"""K2: fused FiLM-SIREN field render with front-to-back compositing.

Replaces threedhumangan_tpu/ops/raymarch.py::_raymarch_kernel_folded
(Pallas), the folded-FiLM form that the JAX generator runs by default:
freq/phase and omega are folded into per-image weight tables
(``fold_film_tables``), the SIREN runs 1 block-diagonal first layer, the
trunk, a sigma head, a colour layer whose view-direction term is hoisted
per ray (directions are constant along a ray), and sigmoid-RGB and feature
heads; the per-step outputs are alpha-composited front to back with delta
1e9 on the last step and the residual transmittance routed to the last
sample (``last_back``) and/or a white background (``white_back``).  An
optional 38th packed column carries the training-time nerf noise, added to
sigma before the density clamp.

``fused_field_render`` launches csrc/raymarch.cu on CUDA tensors and runs
``field_render_plain`` — the same math on the same folded tables, in
PyTorch — on CPU tensors.  The packed slabs are rounded to the compute
dtype first, as the JAX wrapper does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from threedhumangan_tpu_torch import _build
from threedhumangan_tpu_torch.models.volume_rendering import ray_integration
from threedhumangan_tpu_torch.utils.misc import mm, pad_to, round16

INPUT_PACK = 37  # 3 coords + 31 geo + 3 ray dirs (+1 optional sigma noise)

# degree-9 odd minimax sine on [-pi, pi] after a 2*pi range reduction
# (the JAX package's coefficients)
_SIN_C1 = 0.999979407588
_SIN_C3 = -0.166624416001
_SIN_C5 = 0.00830899784978
_SIN_C7 = -0.000192651914745
_SIN_C9 = 2.14797007513e-06
_INV_2PI = 0.15915494309189535
_TWO_PI = 6.283185307179586

launches = 0  # K2 launches (the CUDA path only)


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """Range-reduced odd-polynomial sine (max error ~3e-5 in float32)."""
    k = torch.round(x * _INV_2PI)
    y = x - k * _TWO_PI
    y2 = y * y
    return y * (_SIN_C1 + y2 * (_SIN_C3 + y2 * (_SIN_C5 + y2 * (_SIN_C7 + y2 * _SIN_C9))))


def pack_field_inputs(points, geo, dirs, input_scaler: float, noise=None) -> torch.Tensor:
    """(B, P, 3/31/3) -> (B, P, 37) with the coordinate scale folded in.
    P is ray-major (p = ray * num_steps + step).  ``noise`` (B, P, 1), when
    given, rides as a 38th column that is added to sigma before the clamp."""
    cols = [points * input_scaler, geo, dirs] + ([noise] if noise is not None else [])
    return torch.cat(cols, -1)


def check_packed_width(n_cols: int) -> bool:
    """True when the packed inputs carry the noise column."""
    if n_cols not in (INPUT_PACK, INPUT_PACK + 1):
        raise ValueError(f"packed inputs need {INPUT_PACK} or {INPUT_PACK + 1} columns, "
                         f"got {n_cols}")
    return n_cols == INPUT_PACK + 1


def fold_film_tables(field, freq, phase, compute_dtype=torch.bfloat16):
    """Per-image folded weight tables from a ``CoordConcatSiren``.

    Returns (shared, per_image).  ``shared``: the omega-scaled block-diagonal
    first layer and the heads; ``per_image``: the trunk and colour weights
    scaled by freq*15+30 with biases folded with phase.  Weight matrices are
    (in, out) in the compute dtype, biases float32; all detached (inference)."""
    cd, f32 = compute_dtype, torch.float32
    wt = lambda lin: lin.weight.t().float()
    w_coord, w_geo = wt(field.first_layer_coord.layer), wt(field.first_layer_mod.layer)
    H, G = w_coord.shape[1], w_geo.shape[0]
    NB = len(field.network)
    B = freq.shape[0]
    freq_r = (freq.float() * 15.0 + 30.0).reshape(B, NB, H)
    phase_r = phase.float().reshape(B, NB, H)

    top = torch.cat([w_coord, w_coord.new_zeros(3, H)], 1)
    bot = torch.cat([w_geo.new_zeros(G, H), w_geo], 1)
    shared = {
        "w_first": (torch.cat([top, bot], 0) * 30.0).to(cd),
        "b_first": torch.cat([field.first_layer_coord.layer.bias,
                              field.first_layer_mod.layer.bias])[None].float() * 30.0,
        "w_sigma": wt(field.sigma_layer).to(cd),
        "b_sigma": field.sigma_layer.bias[None].float(),
        "w_rgb": wt(field.color_layer_linear).to(cd),
        "b_rgb": field.color_layer_linear.bias[None].float(),
        "w_feat": wt(field.feature_layer_linear).to(cd),
        "b_feat": field.feature_layer_linear.bias[None].float(),
    }
    nets = [wt(blk.layer) for blk in field.network]
    b_all = torch.stack([blk.layer.bias.float() for blk in field.network], 0)
    f_last, p_last = freq_r[:, NB - 1], phase_r[:, NB - 1]
    w_color = wt(field.color_layer_sine.layer)
    stk = (torch.stack(nets[1:], 0)[None] * freq_r[:, 1:, None, :] if NB > 1
           else w_color.new_zeros(B, 0, H, H))
    per_image = {
        "w_net0": (nets[0][None] * freq_r[:, 0, None, :]).to(cd),          # (B, 2H, H)
        "w_net_stk": stk.to(cd),                                           # (B, NB-1, H, H)
        "b_net": (b_all[None] * freq_r + phase_r).to(f32),                 # (B, NB, H)
        # colour FiLM reuses the LAST trunk slice (reference quirk)
        "w_color_x": (w_color[3:][None] * f_last[:, None, :]).to(cd),      # (B, H, H)
        "w_color_d": (w_color[:3][None] * f_last[:, None, :]).to(cd),      # (B, 3, H)
        "b_color": (field.color_layer_sine.layer.bias.float() * f_last + p_last)[:, None, :],
    }
    detach = lambda d: {k: v.detach() for k, v in d.items()}
    return detach(shared), detach(per_image)


def field_render_plain(shared: Dict, per_image: Dict, packed, z_vals, num_steps: int,
                       white_back: bool = False, last_back: bool = False,
                       compute_dtype=torch.bfloat16, exact_sin: bool = False,
                       ray_chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K2 on folded tables: (out (B, R, F+3), depth (B, R, 1))."""
    _sin = torch.sin if exact_sin else fast_sin
    cd = compute_dtype
    B, P, n_cols = packed.shape
    with_noise = check_packed_width(n_cols)
    S = num_steps
    R = P // S
    n_in = shared["w_first"].shape[0]
    width = shared["w_feat"].shape[1] + 3
    packed = packed.to(cd)
    z_vals = z_vals.float().reshape(B, R, S)
    out = packed.new_empty(B, R, width, dtype=torch.float32)
    depth = packed.new_empty(B, R, 1, dtype=torch.float32)
    n_trunk = per_image["w_net_stk"].shape[1]
    for b in range(B):
        for r0 in range(0, R, ray_chunk):
            nr = min(ray_chunk, R - r0)
            slab = packed[b, r0 * S:(r0 + nr) * S]
            x = _sin(mm(slab[:, :n_in], shared["w_first"], cd) + shared["b_first"]).to(cd)
            x = _sin(mm(x, per_image["w_net0"][b], cd) + per_image["b_net"][b, 0]).to(cd)
            for i in range(n_trunk):
                x = _sin(mm(x, per_image["w_net_stk"][b, i], cd)
                         + per_image["b_net"][b, i + 1]).to(cd)
            sigma = mm(x, shared["w_sigma"], cd) + shared["b_sigma"]
            if with_noise:
                sigma = sigma + slab[:, n_in + 3:n_in + 4].float()
            dirs = slab.reshape(nr, S, n_cols)[:, 0, n_in:n_in + 3]
            dpart = mm(dirs, per_image["w_color_d"][b], cd) + per_image["b_color"][b]
            xc = mm(x, per_image["w_color_x"][b], cd).reshape(nr, S, -1) + dpart[:, None]
            xc = _sin(xc.reshape(nr * S, -1)).to(cd)
            rgb = torch.sigmoid(mm(xc, shared["w_rgb"], cd) + shared["b_rgb"])
            feat = mm(xc, shared["w_feat"], cd) + shared["b_feat"]
            field = torch.cat([rgb, feat, sigma.reshape(-1, 1)], -1).reshape(1, nr, S, width + 1)
            o, d, _ = ray_integration(field, z_vals[b, r0:r0 + nr].reshape(1, nr, S, 1),
                                      white_back=white_back, last_back=last_back)
            out[b, r0:r0 + nr] = o[0]
            depth[b, r0:r0 + nr] = d[0]
    return out, depth


def fused_field_render(field, packed, freq, phase, z_vals, num_steps: int,
                       white_back: bool = False, last_back: bool = False,
                       compute_dtype=torch.bfloat16, exact_sin: bool = False):
    """Render the field: packed (B, R*S, 37[+1]) ray-major inputs, freq/phase
    (B, NB*H) raw mapping outputs, z_vals (B, R, S).  Returns (rendered
    (B, R, F+3), depth (B, R, 1)) float32.  CUDA tensors launch K2 (bf16
    only); CPU tensors take ``field_render_plain``."""
    shared, per_image = fold_film_tables(field, freq, phase, compute_dtype)
    if packed.device.type == "cpu":
        return field_render_plain(shared, per_image, packed, z_vals, num_steps,
                                  white_back, last_back, compute_dtype, exact_sin)
    if packed.device.type != "cuda":
        raise ValueError(f"fused_field_render: unsupported device {packed.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("the field kernel computes in bfloat16 only")
    return field_render_cuda(shared, per_image, packed, z_vals, num_steps,
                             white_back, last_back, exact_sin)


ROWS_PER_CTA = 64  # rows (ray x step samples) one CTA of the kernel holds


def field_render_cuda(shared, per_image, packed, z_vals, num_steps, white_back=False,
                      last_back=False, exact_sin=False):
    """Launch K2 on folded tables (zero-padded to multiples of 16 here)."""
    global launches
    bf16, f32 = torch.bfloat16, torch.float32
    B, P, n_cols = packed.shape
    S = num_steps
    R = P // S
    dev = packed.device
    check_packed_width(n_cols)
    if P != R * S or ROWS_PER_CTA % S or R % (ROWS_PER_CTA // S):
        raise ValueError(f"field kernel needs num_steps dividing {ROWS_PER_CTA} and "
                         f"rays divisible by {ROWS_PER_CTA} // num_steps (R={R}, S={S})")
    if tuple(z_vals.shape) != (B, R, S):
        raise ValueError(f"z_vals: expected {(B, R, S)}, got {tuple(z_vals.shape)}")
    n_in, n0 = shared["w_first"].shape
    H = per_image["w_net0"].shape[2]
    NB = per_image["b_net"].shape[1]
    width = shared["w_feat"].shape[1] + 3
    k0p, n0p, hp, headp = round16(n_in), round16(n0), round16(H), round16(width)
    NS = max(NB - 1, 1)

    w_head = torch.cat([shared["w_rgb"], shared["w_feat"]], 1)
    b_head = torch.cat([shared["b_rgb"], shared["b_feat"]], 1)[0]
    args = [
        packed.to(bf16).contiguous(),
        z_vals.to(f32).contiguous(),
        pad_to(shared["w_first"], (k0p, n0p), bf16),
        pad_to(shared["b_first"][0], (n0p,), f32),
        pad_to(per_image["w_net0"], (B, n0p, hp), bf16),
        pad_to(per_image["w_net_stk"], (B, NS, hp, hp), bf16),
        pad_to(per_image["b_net"], (B, NB, hp), f32),
        pad_to(per_image["w_color_x"], (B, hp, hp), bf16),
        pad_to(per_image["w_color_d"].float(), (B, 3, hp), f32),
        pad_to(per_image["b_color"][:, 0], (B, hp), f32),
        pad_to(shared["w_sigma"][:, 0].float(), (hp,), f32),
        shared["b_sigma"].reshape(1).float().contiguous(),
        pad_to(w_head, (hp, headp), bf16),
        pad_to(b_head, (headp,), f32),
    ]
    for t in args:
        if t.device != dev:
            raise ValueError(f"field kernel operand on {t.device}, expected {dev}")
    out = torch.empty(B, R, width, dtype=f32, device=dev)
    depth = torch.empty(B, R, 1, dtype=f32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.thgt_raymarch(
            *[t.data_ptr() for t in args], out.data_ptr(), depth.data_ptr(),
            B, R, S, n_cols, n_in, k0p, n0p, hp, NB, width, headp,
            int(white_back), int(last_back), int(exact_sin), stream)
    _build.check(err, "thgt_raymarch")
    launches += 1
    return out, depth
