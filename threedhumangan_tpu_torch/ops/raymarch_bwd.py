"""K8 + K9: the backward of the field render (K2), and ``FieldRender``.

Replaces threedhumangan_tpu/ops/raymarch_bwd.py (Pallas): ``_stats_kernel``
(K8) and ``_bwd_step_kernel`` (K9), the ``pallas_bwd`` branch of the custom
VJP of ``fused_field_render_trainable`` (threedhumangan_tpu/ops/
raymarch.py:933-951).  The backward recomputes the UNFOLDED FiLM-SIREN
(freq/phase applied per element, omega 30 on the first layers, as
``_xla_packed_render``) in three parts:

  K8      per sample: sigma (+ the nerf-noise column) and sum(g_out * field),
          written to (B, R, S) tables;
  tables  plain torch on (B, R, S): alpha, transmittance, the residual,
          the division-free reverse recurrence
              M_s = gw_{s+1} a_{s+1} + (1 - a_{s+1} + eps) M_{s+1},
              dalpha_s = T_s (gw_s - M_s)
          (the naive A_s / (1 - a_s + eps) is 0/0 on saturated rays), then
          dsigma and the per-sample compositing coefficient;
  K9      per sample: recompute the activations and backprop the heads,
          colour layer, trunk and first layers.  Weight and bias grads are
          summed over the whole batch, freq/phase grads per image, and
          d_freq = 15 * d(freq*15+30).

Gradients come out for the field's weights and for freq/phase only: the
packed inputs and the depth samples are no-grad data on every caller path.

``fused_field_render_bwd`` launches csrc/raymarch_bwd.cu on CUDA tensors
and runs ``field_stats_plain`` / ``field_bwd_step_plain`` on CPU tensors.
``FieldRender`` is the ``torch.autograd.Function``: K2 forward on folded
tables, or K4 on the unfolded ones under ``fold_film=False`` (JAX
raymarch.py:920-927), and this backward.  The tables,
``slab_forward`` and ``flat_weights`` live in ops/raymarch.py beside K4.
``field_render_unfolded`` (``_xla_packed_render``) is the plain
differentiable render that the tests hold both against.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from threedhumangan_tpu_torch import _build
from threedhumangan_tpu_torch.models.volume_rendering import ray_integration
from threedhumangan_tpu_torch.ops import raymarch as rm
from threedhumangan_tpu_torch.ops.raymarch import (KERNEL_TABLE_ORDER, film_tables,
                                                  flat_weights, kernel_tables, layer_names,
                                                  slab_forward)
from threedhumangan_tpu_torch.utils.misc import mm

launches_stats = 0  # K8 launches (the CUDA path only)
launches_bwd = 0    # K9 launches (the CUDA path only)
launches_wgrad = 0  # K9's weight-gradient reduction launches (the CUDA path only)

def fast_sin_grad(x: torch.Tensor) -> torch.Tensor:
    """Exact derivative of ``fast_sin`` (the 2*pi offset is piecewise constant)."""
    k = torch.round(x * rm._INV_2PI)
    y = x - k * rm._TWO_PI
    y2 = y * y
    return rm._SIN_C1 + y2 * (3.0 * rm._SIN_C3 + y2 * (5.0 * rm._SIN_C5 + y2 * (
        7.0 * rm._SIN_C7 + y2 * (9.0 * rm._SIN_C9))))


def _rows(packed, g_out, b, r0, r1, num_steps):
    """Packed rows [r0, r1) of image b and the output cotangent of each row's ray."""
    rays = torch.arange(r0, r1, device=packed.device) // num_steps
    return packed[b, r0:r1], g_out[b, rays].float()


def field_stats_plain(w, packed, freq_k, phase_k, g_out, num_steps: int,
                      compute_dtype=torch.bfloat16, exact_sin: bool = False,
                      row_chunk: int = 32768) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K8: (sigma, sum(g_out * field)) tables, each (B, R, S)."""
    B, P, n_cols = packed.shape
    with_noise = rm.check_packed_width(n_cols)
    n_blocks = freq_k.shape[1]
    sigma = packed.new_empty(B, P, dtype=torch.float32)
    gdot = packed.new_empty(B, P, dtype=torch.float32)
    for b in range(B):
        for r0 in range(0, P, row_chunk):
            r1 = min(P, r0 + row_chunk)
            slab, go = _rows(packed, g_out, b, r0, r1, num_steps)
            acts = slab_forward(w, slab, freq_k[b], phase_k[b], n_blocks, compute_dtype,
                                exact_sin, with_noise)
            sigma[b, r0:r1] = acts["sigma"][:, 0]
            gdot[b, r0:r1] = (go * acts["field"]).sum(-1)
    R = P // num_steps
    return sigma.reshape(B, R, num_steps), gdot.reshape(B, R, num_steps)


def backward_tables(sigma, gdot, z_vals, g_out, g_depth, white_back: bool, last_back: bool):
    """The (B, R, S) table algebra between K8 and K9 (JAX raymarch_bwd.py:341-380):
    returns (coef, dsigma), the per-sample weight of d(field) and d(sigma)."""
    z = z_vals.float()
    B, R, S = z.shape
    delta = torch.cat([z[..., 1:] - z[..., :-1], z.new_full((B, R, 1), 1e9)], -1)
    alpha = 1.0 - torch.exp(-delta * torch.relu(sigma))
    T = torch.cumprod(torch.cat([z.new_ones(B, R, 1), 1.0 - alpha[..., :-1] + 1e-12], -1), -1)
    w = T * alpha
    residual = 1.0 - w.sum(-1, keepdim=True)
    go = g_out.float()
    gd = g_depth.float()
    r_dot = torch.zeros_like(gd)
    if white_back:
        r_dot = r_dot + go.sum(-1, keepdim=True)
    if last_back:
        r_dot = r_dot + gdot[..., -1:]
    gw = gdot + z * gd - (r_dot + gd * z[..., -1:])
    # descending exclusive-product recurrence (module docstring)
    m = torch.zeros_like(z)
    for s in range(S - 2, -1, -1):
        a1 = alpha[..., s + 1]
        m[..., s] = gw[..., s + 1] * a1 + (1.0 - a1 + 1e-12) * m[..., s + 1]
    da = T * (gw - m)
    dsigma = da * delta * (1.0 - alpha) * (sigma > 0.0).float()
    coef = w.clone()
    if last_back:
        coef[..., -1] += residual[..., 0]
    return coef, dsigma


def field_bwd_step_plain(w, packed, freq_k, phase_k, g_out, coef, dsigma, num_steps: int,
                         compute_dtype=torch.bfloat16, exact_sin: bool = False,
                         row_chunk: int = 32768):
    """Plain K9: weight grads (``w_*``/``b_*``, summed over the batch) and
    the kernel-side (d freq*15+30, d phase), each (B, NB, H)."""
    cd = compute_dtype
    _sin_g = torch.cos if exact_sin else fast_sin_grad
    B, P, n_cols = packed.shape
    with_noise = rm.check_packed_width(n_cols)
    n_blocks = freq_k.shape[1]
    H = w["w_coord"].shape[1]
    grads = {k: torch.zeros_like(v) for k, v in w.items()}
    d_freq = torch.zeros_like(freq_k)
    d_phase = torch.zeros_like(phase_k)
    coef = coef.reshape(B, P, 1).float()
    dsigma = dsigma.reshape(B, P, 1).float()
    outer = lambda x, dy: mm(x.t(), dy, cd)

    def acc(name, dy, x):
        grads["w_" + name] += outer(x, dy)
        grads["b_" + name] += dy.sum(0)

    for b in range(B):
        f, p = freq_k[b], phase_k[b]
        for r0 in range(0, P, row_chunk):
            r1 = min(P, r0 + row_chunk)
            slab, go = _rows(packed, g_out, b, r0, r1, num_steps)
            a = slab_forward(w, slab, f, p, n_blocks, cd, exact_sin, with_noise)
            dfield = coef[b, r0:r1] * go
            dfeat = dfield[:, 3:]
            dpre_r = dfield[:, :3] * a["rgb"] * (1.0 - a["rgb"])
            acc("feat", dfeat, a["xc"])
            acc("rgb", dpre_r, a["xc"])
            dxc = mm(dfeat, w["w_feat"].t(), cd) + mm(dpre_r, w["w_rgb"].t(), cd)
            dprec = dxc * _sin_g(a["prec"])
            d_freq[b, -1] += (dprec * a["vc"]).sum(0)
            d_phase[b, -1] += dprec.sum(0)
            dvc = dprec * f[-1]
            acc("color", dvc, a["xc_in"])
            dx = mm(dvc, w["w_color"].t(), cd)[:, 3:]
            ds = dsigma[b, r0:r1]
            acc("sigma", ds, a["xs"][-1])
            dx = dx + mm(ds, w["w_sigma"].t(), cd)
            for i in range(n_blocks - 1, -1, -1):
                dpre = dx * _sin_g(a["pres"][i])
                d_freq[b, i] += (dpre * a["vs"][i]).sum(0)
                d_phase[b, i] += dpre.sum(0)
                dv = dpre * f[i]
                acc(f"net{i}", dv, a["xs"][i])
                dx = mm(dv, w[f"w_net{i}"].t(), cd)
            du1 = dx[:, :H] * _sin_g(30.0 * a["u1"]) * 30.0
            du2 = dx[:, H:] * _sin_g(30.0 * a["u2"]) * 30.0
            acc("coord", du1, a["pts"])
            acc("geo", du2, a["geo"])
    return grads, d_freq, d_phase


def fused_field_render_bwd(w: Dict[str, torch.Tensor], packed, freq, phase, z_vals, g_out,
                           g_depth, num_steps: int, white_back: bool = False,
                           last_back: bool = False, compute_dtype=torch.bfloat16,
                           exact_sin: bool = False):
    """VJP of the field render w.r.t. the raw field weights ``w``
    (``flat_weights``) and freq/phase (B, NB*H).  Returns (weight grads,
    d_freq, d_phase).  CUDA tensors launch K8 and K9 (bf16 only); CPU
    tensors take the plain versions."""
    n_blocks = sum(k.startswith("w_net") for k in w)
    freq_k, phase_k = film_tables(freq, phase, n_blocks)
    if packed.device.type == "cpu":
        stats, step = field_stats_plain, field_bwd_step_plain
        kw = dict(compute_dtype=compute_dtype, exact_sin=exact_sin)
    elif packed.device.type == "cuda":
        if compute_dtype != torch.bfloat16:
            raise ValueError("the field backward kernels compute in bfloat16 only")
        stats, step = field_stats_cuda, field_bwd_step_cuda
        kw = dict(exact_sin=exact_sin)
    else:
        raise ValueError(f"fused_field_render_bwd: unsupported device {packed.device}")
    sigma, gdot = stats(w, packed, freq_k, phase_k, g_out, num_steps, **kw)
    coef, dsigma = backward_tables(sigma, gdot, z_vals, g_out, g_depth, white_back, last_back)
    grads, d_freq_k, d_phase = step(w, packed, freq_k, phase_k, g_out, coef, dsigma,
                                    num_steps, **kw)
    B = freq.shape[0]
    return grads, 15.0 * d_freq_k.reshape(B, -1), d_phase.reshape(B, -1)


# ---------------------------------------------------------------------------
# differentiable render
# ---------------------------------------------------------------------------


class FieldRender(torch.autograd.Function):
    """K2 forward on folded (detached) tables, or K4 as ``fused_field_render``
    routes; K8 + tables + K9 backward.
    Saves only the inputs.  Returns grads for the field's parameters and for
    freq/phase; None for the packed inputs and z_vals (no-grad data)."""

    @staticmethod
    def forward(ctx, field, opts, packed, freq, phase, z_vals, *params):
        ctx.field, ctx.opts = field, opts
        ctx.save_for_backward(packed, freq, phase, z_vals)
        return rm.fused_field_render(field, packed, freq, phase, z_vals, *opts)

    @staticmethod
    def backward(ctx, g_out, g_depth):
        packed, freq, phase, z_vals = ctx.saved_tensors
        field = ctx.field
        num_steps, white_back, last_back, compute_dtype, exact_sin, _ = ctx.opts
        grads, d_freq, d_phase = fused_field_render_bwd(
            flat_weights(field), packed, freq, phase, z_vals, g_out, g_depth, num_steps,
            white_back, last_back, compute_dtype, exact_sin)
        names = layer_names(field)
        d_params = []
        for name, prm in field.named_parameters():
            path, kind = name.rsplit(".", 1)
            g = grads[f"w_{names[path]}"].t() if kind == "weight" else grads[f"b_{names[path]}"]
            d_params.append(g.to(prm.dtype))
        return (None, None, None, d_freq.to(freq.dtype), d_phase.to(phase.dtype), None,
                *d_params)


def field_render_trainable(field, packed, freq, phase, z_vals, num_steps: int,
                           white_back: bool = False, last_back: bool = False,
                           compute_dtype=torch.bfloat16, exact_sin: bool = False,
                           fold_film: bool = True):
    """``fused_field_render`` with gradients for the field and freq/phase
    (JAX ``fused_field_render_trainable(..., pallas_bwd=True)``); the
    forward kernel as ``fold_film`` selects it."""
    opts = (num_steps, white_back, last_back, compute_dtype, exact_sin, fold_film)
    return FieldRender.apply(field, opts, packed, freq, phase, z_vals,
                             *field.parameters())


def field_render_unfolded(field, packed, freq, phase, z_vals, num_steps: int,
                          white_back: bool = False, last_back: bool = False,
                          compute_dtype=torch.float32, exact_sin: bool = False):
    """Plain differentiable render on the same packed inputs with the
    unfolded SIREN (JAX ``_xla_packed_render``): the reference that autograd
    differentiates in the tests."""
    B, P, n_cols = packed.shape
    with_noise = rm.check_packed_width(n_cols)
    n_in = field.first_layer_coord.layer.in_features + field.first_layer_mod.layer.in_features
    out = field(packed[..., :3], freq, phase, packed[..., 3:n_in], packed[..., n_in:n_in + 3],
                compute_dtype=compute_dtype, fast_math=not exact_sin)
    if with_noise:
        out = torch.cat([out[..., :-1], out[..., -1:] + packed[..., n_in + 3:n_in + 4]], -1)
    R = P // num_steps
    o, d, _ = ray_integration(out.reshape(B, R, num_steps, -1),
                              z_vals.float().reshape(B, R, num_steps, 1),
                              white_back=white_back, last_back=last_back)
    return o, d


# ---------------------------------------------------------------------------
# CUDA path (csrc/raymarch_bwd.cu)
# ---------------------------------------------------------------------------

ROWS_PER_CTA = 64
# K9 takes the batch in groups of this many images, so that the per-sample
# operands of the weight-gradient products (bf16) and the saved
# pre-activations (f32) stay a few GB at full width
IMAGES_PER_LAUNCH = 2


def _check_rows(packed, num_steps):
    B, P, n_cols = packed.shape
    rm.check_packed_width(n_cols)
    if P % num_steps or P % ROWS_PER_CTA:
        raise ValueError(f"field backward kernels need rays*steps divisible by "
                         f"{ROWS_PER_CTA} and by num_steps (P={P}, S={num_steps})")


def _launch(name, *args):
    lib = _build.library()
    err = getattr(lib, name)(*args)
    _build.check(err, name)


def field_stats_cuda(w, packed, freq_k, phase_k, g_out, num_steps: int, exact_sin=False):
    """Launch K8; same contract as ``field_stats_plain``."""
    global launches_stats
    _check_rows(packed, num_steps)
    B, P, n_cols = packed.shape
    t, d = kernel_tables(w, freq_k, phase_k)
    pk = packed.to(torch.bfloat16).contiguous()
    go = g_out.float().contiguous()
    sigma = torch.empty(B, P, dtype=torch.float32, device=packed.device)
    gdot = torch.empty_like(sigma)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        ptrs = rm.cuda_ptrs([pk, go] + [t[k] for k in KERNEL_TABLE_ORDER], "field backward kernel")
        _launch("thgt_field_stats", *ptrs,
                sigma.data_ptr(), gdot.data_ptr(), B, P, num_steps, n_cols, d["n_in"],
                d["k0p"], d["n0p"], d["hp"], d["NB"], d["F"] + 3, d["headp"], int(exact_sin),
                stream)
    launches_stats += 1
    R = P // num_steps
    return sigma.reshape(B, R, num_steps), gdot.reshape(B, R, num_steps)


def wgrad(X, Y, stream):
    """sum over rows of X^T Y: X (rows, K), Y (rows, N) bf16 -> (K, N) f32,
    rows a multiple of 64.  Per-CTA partials over row chunks, reduced here in
    a fixed order.  Callers count the launch (K9 here, K11 in
    ops/synthesis_train.py)."""
    rows, K = X.shape
    N = Y.shape[1]
    tiles = -(-K // 64) * -(-N // 64)
    chunk_tiles = rows // ROWS_PER_CTA
    n_chunks = max(1, min(chunk_tiles, -(-264 // tiles)))
    chunk_rows = -(-chunk_tiles // n_chunks) * ROWS_PER_CTA
    n_chunks = -(-rows // chunk_rows)
    part = torch.empty(n_chunks, K, N, dtype=torch.float32, device=X.device)
    _launch("thgt_wgrad", X.data_ptr(), Y.data_ptr(), part.data_ptr(), K, N, rows, chunk_rows,
            n_chunks, stream)
    return part.sum(0)


def _wgrad(X, Y, stream):
    global launches_wgrad
    out = wgrad(X, Y, stream)
    launches_wgrad += 1
    return out


def field_bwd_step_cuda(w, packed, freq_k, phase_k, g_out, coef, dsigma, num_steps: int,
                        exact_sin=False):
    """Launch K9 once per ``IMAGES_PER_LAUNCH`` images, then its
    weight-gradient reduction; same contract as ``field_bwd_step_plain``."""
    global launches_bwd
    _check_rows(packed, num_steps)
    B, P, n_cols = packed.shape
    t, d = kernel_tables(w, freq_k, phase_k)
    hp, n0p, headp, k0p, NB, H = d["hp"], d["n0p"], d["headp"], d["k0p"], d["NB"], d["H"]
    cp = hp + 16
    n_part = n0p + 3 * hp * (NB + 1) + headp + 1
    bf16, f32, dev = torch.bfloat16, torch.float32, packed.device
    pk_all = packed.to(bf16).contiguous()
    go_all = g_out.float().contiguous()
    coef_all = coef.reshape(B, P).float().contiguous()
    ds_all = dsigma.reshape(B, P).float().contiguous()
    gw = {}  # padded weight-grad sums
    parts = []
    wt = dict(wT_head=t["w_head"].t().contiguous(), wT_color_x=t["w_color_x"].t().contiguous(),
              wT_net_stk=t["w_net_stk"].transpose(1, 2).contiguous(),
              wT_net0=t["w_net0"].t().contiguous())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b0 in range(0, B, IMAGES_PER_LAUNCH):
            b1 = min(B, b0 + IMAGES_PER_LAUNCH)
            Bc = b1 - b0
            rows = Bc * P
            e = lambda *shape, dt=bf16: torch.empty(*shape, dtype=dt, device=dev)
            x0, xs0, xsk = e(rows, k0p), e(rows, n0p), e(max(NB - 1, 1), rows, hp)
            xcol, xc = e(rows, cp), e(rows, hp)
            du, dv, dcol, dyh = e(rows, n0p), e(NB, rows, hp), e(rows, cp), e(rows, headp)
            U, V, VC = e(rows, n0p, dt=f32), e(NB, rows, hp, dt=f32), e(rows, hp, dt=f32)
            part = e(rows // ROWS_PER_CTA, n_part, dt=f32)
            tabs = [t[k] for k in KERNEL_TABLE_ORDER]
            tabs[5], tabs[6] = t["freq"][b0:b1].contiguous(), t["phase"][b0:b1].contiguous()
            args = rm.cuda_ptrs(
                [pk_all[b0:b1], go_all[b0:b1], coef_all[b0:b1], ds_all[b0:b1]] + tabs
                + [wt["wT_head"], wt["wT_color_x"], wt["wT_net_stk"], wt["wT_net0"],
                   x0, xs0, xsk, xcol, xc, du, dv, dcol, dyh, U, V, VC, part],
                "field backward kernel")
            _launch("thgt_field_bwd", *args, Bc, P, num_steps, n_cols, d["n_in"], k0p, n0p,
                    hp, NB, d["F"] + 3, headp, int(exact_sin), stream)
            launches_bwd += 1
            prods = {"first": (x0, du), "net0": (xs0, dv[0]), "color": (xcol, dcol),
                     "head": (xc, dyh)}
            prods.update({f"net{i}": (xsk[i - 1], dv[i]) for i in range(1, NB)})
            for k, (X, Y) in prods.items():
                g = _wgrad(X, Y, stream)
                gw[k] = gw[k] + g if k in gw else g
            parts.append(part.reshape(Bc, -1, n_part).sum(1))
    part = torch.cat(parts, 0)  # (B, n_part): per-image column sums
    tot = part.sum(0)
    G = d["n_in"] - 3
    F = d["F"]
    grads = {
        "w_coord": gw["first"][:3, :H], "b_coord": tot[:H],
        "w_geo": gw["first"][3:3 + G, H:2 * H], "b_geo": tot[H:2 * H],
        "w_color": torch.cat([gw["color"][hp:hp + 3, :H], gw["color"][:H, :H]], 0),
        "w_sigma": gw["color"][:H, hp:hp + 1],
        "w_rgb": gw["head"][:H, :3], "w_feat": gw["head"][:H, 3:3 + F],
    }
    off_c = n0p + 3 * hp * NB
    off_h = off_c + 3 * hp
    grads["b_color"] = tot[off_c:off_c + H]
    grads["b_rgb"], grads["b_feat"] = tot[off_h:off_h + 3], tot[off_h + 3:off_h + 3 + F]
    grads["b_sigma"] = tot[off_h + headp:off_h + headp + 1]
    d_freq = torch.zeros(B, NB, H, dtype=f32, device=dev)
    d_phase = torch.zeros_like(d_freq)
    for i in range(NB):
        o = n0p + 3 * hp * i
        grads[f"w_net{i}"] = gw[f"net{i}"][:(2 * H if i == 0 else H), :H]
        grads[f"b_net{i}"] = tot[o:o + H]
        d_freq[:, i] = part[:, o + hp:o + hp + H]
        d_phase[:, i] = part[:, o + 2 * hp:o + 2 * hp + H]
    d_freq[:, -1] += part[:, off_c + hp:off_c + hp + H]
    d_phase[:, -1] += part[:, off_c + 2 * hp:off_c + 2 * hp + H]
    return {k: grads[k].contiguous() for k in w}, d_freq, d_phase
