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
tables, this backward.  ``field_render_unfolded`` (``_xla_packed_render``)
is the plain differentiable render that the tests hold both against.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from threedhumangan_tpu_torch import _build
from threedhumangan_tpu_torch.models.volume_rendering import ray_integration
from threedhumangan_tpu_torch.ops import raymarch as rm
from threedhumangan_tpu_torch.utils.misc import mm, pad_to, round16

launches_stats = 0  # K8 launches (the CUDA path only)
launches_bwd = 0    # K9 launches (the CUDA path only)
launches_wgrad = 0  # K9's weight-gradient reduction launches (the CUDA path only)

# field module attribute -> the JAX package's flat weight name stem
_LAYERS = {"first_layer_coord.layer": "coord", "first_layer_mod.layer": "geo",
           "sigma_layer": "sigma", "color_layer_sine.layer": "color",
           "color_layer_linear": "rgb", "feature_layer_linear": "feat"}


def _layer_names(field):
    names = dict(_LAYERS)
    names.update({f"network.{i}.layer": f"net{i}" for i in range(len(field.network))})
    return names


def flat_weights(field) -> Dict[str, torch.Tensor]:
    """Raw field weights as the JAX package's ``_flatten_field_params``:
    ``w_<name>`` (in, out) and ``b_<name>`` (out,), float32, detached."""
    mods = dict(field.named_modules())
    out = {}
    for path, stem in _layer_names(field).items():
        lin = mods[path]
        out[f"w_{stem}"] = lin.weight.detach().t().float()
        out[f"b_{stem}"] = lin.bias.detach().float()
    return out


def fast_sin_grad(x: torch.Tensor) -> torch.Tensor:
    """Exact derivative of ``fast_sin`` (the 2*pi offset is piecewise constant)."""
    k = torch.round(x * rm._INV_2PI)
    y = x - k * rm._TWO_PI
    y2 = y * y
    return rm._SIN_C1 + y2 * (3.0 * rm._SIN_C3 + y2 * (5.0 * rm._SIN_C5 + y2 * (
        7.0 * rm._SIN_C7 + y2 * (9.0 * rm._SIN_C9))))


def _film_tables(freq, phase, n_blocks: int):
    """Raw mapping outputs (B, NB*H) -> kernel-side (freq*15+30, phase), (B, NB, H)."""
    B = freq.shape[0]
    return (freq.float() * 15.0 + 30.0).reshape(B, n_blocks, -1), phase.float().reshape(
        B, n_blocks, -1)


def _slab_forward(w, slab, f, p, n_blocks, cd, exact_sin, with_noise):
    """One image's rows (N, C) through the unfolded SIREN, keeping every
    activation (JAX ``_slab_forward``); f/p (NB, H)."""
    _sin = torch.sin if exact_sin else rm.fast_sin
    n_in = w["w_coord"].shape[0] + w["w_geo"].shape[0]
    pts, geo, dirs = slab[:, :3], slab[:, 3:n_in], slab[:, n_in:n_in + 3]
    u1 = mm(pts, w["w_coord"], cd) + w["b_coord"]
    u2 = mm(geo, w["w_geo"], cd) + w["b_geo"]
    x = torch.cat([_sin(30.0 * u1), _sin(30.0 * u2)], -1)
    xs, pres, vs = [x], [], []
    for i in range(n_blocks):
        v = mm(x, w[f"w_net{i}"], cd) + w[f"b_net{i}"]
        pre = f[i] * v + p[i]
        x = _sin(pre)
        vs.append(v)
        pres.append(pre)
        xs.append(x)
    sigma = mm(x, w["w_sigma"], cd) + w["b_sigma"]
    if with_noise:
        sigma = sigma + slab[:, n_in + 3:n_in + 4].float()
    xc_in = torch.cat([dirs.float(), x], -1)
    vc = mm(xc_in, w["w_color"], cd) + w["b_color"]
    prec = f[-1] * vc + p[-1]
    xc = _sin(prec)
    rgb = torch.sigmoid(mm(xc, w["w_rgb"], cd) + w["b_rgb"])
    feat = mm(xc, w["w_feat"], cd) + w["b_feat"]
    return dict(pts=pts, geo=geo, u1=u1, u2=u2, xs=xs, pres=pres, vs=vs, xc_in=xc_in,
                vc=vc, prec=prec, xc=xc, rgb=rgb, field=torch.cat([rgb, feat], -1),
                sigma=sigma)


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
            acts = _slab_forward(w, slab, freq_k[b], phase_k[b], n_blocks, compute_dtype,
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
            a = _slab_forward(w, slab, f, p, n_blocks, cd, exact_sin, with_noise)
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
    freq_k, phase_k = _film_tables(freq, phase, n_blocks)
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
    """K2 forward on folded (detached) tables; K8 + tables + K9 backward.
    Saves only the inputs.  Returns grads for the field's parameters and for
    freq/phase; None for the packed inputs and z_vals (no-grad data)."""

    @staticmethod
    def forward(ctx, field, opts, packed, freq, phase, z_vals, *params):
        num_steps, white_back, last_back, compute_dtype, exact_sin = opts
        ctx.field, ctx.opts = field, opts
        ctx.save_for_backward(packed, freq, phase, z_vals)
        return rm.fused_field_render(field, packed, freq, phase, z_vals, num_steps,
                                     white_back, last_back, compute_dtype, exact_sin)

    @staticmethod
    def backward(ctx, g_out, g_depth):
        packed, freq, phase, z_vals = ctx.saved_tensors
        field = ctx.field
        num_steps, white_back, last_back, compute_dtype, exact_sin = ctx.opts
        grads, d_freq, d_phase = fused_field_render_bwd(
            flat_weights(field), packed, freq, phase, z_vals, g_out, g_depth, num_steps,
            white_back, last_back, compute_dtype, exact_sin)
        names = _layer_names(field)
        d_params = []
        for name, prm in field.named_parameters():
            path, kind = name.rsplit(".", 1)
            g = grads[f"w_{names[path]}"].t() if kind == "weight" else grads[f"b_{names[path]}"]
            d_params.append(g.to(prm.dtype))
        return (None, None, None, d_freq.to(freq.dtype), d_phase.to(phase.dtype), None,
                *d_params)


def field_render_trainable(field, packed, freq, phase, z_vals, num_steps: int,
                           white_back: bool = False, last_back: bool = False,
                           compute_dtype=torch.bfloat16, exact_sin: bool = False):
    """``fused_field_render`` with gradients for the field and freq/phase
    (JAX ``fused_field_render_trainable(..., pallas_bwd=True)``)."""
    opts = (num_steps, white_back, last_back, compute_dtype, exact_sin)
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


def _kernel_tables(w, freq_k, phase_k):
    """Zero-padded bf16/f32 operands of K8/K9 (widths rounded up to 16)."""
    bf16, f32 = torch.bfloat16, torch.float32
    H = w["w_coord"].shape[1]
    G = w["w_geo"].shape[0]
    F = w["w_feat"].shape[1]
    B, NB, _ = freq_k.shape
    n_in = 3 + G
    k0p, n0p, hp, headp = round16(n_in), round16(2 * H), round16(H), round16(F + 3)
    first = w["w_coord"].new_zeros(n_in, 2 * H)
    first[:3, :H] = w["w_coord"]
    first[3:, H:] = w["w_geo"]
    stk = (torch.stack([w[f"w_net{i}"] for i in range(1, NB)], 0) if NB > 1
           else w["w_coord"].new_zeros(1, H, H))
    head = torch.cat([w["w_rgb"], w["w_feat"]], 1)
    t = dict(
        w_first=pad_to(first, (k0p, n0p), bf16),
        b_first=pad_to(torch.cat([w["b_coord"], w["b_geo"]]), (n0p,), f32),
        w_net0=pad_to(w["w_net0"], (n0p, hp), bf16),
        w_net_stk=pad_to(stk, (max(NB - 1, 1), hp, hp), bf16),
        b_net=pad_to(torch.stack([w[f"b_net{i}"] for i in range(NB)], 0), (NB, hp), f32),
        freq=pad_to(freq_k, (B, NB, hp), f32),
        phase=pad_to(phase_k, (B, NB, hp), f32),
        w_color_x=pad_to(w["w_color"][3:], (hp, hp), bf16),
        w_color_d=pad_to(w["w_color"][:3].to(bf16), (3, hp), f32),
        b_color=pad_to(w["b_color"], (hp,), f32),
        w_sigma=pad_to(w["w_sigma"][:, 0].to(bf16), (hp,), f32),
        b_sigma=w["b_sigma"].reshape(1).float().contiguous(),
        w_head=pad_to(head, (hp, headp), bf16),
        b_head=pad_to(torch.cat([w["b_rgb"], w["b_feat"]]), (headp,), f32),
    )
    dims = dict(H=H, F=F, NB=NB, n_in=n_in, k0p=k0p, n0p=n0p, hp=hp, headp=headp)
    return t, dims


_STATS_ORDER = ("w_first", "b_first", "w_net0", "w_net_stk", "b_net", "freq", "phase",
                "w_color_x", "w_color_d", "b_color", "w_sigma", "b_sigma", "w_head", "b_head")


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


def _ptrs(ts):
    for t in ts:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("field backward kernel operands must be contiguous CUDA tensors")
    return [t.data_ptr() for t in ts]


def field_stats_cuda(w, packed, freq_k, phase_k, g_out, num_steps: int, exact_sin=False):
    """Launch K8; same contract as ``field_stats_plain``."""
    global launches_stats
    _check_rows(packed, num_steps)
    B, P, n_cols = packed.shape
    t, d = _kernel_tables(w, freq_k, phase_k)
    pk = packed.to(torch.bfloat16).contiguous()
    go = g_out.float().contiguous()
    sigma = torch.empty(B, P, dtype=torch.float32, device=packed.device)
    gdot = torch.empty_like(sigma)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        _launch("thgt_field_stats", *_ptrs([pk, go] + [t[k] for k in _STATS_ORDER]),
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
    t, d = _kernel_tables(w, freq_k, phase_k)
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
            tabs = [t[k] for k in _STATS_ORDER]
            tabs[5], tabs[6] = t["freq"][b0:b1].contiguous(), t["phase"][b0:b1].contiguous()
            args = _ptrs([pk_all[b0:b1], go_all[b0:b1], coef_all[b0:b1], ds_all[b0:b1]] + tabs
                         + [wt["wT_head"], wt["wT_color_x"], wt["wT_net_stk"], wt["wT_net0"],
                            x0, xs0, xsk, xcol, xc, du, dv, dcol, dyh, U, V, VC, part])
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
