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
Both kernels read the field's own weights as one packed bf16 stream
(``pack_field_bwd_stream``: the forward half, which K8 walks alone, then the
transposes K9's backprop takes) beside small float32 tables
(``field_bwd_side_tables``).
``FieldRender`` is the ``torch.autograd.Function``: K2 forward on folded
tables, or K4 on the unfolded ones under ``fold_film=False`` (JAX
raymarch.py:920-927), and this backward; ``FieldRenderRemat`` has the same
forward and the JAX package's remat backward (``pallas_bwd=False``):
autograd through ``field_render_unfolded`` recomputed.  The tables,
``slab_forward`` and ``flat_weights`` live in ops/raymarch.py beside K4.
``field_render_unfolded`` (``_xla_packed_render``) is the plain
differentiable render that the tests hold both against.
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch

from threedhumangan_tpu_torch import _build
from threedhumangan_tpu_torch.models.volume_rendering import ray_integration
from threedhumangan_tpu_torch.ops import raymarch as rm
from threedhumangan_tpu_torch.ops.raymarch import (film_tables, flat_weights, layer_names,
                                                  slab_forward)
from threedhumangan_tpu_torch.utils.misc import mm, pad_to, round16

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


class FieldRenderRemat(FieldRender):
    """The remat backward of ``pallas_field_bwd=False`` (JAX
    ``fused_field_render_trainable(..., pallas_bwd=False)``, the vjp of
    ``_xla_packed_render``): ``FieldRender``'s forward (K2, or K4 under
    ``fold_film=False``; the plain versions on the CPU), saving only the
    inputs; the backward recomputes the render through
    ``field_render_unfolded`` under autograd and pulls the cotangents back to
    the field's parameters and freq/phase.  As in JAX, the gradient is the
    unfolded function's even when the forward is folded."""

    @staticmethod
    def backward(ctx, g_out, g_depth):
        packed, freq, phase, z_vals = ctx.saved_tensors
        field = ctx.field
        num_steps, white_back, last_back, compute_dtype, exact_sin, _ = ctx.opts
        params = list(field.parameters())
        with torch.enable_grad():
            f, p = freq.detach().requires_grad_(), phase.detach().requires_grad_()
            out, depth = field_render_unfolded(field, packed, f, p, z_vals, num_steps,
                                               white_back, last_back, compute_dtype, exact_sin)
            grads = torch.autograd.grad((out, depth), [f, p] + params, (g_out, g_depth),
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip([f, p] + params, grads)]
        return (None, None, None, grads[0], grads[1], None, *grads[2:])


def field_render_trainable(field, packed, freq, phase, z_vals, num_steps: int,
                           white_back: bool = False, last_back: bool = False,
                           compute_dtype=torch.bfloat16, exact_sin: bool = False,
                           fold_film: bool = True, pallas_bwd: bool = True):
    """``fused_field_render`` with gradients for the field and freq/phase
    (JAX ``fused_field_render_trainable``); the forward kernel as
    ``fold_film`` selects it; the K8/K9 backward (``FieldRender``), or with
    ``pallas_bwd=False`` the remat backward (``FieldRenderRemat``)."""
    opts = (num_steps, white_back, last_back, compute_dtype, exact_sin, fold_film)
    fn = FieldRender if pallas_bwd else FieldRenderRemat
    return fn.apply(field, opts, packed, freq, phase, z_vals, *field.parameters())


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


# the widest padded width of one product of K8/K9: 54 n8 tiles, 18 for each
# of the 3 consumer warpgroups (csrc/synthesis_core.cuh), as K2's
MAX_FIELD_WIDTH = 8 * rm.FIELD_UNITS
_STREAM_INDEX: Dict = {}  # widths, device -> (gather map, chunk sizes)


def field_bwd_dims(w, n_blocks: int) -> Dict:
    """K8's and K9's padded widths: K2's (``field_dims``: the first layer's
    column products ``first``, the colour product's nc with w_sigma in
    column H) with the head padded to 16 (headp, the width of K9's operand
    dyh); ``fwd_bytes`` and ``bwd_bytes`` the two halves of
    ``pack_field_bwd_stream``.  Raises above the kernels' widths."""
    H, F = w["w_coord"].shape[1], w["w_feat"].shape[1]
    d = rm.field_dims(3 + w["w_geo"].shape[0], H, F, n_blocks)
    d["headp"] = round16(F + 3)
    k0p, n0p, hp, nc, headp, NB = (d[k] for k in ("k0p", "n0p", "hp", "nc", "headp", "NB"))
    if max(hp, nc, headp) > MAX_FIELD_WIDTH:
        raise ValueError(f"the field backward kernels take products of at most "
                         f"{MAX_FIELD_WIDTH} columns: hidden {H} pads to {hp} ({nc} with the "
                         f"sigma column), the head {F + 3} to {headp}")
    d["fwd_bytes"] = 2 * (k0p * n0p + n0p * hp + (NB - 1) * hp * hp + hp * nc + hp * headp)
    d["bwd_bytes"] = 2 * (headp * hp + hp * hp + (NB - 1) * hp * hp + hp * n0p)
    return d


def field_bwd_stream_index(d):
    """The gather map of ``pack_field_bwd_stream`` (int32, into
    ``field_source`` and its trailing 0) and the bytes of each chunk.  The
    stream holds, as ``chunk_images`` in the order the kernels consume them:

      forward half (K8 walks it alone): K2's products (``field_index_mats``)
          with neither omega nor freq folded: the first layer [coords | geo]
          block-diagonal (k0p x n0p) in column products of ``d["first"]``,
          w_net0 (n0p x hp), the NB-1 trunk layers (hp x hp), the colour
          layer w_color_x (hp x nc) with w_sigma in column H, the head [rgb 3
          | feat F] (hp x headp);
      backward half (K9 walks it after the forward): W_head^T (headp x hp),
          W_color_x^T (hp x hp, without w_sigma), W_net{NB-1}^T .. W_net1^T
          (hp x hp), W_net0^T (hp x n0p) in column products of ``d["first"]``."""
    H, hp, NB = d["H"], d["hp"], d["NB"]
    fwd = [v for v, _ in rm.field_index_mats(d)]
    n_first = len(d["first"])
    net, color, head = fwd[n_first:n_first + NB], fwd[-2], fwd[-1]
    _, zero = rm.field_source_offsets(d)
    color_x = color[:, :hp].clone()
    if H < hp:
        color_x[:, H] = zero  # w_sigma's column
    bwd = [head.t(), color_x.t()] + [net[i].t() for i in range(NB - 1, 0, -1)]
    net0_t = net[0].t()
    c0 = 0
    for n in d["first"]:
        bwd.append(net0_t[:, c0:c0 + n])
        c0 += n
    return rm.chunk_map(fwd + bwd)


def pack_field_bwd_stream(w, d, forward_only: bool = False):
    """Every weight K8 and K9 read, as one bf16 stream of chunk images (see
    ``field_bwd_stream_index``; the first ``d["fwd_bytes"]`` are the forward
    half, all that K4, K5 and K8 read, and ``forward_only`` packs that half
    alone), on w's device: one gather of the field's own float32 weights
    through a map built once per widths and device, rounded to bf16 once, so
    every value is bit-equal to the padded tables of the field's weights
    (and to their transposes).  The same stream serves every image.  w:
    ``flat_weights``.  Returns (stream, the bytes of each chunk)."""
    dev = w["w_coord"].device
    key = (d["n_in"], d["H"], d["F"], d["NB"], str(dev))
    if key not in _STREAM_INDEX:
        idx, sizes = field_bwd_stream_index(d)
        _STREAM_INDEX[key] = (idx.to(dev), sizes)
    idx, sizes = _STREAM_INDEX[key]
    if forward_only:
        idx = idx[:d["fwd_bytes"] // 2]
        sizes = sizes[:list(itertools.accumulate(sizes)).index(d["fwd_bytes"]) + 1]
    flat = torch.cat([rm.field_source(w), w["w_coord"].new_zeros(1)])
    return flat.index_select(0, idx).to(torch.bfloat16), sizes


def field_bwd_side_tables(w, freq_k, phase_k, d):
    """K8's and K9's float32 tables beside the stream, zero-padded, in the C
    order: b_first (n0p), b_net (NB, hp), freq*15+30 and phase (B, NB, nc),
    w_color_d (3, nc) and w_sigma (hp) as bf16 values, b_color (nc),
    b_sigma (1), b_head (headp) — the field's weights, padded."""
    f32, bf16 = torch.float32, torch.bfloat16
    B, NB, _ = freq_k.shape
    n0p, hp, nc = d["n0p"], d["hp"], d["nc"]
    return [
        pad_to(torch.cat([w["b_coord"], w["b_geo"]]), (n0p,), f32),
        pad_to(torch.stack([w[f"b_net{i}"] for i in range(NB)], 0), (NB, hp), f32),
        pad_to(freq_k, (B, NB, nc), f32),
        pad_to(phase_k, (B, NB, nc), f32),
        pad_to(w["w_color"][:3].to(bf16), (3, nc), f32),
        pad_to(w["w_sigma"][:, 0].to(bf16), (hp,), f32),
        pad_to(w["b_color"], (nc,), f32),
        w["b_sigma"].reshape(1).float().contiguous(),
        pad_to(torch.cat([w["b_rgb"], w["b_feat"]]), (d["headp"],), f32),
    ]


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


def kernel_ints(d, B, P, num_steps, n_cols, exact_sin):
    """The int arguments that the C entries of K4, K5, K8 and K9 begin with."""
    return [B, P, num_steps, n_cols, d["n_in"], d["H"], d["k0p"], d["n0p"], d["hp"], d["nc"],
            d["headp"], d["NB"], d["F"] + 3, int(exact_sin)]


def _field_dims(w, n_blocks):
    """``field_bwd_dims``; raises on a field the kernels do not take."""
    d = field_bwd_dims(w, n_blocks)
    if d["n_in"] != rm.INPUT_PACK - 3:
        raise ValueError(f"the packed inputs carry {rm.INPUT_PACK - 3} field inputs, the field "
                         f"takes {d['n_in']}")
    return d


def field_forward_operands(w, freq_k, phase_k):
    """What K4, K5 and K8 read beside their inputs and outputs, in the C
    order: the forward half of ``pack_field_bwd_stream`` and the side
    tables.  Returns (the widths, ``field_bwd_dims``; the operands)."""
    d = _field_dims(w, freq_k.shape[1])
    stream, _ = pack_field_bwd_stream(w, d, forward_only=True)
    return d, [stream] + field_bwd_side_tables(w, freq_k, phase_k, d)


def field_stats_operands(w, packed, freq_k, phase_k, g_out, num_steps: int, exact_sin=False):
    """K8's host glue before the launch: the forward half of
    ``pack_field_bwd_stream``, the side tables and the outputs, in the C
    order."""
    _check_rows(packed, num_steps)
    d, fwd = field_forward_operands(w, freq_k, phase_k)
    B, P, n_cols = packed.shape
    sigma = torch.empty(B, P, dtype=torch.float32, device=packed.device)
    gdot = torch.empty_like(sigma)
    ops = [packed.to(torch.bfloat16).contiguous(), g_out.float().contiguous()] + fwd + [sigma, gdot]
    return dict(d=d, ops=ops, ints=kernel_ints(d, B, P, num_steps, n_cols, exact_sin),
                stream_bytes=fwd[0].numel() * 2, dev=packed.device, sigma=sigma, gdot=gdot,
                shape=(B, P // num_steps, num_steps))


def field_stats_body(op):
    """Launch K8's kernel on the operands of ``field_stats_operands``."""
    global launches_stats
    dev = op["dev"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("thgt_field_stats", *rm.cuda_ptrs(op["ops"], "field backward kernel"),
                *op["ints"], op["stream_bytes"], stream)
    launches_stats += 1


def field_stats_cuda(w, packed, freq_k, phase_k, g_out, num_steps: int, exact_sin=False):
    """Launch K8; same contract as ``field_stats_plain``."""
    op = field_stats_operands(w, packed, freq_k, phase_k, g_out, num_steps, exact_sin)
    field_stats_body(op)
    return op["sigma"].reshape(op["shape"]), op["gdot"].reshape(op["shape"])


WGRAD_TILE = 128  # output rows and columns a CTA of csrc/wgrad.cu owns
WGRAD_CHUNK = 64  # rows of X and Y a stage of its ring holds


def wgrad_plan(rows, K, N, sms):
    """The row chunks of ``wgrad``: (chunk_rows, n_chunks), chunk_rows a
    multiple of WGRAD_CHUNK.  The output tiles times the chunks fill the
    card's ``sms`` SMs once (one CTA an SM), so the CTAs of one chunk run
    together and its rows leave device memory once."""
    tiles = -(-K // WGRAD_TILE) * -(-N // WGRAD_TILE)
    steps = -(-rows // WGRAD_CHUNK)
    n_chunks = max(1, min(steps, sms // tiles))
    chunk_rows = -(-steps // n_chunks) * WGRAD_CHUNK
    return chunk_rows, -(-rows // chunk_rows)


def wgrad_plain(X, Y):
    """Plain ``wgrad``: the f32 product of the bf16 operands."""
    return torch.matmul(X.float().t(), Y.float())


def wgrad(X, Y, stream=None):
    """sum over rows of X^T Y: X (rows, K), Y (rows, N) bf16 -> (K, N) f32.
    CUDA tensors launch csrc/wgrad.cu on ``stream`` (per-CTA partials over
    row chunks, reduced here in a fixed order); CPU tensors take
    ``wgrad_plain``.  Callers count the launch (K9 here, K11 in
    ops/synthesis_train.py)."""
    if X.device.type == "cpu":
        return wgrad_plain(X, Y)
    rows, K = X.shape
    N = Y.shape[1]
    if X.dtype != torch.bfloat16 or Y.dtype != torch.bfloat16 or Y.shape[0] != rows:
        raise ValueError("wgrad takes bf16 X (rows, K) and Y (rows, N)")
    if not (X.is_contiguous() and Y.is_contiguous()):
        raise ValueError("wgrad operands must be contiguous")
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    chunk_rows, n_chunks = wgrad_plan(rows, K, N, sms)
    part = torch.empty(n_chunks, K, N, dtype=torch.float32, device=X.device)
    _launch("thgt_wgrad", X.data_ptr(), Y.data_ptr(), part.data_ptr(), K, N, rows, chunk_rows,
            n_chunks, stream)
    return part.sum(0)


def _wgrad(X, Y, stream):
    global launches_wgrad
    out = wgrad(X, Y, stream)
    launches_wgrad += 1
    return out


SUM_SLOTS = 4  # rows of column sums a K9 CTA writes, one per warp of a warpgroup


def _n_ws(d):
    """Columns of K9's per-warp sums: du (n0p), then 3 x hp for each trunk
    layer and the colour layer (sum dv, sum dpre v, sum dpre)."""
    return d["n0p"] + 3 * d["hp"] * (d["NB"] + 1)


def _n_part(d):
    """Columns of an image's column sums: K9's per-warp ones, the head's
    bias grads (headp) and b_sigma's."""
    return _n_ws(d) + d["headp"] + 1


def field_bwd_step_operands(w, packed, freq_k, phase_k, g_out, coef, dsigma, num_steps: int,
                            exact_sin=False):
    """K9's host glue before its launches: ``pack_field_bwd_stream``, the
    side tables, the inputs and one launch's buffers (flat, shaped per
    group of images by ``_group``; the launches run in order on one stream,
    so each reuses them)."""
    _check_rows(packed, num_steps)
    d = _field_dims(w, freq_k.shape[1])
    B, P, n_cols = packed.shape
    hp, n0p, headp, NB = d["hp"], d["n0p"], d["headp"], d["NB"]
    bf16, f32, dev = torch.bfloat16, torch.float32, packed.device
    cap = min(B, IMAGES_PER_LAUNCH) * P  # rows of one launch at most
    tiles = cap // ROWS_PER_CTA
    sizes = dict(x0=d["k0p"], xs0=n0p, xsk=max(NB - 1, 1) * hp, xcol=hp + 16, xc=hp, du=n0p,
                 dv=NB * hp, dcol=hp + 16, dyh=headp)
    flat = {k: torch.empty(cap * n, dtype=bf16, device=dev) for k, n in sizes.items()}
    flat.update(U=torch.empty(cap * n0p, dtype=f32, device=dev),
                V=torch.empty(cap * NB * hp, dtype=f32, device=dev),
                VC=torch.empty(cap * hp, dtype=f32, device=dev),
                part=torch.empty(tiles * SUM_SLOTS * _n_ws(d), dtype=f32, device=dev),
                hsum=torch.empty(tiles * (headp + 1), dtype=f32, device=dev))
    stream, _ = pack_field_bwd_stream(w, d)
    ins = [packed.to(bf16).contiguous(), g_out.float().contiguous(),
           coef.reshape(B, P).float().contiguous(), dsigma.reshape(B, P).float().contiguous()]
    return dict(d=d, B=B, P=P, S=num_steps, n_cols=n_cols, exact_sin=exact_sin, dev=dev,
                stream=stream, tabs=field_bwd_side_tables(w, freq_k, phase_k, d), ins=ins,
                flat=flat, names=list(w))


def _group(op, b0):
    """Images [b0, b1) of one K9 launch and its buffers shaped for them."""
    d, P = op["d"], op["P"]
    b1 = min(op["B"], b0 + IMAGES_PER_LAUNCH)
    rows = (b1 - b0) * P
    hp, NB = d["hp"], d["NB"]

    def v(name, *shape):
        n = 1
        for s in shape:
            n *= s
        return op["flat"][name][:n].view(*shape)

    bufs = dict(x0=v("x0", rows, d["k0p"]), xs0=v("xs0", rows, d["n0p"]),
                xsk=v("xsk", max(NB - 1, 1), rows, hp), xcol=v("xcol", rows, hp + 16),
                xc=v("xc", rows, hp), du=v("du", rows, d["n0p"]), dv=v("dv", NB, rows, hp),
                dcol=v("dcol", rows, hp + 16), dyh=v("dyh", rows, d["headp"]),
                U=v("U", rows, d["n0p"]), V=v("V", NB, rows, hp), VC=v("VC", rows, hp),
                part=v("part", rows // ROWS_PER_CTA, SUM_SLOTS, _n_ws(d)),
                hsum=v("hsum", rows // ROWS_PER_CTA, d["headp"] + 1))
    return b1, bufs


_SAVED_ORDER = ("x0", "xs0", "xsk", "xcol", "xc", "du", "dv", "dcol", "dyh", "U", "V", "VC",
                "part", "hsum")


def field_bwd_step_body(op, b0):
    """Launch K9's kernel on images [b0, b0 + IMAGES_PER_LAUNCH) of
    ``field_bwd_step_operands``."""
    global launches_bwd
    b1, bufs = _group(op, b0)
    dev = op["dev"]
    tabs = list(op["tabs"])
    tabs[2], tabs[3] = tabs[2][b0:b1], tabs[3][b0:b1]  # this group's freq and phase
    args = ([x[b0:b1] for x in op["ins"]] + [op["stream"]] + tabs
            + [bufs[k] for k in _SAVED_ORDER])
    ints = kernel_ints(op["d"], b1 - b0, op["P"], op["S"], op["n_cols"], op["exact_sin"])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("thgt_field_bwd", *rm.cuda_ptrs(args, "field backward kernel"), *ints,
                op["stream"].numel() * 2, stream)
    launches_bwd += 1


def field_bwd_step_pairs(op, b0):
    """The (X, Y) operands of each weight-gradient product of one launch."""
    _, bufs = _group(op, b0)
    prods = {"first": (bufs["x0"], bufs["du"]), "net0": (bufs["xs0"], bufs["dv"][0]),
             "color": (bufs["xcol"], bufs["dcol"]), "head": (bufs["xc"], bufs["dyh"])}
    prods.update({f"net{i}": (bufs["xsk"][i - 1], bufs["dv"][i]) for i in range(1, op["d"]["NB"])})
    return prods


def field_bwd_step_products(op, b0):
    """One launch's weight-gradient products, X^T Y of each operand pair."""
    dev = op["dev"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return {k: _wgrad(X, Y, stream) for k, (X, Y) in field_bwd_step_pairs(op, b0).items()}


def field_bwd_step_partials(op, b0):
    """One launch's column sums per image, (images, n_part), each summed over
    the image's CTAs and warps in a fixed order."""
    b1, bufs = _group(op, b0)
    n = b1 - b0
    return torch.cat([bufs["part"].reshape(n, -1, _n_ws(op["d"])).sum(1),
                      bufs["hsum"].reshape(n, -1, op["d"]["headp"] + 1).sum(1)], 1)


def field_bwd_step_reduce(op, gw, part):
    """The grads from the summed weight-gradient products ``gw`` (padded)
    and the per-image column sums ``part`` (B, n_part), cut to the field's
    widths."""
    d = op["d"]
    hp, n0p, headp, NB, H, F = d["hp"], d["n0p"], d["headp"], d["NB"], d["H"], d["F"]
    G = d["n_in"] - 3
    tot = part.sum(0)
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
    d_freq = part.new_zeros(op["B"], NB, H)
    d_phase = torch.zeros_like(d_freq)
    for i in range(NB):
        o = n0p + 3 * hp * i
        grads[f"w_net{i}"] = gw[f"net{i}"][:(2 * H if i == 0 else H), :H]
        grads[f"b_net{i}"] = tot[o:o + H]
        d_freq[:, i] = part[:, o + hp:o + hp + H]
        d_phase[:, i] = part[:, o + 2 * hp:o + 2 * hp + H]
    d_freq[:, -1] += part[:, off_c + hp:off_c + hp + H]
    d_phase[:, -1] += part[:, off_c + 2 * hp:off_c + 2 * hp + H]
    return {k: grads[k].contiguous() for k in op["names"]}, d_freq, d_phase


def field_bwd_step_cuda(w, packed, freq_k, phase_k, g_out, coef, dsigma, num_steps: int,
                        exact_sin=False):
    """Launch K9 once per ``IMAGES_PER_LAUNCH`` images, each launch followed
    by its weight-gradient products; same contract as
    ``field_bwd_step_plain``."""
    op = field_bwd_step_operands(w, packed, freq_k, phase_k, g_out, coef, dsigma, num_steps,
                                 exact_sin)
    gw, parts = {}, []
    for b0 in range(0, op["B"], IMAGES_PER_LAUNCH):
        field_bwd_step_body(op, b0)
        for k, g in field_bwd_step_products(op, b0).items():
            gw[k] = gw[k] + g if k in gw else g
        parts.append(field_bwd_step_partials(op, b0))
    return field_bwd_step_reduce(op, gw, torch.cat(parts, 0))
