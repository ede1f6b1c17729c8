"""K10 + K11: the trainable fused SPADE half-block (train-mode synthesis).

Replaces threedhumangan_tpu/ops/synthesis_train.py (Pallas): ``_fwd_kernel``
(K10) and ``_bwd_kernel`` (K11), the custom VJP built by
``_make_half_block``.  One half-block of a SPADEBlock in train mode:

    nhat = (h - m) * r            # batch-stat normalise; (m, r) are ARGUMENTS
    u    = nhat * a + b           # BN affine, f32, then the compute dtype
    s    = u * gamma + beta       # SPADE modulation in the compute dtype
    t    = lrelu(s)
    out  = t @ W + c              # spectral-normalised 1x1 conv

``spatial``: gamma/beta from the per-pixel SPADE MLP on the style map (plus
an optional per-image ``fixed`` row added to the style, mixed/all modes);
``rank1``: gamma/beta are per-image rows computed outside.

The batch moments (m, r = rsqrt(var + eps)) enter as differentiable
arguments: ``HalfBlock`` reports dL/dm = -r * sum(dnhat) and dL/dr =
sum(dnhat * nhat) / r, and autograd carries them through the plain
``sync_bn_moments`` in models/synthesis.py, so the batch-norm coupling
through the moments is exact.  The Function saves its inputs, not its
activations: the backward recomputes the chain per tile, as K11 does.  No
double backward (R1 differentiates the discriminator only).

``half_block_forward`` / ``half_block_backward`` are the plain versions
(the JAX kernels' math, rounding to the compute dtype where they do).
``HalfBlock`` launches csrc/synthesis_train.cu (K10) and
csrc/synthesis_train_bwd.cu (K11, its weights packed by ``pack_bwd_stream``;
its weight-gradient products through csrc/wgrad.cu) on CUDA tensors (bf16 only)
and runs the plain versions on CPU tensors.  The TPU's scoped-VMEM tile
model (``estimate_half_block_vmem`` / ``auto_tile_rows``) has no
counterpart: the CUDA kernels fix their own 64-pixel tile.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from threedhumangan_tpu_torch import _build
from threedhumangan_tpu_torch.ops import raymarch_bwd
from threedhumangan_tpu_torch.ops.synthesis_kernel import (CHUNK_ROWS, _lrelu, chunk_images,
                                                           gamma_beta_pass)
from threedhumangan_tpu_torch.utils.misc import mm, pad_to, round16

launches_fwd = 0    # K10 launches (the CUDA path only)
launches_bwd = 0    # K11 launches (the CUDA path only)
launches_wgrad = 0  # K11's weight-gradient kernel launches (the CUDA path only)

MLP_NAMES = ("sh_w", "sh_b", "g_w", "g_b", "bt_w", "bt_b")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def spade_mlp(st, mlp: Dict[str, torch.Tensor], cd):
    """SPADE MLP on a style map -> (z0 pre-relu f32, actv, gamma, beta), the
    last three in ``cd`` (JAX ``_spade_mlp``: gamma = cd(cd(actv g_w + g_b) + 1))."""
    z0 = mm(st, mlp["sh_w"], cd) + mlp["sh_b"].float()
    actv = torch.relu(z0).to(cd)
    gam = (mm(actv, mlp["g_w"], cd) + mlp["g_b"].float()).to(cd) + 1.0
    bet = (mm(actv, mlp["bt_w"], cd) + mlp["bt_b"].float()).to(cd)
    return z0, actv, gam, bet


def _modulation(h, style, fixed, gam, bet, mlp, cd):
    """(style input st, z0, actv, gamma, beta) broadcastable over h (B, H, W, C)."""
    if style is not None:
        st = style.to(cd)
        if fixed is not None:
            st = st + fixed.to(cd)[:, None, None, :]
        z0, actv, g, bt = spade_mlp(st, mlp, cd)
        return st, z0, actv, g, bt
    B = h.shape[0]
    return None, None, None, gam.to(cd).reshape(B, 1, 1, -1), bet.to(cd).reshape(B, 1, 1, -1)


def _half_forward(h, m, r, a, b, gam, bet, cd):
    """BN in f32 -> cast -> modulation and lrelu in ``cd`` (JAX ``_half_forward``)."""
    nhat = (h.float() - m.float()) * r.float()
    u = (nhat * a.float() + b.float()).to(cd)
    s = u * gam.to(cd) + bet.to(cd)
    return nhat, u, s, _lrelu(s)


def half_block_forward(h, style, fixed, gam, bet, m, r, a, b, mlp, w, c,
                       compute_dtype=torch.bfloat16):
    """Plain K10: (B, H, W, Co) in ``compute_dtype``."""
    cd = compute_dtype
    _, _, _, g_px, b_px = _modulation(h, style, fixed, gam, bet, mlp, cd)
    t = _half_forward(h, m, r, a, b, g_px, b_px, cd)[3]
    return (mm(t, w, cd) + c.float()).to(cd)


def _outer(x, dy, cd):
    """x^T dy over all leading dims, operands rounded to ``cd``, f32 sums."""
    return mm(x.reshape(-1, x.shape[-1]).t(), dy.reshape(-1, dy.shape[-1]), cd)


def half_block_backward(h, style, fixed, gam, bet, m, r, a, b, mlp, w, g,
                        compute_dtype=torch.bfloat16) -> Dict[str, Optional[torch.Tensor]]:
    """Plain K11 and its wrapper's algebra (JAX ``_bwd_kernel`` + ``bwd_rule``):
    the cotangent of every input of the half-block from the output's ``g``."""
    cd = compute_dtype
    f32 = torch.float32
    px = (0, 1, 2)
    st, z0, actv, g_px, b_px = _modulation(h, style, fixed, gam, bet, mlp, cd)
    nhat, u, s, t = _half_forward(h, m, r, a, b, g_px, b_px, cd)
    out = {"dw": _outer(t, g, cd), "dc": g.float().sum(px)}
    dt = mm(g, w.t(), cd)
    # lrelu'(s): the JAX kernel's where on f32 operands, slope f32 0.2
    ds = dt * torch.where(s.float() >= 0.0, 1.0, 0.2)
    u32 = u.float()
    if style is not None:
        dgam_px = ds * u32
        dactv = (mm(dgam_px, mlp["g_w"].t(), cd) + mm(ds, mlp["bt_w"].t(), cd)) * (z0 > 0.0).to(f32)
        dsty = mm(dactv, mlp["sh_w"].t(), cd).to(style.dtype)
        out.update(dsty=dsty, dg_w=_outer(actv, dgam_px, cd), dg_b=dgam_px.sum(px),
                   dbt_w=_outer(actv, ds, cd), dbt_b=ds.sum(px),
                   dsh_w=_outer(st, dactv, cd), dsh_b=dactv.sum(px))
        out["dfixed"] = (dsty.float().sum((1, 2)).to(fixed.dtype) if fixed is not None
                         else None)
    else:
        out["dgam"] = (ds * u32).sum((1, 2)).to(gam.dtype)
        out["dbet"] = ds.sum((1, 2)).to(bet.dtype)
    du = ds * g_px.float()
    dnhat = du * a.float()
    r32 = r.float()
    out.update(da=(du * nhat).sum(px), db=du.sum(px),
               dm=(-r32 * dnhat.sum(px)).to(m.dtype),
               dr=((dnhat * nhat).sum(px) / r32).to(r.dtype),
               dh=(dnhat * r32).to(h.dtype))
    return out


# ---------------------------------------------------------------------------
# the differentiable half-block
# ---------------------------------------------------------------------------


class HalfBlock(torch.autograd.Function):
    """The custom VJP of the JAX package (``_make_half_block``): forward K10
    (or the plain version on the CPU), backward K11 (or the plain version).
    Saves the inputs only.  Arguments after ``compute_dtype``: h, style,
    fixed, gam, bet, m, r, a, b, the six MLP tensors (``MLP_NAMES``), w, c;
    the ones a variant does not use are None."""

    @staticmethod
    def forward(ctx, compute_dtype, h, style, fixed, gam, bet, m, r, a, b, *rest):
        mlp = dict(zip(MLP_NAMES, rest[:6])) if style is not None else None
        w, c = rest[6:]
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(h, style, fixed, gam, bet, m, r, a, b, *rest[:6], w)
        return _dispatch(h, "forward")(h, style, fixed, gam, bet, m, r, a, b, mlp, w, c,
                                       compute_dtype)

    @staticmethod
    def backward(ctx, g):
        h, style, fixed, gam, bet, m, r, a, b, *rest = ctx.saved_tensors
        mlp = dict(zip(MLP_NAMES, rest[:6])) if style is not None else None
        w = rest[6]
        d = _dispatch(h, "backward")(h, style, fixed, gam, bet, m, r, a, b, mlp, w,
                                     g.contiguous(), ctx.compute_dtype)
        dmlp = ([d[f"d{n}"].to(mlp[n].dtype) for n in MLP_NAMES] if mlp is not None
                else [None] * 6)
        return (None, d["dh"], d.get("dsty"), d.get("dfixed"), d.get("dgam"), d.get("dbet"),
                d["dm"], d["dr"], d["da"].to(a.dtype), d["db"].to(b.dtype), *dmlp,
                d["dw"].to(w.dtype), d["dc"])


def _dispatch(h, which):
    if h.device.type == "cpu":
        return half_block_forward if which == "forward" else half_block_backward
    if h.device.type != "cuda":
        raise ValueError(f"SPADE half-block: unsupported device {h.device}")
    return half_block_forward_cuda if which == "forward" else half_block_backward_cuda


def spade_half_block_spatial(h, style, fixed: Optional[torch.Tensor], m, r, a, b,
                             mlp: Dict[str, torch.Tensor], w, c,
                             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused norm + SPADE (per-pixel MLP on ``style`` (B, H, W, Cs), plus the
    (B, Cs) ``fixed`` row when given) + lrelu + conv ``w`` (Ci, Co), ``c``
    (Co,).  Differentiable in every tensor argument."""
    return HalfBlock.apply(compute_dtype, h, style, fixed, None, None, m, r, a, b,
                           *(mlp[n] for n in MLP_NAMES), w, c)


def spade_half_block_rank1(h, gam, bet, m, r, a, b, w, c,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Fused half-block with per-image (B, Ci) gamma/beta rows (global-style
    blocks; the SPADE MLP runs pre-broadcast outside)."""
    return HalfBlock.apply(compute_dtype, h, None, None, gam, bet, m, r, a, b,
                           *([None] * 6), w, c)


# ---------------------------------------------------------------------------
# CUDA path (csrc/synthesis_train.cu, csrc/synthesis_train_bwd.cu)
# ---------------------------------------------------------------------------

PIXELS_PER_CTA = 64
MAX_BWD_WIDTH = 432  # K11 keeps 64 x (3 Ci + ...) bf16 tiles in one CTA's shared memory


def _dims(h, style, w, mlp):
    B, H, W, ci = h.shape
    co = w.shape[1]
    cs = style.shape[-1] if style is not None else 0
    hid = mlp["sh_w"].shape[1] if mlp is not None else 0
    return dict(B=B, HW=H * W, ci=ci, cs=cs, co=co, cip=round16(ci), csp=round16(cs),
                cop=round16(co), hid=hid, hidp=round16(hid),
                tiles=-(-(H * W) // PIXELS_PER_CTA))


def _operands(h, style, fixed, gam, bet, m, r, a, b, mlp, d):
    """Zero-padded kernel operands of K10, in the C order."""
    bf16, f32 = torch.bfloat16, torch.float32
    dev = h.device
    dummy = torch.zeros(16, dtype=f32, device=dev)
    row = lambda t: pad_to(t.reshape(-1), (d["cip"],), f32)
    ops = [h.to(bf16).contiguous()]
    if style is not None:
        ops += [style.to(bf16).contiguous(),
                fixed.reshape(d["B"], -1).to(bf16).contiguous() if fixed is not None else dummy,
                dummy, dummy]
    else:
        ops += [dummy, dummy, pad_to(gam.reshape(d["B"], -1), (d["B"], d["cip"]), bf16),
                pad_to(bet.reshape(d["B"], -1), (d["B"], d["cip"]), bf16)]
    ops += [row(m), row(r), row(a), row(b)]
    if style is not None:
        ops += [pad_to(mlp["sh_w"], (d["csp"], d["hidp"]), bf16),
                pad_to(mlp["sh_b"], (d["hidp"],), f32),
                pad_to(mlp["g_w"], (d["hidp"], d["cip"]), bf16), row(mlp["g_b"]),
                pad_to(mlp["bt_w"], (d["hidp"], d["cip"]), bf16), row(mlp["bt_b"])]
    else:
        ops += [dummy] * 6
    return ops


def _ints(d, style, fixed):
    return [d["B"], d["HW"], d["ci"], d["cs"], d["co"], d["cip"], d["csp"], d["cop"], d["hidp"],
            int(style is not None), int(fixed is not None)]


def _ptrs(ts, dev):
    for t in ts:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"half-block kernel operands must be contiguous tensors on {dev}")
    return [t.data_ptr() for t in ts]


def _check_dtype(compute_dtype):
    if compute_dtype != torch.bfloat16:
        raise ValueError("the SPADE half-block kernels compute in bfloat16 only")


def half_block_forward_cuda(h, style, fixed, gam, bet, m, r, a, b, mlp, w, c,
                            compute_dtype=torch.bfloat16):
    """Launch K10; same contract as ``half_block_forward``."""
    global launches_fwd
    _check_dtype(compute_dtype)
    d = _dims(h, style, w, mlp)
    dev = h.device
    ops = _operands(h, style, fixed, gam, bet, m, r, a, b, mlp, d)
    ops += [pad_to(w, (d["cip"], d["cop"]), torch.bfloat16),
            pad_to(c, (d["cop"],), torch.float32)]
    out = torch.empty(h.shape[:3] + (d["co"],), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().thgt_half_block_fwd(*_ptrs(ops + [out], dev),
                                                   *_ints(d, style, fixed), stream)
    _build.check(err, "thgt_half_block_fwd")
    launches_fwd += 1
    return out


def _wgrad(X, Y, stream):
    global launches_wgrad
    out = raymarch_bwd.wgrad(X, Y, stream)
    launches_wgrad += 1
    return out


SUM_SLOTS = 4  # rows of column sums a K11 CTA writes, one per warp of a warpgroup
_STREAM_INDEX: Dict = {}  # widths, variant, device -> (gather map, chunk sizes)


def bwd_stream_index(d, spatial):
    """The gather map of ``pack_bwd_stream``: for each element of K11's
    weight stream, its index into the flat source [W, sh_w, g_w, bt_w, 0]
    (the trailing 0 fills the padding), and the bytes of each chunk.  The
    stream holds, as ``chunk_images`` in the order the kernel consumes them:
    sh_w (csp x hidp), the gamma/beta heads in two column passes of
    ``gamma_beta_pass`` (hidp x cip each), W^T (cop x cip), [g_w; bt_w]^T
    (2 cip x hidp) and sh_w^T (hidp x csp); rank-1 holds W^T alone."""
    ci, co, cs, hid = d["ci"], d["co"], d["cs"], d["hid"]
    cip, cop, csp, hidp = d["cip"], d["cop"], d["csp"], d["hidp"]
    n_w, n_sh, n_g = ci * co, (cs * hid if spatial else 0), (hid * ci if spatial else 0)
    zero = n_w + n_sh + 2 * n_g

    def block(off, rows, cols, shape):
        idx = torch.full(shape, zero, dtype=torch.int64)
        idx[:rows, :cols] = torch.arange(off, off + rows * cols).reshape(rows, cols)
        return idx

    w = block(0, ci, co, (cip, cop))
    mats = []
    if spatial:
        sh = block(n_w, cs, hid, (csp, hidp))
        gw = block(n_w + n_sh, hid, ci, (hidp, cip))
        bt = block(n_w + n_sh + n_g, hid, ci, (hidp, cip))
        mats += [sh, gamma_beta_pass(gw, bt, 0), gamma_beta_pass(gw, bt, 1)]
    mats.append(w.t())
    if spatial:
        mats += [torch.cat([gw.t(), bt.t()], 0), sh.t()]
    idx = torch.cat([chunk_images(x.contiguous()) for x in mats])
    sizes = [CHUNK_ROWS * x.shape[1] * 2 for x in mats for _ in range(x.shape[0] // CHUNK_ROWS)]
    return idx, sizes


def pack_bwd_stream(w, mlp, d):
    """Every weight K11's body reads, as one bf16 stream of chunk images (see
    ``bwd_stream_index``), on w's device: one gather of the concatenated
    weights through a map built once per shape.  Returns (stream, sizes)."""
    spatial = mlp is not None
    key = (d["ci"], d["co"], d["cs"], d["hid"], spatial, str(w.device))
    if key not in _STREAM_INDEX:
        idx, sizes = bwd_stream_index(d, spatial)
        _STREAM_INDEX[key] = (idx.to(w.device), sizes)
    idx, sizes = _STREAM_INDEX[key]
    src = [w] + ([mlp["sh_w"], mlp["g_w"], mlp["bt_w"]] if spatial else [])
    flat = torch.cat([t.reshape(-1).float() for t in src] + [w.new_zeros(1, dtype=torch.float32)])
    return flat[idx].to(torch.bfloat16), sizes


def bwd_operands(h, style, fixed, gam, bet, m, r, a, b, mlp, w, g):
    """K11's host glue before the launch: the weight stream, the padded
    tables, the outputs and the weight-gradient operand buffers, in the C
    order."""
    d = _dims(h, style, w, mlp)
    if d["cip"] > MAX_BWD_WIDTH:
        raise ValueError(f"the half-block backward kernel takes at most {MAX_BWD_WIDTH} "
                         f"channels, got {d['ci']}")
    bf16, f32, dev = torch.bfloat16, torch.float32, h.device
    spatial = style is not None
    B, co, cs, cip, cop, csp, hidp = (d[k] for k in ("B", "co", "cs", "cip", "cop", "csp",
                                                      "hidp"))
    rows = B * d["tiles"] * PIXELS_PER_CTA
    n_part = cop + 4 * cip + (hidp if spatial else 0)
    e = lambda *shape, dt=bf16: torch.empty(*shape, dtype=dt, device=dev)
    dummy = torch.zeros(16, dtype=f32, device=dev)
    row = lambda t, n: F.pad(t.reshape(-1).float(), (0, n - t.numel()))
    stream, _ = pack_bwd_stream(w, mlp, d)
    g = g.to(bf16).contiguous()
    # g is the operand of dW = t^T g when the tiles cover the pixels exactly
    yg = None if d["HW"] % PIXELS_PER_CTA == 0 and co == cop else e(rows, cop)
    prods = {"dw": (e(rows, cip), g.reshape(rows, co) if yg is None else yg)}
    ins = [h.to(bf16).contiguous()]
    if spatial:
        ins += [style.to(bf16).contiguous(),
                fixed.reshape(B, -1).to(bf16).contiguous() if fixed is not None else dummy,
                dummy, dummy]
    else:
        ins += [dummy, dummy, pad_to(gam.reshape(B, -1), (B, cip), bf16),
                pad_to(bet.reshape(B, -1), (B, cip), bf16)]
    ins += [row(m, cip), row(r, cip), row(a, cip), row(b, cip)]
    if spatial:
        ins += [row(mlp["sh_b"], hidp), row(mlp["g_b"], cip), row(mlp["bt_b"], cip)]
        dsty = e(*h.shape[:3], cs)
        prods.update(dsh_w=(e(rows, csp), e(rows, hidp)), dgb=(e(rows, hidp), e(rows, 2 * cip)))
        xst, ydact = prods["dsh_w"]
        xact, ygb = prods["dgb"]
    else:
        ins += [dummy] * 3
        dsty = xst = xact = ygb = ydact = dummy
    dh = e(*h.shape)
    part = e(B * d["tiles"], SUM_SLOTS, n_part, dt=f32)
    xt = prods["dw"][0]
    ptrs = ins + [stream, g, dh, dsty, xt, yg, xst, xact, ygb, ydact, part]
    return dict(d=d, spatial=spatial, ptrs=ptrs, ints=_ints(d, style, fixed),
                stream_bytes=stream.numel() * 2, dev=dev, dh=dh, dsty=dsty, part=part,
                prods=prods)


def bwd_body(op):
    """Launch K11's kernel on the operands of ``bwd_operands``."""
    global launches_bwd
    dev = op["dev"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [None if t is None else _ptrs([t], dev)[0] for t in op["ptrs"]]  # None: NULL
        err = _build.library().thgt_half_block_bwd(*ptrs, *op["ints"], op["stream_bytes"],
                                                   stream)
    _build.check(err, "thgt_half_block_bwd")
    launches_bwd += 1


def bwd_products(op):
    """K11's weight-gradient products, X^T Y of each operand pair the body wrote."""
    dev = op["dev"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        return {k: _wgrad(X, Y, stream) for k, (X, Y) in op["prods"].items()}


def bwd_reduce(op, gw, h, style, fixed, gam, bet, m, r, a):
    """The host's fixed-order sums of K11's per-CTA column sums, and the
    cotangents cut to the unpadded widths."""
    d, part, dsty = op["d"], op["part"], op["dsty"]
    B, ci, co, cs, cip, cop = (d[k] for k in ("B", "ci", "co", "cs", "cip", "cop"))
    img = part.reshape(B, d["tiles"] * SUM_SLOTS, -1).sum(1)  # per image, in a fixed order
    tot = img.sum(0)
    col = lambda j: cop + j * cip  # offset of column sum j (dgam, dbet, da, db)
    r32, a32 = r.float().reshape(-1), a.float().reshape(-1)
    da, db = tot[col(2):col(2) + ci], tot[col(3):col(3) + ci]
    ds1, ds2 = a32 * db, a32 * da  # sum dnhat, sum dnhat nhat (dnhat = du a)
    dw = gw["dw"]
    out = {"dh": op["dh"].to(h.dtype), "dw": dw[:ci, :co].contiguous(), "dc": tot[:co],
           "da": da, "db": db,
           "dm": (-r32 * ds1).to(m.dtype).reshape(m.shape),
           "dr": (ds2 / r32).to(r.dtype).reshape(r.shape)}
    if op["spatial"]:
        hid = d["hid"]
        dsh_w, dgb = gw["dsh_w"], gw["dgb"]
        out.update(dsty=dsty.to(style.dtype),
                   dsh_w=dsh_w[:cs, :hid].contiguous(), dsh_b=tot[cop + 4 * cip:][:hid],
                   dg_w=dgb[:hid, :ci].contiguous(), dg_b=tot[col(0):col(0) + ci],
                   dbt_w=dgb[:hid, cip:cip + ci].contiguous(), dbt_b=tot[col(1):col(1) + ci])
        out["dfixed"] = (dsty.sum((1, 2), dtype=torch.float32).to(fixed.dtype)
                         if fixed is not None else None)
    else:
        out["dgam"] = img[:, col(0):col(0) + ci].to(gam.dtype)
        out["dbet"] = img[:, col(1):col(1) + ci].to(bet.dtype)
    return out


def half_block_backward_cuda(h, style, fixed, gam, bet, m, r, a, b, mlp, w, g,
                             compute_dtype=torch.bfloat16):
    """Launch K11, then its weight-gradient products (csrc/wgrad.cu, shared
    with K9; per-chunk partials summed in a fixed order); same contract as
    ``half_block_backward``."""
    _check_dtype(compute_dtype)
    op = bwd_operands(h, style, fixed, gam, bet, m, r, a, b, mlp, w, g)
    bwd_body(op)
    return bwd_reduce(op, bwd_products(op), h, style, fixed, gam, bet, m, r, a)
