"""The field render kernels: K2 (folded), K4 (unfolded), K5 (geo-fused).

All three render the FiLM-SIREN field of ``models.siren.CoordConcatSiren``
over ray-major samples and alpha-composite each ray front to back (delta
1e9 on the last step, the residual transmittance routed to the last sample
(``last_back``) and/or a white background (``white_back``)).  An optional
last packed column carries the training-time nerf noise, added to sigma
before the density clamp.

K2 replaces threedhumangan_tpu/ops/raymarch.py::_raymarch_kernel_folded
(Pallas), the folded-FiLM form that the JAX generator runs by default:
freq/phase and omega are folded into per-image weight tables
(``fold_film_tables``), the SIREN runs 1 block-diagonal first layer, the
trunk, a sigma head, a colour layer whose view-direction term is hoisted
per ray (directions are constant along a ray), and sigmoid-RGB and feature
heads.  ``field_render_plain`` runs it on those tables; ``field_render_cuda``
launches csrc/raymarch.cu on the field's own weights and the FiLM tables,
folding them in the layout the kernel reads (``pack_field_stream``: one bf16
stream of chunk images per image, bit-equal to the folded tables).  The
packed slabs are rounded to the compute dtype first, as the JAX wrapper does.

K4 replaces ``_raymarch_kernel``: the UNFOLDED SIREN (``_field_slab_parts``:
freq/phase applied per element, omega 30 on the first layers, the field's
own weights shared by the batch) and ``_march``.  ``fused_field_render``
takes it when ``fold_film`` is off and for a field with fewer than 2 trunk
blocks (JAX raymarch.py:341-355).  The packed inputs stay float32: their
product columns are rounded to bf16 at the product, the noise column is
added to sigma in float32.  ``field_render_unfolded_cuda`` launches
csrc/raymarch_unfolded.cu (K8's forward with K2's composite, csrc/
field_core.cuh) on the forward half of the field backward's weight stream
(ops/raymarch_bwd.py::pack_field_bwd_stream); ``field_render_unfolded_plain``
is ``slab_forward`` then ``ray_integration``.

K5 replaces ``_raymarch_geo_kernel``: K4 with the 31 geo columns computed
from the raw points inside the kernel (``geo_slab``: joint distances, the
1-NN over the posed vertices, the winner's [inverse-FK 16; T-pose 3] row,
canonicalisation).  ``fused_field_render_geo`` launches
csrc/raymarch_geo.cu (``field_render_geo_cuda``, K4's kernel with the scan
in its prologue) or runs ``field_render_geo_plain``.

Each entry point launches its kernel on CUDA tensors (bf16 products only)
and runs the plain version on CPU tensors.  ``flat_weights``,
``film_tables``, ``slab_forward`` and K2's index maps
(``field_index_mats``) also serve the field backward
(ops/raymarch_bwd.py).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from threedhumangan_tpu_torch import _build
from threedhumangan_tpu_torch.models.volume_rendering import ray_integration
from threedhumangan_tpu_torch.ops.geo import GEO_DIM, nearest_vertex
from threedhumangan_tpu_torch.ops.synthesis_kernel import CHUNK_ROWS, chunk_images
from threedhumangan_tpu_torch.utils.misc import mm, pad_to, round16

INPUT_PACK = 37  # 3 coords + 31 geo + 3 ray dirs (+1 optional sigma noise)
GEO_PACK = 6     # K5: 3 raw coords + 3 ray dirs (+1 optional sigma noise)

# degree-9 odd minimax sine on [-pi, pi] after a 2*pi range reduction
# (the JAX package's coefficients)
_SIN_C1 = 0.999979407588
_SIN_C3 = -0.166624416001
_SIN_C5 = 0.00830899784978
_SIN_C7 = -0.000192651914745
_SIN_C9 = 2.14797007513e-06
_INV_2PI = 0.15915494309189535
_TWO_PI = 6.283185307179586

launches = 0           # K2 launches (the CUDA path only)
launches_unfolded = 0  # K4 launches
launches_geo = 0       # K5 launches


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
                       compute_dtype=torch.bfloat16, exact_sin: bool = False,
                       fold_film: bool = True):
    """Render the field: packed (B, R*S, 37[+1]) ray-major inputs, freq/phase
    (B, NB*H) raw mapping outputs, z_vals (B, R, S).  Returns (rendered
    (B, R, F+3), depth (B, R, 1)) float32.

    ``fold_film`` with at least 2 trunk blocks takes K2 on folded tables;
    anything else takes K4, the unfolded SIREN (JAX raymarch.py:341-355).
    The JAX ``march_loop`` (a fori_loop over steps) also selects K4 there
    and ``step_pack`` (stacked step slabs) only schedules the TPU kernels,
    so on the card both reduce to this one flag: ``models.generator.render``
    passes ``fold_film=False`` under ``pallas_march_loop``.  CUDA tensors
    launch the kernel (bf16 only); CPU tensors take its plain version."""
    folded = fold_film and len(field.network) >= 2
    if folded and packed.device.type == "cpu":
        shared, per_image = fold_film_tables(field, freq, phase, compute_dtype)
        return field_render_plain(shared, per_image, packed, z_vals, num_steps,
                                  white_back, last_back, compute_dtype, exact_sin)
    w = flat_weights(field)
    freq_k, phase_k = film_tables(freq, phase, len(field.network))
    if folded:
        _check_cuda(packed, compute_dtype, "fused_field_render")
        return field_render_cuda(w, (freq_k, phase_k), packed, z_vals, num_steps,
                                 white_back, last_back, exact_sin)
    if packed.device.type == "cpu":
        return field_render_unfolded_plain(w, packed, freq_k, phase_k, z_vals, num_steps,
                                           white_back, last_back, compute_dtype, exact_sin)
    _check_cuda(packed, compute_dtype, "fused_field_render")
    return field_render_unfolded_cuda(w, packed, freq_k, phase_k, z_vals, num_steps,
                                      white_back, last_back, exact_sin)


def _check_cuda(t: torch.Tensor, compute_dtype, name: str):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("the field kernels compute in bfloat16 only")


ROWS_PER_CTA = 64  # rows (ray x step samples) one CTA of the kernel holds
FIELD_UNITS = 54   # n8 column tiles of one K2 product (3 warpgroups x 18, csrc/raymarch.cu)
_STREAM_INDEX: Dict = {}  # widths, device -> (value map, scale map, consts, chunk sizes)


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def field_dims(n_in: int, H: int, F: int, NB: int) -> Dict[str, int]:
    """K2's padded widths: k0p/n0p the first layer's K and N, hp the trunk's,
    nc the colour product's N (w_sigma rides in its column H), headp the
    head's; ``first`` the columns of each of the first layer's products."""
    n0p = round16(2 * H)
    tiles = n0p // 8
    n_first = -(-tiles // FIELD_UNITS)
    first = [8 * (tiles // n_first + (j < tiles % n_first)) for j in range(n_first)]
    return dict(n_in=n_in, H=H, F=F, NB=NB, k0p=round16(n_in), n0p=n0p, hp=round16(H),
                nc=max(round16(H), _round8(H + 1)), headp=_round8(F + 3), first=first)


# the flat source of K2's stream: the field's own float32 weights, each
# (in, out) matrix of ``flat_weights`` in its (out, in) storage order
_STREAM_SOURCE = ("w_coord", "w_geo", "w_net", "w_color", "w_sigma", "w_rgb", "w_feat")


def field_source_offsets(d):
    """Where each weight of ``_STREAM_SOURCE`` starts in the flat source
    (each matrix (out, in) row-major, the trunk's layers in turn), and the
    index just past them, where the source's trailing 0 lies."""
    H, F, NB, G = d["H"], d["F"], d["NB"], d["n_in"] - 3
    sizes = {"w_coord": 3 * H, "w_geo": G * H, "w_net": 2 * H * H + (NB - 1) * H * H,
             "w_color": (H + 3) * H, "w_sigma": H, "w_rgb": 3 * H, "w_feat": F * H}
    off, pos = {}, 0
    for k in _STREAM_SOURCE:
        off[k], pos = pos, pos + sizes[k]
    return off, pos


def field_source(w):
    """The flat float32 source of the field's weights (``_STREAM_SOURCE``
    in order, see ``field_source_offsets``)."""
    NB = sum(k.startswith("w_net") for k in w)
    mats = [w["w_coord"], w["w_geo"]] + [w[f"w_net{i}"] for i in range(NB)] + [
        w[k] for k in _STREAM_SOURCE[3:]]
    return torch.cat([t.t().reshape(-1) for t in mats])


def field_index_mats(d):
    """The value and scale maps (int32, (K, N) each) of the field's
    products in K2's order: the first layer [coords | geo] block-diagonal
    (k0p x n0p, scale 30) in column products of ``d["first"]`` columns,
    w_net0 (n0p x hp) and the NB-1 trunk layers (hp x hp) scaled by their
    freq column, the colour layer (hp x nc) scaled by the last trunk freq
    with w_sigma (scale 1) in column H, and the head [rgb 3 | feat F] (hp x
    headp, scale 1).  A value is an index into the flat source
    (``_STREAM_SOURCE`` in order, each matrix (out, in) row-major, the
    trunk's layers in turn, then [0, 30, 1]: padding reads the 0), a scale
    an index into an image's scale row [freq*15+30 (NB x H) | 30 | 1]."""
    H, F, NB = d["H"], d["F"], d["NB"]
    k0p, n0p, hp, nc, headp = d["k0p"], d["n0p"], d["hp"], d["nc"], d["headp"]
    G = d["n_in"] - 3
    off, zero = field_source_offsets(d)
    s30, s1 = NB * H, NB * H + 1

    def mat(K, N):
        return torch.full((K, N), zero, dtype=torch.int32), torch.full((K, N), s1,
                                                                       dtype=torch.int32)

    def put(m, r0, c0, src, rows, cols, k_in, scale):
        """Block (r0 + r, c0 + c) reads input r, output c of a source stored
        (out, k_in) row-major whose input r = 0 lies at flat index src."""
        v, sc = m
        r, c = torch.arange(rows)[:, None], torch.arange(cols)[None, :]
        v[r0:r0 + rows, c0:c0 + cols] = (src + c * k_in + r).int()
        sc[r0:r0 + rows, c0:c0 + cols] = scale

    cols = torch.arange(H, dtype=torch.int32)
    first = mat(k0p, n0p)
    put(first, 0, 0, off["w_coord"], 3, H, 3, s30)
    put(first, 3, H, off["w_geo"], G, H, G, s30)
    mats = []
    c0 = 0
    for n in d["first"]:
        mats.append(tuple(t[:, c0:c0 + n] for t in first))
        c0 += n
    src = off["w_net"]
    for i in range(NB):
        k = 2 * H if i == 0 else H
        m = mat(n0p if i == 0 else hp, hp)
        put(m, 0, 0, src, k, H, k, i * H + cols)
        mats.append(m)
        src += k * H
    color = mat(hp, nc)
    put(color, 0, 0, off["w_color"] + 3, H, H, H + 3, (NB - 1) * H + cols)
    put(color, 0, H, off["w_sigma"], H, 1, H, s1)
    head = mat(hp, headp)
    put(head, 0, 0, off["w_rgb"], H, 3, H, s1)
    put(head, 0, 3, off["w_feat"], H, F, H, s1)
    return mats + [color, head]


def chunk_map(mats):
    """The (K, N) maps' ``chunk_images`` in order, and the bytes of each chunk."""
    idx = torch.cat([chunk_images(m.contiguous()) for m in mats])
    return idx, [CHUNK_ROWS * m.shape[1] * 2 for m in mats for _ in range(m.shape[0] // CHUNK_ROWS)]


def field_stream_index(d):
    """The gather maps of ``pack_field_stream`` for one image (int32): for
    each stream element, its index into the flat source and into the
    image's scale row (``field_index_mats``); and the bytes of each chunk.
    The stream holds the products of ``field_index_mats`` as
    ``chunk_images``, in the order K2 consumes them."""
    mats = field_index_mats(d)
    idx, chunk = chunk_map([v for v, _ in mats])
    sidx, _ = chunk_map([sc for _, sc in mats])
    return idx, sidx, chunk


def pack_field_stream(w, freq_k):
    """Every weight K2 reads, as one bf16 stream of chunk images per image
    (``field_stream_index``), (B, E) on w's device: the shared float32
    weights gathered into the stream's layout once, times each image's
    column scale gathered through maps built once per widths and device,
    rounded to bf16 once, so every value is bit-equal to
    ``fold_film_tables``' (a float32 product, then one rounding).  w:
    ``flat_weights``; freq_k (B, NB, H) from ``film_tables``.  Returns
    (stream, the bytes of each chunk of one image)."""
    B, NB, H = freq_k.shape
    d = field_dims(3 + w["w_geo"].shape[0], H, w["w_feat"].shape[1], NB)
    dev = w["w_coord"].device
    key = (d["n_in"], H, d["F"], NB, str(dev))
    if key not in _STREAM_INDEX:
        idx, sidx, chunk = field_stream_index(d)
        consts = torch.tensor([0.0, 30.0, 1.0], device=dev)
        _STREAM_INDEX[key] = (idx.to(dev), sidx.to(dev), consts, chunk)
    idx, sidx, consts, chunk = _STREAM_INDEX[key]
    flat = torch.cat([field_source(w), consts]).index_select(0, idx)
    scales = torch.cat([freq_k.reshape(B, NB * H), consts[1:].expand(B, 2)], 1)
    stream = torch.empty(B, idx.numel(), dtype=torch.bfloat16, device=dev)
    torch.mul(scales.index_select(1, sidx), flat, out=stream)
    return stream, chunk


def field_side_tables(w, freq_k, phase_k, d):
    """K2's small float32 tables beside the stream, padded: b_first (omega
    folded), b_net (B, NB, hp) and b_color (B, nc) folded with freq/phase,
    w_color_d (B, 3, nc) as bf16 values, b_sigma, b_head [rgb | feat] —
    ``fold_film_tables``' values."""
    f32 = torch.float32
    B, NB, _ = freq_k.shape
    f_last, p_last = freq_k[:, NB - 1], phase_k[:, NB - 1]
    b_net = torch.stack([w[f"b_net{i}"] for i in range(NB)], 0)
    w_cd = (w["w_color"][:3][None] * f_last[:, None, :]).to(torch.bfloat16)
    return [
        pad_to(torch.cat([w["b_coord"], w["b_geo"]]) * 30.0, (d["n0p"],), f32),
        pad_to(b_net[None] * freq_k + phase_k, (B, NB, d["hp"]), f32),
        pad_to(w_cd, (B, 3, d["nc"]), f32),
        pad_to(w["b_color"] * f_last + p_last, (B, d["nc"]), f32),
        w["b_sigma"].reshape(1).float().contiguous(),
        pad_to(torch.cat([w["b_rgb"], w["b_feat"]]), (d["headp"],), f32),
    ]


def field_render_cuda(w, film, packed, z_vals, num_steps, white_back=False,
                      last_back=False, exact_sin=False):
    """Launch K2: ``w`` the field's own float32 weights (``flat_weights``),
    ``film`` its (freq*15+30, phase) (B, NB, H) (``film_tables``); the FiLM
    fold happens in the weight pack (``pack_field_stream``), inside this
    call.  Computes what ``field_render_plain`` computes on
    ``fold_film_tables``' tables, which this entry does not take."""
    global launches
    B, P, n_cols = packed.shape
    S = num_steps
    dev = packed.device
    check_packed_width(n_cols)
    R = _check_tiling(B, P, S, z_vals)
    if "w_coord" not in w:
        raise ValueError("field_render_cuda takes the field's own weights (flat_weights) and "
                         "film_tables(freq, phase, NB), not fold_film_tables' folded tables")
    freq_k, phase_k = (t.detach().float() for t in film)
    NB, H = freq_k.shape[1:]
    d = field_dims(3 + w["w_geo"].shape[0], H, w["w_feat"].shape[1], NB)
    if d["n_in"] != INPUT_PACK - 3:
        raise ValueError(f"the packed inputs carry {INPUT_PACK - 3} field inputs, the field "
                         f"takes {d['n_in']}")
    stream, _ = pack_field_stream(w, freq_k)
    ops = [packed.to(torch.bfloat16).contiguous(), z_vals.float().contiguous(), stream,
           *field_side_tables(w, freq_k, phase_k, d)]
    out = torch.empty(B, R, d["F"] + 3, dtype=torch.float32, device=dev)
    depth = torch.empty(B, R, 1, dtype=torch.float32, device=dev)
    for t in ops:
        if t.device != dev:
            raise ValueError(f"field kernel operand on {t.device}, expected {dev}")
    with torch.cuda.device(dev):
        err = _build.library().thgt_raymarch(
            *cuda_ptrs(ops + [out, depth]), B, R, S, n_cols, d["n_in"], H, d["k0p"], d["n0p"],
            d["hp"], d["nc"], d["headp"], NB, d["F"] + 3, int(white_back), int(last_back),
            int(exact_sin), stream.numel() * 2, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "thgt_raymarch")
    launches += 1
    return out, depth


# ---------------------------------------------------------------------------
# the unfolded field (K4, K5; the recompute of K8/K9)
# ---------------------------------------------------------------------------

# field module attribute -> the JAX package's flat weight name stem
_LAYERS = {"first_layer_coord.layer": "coord", "first_layer_mod.layer": "geo",
           "sigma_layer": "sigma", "color_layer_sine.layer": "color",
           "color_layer_linear": "rgb", "feature_layer_linear": "feat"}


def layer_names(field) -> Dict[str, str]:
    """Module path of each linear layer of the field -> its flat weight stem."""
    names = dict(_LAYERS)
    names.update({f"network.{i}.layer": f"net{i}" for i in range(len(field.network))})
    return names


def flat_weights(field) -> Dict[str, torch.Tensor]:
    """Raw field weights as the JAX package's ``_flatten_field_params``:
    ``w_<name>`` (in, out) and ``b_<name>`` (out,), float32, detached."""
    mods = dict(field.named_modules())
    out = {}
    for path, stem in layer_names(field).items():
        lin = mods[path]
        out[f"w_{stem}"] = lin.weight.detach().t().float()
        out[f"b_{stem}"] = lin.bias.detach().float()
    return out


def film_tables(freq, phase, n_blocks: int):
    """Raw mapping outputs (B, NB*H) -> kernel-side (freq*15+30, phase), (B, NB, H)."""
    B = freq.shape[0]
    return (freq.float() * 15.0 + 30.0).reshape(B, n_blocks, -1), phase.float().reshape(
        B, n_blocks, -1)


def slab_forward(w, slab, f, p, n_blocks, cd, exact_sin, with_noise):
    """One image's packed rows (N, C) through the unfolded SIREN (JAX
    ``_field_slab_parts``), keeping every activation for the backward
    (ops/raymarch_bwd.py); f/p (NB, H)."""
    _sin = torch.sin if exact_sin else fast_sin
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


def field_render_unfolded_plain(w, packed, freq_k, phase_k, z_vals, num_steps: int,
                                white_back: bool = False, last_back: bool = False,
                                compute_dtype=torch.bfloat16, exact_sin: bool = False,
                                ray_chunk: int = 1024):
    """Plain K4 (no autograd): ``slab_forward`` then ``ray_integration`` over
    chunks of rays.  w: ``flat_weights``; freq_k/phase_k (B, NB, H) from
    ``film_tables``.  Returns (out (B, R, F+3), depth (B, R, 1))."""
    B, P, n_cols = packed.shape
    with_noise = check_packed_width(n_cols)
    S = num_steps
    slabs = lambda b, r0, nr: packed[b, r0 * S:(r0 + nr) * S]
    return _render_unfolded_plain(w, slabs, B, P // S, freq_k, phase_k, z_vals, S, white_back,
                                  last_back, compute_dtype, exact_sin, with_noise, ray_chunk)


def _render_unfolded_plain(w, slabs, B, R, freq_k, phase_k, z_vals, S, white_back, last_back,
                           cd, exact_sin, with_noise, ray_chunk):
    """``slabs(b, r0, nr)`` gives the packed rows of rays [r0, r0 + nr) of
    image b; the SIREN and the composite run on them chunk by chunk."""
    n_blocks = freq_k.shape[1]
    z = z_vals.float().reshape(B, R, S)
    width = w["w_feat"].shape[1] + 3
    out = z.new_empty(B, R, width)
    depth = z.new_empty(B, R, 1)
    with torch.no_grad():
        for b in range(B):
            for r0 in range(0, R, ray_chunk):
                nr = min(ray_chunk, R - r0)
                a = slab_forward(w, slabs(b, r0, nr), freq_k[b], phase_k[b], n_blocks, cd,
                                 exact_sin, with_noise)
                fo = torch.cat([a["field"], a["sigma"]], -1).reshape(1, nr, S, width + 1)
                o, d, _ = ray_integration(fo, z[b, r0:r0 + nr].reshape(1, nr, S, 1),
                                          white_back=white_back, last_back=last_back)
                out[b, r0:r0 + nr] = o[0]
                depth[b, r0:r0 + nr] = d[0]
    return out, depth


def cuda_ptrs(ts, what: str = "field kernel"):
    """Data pointers of contiguous CUDA tensors (raises on any other)."""
    for t in ts:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{what} operands must be contiguous CUDA tensors")
    return [t.data_ptr() for t in ts]


def _check_tiling(B, P, num_steps, z_vals):
    S = num_steps
    R = P // S
    if P != R * S or S < 4 or ROWS_PER_CTA % S or R % (ROWS_PER_CTA // S):
        raise ValueError(f"field kernel needs num_steps a power of two in [4, {ROWS_PER_CTA}] "
                         f"and rays divisible by {ROWS_PER_CTA} // num_steps (R={R}, S={S})")
    if tuple(z_vals.shape) != (B, R, S):
        raise ValueError(f"z_vals: expected {(B, R, S)}, got {tuple(z_vals.shape)}")
    return R


def _render_outputs(B, R, d, dev):
    return (torch.empty(B, R, d["F"] + 3, dtype=torch.float32, device=dev),
            torch.empty(B, R, 1, dtype=torch.float32, device=dev))


def field_render_unfolded_operands(w, packed, freq_k, phase_k, z_vals, num_steps: int,
                                   white_back: bool = False, last_back: bool = False,
                                   exact_sin: bool = False):
    """K4's host glue before its launch, in the C order of
    ``thgt_raymarch_unfolded``: the float32 packed rows and z, the forward
    half of the field backward's weight stream with its side tables
    (``raymarch_bwd.field_forward_operands``, as K8 reads them), the
    outputs; then the ints.  Raises on inputs the kernel does not take."""
    from threedhumangan_tpu_torch.ops import raymarch_bwd as rb  # it imports this module

    B, P, n_cols = packed.shape
    check_packed_width(n_cols)
    R = _check_tiling(B, P, num_steps, z_vals)
    d, fwd = rb.field_forward_operands(w, freq_k, phase_k)
    out, depth = _render_outputs(B, R, d, packed.device)
    ops = [packed.float().contiguous(), z_vals.float().contiguous()] + fwd + [out, depth]
    ints = rb.kernel_ints(d, B, P, num_steps, n_cols, exact_sin) + [int(white_back),
                                                                    int(last_back)]
    return dict(d=d, ops=ops, ints=ints, stream_bytes=fwd[0].numel() * 2, dev=packed.device,
                out=out, depth=depth)


def field_render_unfolded_body(op):
    """Launch K4's kernel on the operands of ``field_render_unfolded_operands``."""
    global launches_unfolded
    dev = op["dev"]
    with torch.cuda.device(dev):
        err = _build.library().thgt_raymarch_unfolded(
            *cuda_ptrs(op["ops"]), *op["ints"], op["stream_bytes"],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "thgt_raymarch_unfolded")
    launches_unfolded += 1


def field_render_unfolded_cuda(w, packed, freq_k, phase_k, z_vals, num_steps: int,
                               white_back: bool = False, last_back: bool = False,
                               exact_sin: bool = False):
    """Launch K4; same contract as ``field_render_unfolded_plain`` (bf16 products)."""
    op = field_render_unfolded_operands(w, packed, freq_k, phase_k, z_vals, num_steps,
                                        white_back, last_back, exact_sin)
    field_render_unfolded_body(op)
    return op["out"], op["depth"]


# ---------------------------------------------------------------------------
# K5: the unfolded render with the geo features computed in the kernel
# ---------------------------------------------------------------------------


def geo_slab(pts, verts, vfeat, skel, legacy_mode: bool, point_chunk: int = 2048):
    """31-d geo features of one image's raw points (N, 3) (JAX ``_geo_slab``):
    verts (V, 3), vfeat (V, 19) [blended inverse-FK 16; T-pose 3], skel (J, 3).
    The 1-NN is ``ops.geo.nearest_vertex`` (the elementwise distance, lowest
    index on ties, as every 1-NN kernel of the port); the joint distances
    take the JAX kernel's expanded form."""
    d2, idx = nearest_vertex(pts[None], verts[None], point_chunk)
    d2, idx = d2[0], idx[0]
    p_sq = torch.sum(torch.square(pts), 1, keepdim=True)
    crossj = torch.matmul(pts, skel.t())
    ssq = torch.sum(torch.square(skel), -1)[None]
    jd = torch.sqrt(torch.clamp(p_sq - 2.0 * crossj + ssq, min=0.0) + 1e-12) / 2.4
    g = vfeat[idx]
    x, y, z1 = pts[:, 0:1], pts[:, 1:2], pts[:, 2:3]
    col = lambda i: g[:, i:i + 1]
    cano = torch.cat([(col(0) * x + col(1) * y + col(2) * z1 + col(3)) / 2.0,
                      (col(4) * x + col(5) * y + col(6) * z1 + col(7) + 0.2) / 2.0,
                      (col(8) * x + col(9) * y + col(10) * z1 + col(11)) / 1.3], -1)
    tp = torch.cat([col(16), col(17), col(18) / 0.2], -1)
    ndist = torch.sqrt(torch.clamp(d2, min=0.0))[:, None] / 1.3
    cols = [jd, cano, tp, ndist] if legacy_mode else [cano, jd, tp, ndist]
    return torch.cat(cols, -1)


def _check_geo_pack(n_cols: int) -> bool:
    if n_cols not in (GEO_PACK, GEO_PACK + 1):
        raise ValueError(f"raw packed inputs need {GEO_PACK} or {GEO_PACK + 1} columns, "
                         f"got {n_cols}")
    return n_cols == GEO_PACK + 1


def field_render_geo_plain(w, packed, freq_k, phase_k, z_vals, verts, vfeat, skeletons,
                           num_steps: int, input_scaler: float, white_back: bool = False,
                           last_back: bool = False, compute_dtype=torch.bfloat16,
                           exact_sin: bool = False, legacy_mode: bool = False,
                           ray_chunk: int = 1024):
    """Plain K5: ``geo_slab`` + ``slab_forward`` + ``ray_integration`` over
    chunks of rays.  packed (B, R*S, 6[+1]) raw [points | dirs | noise] float32."""
    B, P, n_cols = packed.shape
    with_noise = _check_geo_pack(n_cols)
    S = num_steps

    def slabs(b, r0, nr):
        raw = packed[b, r0 * S:(r0 + nr) * S].float()
        pts = raw[:, :3]
        geo = geo_slab(pts, verts[b].float(), vfeat[b].float(), skeletons[b].float(),
                       legacy_mode)
        return torch.cat([pts * input_scaler, geo, raw[:, 3:]], -1)

    return _render_unfolded_plain(w, slabs, B, P // S, freq_k, phase_k, z_vals, S, white_back,
                                  last_back, compute_dtype, exact_sin, with_noise, ray_chunk)


def fused_field_render_geo(field, packed, freq, phase, z_vals, verts, vfeat, skeletons,
                           num_steps: int, input_scaler: float, white_back: bool = False,
                           last_back: bool = False, compute_dtype=torch.bfloat16,
                           exact_sin: bool = False, legacy_mode: bool = False):
    """``fused_field_render`` with the geo features computed in the render
    (JAX ``fused_field_render_geo``): packed (B, R*S, 6[+1]) RAW points,
    directions (and noise); verts (B, V, 3) posed vertices, vfeat (B, V, 19)
    (``ops.geo.build_vertex_features``), skeletons (B, J, 3).  Returns
    (rendered (B, R, F+3), depth (B, R, 1)).  CUDA tensors launch K5 (bf16
    only); CPU tensors take ``field_render_geo_plain``."""
    w = flat_weights(field)
    freq_k, phase_k = film_tables(freq, phase, len(field.network))
    args = (w, packed, freq_k, phase_k, z_vals, verts, vfeat, skeletons, num_steps,
            input_scaler, white_back, last_back)
    if packed.device.type == "cpu":
        return field_render_geo_plain(*args, compute_dtype, exact_sin, legacy_mode)
    _check_cuda(packed, compute_dtype, "fused_field_render_geo")
    return field_render_geo_cuda(*args, exact_sin, legacy_mode)


def field_render_geo_operands(w, packed, freq_k, phase_k, z_vals, verts, vfeat, skeletons,
                              num_steps: int, input_scaler: float, white_back: bool = False,
                              last_back: bool = False, exact_sin: bool = False,
                              legacy_mode: bool = False, return_index: bool = False):
    """K5's host glue before its launch, in the C order of
    ``thgt_raymarch_geo``: the raw float32 rows, z, the posed vertices, their
    feature rows and the joints (``ops``); the nearest-vertex output or None
    (``idx``); K4's weight operands and the outputs (``tabs``); then the ints
    and the input scale.  Raises on inputs the kernel does not take."""
    from threedhumangan_tpu_torch.ops import raymarch_bwd as rb  # it imports this module

    B, P, n_cols = packed.shape
    _check_geo_pack(n_cols)
    R = _check_tiling(B, P, num_steps, z_vals)
    V, J = verts.shape[1], skeletons.shape[1]
    if tuple(verts.shape) != (B, V, 3) or tuple(vfeat.shape) != (B, V, 19) or V == 0:
        raise ValueError(f"verts/vfeat: expected (B, V, 3)/(B, V, 19), got "
                         f"{tuple(verts.shape)}/{tuple(vfeat.shape)}")
    if J + 7 != GEO_DIM or w["w_geo"].shape[0] != GEO_DIM:
        raise ValueError(f"the geo-fused kernel computes {GEO_DIM} geo columns from 24 joints, "
                         f"got {J} joints and a field taking {w['w_geo'].shape[0]}")
    d, fwd = rb.field_forward_operands(w, freq_k, phase_k)
    dev = packed.device
    out, depth = _render_outputs(B, R, d, dev)
    f32 = lambda x: x.float().contiguous()
    ints = rb.kernel_ints(d, B, P, num_steps, n_cols, exact_sin) + [
        int(white_back), int(last_back), V, J, int(legacy_mode)]
    return dict(d=d, ops=[f32(packed), f32(z_vals), f32(verts), f32(vfeat), f32(skeletons)],
                idx=torch.empty(B, P, dtype=torch.int32, device=dev) if return_index else None,
                tabs=fwd + [out, depth], ints=ints, scaler=float(input_scaler),
                stream_bytes=fwd[0].numel() * 2, dev=dev, out=out, depth=depth)


def field_render_geo_body(op):
    """Launch K5's kernel on the operands of ``field_render_geo_operands``."""
    global launches_geo
    dev, idx = op["dev"], op["idx"]
    with torch.cuda.device(dev):
        err = _build.library().thgt_raymarch_geo(
            *cuda_ptrs(op["ops"]), None if idx is None else idx.data_ptr(),
            *cuda_ptrs(op["tabs"]), *op["ints"], op["scaler"], op["stream_bytes"],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "thgt_raymarch_geo")
    launches_geo += 1


def field_render_geo_cuda(w, packed, freq_k, phase_k, z_vals, verts, vfeat, skeletons,
                          num_steps: int, input_scaler: float, white_back: bool = False,
                          last_back: bool = False, exact_sin: bool = False,
                          legacy_mode: bool = False, return_index: bool = False):
    """Launch K5; same contract as ``field_render_geo_plain``.  With
    ``return_index`` it also returns each sample's nearest vertex (B, R*S)
    int32, which the kernel then writes."""
    op = field_render_geo_operands(w, packed, freq_k, phase_k, z_vals, verts, vfeat, skeletons,
                                   num_steps, input_scaler, white_back, last_back, exact_sin,
                                   legacy_mode, return_index)
    field_render_geo_body(op)
    return (op["out"], op["depth"], op["idx"]) if return_index else (op["out"], op["depth"])
