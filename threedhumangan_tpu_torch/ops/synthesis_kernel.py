"""K3: fused SPADE synthesis, inference path.

Replaces threedhumangan_tpu/ops/synthesis_kernel.py::_synthesis_kernel
(Pallas).  Per pixel: coordinates from the pixel index -> sin(coords @ W_in
+ b); then every SPADE block, twice: x*gamma + beta, lrelu, a 1x1 conv;
the skip add for blocks >= NB//2 and the ToRGB sum for blocks >= NB//2 - 1.
Only the RGB leaves.  Host-side folds (``fold_synthesis_params``): spectral
norm with u frozen divided into the conv weights, and the eval batch-norm
affine folded into the SPADE gamma/beta weights.  Blocks whose style is the
per-image fixed vector (isolated/mixed non-mod blocks) collapse to per-image
(gamma, beta) rows computed here in plain PyTorch (``rank1_rows``).

``fused_synthesis`` launches csrc/synthesis.cu on CUDA tensors and runs
``synthesis_plain`` — the JAX kernel's math, rounding to the compute dtype
where it does — on CPU tensors.  The kernel reads every weight from one
bf16 stream of 16-row chunk images (``pack_weight_stream``), in the order
and the shared-memory layout it consumes them, so its producer warp only
copies contiguous chunks; the biases, input and ToRGB weights are float32
tables (``weight_tables``).  ``synthesis_operands`` builds the fold and
those tables once per set of weights and keeps them on the network, keyed
on its parameters' and buffers' addresses and versions; per launch only
the rank-1 rows and the style casts are made.  Given a folded dict alone,
``synthesis_cuda`` builds the tables inside the call.
"""

from __future__ import annotations

import itertools
from typing import Dict

import torch

from threedhumangan_tpu_torch import _build
from threedhumangan_tpu_torch.models.synthesis import SPADE_HIDDEN, norm_affine
from threedhumangan_tpu_torch.utils import trace
from threedhumangan_tpu_torch.utils.misc import mm, pad_to, round16

launches = 0  # K3 launches (the CUDA path only)
operand_builds = 0  # builds of the cached weight operands (``synthesis_operands``)
operand_hits = 0  # reuses of them


def fold_synthesis_params(network, syn_input, normalization: str = "batch_norm") -> Dict:
    """Flatten + fold a ``SynthesisNetwork`` and ``SynthesisInput`` (JAX key
    names; matrices (in, out) float32, detached: inference only)."""
    first = syn_input.network[0]
    flat = {"in_w": first.w.float(), "in_b": first.bias[None].float()}
    for i in range(network.num_blocks):
        blk = network.network[f"m3d_{i}"]
        for ci in (0, 1):
            conv = getattr(blk, f"conv_{ci}")
            flat[f"b{i}_conv{ci}_w"] = conv.normalized_weight()
            flat[f"b{i}_conv{ci}_b"] = conv.bias[None].float()
        for si in (0, 1):
            sp = getattr(blk, f"spade_{si}")
            a, b = norm_affine(sp.first_norm, normalization)
            g_w, g_b = sp.mlp_gamma.w.float(), sp.mlp_gamma.bias[None].float()
            bt_w, bt_b = sp.mlp_beta.w.float(), sp.mlp_beta.bias[None].float()
            flat[f"b{i}_sp{si}_sh_w"] = sp.mlp_shared[0].w.float()
            flat[f"b{i}_sp{si}_sh_b"] = sp.mlp_shared[0].bias[None].float()
            # a*x_norm*gamma + ... == x*gamma' + beta' with the norm affine
            # folded into the gamma/beta weights
            flat[f"b{i}_sp{si}_g_w"] = g_w * a[None]
            flat[f"b{i}_sp{si}_g_b"] = (1.0 + g_b) * a[None]
            flat[f"b{i}_sp{si}_bt_w"] = g_w * b[None] + bt_w
            flat[f"b{i}_sp{si}_bt_b"] = (1.0 + g_b) * b[None] + bt_b
        rgb = network.to_rgbs[f"m3d_{i}"].linear
        flat[f"b{i}_rgb_w"] = rgb.w.float()
        flat[f"b{i}_rgb_b"] = rgb.bias[None].float()
    return {k: v.detach() for k, v in flat.items()}


def rank1_blocks_of(num_blocks: int, mod_blocks, map3d_mode: str):
    return [] if map3d_mode == "all" else [i for i in range(num_blocks) if i not in mod_blocks]


def rank1_weights(folded: Dict, rank1_blocks, compute_dtype=torch.bfloat16) -> Dict:
    """The SPADE weights ``rank1_rows`` multiplies, rounded to
    ``compute_dtype`` (float32 values)."""
    return {f"b{i}_sp{si}_{k}": folded[f"b{i}_sp{si}_{k}"].to(compute_dtype).float()
            for i in rank1_blocks for si in (0, 1) for k in ("sh_w", "g_w", "bt_w")}


def rank1_rows(folded: Dict, fixed_style, rank1_blocks, compute_dtype=torch.bfloat16,
               weights=None):
    """Per-image (gamma, beta) rows of the fixed-style blocks: (B, 4*n,
    hidden) float32, rows [ga0, gb0, ga1, gb1] per block.  ``weights``:
    ``rank1_weights`` of ``folded``, made here when None."""
    B = fixed_style.shape[0]
    # the JAX wrapper rounds each operand, and each bare `@` product, to cd
    rnd = lambda t: t.to(compute_dtype).float()
    w = rank1_weights(folded, rank1_blocks, compute_dtype) if weights is None else weights
    fx = rnd(fixed_style.reshape(B, -1))
    rows = []
    for i in rank1_blocks:
        for si in (0, 1):
            k = f"b{i}_sp{si}"
            actv = rnd(torch.relu(rnd(fx @ w[f"{k}_sh_w"]) + folded[f"{k}_sh_b"]))
            rows.append(rnd(actv @ w[f"{k}_g_w"]) + folded[f"{k}_g_b"])
            rows.append(rnd(actv @ w[f"{k}_bt_w"]) + folded[f"{k}_bt_b"])
    return torch.stack(rows, 1).float()


def _lrelu(x):
    # the JAX kernel's slope is a weakly typed 0.2, i.e. 0.2 in x's dtype
    slope = torch.tensor(0.2, dtype=x.dtype).item()
    return torch.clamp_min(x, 0) + slope * torch.clamp_max(x, 0)


def synthesis_plain(folded: Dict, style_map, fixed_style, num_blocks: int, mod_blocks,
                    map3d_mode: str, compute_dtype=torch.bfloat16, gab=None,
                    pixel_chunk: int = 16384):
    """Plain PyTorch K3: rgb (B, H, W, 3) float32."""
    cd = compute_dtype
    B, H, W, F = style_map.shape
    dev = style_map.device
    rank1 = rank1_blocks_of(num_blocks, mod_blocks, map3d_mode)
    row_of = {i: 4 * k for k, i in enumerate(rank1)}
    if rank1 and gab is None:
        gab = rank1_rows(folded, fixed_style, rank1, cd)
    add_fixed = map3d_mode in ("all", "mixed")
    out = torch.empty(B, H, W, 3, dtype=torch.float32, device=dev)
    out_flat = out.view(B, H * W, 3)
    style_flat = style_map.reshape(B, H * W, F)
    sy, sx = 2.0 / (H - 1), 2.0 / (W - 1)
    for b in range(B):
        fixed = fixed_style.reshape(B, -1)[b].to(cd)
        for p0 in range(0, H * W, pixel_chunk):
            p = torch.arange(p0, min(p0 + pixel_chunk, H * W), device=dev)
            gi = torch.div(p, W, rounding_mode="floor").float() * sy - 1.0
            gj = (p % W).float() * sx - 1.0
            coords = torch.stack([gi, gj], -1)
            x = torch.sin(mm(coords, folded["in_w"], cd) + folded["in_b"]).to(cd)
            style = style_flat[b, p0:p0 + len(p)].to(cd)
            in_style = style + fixed if add_fixed else style
            rgb = None
            for i in range(num_blocks):
                x_orig = x
                for si in (0, 1):
                    if i in row_of:
                        r = row_of[i] + 2 * si
                        x = _lrelu(x * gab[b, r].to(cd) + gab[b, r + 1].to(cd)).to(cd)
                    else:
                        k = f"b{i}_sp{si}"
                        actv = torch.relu(mm(in_style, folded[f"{k}_sh_w"], cd)
                                          + folded[f"{k}_sh_b"]).to(cd)
                        gamma = (mm(actv, folded[f"{k}_g_w"], cd) + folded[f"{k}_g_b"]).to(cd)
                        beta = (mm(actv, folded[f"{k}_bt_w"], cd) + folded[f"{k}_bt_b"]).to(cd)
                        x = _lrelu(x * gamma + beta).to(cd)
                    x = (mm(x, folded[f"b{i}_conv{si}_w"], cd)
                         + folded[f"b{i}_conv{si}_b"]).to(cd)
                if i >= num_blocks // 2 and x.shape[-1] == x_orig.shape[-1]:
                    x = x + x_orig
                if i >= num_blocks // 2 - 1:
                    r = mm(x, folded[f"b{i}_rgb_w"], cd) + folded[f"b{i}_rgb_b"]
                    rgb = r if rgb is None else rgb + r
            out_flat[b, p0:p0 + len(p)] = rgb
    return out


def fused_synthesis(folded: Dict, style_map, fixed_style, num_blocks: int, mod_blocks,
                    map3d_mode: str, compute_dtype=torch.bfloat16, tables=None):
    """rgb (B, H, W, 3) float32 from the upsampled style map (B, H, W, F)
    and the fixed style (B, 1, F).  CUDA tensors launch K3 (bf16 only; with
    ``tables``, ``synthesis_operands``' tables of ``folded``); CPU tensors
    take ``synthesis_plain``."""
    if style_map.device.type == "cpu":
        return synthesis_plain(folded, style_map, fixed_style, num_blocks, mod_blocks,
                               map3d_mode, compute_dtype)
    if style_map.device.type != "cuda":
        raise ValueError(f"fused_synthesis: unsupported device {style_map.device}")
    if compute_dtype != torch.bfloat16:
        raise ValueError("the synthesis kernel computes in bfloat16 only")
    return synthesis_cuda(folded, style_map, fixed_style, num_blocks, mod_blocks, map3d_mode,
                          tables)


PIXELS_PER_CTA = 64  # pixels one CTA of the kernel holds
CHUNK_ROWS = 16  # K rows of a chunk image of the weight stream
RING_STAGES = 3  # stages of the kernel's weight ring (csrc/synthesis_core.cuh kStages)


def chunk_images(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) weight (K % 16 == 0, N % 8 == 0) as its K/16 chunk images,
    flat: image q holds rows 16q..16q+15 as 8 x 16-byte core matrices,
    element (k, n) at ((n // 8) * 2 + k // 8) * 64 + (n % 8) * 8 + k % 8 —
    wgmma's K-major B layout without swizzle, the two K halves 128 bytes and
    the 8-column groups 256 bytes apart (``desc_b`` in
    csrc/synthesis_core.cuh)."""
    K, N = w.shape
    return w.reshape(K // CHUNK_ROWS, 2, 8, N // 8, 8).permute(0, 3, 1, 4, 2).reshape(-1)


def gamma_beta_pass(g_w: torch.Tensor, bt_w: torch.Tensor, p: int) -> torch.Tensor:
    """Column pass p (0, 1) of the gamma and beta heads (K, hp) as one (K,
    hp) matrix: 8-column groups alternate gamma s, beta s over the pass's
    hp/2 columns, so a thread's accumulators hold gamma and beta of the same
    elements."""
    K, hp = g_w.shape
    h2 = hp // 2
    parts = [t[:, p * h2:(p + 1) * h2].reshape(K, h2 // 8, 1, 8) for t in (g_w, bt_w)]
    return torch.cat(parts, 2).reshape(K, hp)


def pack_weight_stream(folded: Dict, num_blocks: int, mods, hp: int, fp: int):
    """Every weight K3 reads, as one contiguous bf16 stream of chunk images in
    the order the kernel consumes them: per block and half, for the blocks in
    ``mods`` the SPADE shared layer (fp x 128) and the gamma/beta heads (two
    column passes of ``gamma_beta_pass``), then the conv (hp x hp).  Returns
    (stream, the bytes of each chunk); every chunk is 16 rows x N x 2 bytes,
    a multiple of 256."""
    bf16 = torch.bfloat16
    images, sizes = [], []

    def put(w):
        images.append(chunk_images(w))
        sizes.extend([CHUNK_ROWS * w.shape[1] * 2] * (w.shape[0] // CHUNK_ROWS))

    for i in range(num_blocks):
        for si in (0, 1):
            if i in mods:
                k = f"b{i}_sp{si}"
                put(pad_to(folded[f"{k}_sh_w"], (fp, SPADE_HIDDEN), bf16))
                g_w = pad_to(folded[f"{k}_g_w"], (SPADE_HIDDEN, hp), bf16)
                bt_w = pad_to(folded[f"{k}_bt_w"], (SPADE_HIDDEN, hp), bf16)
                for p in (0, 1):
                    put(gamma_beta_pass(g_w, bt_w, p))
            put(pad_to(folded[f"b{i}_conv{si}_w"], (hp, hp), bf16))
    return torch.cat(images), sizes


def _stack_pad(ts, shape, dtype):
    return torch.stack([pad_to(t, shape, dtype) for t in ts], 0)


def mod_blocks_of(num_blocks: int, mod_blocks, map3d_mode: str):
    rank1 = rank1_blocks_of(num_blocks, mod_blocks, map3d_mode)
    return [i for i in range(num_blocks) if i not in rank1]


def weight_tables(folded: Dict, num_blocks: int, mods) -> Dict:
    """K3's operands that depend on the weights alone: the bf16 weight stream,
    the float32 tables of the conv biases, of the SPADE biases of the blocks
    in ``mods`` (``sp``), and of the padded input and ToRGB weights and
    biases; and the other blocks' ``rank1_weights``."""
    bf16, f32 = torch.bfloat16, torch.float32
    hp = fp = round16(folded["b0_conv0_w"].shape[1])
    stream, _ = pack_weight_stream(folded, num_blocks, mods, hp, fp)
    cb = [folded[f"b{i}_conv{ci}_b"][0] for i in range(num_blocks) for ci in (0, 1)]
    spk = lambda k: [folded[f"b{i}_sp{si}_{k}"][0] for i in mods for si in (0, 1)]
    rnd = lambda t: t.to(bf16).float()  # operands the kernel reads as bf16 values
    if mods:
        sp = [_stack_pad(spk("sh_b"), (SPADE_HIDDEN,), f32), _stack_pad(spk("g_b"), (hp,), f32),
              _stack_pad(spk("bt_b"), (hp,), f32)]
    else:
        sp = [torch.zeros(16, dtype=f32, device=stream.device)] * 3
    rank1 = [i for i in range(num_blocks) if i not in mods]
    return {
        "rank1_w": rank1_weights(folded, rank1, bf16),
        "in_w": pad_to(rnd(folded["in_w"]), (2, hp), f32),
        "in_b": pad_to(folded["in_b"][0], (hp,), f32),
        "stream": stream,
        "conv_b": _stack_pad(cb, (hp,), f32),
        "sp": sp,
        "rgb_w": _stack_pad([rnd(folded[f"b{i}_rgb_w"]) for i in range(num_blocks)], (hp, 3), f32),
        "rgb_b": torch.stack([folded[f"b{i}_rgb_b"][0].float() for i in range(num_blocks)], 0),
    }


_ENTRY = "_k3_operands"  # the cached operands' attribute on a SynthesisNetwork


def _state_tensors(module, out):
    """``out`` with every parameter and buffer of ``module`` and its children
    appended: the walk of ``parameters()`` and ``buffers()`` without their
    names, a fifth of their host time."""
    out.extend(t for t in itertools.chain(module._parameters.values(),
                                          module._buffers.values()) if t is not None)
    for child in module._modules.values():
        if child is not None:
            _state_tensors(child, out)
    return out


def synthesis_operands(network, syn_input, normalization: str, num_blocks: int, mod_blocks,
                       map3d_mode: str):
    """K3's weight operands for ``network`` and ``syn_input``: (the folded
    dict, and on CUDA ``weight_tables``; None elsewhere), built once per set
    of weights.  They stay on ``network`` as a plain attribute (in no state
    dict), keyed on the address and the version of every parameter and
    buffer of both modules: ``load_state_dict``, an optimizer or EMA step, a
    running-stats update, the spectral norm's ``u`` in train mode (each
    bumps a version), ``.to()`` and ``p.data = ...`` (each moves a storage)
    rebuild them; a write through ``p.data`` bumps no version and is not
    seen.  The entry holds those storages, so no address of its key can
    belong to another tensor while it lives."""
    global operand_builds, operand_hits
    tensors = _state_tensors(syn_input, _state_tensors(network, []))
    key = (normalization, tensors[0].device, tensors[0].dtype, num_blocks, tuple(mod_blocks),
           map3d_mode, tuple((t.data_ptr(), t._version) for t in tensors))
    entry = network.__dict__.get(_ENTRY)
    if entry is not None and entry[0] == key:
        operand_hits += 1
        return entry[2], entry[3]
    with trace.span("synthesis.operands"):
        network.__dict__.pop(_ENTRY, None)  # the old operands go before the new are built
        folded = fold_synthesis_params(network, syn_input, normalization)
        tables = None
        if tensors[0].device.type == "cuda":
            tables = weight_tables(folded, num_blocks,
                                   mod_blocks_of(num_blocks, mod_blocks, map3d_mode))
        setattr(network, _ENTRY, (key, [t.detach() for t in tensors], folded, tables))
    operand_builds += 1
    return folded, tables


def synthesis_cuda(folded, style_map, fixed_style, num_blocks, mod_blocks, map3d_mode,
                   tables=None):
    """K3 on the card; ``tables``: ``weight_tables`` of ``folded``, built
    here when None."""
    global launches
    with trace.span("synthesis.glue"):  # the operands, up to the C call
        bf16, f32 = torch.bfloat16, torch.float32
        B, H, W, F = style_map.shape
        dev = style_map.device
        hidden = folded["b0_conv0_w"].shape[1]
        if folded["in_w"].shape[1] != hidden or F != hidden:
            raise ValueError("synthesis kernel needs feature_dim == hidden_dim "
                             f"(got style {F}, input {folded['in_w'].shape[1]}, hidden {hidden})")
        if (H * W) % PIXELS_PER_CTA:
            raise ValueError(f"synthesis kernel needs H*W divisible by {PIXELS_PER_CTA}")
        hp = fp = round16(hidden)
        rank1 = rank1_blocks_of(num_blocks, mod_blocks, map3d_mode)
        mods = mod_blocks_of(num_blocks, mod_blocks, map3d_mode)
        if num_blocks > 32:
            raise ValueError(f"synthesis kernel takes at most 32 blocks, got {num_blocks}")
        if tables is None:
            tables = weight_tables(folded, num_blocks, mods)
        if rank1:
            gab = rank1_rows(folded, fixed_style, rank1, bf16, tables["rank1_w"])
            gab = pad_to(gab.to(bf16).float(), (B, gab.shape[1], hp), f32)
        else:
            gab = torch.zeros(16, dtype=f32, device=dev)
        stream = tables["stream"]
        args = [
            style_map.to(bf16).contiguous(),
            fixed_style.reshape(B, F).to(bf16).contiguous(),
            gab,
            tables["in_w"],
            tables["in_b"],
            stream,
            tables["conv_b"],
            *tables["sp"],
            tables["rgb_w"],
            tables["rgb_b"],
        ]
        for t in args:
            if t.device != dev:
                raise ValueError(f"synthesis kernel operand on {t.device}, expected {dev}")
        rgb = torch.empty(B, H, W, 3, dtype=f32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        cuda_stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.thgt_synthesis(
            *[t.data_ptr() for t in args], rgb.data_ptr(),
            B, H, W, F, fp, hp, num_blocks, gab.shape[1] if rank1 else 0,
            int(map3d_mode in ("all", "mixed")), sum(1 << i for i in mods),
            stream.numel() * stream.element_size(), cuda_stream)
    _build.check(err, "thgt_synthesis")
    launches += 1
    return rgb
