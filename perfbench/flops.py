"""Operations and bytes of the Map3D layers at a cell's shapes, and the
card's peaks: the yardstick of every roofline and utilisation metric.

The counts are the work the layer's mathematics needs, whatever kernel
implements it: 2 operations a multiply-add of every product, each input
the layer needs read once and each output written once (weights, which
stay in cache, are not counted).  ``field`` and ``synthesis`` extend the
per-kernel bounds of ``chip_smoke.py`` (``field_bound``,
``synthesis_bound``) to whole stages; ``bound_s`` is theirs.
"""

from __future__ import annotations

from typing import Dict

from perfbench.reference.discriminator import CHANNELS, layout, num_blocks

# NVIDIA H100 SXM data sheet, dense
PEAK_BF16 = 989e12  # FLOP/s
HBM_BPS = 3.35e12   # bytes/s
SPADE_HIDDEN = 128


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """Least seconds for the work: operations at the peak of their type or
    bytes at the memory rate, whichever is longer."""
    return max(flops / peak, nbytes / HBM_BPS)


def field(meta: Dict, images: int, act_bytes: int = 2, backward: bool = False) -> Dict:
    """The FiLM-SIREN over every sample of ``images`` renders and the
    composite: the first layers (3 coords and the geo columns), the trunk,
    sigma, the colour layer over [dirs, x], the rgb and feature heads.  In:
    the packed samples (coords, geo, dirs, noise) in the compute dtype; out:
    the composited map and depth in float32.  ``backward``: the backward of
    the same products (data and weight gradients, 2x the forward's)."""
    H, NB, F = meta["hidden_dim"], meta["neural_field_blocks"], meta["feature_dim"]
    n_in = meta["input_dim"] + meta["geo_feature_dim"]
    rays = meta["render_width"] * meta["render_height"]
    samples = images * rays * meta["num_steps"]
    macs = n_in * H + 2 * H * H + (NB - 1) * H * H + (H + 3) * H + H + H * (3 + F)
    flops = 2 * macs * samples
    nbytes = samples * (n_in + 3 + 1) * act_bytes + images * rays * (F + 3 + 1) * 4
    if backward:
        flops *= 2
        nbytes *= 2
    return {"flops": flops, "bytes": nbytes}


def synthesis(meta: Dict, images: int, act_bytes: int = 2, backward: bool = False) -> Dict:
    """The SPADE stack at the output size: the Fourier input, two 1x1 convs
    a block, the SPADE MLP (shared, gamma, beta) a half-block per pixel on
    the blocks that take the style map (per image elsewhere: not counted),
    ToRGB from block NB//2-1.  In: the upsampled style map; out: the rgb."""
    NB, mods, mode = meta["synthesis_blocks"], meta["mod_blocks"], meta["map3d_mode"]
    H, F = meta["hidden_dim"], meta["feature_dim"]
    n_mod = NB if mode == "all" else len(mods)
    px = images * meta["gen_height"] * meta["gen_width"]
    macs = (2 * H + NB * 2 * H * H + n_mod * 2 * (F * SPADE_HIDDEN + 2 * SPADE_HIDDEN * H)
            + (NB - NB // 2 + 1) * 3 * H)
    flops = 2 * macs * px
    nbytes = px * (F * act_bytes + 3 * 4)
    if backward:
        flops *= 2
        nbytes *= 2
    return {"flops": flops, "bytes": nbytes}


def mapping(meta: Dict, images: int) -> Dict:
    """The two mapping networks a latent: the field's 4 layers and the
    style trunk's 7 with its synthesis branch."""
    L, H, F, NB = meta["latent_dim"], meta["hidden_dim"], meta["feature_dim"], \
        meta["neural_field_blocks"]
    macs = L * H + 2 * H * H + H * 2 * NB * H + L * F + 6 * F * F + F * F
    return {"flops": 2 * macs * images, "bytes": images * (L + 2 * NB * H + F) * 4}


def generation(meta: Dict, images: int) -> Dict[str, Dict]:
    """The layers of one eval batch, and ``model``: their products summed."""
    act = 2 if meta.get("use_mixed_precision", False) else 4
    out = {"field": field(meta, images, act), "synthesis": synthesis(meta, images, act),
           "mapping": mapping(meta, images)}
    out["model"] = {"flops": sum(v["flops"] for v in out.values()),
                    "bytes": sum(v["bytes"] for v in out.values())}
    return out


def discriminator(meta: Dict, images: int) -> Dict:
    """The U-Net discriminator's forward over ``images``: every conv of its
    ResBlocks at the resolution it runs at (the shortcut's after pooling in
    the first block, before it in the others; the decoder's after
    upsampling), the full-size latent conv (where the bottleneck is more
    than one pixel across) and the two 1x1 heads.  In: the
    images; out: the per-pixel heads, in float32."""
    H, W = meta["gen_height"], meta["gen_width"]
    h, w = H, W
    macs = 0
    nb = num_blocks(meta)
    for i, (_, fin, fout, ud, first) in enumerate(layout(meta)):
        if ud > 0:
            h, w = 2 * h, 2 * w
        macs += (fin * fout + fout * fout) * 9 * h * w
        if fin != fout:
            macs += fin * fout * (h * w // 4 if first else h * w)
        if ud < 0:
            h, w = h // 2, w // 2
        if i == nb - 1 and min(h, w) > 1:  # the latent conv over the bottleneck
            macs += CHANNELS[nb - 1] * meta["latent_dim"] * h * w
    label = meta.get("semantic_dim", 0) + meta.get("label_dim", 0)
    macs += 64 * (1 + label) * H * W
    nbytes = images * H * W * (3 + 1 + label) * 4
    return {"flops": 2 * macs * images, "bytes": nbytes}


def training(meta: Dict, images: int) -> Dict[str, Dict]:
    """The layers of one training pair at batch ``images``: ``fakes`` (the
    generator's train forward of the D step's fakes: field, synthesis,
    mapping), ``g_backward`` (the G step's backward: the generator's, twice
    its forward's products, and the discriminator's to its input, once its
    forward's; a recompute is not counted), and ``pair`` / ``pair_r1`` (the
    pair's products: the generator's forward twice and its backward; the
    discriminator on the reals and the fakes with its backward, twice each
    forward, then on the G step's fakes with the backward to the input; on
    an R1 slot also its forward, the gradient to the input and that
    gradient's backward, four forwards)."""
    act = 2 if meta.get("use_mixed_precision", False) else 4
    g = [field(meta, images, act), synthesis(meta, images, act), mapping(meta, images)]
    g_fwd = {"flops": sum(x["flops"] for x in g), "bytes": sum(x["bytes"] for x in g)}
    d = discriminator(meta, images)
    scale = lambda x, n: {"flops": n * x["flops"], "bytes": n * x["bytes"]}
    add = lambda *xs: {"flops": sum(x["flops"] for x in xs), "bytes": sum(x["bytes"] for x in xs)}
    pair = add(scale(g_fwd, 4), scale(d, 8))
    return {"fakes": g_fwd, "g_backward": add(scale(g_fwd, 2), d), "pair": pair,
            "pair_r1": add(pair, scale(d, 4))}
