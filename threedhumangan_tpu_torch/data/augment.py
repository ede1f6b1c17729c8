"""Adaptive discriminator augmentation (threedhumangan_tpu/data/augment.py).

The ADA pipe as the JAX package's ``augment_pipe`` computes it, on NHWC
images in [-1, 1]: probability-gated pixel blits (xflip; rotate90, with
2:1 images padded to a square, rotated and cropped back; integer
translation), the geometric transforms (isotropic and anisotropic scale,
rotation, fractional translation) composed into one affine warp sampled
bilinearly with zero padding, the colour transforms (brightness, contrast,
lumaflip, hue, saturation) composed into one 4 x 4 matrix in the JAX
package's order, the wavelet-band filter (``imgfilter``: a sym2 filter bank
applied as a separable depthwise convolution with reflect padding),
additive noise and cutout.

The pipe is split in two, so that a test can hand in the JAX package's
draws (as the train steps' ``draws`` mapping does):

  ``sample_augment(cfg, shape, generator, device)`` returns the per-image
  random values as named tensors, drawn on ``device`` from ``generator``
  with no host sync: the uniform behind each gate (not the boolean, since
  p is applied inside) and each transform's draw;
  ``apply_augment(images, cfg, p, draws)`` applies them at probability p.

Every step is differentiable (the G step takes gradients through the
fakes' augmentation) and written with ops whose CUDA backward is
deterministic under ``torch.use_deterministic_algorithms``: the warp is
four ``torch.gather`` taps and a lerp in JAX's operation order, and the
filter's reflect padding is an ``index_select``.  ``grid_sample_bilinear``
(``F.grid_sample``) stays for ``apps/eval_consistency.py``.

``cfg`` is the config's ``ada_aug``; keys it leaves out take the defaults
of the JAX package's ``AugmentPipe`` (``augment_config``).  The JAX train
step hands ``ada_aug`` to ``augment_pipe`` as it is, which then indexes
``scale_std`` and the other strengths' spreads without a default, so the
shipped ``ada_aug`` raises ``KeyError`` there; the port fills them in.

Colour on other than 3 channels follows the JAX rule for one channel: the
mean of the matrix's RGB rows scales every channel, so the 6-channel
inputs of dual discrimination get a luma-averaged scale (kept for parity).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# the JAX package's AugmentPipe defaults
AUGMENT_DEFAULTS = dict(
    xflip=0, rotate90=0, xint=0, xint_max=0.125,
    scale=0, rotate=0, aniso=0, xfrac=0,
    scale_std=0.2, rotate_max=1.0, aniso_std=0.2, xfrac_std=0.125,
    brightness=0, contrast=0, lumaflip=0, hue=0, saturation=0,
    brightness_std=0.2, contrast_std=0.5, hue_max=1.0, saturation_std=1.0,
    imgfilter=0, imgfilter_bands=(1, 1, 1, 1), imgfilter_std=1.0,
    noise=0, cutout=0, noise_std=0.1, cutout_size=0.5)

# the groups in the order the pipe applies them
GROUPS = ("xflip", "rotate90", "xint", "scale", "rotate", "aniso", "xfrac", "brightness",
          "contrast", "lumaflip", "hue", "saturation", "imgfilter", "noise", "cutout")
_WARP = ("xint", "scale", "rotate", "aniso", "xfrac")

# sym2 wavelet low-pass coefficients
_SYM2 = [-0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025]
_LUMA = np.asarray([1.0, 1.0, 1.0, 0.0]) / np.sqrt(3.0)


def augment_config(cfg: Dict) -> Dict:
    """``cfg`` over ``AUGMENT_DEFAULTS``."""
    out = {**AUGMENT_DEFAULTS, **cfg}
    out["imgfilter_bands"] = tuple(out["imgfilter_bands"])
    return out


def _enabled(cfg: Dict, group: str, channels: int) -> bool:
    # hue and saturation need colour
    return bool(cfg[group]) and (channels > 1 or group not in ("hue", "saturation"))


@functools.lru_cache()
def _wavelet_fbank(num_bands: int = 4) -> np.ndarray:
    """The sym2 band-pass filter bank, (bands, taps) float32."""
    hz_lo = np.asarray(_SYM2)
    hz_hi = hz_lo * ((-1.0) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2.0
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2.0
    fbank = np.eye(num_bands, 1)
    for i in range(1, num_bands):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(fbank.shape[0], -1)[:, :-1]
        fbank = np.stack([np.convolve(row, hz_lo2) for row in fbank])
        lo = (fbank.shape[1] - hz_hi2.size) // 2
        fbank[i, lo:lo + hz_hi2.size] += hz_hi2
    return fbank.astype(np.float32)


def sample_augment(cfg: Dict, shape: Sequence[int], generator: torch.Generator,
                   device) -> Dict[str, torch.Tensor]:
    """The per-image draws of one pass of the pipe over a (B, H, W, C) batch:
    ``<group>_u`` the uniform behind each gate, and each group's own draw."""
    cfg = augment_config(cfg)
    B, _, _, C = shape
    kw = dict(generator=generator, device=device)
    uniform = lambda *s: torch.rand(*s, **kw)
    normal = lambda *s: torch.randn(*s, **kw)
    own = {"rotate90_n": lambda: torch.randint(0, 4, (B,), **kw),
           "xint_t": lambda: uniform(B, 2) * 2 - 1, "scale_n": lambda: normal(B),
           "rotate_t": lambda: uniform(B) * 2 - 1, "aniso_n": lambda: normal(B),
           "xfrac_n": lambda: normal(B, 2), "brightness_n": lambda: normal(B),
           "contrast_n": lambda: normal(B), "lumaflip_t": lambda: uniform(B),
           "hue_t": lambda: uniform(B), "saturation_n": lambda: normal(B),
           "cutout_c": lambda: uniform(B, 2)}
    draws = {}
    for g in GROUPS:
        if not _enabled(cfg, g, C):
            continue
        if g == "imgfilter":
            bands = len(cfg["imgfilter_bands"])
            draws.update(imgfilter_n=normal(B, bands), imgfilter_u=uniform(B, bands))
        elif g == "noise":
            draws.update(noise_sigma=normal(B), noise_u=uniform(B), noise_n=normal(*shape))
        else:
            draws[f"{g}_u"] = uniform(B)
            draws.update({k: make() for k, make in own.items() if k.rsplit("_", 1)[0] == g})
    return draws


def _bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (ndim - v.dim()))


def _warp_bilinear(images: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear taps of (B, H, W, C) ``images`` at pixel coordinates x, y
    (B, P), zero outside: four gathers and a lerp, as JAX's
    ``grid_sample_bilinear``.  Returns (B, P, C)."""
    B, H, W, C = images.shape
    flat = images.reshape(B, H * W, C)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]

    def tap(yy, xx):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        return vals * inb[..., None].to(vals.dtype)

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _affine_inverse(theta, sx, sy, tx, ty):
    """The inverse of scale -> rotate -> translate, as (B, 2, 3) rows."""
    cos, sin = torch.cos(theta), torch.sin(theta)
    a, b, c, d = cos * sx, -sin * sy, sin * sx, cos * sy
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    return torch.stack([torch.stack([ia, ib, -(ia * tx + ib * ty)], -1),
                        torch.stack([ic, id_, -(ic * tx + id_ * ty)], -1)], -2)


def _eye4(B, like):
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(B, 4, 4)


def _translate3d(b):
    m = _eye4(b.shape[0], b).clone()
    m[:, :3, 3] = b[:, None]
    return m


def _scale3d(c):
    return torch.diag_embed(torch.stack([c, c, c, torch.ones_like(c)], -1))


def _rotate3d_luma(theta):
    v = _LUMA[:3] / np.linalg.norm(_LUMA[:3])
    K = np.asarray([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    t = lambda a: torch.as_tensor(a, dtype=theta.dtype, device=theta.device)
    cos, sin = _bcast(torch.cos(theta), 3), _bcast(torch.sin(theta), 3)
    m = _eye4(theta.shape[0], theta).clone()
    m[:, :3, :3] = cos * t(np.eye(3)) + sin * t(K) + (1 - cos) * t(np.outer(v, v))
    return m


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source rows of numpy's 'reflect' padding of ``n`` rows by ``pad`` on
    each side (periodic with period 2(n - 1) once the pad exceeds n - 1)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    r = torch.remainder(i, period)
    return torch.where(r < n, r, period - r)


def apply_augment(images: torch.Tensor, cfg: Dict, p: float,
                  draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The pipe on (B, H, W, C) ``images`` at probability ``p`` with
    ``draws`` (``sample_augment``'s).  Transforms are formed in float32, or
    in float64 for float64 images (a reference for the rounding of float32)."""
    cfg = augment_config(cfg)
    B, H, W, C = images.shape
    dev = images.device
    on = lambda g: _enabled(cfg, g, C)
    gate = lambda key, strength: draws[key] < p * strength
    pick = lambda do, a, b: torch.where(_bcast(do, a.dim()), a, b)

    # ---- pixel blits
    if on("xflip"):
        images = pick(gate("xflip_u", cfg["xflip"]), images.flip(2), images)
    if on("rotate90"):
        do, n = gate("rotate90_u", cfg["rotate90"]), draws["rotate90_n"]
        py = px = 0
        src = images
        if H != W:  # pad to a square, rotate, crop back
            side = max(H, W)
            py, px = (side - H) // 2, (side - W) // 2
            src = F.pad(images, (0, 0, px, side - W - px, py, side - H - py))
        sel = src
        for i in (1, 2, 3):
            sel = pick(n == i, torch.rot90(src, i, (1, 2)), sel)
        images = pick(do, sel[:, py:py + H, px:px + W], images)

    # ---- the geometric warp: one composed affine
    wdt = torch.promote_types(images.dtype, torch.float32)
    wk = dict(dtype=wdt, device=dev)
    theta, tx, ty = (torch.zeros(B, **wk) for _ in range(3))
    sx, sy = torch.ones(B, **wk), torch.ones(B, **wk)
    if on("xint"):
        do = gate("xint_u", cfg["xint"])
        t = draws["xint_t"] * cfg["xint_max"]
        tx = tx + torch.where(do, torch.round(t[:, 0] * W) / max(W - 1, 1) * 2, 0.0)
        ty = ty + torch.where(do, torch.round(t[:, 1] * H) / max(H - 1, 1) * 2, 0.0)
    if on("scale"):
        s = torch.exp2(draws["scale_n"] * cfg["scale_std"])
        s = torch.where(gate("scale_u", cfg["scale"]), s, 1.0)
        sx, sy = sx * s, sy * s
    if on("rotate"):
        r = draws["rotate_t"] * (math.pi * cfg["rotate_max"])
        theta = theta + torch.where(gate("rotate_u", cfg["rotate"]), r, 0.0)
    if on("aniso"):
        a = torch.exp2(draws["aniso_n"] * cfg["aniso_std"])
        a = torch.where(gate("aniso_u", cfg["aniso"]), a, 1.0)
        sx, sy = sx * a, sy / a
    if on("xfrac"):
        do = gate("xfrac_u", cfg["xfrac"])
        t = draws["xfrac_n"] * cfg["xfrac_std"]
        tx = tx + torch.where(do, t[:, 0] * 2, 0.0)
        ty = ty + torch.where(do, t[:, 1] * 2, 0.0)
    if any(on(g) for g in _WARP):
        # inverse warp: the source of each output pixel, on JAX's linspace grid
        inv = _affine_inverse(theta, sx, sy, tx, ty)
        gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, H, **wk),
                                torch.linspace(-1.0, 1.0, W, **wk), indexing="ij")
        pix = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(1, H * W, 3)
        src = torch.einsum("bij,bnj->bni", inv, pix.expand(B, H * W, 3))
        x = (src[..., 0] + 1.0) * 0.5 * (W - 1)
        y = (src[..., 1] + 1.0) * 0.5 * (H - 1)
        images = _warp_bilinear(images, x, y).reshape(B, H, W, C)

    # ---- colour: one 4 x 4 matrix, brightness -> contrast -> lumaflip ->
    # hue -> saturation
    Cm = _eye4(B, theta)
    vvt = torch.as_tensor(np.outer(_LUMA, _LUMA), **wk)
    eye = torch.eye(4, **wk)
    if on("brightness"):
        b = draws["brightness_n"] * cfg["brightness_std"]
        Cm = _translate3d(torch.where(gate("brightness_u", cfg["brightness"]), b, 0.0)) @ Cm
    if on("contrast"):
        c = torch.exp2(draws["contrast_n"] * cfg["contrast_std"])
        Cm = _scale3d(torch.where(gate("contrast_u", cfg["contrast"]), c, 1.0)) @ Cm
    if on("lumaflip"):
        i = torch.floor(draws["lumaflip_t"] * 2)
        i = torch.where(gate("lumaflip_u", cfg["lumaflip"]), i, 0.0)
        Cm = (eye - 2.0 * vvt * _bcast(i, 3)) @ Cm
    if on("hue"):
        t = (draws["hue_t"] * 2 - 1) * (math.pi * cfg["hue_max"])
        Cm = _rotate3d_luma(torch.where(gate("hue_u", cfg["hue"]), t, 0.0)) @ Cm
    if on("saturation"):
        s = torch.exp2(draws["saturation_n"] * cfg["saturation_std"])
        s = torch.where(gate("saturation_u", cfg["saturation"]), s, 1.0)
        Cm = (vvt + (eye - vvt) * _bcast(s, 3)) @ Cm
    if any(on(g) for g in ("brightness", "contrast", "lumaflip", "hue", "saturation")):
        px_ = images.reshape(B, H * W, C).to(wdt)
        if C == 3:
            px_ = px_ @ Cm[:, :3, :3].transpose(1, 2) + Cm[:, None, :3, 3]
        else:  # one channel's rule: the mean of the RGB rows
            Cme = Cm[:, :3, :].mean(1)
            px_ = px_ * Cme[:, None, :3].sum(-1, keepdim=True) + Cme[:, None, 3:]
        images = px_.reshape(B, H, W, C)

    # ---- the wavelet-band filter: separable depthwise conv, reflect padding
    if on("imgfilter"):
        bands = cfg["imgfilter_bands"]
        nb = len(bands)
        fbank = torch.as_tensor(_wavelet_fbank(nb), **wk)
        power = torch.as_tensor(np.array([10.0, 1.0, 1.0, 1.0])[:nb] / 13.0, **wk)
        g = torch.ones(B, nb, **wk)
        for i, strength in enumerate(bands):
            t_i = torch.exp2(draws["imgfilter_n"][:, i] * cfg["imgfilter_std"])
            t_i = torch.where(draws["imgfilter_u"][:, i] < p * cfg["imgfilter"] * strength,
                              t_i, 1.0)
            t = torch.ones(B, nb, **wk)
            t[:, i] = t_i
            g = g * (t / torch.sqrt(torch.sum(power * torch.square(t), -1, keepdim=True)))
        hz = g @ fbank
        taps = hz.shape[-1]
        pad = taps // 2
        kern = hz.repeat_interleave(C, 0)  # row b * C + c is image b's
        x = images.to(wdt).permute(0, 3, 1, 2).reshape(1, B * C, H, W)
        x = x.index_select(2, _reflect_index(H, pad, dev))
        x = x.index_select(3, _reflect_index(W, pad, dev))
        x = F.conv2d(x, kern[:, None, None, :], groups=B * C)
        x = F.conv2d(x, kern[:, None, :, None], groups=B * C)
        images = x.reshape(B, C, H, W).permute(0, 2, 3, 1)

    # ---- image-space corruptions
    if on("noise"):
        sigma = torch.abs(draws["noise_sigma"]) * cfg["noise_std"]
        sigma = torch.where(gate("noise_u", cfg["noise"]), sigma, 0.0)
        images = images + draws["noise_n"] * _bcast(sigma, 4)
    if on("cutout"):
        size = torch.where(gate("cutout_u", cfg["cutout"]), cfg["cutout_size"], 0.0)
        center = draws["cutout_c"]
        cx = torch.arange(W, **wk)[None, None, :]
        cy = torch.arange(H, **wk)[None, :, None]
        half = _bcast(size, 3) / 2
        mask_x = torch.abs((cx + 0.5) / W - _bcast(center[:, 0], 3)) >= half
        mask_y = torch.abs((cy + 0.5) / H - _bcast(center[:, 1], 3)) >= half
        images = images * (mask_x | mask_y)[..., None]
    return images


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with zero padding; ``img`` NHWC, ``grid`` (B, H, W, 2)
    as (x, y) in [-1, 1], where -1 and 1 are the centres of the corner
    pixels: the JAX formula ``x = (g + 1) / 2 * (W - 1)`` is
    ``align_corners=True``.  Returns NHWC."""
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)
