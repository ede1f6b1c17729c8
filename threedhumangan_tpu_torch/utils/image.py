"""Image resizes as ``jax.image.resize`` computes them, for NHWC tensors.

``jax.image.resize`` samples at half-pixel centres and, where it shrinks an
axis, widens its kernel by the scale (antialiasing): that is
``F.interpolate(..., align_corners=False, antialias=True)``, which for an
axis that grows is plain bilinear.  Its "nearest" takes the pixel whose
centre lies nearest a half-pixel centre, torch's ``"nearest-exact"``.
(``models.generator.resize_feature_maps`` keeps the plain bilinear form for
its upsampling.)

``resize`` computes every method ``jax.image.resize`` takes from JAX's own
weight rule, where ``F.interpolate`` differs: JAX's cubic is Keys' with
a = -0.5 (torch's bicubic uses -0.75), and JAX drops the taps that fall
outside the input and renormalises the rest where torch clamps the index.
Each resized axis is one product with an (out, in) weight matrix.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C), ``jax.image.resize`` 'bilinear'."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W) -> (B, height, width), ``jax.image.resize`` 'nearest'."""
    return F.interpolate(x[:, None], size=(height, width), mode="nearest-exact")[:, 0]


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float):
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        safe = torch.where(x != 0, math.pi ** 2 * x ** 2, torch.ones_like(x))
        out = torch.where(x > 1e-3, y / safe, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


_KERNELS = {"linear": lambda x: torch.clamp(1.0 - x.abs(), min=0.0), "cubic": _keys_cubic,
            "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}
_ALIASES = {"bilinear": "linear", "trilinear": "linear", "triangle": "linear",
            "bicubic": "cubic", "tricubic": "cubic"}


def _resize_weights(in_size: int, out_size: int, method: str, antialias: bool = True,
                   device=None) -> torch.Tensor:
    """(out, in) float32 weights of one axis (JAX ``compute_weight_mat``):
    the kernel at half-pixel centres, widened by the scale where the axis
    shrinks (``antialias``), each row renormalised, rows whose sample lies
    outside the input zero."""
    kernel = _KERNELS[_ALIASES.get(method, method)]
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale
              - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample[:, None] - src[None, :]).abs() / kernel_scale)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def resize(x: torch.Tensor, height: int, width: int, method: str,
           antialias: bool = True) -> torch.Tensor:
    """(B, H, W, C) -> (B, height, width, C), ``jax.image.resize`` with
    ``method`` ('nearest', 'linear'/'bilinear', 'cubic', 'lanczos3',
    'lanczos5').  'nearest' takes input index floor((i + 0.5) * in / out)
    computed in float32; the others are one product a resized axis, the
    weights rounded to x's dtype (as JAX casts them) and the sums taken in
    float32.  An axis that keeps its size is left as it is."""
    if method == "nearest":
        for dim, n in ((1, height), (2, width)):
            m = x.shape[dim]
            if m != n:
                idx = torch.floor((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5)
                                  * m / n).long()
                x = x.index_select(dim, idx)
        return x
    dtype = x.dtype
    if x.shape[1] != height:
        w = _resize_weights(x.shape[1], height, method, antialias, x.device).to(dtype)
        x = torch.einsum("oh,bhwc->bowc", w.float(), x.float()).to(dtype)
    if x.shape[2] != width:
        w = _resize_weights(x.shape[2], width, method, antialias, x.device).to(dtype)
        x = torch.einsum("ow,bhwc->bhoc", w.float(), x.float()).to(dtype)
    return x
