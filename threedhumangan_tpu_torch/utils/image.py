"""Image resizes as ``jax.image.resize`` computes them, for NHWC tensors.

``jax.image.resize`` samples at half-pixel centres and, where it shrinks an
axis, widens its kernel by the scale (antialiasing): that is
``F.interpolate(..., align_corners=False, antialias=True)``, which for an
axis that grows is plain bilinear.  Its "nearest" takes the pixel whose
centre lies nearest a half-pixel centre, torch's ``"nearest-exact"``.
(``models.generator.resize_feature_maps`` only upsamples and keeps the
plain form.)
"""

from __future__ import annotations

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
