"""Image augmentation (threedhumangan_tpu/data/augment.py).

Holds ``grid_sample_bilinear`` for now, which ``apps/eval_consistency.py``
warps with; the ADA pipe of the JAX module is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with zero padding; ``img`` NHWC, ``grid`` (B, H, W, 2)
    as (x, y) in [-1, 1], where -1 and 1 are the centres of the corner
    pixels: the JAX formula ``x = (g + 1) / 2 * (W - 1)`` is
    ``align_corners=True``.  Returns NHWC."""
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)
