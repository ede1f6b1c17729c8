"""Training statistics as (count, sum, sum of squares) moments
(threedhumangan_tpu/parallel/stats.py).  On one process the JAX package's
cross-replica psum of the moments is the identity, so there is none here."""

from __future__ import annotations

import torch


def moments(x) -> torch.Tensor:
    """[count, sum, sum_sq] of a tensor as one float32 vector (no grad)."""
    x = torch.as_tensor(x).detach().float()
    return torch.stack([torch.tensor(float(x.numel()), device=x.device), x.sum(),
                        torch.square(x).sum()])
