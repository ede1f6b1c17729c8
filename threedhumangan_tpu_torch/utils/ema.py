"""Exponential moving average of the generator's parameters
(threedhumangan_tpu/utils/ema.py): warm-up decay
min(decay, (1 + n) / (10 + n)) with n the update count."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def ema_init(module: nn.Module) -> Dict:
    return {"params": {k: p.detach().clone() for k, p in module.named_parameters()},
            "count": 0}


@torch.no_grad()
def ema_update(ema: Dict, module: nn.Module, decay: float = 0.999) -> Dict:
    """e -= (1 - d) (e - p), in place."""
    ema["count"] += 1
    n = ema["count"]
    d = min(decay, (1.0 + n) / (10.0 + n))
    names = [k for k, _ in module.named_parameters()]
    e = [ema["params"][k] for k in names]
    p = [q.detach() for _, q in module.named_parameters()]
    diff = torch._foreach_sub(e, p)
    torch._foreach_add_(e, diff, alpha=-(1.0 - d))
    return ema
