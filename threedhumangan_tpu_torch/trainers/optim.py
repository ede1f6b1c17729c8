"""Adam with per-group learning rates and global-norm clipping
(threedhumangan_tpu/trainers/optim.py).

optax ``scale_by_adam`` with betas (0, 0.9), eps 1e-8, is
``torch.optim.Adam``; the gradients are clipped to a global norm before the
update (factor min(1, max_norm / (norm + 1e-6)), as torch's
clip_grad_norm_).  The generator has five parameter groups, each with a
multiplier of the step's learning rate.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn


def generator_lr_multipliers(meta: Dict) -> Dict[str, float]:
    """Learning-rate multiplier of each generator submodule; the rest
    (synthesis input/style input/network) take 1."""
    return {"latent_pool": meta.get("appearance_codes_lr_mul", 1.0),
            "neural_field_mapping_network": meta.get("mapping_net_lr_mul", 1.0),
            "synthesis_mapping_network": 1.0,
            "neural_field": meta.get("neural_field_lr_mul", 1.0)}


def param_groups(module: nn.Module, multipliers: Dict[str, float] | None = None) -> List[Dict]:
    """Parameter groups by top-level submodule: the five generator groups
    (``multipliers`` given), or one group."""
    if multipliers is None:
        return [{"params": list(module.parameters()), "lr_mul": 1.0}]
    groups: Dict[str, Dict] = {}
    order: List[str] = []
    for name, child in module.named_children():
        m = multipliers.get(name, 1.0)
        key = name if name in multipliers else "generator"
        if key not in order:
            order.append(key)
            groups[key] = {"params": [], "lr_mul": m}
        groups[key]["params"] += list(child.parameters())
    return [groups[k] for k in order]


def make_adam(groups: List[Dict], betas: Sequence[float], eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam([dict(g, lr=0.0) for g in groups], lr=0.0,
                            betas=tuple(float(b) for b in betas),
                            eps=eps, foreach=True)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before clipping."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(factor)
    return norm


def adam_step(opt: torch.optim.Adam, grads: List[torch.Tensor], lr: float,
              grad_clip: float = 0.0) -> None:
    """clip -> Adam with per-group lr = lr * lr_mul, in place.  ``grads``
    are in the order of the optimizer's parameters."""
    params = [p for g in opt.param_groups for p in g["params"]]
    if len(grads) != len(params):
        raise ValueError(f"{len(grads)} grads for {len(params)} parameters")
    if grad_clip and grad_clip > 0:
        clip_by_global_norm(grads, grad_clip)
    for p, g in zip(params, grads):
        p.grad = g
    for group in opt.param_groups:
        group["lr"] = float(lr) * group["lr_mul"]
    opt.step()
    for p in params:
        p.grad = None
