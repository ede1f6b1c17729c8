"""Fused bias + activation (+ gain + clamp), plain PyTorch.

Counterpart of threedhumangan_tpu/ops/bias_act.py, which is itself plain
jnp: elementwise work that the framework fuses into the producing matmul.
The activation table (names, default alpha and gain) matches it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)

# name -> (fn(x, alpha), default alpha, default gain)
activation_funcs = {
    "linear": (lambda x, a: x, 0.0, 1.0),
    "relu": (lambda x, a: torch.relu(x), 0.0, _SQRT2),
    "lrelu": (lambda x, a: torch.where(x >= 0, x, x * a), 0.2, _SQRT2),
    "tanh": (lambda x, a: torch.tanh(x), 0.0, 1.0),
    "sigmoid": (lambda x, a: torch.sigmoid(x), 0.0, 1.0),
    "elu": (lambda x, a: F.elu(x), 0.0, 1.0),
    "selu": (lambda x, a: F.selu(x), 0.0, 1.0),
    "softplus": (lambda x, a: F.softplus(x), 0.0, 1.0),
    "swish": (lambda x, a: F.silu(x), 0.0, _SQRT2),
}


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    dim: int = -1,
    act: str = "linear",
    alpha: Optional[float] = None,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """y = clamp(gain * act(x + broadcast(b, dim)), ±clamp).  ``dim``
    defaults to the last (channels-last) axis, as in the JAX op."""
    fn, def_alpha, def_gain = activation_funcs[act]
    alpha = def_alpha if alpha is None else float(alpha)
    gain = def_gain if gain is None else float(gain)
    if clamp is not None and clamp < 0:
        raise ValueError(f"clamp must be >= 0, got {clamp}")
    if b is not None:
        if b.ndim != 1:
            raise ValueError("bias must be 1-d")
        shape = [1] * x.ndim
        shape[dim] = b.shape[0]
        x = x + b.reshape(shape).to(x.dtype)
    x = fn(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        x = torch.clamp(x, -clamp, clamp)
    return x
