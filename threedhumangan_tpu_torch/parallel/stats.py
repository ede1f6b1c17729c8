"""Training statistics as (count, sum, sum of squares) moments
(threedhumangan_tpu/parallel/stats.py).  On one process the JAX package's
cross-replica psum of the moments is the identity, so there is none here.

``moments`` runs inside the train step on the device; ``Collector`` is the
host-side accumulator the trainer feeds every 10 steps with the summed
moments of those steps and reads means from.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def moments(x) -> torch.Tensor:
    """[count, sum, sum_sq] of a tensor as one float32 vector (no grad)."""
    x = torch.as_tensor(x).detach().float()
    return torch.stack([torch.tensor(float(x.numel()), device=x.device), x.sum(),
                        torch.square(x).sum()])


class Collector:
    """Host-side accumulator over per-step moment dicts (names matching ``regex``)."""

    def __init__(self, regex: str = ".*"):
        self._regex = re.compile(regex)
        self._moments: Dict[str, np.ndarray] = {}

    def update(self, stats: Dict) -> None:
        for name, m in stats.items():
            if not self._regex.fullmatch(name):
                continue
            m = np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m, np.float64)
            self._moments[name] = self._moments[name] + m if name in self._moments else m

    def names(self):
        return list(self._moments)

    def num(self, name) -> float:
        return float(self._moments[name][0]) if name in self._moments else 0.0

    def mean(self, name) -> float:
        if name not in self._moments or self._moments[name][0] == 0:
            return float("nan")
        c, s, _ = self._moments[name]
        return float(s / c)

    def std(self, name) -> float:
        if name not in self._moments or self._moments[name][0] == 0:
            return float("nan")
        c, s, ss = self._moments[name]
        mean = s / c
        return float(np.sqrt(max(ss / c - mean * mean, 0.0)))

    def __getitem__(self, name) -> float:
        return self.mean(name)

    def reset(self):
        self._moments.clear()
