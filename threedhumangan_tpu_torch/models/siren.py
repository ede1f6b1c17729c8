"""FiLM-conditioned SIREN neural field, COORDCONCATSIREN
(threedhumangan_tpu/models/siren.py).

Two first layers — coords (omega 30) and the 31-d geo features — are
concatenated; ``num_blocks`` FiLM trunk layers take per-layer slices of
(freq*15+30, phase); heads give sigma, a view-dependent colour through a
FiLM layer over [ray_dirs, x] (which reuses the LAST trunk slice, a
reference quirk), and a feature map.  Output [rgb 3, features, sigma 1].

Keys follow the reference torch module (``first_layer_coord.layer``,
``network.{i}.layer``, ``sigma_layer`` ...), weights (out, in).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from threedhumangan_tpu_torch.ops.raymarch import fast_sin
from threedhumangan_tpu_torch.utils.misc import mm, uniform_


class _Sine(nn.Module):
    """Holder giving a Linear the reference's ``<name>.layer`` key."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.layer = nn.Linear(in_dim, out_dim)


class CoordConcatSiren(nn.Module):
    def __init__(self, input_dim: int = 3, hidden_dim: int = 256, geo_feature_dim: int = 31,
                 feature_dim: int = 384, num_blocks: int = 4,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.first_layer_coord = _Sine(input_dim, hidden_dim)
        self.first_layer_mod = _Sine(geo_feature_dim, hidden_dim)
        in_dims = [2 * hidden_dim] + [hidden_dim] * (num_blocks - 1)
        self.network = nn.ModuleList([_Sine(d, hidden_dim) for d in in_dims])
        self.sigma_layer = nn.Linear(hidden_dim, 1)
        self.color_layer_sine = _Sine(hidden_dim + 3, hidden_dim)
        self.color_layer_linear = nn.Linear(hidden_dim, 3)
        self.feature_layer_linear = nn.Linear(hidden_dim, feature_dim)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        """pi-GAN init: first layers uniform(±1/fan_in), the rest
        uniform(±sqrt(6/fan_in)/25); biases uniform(±1/sqrt(fan_in))."""
        freq25 = lambda fan_in: math.sqrt(6.0 / fan_in) / 25.0
        layers = [(self.first_layer_coord.layer, lambda f: 1.0 / f),
                  (self.first_layer_mod.layer, lambda f: 1.0 / f),
                  (self.sigma_layer, freq25),
                  (self.color_layer_sine.layer, freq25),
                  (self.color_layer_linear, freq25),
                  (self.feature_layer_linear, freq25)]
        layers += [(blk.layer, freq25) for blk in self.network]
        for lin, bound in layers:
            uniform_(lin.weight, bound(lin.in_features), generator)
            uniform_(lin.bias, 1.0 / math.sqrt(lin.in_features), generator)

    def forward(self, points, frequencies, phase_shifts, geo_feature, ray_directions,
                input_scaler: float = 1.0, compute_dtype=torch.float32, fast_math: bool = False):
        """points/geo_feature/ray_directions (B, P, ·); frequencies and
        phase_shifts (B, num_blocks*hidden).  Returns (B, P, 3+F+1)."""
        _sin = fast_sin if fast_math else torch.sin
        H = self.hidden_dim

        def lin(layer, x):
            return mm(x, layer.weight.t(), compute_dtype) + layer.bias.float()

        frequencies = frequencies * 15.0 + 30.0
        x1 = _sin(30.0 * lin(self.first_layer_coord.layer, points * input_scaler))
        x2 = _sin(30.0 * lin(self.first_layer_mod.layer, geo_feature))
        x = torch.cat([x1, x2], -1)
        for i, blk in enumerate(self.network):
            f = frequencies[:, None, i * H:(i + 1) * H]
            p = phase_shifts[:, None, i * H:(i + 1) * H]
            x = _sin(f * lin(blk.layer, x) + p)
        sigma = lin(self.sigma_layer, x)
        xc = torch.cat([ray_directions.to(x.dtype), x], -1)
        f, p = frequencies[:, None, -H:], phase_shifts[:, None, -H:]
        xc = _sin(f * lin(self.color_layer_sine.layer, xc) + p)
        rgb = torch.sigmoid(lin(self.color_layer_linear, xc))
        feat = lin(self.feature_layer_linear, xc)
        return torch.cat([rgb, feat, sigma], -1)


NEURAL_FIELD_REGISTRY = {"COORDCONCATSIREN": CoordConcatSiren}
