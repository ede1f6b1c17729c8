"""Latent mapping networks (threedhumangan_tpu/models/mapping.py).

MappingNetwork          z -> (freq, phase): a 4-layer lrelu MLP over the
                        2nd-moment-normalised latent, last weight x0.25.
TwoPartMappingNetwork   StyleGAN2 equalised-lr trunk (7 layers), a 1-d
                        implicit branch and the synthesis-style branch.

Parameters live in the reference torch key space read by
``threedhumangan_tpu.utils.torch_convert.convert_generator_state_dict``:
``network.{0,2,4,6}`` for the first, ``trunk{t}`` / ``implicit{i}`` /
``superres{i}`` (weights (out, in), gains recomputed) for the second.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from threedhumangan_tpu_torch.ops.bias_act import bias_act
from threedhumangan_tpu_torch.utils.misc import lrelu, mm, normal_, normalize_2nd_moment, uniform_


class MappingNetwork(nn.Module):
    """pi-GAN mapping network (JAX init/apply at mapping.py:36/:50)."""

    def __init__(self, latent_dim: int, map_hidden_dim: int, map_output_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = [latent_dim, map_hidden_dim, map_hidden_dim, map_hidden_dim, map_output_dim]
        layers = []
        for i in range(4):
            if i:
                layers.append(nn.LeakyReLU(0.2))
            layers.append(nn.Linear(dims[i], dims[i + 1]))
        self.network = nn.Sequential(*layers)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        linears = [m for m in self.network if isinstance(m, nn.Linear)]
        for i, lin in enumerate(linears):
            fan_in = lin.in_features
            # kaiming_normal_ (fan_in, leaky_relu a=0.2); last layer x0.25
            std = math.sqrt(2.0 / (1.0 + 0.2 ** 2)) / math.sqrt(fan_in)
            normal_(lin.weight, std, generator)
            if i == len(linears) - 1:
                with torch.no_grad():
                    lin.weight.mul_(0.25)
            uniform_(lin.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, z: torch.Tensor,
                compute_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
        x = normalize_2nd_moment(z.float())
        linears = [m for m in self.network if isinstance(m, nn.Linear)]
        for i, lin in enumerate(linears):
            x = mm(x, lin.weight.t(), compute_dtype) + lin.bias
            if i < len(linears) - 1:
                x = lrelu(x)
        half = x.shape[-1] // 2
        return x[..., :half], x[..., half:]


class FullyConnectedLayer(nn.Module):
    """Equalised-lr linear: weight stored randn/lr_mul, runtime gain
    lr_mul/sqrt(fan_in) (JAX _init_fc/_apply_fc)."""

    def __init__(self, in_features: int, out_features: int, lr_multiplier: float = 1.0,
                 weight_gain_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.lr_multiplier = lr_multiplier
        self.weight_gain = lr_multiplier / math.sqrt(in_features) * weight_gain_scale
        self.bias_gain = lr_multiplier

    def reset_parameters(self, generator: torch.Generator):
        normal_(self.weight, 1.0 / self.lr_multiplier, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x, activation="linear", compute_dtype=torch.float32):
        w = self.weight * self.weight_gain
        y = mm(x, w.t(), compute_dtype)
        return bias_act(y, (self.bias * self.bias_gain).float(), act=activation)


class TwoPartMappingNetwork(nn.Module):
    """StyleGAN2-style two-branch mapping (JAX :174/:213)."""

    def __init__(self, z_dim: int, w_dim: int, implicit_dim: int = 1, num_ws: int = 1,
                 trunk_layers: int = 7, branch_layers: int = 1, lr_multiplier: float = 0.01,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_ws = num_ws
        self.trunk_layers = trunk_layers
        self.branch_layers = branch_layers
        dims = [z_dim] + [w_dim] * trunk_layers
        for i in range(trunk_layers):
            setattr(self, f"trunk{i}", FullyConnectedLayer(dims[i], dims[i + 1], lr_multiplier))
        idims = [w_dim] * branch_layers + [implicit_dim]
        for i in range(branch_layers):
            # the last implicit layer carries an extra 0.2 weight gain
            scale = 0.2 if i == branch_layers - 1 else 1.0
            setattr(self, f"implicit{i}",
                    FullyConnectedLayer(idims[i], idims[i + 1], lr_multiplier, scale))
            setattr(self, f"superres{i}", FullyConnectedLayer(w_dim, w_dim, lr_multiplier))
        if generator is not None:
            self.reset_parameters(generator)

    def _layers(self, name, n):
        return [getattr(self, f"{name}{i}") for i in range(n)]

    def reset_parameters(self, generator: torch.Generator):
        for name, n in (("trunk", self.trunk_layers), ("implicit", self.branch_layers),
                        ("superres", self.branch_layers)):
            for layer in self._layers(name, n):
                layer.reset_parameters(generator)

    def forward(self, z: torch.Tensor, compute_dtype=torch.float32):
        """Returns (implicit (B, implicit_dim), synthesis styles (B, num_ws, w_dim))."""
        x = normalize_2nd_moment(z.float())
        for layer in self._layers("trunk", self.trunk_layers):
            x = layer(x, "lrelu", compute_dtype)
        xi = x
        for i, layer in enumerate(self._layers("implicit", self.branch_layers)):
            act = "linear" if i == self.branch_layers - 1 else "lrelu"
            xi = layer(xi, act, compute_dtype)
        xs = x
        for layer in self._layers("superres", self.branch_layers):
            xs = layer(xs, "lrelu", compute_dtype)
        xs = xs[:, None, :].expand(xs.shape[0], self.num_ws, xs.shape[-1])
        return xi, xs
