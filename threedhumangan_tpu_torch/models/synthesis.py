"""2D synthesis stack, eval path (threedhumangan_tpu/models/synthesis.py).

SPADE blocks with batch-norm running stats and spectral norm with a frozen
``u``, the Fourier-feature input head, the condition-image style head and
ToRGB.  NHWC throughout; a 1x1 conv is a matmul over flattened pixels whose
result is stored in the compute dtype, as in the JAX package.

Keys follow the reference torch modules: ``network.m3d_{i}.conv_0.weight_orig``
/ ``.weight_u`` (spectral norm), ``spade_{s}.first_norm.*`` (SyncBatchNorm),
``spade_{s}.mlp_shared.0``, ``to_rgbs.m3d_{i}.linear``; conv weights are
(out, in, 1, 1).  Training mode (batch moments, u updates) is not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from threedhumangan_tpu_torch.utils.misc import lrelu, mm, normal_, uniform_

SPADE_HIDDEN = 128


class Conv1x1(nn.Module):
    """1x1 conv on NHWC tensors; weight (out, in, 1, 1)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    @property
    def w(self) -> torch.Tensor:
        """(in, out) matrix."""
        return self.weight[:, :, 0, 0].t()

    def reset_parameters(self, generator, w_bound=None, w_std=None, weight_scale=1.0):
        """torch Conv2d default init (uniform ±sqrt(1/fan_in)), or a given
        uniform bound / normal std for the weight; bias uniform ±1/sqrt(fan_in)."""
        fan_in = self.weight.shape[1]
        if w_std is not None:
            normal_(self.weight, w_std, generator)
        else:
            uniform_(self.weight, w_bound or math.sqrt(1.0 / fan_in), generator)
        with torch.no_grad():
            self.weight.mul_(weight_scale)
        uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        return (mm(x, self.w, compute_dtype) + self.bias.float()).to(compute_dtype)


class SNConv1x1(nn.Module):
    """Spectral-normalised 1x1 conv (eval: power-iteration vector frozen)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight_orig = nn.Parameter(torch.zeros(out_dim, in_dim, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.register_buffer("weight_u", torch.ones(out_dim) / math.sqrt(out_dim))

    def reset_parameters(self, generator):
        fan_in = self.weight_orig.shape[1]
        uniform_(self.weight_orig, math.sqrt(1.0 / fan_in), generator)
        uniform_(self.bias, math.sqrt(1.0 / fan_in), generator)
        with torch.no_grad():
            u = torch.randn(self.weight_u.shape, generator=generator)
            self.weight_u.copy_(u / (torch.linalg.norm(u) + 1e-12))

    def normalized_weight(self, eps: float = 1e-12) -> torch.Tensor:
        """(in, out) weight divided by sigma = v.(W u), v = W u / |W u|."""
        w = self.weight_orig[:, :, 0, 0].t().float()
        wu = w @ self.weight_u.float()
        v = wu / (torch.linalg.norm(wu) + eps)
        return w / torch.dot(v, wu)

    def forward(self, x, compute_dtype=torch.float32):
        y = mm(x, self.normalized_weight(), compute_dtype) + self.bias.float()
        return y.to(compute_dtype)


def norm_affine(norm: nn.BatchNorm2d, normalization: str, eps: float = 1e-5):
    """Eval-mode norm as per-channel (a, b): y = x*a + b."""
    r = torch.rsqrt(norm.running_var.float() + eps)
    if normalization == "batch_norm":
        a = norm.weight.float() * r
        return a, norm.bias.float() - norm.running_mean.float() * a
    if normalization == "adaptive_batch_norm":
        return r, -norm.running_mean.float() * r
    raise ValueError(f"unsupported normalization {normalization!r}")


class SPADE2d(nn.Module):
    def __init__(self, input_dim: int, feature_dim: int, normalization: str = "batch_norm"):
        super().__init__()
        self.normalization = normalization
        if normalization not in ("batch_norm", "adaptive_batch_norm"):
            raise NotImplementedError(f"eval SPADE with {normalization!r}")
        self.first_norm = nn.BatchNorm2d(input_dim, affine=normalization == "batch_norm")
        self.mlp_shared = nn.Sequential(Conv1x1(feature_dim, SPADE_HIDDEN), nn.ReLU())
        self.mlp_gamma = Conv1x1(SPADE_HIDDEN, input_dim)
        self.mlp_beta = Conv1x1(SPADE_HIDDEN, input_dim)

    def reset_parameters(self, generator):
        for conv in (self.mlp_shared[0], self.mlp_gamma, self.mlp_beta):
            conv.reset_parameters(generator)

    def forward(self, x, feature_maps, compute_dtype=torch.float32):
        """x, feature_maps: NHWC (feature_maps may be (B, 1, 1, C))."""
        norm = self.first_norm
        x32 = x.float()
        y = (x32 - norm.running_mean.float()) * torch.rsqrt(norm.running_var.float() + 1e-5)
        if self.normalization == "batch_norm":
            y = y * norm.weight.float() + norm.bias.float()
        normalized = y.to(x.dtype)
        actv = torch.relu(self.mlp_shared[0](feature_maps, compute_dtype))
        gamma = 1.0 + self.mlp_gamma(actv, compute_dtype)
        beta = self.mlp_beta(actv, compute_dtype)
        return normalized * gamma + beta


class SPADEBlock(nn.Module):
    def __init__(self, in_dim, out_dim, style_dim, normalization="batch_norm"):
        super().__init__()
        self.conv_0 = SNConv1x1(in_dim, out_dim)
        self.conv_1 = SNConv1x1(out_dim, out_dim)
        self.spade_0 = SPADE2d(in_dim, style_dim, normalization)
        self.spade_1 = SPADE2d(out_dim, style_dim, normalization)

    def reset_parameters(self, generator):
        for m in (self.conv_0, self.conv_1, self.spade_0, self.spade_1):
            m.reset_parameters(generator)

    def forward(self, x, style, skip=False, compute_dtype=torch.float32):
        if style.ndim == 3:  # (B, 1, C) global style: rank-1 over pixels
            style = style[:, :, None, :]
        x_orig = x
        x = self.conv_0(lrelu(self.spade_0(x, style, compute_dtype)), compute_dtype)
        x = self.conv_1(lrelu(self.spade_1(x, style, compute_dtype)), compute_dtype)
        if skip and x.shape[-1] == x_orig.shape[-1]:
            x = x + x_orig
        return x


class ToRGB(nn.Module):
    def __init__(self, in_dim, dim_rgb=3):
        super().__init__()
        self.linear = Conv1x1(in_dim, dim_rgb)

    def reset_parameters(self, generator):
        self.linear.reset_parameters(generator, weight_scale=0.25)

    def forward(self, x, rgb=None, compute_dtype=torch.float32):
        out = self.linear(x, compute_dtype)
        return out if rgb is None else out + rgb


class SynthesisNetwork(nn.Module):
    def __init__(self, input_dim, style_dim, hidden_dim=256, num_blocks=8,
                 mod_blocks=tuple(range(8)), spatial_normalization="batch_norm",
                 map3d_mode="isolated"):
        super().__init__()
        self.num_blocks = num_blocks
        self.mod_blocks = tuple(mod_blocks)
        self.spatial_normalization = spatial_normalization
        self.map3d_mode = map3d_mode
        self.network = nn.ModuleDict()
        self.to_rgbs = nn.ModuleDict()
        in_dim = input_dim
        for i in range(num_blocks):
            self.network[f"m3d_{i}"] = SPADEBlock(in_dim, hidden_dim, style_dim,
                                                  spatial_normalization)
            self.to_rgbs[f"m3d_{i}"] = ToRGB(hidden_dim)
            in_dim = hidden_dim

    def reset_parameters(self, generator):
        for i in range(self.num_blocks):
            self.network[f"m3d_{i}"].reset_parameters(generator)
            self.to_rgbs[f"m3d_{i}"].reset_parameters(generator)

    def block_style(self, idx, style, fixed_style):
        """Style input of block ``idx`` under the map3d mode: the spatial map
        (plus the fixed row in 'mixed'/'all'), or the (B, 1, C) fixed row."""
        fs = fixed_style[:, 0]
        if self.map3d_mode == "all":
            return style + fs[:, None, None, :]
        if self.map3d_mode == "mixed":
            if idx not in self.mod_blocks:
                return fs[:, None, :]
            return style + fs[:, None, None, :]
        if self.map3d_mode == "isolated":
            return style if idx in self.mod_blocks else fixed_style
        raise ValueError(f"invalid map3d_mode {self.map3d_mode!r}")

    def forward(self, x, style, fixed_style, compute_dtype=torch.float32):
        """Eval forward (JAX apply_synthesis_network(train=False)).
        x: NHWC input features; style: NHWC spatial style; fixed_style
        (B, 1, C).  Returns the NHWC rgb."""
        rgb = None
        for idx in range(self.num_blocks):
            skip = idx >= self.num_blocks // 2
            x = self.network[f"m3d_{idx}"](x, self.block_style(idx, style, fixed_style),
                                           skip, compute_dtype)
            if idx >= self.num_blocks // 2 - 1:
                rgb = self.to_rgbs[f"m3d_{idx}"](x, rgb, compute_dtype)
        return rgb


def get_2d_coords(batch_size, height, width, dtype=torch.float32, device=None):
    """(B, H, W, 2) grid: row coord then column coord, both in [-1, 1]."""
    i = torch.linspace(-1.0, 1.0, height, dtype=dtype, device=device)
    j = torch.linspace(-1.0, 1.0, width, dtype=dtype, device=device)
    gi, gj = torch.meshgrid(i, j, indexing="ij")
    return torch.stack([gi, gj], -1)[None].expand(batch_size, height, width, 2)


class SynthesisInput(nn.Module):
    """Fourier-feature input head: sin(conv1x1(coords))."""

    def __init__(self, input_dim, output_dim):
        super().__init__()
        self.network = nn.Sequential(Conv1x1(input_dim, output_dim))

    def reset_parameters(self, generator):
        fan_in = self.network[0].weight.shape[1]
        self.network[0].reset_parameters(generator, w_bound=math.sqrt(9.0 / fan_in))

    def forward(self, coords, compute_dtype=torch.float32):
        return torch.sin(self.network[0](coords, compute_dtype))


class SynthesisStyleInput(nn.Module):
    """Condition-image style head.  Generation with a render never runs it
    (``disable_render`` is not ported); it holds its parameters so the
    generator keeps the reference key space."""

    def __init__(self, input_dim, latent_dim, output_dim, num_layers=3):
        super().__init__()
        self.from_coords = nn.Sequential(Conv1x1(input_dim, latent_dim))
        layers = [Conv1x1(latent_dim * 2, output_dim)]
        for _ in range(1, num_layers - 1):
            layers += [nn.LeakyReLU(0.2), Conv1x1(output_dim, output_dim)]
        self.network = nn.Sequential(*layers)

    def _convs(self):
        return [m for m in self.network if isinstance(m, Conv1x1)]

    def reset_parameters(self, generator):
        fan_in = self.from_coords[0].weight.shape[1]
        self.from_coords[0].reset_parameters(generator, w_bound=math.sqrt(9.0 / fan_in))
        for conv in self._convs():
            std = math.sqrt(2.0 / 1.04) / math.sqrt(conv.weight.shape[1])
            conv.reset_parameters(generator, w_std=std)
