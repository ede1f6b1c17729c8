"""2D synthesis stack (threedhumangan_tpu/models/synthesis.py).

SPADE blocks with spectral-norm 1x1 convs under batch norm, adaptive batch
norm, instance norm or no norm; the pixelwise blocks of
``spatial_normalization='none'`` (two demodulated style-modulated products a
block); the Fourier-feature input head, the condition-image style head and
ToRGB.  NHWC throughout (the pixelwise blocks run on the flat (B, H*W, C)
map); a 1x1 conv is a matmul over flattened pixels whose result is stored
in the compute dtype, as in the JAX package.

Eval mode normalises by the running stats (batch norm, adaptive batch
norm), per image (instance norm) or not at all, with a frozen ``u``.  Train
mode (``train=True``) updates the state in place under no-grad: one power
iteration of each ``u`` and the running stats.  Batch norm normalises by
the batch moments, which gradients flow through, and updates its stats at
momentum 0.1 with the unbiased variance; adaptive batch norm takes the
unbiased batch moments under no-grad, moves its stats by
``old + (m - old) * 0.05`` and normalises by the updated stats, so no
gradient flows through the moments; instance norm's per-image moments carry
gradient and it keeps no state.  Under a process group the batch moments
are those of the global batch, reduced across ranks (``batch_moments``;
adaptive batch norm takes the mean over ranks of each rank's moments, as
the JAX package), so every rank's running stats and ``u`` stay equal.
Batch norm runs per op (the JAX package's ``pallas_synthesis_train=False``
path) or, with ``fused=True``, on the fused half-blocks of
``ops/synthesis_train.py`` (K10/K11; the JAX fused path, batch norm only).

``remat=True`` (the JAX ``jax.checkpoint`` around each block) runs each
train-mode block under ``torch.utils.checkpoint`` (non-reentrant; a SPADE
block with its ToRGB): the backward keeps the block's input and recomputes
the rest.  A block's state advances outside the recomputed part, once a
step: both ``u`` are stepped and both convs' normalised weights formed
before the block runs and passed in, adaptive batch norm's running stats
before the step are passed in too, and the running stats take the values
the block returns.  The recompute therefore sees the same weights and
stats and updates nothing.  Under a process group the recompute runs the
moments' all-reduces again, in the same order on every rank and on the
same inputs, so it gets the forward's moments bit for bit.

Keys follow the reference torch modules: ``network.m3d_{i}.conv_0.weight_orig``
/ ``.weight_u`` (spectral norm), ``spade_{s}.first_norm.*`` (SyncBatchNorm;
none under instance norm or no norm), ``spade_{s}.mlp_shared.0``,
``to_rgbs.m3d_{i}.linear``; conv weights are (out, in, 1, 1).  No released
checkpoint holds a pixelwise block: its keys follow the JAX tree,
``network.m3d_{i}.mod1.weight`` ((in, out), as JAX's), ``mod1.bias``,
``mod1.affine.weight`` / ``.bias`` (a 1x1 conv), and ``mod2.*``.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from threedhumangan_tpu_torch.parallel import dist
from threedhumangan_tpu_torch.utils.misc import (lrelu, mm, normal_, normalize_2nd_moment,
                                                 uniform_)

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


def spectral_normalize(w2d: torch.Tensor, u: torch.Tensor, train: bool,
                       eps: float = 1e-12) -> torch.Tensor:
    """w2d (in, out) divided by its spectral-norm estimate (torch semantics,
    JAX ``spectral_normalize``): when training, one power iteration updates
    the buffer ``u`` (out,) in place under no-grad first; then
    sigma = v . (w2d u) with v = W u / |W u| from the detached weight, so
    the gradient flows through ``w2d @ u`` only."""
    w = w2d.detach()
    if train:
        with torch.no_grad():
            v = w @ u.float()
            v = v / (torch.linalg.norm(v) + eps)
            u_new = w.t() @ v
            u.copy_(u_new / (torch.linalg.norm(u_new) + eps))
    u = u.float().clone()  # the buffer changes in place at the next update
    wu = w2d @ u
    v = w @ u
    v = v / (torch.linalg.norm(v) + eps)
    return w2d / torch.dot(v, wu)


class SNConv1x1(nn.Module):
    """Spectral-normalised 1x1 conv."""

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

    def normalized_weight(self, train: bool = False) -> torch.Tensor:
        """(in, out) weight divided by sigma = v.(W u), v = W u / |W u|."""
        return spectral_normalize(self.weight_orig[:, :, 0, 0].t().float(), self.weight_u, train)

    def forward(self, x, compute_dtype=torch.float32):
        """Eval mode (frozen ``u``)."""
        return self.apply_weight(x, self.normalized_weight(), compute_dtype)

    def apply_weight(self, x, w, compute_dtype=torch.float32):
        """The conv with a given normalised (in, out) weight."""
        return (mm(x, w, compute_dtype) + self.bias.float()).to(compute_dtype)


def norm_affine(norm: nn.BatchNorm2d, normalization: str, eps: float = 1e-5):
    """Eval-mode norm as per-channel (a, b): y = x*a + b."""
    r = torch.rsqrt(norm.running_var.float() + eps)
    if normalization == "batch_norm":
        a = norm.weight.float() * r
        return a, norm.bias.float() - norm.running_mean.float() * a
    if normalization == "adaptive_batch_norm":
        return r, -norm.running_mean.float() * r
    raise ValueError(f"unsupported normalization {normalization!r}")


@torch.no_grad()
def _update_running_stats(norm: nn.BatchNorm2d, mean, var, n: int, momentum: float):
    norm.running_mean.mul_(1 - momentum).add_(momentum * mean)
    norm.running_var.mul_(1 - momentum).add_(momentum * var * n / max(n - 1, 1))
    norm.num_batches_tracked.add_(1)


def batch_moments(x: torch.Tensor):
    """Train-mode sync-BN moments of NHWC ``x`` in float32, differentiable,
    in the JAX package's two passes (``sync_bn_moments``): the mean of the
    local means over ranks, then the mean over ranks of the local mean of
    ``(x - mean)^2``.  Both reductions cross ranks through
    ``parallel.dist.mean_across_ranks`` (none without a process group)."""
    x32 = x.float()
    mean = dist.mean_across_ranks(x32.mean((0, 1, 2)))
    var = dist.mean_across_ranks(torch.square(x32 - mean).mean((0, 1, 2)))
    return mean, var


@torch.no_grad()
def adaptive_stats(x: torch.Tensor, old_mean, old_var, momentum: float = 0.05):
    """Adaptive batch norm's running stats after one train step (JAX
    ``apply_adaptive_batch_norm``): this rank's mean and unbiased variance
    of NHWC ``x`` under no-grad, each then averaged over ranks, and the
    stats moved by ``old + (m - old) * momentum``."""
    xs = x.detach().float()
    mean = xs.mean((0, 1, 2))
    n = xs.shape[0] * xs.shape[1] * xs.shape[2]
    var = torch.square(xs - mean).sum((0, 1, 2)) / max(n - 1, 1)
    mean, var = dist.mean_across_ranks(mean), dist.mean_across_ranks(var)
    return old_mean + (mean - old_mean) * momentum, old_var + (var - old_var) * momentum


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``nn.InstanceNorm2d`` without affine or running stats on NHWC ``x``:
    per-image, per-channel moments in float32, differentiable."""
    x32 = x.float()
    mean = x32.mean((1, 2), keepdim=True)
    var = torch.square(x32 - mean).mean((1, 2), keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


NORMALIZATIONS = ("batch_norm", "adaptive_batch_norm", "instance_norm", "none")


class SPADE2d(nn.Module):
    def __init__(self, input_dim: int, feature_dim: int, normalization: str = "batch_norm"):
        super().__init__()
        if normalization not in NORMALIZATIONS:
            raise ValueError(f"SPADE with {normalization!r}")
        self.normalization = normalization
        if normalization in ("batch_norm", "adaptive_batch_norm"):
            self.first_norm = nn.BatchNorm2d(input_dim, affine=normalization == "batch_norm")
        self.mlp_shared = nn.Sequential(Conv1x1(feature_dim, SPADE_HIDDEN), nn.ReLU())
        self.mlp_gamma = Conv1x1(SPADE_HIDDEN, input_dim)
        self.mlp_beta = Conv1x1(SPADE_HIDDEN, input_dim)

    def reset_parameters(self, generator):
        for conv in (self.mlp_shared[0], self.mlp_gamma, self.mlp_beta):
            conv.reset_parameters(generator)

    def mlp_weights(self):
        """The SPADE MLP as (in, out) matrices and biases (ops/synthesis_train.MLP_NAMES)."""
        convs = (self.mlp_shared[0], self.mlp_gamma, self.mlp_beta)
        out = {}
        for stem, conv in zip(("sh", "g", "bt"), convs):
            out[f"{stem}_w"], out[f"{stem}_b"] = conv.w, conv.bias
        return out

    def forward(self, x, feature_maps, compute_dtype=torch.float32):
        """Eval mode.  x, feature_maps: NHWC (feature_maps may be (B, 1, 1, C))."""
        if self.normalization in ("batch_norm", "adaptive_batch_norm"):
            norm = self.first_norm
            normalized = self.by_moments(x, norm.running_mean.float(), norm.running_var.float())
        else:
            normalized = self.unit_normalize(x)
        return self.modulate(normalized, feature_maps, compute_dtype)

    def by_moments(self, x, mean, var):
        """x normalised by the given moments (and batch norm's affine), in
        float32, stored in x's dtype."""
        y = (x.float() - mean) * torch.rsqrt(var + 1e-5)
        if self.normalization == "batch_norm":
            y = y * self.first_norm.weight.float() + self.first_norm.bias.float()
        return y.to(x.dtype)

    def unit_normalize(self, x):
        """The stateless normalisations: per image (instance norm) or none."""
        return instance_norm(x) if self.normalization == "instance_norm" else x

    def train_stats(self):
        """The state a train step starts from, passed into the (recomputed)
        block: adaptive batch norm's running stats, cloned; else None."""
        if self.normalization != "adaptive_batch_norm":
            return None
        return self.first_norm.running_mean.clone(), self.first_norm.running_var.clone()

    def train_normalize(self, x, stats):
        """Train-mode normalisation: returns (normalised x, what the state
        takes: the batch moments under batch norm, the updated running stats
        under adaptive batch norm, else None)."""
        if self.normalization == "batch_norm":
            mean, var = batch_moments(x)
            return self.by_moments(x, mean, var), (mean, var)
        if self.normalization == "adaptive_batch_norm":
            mean, var = adaptive_stats(x, *stats)
            return self.by_moments(x, mean, var), (mean, var)
        return self.unit_normalize(x), None

    def modulate(self, normalized, feature_maps, compute_dtype=torch.float32):
        """The SPADE modulation of a normalised map; under no norm gamma is
        normalised to unit second moment and there is no beta."""
        actv = torch.relu(self.mlp_shared[0](feature_maps, compute_dtype))
        gamma = 1.0 + self.mlp_gamma(actv, compute_dtype)
        if self.normalization == "none":
            return normalized * normalize_2nd_moment(gamma, -1)
        return normalized * gamma + self.mlp_beta(actv, compute_dtype)


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
        """Eval mode (train mode: ``train_body``)."""
        if style.ndim == 3:  # (B, 1, C) global style: rank-1 over pixels
            style = style[:, :, None, :]
        x_orig = x
        x = self.conv_0(lrelu(self.spade_0(x, style, compute_dtype)), compute_dtype)
        x = self.conv_1(lrelu(self.spade_1(x, style, compute_dtype)), compute_dtype)
        if skip and x.shape[-1] == x_orig.shape[-1]:
            x = x + x_orig
        return x

    def forward_fused(self, x, style, fixed_row=None, skip=False, compute_dtype=torch.bfloat16):
        """Train-mode block on the fused half-blocks (JAX ``apply_spade_block_fused``):
        moments, running stats and the spectral-norm ``u`` update stay here in
        torch, the normalise/modulate/lrelu/conv chain runs in
        ``ops.synthesis_train`` (K10 forward, K11 backward on CUDA).
        ``style``: (B, H, W, Cs) map, or a (B, 1, Cs) row (the SPADE MLP then
        runs pre-broadcast and the half-blocks take per-image gamma/beta);
        ``fixed_row``: optional (B, Cs) row added to a spatial style in-kernel."""
        h, moments = self.train_body(x, style, fixed_row, *self.train_weights(), skip,
                                     compute_dtype, fused=True)
        self.update_running_stats(moments, x)
        return h

    def train_weights(self):
        """Both convs' normalised weights, each ``u`` stepped once (train mode),
        and the norms' state before the step (``SPADE2d.train_stats``)."""
        return (self.conv_0.normalized_weight(train=True),
                self.conv_1.normalized_weight(train=True),
                self.spade_0.train_stats(), self.spade_1.train_stats())

    def update_running_stats(self, moments, x):
        """The running stats from what ``train_body`` returned for input
        ``x``: batch norm's from the batch moments, its variance unbiased by
        the global count (this rank's pixels times the world size);
        adaptive batch norm's are the returned stats."""
        n = x.shape[0] * x.shape[1] * x.shape[2] * dist.world_size()
        for spade, m in zip((self.spade_0, self.spade_1), moments):
            if spade.normalization == "batch_norm":
                _update_running_stats(spade.first_norm, m[0].detach(), m[1].detach(), n, 0.1)
            elif spade.normalization == "adaptive_batch_norm":
                with torch.no_grad():
                    spade.first_norm.running_mean.copy_(m[0])
                    spade.first_norm.running_var.copy_(m[1])
                    spade.first_norm.num_batches_tracked.add_(1)

    def train_body(self, x, style, fixed_row, w0, w1, stats0=None, stats1=None, skip=False,
                   compute_dtype=torch.float32, fused=False):
        """The train-mode block without its state updates: returns (output,
        what each half-block's norm hands the state, ``SPADE2d.train_normalize``).
        ``stats0``/``stats1``: adaptive batch norm's stats before the step."""
        if fused:
            from threedhumangan_tpu_torch.ops.synthesis_train import (
                spade_half_block_rank1,
                spade_half_block_spatial,
            )
        elif style.ndim == 3:  # (B, 1, C) global style: rank-1 over pixels
            style = style[:, :, None, :]
        cd = compute_dtype
        B = x.shape[0]
        h = x.to(cd) if fused else x
        moments = []
        for spade, conv, w, st in ((self.spade_0, self.conv_0, w0, stats0),
                                   (self.spade_1, self.conv_1, w1, stats1)):
            if not fused:
                normalized, m = spade.train_normalize(h, st)
                moments.append(m)
                h = conv.apply_weight(lrelu(spade.modulate(normalized, style, cd)), w, cd)
                continue
            if spade.normalization != "batch_norm":
                raise ValueError("the fused half-blocks take batch norm only")
            norm = spade.first_norm
            mean, var = batch_moments(h)
            moments.append((mean, var))
            r = torch.rsqrt(var + 1e-5)
            if style.ndim == 4:
                h = spade_half_block_spatial(h, style.to(cd), fixed_row, mean, r, norm.weight,
                                             norm.bias, spade.mlp_weights(), w, conv.bias, cd)
            else:
                srow = style.reshape(B, 1, -1)
                actv = torch.relu(spade.mlp_shared[0](srow, cd))
                gam = 1.0 + spade.mlp_gamma(actv, cd)
                bet = spade.mlp_beta(actv, cd)
                h = spade_half_block_rank1(h, gam.reshape(B, -1), bet.reshape(B, -1), mean, r,
                                           norm.weight, norm.bias, w, conv.bias, cd)
        if skip and h.shape[-1] == x.shape[-1]:
            h = h + x
        return h, moments


class SpatialStyleModLayer(nn.Module):
    """Per-pixel style-modulated product with demodulation (JAX
    ``apply_spatial_style_mod``), as two products: ((x * mod) @ W) *
    rsqrt((mod^2) @ W^2 + eps) + bias, with mod = affine(style) + 1.
    ``weight`` (in, out) as JAX's; the output is float32."""

    def __init__(self, in_dim: int, out_dim: int, style_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.affine = Conv1x1(style_dim, in_dim)

    def reset_parameters(self, generator):
        """JAX init: weight normal * sqrt(2 / 1.04) / sqrt(in), bias zero,
        the affine kaiming-normal (linear gain) with the default bias."""
        normal_(self.weight, math.sqrt(2.0 / (1 + 0.2 ** 2)) / math.sqrt(self.weight.shape[0]),
                generator)
        with torch.no_grad():
            self.bias.zero_()
        self.affine.reset_parameters(generator, w_std=1.0 / math.sqrt(self.affine.weight.shape[1]))

    def forward(self, x, style, compute_dtype=torch.float32):
        """x (B, N, in); style (B, N, style_dim) or (B, 1, style_dim)."""
        mod = self.affine(style, compute_dtype) + 1.0
        w = self.weight.to(compute_dtype)
        y = mm(x * mod, w, compute_dtype)
        y = y * torch.rsqrt(mm(torch.square(mod), torch.square(w), compute_dtype) + 1e-8)
        return y + self.bias.float()


class SynthesisBlock(nn.Module):
    """Pixelwise block (JAX ``apply_synthesis_block``) on (B, N, C) maps."""

    def __init__(self, in_dim, out_dim, style_dim):
        super().__init__()
        self.mod1 = SpatialStyleModLayer(in_dim, out_dim, style_dim)
        self.mod2 = SpatialStyleModLayer(out_dim, out_dim, style_dim)

    def reset_parameters(self, generator):
        self.mod1.reset_parameters(generator)
        self.mod2.reset_parameters(generator)

    def forward(self, x, style, skip=False, compute_dtype=torch.float32):
        out = lrelu(self.mod2(lrelu(self.mod1(x, style, compute_dtype)), style, compute_dtype))
        if skip and out.shape[-1] == x.shape[-1]:
            out = out + x
        return out


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
            if spatial_normalization == "none":
                block = SynthesisBlock(in_dim, hidden_dim, style_dim)
            else:
                block = SPADEBlock(in_dim, hidden_dim, style_dim, spatial_normalization)
            self.network[f"m3d_{i}"] = block
            self.to_rgbs[f"m3d_{i}"] = ToRGB(hidden_dim)
            in_dim = hidden_dim

    @property
    def pixelwise(self) -> bool:
        return self.spatial_normalization == "none"

    def reset_parameters(self, generator):
        for i in range(self.num_blocks):
            self.network[f"m3d_{i}"].reset_parameters(generator)
            self.to_rgbs[f"m3d_{i}"].reset_parameters(generator)

    def block_style(self, idx, style, fixed_style):
        """Style input of block ``idx`` under the map3d mode: the spatial map
        (plus the fixed row in 'mixed'/'all'), or the (B, 1, C) fixed row.
        ``style`` is NHWC, or (B, N, C) for the pixelwise blocks."""
        fs = fixed_style[:, 0]
        row = fs.reshape(fs.shape[:1] + (1,) * (style.ndim - 2) + fs.shape[1:])
        if self.map3d_mode == "all":
            return style + row
        if self.map3d_mode == "mixed":
            if idx not in self.mod_blocks:
                return fs[:, None, :]
            return style + row
        if self.map3d_mode == "isolated":
            return style if idx in self.mod_blocks else fixed_style
        raise ValueError(f"invalid map3d_mode {self.map3d_mode!r}")

    def fused_block_style(self, idx, style, fixed_style):
        """(style, fixed_row) of block ``idx`` on the fused path (JAX
        apply_synthesis_network with fused_train): the spatial map with the
        fixed row added in-kernel (mixed mod blocks, 'all'), the map alone
        (isolated mod blocks), or a (B, 1, C) row for the rank-1 blocks."""
        fs = fixed_style[:, 0]
        if self.map3d_mode == "all":
            return style, fs
        if self.map3d_mode == "mixed":
            return (style, fs) if idx in self.mod_blocks else (fs[:, None, :], None)
        if self.map3d_mode == "isolated":
            return (style if idx in self.mod_blocks else fixed_style), None
        raise ValueError(f"invalid map3d_mode {self.map3d_mode!r}")

    def forward(self, x, style, fixed_style, compute_dtype=torch.float32, train: bool = False,
                fused: bool = False, remat: bool = False):
        """Forward (JAX apply_synthesis_network).  x: NHWC input features;
        style: NHWC spatial style; fixed_style (B, 1, C).  Returns the NHWC
        rgb; in train mode the state is updated in place.  ``fused`` (train
        mode, batch norm) runs each block on the fused half-blocks
        (``SPADEBlock.forward_fused``), else every op in PyTorch; ``remat``
        (train mode, with gradients) recomputes each block (a SPADE block
        with its ToRGB) in the backward (module docstring)."""
        fused = fused and train and self.spatial_normalization == "batch_norm"
        remat = remat and train and torch.is_grad_enabled()
        B, H, W, _ = x.shape
        if self.pixelwise:
            x = x.reshape(B, H * W, -1)
            style = style.reshape(B, H * W, -1)
        rgb = None
        for idx in range(self.num_blocks):
            skip = idx >= self.num_blocks // 2
            block = self.network[f"m3d_{idx}"]
            to_rgb = self.to_rgbs[f"m3d_{idx}"] if idx >= self.num_blocks // 2 - 1 else None
            if self.pixelwise or not train:
                st = self.block_style(idx, style, fixed_style)
                if remat:
                    x = checkpoint(block, x, st, skip, compute_dtype, use_reentrant=False)
                else:
                    x = block(x, st, skip, compute_dtype)
                if to_rgb is not None:
                    rgb = to_rgb(x, rgb, compute_dtype)
                continue
            if fused:
                st, fixed_row = self.fused_block_style(idx, style, fixed_style)
            else:
                st, fixed_row = self.block_style(idx, style, fixed_style), None
            step = functools.partial(_train_block_step, block, to_rgb, skip=skip,
                                     compute_dtype=compute_dtype, fused=fused)
            args = (x, rgb, st, fixed_row, *block.train_weights())
            if remat:
                out, rgb, moments = checkpoint(step, *args, use_reentrant=False)
            else:
                out, rgb, moments = step(*args)
            block.update_running_stats(moments, x)
            x = out
        return rgb.reshape(B, H, W, -1) if self.pixelwise else rgb


def _train_block_step(block, to_rgb, x, rgb, style, fixed_row, w0, w1, stats0, stats1, skip,
                      compute_dtype, fused):
    """One train-mode block and its ToRGB, without state updates: the unit
    that remat recomputes.  Returns (x, rgb, what the block's norms hand
    the state)."""
    x, moments = block.train_body(x, style, fixed_row, w0, w1, stats0, stats1, skip,
                                  compute_dtype, fused)
    if to_rgb is not None:
        rgb = to_rgb(x, rgb, compute_dtype)
    return x, rgb, moments


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
    """Condition-image style head (``disable_render``): the feature maps
    from the condition image and the latent, sin(conv1x1(condition))
    concatenated with the broadcast latent (normalised to unit second
    moment), then two 1x1 convs with leaky ReLU."""

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

    def forward(self, condition, latent, compute_dtype=torch.float32):
        """condition: NHWC condition image; latent (B, latent_dim)."""
        B, H, W, _ = condition.shape
        latent = normalize_2nd_moment(latent, -1)
        ff = torch.sin(self.from_coords[0](condition, compute_dtype))
        x = torch.cat([ff, latent[:, None, None, :].expand(B, H, W, -1).to(ff.dtype)], -1)
        for conv in self._convs():
            x = lrelu(conv(x, compute_dtype))
        return x
