"""OASIS-style U-Net segmentation discriminator
(threedhumangan_tpu/models/discriminator.py).

ResBlocks of spectral-norm 3x3 convs (nearest 2x upsampling in the
decoder, 2x average pooling in the encoder, a learned 1x1 shortcut when the
channel count changes); channels [in, 128, 128, 256, 256, 512, ...],
``num_blocks = min(6, log2(max(H, W)) - 1)``, skip concatenations, and three
heads: a per-pixel real/fake logit, a per-pixel ``label_dim`` segmentation,
and a global latent regressed from the bottleneck by a full-size conv.

Images are NHWC at the API, as in the JAX package; inside the convolutions
run NCHW (cuDNN on the card: the JAX package has no kernel here).  A conv
rounds its operands to the compute dtype and stores its output there.
Spectral-norm ``u`` vectors are buffers, updated in place when ``train``.
Keys: ``down.{i}.conv1.weight_orig`` (OIHW) / ``.bias`` / ``.weight_u``,
``up.{i}...``, ``layer_up_last``, ``output_layer``, ``latent_layer``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from threedhumangan_tpu_torch.models.synthesis import spectral_normalize
from threedhumangan_tpu_torch.utils.misc import lrelu, normal_, resolve_device, uniform_

CHANNELS = [128, 128, 256, 256, 512, 512, 512, 512]


class Conv(nn.Module):
    """kh x kw conv, weight (out, in, kh, kw); ``sn`` adds spectral norm."""

    def __init__(self, cin: int, cout: int, k, sn: bool = False):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.sn = sn
        name = "weight_orig" if sn else "weight"
        setattr(self, name, nn.Parameter(torch.zeros(cout, cin, kh, kw)))
        self.bias = nn.Parameter(torch.zeros(cout))
        if sn:
            self.register_buffer("weight_u", torch.ones(cout) / math.sqrt(cout))

    def reset_parameters(self, generator: torch.Generator, weight_scale: float = 1.0):
        """kaiming-normal (leaky 0.2, fan_in) weight, torch-default bias."""
        w = self.weight_orig if self.sn else self.weight
        fan_in = w[0].numel()
        normal_(w, math.sqrt(2.0 / 1.04) / math.sqrt(fan_in), generator)
        with torch.no_grad():
            w.mul_(weight_scale)
        uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)
        if self.sn:
            with torch.no_grad():
                u = torch.randn(self.weight_u.shape, generator=generator)
                self.weight_u.copy_(u / (torch.linalg.norm(u) + 1e-12))

    def forward(self, x, compute_dtype=torch.float32, train: bool = False, padding="same"):
        """x NCHW -> NCHW in the compute dtype."""
        if self.sn:
            w = self.weight_orig
            cout = w.shape[0]
            w2d = spectral_normalize(w.reshape(cout, -1).t().float(), self.weight_u, train)
            w = w2d.t().reshape(w.shape)
        else:
            w = self.weight
        y = F.conv2d(x.to(compute_dtype), w.to(compute_dtype), padding=padding)
        return y + self.bias.to(y.dtype)[:, None, None]


def _upsample2x(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


def _avgpool2(x):
    return F.avg_pool2d(x, 2)


class ResBlock(nn.Module):
    def __init__(self, fin: int, fout: int, up_or_down: int, first: bool = False):
        super().__init__()
        self.up_or_down, self.first = up_or_down, first
        self.conv1 = Conv(fin, fout, 3, sn=True)
        self.conv2 = Conv(fout, fout, 3, sn=True)
        self.learned_shortcut = fin != fout
        if self.learned_shortcut:
            self.conv_s = Conv(fin, fout, 1, sn=True)

    def reset_parameters(self, generator):
        for m in (self.conv1, self.conv2) + ((self.conv_s,) if self.learned_shortcut else ()):
            m.reset_parameters(generator)

    def forward(self, x, compute_dtype=torch.float32, train: bool = False):
        xs = x
        if self.first:
            if self.up_or_down < 0:
                xs = _avgpool2(xs)
            if self.learned_shortcut:
                xs = self.conv_s(xs, compute_dtype, train)
        else:
            if self.up_or_down > 0:
                xs = _upsample2x(xs)
            if self.learned_shortcut:
                xs = self.conv_s(xs, compute_dtype, train)
            if self.up_or_down < 0:
                xs = _avgpool2(xs)
        dx = x
        if not self.first:
            dx = lrelu(dx)
            if self.up_or_down > 0:
                dx = _upsample2x(dx)
        dx = lrelu(self.conv1(dx, compute_dtype, train))
        dx = self.conv2(dx, compute_dtype, train)
        if self.up_or_down < 0:
            dx = _avgpool2(dx)
        return xs + dx


def num_discriminator_blocks(meta: Dict) -> int:
    return min(meta.get("discriminator_blocks", 6),
               int(math.log2(max(meta["gen_height"], meta["gen_width"]))) - 1)


class UNetDiscriminator(nn.Module):
    def __init__(self, meta: Dict, generator: torch.Generator | None = None):
        super().__init__()
        self.semantic_dim = meta.get("semantic_dim", 0)
        label_dim = meta.get("label_dim", 0)
        latent_dim = meta["latent_dim"]
        nb = num_discriminator_blocks(meta)
        ch = [6 if meta.get("dual_discrimination", False) else 3] + CHANNELS
        self.down = nn.ModuleList([ResBlock(ch[i], ch[i + 1], -1, first=i == 0)
                                   for i in range(nb)])
        ups = [ResBlock(ch[nb], ch[nb - 1], 1)]
        ups += [ResBlock(2 * ch[nb - i], ch[nb - i - 1], 1) for i in range(1, nb - 1)]
        ups.append(ResBlock(2 * ch[1], 64, 1))
        self.up = nn.ModuleList(ups)
        self.layer_up_last = Conv(64, 1, 1)
        self.output_layer = Conv(64, self.semantic_dim + label_dim, 1)
        down = 2 ** nb
        self.latent_layer = Conv(ch[nb], latent_dim,
                                 (meta["gen_height"] // down, meta["gen_width"] // down))
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        for blk in list(self.down) + list(self.up):
            blk.reset_parameters(generator)
        self.layer_up_last.reset_parameters(generator)
        self.output_layer.reset_parameters(generator, weight_scale=0.25)
        self.latent_layer.reset_parameters(generator)

    def forward(self, images, compute_dtype=torch.float32, train: bool = False) -> Dict:
        """images NHWC in [-1, 1] -> {'prediction' (B, H, W, 1), 'segments'
        (B, H, W, label_dim), 'latents' (B, latent_dim)[, 'semantics']}."""
        x = images.permute(0, 3, 1, 2)
        enc = []
        for blk in self.down:
            x = blk(x, compute_dtype, train)
            enc.append(x)
        B = x.shape[0]
        latent_dim = self.latent_layer.weight.shape[0]
        if min(x.shape[2], x.shape[3]) > 1:
            latents = self.latent_layer(x, compute_dtype, padding="valid").reshape(B, latent_dim)
        else:
            latents = x.new_zeros(B, latent_dim)
        x = self.up[0](x, compute_dtype, train)
        for i in range(1, len(self.up)):
            x = self.up[i](torch.cat([enc[-i - 1], x], 1), compute_dtype, train)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        heads = nhwc(self.output_layer(x, compute_dtype))
        out = {"prediction": nhwc(self.layer_up_last(x, compute_dtype)), "latents": latents,
               "segments": heads[..., self.semantic_dim:]}
        if self.semantic_dim > 0:
            out["semantics"] = heads[..., :self.semantic_dim]
        return out


def init_discriminator(meta: Dict, generator: torch.Generator,
                       device="cuda") -> UNetDiscriminator:
    return UNetDiscriminator(meta, generator).to(resolve_device(device))
