"""The U-Net segmentation discriminator in plain PyTorch, from a state dict.

``ReferenceDiscriminator`` holds the model's torch key space (``down.{i}.
conv1.weight_orig`` / ``.bias`` / ``.weight_u``, ``up.{i}...``,
``layer_up_last``, ``output_layer``, ``latent_layer``): ResBlocks of
spectral-norm 3x3 convs, 2x average pooling down, nearest 2x upsampling up,
a learned 1x1 shortcut where the channel count changes, skip
concatenations, and the three heads.  In train mode every spectral-norm conv
first takes one power iteration of its ``u`` (kept here, as the model keeps
its buffer), then divides its weight by sigma = v . (W u) with v from the
detached weight, so the gradient flows through W u alone.  Images are NHWC
at the API, NCHW inside.  ``discriminator_leaves`` lists every leaf with its
init, for ``weights.make_state``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference.precision import Products

CHANNELS = [128, 128, 256, 256, 512, 512, 512, 512]


def num_blocks(meta: Dict) -> int:
    return min(meta.get("discriminator_blocks", 6),
               int(math.log2(max(meta["gen_height"], meta["gen_width"]))) - 1)


def layout(meta: Dict):
    """[(key, fin, fout, up_or_down, first)] of the ResBlocks, in order."""
    nb = num_blocks(meta)
    ch = [6 if meta.get("dual_discrimination", False) else 3] + CHANNELS
    blocks = [(f"down.{i}", ch[i], ch[i + 1], -1, i == 0) for i in range(nb)]
    blocks.append(("up.0", ch[nb], ch[nb - 1], 1, False))
    blocks += [(f"up.{i}", 2 * ch[nb - i], ch[nb - i - 1], 1, False) for i in range(1, nb - 1)]
    blocks.append((f"up.{nb - 1}", 2 * ch[1], 64, 1, False))
    return blocks


def discriminator_leaves(meta: Dict) -> List:
    """(key, shape, kind, scale) of every leaf: kaiming-normal (leaky 0.2)
    weights, uniform biases, unit ``u``; the segmentation head's weight at a
    quarter."""
    leaves = []

    def conv(key, cin, cout, kh, kw, sn, w_scale=1.0):
        fan_in = cin * kh * kw
        std = math.sqrt(2.0 / 1.04) / math.sqrt(fan_in) * w_scale
        leaves.append((key + (".weight_orig" if sn else ".weight"), (cout, cin, kh, kw),
                       "normal", std))
        leaves.append((key + ".bias", (cout,), "uniform", 1.0 / math.sqrt(fan_in)))
        if sn:
            leaves.append((key + ".weight_u", (cout,), "unit", 1.0))

    for key, fin, fout, _, _ in layout(meta):
        conv(key + ".conv1", fin, fout, 3, 3, True)
        conv(key + ".conv2", fout, fout, 3, 3, True)
        if fin != fout:
            conv(key + ".conv_s", fin, fout, 1, 1, True)
    nb = num_blocks(meta)
    ch = CHANNELS
    conv("layer_up_last", 64, 1, 1, 1, False)
    conv("output_layer", 64, meta.get("semantic_dim", 0) + meta.get("label_dim", 0), 1, 1,
         False, 0.25)
    down = 2 ** nb
    conv("latent_layer", ch[nb - 1], meta["latent_dim"], meta["gen_height"] // down,
         meta["gen_width"] // down, False)
    return leaves


def lrelu(x, alpha=0.2):
    return torch.where(x >= 0, x, alpha * x)


def sn_weight(w: torch.Tensor, u: torch.Tensor, train: bool, eps: float = 1e-12):
    """The conv weight (out, in, kh, kw) over its spectral-norm estimate;
    ``train`` steps ``u`` (out,) in place first."""
    cout = w.shape[0]
    w2d = w.reshape(cout, -1).t().float()
    wd = w2d.detach()
    if train:
        with torch.no_grad():
            v = wd @ u
            v = v / (torch.linalg.norm(v) + eps)
            un = wd.t() @ v
            u.copy_(un / (torch.linalg.norm(un) + eps))
    u = u.clone()
    v = wd @ u
    v = v / (torch.linalg.norm(v) + eps)
    return (w2d / torch.dot(v, w2d @ u)).t().reshape(w.shape)


class ReferenceDiscriminator:
    """``params``: the weights and biases (leaves that may require grad);
    ``u``: the spectral-norm vectors, stepped in place in train mode."""

    def __init__(self, params: Dict[str, torch.Tensor], u: Dict[str, torch.Tensor], meta: Dict,
                 products: Products = Products()):
        self.w, self.u, self.meta, self.p = params, u, meta, products

    def conv(self, x, key, train, padding="same"):
        if key + ".weight_orig" in self.w:
            w = sn_weight(self.w[key + ".weight_orig"], self.u[key + ".weight_u"], train)
        else:
            w = self.w[key + ".weight"]
        y = self.p.out(F.conv2d(self.p.round(x), self.p.round(w), padding=padding))
        return y + self.w[key + ".bias"][:, None, None]

    def block(self, x, key, fin, fout, up_or_down, first, train):
        pool = lambda t: F.avg_pool2d(t, 2)
        up = lambda t: t.repeat_interleave(2, 2).repeat_interleave(2, 3)
        xs = x
        if first:
            if up_or_down < 0:
                xs = pool(xs)
            if fin != fout:
                xs = self.conv(xs, key + ".conv_s", train)
        else:
            if up_or_down > 0:
                xs = up(xs)
            if fin != fout:
                xs = self.conv(xs, key + ".conv_s", train)
            if up_or_down < 0:
                xs = pool(xs)
        dx = x
        if not first:
            dx = lrelu(dx)
            if up_or_down > 0:
                dx = up(dx)
        dx = lrelu(self.conv(dx, key + ".conv1", train))
        dx = self.conv(dx, key + ".conv2", train)
        if up_or_down < 0:
            dx = pool(dx)
        return xs + dx

    def forward(self, images, train: bool) -> Dict[str, torch.Tensor]:
        """images NHWC -> {'prediction' (B, H, W, 1), 'segments' (B, H, W,
        label_dim), 'latents' (B, latent_dim)}."""
        x = images.permute(0, 3, 1, 2).float()
        blocks = layout(self.meta)
        nb = num_blocks(self.meta)
        enc = []
        for b in blocks[:nb]:
            x = self.block(x, *b, train)
            enc.append(x)
        B = x.shape[0]
        if min(x.shape[2], x.shape[3]) > 1:
            latents = self.conv(x, "latent_layer", train, padding="valid").reshape(B, -1)
        else:
            latents = x.new_zeros(B, self.w["latent_layer.bias"].shape[0])
        x = self.block(x, *blocks[nb], train)
        for i in range(1, nb):
            x = self.block(torch.cat([enc[-i - 1], x], 1), *blocks[nb + i], train)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        sd = self.meta.get("semantic_dim", 0)
        heads = nhwc(self.conv(x, "output_layer", train))
        return {"prediction": nhwc(self.conv(x, "layer_up_last", train)), "latents": latents,
                "segments": heads[..., sd:]}
