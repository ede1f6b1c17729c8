"""Training losses (threedhumangan_tpu/trainers/losses.py).

segmentation_loss   balanced per-pixel cross-entropy (class 0, the fake
                    class, gets no weight; reciprocal-frequency balancing;
                    plain CE when no foreground), plus accuracy and the
                    real probability.
r1_regularization   R1 penalty on the discriminator input, of
                    sum(softmax(segments)) — or of sum(prediction) when
                    gan_lambda > 0.  sum(softmax) is 1 per pixel, so the
                    penalty is analytically 0 and numerically tiny: a quirk
                    of the reference that the port keeps, with its double
                    backward and its cost.
gan_loss_d/_g       non-saturating softplus GAN losses (top-k filtered for G).
smooth_l1           F.smooth_l1_loss(beta=0.1), mean.

Images NHWC; segment logits (B, H, W, L); labels (B, H, W) int.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F


def smooth_l1(x, y, beta: float = 0.1):
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


def _resize_labels(gt, h: int, w: int):
    """Nearest-neighbour label resize with half-pixel centres (jax.image.resize)."""
    if gt.shape[1] == h and gt.shape[2] == w:
        return gt
    return F.interpolate(gt[:, None].float(), size=(h, w), mode="nearest-exact")[:, 0].to(gt.dtype)


def _cross_entropy(logits, labels):
    """Per-pixel CE, no reduction."""
    return -torch.gather(torch.log_softmax(logits, -1), -1, labels[..., None].long())[..., 0]


def segmentation_loss(segments, gt_segments, label_dim: int,
                      mode: str = "cross_entropy_balanced",
                      prior_weights=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (loss, accuracy, real_prob)."""
    B, H, W, L = segments.shape
    gt = _resize_labels(gt_segments, H, W).long()
    dt, dev = segments.dtype, segments.device
    prior = (torch.ones(label_dim, dtype=dt, device=dev) if prior_weights is None
             else torch.as_tensor(prior_weights, dtype=dt, device=dev))
    prior = prior / prior.mean()
    if mode == "cross_entropy":
        loss = _cross_entropy(segments, gt).mean()
    elif mode == "cross_entropy_multiclass":
        one_hot = F.one_hot(gt, label_dim).to(dt)
        one_hot[..., 1] = torch.where(gt > 0, 1.0, one_hot[..., 1])
        loss = (segments.clamp(min=0) - segments * one_hot
                + torch.log1p(torch.exp(-segments.abs()))).mean()
    elif mode == "cross_entropy_balanced":
        one_hot = F.one_hot(gt, label_dim).to(dt)
        occ = one_hot.sum((0, 1, 2))
        occ[0] = 0.0
        n_occ = (occ > 0).sum()
        total = torch.tensor(float(one_hot.numel()), dtype=dt, device=dev)
        coeff = torch.where(occ > 0, total / (occ.clamp(min=1e-12) * n_occ.clamp(min=1) * L),
                            torch.zeros_like(occ))
        coeff[0] = 0.0
        coeff = coeff * prior
        ce = _cross_entropy(segments, gt)
        balanced = (ce * coeff[gt]).mean()
        loss = torch.where((gt > 0).any(), balanced, ce.mean())
    elif mode == "softplus":
        one_hot = F.one_hot(gt, label_dim).to(dt)
        one_hot[..., 1] = torch.where(gt > 0, 1.0, one_hot[..., 1])
        signed = torch.where(one_hot > 0, -segments, segments)
        loss = (F.softplus(signed[..., 0]).mean() + F.softplus(signed[..., 1]).mean()
                + F.softplus(signed[..., 2:]).mean()) / 3.0
    else:
        raise ValueError(f"unknown segmentation loss mode {mode}")
    with torch.no_grad():
        real_prob = (1.0 - torch.softmax(segments, -1)[..., 0]).mean()
        accuracy = ((segments[..., 1:].argmax(-1) + 1) == gt).float().mean()
    return loss, accuracy, real_prob


def r1_regularization(disc_forward: Callable[[torch.Tensor], Dict], real_images, r1_lambda: float,
                      gan_lambda: float = 0.0, segmentation_lambda: float = 1.0):
    """R1 penalty w.r.t. the real input, differentiable w.r.t. the
    discriminator (double backward)."""
    img = real_images.detach().requires_grad_(True)
    out = disc_forward(img)
    if gan_lambda > 0:
        scalar = out["prediction"].sum()
    elif segmentation_lambda > 0:
        scalar = torch.softmax(out["segments"], -1).sum()
    else:
        raise ValueError("R1 needs gan_lambda>0 or segmentation_lambda>0")
    (grad,) = torch.autograd.grad(scalar, img, create_graph=True)
    penalty = 0.5 * r1_lambda * torch.square(grad.float()).reshape(grad.shape[0], -1).sum(1).mean()
    return torch.where(torch.isnan(penalty), torch.zeros_like(penalty), penalty)


def gan_loss_d(pred_real, pred_gen):
    return F.softplus(pred_gen).mean() + F.softplus(-pred_real).mean()


def gan_loss_g(pred_gen):
    return F.softplus(-pred_gen).mean()


def topk_fraction(step: int, meta: Dict) -> Optional[float]:
    if "topk_interval" in meta and "topk_v" in meta:
        return max(0.99 ** (step / meta["topk_interval"]), meta["topk_v"])
    return None


def gan_loss_g_topk(pred_gen, step: int, meta: Dict):
    """Non-saturating G loss over the top ceil(frac * B) predictions of the
    batch at each location (decaying fraction; no-op unless configured)."""
    frac = topk_fraction(step, meta)
    if frac is None:
        return gan_loss_g(pred_gen)
    k = math.ceil(frac * pred_gen.shape[0])
    top = torch.topk(pred_gen, k, dim=0).values
    return F.softplus(-top).mean()
