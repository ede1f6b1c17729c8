"""Multi-view consistency sweep of the port (apps/eval_consistency.py).

Renders one identity across N camera angles and prints, as one JSON line:
  * seg_iou_mean      — mean IoU between the rendered silhouette (depth
                        inside the clamp) and the rasterized SMPL silhouette;
  * reproj_l1         — view i's pixels lifted to world space through its
                        rendered depth and the weak-perspective camera,
                        projected into view i+1, and that view's image sampled
                        there (bilinear, zero padding) and compared under the
                        joint validity mask, weighted by the valid pixels;
  * adjacent_view_l1  — the un-warped L1 of adjacent frames.

    python -m threedhumangan_tpu_torch.apps.eval_consistency --config MAP3DBN512L --n_angles 16
    python -m threedhumangan_tpu_torch.apps.eval_consistency --config MAP3DBN_NANO \\
        --device cpu --n_angles 3

As in the JAX app, each view renders with its own truncation average (drawn
from one ``torch.Generator`` seeded with ``--seed``, 10,000 latents a view),
in the config's compute dtype (bf16 where ``use_mixed_precision`` is set);
``--checkpoint`` as in ``sample_from_generator``.
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="MAP3DBN_TINY")
    parser.add_argument("--tune", type=str, default="")
    parser.add_argument("--variant", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--n_angles", type=int, default=16)
    parser.add_argument("--angle_range", type=float, default=math.pi / 6)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (cpu: every kernel's plain version)")
    return parser.parse_args(argv)


@torch.no_grad()
def one_view(gen, pre, meta, z, conditions, h: float, avg_latent,
             compute_dtype=torch.float32) -> Dict:
    """One view at horizontal angle ``h``: its image, silhouettes and IoU,
    depth, the image resized to the render's grid, and its camera."""
    from threedhumangan_tpu_torch.models.generator import staged_forward
    from threedhumangan_tpu_torch.utils.image import resize_bilinear, resize_nearest

    zero = torch.zeros(1, device=z.device)
    cond = pre.forward_with_rotation(conditions, zero + h, zero, zero)
    out = staged_forward(gen, z, cond, meta, avg_latent=avg_latent, compute_dtype=compute_dtype)
    body_mask = cond["rasterized_segments"] > 1  # (1, H, W)
    depth = out["depths"][..., 0].float()  # (1, h, w)
    render_mask = depth < 0.999
    raster_small = resize_nearest(body_mask.float(), *depth.shape[1:]) > 0.5
    inter = (render_mask & raster_small).sum()
    union = (render_mask | raster_small).sum()
    rgb = out["rgbs"].float()
    return dict(rgb=rgb[0], iou=float(inter / union.clamp(min=1)), depth=depth[0],
                render_mask=render_mask[0], raster_mask=raster_small[0],
                rgb_small=resize_bilinear(rgb, meta["render_height"], meta["render_width"])[0],
                cam=cond["cam2world_matrices"][0].float(), focal=cond["intrinsics"][0, 0, 0],
                scale=cond["scales"][0].float())


def reproject(meta, depth_i, rgb_i, cam_i, rgb_j, cam_j, focal, scale):
    """Masked L1 of view j's image sampled where view i's pixels land, and
    the count of valid pixels.  The exact inverse of the weak-perspective
    rays (``models.volume_rendering``): pixel (u, v) -> d_cam =
    normalize([x, y, focal]), world = R d t + T, t along the unit ray."""
    from threedhumangan_tpu_torch.ops import grid_sample

    rh, rw = depth_i.shape
    span = rw / rh
    dev = depth_i.device
    xs = torch.linspace(-span, span, rw, device=dev)
    ys = torch.linspace(-1.0, 1.0, rh, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.stack([gx, gy, torch.full_like(gx, float(focal))], -1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    # the [-1, 1]-clipped depth map back to distances along the ray
    t = depth_i * (meta["depth_length"] / 2.0) + focal / scale
    p = torch.einsum("ij,hwj->hwi", cam_i[:3, :3], d_cam * t[..., None]) + cam_i[:3, 3]
    q = torch.einsum("ji,hwj->hwi", cam_j[:3, :3], p - cam_j[:3, 3])
    xj = q[..., 0] / q[..., 2] * focal
    yj = q[..., 1] / q[..., 2] * focal
    grid = torch.stack([xj / span, yj], -1)[None]
    warped = grid_sample(rgb_j[None], grid)[0]
    valid = (depth_i.abs() < 0.999) & (xj.abs() < span) & (yj.abs() < 1.0)
    err = (warped - rgb_i).abs().sum(-1) / 3.0
    n = valid.sum().clamp(min=1)
    return float(torch.where(valid, err, 0.0).sum() / n), float(n)


def consistency_sweep(gen, pre, meta, z, conditions, angles: Sequence[float],
                      avg_latents: Sequence, compute_dtype=torch.float32):
    """The three metrics over ``angles`` (unrounded), and the views; view i
    renders with ``avg_latents[i]``."""
    views: List[Dict] = [one_view(gen, pre, meta, z, conditions, float(h), avg, compute_dtype)
                         for h, avg in zip(angles, avg_latents)]
    reproj, weights = [], []
    for vi, vj in zip(views[:-1], views[1:]):
        l1, n = reproject(meta, vi["depth"], vi["rgb_small"], vi["cam"], vj["rgb_small"],
                          vj["cam"], vi["focal"], vi["scale"])
        reproj.append(l1)
        weights.append(n)
    frames = np.stack([v["rgb"].cpu().numpy() for v in views])
    metrics = {"seg_iou_mean": float(np.mean([v["iou"] for v in views])),
               "reproj_l1": float(np.average(reproj, weights=weights)),
               "adjacent_view_l1": float(np.mean(np.abs(frames[1:] - frames[:-1])))}
    return metrics, views


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from threedhumangan_tpu_torch.apps.common import eval_config, load_weights
    from threedhumangan_tpu_torch.data.dataset import get_dataset, to_tensors
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.generator import generate_avg_latent, init_generator
    from threedhumangan_tpu_torch.trainers.phase_trainer import compute_dtype
    from threedhumangan_tpu_torch.utils.misc import resolve_device

    opt = parse_args(argv)
    device = resolve_device(opt.device)
    config = eval_config(opt)
    gen = init_generator(config, torch.Generator().manual_seed(opt.seed), device)
    load_weights(gen, opt.checkpoint)
    loader, dataset = get_dataset(config["dataset"], inference=True, **config)
    pre = get_preprocessor(config, smpl_model=dataset.smpl_model)
    conditions = to_tensors(next(iter(loader())), device)
    g = torch.Generator(device=device).manual_seed(opt.seed)
    z = torch.randn(1, config["latent_dim"], generator=g, device=device)
    angles = np.linspace(-opt.angle_range, opt.angle_range, opt.n_angles)
    avgs = [generate_avg_latent(gen, config, g, device=device) for _ in angles]
    metrics, _ = consistency_sweep(gen, pre, config, z, conditions, angles, avgs,
                                   compute_dtype(config))
    result = {"metric": f"multi-view consistency ({opt.n_angles}-angle sweep)",
              "n_angles": opt.n_angles, **{k: round(v, 4) for k, v in metrics.items()}}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
