"""Parity harness against a reference checkpoint and its goldens
(apps/eval_parity.py), in the port.

  1. ``--torch_checkpoint``: the released ``map3dbn512l`` EMA state_dict, or
     any state_dict in the reference key space (one the port saved with
     ``torch.save``): it loads with no converter.  Absent: random weights
     from a fixed seed.
  2. Renders ``--seeds`` fixed identities at a fixed pose and camera with
     the original repo's eval settings, deterministically.
  3. ``--goldens``: a directory of ``seed_{s:03d}.npy`` (float32 HWC in
     [-1, 1]).  Reports per-pixel deltas per seed and a Frechet distance
     between the two sets' features (``utils.fid.get_extractor('auto')``:
     Inception pool3 with ``INCEPTION_WEIGHTS_NPZ``, else labelled fixed-
     random VGG16).
  4. ``--write_goldens``: writes this run's renders in that layout.

    python -m threedhumangan_tpu_torch.apps.eval_parity --torch_checkpoint ema.pth \\
        --goldens goldens/
    python -m threedhumangan_tpu_torch.apps.eval_parity --config MAP3DBN_NANO --device cpu \\
        --seeds 1 2 --dataset_length 4 --write_goldens /tmp/goldens

Seed s renders dataset item ``s % len`` with a latent from a
``torch.Generator`` seeded with s, in the config's compute dtype (bf16 for
MAP3DBN512L).  Prints one JSON summary line and writes it to
``<output_dir>/parity.json``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default="MAP3DBN512L")
    p.add_argument("--torch_checkpoint", type=str, default="",
                   help="EMA state_dict in the reference key space (.pth/.pkl); optional")
    p.add_argument("--goldens", type=str, default="",
                   help="dir of reference-rendered seed_{s:03d}.npy goldens")
    p.add_argument("--write_goldens", type=str, default="",
                   help="write this run's renders as goldens to this dir")
    p.add_argument("--seeds", nargs="+", type=int, default=list(range(1, 9)))
    p.add_argument("--dataroot", type=str, default="synthetic")
    p.add_argument("--dataset_length", type=int, default=8)
    p.add_argument("--output_dir", type=str, default="results/eval_parity")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (cpu: every kernel's plain version)")
    p.add_argument("--tune", type=str, default="")
    p.add_argument("--variant", type=int, default=0)
    return p.parse_args(argv)


@torch.no_grad()
def render_seed(gen, pre, meta, z, conditions, avg_latent, compute_dtype=torch.float32):
    """One deterministic render (H, W, 3) in [-1, 1] of latent ``z`` (1,
    latent_dim) at the pose of ``conditions`` (a batch of one), camera at 0."""
    from threedhumangan_tpu_torch.models.generator import staged_forward

    zero = torch.zeros(1, device=z.device)
    cond = pre.forward_with_rotation(conditions, zero, zero, zero)
    out = staged_forward(gen, z, cond, meta, truncation_psi=meta.get("truncation_psi", 0.7),
                         avg_latent=avg_latent, compute_dtype=compute_dtype)
    return out["rgbs"][0]


def seed_conditions(dataset, seed: int, device) -> Dict:
    """The fixed pose of ``seed``: dataset item ``seed % len``, as a batch of one."""
    from threedhumangan_tpu_torch.data.dataset import to_tensors

    data = dataset[seed % len(dataset)]
    return to_tensors({k: np.asarray(v)[None] for k, v in data.items()}, device)


def save_goldens(renders: Dict[int, np.ndarray], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for seed, img in renders.items():
        np.save(os.path.join(out_dir, f"seed_{seed:03d}.npy"), np.asarray(img, np.float32))


def compare_goldens(renders: Dict[int, np.ndarray], goldens: str, device) -> Dict:
    """Per-pixel deltas against the goldens present, and (two or more) the
    Frechet distance of the two sets' features."""
    from threedhumangan_tpu_torch.utils.fid import (compute_statistics, frechet_distance,
                                                    get_extractor)

    deltas, golden_imgs, our_imgs, out = {}, [], [], {}
    for seed, img in renders.items():
        path = os.path.join(goldens, f"seed_{seed:03d}.npy")
        if not os.path.exists(path):
            continue
        g = np.load(path).astype(np.float32)
        if g.shape != img.shape:
            deltas[seed] = {"error": f"shape {g.shape} vs {img.shape}"}
            continue
        deltas[seed] = {"max_abs": float(np.abs(g - img).max()),
                        "mean_abs": float(np.abs(g - img).mean())}
        golden_imgs.append(g)
        our_imgs.append(img)
    out["per_pixel"] = deltas
    if len(golden_imgs) >= 2:
        feats, label = get_extractor("auto", device)
        fa = feats(torch.as_tensor(np.stack(our_imgs), device=device)).float().cpu().numpy()
        fb = feats(torch.as_tensor(np.stack(golden_imgs), device=device)).float().cpu().numpy()
        out["feature_frechet"] = frechet_distance(*compute_statistics(fa),
                                                  *compute_statistics(fb))
        out["feature_space"] = label
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from threedhumangan_tpu_torch.apps.common import eval_config, load_weights
    from threedhumangan_tpu_torch.data.dataset import get_dataset
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.generator import generate_avg_latent, init_generator
    from threedhumangan_tpu_torch.trainers.phase_trainer import compute_dtype
    from threedhumangan_tpu_torch.utils.misc import resolve_device

    opt = parse_args(argv)
    device = resolve_device(opt.device)
    config = eval_config(opt, dataroot=opt.dataroot, dataset_length=opt.dataset_length)
    summary = {"config": config["name"], "n_seeds": len(opt.seeds)}
    gen = init_generator(config, torch.Generator().manual_seed(0), device)
    if opt.torch_checkpoint:
        load_weights(gen, opt.torch_checkpoint)
        summary["weights"] = "released-checkpoint"
    else:
        summary["weights"] = "random-init (no --torch_checkpoint): synthetic mode"
    avg_latent = generate_avg_latent(gen, config, torch.Generator(device=device).manual_seed(1),
                                     device=device)
    _, dataset = get_dataset(config["dataset"], inference=True, **config)
    pre = get_preprocessor(config, smpl_model=dataset.smpl_model)
    renders = {}
    for seed in opt.seeds:
        g = torch.Generator(device=device).manual_seed(seed)
        z = torch.randn(1, config["latent_dim"], generator=g, device=device)
        img = render_seed(gen, pre, config, z, seed_conditions(dataset, seed, device),
                          avg_latent, compute_dtype(config))
        renders[seed] = img.float().cpu().numpy()

    os.makedirs(opt.output_dir, exist_ok=True)
    if opt.write_goldens:
        save_goldens(renders, opt.write_goldens)
        summary["goldens_written"] = opt.write_goldens
    if opt.goldens and os.path.isdir(opt.goldens):
        summary.update(compare_goldens(renders, opt.goldens, device))
    elif opt.goldens:
        summary["per_pixel"] = f"goldens dir not found: {opt.goldens}"
    with open(os.path.join(opt.output_dir, "parity.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
