"""Frechet feature distance between generated images and dataset images
(apps/eval_fid.py), in the port.

    python -m threedhumangan_tpu_torch.apps.eval_fid --config MAP3DBN512L --n 64 --batch 8
    python -m threedhumangan_tpu_torch.apps.eval_fid --config MAP3DBN_NANO --device cpu --n 16

Batch i of the dataset (in order) is preprocessed without camera jitter
(``pre(batch, rotate=False)``, which rasterizes: K7) and rendered from
latents drawn from a ``torch.Generator`` seeded with ``--seed``, each batch
with its own truncation average as in the JAX app, in the config's compute
dtype; ``utils.fid.fid_between`` then compares the two sets.  Without
``INCEPTION_WEIGHTS_NPZ``/``VGG16_WEIGHTS_NPZ`` the features are a fixed-
random VGG16's: comparable across runs of this program, not to published
Inception-FID, and the printed metric says so.  ``--checkpoint`` as in
``sample_from_generator``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from threedhumangan_tpu_torch.utils.fid import fid_between


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="MAP3DBN_TINY")
    parser.add_argument("--tune", type=str, default="")
    parser.add_argument("--variant", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--n", type=int, default=64)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (cpu: every kernel's plain version)")
    return parser.parse_args(argv)


@torch.no_grad()
def generate_fakes(gen, pre, meta, batches: Iterable[Dict], zs: Sequence, avg_latents: Sequence,
                   compute_dtype=torch.float32, device="cuda"):
    """(fakes, reals): the renders of each numpy batch (latents ``zs[i]``,
    truncation average ``avg_latents[i]``) clipped to [-1, 1], and the
    batches' images, as numpy arrays."""
    from threedhumangan_tpu_torch.data.dataset import to_tensors
    from threedhumangan_tpu_torch.models.generator import staged_forward

    g = torch.Generator(device=device)  # rotate=False: the draws are multiplied by 0
    fakes, reals = [], []
    for data, z, avg in zip(batches, zs, avg_latents):
        cond = pre(to_tensors(data, device), rotate=False, generator=g)
        out = staged_forward(gen, z, cond, meta, avg_latent=avg, compute_dtype=compute_dtype)
        fakes.append(out["rgbs"].float().clamp(-1, 1).cpu().numpy())
        reals.append(np.asarray(data["images"]))
    return np.concatenate(fakes), np.concatenate(reals)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from threedhumangan_tpu_torch.apps.common import eval_config, load_weights
    from threedhumangan_tpu_torch.data.dataset import get_dataset, iterate_batches
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.generator import generate_avg_latent, init_generator
    from threedhumangan_tpu_torch.trainers.phase_trainer import compute_dtype
    from threedhumangan_tpu_torch.utils.misc import resolve_device

    opt = parse_args(argv)
    device = resolve_device(opt.device)
    config = eval_config(opt, eval_last_back=False)
    config["dataset_length"] = max(config.get("dataset_length", opt.n), opt.n)
    gen = init_generator(config, torch.Generator().manual_seed(opt.seed), device)
    load_weights(gen, opt.checkpoint)
    _, dataset = get_dataset(config["dataset"], batch_size=opt.batch, **config)
    pre = get_preprocessor(config, smpl_model=dataset.smpl_model)
    n_batches = -(-opt.n // opt.batch)
    batches = [b for _, b in zip(range(n_batches),
                                 iterate_batches(dataset, opt.batch, shuffle=False))]
    g = torch.Generator(device=device).manual_seed(opt.seed)
    zs, avgs = [], []
    for _ in batches:
        zs.append(torch.randn(opt.batch, config["latent_dim"], generator=g, device=device))
        avgs.append(generate_avg_latent(gen, config, g, device=device))
    fakes, reals = generate_fakes(gen, pre, config, batches, zs, avgs, compute_dtype(config),
                                  device)
    value = fid_between(fakes[:opt.n], reals[:opt.n], device=device)
    weights = ("inception/vgg npz" if os.environ.get("VGG16_WEIGHTS_NPZ")
               else "fixed-random VGG16")
    result = {"metric": f"frechet feature distance ({weights}; NOT Inception-FID unless "
                        "weights supplied)",
              "value": round(float(value), 4), "n": int(opt.n)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
