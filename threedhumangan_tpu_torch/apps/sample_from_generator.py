"""Inference CLI of the port: one identity rendered across a sweep of camera
angles (apps/sample_from_generator.py's flags; ``--platform`` becomes
``--device``).

    python -m threedhumangan_tpu_torch.apps.sample_from_generator --config MAP3DBN512L \\
        --checkpoint ema.pth --seeds 1 2 --n_angles 40
    python -m threedhumangan_tpu_torch.apps.sample_from_generator --config MAP3DBN_NANO \\
        --device cpu --seeds 7 --n_angles 3 --save png --output_dir /tmp/samples

The original repo's eval settings (truncation 0.7, no camera jitter, no nerf
noise, ``last_back = eval_last_back``).  Each frame poses the camera
(``Preprocessor.forward_with_rotation``, which rasterizes the SMPL body:
K7) and renders at batch 1 (K1, K2, K3) in the config's compute dtype, bf16
where ``use_mixed_precision`` is set: the card's field and synthesis
kernels compute in bf16 (the JAX app renders in float32).  The latent comes
from a ``torch.Generator`` seeded with the seed.  Writes
``{seed:03d}_uncond`` (the synthesis) and ``{seed:03d}_smpl`` (the
rasterized T-pose coordinates) as mp4 or gif through ``imageio`` when it
imports, else, or with ``--save png``, as PNG strips
(``data.utils.write_png``).  ``--checkpoint``: the port's ``Trainer``
checkpoint (``.npz``, EMA weights) or a reference-key-space torch
state_dict.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="MAP3DBN")
    parser.add_argument("--tune", type=str, default="")
    parser.add_argument("--variant", type=int, default=0)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--seeds", nargs="+", type=int, default=list(range(1, 10)))
    parser.add_argument("--dataroot", type=str, default="./datasets/shhq_example_dataset")
    parser.add_argument("--dataset_length", type=int, default=10)
    parser.add_argument("--output_dir", type=str, default="results/sample_from_generator")
    parser.add_argument("--postfix", type=str, default="")
    parser.add_argument("--lock_view_dependence", default=None)
    parser.add_argument("--n_angles", type=int, default=40)
    parser.add_argument("--back_and_forth", default=False, action="store_true")
    parser.add_argument("--save", type=str, default="mp4", choices=["mp4", "png", "gif"])
    parser.add_argument("--stitch", default=False, action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to render on (cpu: every kernel's plain version)")
    return parser.parse_args(argv)


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip((x * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)


@torch.no_grad()
def generate_frames(gen, pre, meta, z, conditions, n_angles, angle_range_h, angle_range_v,
                    back_and_forth, avg_latent, compute_dtype=torch.float32):
    """(n_angles, H, W, 3) uint8 frames of the synthesis and of the
    rasterized semantics (background white) of latent ``z`` (1, latent_dim)
    under ``conditions`` (a batch of one on z's device), the camera swept
    over ``n_angles`` angles."""
    from threedhumangan_tpu_torch.models.generator import staged_forward

    dev = z.device
    if back_and_forth:
        t = torch.linspace(-math.pi, math.pi, n_angles, device=dev)
        angles_h, angles_v = angle_range_h * torch.sin(t), angle_range_v * torch.cos(t)
    else:
        angles_h = torch.linspace(-angle_range_h, angle_range_h, n_angles, device=dev)
        angles_v = torch.linspace(-angle_range_v, angle_range_v, n_angles, device=dev)
    zero = torch.zeros(1, device=dev)
    frames, semantics = [], []
    for i in range(n_angles):
        cond = pre.forward_with_rotation(conditions, angles_h[i:i + 1], angles_v[i:i + 1], zero)
        out = staged_forward(gen, z, cond, meta, truncation_psi=meta.get("truncation_psi", 0.7),
                             avg_latent=avg_latent, compute_dtype=compute_dtype)
        smpl_img = cond["rasterized_semantics"].clamp(-1, 1)
        bg = (smpl_img == 0).all(-1, keepdim=True)
        smpl_img = torch.where(bg, 1.0, smpl_img)
        frames.append(out["rgbs"].float().clamp(-1, 1)[0].cpu().numpy())
        semantics.append(smpl_img[0].float().cpu().numpy())
    return _to_uint8(np.stack(frames)), _to_uint8(np.stack(semantics))


def save_frames(base: str, frames: np.ndarray, semantics: np.ndarray, save: str,
                stitch: bool) -> str:
    """Write one seed's frames as ``base``_uncond / _smpl; returns the format
    written (PNG where ``imageio`` does not import)."""
    from threedhumangan_tpu_torch.data.utils import write_png

    if stitch:
        frames = np.concatenate([frames, semantics], axis=1)
    try:
        import imageio
    except ImportError:
        imageio = None
    if imageio is None or save == "png":
        write_png(base + "_uncond.png", np.concatenate(list(frames), axis=1))
        write_png(base + "_smpl.png", np.concatenate(list(semantics), axis=1))
        return "png"
    if save == "gif":
        imageio.mimwrite(base + "_uncond.gif", frames, fps=10)
        imageio.mimwrite(base + "_smpl.gif", semantics, fps=10)
    else:
        imageio.mimwrite(base + "_uncond.mp4", frames, fps=20, quality=9)
        if not stitch:
            imageio.mimwrite(base + "_smpl.mp4", semantics, fps=20, quality=9)
    return save


def main(argv: Optional[Sequence[str]] = None):
    from threedhumangan_tpu_torch.apps.common import eval_config, load_weights
    from threedhumangan_tpu_torch.data.dataset import get_dataset, to_tensors
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.generator import generate_avg_latent, init_generator
    from threedhumangan_tpu_torch.trainers.phase_trainer import compute_dtype
    from threedhumangan_tpu_torch.utils.misc import resolve_device

    opt = parse_args(argv)
    device = resolve_device(opt.device)
    config = eval_config(opt, dataroot=opt.dataroot, dataset_length=opt.dataset_length)
    if opt.lock_view_dependence is not None:
        config["lock_view_dependence"] = opt.lock_view_dependence
    output_dir = os.path.join(opt.output_dir, config["name"] + opt.postfix)
    os.makedirs(output_dir, exist_ok=True)

    gen = init_generator(config, torch.Generator().manual_seed(0), device)
    load_weights(gen, opt.checkpoint)
    avg_latent = generate_avg_latent(gen, config, torch.Generator(device=device).manual_seed(1),
                                     device=device)
    loader, dataset = get_dataset(config["dataset"], inference=True, **config)
    pre = get_preprocessor(config, smpl_model=dataset.smpl_model)
    data_iter = iter(loader())
    written = {}
    for seed in opt.seeds:
        conditions = to_tensors(next(data_iter), device)
        gz = torch.Generator(device=device).manual_seed(seed)
        z = torch.randn(1, config["latent_dim"], generator=gz, device=device)
        frames, semantics = generate_frames(gen, pre, config, z, conditions, opt.n_angles,
                                            math.pi / 6, 0, opt.back_and_forth, avg_latent,
                                            compute_dtype(config))
        base = os.path.join(output_dir, f"{seed:03d}")
        fmt = save_frames(base, frames, semantics, opt.save, opt.stitch)
        written[seed] = (base, frames, semantics)
        print(f"seed {seed}: wrote {base}_*.{fmt}", flush=True)
    return written


if __name__ == "__main__":
    main()
