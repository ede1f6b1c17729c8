"""Training CLI of the port (apps/train.py's flags; ``--platform`` becomes
``--device``).

    python -m threedhumangan_tpu_torch.apps.train --config MAP3DBN --output_dir log
    python -m threedhumangan_tpu_torch.apps.train --config MAP3DBN_NANO --device cpu \\
        --output_dir /tmp/run --max_steps 2 --model_save_interval 2
    torchrun --nproc_per_node=4 -m threedhumangan_tpu_torch.apps.train \\
        --config MAP3DBN512L --output_dir log

One process a device (``cuda`` by default; ``cpu`` runs every kernel's
plain version).  Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` in the environment; ``--local_rank`` is read where
``LOCAL_RANK`` is not) each process joins the default process group (NCCL
on CUDA, on ``cuda:LOCAL_RANK``; gloo with ``--device cpu``; a collective
waits ``DIST_TIMEOUT_S`` seconds for the other ranks) and trains on its
share of the global batch (``trainers/base_trainer.py``); the group is
destroyed at the end.

It trains on the SHHQ-layout tree under the config's ``dataroot``
(``images/``, ``masks/``, ``body_seg/``, ``inversions/``, ``smpl/``) with
``datasets/SMPL_NEUTRAL.pkl``; without them, on the synthetic dataset and
SMPL model.  It prints the dataset it built and
``training finished at step N``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

DIST_TIMEOUT_S = 1800  # how long a collective waits for the other ranks


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--n_epochs", type=int, default=3000)
    parser.add_argument("--sample_interval", type=int, default=1000)
    parser.add_argument("--output_dir", type=str, default="log")
    parser.add_argument("--eval_freq", type=int, default=0)
    parser.add_argument("--set_step", type=int, default=None)
    parser.add_argument("--model_save_interval", type=int, default=1000)
    parser.add_argument("--model_keep_interval", type=int, default=5000)
    parser.add_argument("--bs_factor", type=int, default=1, help="batch split factor")
    parser.add_argument("--local_rank", default=-1, type=int)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cpu for smoke tests)")
    parser.add_argument("--tensorboard", type=int, default=1,
                        help="write tfevents alongside metrics.jsonl")
    parser.add_argument("--tune", type=str, default="")
    parser.add_argument("--variant", type=int, default=0)
    opt = parser.parse_args(argv)
    if opt.model_keep_interval % opt.model_save_interval:
        parser.error("--model_keep_interval must be a multiple of --model_save_interval")
    return opt


def init_process_group(opt):
    """Join the default process group when launched by ``torchrun``; returns
    (rank, world_size).  Without ``WORLD_SIZE`` in the environment it
    starts no group: one process, rank 0."""
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    import datetime

    import torch
    import torch.distributed as dist

    rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", max(opt.local_rank, 0)))
    if torch.device(opt.device).type == "cuda":
        opt.device = f"cuda:{local_rank}"
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    return rank, world_size


def main(argv: Optional[Sequence[str]] = None):
    opt = parse_args(argv)
    rank, world_size = init_process_group(opt)
    try:
        from threedhumangan_tpu_torch import configs
        from threedhumangan_tpu_torch.trainers.base_trainer import TRAINERS

        if rank == 0:
            print(opt)
            os.makedirs(opt.output_dir, exist_ok=True)
        config = configs.get_config(opt)
        trainer = TRAINERS[config["trainer"]](rank, world_size, opt, config)
        if opt.set_step is not None:
            trainer.step = trainer.ts.step = opt.set_step
        trainer.run(max_steps=opt.max_steps)
        prefix = f"rank {rank}: " if world_size > 1 else ""
        print(f"{prefix}training finished at step {trainer.step}", flush=True)
    finally:
        if "WORLD_SIZE" in os.environ:
            import torch.distributed as dist

            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
