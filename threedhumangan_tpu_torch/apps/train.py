"""Training CLI of the port (apps/train.py's flags; ``--platform`` becomes
``--device``).

    python -m threedhumangan_tpu_torch.apps.train --config MAP3DBN --output_dir log
    python -m threedhumangan_tpu_torch.apps.train --config MAP3DBN_NANO --device cpu \\
        --output_dir /tmp/run --max_steps 2 --model_save_interval 2

One process on one device (``cuda`` by default; ``cpu`` runs every kernel's
plain version).  Without SMPL assets it trains on the synthetic dataset with
the synthetic SMPL model.  It prints ``training finished at step N``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


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


def main(argv: Optional[Sequence[str]] = None):
    opt = parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or opt.local_rank > 0:
        raise NotImplementedError("more than one training process")

    from threedhumangan_tpu_torch import configs
    from threedhumangan_tpu_torch.trainers.base_trainer import TRAINERS

    print(opt)
    os.makedirs(opt.output_dir, exist_ok=True)
    config = configs.get_config(opt)
    trainer = TRAINERS[config["trainer"]](0, 1, opt, config)
    if opt.set_step is not None:
        trainer.step = trainer.ts.step = opt.set_step
    trainer.run(max_steps=opt.max_steps)
    print(f"training finished at step {trainer.step}")
    return trainer


if __name__ == "__main__":
    main()
