"""Convert a training run's ``metrics.jsonl`` into a TensorBoard event file
(apps/export_tensorboard.py), with the port's ``utils/tb.py``.

The port's ``Trainer`` writes both by default (``--tensorboard 1``); this
backfills event files for runs recorded without them.  It reads and writes
files only, so it takes no device.

    python -m threedhumangan_tpu_torch.apps.export_tensorboard --run_dir log/map3dbn512l [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence, Tuple

from threedhumangan_tpu_torch.utils.tb import EventWriter


def export(run_dir: str, out_dir: Optional[str] = None) -> Tuple[str, int]:
    """Every numeric value of each ``metrics.jsonl`` row as the scalar
    ``train/<key>`` at the row's step; returns (event file, scalars written)."""
    path = os.path.join(run_dir, "metrics.jsonl")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    writer = EventWriter(out_dir or run_dir, filename_suffix=".export")
    n = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            step = int(row.pop("step", 0))
            for tag, value in row.items():
                if isinstance(value, (int, float)):
                    writer.add_scalar(f"train/{tag}", value, step)
                    n += 1
    writer.close()
    print(f"wrote {n} scalars -> {writer.path}", flush=True)
    return writer.path, n


def main(argv: Optional[Sequence[str]] = None) -> Tuple[str, int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True, help="directory containing metrics.jsonl")
    ap.add_argument("--out", default=None, help="output dir (default: run_dir)")
    opt = ap.parse_args(argv)
    return export(opt.run_dir, opt.out)


if __name__ == "__main__":
    main()
