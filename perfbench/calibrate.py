"""Readings that a cell's limits are set from (on the card).

    python3 -m perfbench.calibrate --workload <name> --seeds 1 2 ... \
        --control-seeds 7 8 9 [--fault-seeds 7 8 9] [--seconds 3] \
        [--control-dtype float8_e4m3fn]

For each of ``--seeds`` it runs the cell as a run does, for ``--seconds``,
and prints the numbers compared (the lower readings: the program's).  For
each of ``--control-seeds`` it prints the control's numbers: the plain
reference put in the program's place with its products in
``--control-dtype``, against the float32 reference (the upper readings).
For each of ``--fault-seeds``, where the cell's driver has it, the
half-batch fault read with the reference in the program's place.
One JSON line a seed, on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from perfbench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-dtype", default="float8_e4m3fn")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Spec().cell(args.workload)
    drv = harness.driver(cell.traffic["driver"])
    dev = torch.device("cuda")
    for seed in args.seeds:
        t = time.perf_counter()
        rec = drv.run(cell, seed, args.seconds, False, dev, t)
        print(json.dumps({"side": "program", "seed": seed, "units": len(rec.requests),
                          "failed": rec.failed, "setup_s": rec.setup_s,
                          "check_s": time.perf_counter() - rec.window_end,
                          "numbers": rec.checks, "notes": rec.notes}), flush=True)
    dtype = getattr(torch, args.control_dtype)
    for seed in args.control_seeds:
        t = time.perf_counter()
        print(json.dumps({"side": "control", "dtype": args.control_dtype, "seed": seed,
                          "readings": drv.control(cell, seed, dev, dtype),
                          "seconds": time.perf_counter() - t}), flush=True)
    for seed in args.fault_seeds:
        print(json.dumps({"side": "half_batch", "seed": seed,
                          "readings": drv.half_batch(cell, seed, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
