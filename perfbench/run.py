"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA cards.  The
cell (``BENCHMARK.json``) names its configuration and traffic mix; the mix
names the driver that sets up, warms up, drives the window for ``--seconds``
and checks what the window produced against the plain reference.  With
``--trace 0`` the result's metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace of
the window and the stage hooks.  The last line on standard output is one
JSON object; the last lines on standard error are the numbers compared,
each beside its limit.  Exits non-zero, with no result, without the cards
the cell asks for or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from perfbench import harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "threedhumangan_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def judge(checks, limits):
    """The names of the numbers over their limits.  A number without a
    limit, or a limit without a number, is an error of the benchmark."""
    if set(checks) != set(limits):
        raise KeyError(f"numbers {sorted(checks)} against limits {sorted(limits)}")
    return sorted(k for k, v in checks.items() if not v <= limits[k])


def result(cell, rec, trace: bool, device_info) -> dict:
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = harness.reader(m["name"], cell.root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    over = judge(rec.checks, cell.limits)
    out = {"correct": not over and rec.failed == 0, "attempted": len(rec.requests),
           "failed": rec.failed, "metrics": metrics, "device": device_info}
    if trace and rec.trace:
        out["device"].update(busy_s=rec.trace["busy_s"], window_s=rec.trace["window_s"])
        out["breakdown"] = {"device_ops": rec.trace["device_ops"],
                            "idle_gaps": rec.trace["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in rec.checks.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(harness.HERE, ".cache", sub)
    cell = harness.Spec().cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    drv = harness.driver(cell.traffic["driver"])
    rec = drv.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad}; the port's runs import no JAX", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
            "memory_peak_bytes": rec.peak_bytes}
    out = result(cell, rec, bool(args.trace), info)
    if "numbers" in rec.notes:
        print(f"perfbench: readings {json.dumps(rec.notes['numbers'])}", file=sys.stderr)
    print(f"perfbench: set-up {rec.setup_s:.1f} s, window "
          f"{rec.window_end - rec.window_start:.1f} s, run {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
