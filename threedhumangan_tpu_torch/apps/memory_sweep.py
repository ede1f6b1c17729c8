"""Peak device memory and time of a training pair by (batch_split, remat)
on one CUDA card: the measurements ``models/generator.py::
REMAT_RESIDUAL_BUDGET`` is fitted to.

    python -m threedhumangan_tpu_torch.apps.memory_sweep

MAP3DBN512L's pair at its batch 32, for batch_split 1, 2 and 4, each with
remat on and off.  Each case runs in a process of its own (``--case
split,remat``), so a case that runs out of memory leaves nothing behind for
the next.  A case builds the pair as the trainer does on the card (fused
half-blocks, bf16, random weights from seed 0, a synthetic batch with the
6,890-vertex synthetic SMPL model, phase slot 3, nerf noise 0.5) with
``batch_split`` and ``remat_synthesis`` pinned, runs one warm-up pair and
times two more (host clock, synchronized at both ends), and prints one
``CASE`` JSON line: its micro-batch, the JAX residual estimate of that
micro-batch (``synthesis_residual_bytes``),
``torch.cuda.max_memory_allocated()`` over all its pairs, ms a pair, or the
stage where it ran out of memory.  Then the parent prints the interval of
budgets that keep remat off exactly where the no-remat pair fits with 8 GiB
to spare, the card's line (``nvidia-smi`` name and power limit) and one
``SWEEP`` JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

GIB = 2**30
CONFIG, BATCH, SPLITS, WARMUP, PAIRS = "MAP3DBN512L", 32, (1, 2, 4), 1, 2
HEADROOM_GIB = 8.0


def run_case(split: int, remat: bool):
    import torch

    from threedhumangan_tpu_torch import configs
    from threedhumangan_tpu_torch.data.dataset import (SyntheticSHHQDataset, iterate_batches,
                                                       to_tensors)
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.generator import synthesis_residual_bytes
    from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
    from threedhumangan_tpu_torch.trainers.phase_trainer import init_train_state, train_step_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = BATCH
    meta = dict(configs.extract_metadata(getattr(configs, CONFIG), 0), dataset_length=batch,
                batch_size=batch, batch_split=split, remat_synthesis=remat,
                pallas_synthesis_train=True)
    micro = batch // split
    case = dict(config=CONFIG, batch=batch, split=split, remat=remat, micro_batch=micro,
                residual_bytes=synthesis_residual_bytes(meta, micro))
    smpl = synthetic_smpl_model(num_verts=6890, num_faces=13776)
    data = to_tensors(next(iterate_batches(SyntheticSHHQDataset(smpl_model=smpl, **meta), batch,
                                           shuffle=False)))
    pre = get_preprocessor(meta, smpl)
    ts = init_train_state(meta, torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    where = {"stage": "set-up"}

    @contextlib.contextmanager
    def stage(name):
        where["stage"] = name
        yield

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    try:
        for it in range(WARMUP + PAIRS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, _ = train_step_pair(ts, data, gen, meta, pre, meta["phases"][3], 5e-5, 2e-4, 0.5,
                                    stage=stage)
            torch.cuda.synchronize()
            if it >= WARMUP:
                walls.append(time.perf_counter() - t0)
        case.update(oom=False, ms_per_pair=1e3 * sum(walls) / len(walls),
                    ms_per_pair_runs=[1e3 * w for w in walls])
    except torch.cuda.OutOfMemoryError:
        case.update(oom=True, oom_stage=where["stage"])
    case.update(peak_gib=torch.cuda.max_memory_allocated() / GIB,
                capacity_gib=torch.cuda.get_device_properties(0).total_memory / GIB)
    print("CASE " + json.dumps(case), flush=True)


def budget_interval(cases, headroom_gib: float = HEADROOM_GIB):
    """(lo, hi): a budget in [lo, hi) turns remat off exactly for the
    micro-batches whose no-remat pair ran within the card less the headroom;
    lo > hi-1 when no budget does."""
    lo, hi = 0, float("inf")
    for c in cases:
        if c["remat"]:
            continue
        fits = not c["oom"] and c["peak_gib"] <= c["capacity_gib"] - headroom_gib
        if fits:
            lo = max(lo, c["residual_bytes"])
        else:
            hi = min(hi, c["residual_bytes"])
    return lo, hi


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--case", default=None, help="split,remat: run one case in this process")
    opt = parser.parse_args(argv)
    if opt.case:
        split, remat = (int(v) for v in opt.case.split(","))
        run_case(split, bool(remat))
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("memory_sweep needs a CUDA card")
    from threedhumangan_tpu_torch import _build

    _build.library()  # once, before the cases load it
    cases = []
    for remat in (1, 0):
        for split in SPLITS:
            cmd = [sys.executable, "-m", "threedhumangan_tpu_torch.apps.memory_sweep", "--case",
                   f"{split},{remat}"]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("CASE ")]
            if proc.returncode or not lines:
                print(proc.stdout[-3000:] + proc.stderr[-3000:], flush=True)
                raise SystemExit(f"case split {split} remat {remat} failed ({proc.returncode})")
            case = json.loads(lines[-1][5:])
            case["process_s"] = time.perf_counter() - t0
            cases.append(case)
            res = case["residual_bytes"] / GIB
            what = (f"out of memory in {case['oom_stage']}" if case["oom"]
                    else f"{case['ms_per_pair']:.3f} ms/pair")
            print(f"split {split} (micro-batch {case['micro_batch']}) remat {bool(remat)}: "
                  f"residual estimate {res:.2f} GiB, peak {case['peak_gib']:.2f} of "
                  f"{case['capacity_gib']:.2f} GiB, {what} ({case['process_s']:.0f} s)",
                  flush=True)
    lo, hi = budget_interval(cases)
    print(f"budgets that keep remat off exactly where the no-remat pair fits with "
          f"{HEADROOM_GIB} GiB to spare: [{lo / GIB:.2f}, {hi / GIB:.2f}) GiB", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print("SWEEP " + json.dumps({"card": card, "cases": cases, "budget_lo": lo,
                                 "budget_hi": None if hi == float("inf") else hi}))


if __name__ == "__main__":
    main()
