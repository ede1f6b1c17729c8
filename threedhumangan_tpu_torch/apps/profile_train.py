"""Device-time breakdown of the MAP3DBN D+G+R1 pair on one CUDA card.

    python -m threedhumangan_tpu_torch.apps.profile_train [--paths fused,per_op] [--pairs 2]

For each path (the fused half-blocks K10/K11, or the per-op synthesis) it
builds the pair as ``chip_smoke.py``'s training slice does (batch 8, bf16,
phase slot 3, nerf noise 0.5, random weights from seed 0, the synthetic
6,890-vertex SMPL model), runs 2 warm-up pairs, traces ``--pairs`` pairs
with ``torch.profiler`` and prints: host-clock ms a pair, the card's busy
ms a pair (the union of kernel intervals in the trace), the busy share, and
device ms a pair by kernel group and for the top kernels.  The trace goes to
``build/profile/profile_<path>.json`` (git-ignored; ``--out_dir`` moves it).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

# kernel-name substrings -> group; the port's kernels first
GROUPS = (
    ("half_block_fwd", "K10 half-block forward"),
    ("half_block_bwd", "K11 half-block backward"),
    ("wgrad_kernel", "K9/K11 weight-gradient products"),
    ("field_kernel<true>", "K9 field backward"),
    ("field_kernel<false>", "K8 field stats"),
    ("raymarch_kernel", "K2 field render"),
    ("geo_kernel", "K1 geo"),
    ("rasterize_kernel", "K7 rasterizer"),
    ("synthesis_kernel", "K3 synthesis"),
    ("conv", "cuDNN convolutions"),
    ("gemm", "library GEMMs"),
    ("Reduce", "PyTorch reductions"),
    ("elementwise", "PyTorch element-wise"),
)


def _group(name: str) -> str:
    for key, group in GROUPS:
        if key.lower() in name.lower():
            return group
    return "other"


def _busy_ms(kernels):
    """Length of the union of the kernels' [ts, ts + dur) intervals, ms."""
    total, end = 0.0, None
    for ts, dur in sorted((k["ts"], k["dur"]) for k in kernels):
        if end is None or ts > end:
            total += dur
            end = ts + dur
        elif ts + dur > end:
            total += ts + dur - end
            end = ts + dur
    return total / 1e3


def profile_path(fused: bool, pairs: int, out_dir: str):
    import torch

    from threedhumangan_tpu_torch import configs
    from threedhumangan_tpu_torch.data.dataset import (SyntheticSHHQDataset, iterate_batches,
                                                       to_tensors)
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
    from threedhumangan_tpu_torch.trainers.phase_trainer import init_train_state, train_step_pair

    meta = dict(configs.extract_metadata(configs.MAP3DBN, 0), dataset_length=8,
                pallas_synthesis_train=fused)
    smpl = synthetic_smpl_model(num_verts=6890, num_faces=13776)
    batch = to_tensors(next(iterate_batches(SyntheticSHHQDataset(smpl_model=smpl, **meta), 8,
                                            shuffle=False)))
    pre = get_preprocessor(meta, smpl)
    ts = init_train_state(meta, torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = lambda: train_step_pair(ts, batch, gen, meta, pre, meta["phases"][3], 1e-4, 4e-4, 0.5)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(pairs):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / pairs
    name = "fused" if fused else "per_op"
    path = os.path.join(out_dir, f"profile_{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    busy = _busy_ms(kernels) / pairs
    by_group, by_name = {}, {}
    for k in kernels:
        g = _group(k["name"])
        by_group[g] = by_group.get(g, 0.0) + k["dur"] / 1e3 / pairs
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["dur"] / 1e3 / pairs
    print(f"{name}: {pairs} traced pairs, {len(kernels) / pairs:.0f} kernels a pair; wall "
          f"{wall:.3f} ms/pair (under the profiler), card busy {busy:.3f} ms/pair, busy share "
          f"{busy / wall:.3f}")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:<34} {ms:10.3f} ms/pair")
    print("  top kernels:")
    for n, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {ms:10.3f} ms/pair  {n[:110]}")


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--paths", default="fused,per_op")
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--out_dir", default=os.path.join("build", "profile"))
    opt = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(opt.out_dir, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip() or torch.cuda.get_device_name(0))
    for p in opt.paths.split(","):
        profile_path(p == "fused", opt.pairs, opt.out_dir)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
