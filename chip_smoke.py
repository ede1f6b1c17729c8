#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (threedhumangan_tpu_torch) on one
CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (exit code != 0):

  1. card     — nvidia-smi name and power limit; TF32 off for the references.
  2. build    — nvcc builds K1-K11 and the weight-gradient reduction of K9
                and K11 from threedhumangan_tpu_torch/csrc, one process per
                source.
  3. check    — K1-K6 against their plain PyTorch versions at the generation
                slice's shapes (and K2-K5 pointwise at a narrow width, K2 at
                S 4-64; K4 and K5 at full width by statistics, K5 and K6
                with 100% index agreement; K1 and K6 also with the vertex
                order shuffled and on ties over a ragged ray grid, with the
                share of pairs their search scanned, <= 35% on the slice,
                beside the share these inputs need, which sets their bound,
                and their cluster build bit for bit against its plain
                version and timed beside it), with the tolerance and its
                reason; two K1, K2,
                K4, K5 and K6 calls bit for bit; kernel, plain and bound
                times; the weight pack, ptxas line (K1, K4, K5, K6 and the
                cluster build: a spill fails the run), shared-memory budget
                of K2, K4 and K5, and K2's L2 stream.
  4. generate — MAP3DBN512L generation at batch 8 in bf16 with seeded random
                weights: 2 warm-up + 5 timed batches through
                ``generator_forward``, per-stage ms/batch, imgs/s; the output
                must be (8, 512, 256, 3), finite and not constant, K1-K3 must
                launch, and a small config run on the card must agree with
                the same run on the CPU.
  5. check    — K7 (bin pre-pass and z-test) bit for bit against its plain
                version (bin_candidates + rasterize_tiles_plain) on the
                training inputs, with the cap at 256 faces a tile and on an
                adversarial mesh (slivers, edges through pixel centres,
                equal-z duplicates across chunks, empty tiles), two calls
                bit-equal, a spill fails, the pairs needed (its bound) and
                tested; K1, K2 (with the
                nerf-noise column), K8 and K9 against their
                plain versions at the training slice's shapes (K8/K9 also
                pointwise at a narrow width, and against autograd through the
                plain unfolded render); the weight-gradient reduction against
                the plain f32 X^T Y at K9's ragged widths; K9's call split
                into host glue, bodies, each weight-gradient product (beside
                its bound and torch.matmul) and host sums, K8's into glue
                and body, with their ptxas line; the synchronizing calls of
                one preprocess call (torch.cuda.set_sync_debug_mode).
  6. train    — the MAP3DBN D+G+R1 step at batch 8 in bf16, phase slot 3
                (R1 on), nerf noise 0.5, lr_d 4e-4 / lr_g 1e-4, per-op
                synthesis (``pallas_synthesis_train=False``): 2 warm-up + 5
                timed pair steps through ``train_step_pair``, per-stage
                ms/pair (the preprocess stage split into camera, binning, K7
                and post), imgs/s, peak memory; losses finite, parameters
                moved, K1, K2, K7, K8 and K9 launched; and a TINY D+G step on
                the card against the same step on the CPU.
  7. check    — K10/K11 against their plain versions (and K11 against
                autograd through the plain forward) at the training shapes,
                spatial with the fixed row and rank-1, and pointwise on a
                narrow case with a ragged last tile; K10's call split into
                host glue (and its weight pack) and body, with its ptxas
                line and shared memory a CTA; K11's call split into host
                glue (and its weight pack), body, each weight-gradient
                product (beside its bound and torch.matmul) and host sums;
                two K10 and two K11 calls bit for bit; the reduction against
                the plain f32 X^T Y on K11's own operands.
  8. train    — phase 6 on the fused half-blocks
                (``pallas_synthesis_train=True``): 36 K10 and 18 K11 launches
                a pair; and the TINY card-vs-CPU step on them.
  9. trainer  — ``Trainer`` on MAP3DBN at full width, batch 8: 4 steps with
                checkpoints and EMA samples, then a second ``Trainer`` resumes
                at step 4 and runs to 6; finite metrics; K1-K3 and K7-K11
                launched.
 10. 512L     — MAP3DBN512L, the released checkpoint's config, at its own
                batch 32 through ``Trainer`` on an SHHQ-layout tree written
                to a temporary directory (64 items at SHHQ's 1024 x 512:
                smooth images, masks, palette body_seg, inversions, VIBE-
                style SMPL pickles; PNG rows cycling through the five filter
                types; SMPL_NEUTRAL.pkl written from the 6,890-vertex
                synthetic model and loaded back by ``get_smpl_model``): 2
                warm-up + 3 timed steps with the trainer's own batch_split
                and remat; ms a pair (host clock), imgs/s, the stage split,
                peak memory, the chosen split and remat, launches a pair and
                the loader's ms a batch (the native core must have built).
                Then K1 (legacy), K2, K7-K11 at its shapes: on the tree's
                first 32 items, each against its plain version on the last
                two images, the 32-image launch bit-equal on those two to
                their own launch (K10/K11 spatial without the fixed row and
                rank-1, moments passed in), the batch-reduced weight
                gradients against the plain f32 X^T Y, times at the
                trainer's micro-batch; and one fused MAP3DBN G step with
                remat on vs off (gradients, BN stats and u).
 12. ranks    — the trainer across processes (run before the result phase):
                (a) ``Trainer`` on MAP3DBN b8 for 8 steps without a process
                group and in an NCCL group of one rank, twice each in
                turns: bit-equal, ms a pair of each (the collectives' own
                cost); (a) and (b) run
                under torch.use_deterministic_algorithms, as two default-
                mode runs differ in their last bits; (b) two rank
                processes sharing the card under gloo (NCCL refuses two
                ranks on one device), MAP3DBN at a global batch of 8 (4 a
                rank) through ``Trainer`` for 4 steps with a checkpoint at
                2: the ranks' weights, BN stats, u, EMA and Adam states
                bit-equal, K1, K2 and K7-K11 launched on each rank and K3
                (the samples) on rank 0 alone, a resume from step 2 to 4
                bit-equal to the uninterrupted run on each rank, each
                rank's peak memory and ms a pair (for information: two
                ranks on one card say nothing of scaling); (c) a TINY D+G
                pair on two ranks on the card against the same on the CPU
                (gloo), summed over ranks, within phase 6's limits.
 13. apps     — the inference and eval apps at MAP3DBN512L (after phase 12),
                from a temporary directory laid out as a user's checkout: a
                64-item SHHQ tree of the synthetic body (6,844 vertices
                of its 6,890 kept, 13,776 faces) under datasets/, random
                weights (the field's density bias 0.5) saved with
                torch.save.  K7, K1, K2 and K3 at batch 1: each
                image's launch bit-equal to its image of a batch-8 launch,
                one image against the plain version at the slice's
                tolerances, times and bounds; one frame at batch 1 timed by
                stage; a bf16 frame against the plain versions in float32
                (a reading); then through their CLI entries:
                sample_from_generator (2 seeds x 8 angles: PNGs read back
                equal, exactly one K1, K2, K3 and K7 a frame and no other
                kernel), eval_consistency (16 angles, finite metrics),
                eval_parity (its own goldens < 1e-5, feature Frechet < 1e-3,
                the saved state_dict's renders bit-equal to the in-memory
                G's), eval_fid (64 images, batch 8: generation and features
                timed apart), export_tensorboard over phase 10's
                metrics.jsonl (read back scalar for scalar).
 11. result   — K7's device time a launch (torch.profiler, last, as it may
                slow later host-bound launches); a JSON line of the kernels
                (times, bounds, launches by path, each kernel of the 512L
                path at its shapes, K1, K2, K3 and K7 at batch 1), the card
                line, and the final {"ok": true, "device": ...} line.
"""

import contextlib
import json
import math
import os
import re
import struct
import subprocess
import sys
import time

BATCH = 8
WARMUP = 2
TIMED = 5
SEED = 0


def log(msg):
    print(msg, flush=True)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms of fn() over ``reps`` launches after one warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernels, reps=5):
    """Device ms a call of each kernel named (a substring of its name), from
    torch.profiler's CUDA kernel events over ``reps`` calls after a warm-up;
    None where the trace holds no such time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(kernels, 0.0)
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = e.cuda_time_total if us is None else us
        for k in kernels:
            if k in e.key:
                out[k] += us / 1e3 / reps
    return {k: v or None for k, v in out.items()}


def diff_stats(got, ref):
    import torch

    d = (got.float() - ref.float()).abs().flatten()
    if not torch.isfinite(d).all():
        raise AssertionError("non-finite values in a kernel/plain comparison")
    q = torch.quantile(d[torch.randperm(d.numel(), device=d.device)[:1_000_000]], 0.99)
    return float(d.max()), float(d.mean()), float(q)


class StageTimer:
    """CUDA-event timer for generator_forward's ``stage`` hook."""

    def __init__(self):
        self.events = {}
        self.on = False

    @contextlib.contextmanager
    def stage(self, name):
        import torch

        if not self.on:
            yield
            return
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        yield
        e.record()
        self.events.setdefault(name, []).append((s, e))

    def mean_ms(self):
        import torch

        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / len(v) for k, v in self.events.items()}


def slice_meta():
    from threedhumangan_tpu_torch import configs

    meta = dict(configs.extract_metadata(configs.MAP3DBN512L, 0))
    meta.update(dataset_length=BATCH, nerf_noise=0.0, perturb_rays=False)
    return meta


def field_inputs(gen, cond, z, meta):
    """The slice's K1/K2 inputs, built with the port's public functions as
    ``models.generator.render`` builds them."""
    import torch

    from threedhumangan_tpu_torch.models import volume_rendering as vr
    from threedhumangan_tpu_torch.ops.geo import build_vertex_features

    S, W, H = meta["num_steps"], meta["render_width"], meta["render_height"]
    with torch.no_grad():
        freq, phase = gen.neural_field_mapping_network(z, torch.bfloat16)
        pts_cam, z_vals, d_cam = vr.get_initial_rays_weak_perspective(
            cond["intrinsics"][:, 0, 0], cond["scales"].float(), S, (W, H),
            meta["ray_start"], meta["ray_end"])
        pts, z_vals, _ = vr.transform_sampled_points(pts_cam, z_vals, d_cam,
                                                     cond["cam2world_matrices"])
        B = z.shape[0]
        pts = pts.reshape(B, -1, 3).contiguous()
        vfeat = build_vertex_features(cond["tpose_vertices"], cond["fk_matrices"],
                                      cond["lbs_weights"])
    dirs = torch.zeros_like(pts)
    dirs[..., -1] = -1.0
    return dict(points=pts, vertices=cond["vertices"].float().contiguous(), vfeat=vfeat,
                skeletons=cond["skeletons_xyz"].float().contiguous(), dirs=dirs,
                z_vals=z_vals.reshape(B, W * H, S).contiguous(), freq=freq, phase=phase)


def nn_sets(inp, meta):
    """The input sets of K1's and K6's checks, on the card: the slice's
    points and posed vertices with the points' ray layout; the same with the
    vertex order shuffled; and ties on a ragged grid: every vertex twice, a
    third of the points on vertices, a third at midpoints of two, on a grid
    of 5 rays a row (the last row 3) and 3 steps a ray."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    pts, verts = inp["points"], inp["vertices"]
    B, V = verts.shape[:2]
    perm = torch.randperm(V, generator=g, device="cuda")
    twice = torch.cat([verts[:, :V // 2], verts[:, :V // 2]], 1).contiguous()
    third = 5 * 611 + 3  # rays: rows of 5, the last of 3; 3 steps a ray
    pick = lambda: torch.gather(twice, 1, torch.randint(0, twice.shape[1], (B, third, 1), generator=g,
                                                        device="cuda").expand(-1, -1, 3))
    ties = torch.cat([pick(), 0.5 * (pick() + pick()),
                      pick() + 0.05 * torch.randn(B, third, 3, generator=g, device="cuda")], 1)
    base = dict(vfeat=inp["vfeat"], skeletons=inp["skeletons"], perm=None)
    return [dict(base, name="slice", points=pts, vertices=verts,
                 layout=(meta["render_width"], meta["num_steps"])),
            dict(base, name="slice, vertex order shuffled", points=pts,
                 vertices=verts[:, perm].contiguous(), vfeat=inp["vfeat"][:, perm].contiguous(),
                 layout=(meta["render_width"], meta["num_steps"]), perm=perm),
            dict(base, name="ties on a ragged grid (every vertex twice, 5 rays a row, 3 steps)",
                 points=ties.contiguous(), vertices=twice,
                 vfeat=inp["vfeat"][:, :twice.shape[1]].contiguous(), layout=(5, 3))]


def check_clusters(verts, what):
    """The cluster build (csrc/nn_clusters.cu) against its plain version,
    bit for bit."""
    import torch

    from threedhumangan_tpu_torch.ops import geo

    (tk, bk), (tp, bp) = geo.vertex_clusters(verts), geo.vertex_clusters_plain(verts)
    bits = lambda t: t.contiguous().view(torch.int32)
    same = torch.equal(bits(tk), bits(tp)) and torch.equal(bits(bk), bits(bp))
    log(f"  vertex clusters ({what}, {verts.shape[1]} vertices, {bk.shape[1]} clusters): "
        f"{'bit-equal to' if same else 'DIFFER from'} the plain version")
    if not same:
        raise AssertionError("the cluster build disagrees with its plain version")


def nn_ptxas():
    """ptxas of K1, K6 and the cluster build; a spill or a missing log fails."""
    bad = {}
    for source in ("geo.cu", "knn.cu", "nn_clusters.cu"):
        ptx = ptxas_of(source)
        log(f"  {source} ptxas: {ptx['registers']} registers, {ptx['spill_stores']} bytes spill "
            f"stores, {ptx['spill_loads']} bytes spill loads")
        if ptx["spill_stores"] is None or ptx["spill_stores"] or ptx["spill_loads"]:
            bad[source] = ptx
    if bad:
        raise AssertionError(f"spills, or no build log: {bad}")


def needed_pairs(points, vertices, best_d, chunk=4096):
    """The (point, vertex) pairs these inputs need of a search on the
    kernels' clusters: for each point, the members of every cluster whose
    box lies no farther from the point than its nearest vertex (nn_prune.cuh's
    bound for a box of one point; ``best_d`` the plain version's squared
    distances (B, P)).  What the warp tiles scan beyond that is not counted."""
    import torch

    from threedhumangan_tpu_torch.ops import geo

    _, boxes = geo.vertex_clusters_plain(vertices)
    B, P, _ = points.shape
    V, n = vertices.shape[1], boxes.shape[1]
    members = torch.clamp(V - geo.CLUSTER * torch.arange(n, device=points.device),
                          max=geo.CLUSTER)
    mn, mx = boxes[:, None, :, :3], boxes[:, None, :, 4:7]
    total = 0
    for p0 in range(0, P, chunk):
        p = points[:, p0:p0 + chunk, None, :]
        g = torch.clamp(torch.maximum(mn - p, p - mx), min=0.0)
        lb = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
        total += int(((lb <= best_d[:, p0:p0 + chunk, None]) * members).sum())
    return total


def nn_bounds(B, P, V, scanned, needed, nbytes):
    """K1's or K6's bound: the pairs these inputs need (``needed_pairs``) x
    9 FP32 operations, or its bytes; beside it the pairs the search scanned
    (the kernel's work) and the brute-force scan's bound."""
    bd = bound(9 * needed, nbytes, PEAK_F32)
    brute = bound(9 * B * P * V, nbytes, PEAK_F32)
    return dict(bd, needed_pairs=needed, needed_share=needed / (B * P * V),
                scanned_pairs=scanned, scanned_share=scanned / (B * P * V),
                brute_force_bound_ms=brute["bound_ms"])


def check_geo(inp, meta):
    """K1 against its plain version on the three sets of ``nn_sets`` (and the
    slice without its ray layout), two calls bit for bit, the scanned pairs,
    the cluster build's ms and bound."""
    import torch

    from threedhumangan_tpu_torch.ops import geo

    legacy = meta["legacy_mode"]
    nn_ptxas()
    res, first = {}, None
    sets = nn_sets(inp, meta)
    for case in sets + [dict(sets[0], name="slice without its ray layout", layout=None)]:
        args = (case["points"], case["vertices"], case["vfeat"], case["skeletons"])
        B, P, _ = case["points"].shape
        V = case["vertices"].shape[1]
        check_clusters(case["vertices"], case["name"])
        pairs = torch.zeros(1, dtype=torch.int64, device="cuda")
        feats, idx = geo._geo_cuda(*args, legacy, True, case["layout"], pairs)
        again = geo.geo_features(*args, legacy_mode=legacy, return_index=True,
                                 ray_layout=case["layout"])
        ref, ref_idx = geo.geo_features_plain(*args, legacy_mode=legacy, point_chunk=1024)
        torch.cuda.synchronize()
        agree = float((idx.long() == ref_idx).float().mean())
        mx, mean, _ = diff_stats(feats, ref)
        equal = torch.equal(feats, again[0]) and torch.equal(idx, again[1])
        share = int(pairs) / (B * P * V)
        ms = cuda_ms(lambda: geo.geo_features(*args, legacy_mode=legacy,
                                              ray_layout=case["layout"]), 5)
        log(f"check K1 geo, {case['name']}: {P} points x {V} vertices, layout {case['layout']}: "
            f"index agreement {agree * 100:.6f}%  max|d| {mx:.3e} mean|d| {mean:.3e}  two calls "
            f"{'bit-equal' if equal else 'DIFFER'}  scanned pairs {int(pairs)} = {share:.4f} of "
            f"P x V  kernel {ms:.3f} ms")
        if case["perm"] is not None:
            ref0 = geo.geo_features_plain(inp["points"], inp["vertices"], inp["vfeat"],
                                          inp["skeletons"], legacy_mode=legacy,
                                          point_chunk=1024)[1]
            back = float((case["perm"][idx.long()] == ref0).float().mean())
            log(f"  indices mapped back through the permutation: agreement with the unshuffled "
                f"plain version {back * 100:.6f}% (less only where distinct vertices tie)")
        if agree != 1.0 or mx > 1e-5 or not equal:
            raise AssertionError(f"K1 disagrees with its plain version ({case['name']})")
        res[case["name"]] = dict(index_agreement=agree, max_abs_err=mx, ms=ms,
                                 scanned_share=share)
        if first is None:
            first = dict(args=args, pairs=int(pairs), max_abs_err=mx, feats=feats, ms=ms)
    log("  tolerance: index agreement 100% and max|d| <= 1e-5 (the distance is formed with "
        "the same f32 op order in both, so the argmin is bit-identical; the features differ "
        "only by FMA contraction); the same output from two calls")
    args, slice_layout = first["args"], sets[0]["layout"]
    B, P, _ = args[0].shape
    V, Cf = args[2].shape[1:]
    if res["slice"]["scanned_share"] > 0.35:
        raise AssertionError(f"K1's search scanned {res['slice']['scanned_share']:.4f} of the "
                             "slice's pairs (at most 0.35)")
    build_ms = cuda_ms(lambda: geo.vertex_clusters(args[1]), 5)
    torch_build_ms = cuda_ms(lambda: geo.vertex_clusters_plain(args[1]), 5)
    plain_ms = cuda_ms(lambda: geo.geo_features_plain(*args, legacy_mode=legacy,
                                                      point_chunk=1024), 1)
    needed = needed_pairs(args[0], args[1], geo.nearest_vertex(args[0], args[1], 1024)[0])
    bd = nn_bounds(B, P, V, first["pairs"], needed,
                   4 * (B * P * (3 + 31 + 1) + B * V * (3 + Cf)))
    ms = first["ms"]
    shuffled_ms = res["slice, vertex order shuffled"]["ms"]
    log(f"  time (slice, its layout {slice_layout}): kernel {ms:.3f} ms, of which the cluster "
        f"build alone {build_ms:.3f} ms ({build_ms / ms * 100:.1f}%; its plain version on the "
        f"card {torch_build_ms:.3f} ms); shuffled vertices {shuffled_ms:.3f} ms "
        f"({(shuffled_ms / ms - 1) * 100:+.1f}%); plain {plain_ms:.3f} ms; bound "
        f"{bd['bound_ms']:.3f} ms ({bd['bound_by']}: {needed} pairs needed = "
        f"{bd['needed_share']:.4f} of P x V, x 9 FP32 operations; the search scanned "
        f"{first['pairs']} = {bd['scanned_share']:.4f}; brute force "
        f"{bd['brute_force_bound_ms']:.3f} ms)")
    return first["feats"], dict(max_abs_err=max(r["max_abs_err"] for r in res.values()), ms=ms,
                                plain_ms=plain_ms, build_ms=build_ms,
                                torch_build_ms=torch_build_ms, shuffled_ms=shuffled_ms,
                                sets=res, **bd)


def check_geo_train(meta, cond, gcuda):
    """K1 at the MAP3DBN training shapes (jittered rays, their layout)
    against its plain version, and its time."""
    import torch

    from threedhumangan_tpu_torch.models import volume_rendering as vr
    from threedhumangan_tpu_torch.ops import geo

    S, W, H = meta["num_steps"], meta["render_width"], meta["render_height"]
    B = cond["scales"].shape[0]
    pts_cam, z_vals, d_cam = vr.get_initial_rays_weak_perspective(
        cond["intrinsics"][:, 0, 0], cond["scales"].float(), S, (W, H), meta["ray_start"],
        meta["ray_end"])
    pts = vr.transform_sampled_points(pts_cam, z_vals, d_cam, cond["cam2world_matrices"], gcuda,
                                      True)[0].reshape(B, -1, 3).contiguous()
    vfeat = geo.build_vertex_features(cond["tpose_vertices"], cond["fk_matrices"],
                                      cond["lbs_weights"])
    args = (pts, cond["vertices"].float().contiguous(), vfeat,
            cond["skeletons_xyz"].float().contiguous())
    legacy = meta.get("legacy_mode", False)
    pairs = torch.zeros(1, dtype=torch.int64, device="cuda")
    feats, idx = geo._geo_cuda(*args, legacy, True, (W, S), pairs)
    ref, ref_idx = geo.geo_features_plain(*args, legacy_mode=legacy, point_chunk=1024)
    agree = float((idx.long() == ref_idx).float().mean())
    mx = diff_stats(feats, ref)[0]
    ms = cuda_ms(lambda: geo.geo_features(*args, legacy_mode=legacy, ray_layout=(W, S)), 5)
    P, V = pts.shape[1], args[1].shape[1]
    needed = needed_pairs(pts, args[1], geo.nearest_vertex(pts, args[1], 1024)[0])
    bd = nn_bounds(B, P, V, int(pairs), needed, 4 * (B * P * 35 + B * V * 22))
    log(f"check K1 geo, training shapes {tuple(pts.shape)} x {V} vertices, layout {(W, S)}: "
        f"index agreement {agree * 100:.6f}%  max|d| {mx:.3e}  scanned {bd['scanned_share']:.4f} "
        f"of P x V (needed {bd['needed_share']:.4f})  kernel {ms:.3f} ms  bound "
        f"{bd['bound_ms']:.3f} ms ({bd['bound_by']})")
    if agree != 1.0 or mx > 1e-5:
        raise AssertionError("K1 disagrees with its plain version at the training shapes")
    return dict(max_abs_err=mx, ms=ms, **bd)


def check_field(gen, inp, geo_feats, meta):
    import torch

    from threedhumangan_tpu_torch.models.siren import CoordConcatSiren
    from threedhumangan_tpu_torch.ops import raymarch as rm

    bf16 = torch.bfloat16
    S = meta["num_steps"]
    kw = dict(white_back=meta["white_back"], last_back=meta["last_back"])

    # narrow, exact sine: pointwise.  Both residual routings (the bench's
    # last_back=False, the sampler's True) and the noise column at the
    # slice's S; then S 4, 8, 16 and 64 (64 / S rays a CTA: a ray's rows
    # summed inside a warp's row groups, or across 2 or 4 warps)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    small = CoordConcatSiren(3, 32, 31, 32, 4, generator=torch.Generator().manual_seed(SEED + 1))
    small = small.cuda()
    Bn, Rn = 2, 256
    fr = 0.1 * torch.randn(Bn, 4 * 32, generator=g, device="cuda")
    ph = 0.1 * torch.randn(Bn, 4 * 32, generator=g, device="cuda")
    with torch.no_grad():
        sh, pi = rm.fold_film_tables(small, fr, ph, bf16)
    w_small, ft_small = rm.flat_weights(small), rm.film_tables(fr, ph, 4)
    cases = ((S, False, False), (S, True, False), (S, False, True), (4, False, True),
             (8, False, False), (16, True, True), (64, False, False))
    for Sn, last_back, noise in cases:
        # 37 columns, or 38 with the nerf-noise column of the training path
        pk = torch.randn(Bn, Rn * Sn, rm.INPUT_PACK + noise, generator=g, device="cuda") * 0.5
        pk[..., 34:37] = (pk.view(Bn, Rn, Sn, -1)[:, :, :1, 34:37].expand(Bn, Rn, Sn, 3)
                          .reshape(Bn, Rn * Sn, 3))
        zv = torch.sort(torch.rand(Bn, Rn, Sn, generator=g, device="cuda") + 1.0, -1).values
        nkw = dict(white_back=meta["white_back"], last_back=last_back)
        o_k, d_k = rm.field_render_cuda(w_small, ft_small, pk, zv, Sn, exact_sin=True, **nkw)
        o_p, d_p = rm.field_render_plain(sh, pi, pk, zv, Sn, compute_dtype=bf16, exact_sin=True,
                                         **nkw)
        mx, mean, p99 = diff_stats(torch.cat([o_k, d_k], -1), torch.cat([o_p, d_p], -1))
        log(f"check K2 field narrow (hidden 32, exact sin, bf16 operands, S {Sn}, last_back "
            f"{last_back}, noise {noise}): max|d| {mx:.3e} mean|d| {mean:.3e} p99|d| {p99:.3e}")
        log("  tolerance: max|d| <= 5e-3, mean|d| <= 1e-5 (f32 sums in another order flip "
            "occasional bf16 roundings of activations, which the omega-30 SIREN amplifies)")
        if mx > 5e-3 or mean > 1e-5:
            raise AssertionError("K2 (narrow) disagrees with its plain version")

    # full width, the slice's inputs and weights: statistics
    packed = rm.pack_field_inputs(inp["points"], geo_feats, inp["dirs"],
                                  2.0 / meta["side_length"]).to(bf16).contiguous()
    field = gen.neural_field
    with torch.no_grad():
        sh, pi = rm.fold_film_tables(field, inp["freq"], inp["phase"], bf16)
    w, ft = rm.flat_weights(field), rm.film_tables(inp["freq"], inp["phase"], len(field.network))
    exact = not meta["fast_math"]
    run_k = lambda: rm.field_render_cuda(w, ft, packed, inp["z_vals"], S, exact_sin=exact, **kw)
    run_p = lambda: rm.field_render_plain(sh, pi, packed, inp["z_vals"], S, compute_dtype=bf16,
                                          exact_sin=exact, **kw)
    o_k, d_k = run_k()
    o_p, d_p = run_p()
    mx, mean, p99 = diff_stats(o_k, o_p)
    dmx, dmean, dp99 = diff_stats(d_k, d_p)
    log(f"check K2 field full width {tuple(o_k.shape)}: map max|d| {mx:.3e} mean|d| {mean:.3e} "
        f"p99|d| {p99:.3e}; depth max|d| {dmx:.3e} mean|d| {dmean:.3e}")
    log("  tolerance: map mean|d| <= 2e-3 and p99|d| <= 5e-3, depth mean|d| <= 1e-4 "
        "(statistical: at width 420 a few samples flip far, see above)")
    if mean > 2e-3 or p99 > 5e-3 or dmean > 1e-4:
        raise AssertionError("K2 (full width) disagrees with its plain version")
    o_2, d_2 = run_k()
    if not (torch.equal(o_k, o_2) and torch.equal(d_k, d_2)):
        raise AssertionError("two K2 calls on the same inputs differ")
    log("  two K2 calls on the same inputs: bit-equal (every sum in a fixed order)")
    ms = cuda_ms(run_k, 3)
    plain_ms = cuda_ms(run_p, 1)
    bd = field_bound(packed, o_k, meta, backward=0)
    log(f"  time: kernel {ms:.3f} ms (with its weight pack)  plain {plain_ms:.3f} ms  bound "
        f"{bd['bound_ms']:.3f} ms ({bd['bound_by']})")
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms, **bd,
                **k2_layer_metrics(w, ft, packed, S))


def k2_layer_metrics(w, ft, packed, S):
    """K2's layer metrics at one shape: ``pack_field_stream`` alone (inside
    the kernel's time), the ``ptxas`` line, the shared memory a CTA and the
    ring as the C entry sizes them, and the L2 stream (every 64-row CTA
    reads its image's whole stream)."""
    import ctypes

    from threedhumangan_tpu_torch import _build
    from threedhumangan_tpu_torch.ops import raymarch as rm

    B, P, _ = packed.shape
    freq_k = ft[0]
    d = rm.field_dims(3 + w["w_geo"].shape[0], freq_k.shape[2], w["w_feat"].shape[1],
                      freq_k.shape[1])
    _, sizes = rm.pack_field_stream(w, freq_k)
    ring = (ctypes.c_int * 2)()
    smem = _build.library().thgt_raymarch_smem(d["k0p"], d["n0p"], d["hp"], d["nc"], d["headp"],
                                               ctypes.cast(ring, ctypes.c_void_p))
    l2 = B * (P // rm.ROWS_PER_CTA) * sum(sizes)
    m = dict(pack_ms=cuda_ms(lambda: rm.pack_field_stream(w, freq_k), 3),
             stream_bytes_per_image=sum(sizes), ring_stages=ring[0], stage_bytes=ring[1],
             smem_bytes=smem, l2_stream_gb=l2 / 1e9, **ptxas_of("raymarch.cu"))
    log(f"  pack_field_stream alone (each call, inside the kernel's time above): "
        f"{m['pack_ms']:.3f} ms; ptxas: {m['registers']} registers, {m['spill_stores']} bytes "
        f"spill stores, {m['spill_loads']} bytes spill loads")
    log(f"  shared memory a CTA (the C entry's): {smem} bytes, weight ring {ring[0]} stages of "
        f"{ring[1]} bytes; L2 stream {m['l2_stream_gb']:.2f} GB a call (S {S}), "
        f"{l2 / 7e12 * 1e3:.3f}-{l2 / 5e12 * 1e3:.3f} ms at an assumed 7-5 TB/s of L2 reads "
        f"(an estimate: the L2 rate is not measured here)")
    return m


def field_bound(packed, out, meta, backward):
    """Bound of a field pass over ``packed`` samples: K2 (backward 0: the
    render), K8 (1: the recompute) or K9 (2: recompute, backprop and weight
    products, 3x the forward's), products in bf16."""
    H, NB, F = meta["hidden_dim"], meta["neural_field_blocks"], meta["feature_dim"]
    n_in = 3 + meta["geo_feature_dim"]
    samples = packed.shape[0] * packed.shape[1]
    per = 2 * (n_in * H + 2 * H * H + (NB - 1) * H * H + (H + 3) * H + H + H * (3 + F))
    nbytes = packed.numel() * packed.element_size() + out.numel() * out.element_size()
    if backward:
        nbytes += 8 * samples  # (sigma, f.g) out of K8, (coef, dsigma) into K9
    return bound(per * samples * (3 if backward == 2 else 1), nbytes)


def check_synthesis(gen, meta, styles, gcuda):
    import torch

    from threedhumangan_tpu_torch.models import synthesis as syn
    from threedhumangan_tpu_torch.ops import synthesis_kernel as sk
    from threedhumangan_tpu_torch.utils.misc import round16

    bf16 = torch.bfloat16
    NB, mods, mode = meta["synthesis_blocks"], tuple(meta["mod_blocks"]), meta["map3d_mode"]

    # narrow: pointwise, in every map3d mode (the slice runs "isolated"); hidden
    # 200 (hp 208) leaves ragged column runs: 26 n8 tiles a conv and 13
    # gamma/beta units a pass over the kernel's 3 consumer warpgroups, so
    # both the 72-column and the 8-column wgmma run
    for hidden in (32, 200):
        for narrow_mode in ("isolated", "mixed", "all"):
            g = torch.Generator(device="cuda").manual_seed(SEED + 2)
            net = syn.SynthesisNetwork(hidden, hidden, hidden, NB, mods, "batch_norm",
                                       narrow_mode)
            net.reset_parameters(torch.Generator().manual_seed(SEED + 2))
            sin_ = syn.SynthesisInput(2, hidden)
            sin_.reset_parameters(torch.Generator().manual_seed(SEED + 3))
            net, sin_ = net.cuda(), sin_.cuda()
            with torch.no_grad():
                for m in net.modules():
                    if isinstance(m, torch.nn.BatchNorm2d):
                        n = m.running_mean.shape
                        m.running_mean.copy_(0.1 * torch.randn(n, generator=g, device="cuda"))
                        m.running_var.copy_(1.0 + 0.2 * torch.rand(n, generator=g,
                                                                      device="cuda"))
                folded = sk.fold_synthesis_params(net, sin_, "batch_norm")
            st = torch.randn(2, 32, 64, hidden, generator=g, device="cuda").to(bf16)
            fx = torch.randn(2, 1, hidden, generator=g, device="cuda")
            r_k = sk.synthesis_cuda(folded, st, fx, NB, mods, narrow_mode)
            r_p = sk.synthesis_plain(folded, st, fx, NB, mods, narrow_mode, bf16)
            mx, mean, p99 = diff_stats(r_k, r_p)
            log(f"check K3 synthesis narrow (hidden {hidden}, {narrow_mode}): max|d| {mx:.3e} "
                f"mean|d| {mean:.3e} p99|d| {p99:.3e} "
                f"(rgb mean|x| {float(r_p.abs().mean()):.3e})")
            log("  tolerance: max|d| <= 2e-2, mean|d| <= 1e-4 (bf16 activations; f32 sums in "
                "another order flip occasional bf16 roundings)")
            if mx > 2e-2 or mean > 1e-4:
                raise AssertionError(f"K3 (narrow, hidden {hidden}, {narrow_mode}) disagrees "
                                     "with its plain version")

    # full width, the slice's weights and shapes: statistics
    with torch.no_grad():
        folded = sk.fold_synthesis_params(gen.synthesis_network, gen.synthesis_input,
                                          meta["spatial_normalization"])
    style = torch.randn(BATCH, meta["gen_height"], meta["gen_width"], meta["feature_dim"],
                        generator=gcuda, device="cuda").to(bf16)
    run_k = lambda: sk.synthesis_cuda(folded, style, styles, NB, mods, mode)
    run_p = lambda: sk.synthesis_plain(folded, style, styles, NB, mods, mode, bf16,
                                       pixel_chunk=32768)
    r_k, r_p = run_k(), run_p()
    mx, mean, p99 = diff_stats(r_k, r_p)
    log(f"check K3 synthesis full width {tuple(r_k.shape)}: max|d| {mx:.3e} mean|d| {mean:.3e} "
        f"p99|d| {p99:.3e} (rgb mean|x| {float(r_p.abs().mean()):.3e})")
    log("  tolerance: mean|d| <= 3e-3 and p99|d| <= 2e-2 (statistical, bf16 activations "
        "through 18 convs of width 420)")
    if mean > 3e-3 or p99 > 2e-2:
        raise AssertionError("K3 (full width) disagrees with its plain version")
    ms = cuda_ms(run_k, 3)
    plain_ms = cuda_ms(run_p, 1)
    bd = synthesis_bound(meta, style, r_k)
    log(f"  time: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']})")
    hp = round16(meta["hidden_dim"])
    rank1 = sk.rank1_blocks_of(NB, mods, mode)
    pack = lambda: sk.pack_weight_stream(folded, NB, [i for i in range(NB) if i not in rank1],
                                         hp, hp)
    _, sizes = pack()
    ring = dict(ring_stages=sk.RING_STAGES, chunk_bytes=sorted(set(sizes)),
                stream_bytes=sum(sizes), pack_ms=cuda_ms(pack, 3), **ptxas_of("synthesis.cu"))
    log(f"  weight ring: {ring['ring_stages']} stages, chunks of {ring['chunk_bytes']} bytes, "
        f"{ring['stream_bytes']} bytes a 64-pixel tile; ptxas: {ring['registers']} registers, "
        f"{ring['spill_stores']} bytes spill stores, {ring['spill_loads']} bytes spill loads")
    log(f"  pack_weight_stream alone (each synthesis_cuda call, inside the kernel's time "
        f"above): {ring['pack_ms']:.3f} ms")
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms, **bd, **ring)


def synthesis_bound(meta, style, out):
    """K3's bound on a style map (B, H, W, F) and its rgb out: the products
    of every block, SPADE head and ToRGB a pixel in bf16, or the bytes."""
    NB, mods, mode = meta["synthesis_blocks"], meta["mod_blocks"], meta["map3d_mode"]
    H, F = meta["hidden_dim"], meta["feature_dim"]
    n_mod = NB if mode == "all" else len(mods)
    per_px = 2 * (2 * H + NB * 2 * H * H + n_mod * 2 * (F * 128 + 2 * 128 * H)
                  + (NB - NB // 2 + 1) * 3 * H)
    return bound(per_px * style.shape[0] * style.shape[1] * style.shape[2],
                 style.numel() * style.element_size() + out.numel() * out.element_size())


def ptxas_of(source):
    """Registers and spill bytes that ``ptxas -v`` reported for the kernels of
    one csrc source, and its count of warnings that it serialized ``wgmma``
    (C7510-C7519), in the build log of the loaded library (the most over
    its kernels; the log is kept beside the library under the same source
    hash); None when that log is missing."""
    from threedhumangan_tpu_torch import _build

    out = dict(registers=None, spill_stores=None, spill_loads=None, wgmma_serialized=None)
    path = _build.BUILD_INFO.get("log")
    if not path:
        return out
    with open(path) as f:
        sections = f.read().split("\n" + _build._nvcc())
    for sec in sections:
        if not sec.split("\n", 1)[0].rstrip().endswith("/" + source):
            continue
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", sec)]
        st = [int(x) for x in re.findall(r"(\d+) bytes spill stores", sec)]
        ld = [int(x) for x in re.findall(r"(\d+) bytes spill loads", sec)]
        out.update(registers=max(regs, default=None), spill_stores=max(st, default=None),
                   spill_loads=max(ld, default=None),
                   wgmma_serialized=len(re.findall(r"\(C751\d\)", sec)))
    return out


def run_generation(gen, pre, batch, z0, meta, gen_rng, label, need, forbid):
    """WARMUP + TIMED batches through ``generator_forward`` with the counts
    set to 0 just before and read just after: per-stage ms, imgs/s, peak
    memory; the output must be (8, 512, 256, 3), finite and not constant,
    every kernel of ``need`` must launch and none of ``forbid``."""
    import torch

    from threedhumangan_tpu_torch.models.generator import generator_forward

    timer = StageTimer()
    reset_counts()
    walls = []
    for it in range(WARMUP + TIMED):
        timer.on = it >= WARMUP
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer.stage("conditions"):
            cond = pre(batch, rotate=True, generator=gen_rng)
        out = generator_forward(gen, z0 + 0.01 * it, cond, meta, gen_rng,
                                compute_dtype=torch.bfloat16, stage=timer.stage)
        torch.cuda.synchronize()
        if timer.on:
            walls.append(time.perf_counter() - t0)
    counts = read_counts()
    stage_ms = timer.mean_ms()
    rgbs = out["rgbs"]
    log(f"{label}: MAP3DBN512L batch {BATCH} bf16, {TIMED} timed batches after {WARMUP} warm-up")
    for k in ("conditions", "mapping", "rays", "geo", "field", "resize", "synthesis"):
        log(f"  stage {k:<10} {stage_ms[k]:9.3f} ms/batch")
    total = sum(walls) / len(walls)
    log(f"  total {total * 1e3:.3f} ms/batch (host clock)  {BATCH / total:.3f} imgs/s  "
        f"stage sum {sum(v for k, v in stage_ms.items() if k != 'd_r1'):.3f} ms")
    log(f"  launches during the slice: {counts}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak memory {peak:.2f} GiB")
    if tuple(rgbs.shape) != (BATCH, meta["gen_height"], meta["gen_width"], 3):
        raise AssertionError(f"bad output shape {tuple(rgbs.shape)}")
    if not torch.isfinite(rgbs).all() or not torch.isfinite(out["rgbs_render"]).all():
        raise AssertionError("non-finite output")
    if float(rgbs.float().std()) <= 0.0:
        raise AssertionError("constant output")
    if min(counts[k] for k in need) <= 0:
        raise AssertionError(f"a kernel did not launch during the slice: {counts}")
    if any(counts[k] for k in forbid):
        raise AssertionError(f"the slice launched a kernel its selection replaces: {counts}")
    log(f"  output {tuple(rgbs.shape)} mean {float(rgbs.mean()):.4f} std {float(rgbs.std()):.4f}")
    return dict(counts=counts, ms_per_batch=total * 1e3, imgs_per_s=BATCH / total,
                stage_ms=stage_ms, peak_gib=peak)


def check_small_config(flags=None, sigma_bias=None):
    """A small legacy/isolated config through generator_forward on the card
    (kernels) and on the CPU (plain versions), same weights and inputs.
    ``flags`` select the generator's kernels.  ``sigma_bias`` (0.5) sets the
    field's density bias: at these random weights every density otherwise
    sits below the clamp and the render is the empty background on both
    devices (as it is in the call with neither, kept as it was)."""
    import torch

    from threedhumangan_tpu_torch import configs
    from threedhumangan_tpu_torch.data.dataset import (
        SyntheticSHHQDataset, iterate_batches, to_tensors)
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.generator import generator_forward, init_generator
    from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model

    meta = dict(configs.extract_metadata(configs.MAP3DBN_TINY, 0))
    meta.update(nerf_noise=0, perturb_rays=False, legacy_mode=True, map3d_mode="isolated",
                **(flags or {}))
    smpl = synthetic_smpl_model(num_verts=384, num_faces=512)
    batch = next(iterate_batches(SyntheticSHHQDataset(smpl_model=smpl, **meta), 2, shuffle=False))
    z = torch.randn(2, meta["latent_dim"], generator=torch.Generator().manual_seed(SEED))
    outs = {}
    for dev in ("cuda", "cpu"):
        gen = init_generator(meta, torch.Generator().manual_seed(SEED), dev)
        if sigma_bias is not None:
            with torch.no_grad():
                gen.neural_field.sigma_layer.bias.fill_(sigma_bias)
        cond = get_preprocessor(meta).forward_with_rotation(
            to_tensors(batch, dev), *(torch.zeros(2, device=dev),) * 3)
        outs[dev] = generator_forward(gen, z.to(dev), cond, meta, compute_dtype=torch.bfloat16)
    res = {}
    for k in ("rgbs_render", "rgbs"):
        mx, mean, _ = diff_stats(outs["cuda"][k].cpu(), outs["cpu"][k])
        res[k] = (mx, mean)
    extra = (f", {flags}" if flags else "") + (
        f", density bias {sigma_bias:g}" if sigma_bias is not None else "")
    log(f"check small config (TINY, legacy, isolated, bf16{extra}) card vs CPU plain: "
        f"rgbs_render max|d| {res['rgbs_render'][0]:.3e} mean|d| {res['rgbs_render'][1]:.3e}; "
        f"rgbs max|d| {res['rgbs'][0]:.3e} mean|d| {res['rgbs'][1]:.3e}")
    log("  tolerance: mean|d| <= 2e-2 for both (bf16 end to end, see the kernel checks)")
    if res["rgbs_render"][1] > 2e-2 or res["rgbs"][1] > 2e-2:
        raise AssertionError("the card disagrees with the CPU plain path")


class PairTimer(StageTimer):
    """CUDA-event timer for the trainer's ``stage`` hook: ms per pair step."""

    def per_pair_ms(self, pairs):
        import torch

        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / pairs for k, v in self.events.items()}


class PreprocessSplit:
    """The trainer's preprocess stage in four parts, by CUDA events, summed
    over a pair's D and G calls: camera (the camera math and the projection),
    binning (``bin_candidates``, which the CUDA path no longer runs: K7 bins
    on the card), K7 (its pre-pass included) and post (argmax, gathers,
    labels).  Stands in for the preprocessor; while ``patched``, the
    rasterizer's binning and K7 entry record their own events."""

    PARTS = ("camera", "binning", "K7", "post")

    def __init__(self, pre):
        self.pre = pre
        self.on = False
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.pre, name)

    def _event(self, key):
        import torch

        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.calls[-1][key] = e

    def _timed(self, fn, *args):
        if self.on:
            self.calls.append({})
        self._event("start")
        out = fn(*args)
        self._event("end")
        return out

    def __call__(self, data, rotate, generator):
        return self._timed(self.pre, data, rotate, generator)

    def forward_with_rotation(self, data, h, v, r):
        return self._timed(self.pre.forward_with_rotation, data, h, v, r)

    @contextlib.contextmanager
    def patched(self):
        from threedhumangan_tpu_torch.ops import rasterize as ras

        def wrap(fn, before, after):
            def run(*args, **kw):
                self._event(before)
                out = fn(*args, **kw)
                self._event(after)
                return out
            return run

        saved = ras.bin_candidates, ras.rasterize_mesh_cuda
        ras.bin_candidates = wrap(saved[0], "bin0", "bin1")
        ras.rasterize_mesh_cuda = wrap(saved[1], "k0", "k1")
        try:
            yield self
        finally:
            ras.bin_candidates, ras.rasterize_mesh_cuda = saved

    def per_pair_ms(self, pairs):
        import torch

        torch.cuda.synchronize()
        ms = dict.fromkeys(self.PARTS, 0.0)
        for c in self.calls:
            bin0, bin1 = c.get("bin0", c["k0"]), c.get("bin1", c["k0"])
            for part, (a, b) in zip(self.PARTS, ((c["start"], bin0), (bin0, bin1),
                                                 (c["k0"], c["k1"]), (c["k1"], c["end"]))):
                ms[part] += a.elapsed_time(b) / pairs
        return ms


def count_syncs(fn):
    """Synchronizing CUDA calls that ``torch.cuda.set_sync_debug_mode``
    reports during fn(), and the lines that made them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = sorted({f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message)})
    return sum("synchroniz" in str(w.message) for w in caught), where


def check_preprocess_syncs(tpre, tbatch, tmeta, gen):
    """Synchronizing calls of one preprocess call: the camera half (the same
    preprocessor without faces) and ``_forward_rasterize``, which must make
    none: it runs once more under ``set_sync_debug_mode('error')``."""
    import torch

    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor

    cam = get_preprocessor(tmeta)
    cond = cam(tbatch, rotate=True, generator=gen)
    tpre._forward_rasterize(cond)  # the first call per device may copy the faces
    torch.cuda.synchronize()
    n_none, at_none = count_syncs(lambda: None)  # the instrument's own first use
    n_cam, at_cam = count_syncs(lambda: cam(tbatch, rotate=True, generator=gen))
    n_ras, at_ras = count_syncs(lambda: tpre._forward_rasterize(cond))
    log(f"preprocess: synchronizing calls in one call (torch.cuda.set_sync_debug_mode): camera "
        f"half {n_cam} {at_cam}, _forward_rasterize {n_ras} {at_ras}; an empty call first "
        f"{n_none} {at_none}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        tpre._forward_rasterize(cond)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("  _forward_rasterize ran under set_sync_debug_mode('error')")
    if n_ras:
        raise AssertionError(f"_forward_rasterize synchronizes: {at_ras}")
    return dict(camera=n_cam, rasterize=n_ras, empty=n_none)


def train_meta():
    from threedhumangan_tpu_torch import configs

    meta = dict(configs.extract_metadata(configs.MAP3DBN, 0))
    meta.update(dataset_length=BATCH)
    return meta


# published dense peaks of one H100 SXM at 700 W (NVIDIA H100 datasheet)
PEAK_BF16 = 989e12  # FLOP/s, bf16 tensor cores
PEAK_F32 = 67e12    # FLOP/s, float32 outside the tensor cores
HBM_BPS = 3.35e12   # bytes/s


def bound(flops, nbytes, peak=PEAK_BF16):
    """Least time (ms) for the work: operations over the peak of their type
    or bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def rel_l2(got, ref):
    import torch

    got, ref = got.float(), ref.float()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite values in a kernel/plain comparison")
    return float((got - ref).norm() / (ref.norm() + 1e-30))


def raster_adversarial(size, tile, B=2):
    """A mesh for K7's corner cases, per image: 2,000 slivers (rounded denom
    in (1e-9, 1e-6]) along pixel rows and columns, 1,000 triangles with
    their corners on pixel centres (edges through further centres), and one
    triangle 2,100 times with equal z (the lowest index wins, across the
    kernel's 1,024-row chunks, and the cap binds); nothing reaches the
    last tile column, so its tiles are empty.  (verts (B, 3 F, 3), faces
    (F, 3)) on the card."""
    import numpy as np
    import torch

    from threedhumangan_tpu_torch.ops import rasterize as ras

    H, W = size
    tiles_y, tiles_x, x_step, y_step, span = ras._grid(size, tile)
    f32 = np.float32
    cols, rows = np.arange(W), np.arange(H)
    px = (f32(-span) + f32((cols // tile) * tile) * x_step) + f32(cols % tile) * x_step
    py = (f32(-1.0) + f32((rows // tile) * tile) * y_step) + f32(rows % tile) * y_step
    last = (tiles_x - 1) * tile - 2  # the columns left of the last tile column
    images = []
    for b in range(B):
        rs = np.random.RandomState(SEED + 20 + b)
        tris = []
        while len(tris) < 2000:
            a = np.asarray([px[rs.randint(last // 2)], py[rs.randint(H)]], f32)
            L = f32(rs.uniform(0.05, 0.4))
            h = f32(10 ** rs.uniform(-8.7, -5.7) / L * rs.choice([-1, 1]))
            t = f32(rs.uniform())
            b_, c_ = ((a + [L, 0], a + [t * L, h]) if rs.rand() < 0.5
                      else (a + [0, L], a + [h, t * L]))
            tri = np.stack([a, b_, c_]).astype(f32)
            v0, v1 = tri[1] - tri[0], tri[2] - tri[0]
            denom = f32(v0[0] * v1[1]) - f32(v0[1] * v1[0])
            if 1e-9 < abs(denom) <= 1e-6 and tri[:, 0].max() < px[last]:
                tris.append(np.concatenate([tri, rs.uniform(1, 2, (3, 1))], 1))
        for _ in range(1000):
            i, j = rs.randint(0, last - 16), rs.randint(0, H - 16)
            di, dj = rs.randint(1, 16, 2)
            corners = [(i, j), (i + di, j), (i, j + dj), (i + di, j + dj)]
            tris.append([[px[x], py[y], 1.0 + rs.rand()]
                         for x, y in (corners[k] for k in rs.permutation(4)[:3])])
        dup = [[px[2], py[2], 1.5], [px[last], py[H // 2], 1.5], [px[2], py[H - 3], 1.5]]
        tris += [dup] * 2100
        images.append(np.asarray(tris, f32).reshape(-1, 3))
    F = len(images[0]) // 3
    return (torch.as_tensor(np.stack(images), device="cuda"),
            torch.arange(3 * F, device="cuda").reshape(F, 3))


def raster_needed_pairs(verts, faces, size, tile, K):
    """The (pixel, candidate) pairs these inputs need of K7: for each tile's
    valid candidates within the cap, the tile's pixels whose centre lies
    inside the candidate's bounding box; and all (pixel, valid candidate)
    pairs."""
    import torch

    from threedhumangan_tpu_torch.ops import rasterize as ras

    tri = ras.bin_candidates(verts, faces, size, tile, K)
    T = tri.shape[1]
    _, tiles_x, x_step, y_step, span = ras._grid(size, tile)
    f32, dev = torch.float32, verts.device
    t, i = torch.arange(T, device=dev)[:, None], torch.arange(tile, device=dev)[None]
    x0 = -span + ((t % tiles_x) * tile).to(f32) * float(x_step)
    y0 = -1.0 + ((t // tiles_x) * tile).to(f32) * float(y_step)
    px, py = x0 + i.to(f32) * float(x_step), y0 + i.to(f32) * float(y_step)  # (T, tile)
    xs, ys = tri[..., 0:9:3], tri[..., 1:9:3]
    inside = lambda c, lo, hi: ((c[None, :, None] >= lo[..., None])
                                & (c[None, :, None] <= hi[..., None])).sum(-1)
    nx = inside(px, xs.amin(-1), xs.amax(-1))
    ny = inside(py, ys.amin(-1), ys.amax(-1))
    valid = tri[..., 9] > 0
    return int((nx * ny * valid).sum()), int(valid.sum()) * tile * tile


def check_raster(pre, cond, meta):
    """K7 (its bin pre-pass and z-test) against its plain version
    (``bin_candidates`` + ``rasterize_tiles_plain``), bit for bit: on the
    training slice's inputs, with the cap at 256 faces a tile, and on
    ``raster_adversarial``; two calls bit for bit; its ptxas line (a spill
    fails); its time, the plain version's (and its binning's alone), the
    recounted bound and the share of (pixel, valid candidate) pairs it
    tested.  Returns them and a function that takes the device ms of each
    of its two launches (torch.profiler) on the same inputs: the caller runs
    it last, since once used the profiler may slow every later host-bound
    launch."""
    import torch

    from threedhumangan_tpu_torch.ops import rasterize as ras

    size, tile = (meta["gen_height"], meta["gen_width"]), pre.raster_tile
    verts, faces = pre.screen_vertices(cond), pre.faces.cuda()
    F = faces.shape[0]
    kcap = lambda kmax, F: -(-min(kmax, F) // 128) * 128
    kernel = lambda v, f, size, K, pairs=None: ras.rasterize_mesh_cuda(v, f, size, tile, K, pairs)
    plain = lambda v, f, size, K: ras.rasterize_mesh_plain(v, f, size, tile, K)
    adv_v, adv_f = raster_adversarial(size, tile)
    cases = [("training slice", verts, faces, kcap(pre.raster_faces_per_tile, F)),
             ("cap 256", verts, faces, kcap(256, F)),
             ("adversarial", adv_v, adv_f, kcap(pre.raster_faces_per_tile, adv_f.shape[0]))]
    log("  tolerance: 100% face-id agreement and bary/z max|d| == 0 (the kernel rounds every "
        "step in the plain version's op order, skips only candidates that a bound under that "
        "rounding rules out, and the lowest candidate row wins z ties)")
    bad, worst = [], 0.0
    for name, v, f, K in cases:
        (fk, bk, zk), (fp, bp, zp) = kernel(v, f, size, K), plain(v, f, size, K)
        torch.cuda.synchronize()
        agree = float((fk == fp).float().mean())
        bmx, zmx = float((bk - bp).abs().max()), float((zk - zp).abs().max())
        log(f"check K7 rasterizer, {name}: {tuple(v.shape)} vertices, {f.shape[0]} faces, K "
            f"{K}: face-id agreement {agree * 100:.6f}% (coverage "
            f"{float((fp >= 0).float().mean()) * 100:.2f}%), bary max|d| {bmx:.3e}, z max|d| "
            f"{zmx:.3e}")
        if name == "adversarial":
            T = ras._grid(size, tile)[0] * ras._grid(size, tile)[1]
            tri = ras.bin_candidates(v, f, size, tile, K)
            empty = int(((tri[..., 9] > 0).sum(-1) == 0).sum())
            log(f"  adversarial: {empty} of {v.shape[0] * T} tiles empty, the cap binds on "
                f"{int(((tri[..., 9] > 0).sum(-1) == K).sum())}")
            if not empty:
                raise AssertionError("the adversarial mesh has no empty tile")
        worst = max(worst, bmx, zmx)
        if agree != 1.0 or bmx > 0 or zmx > 0:
            bad.append(name)
    K = cases[0][3]
    a, b = kernel(verts, faces, size, K), kernel(verts, faces, size, K)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    log(f"  two K7 calls bit-equal: {same}")
    if bad or not same:
        raise AssertionError(f"K7 disagrees with its plain version: {bad}, two calls equal {same}")
    ptx = ptxas_of("rasterize.cu")
    log(f"  rasterize.cu ptxas: {ptx['registers']} registers, {ptx['spill_stores']} bytes spill "
        f"stores, {ptx['spill_loads']} bytes spill loads")
    if ptx["spill_stores"] is None or ptx["spill_stores"] or ptx["spill_loads"]:
        raise AssertionError(f"rasterize.cu spills, or no build log: {ptx}")
    pairs = torch.zeros(1, dtype=torch.int64, device="cuda")
    kernel(verts, faces, size, K, pairs)
    needed, valid_pairs = raster_needed_pairs(verts, faces, size, tile, K)
    tested = int(pairs.item())
    bin_ms = cuda_ms(lambda: ras.bin_candidates(verts, faces, size, tile, K), 5)
    ms = cuda_ms(lambda: kernel(verts, faces, size, K), 5)
    plain_ms = cuda_ms(lambda: plain(verts, faces, size, K), 1)
    B, V = verts.shape[:2]
    # ~20 float32 operations a needed (pixel, candidate) pair; the bytes are
    # the vertices, the faces and 20 bytes a pixel out
    bd = bound(20 * needed, B * V * 12 + F * 3 * 8 + B * size[0] * size[1] * 20, PEAK_F32)
    log(f"  time: kernel {ms:.4f} ms a call, its pre-pass included (CUDA events; the device time "
        f"of each launch is taken at the end of the run)  plain {plain_ms:.3f} ms (its binning, "
        f"bin_candidates, alone {bin_ms:.3f} ms)  bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']})")
    log(f"  (pixel, candidate) pairs: needed {needed} ({needed / valid_pairs * 100:.2f}% of the "
        f"{valid_pairs} (pixel, valid candidate) pairs), tested {tested} "
        f"({tested / valid_pairs * 100:.2f}%)")

    def device_times():
        dev = device_ms(lambda: kernel(verts, faces, size, K), ("bins_kernel", "rasterize_kernel"))
        shown = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        log(f"K7 device time a call (torch.profiler, after every timed phase): bin pre-pass "
            f"{shown(dev['bins_kernel'])}, z-test {shown(dev['rasterize_kernel'])}")
        return dict(prepass_device_ms=dev["bins_kernel"], ztest_device_ms=dev["rasterize_kernel"])

    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                plain_binning_ms=bin_ms, needed_pairs=needed,
                valid_pairs=valid_pairs, tested_pairs=tested,
                tested_share=tested / valid_pairs, **bd), device_times


def _random_field_case(H, NB, noise, gcuda, B=2, R=256, S=32, F=24):
    import torch

    from threedhumangan_tpu_torch.models.siren import CoordConcatSiren

    field = CoordConcatSiren(3, H, 31, F, NB, generator=torch.Generator().manual_seed(SEED + H))
    with torch.no_grad():  # a positive density, or a random field may sit below the clamp
        field.sigma_layer.bias.fill_(0.5)
    pk = torch.randn(B, R * S, 37 + noise, generator=gcuda, device="cuda") * 0.5
    pk[..., 34:37] = pk.view(B, R, S, -1)[:, :, :1, 34:37].expand(B, R, S, 3).reshape(B, R * S, 3)
    zv = torch.sort(torch.rand(B, R, S, generator=gcuda, device="cuda") + 1.0, -1).values
    fr = 0.1 * torch.randn(B, NB * H, generator=gcuda, device="cuda")
    ph = 0.1 * torch.randn(B, NB * H, generator=gcuda, device="cuda")
    go = torch.randn(B, R, F + 3, generator=gcuda, device="cuda")
    gd = torch.randn(B, R, 1, generator=gcuda, device="cuda")
    return field.cuda(), pk.to(torch.bfloat16), zv, fr, ph, go, gd


def _bwd_compare(w, pk, fr, ph, zv, go, gd, S, white_back, last_back, exact):
    """Kernel K8/K9 against their plain versions on the same tables."""
    import torch

    from threedhumangan_tpu_torch.ops import raymarch_bwd as rb

    bf16 = torch.bfloat16
    NB = sum(k.startswith("w_net") for k in w)
    fk, pk_ = rb.film_tables(fr, ph, NB)
    sk, gk = rb.field_stats_cuda(w, pk, fk, pk_, go, S, exact_sin=exact)
    sp, gp = rb.field_stats_plain(w, pk, fk, pk_, go, S, compute_dtype=bf16, exact_sin=exact)
    coef, dsig = rb.backward_tables(sp, gp, zv, go, gd, white_back, last_back)
    gr_k, df_k, dp_k = rb.field_bwd_step_cuda(w, pk, fk, pk_, go, coef, dsig, S, exact_sin=exact)
    gr_p, df_p, dp_p = rb.field_bwd_step_plain(w, pk, fk, pk_, go, coef, dsig, S,
                                               compute_dtype=bf16, exact_sin=exact)
    torch.cuda.synchronize()
    errs = {k: rel_l2(gr_k[k], gr_p[k]) for k in gr_p}
    errs["freq"], errs["phase"] = rel_l2(df_k, df_p), rel_l2(dp_k, dp_p)
    smx = float((sk - sp).abs().max())
    gmx = float((gk - gp).abs().max())
    k9mx = max(float((gr_k[k] - gr_p[k]).abs().max()) for k in gr_p)
    return smx, gmx, errs, k9mx, (fk, pk_, coef, dsig)


def train_field_inputs(G, meta, cond, gcuda):
    """The training slice's field inputs, drawn from ``gcuda``: freq/phase
    of fresh latents, jittered rays, K1 geo features, directions and nerf
    noise 0.5.  Returns (freq, phase, points, z_vals (B, R, S), geo, dirs,
    noise)."""
    import torch

    from threedhumangan_tpu_torch.models import volume_rendering as vr
    from threedhumangan_tpu_torch.models.smpl import get_geo_features

    S, W, H = meta["num_steps"], meta["render_width"], meta["render_height"]
    B = cond["scales"].shape[0]
    with torch.no_grad():
        z = torch.randn(B, meta["latent_dim"], generator=gcuda, device="cuda")
        fr, ph = G.neural_field_mapping_network(z, torch.bfloat16)
        pts_cam, z_vals, d_cam = vr.get_initial_rays_weak_perspective(
            cond["intrinsics"][:, 0, 0], cond["scales"].float(), S, (W, H), meta["ray_start"],
            meta["ray_end"])
        pts, z_vals, _ = vr.transform_sampled_points(pts_cam, z_vals, d_cam,
                                                     cond["cam2world_matrices"], gcuda, True)
        pts = pts.reshape(B, -1, 3)
        geo = get_geo_features(pts, cond["skeletons_xyz"], cond["vertices"],
                               cond["tpose_vertices"], cond["fk_matrices"], cond["lbs_weights"],
                               ray_layout=(W, S))
        dirs = torch.zeros_like(pts)
        dirs[..., -1] = -1.0
        noise = 0.5 * torch.randn(B, pts.shape[1], 1, generator=gcuda, device="cuda")
    return fr, ph, pts, z_vals.reshape(B, W * H, S).contiguous(), geo, dirs, noise


def check_field_bwd(G, meta, cond, gcuda):
    import torch

    from threedhumangan_tpu_torch.ops import raymarch as rm
    from threedhumangan_tpu_torch.ops import raymarch_bwd as rb

    bf16 = torch.bfloat16
    # narrow, exact sine: pointwise, with and without noise, both residual
    # routings; hidden 40 pads to 48 channels, 200 to 208 (26 n8 tiles: ragged
    # column runs over the three warpgroups; a generator of its own keeps
    # the draws of every other phase as they were)
    g200 = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for hidden, noise, last_back, gen in ((32, False, False, gcuda), (32, True, False, gcuda),
                                          (40, True, True, gcuda), (32, False, True, gcuda),
                                          (200, True, False, g200)):
        field, pk, zv, fr, ph, go, gd = _random_field_case(hidden, 4, noise, gen)
        smx, gmx, errs, k9mx, _ = _bwd_compare(rb.flat_weights(field), pk, fr, ph, zv, go, gd, 32,
                                               not last_back, last_back, True)
        worst = max(errs, key=errs.get)
        log(f"check K8/K9 narrow (hidden {hidden}, exact sin, noise {noise}, last_back "
            f"{last_back}): "
            f"K8 sigma max|d| {smx:.3e} f.g max|d| {gmx:.3e}; K9 worst rel L2 {errs[worst]:.3e} "
            f"({worst}), max|d| {k9mx:.3e}")
        log("  tolerance: K8 max|d| <= 5e-3 (sigma) and 2e-2 (f.g, |f.g| ~ 1), K9 rel L2 <= 5e-3 "
            "per tensor (bf16 activations: f32 sums in another order flip occasional roundings)")
        if smx > 5e-3 or gmx > 2e-2 or errs[worst] > 5e-3:
            raise AssertionError("K8/K9 (narrow) disagree with their plain versions")

    # full width: the slice's field, inputs and nerf noise
    S = meta["num_steps"]
    field = G.neural_field
    fr, ph, pts, zv, geo, dirs, noise = train_field_inputs(G, meta, cond, gcuda)
    B, W, H = pts.shape[0], meta["render_width"], meta["render_height"]
    with torch.no_grad():
        pk = rm.pack_field_inputs(pts, geo, dirs, 2.0 / meta["side_length"], noise).to(bf16)
    go = torch.randn(B, W * H, meta["feature_dim"] + 3, generator=gcuda, device="cuda")
    gd = torch.randn(B, W * H, 1, generator=gcuda, device="cuda")
    w = rb.flat_weights(field)
    exact = not meta["fast_math"]
    wb, lb = meta["white_back"], meta["last_back"]
    # K2 forward on the training path's 38-column inputs, as FieldRender and
    # the D step's fakes launch it
    with torch.no_grad():
        sh, pi = rm.fold_film_tables(field, fr, ph, bf16)
    wt, ft = rm.flat_weights(field), rm.film_tables(fr, ph, len(field.network))
    run_k = lambda: rm.field_render_cuda(wt, ft, pk, zv, S, wb, lb, exact)
    run_p = lambda: rm.field_render_plain(sh, pi, pk, zv, S, wb, lb, bf16, exact)
    (o_k, d_k), (o_p, d_p) = run_k(), run_p()
    mx, mean, p99 = diff_stats(o_k, o_p)
    dmx, dmean, _ = diff_stats(d_k, d_p)
    log(f"check K2 field training shapes {tuple(pk.shape)} packed, noise 0.5: map max|d| "
        f"{mx:.3e} mean|d| {mean:.3e} p99|d| {p99:.3e}; depth max|d| {dmx:.3e} "
        f"mean|d| {dmean:.3e}")
    log("  tolerance: as the generation check, map mean|d| <= 2e-3 and p99|d| <= 5e-3, depth "
        "mean|d| <= 1e-4")
    if mean > 2e-3 or p99 > 5e-3 or dmean > 1e-4:
        raise AssertionError("K2 (training shapes, noise column) disagrees with its plain version")
    k2_train = dict(max_abs_err=mx, ms=cuda_ms(run_k, 3), plain_ms=cuda_ms(run_p, 1),
                    **field_bound(pk, o_k, meta, backward=0))
    log(f"  time: kernel {k2_train['ms']:.3f} ms (with its weight pack)  plain "
        f"{k2_train['plain_ms']:.3f} ms  bound {k2_train['bound_ms']:.3f} ms "
        f"({k2_train['bound_by']})")
    k2_train.update(k2_layer_metrics(wt, ft, pk, S))
    del o_k, d_k, o_p, d_p, sh, pi, wt, ft

    smx, gmx, errs, k9mx, (fk, pk_, coef, dsig) = _bwd_compare(w, pk, fr, ph, zv, go, gd, S, wb,
                                                               lb, exact)
    log(f"check K8/K9 full width (hidden {meta['hidden_dim']}, {meta['neural_field_blocks']} "
        f"blocks, B {B}, R {W * H}, S {S}, noise 0.5): K8 sigma max|d| {smx:.3e} f.g max|d| "
        f"{gmx:.3e}")
    log("  K9 rel L2 vs plain: " + " ".join(f"{k} {v:.2e}" for k, v in sorted(errs.items())))
    # against autograd through the plain unfolded render on the same inputs
    grads_k, dfr_k, dph_k = rb.fused_field_render_bwd(w, pk, fr, ph, zv, go, gd, S, wb, lb,
                                                      bf16, exact)
    frq, phs = fr.clone().requires_grad_(), ph.clone().requires_grad_()
    out, depth = rb.field_render_unfolded(field, pk.float(), frq, phs, zv, S, wb, lb, bf16, exact)
    names = [n for n, _ in field.named_parameters()]
    ag = torch.autograd.grad((out * go).sum() + (depth * gd).sum(),
                             list(field.parameters()) + [frq, phs])
    del out, depth
    layer = rb.layer_names(field)
    aerr = {}
    for n, g in zip(names, ag):
        path, kind = n.rsplit(".", 1)
        key = ("w_" if kind == "weight" else "b_") + layer[path]
        aerr[key] = rel_l2(grads_k[key].t() if kind == "weight" else grads_k[key], g)
    aerr["freq"], aerr["phase"] = rel_l2(dfr_k, ag[-2]), rel_l2(dph_k, ag[-1])
    log("  K8+K9 rel L2 vs autograd through the unfolded render: "
        + " ".join(f"{k} {v:.2e}" for k, v in sorted(aerr.items())))
    log("  tolerance: K8 sigma max|d| <= 5e-2 and f.g max|d| <= 5e-2 (|f.g| ~ 5; about 3x the "
        "1.6e-2 read on an H100), K9 rel L2 <= 2e-2 per tensor vs plain and <= 5e-2 vs autograd "
        "(statistical: at width 384 bf16 roundings of activations flip, and the omega-30 SIREN "
        "amplifies a flip; autograd's forward runs the products in another order)")
    if smx > 5e-2 or gmx > 5e-2 or max(errs.values()) > 2e-2 or max(aerr.values()) > 5e-2:
        raise AssertionError("K8/K9 (full width) disagree with their references")
    # two calls of each kernel, bit for bit (no atomics, fixed-order sums)
    run8 = lambda: rb.field_stats_cuda(w, pk, fk, pk_, go, S, exact_sin=exact)
    run9 = lambda: rb.field_bwd_step_cuda(w, pk, fk, pk_, go, coef, dsig, S, exact_sin=exact)
    same8 = all(torch.equal(x, y) for x, y in zip(run8(), run8()))
    (g1, f1, p1), (g2, f2, p2) = run9(), run9()
    same9 = all(torch.equal(g1[k], g2[k]) for k in g1) and torch.equal(f1, f2) and torch.equal(p1, p2)
    log(f"  two calls bit for bit: K8 {same8}, K9 {same9}")
    if not (same8 and same9):
        raise AssertionError("two K8 or K9 calls on the same inputs differ")
    del g1, g2
    ms8 = cuda_ms(lambda: rb.field_stats_cuda(w, pk, fk, pk_, go, S, exact_sin=exact), 3)
    plain8 = cuda_ms(lambda: rb.field_stats_plain(w, pk, fk, pk_, go, S, exact_sin=exact), 1)
    ms9 = cuda_ms(lambda: rb.field_bwd_step_cuda(w, pk, fk, pk_, go, coef, dsig, S,
                                                 exact_sin=exact), 3)
    plain9 = cuda_ms(lambda: rb.field_bwd_step_plain(w, pk, fk, pk_, go, coef, dsig, S,
                                                     exact_sin=exact), 1)
    b8, b9 = field_bound(pk, go, meta, backward=1), field_bound(pk, go, meta, backward=2)
    # the reduction at K9's ragged widths: the first layer's narrow K (k0p)
    # and the 16-column-padded colour layer (hp + 16), at one launch's rows
    dims = rb.field_bwd_dims(w, fk.shape[1])
    rows = rb.IMAGES_PER_LAUNCH * pk.shape[1]
    rnd = lambda n: torch.randn(rows, n, generator=gcuda, device="cuda").to(bf16)
    cp = dims["hp"] + 16
    b9["weight_gradient_reduction"] = check_wgrad("K9", [
        ("first", rnd(dims["k0p"]), rnd(dims["n0p"])), ("color", rnd(cp), rnd(cp)),
        ("head", rnd(dims["hp"]), rnd(dims["headp"]))])
    b9["reduction_ptxas"] = ptxas_of("wgrad.cu")
    log(f"  time: K8 kernel {ms8:.3f} ms plain {plain8:.3f} ms bound {b8['bound_ms']:.3f} ms "
        f"({b8['bound_by']}); K9 kernel {ms9:.3f} ms plain {plain9:.3f} ms bound "
        f"{b9['bound_ms']:.3f} ms ({b9['bound_by']})")
    split = k9_split(w, pk, fk, pk_, go, coef, dsig, S, exact)
    log_k9_split(split)
    lm = field_core_metrics(w, fk.shape[1], "raymarch_bwd.cu")
    return (k2_train, dict(max_abs_err=smx, ms=ms8, plain_ms=plain8, **b8, **split.pop("k8"),
                           **lm),
            dict(max_abs_err=k9mx, ms=ms9, plain_ms=plain9, **b9, split=split, **lm))


def field_core_metrics(w, n_blocks, source, forward_only=False):
    """Layer metrics of a kernel on csrc/field_core.cuh (K4, K5, K8, K9):
    ``pack_field_bwd_stream`` alone (inside the kernel's time; K4 and K5
    pack the forward half alone), the stream's bytes, the shared memory a
    CTA and the ring as the C entry sizes them, and the ``ptxas`` line of
    its source (a spill, or a missing build log, fails the run)."""
    import ctypes

    from threedhumangan_tpu_torch import _build
    from threedhumangan_tpu_torch.ops import raymarch_bwd as rb

    d = rb.field_bwd_dims(w, n_blocks)
    ring = (ctypes.c_int * 2)()
    smem = _build.library().thgt_field_bwd_smem(d["k0p"], d["n0p"], d["hp"], d["nc"], d["headp"],
                                                ctypes.cast(ring, ctypes.c_void_p))
    out = dict(pack_ms=cuda_ms(lambda: rb.pack_field_bwd_stream(w, d, forward_only), 3),
               stream_bytes=d["fwd_bytes"] + (0 if forward_only else d["bwd_bytes"]),
               fwd_bytes=d["fwd_bytes"], smem_bytes=smem, ring_stages=ring[0], stage_bytes=ring[1],
               ptxas=ptxas_of(source))
    ptx = out["ptxas"]
    log(f"  {source}: pack_field_bwd_stream {out['pack_ms']:.3f} ms ({out['stream_bytes']} bytes, "
        f"the forward half {out['fwd_bytes']}); {smem} bytes of shared memory a CTA, {ring[0]} ring "
        f"stages of {ring[1]} bytes; ptxas: {ptx['registers']} registers, {ptx['spill_stores']} "
        f"bytes spill stores, {ptx['spill_loads']} bytes spill loads, {ptx['wgmma_serialized']} "
        f"serialized-wgmma warnings")
    if ptx["spill_stores"] is None or ptx["spill_stores"] or ptx["spill_loads"]:
        raise AssertionError(f"{source} spills or left no build log: {ptx}")
    return out


def k9_split(w, pk, fk, pk_, go, coef, dsig, S, exact):
    """K9's call in parts, each timed alone by CUDA events: the host glue
    before its launches (tables, weights, buffers), the bodies of its
    launches, each weight-gradient product of a launch (beside its bound and
    one ``torch.matmul(X.t(), Y)`` on the same bf16 operands, a yardstick
    never on the path) and the host's sums of the partials; and K8's call
    in glue and body."""
    import torch

    from threedhumangan_tpu_torch.ops import raymarch_bwd as rb

    args = (w, pk, fk, pk_, go, coef, dsig, S)
    op = rb.field_bwd_step_operands(*args, exact_sin=exact)
    groups = range(0, op["B"], rb.IMAGES_PER_LAUNCH)
    bodies = lambda: [rb.field_bwd_step_body(op, b0) for b0 in groups]
    bodies()
    gw = rb.field_bwd_step_products(op, 0)
    sums = lambda: rb.field_bwd_step_reduce(
        op, gw, torch.cat([rb.field_bwd_step_partials(op, b0) for b0 in groups], 0))
    out = dict(launches=len(groups),
               glue_ms=cuda_ms(lambda: rb.field_bwd_step_operands(*args, exact_sin=exact), 3),
               body_ms=cuda_ms(bodies, 3), sums_ms=cuda_ms(sums, 3), products={})
    stream = torch.cuda.current_stream().cuda_stream
    for k, (X, Y) in rb.field_bwd_step_pairs(op, 0).items():
        out["products"][k] = dict(
            shape=[X.shape[0], X.shape[1], Y.shape[1]],
            ms=cuda_ms(lambda: rb.wgrad(X, Y, stream), 3),
            library_ms=cuda_ms(lambda: torch_matmul_t(X, Y), 3), **wgrad_bound(X, Y))
    out["products_ms"] = len(groups) * sum(p["ms"] for p in out["products"].values())
    del op, gw
    op8 = rb.field_stats_operands(w, pk, fk, pk_, go, S, exact_sin=exact)
    out["k8"] = dict(
        glue_ms=cuda_ms(lambda: rb.field_stats_operands(w, pk, fk, pk_, go, S, exact_sin=exact), 3),
        body_ms=cuda_ms(lambda: rb.field_stats_body(op8), 3))
    return out


def log_k9_split(sp):
    log(f"  K9 split: glue {sp['glue_ms']:.3f} ms, {sp['launches']} bodies {sp['body_ms']:.3f} ms, "
        f"{sp['launches']} x {len(sp['products'])} weight-gradient products "
        f"{sp['products_ms']:.3f} ms, sums {sp['sums_ms']:.3f} ms; K8 glue "
        f"{sp['k8']['glue_ms']:.3f} ms, body {sp['k8']['body_ms']:.3f} ms")
    for k, p in sp["products"].items():
        log(f"    product {k} {p['shape']} (rows, K, N): {p['ms']:.3f} ms, bound "
            f"{p['bound_ms']:.3f} ms ({p['bound_by']}), torch.matmul {p['library_ms']:.3f} ms")


def check_small_train(fused=False):
    """A TINY D+G pair on the card (kernels) and on the CPU (plain
    versions): same weights, batch and draws; the synthesis per op or on
    the fused half-blocks (K10/K11)."""
    import torch

    from threedhumangan_tpu_torch import configs
    from threedhumangan_tpu_torch.data.dataset import (
        SyntheticSHHQDataset, iterate_batches, to_tensors)
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
    from threedhumangan_tpu_torch.trainers.phase_trainer import init_train_state, train_step_pair

    meta = dict(configs.extract_metadata(configs.MAP3DBN_TINY, 0))
    meta.update(nerf_noise=0, perturb_rays=False, use_mixed_precision=True,
                pallas_synthesis_train=fused)
    smpl = synthetic_smpl_model(num_verts=384, num_faces=512)
    batch = next(iterate_batches(SyntheticSHHQDataset(smpl_model=smpl, **meta), 2, shuffle=False))
    gz = torch.Generator().manual_seed(SEED)
    draws = {"z": torch.randn(2, meta["latent_dim"], generator=gz), "coin": torch.tensor(0.3),
             "h_rotation": torch.zeros(2), "v_rotation": torch.zeros(2)}
    res = {}
    for dev in ("cuda", "cpu"):
        ts = init_train_state(meta, torch.Generator().manual_seed(SEED), dev)
        with torch.no_grad():  # a positive density, so that the G step reaches the field
            ts.G.neural_field.sigma_layer.bias.fill_(0.5)
        dd = {k: v.to(dev) for k, v in draws.items()}
        _, stats = train_step_pair(ts, to_tensors(batch, dev), torch.Generator(device=dev), meta,
                                   get_preprocessor(meta, smpl), meta["phases"][3], 1e-4, 4e-4,
                                   0.0, draws={"d": dd, "g": dd})
        res[dev] = {k: float(v[1]) for k, v in stats.items()
                    if k in ("d_loss", "g_loss") or "grad_norm" in k}
    worst = {k: abs(res["cuda"][k] - res["cpu"][k]) / (abs(res["cpu"][k]) + 1e-12)
             for k in res["cpu"] if res["cpu"][k] != 0}
    log(f"check small config (TINY D+G, R1, bf16, {'fused' if fused else 'per-op'} synthesis) "
        "card vs CPU plain: "
        + " ".join(f"{k} {res['cuda'][k]:.5g}/{res['cpu'][k]:.5g}" for k in sorted(res["cpu"])))
    log("  tolerance: losses within 2% and grad group norms within 3% relative (bf16 end to "
        "end; the kernels, cuDNN and the CPU sum in other orders; up to 2.6% read on an H100, "
        "on the synthesis mapping network's norm of ~1e-4 with the fused synthesis)")
    for k, v in worst.items():
        if v > (0.02 if k.endswith("loss") else 0.03):
            raise AssertionError(f"the card disagrees with the CPU plain path on {k}: {v:.3e}")
    if res["cuda"]["g_grad_norm/neural_field"] <= 0:
        raise AssertionError("the small config's G step did not reach the field")


# ---------------------------------------------------------------------------
# K10/K11: the trainable SPADE half-blocks
# ---------------------------------------------------------------------------


def _half_block_case(B, H, W, ci, co, cs, hid, spatial, with_fixed, gcuda):
    """Seeded random inputs of one half-block: h and style bf16, the batch
    moments of h, BN affine, SPADE MLP (or per-image rows), conv and g."""
    import torch

    bf16 = torch.bfloat16
    rn = lambda *s: torch.randn(*s, generator=gcuda, device="cuda")
    un = lambda fan, *s: (torch.rand(*s, generator=gcuda, device="cuda") * 2 - 1) * fan ** -0.5
    h = (1.5 * rn(B, H, W, ci) + 0.3).to(bf16)
    x = h.float()
    m = x.mean((0, 1, 2))
    r = torch.rsqrt(torch.square(x - m).mean((0, 1, 2)) + 1e-5)
    args = dict(h=h, style=None, fixed=None, gam=None, bet=None, m=m, r=r,
                a=1.0 + 0.2 * rn(ci), b=0.2 * rn(ci), mlp=None, w=un(ci, ci, co), c=un(ci, co))
    if spatial:
        args["style"] = rn(B, H, W, cs).to(bf16)
        args["fixed"] = rn(B, cs) if with_fixed else None
        args["mlp"] = dict(sh_w=un(cs, cs, hid), sh_b=un(cs, hid), g_w=un(hid, hid, ci),
                           g_b=un(hid, ci), bt_w=un(hid, hid, ci), bt_b=un(hid, ci))
    else:
        args["gam"] = (1.0 + 0.3 * rn(B, ci)).to(bf16)
        args["bet"] = (0.3 * rn(B, ci)).to(bf16)
    return args, rn(B, H, W, co).to(bf16)


def _half_block_autograd(args, g):
    """Gradients of sum(out * g) by autograd through the plain forward."""
    import torch

    from threedhumangan_tpu_torch.ops import synthesis_train as st

    leaves = {k: v.detach().clone().requires_grad_() for k, v in args.items()
              if isinstance(v, torch.Tensor)}
    mlp = None
    if args["mlp"] is not None:
        mlp = {k: v.detach().clone().requires_grad_() for k, v in args["mlp"].items()}
        leaves.update({f"mlp_{k}": v for k, v in mlp.items()})
    a = {**args, **{k: v for k, v in leaves.items() if not k.startswith("mlp_")}, "mlp": mlp}
    out = st.half_block_forward(**a)
    names = list(leaves)
    grads = torch.autograd.grad((out.float() * g.float()).sum(), [leaves[n] for n in names])
    rename = {"style": "dsty", "mlp_sh_w": "dsh_w", "mlp_sh_b": "dsh_b", "mlp_g_w": "dg_w",
              "mlp_g_b": "dg_b", "mlp_bt_w": "dbt_w", "mlp_bt_b": "dbt_b"}
    return {rename.get(n, "d" + n): gr for n, gr in zip(names, grads)}


def _half_block_flops(P, ci, co, cs, hid, spatial):
    """Products of K10 and K11 (recompute, dt, MLP backward, weight grads) a call."""
    mlp = cs * hid + 2 * hid * ci if spatial else 0
    return 2 * P * (ci * co + mlp), 2 * P * (2 * ci * co + 3 * mlp)


def wgrad_bound(X, Y):
    """Bound of one weight-gradient product X^T Y: X (rows, K), Y (rows, N)
    bf16 read once, (K, N) f32 written once."""
    rows, K = X.shape
    N = Y.shape[1]
    return bound(2 * rows * K * N, 2 * rows * (K + N) + 4 * K * N)


def check_wgrad(what, cases):
    """The weight-gradient reduction (csrc/wgrad.cu) against the plain f32
    X^T Y on each (name, X, Y), with one ``torch.matmul(X.t(), Y)`` on the
    same bf16 operands timed beside it (a yardstick, never on the path)."""
    import torch

    from threedhumangan_tpu_torch.ops import raymarch_bwd as rb

    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, X, Y in cases:
        got = rb.wgrad(X, Y, stream)
        ref = rb.wgrad_plain(X, Y)
        err = float((got - ref).abs().max() / (ref.abs().max() + 1e-30))
        out[name] = dict(shape=[X.shape[0], X.shape[1], Y.shape[1]], max_rel_err=err,
                         ms=cuda_ms(lambda: rb.wgrad(X, Y, stream), 5),
                         plain_ms=cuda_ms(lambda: rb.wgrad_plain(X, Y), 3),
                         library_ms=cuda_ms(lambda: torch_matmul_t(X, Y), 5), **wgrad_bound(X, Y))
        r = out[name]
        log(f"check {what} weight-gradient reduction {name} {r['shape']} (rows, K, N): "
            f"max|d|/max|ref| {err:.3e}; {r['ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}), torch.matmul {r['library_ms']:.3f} ms, plain f32 "
            f"{r['plain_ms']:.3f} ms")
    log("  tolerance: max|d|/max|ref| <= 1e-3 (exact bf16 products, f32 sums in another order)")
    worst = max(r["max_rel_err"] for r in out.values())
    if not worst <= 1e-3:
        raise AssertionError(f"the weight-gradient reduction disagrees with X^T Y ({what})")
    return out


def k10_split(args):
    """K10's call in parts, each timed alone by CUDA events: the host glue
    before the launch (of it the weight pack) and the body kernel; and the
    shared memory a CTA and the weight ring as the C entry sizes them."""
    import ctypes

    from threedhumangan_tpu_torch import _build
    from threedhumangan_tpu_torch.ops import synthesis_train as st

    op = st.fwd_operands(**args)
    d = op["d"]
    ring = (ctypes.c_int * 2)()
    smem = _build.library().thgt_half_block_fwd_smem(d["cip"], d["csp"], d["cop"], d["hidp"],
                                                     int(args["style"] is not None),
                                                     ctypes.cast(ring, ctypes.c_void_p))
    return dict(glue_ms=cuda_ms(lambda: st.fwd_operands(**args), 3),
                pack_ms=cuda_ms(lambda: st.pack_fwd_stream(args["w"], args["mlp"], d), 3),
                body_ms=cuda_ms(lambda: st.fwd_body(op), 3),
                smem_bytes=smem, ring_stages=ring[0], stage_bytes=ring[1])


def k11_split(bargs, g):
    """K11's call in parts, each timed alone by CUDA events: the host glue
    before the launch, the body kernel, each weight-gradient product (beside
    its bound and one ``torch.matmul(X.t(), Y)`` on the same bf16 operands, a
    yardstick never on the path) and the host's fixed-order sums."""
    from threedhumangan_tpu_torch.ops import synthesis_train as st

    op = st.bwd_operands(**bargs, g=g)
    st.bwd_body(op)
    gw = st.bwd_products(op)
    red = {k: bargs[k] for k in ("h", "style", "fixed", "gam", "bet", "m", "r", "a")}
    out = dict(glue_ms=cuda_ms(lambda: st.bwd_operands(**bargs, g=g), 3),
               pack_ms=cuda_ms(lambda: st.pack_bwd_stream(bargs["w"], bargs["mlp"], op["d"]), 3),
               body_ms=cuda_ms(lambda: st.bwd_body(op), 3),
               sums_ms=cuda_ms(lambda: st.bwd_reduce(op, gw, **red), 3), products={})
    for k, (X, Y) in op["prods"].items():
        one = {k: (X, Y)}
        out["products"][k] = dict(
            shape=[X.shape[0], X.shape[1], Y.shape[1]],
            ms=cuda_ms(lambda: st.bwd_products(dict(op, prods=one)), 3),
            library_ms=cuda_ms(lambda: torch_matmul_t(X, Y), 3), **wgrad_bound(X, Y))
    return out


def torch_matmul_t(X, Y):
    import torch

    return torch.matmul(X.t(), Y)


def log_k11_split(name, sp):
    prods = sum(p["ms"] for p in sp["products"].values())
    log(f"  K11 {name} split: glue {sp['glue_ms']:.3f} ms (of it the weight pack "
        f"{sp['pack_ms']:.3f} ms), body {sp['body_ms']:.3f} ms, "
        f"weight-gradient products {prods:.3f} ms, sums {sp['sums_ms']:.3f} ms")
    for k, p in sp["products"].items():
        log(f"    product {k} {p['shape']} (rows, K, N): {p['ms']:.3f} ms, bound "
            f"{p['bound_ms']:.3f} ms ({p['bound_by']}), torch.matmul {p['library_ms']:.3f} ms")


def check_half_blocks(gcuda, B, H, W, C, hid):
    """K10/K11 against their plain versions (and K11 against autograd through
    the plain forward): narrow cases pointwise, the training shapes by
    statistics; kernel, plain and bound times at the training shapes."""
    import torch

    from threedhumangan_tpu_torch.ops import synthesis_train as st

    # narrow: Ci 40 / Cs 24 pad to 48 / 32; 5 x 30 = 150 pixels, a ragged
    # last tile of 22; and MAP3DBN512L's width 420 (padded to 432, the
    # half-block kernels' widest instantiation and largest shared-memory
    # layout), spatial and rank-1
    for ci, cs, spatial, with_fixed in ((40, 24, True, True), (40, 24, True, False),
                                        (40, 24, False, False), (420, 420, True, True),
                                        (420, 420, False, False)):
        args, g = _half_block_case(2, 5, 30, ci, ci, cs, 128, spatial, with_fixed, gcuda)
        o_k = st.half_block_forward_cuda(**args)
        o_p = st.half_block_forward(**args)
        d_k = st.half_block_backward_cuda(**{k: v for k, v in args.items() if k != "c"}, g=g)
        d_p = st.half_block_backward(**{k: v for k, v in args.items() if k != "c"}, g=g)
        torch.cuda.synchronize()
        fmx = float((o_k.float() - o_p.float()).abs().max() / o_p.float().abs().max())
        bmx = {k: float((d_k[k].float() - d_p[k].float()).abs().max()
                        / (d_p[k].float().abs().max() + 1e-30)) for k in d_p if d_p[k] is not None}
        worst = max(bmx, key=bmx.get)
        log(f"check K10/K11 pointwise (Ci {ci}, Cs {cs}, 150 px, "
            f"{'spatial' if spatial else 'rank-1'}"
            f"{', fixed row' if with_fixed else ''}): K10 max|d|/max|ref| {fmx:.3e}; K11 worst "
            f"max|d|/max|ref| {bmx[worst]:.3e} ({worst})")
        log("  tolerance: K10 <= 1e-2 and K11 <= 2e-2 of each tensor's max (bf16 outputs: an "
            "f32 sum in another order flips a bf16 rounding, one ulp 4e-3 relative)")
        if fmx > 1e-2 or bmx[worst] > 2e-2:
            raise AssertionError("K10/K11 (narrow) disagree with their plain versions")

    res = {}
    P = B * H * W
    for spatial, name in ((True, "spatial"), (False, "rank1")):
        args, g = _half_block_case(B, H, W, C, C, C, hid, spatial, spatial, gcuda)
        bargs = {k: v for k, v in args.items() if k != "c"}
        run_fk = lambda: st.half_block_forward_cuda(**args)
        run_fp = lambda: st.half_block_forward(**args)
        run_bk = lambda: st.half_block_backward_cuda(**bargs, g=g)
        run_bp = lambda: st.half_block_backward(**bargs, g=g)
        mx, mean, _ = diff_stats(run_fk(), run_fp())
        d_k, d_p = run_bk(), run_bp()
        errs = {k: rel_l2(d_k[k], d_p[k]) for k in d_p if d_p[k] is not None}
        del d_p
        ag = _half_block_autograd(args, g)
        aerr = {k: rel_l2(d_k[k], ag[k]) for k in ag}
        del ag, d_k
        log(f"check K10/K11 training shapes ({B}, {H}, {W}, {C}), hidden {hid}, {name}"
            f"{' with the fixed row' if spatial else ''}: K10 max|d| {mx:.3e} mean|d| {mean:.3e}")
        log("  K11 rel L2 vs plain: " + " ".join(f"{k} {v:.2e}" for k, v in sorted(errs.items())))
        log("  K11 rel L2 vs autograd through the plain forward: "
            + " ".join(f"{k} {v:.2e}" for k, v in sorted(aerr.items())))
        log("  tolerance: K10 mean|d| <= 2e-3; K11 rel L2 <= 1e-2 per tensor vs plain, <= 5e-2 "
            "vs autograd (bf16 activations flip roundings; autograd also rounds its gradients "
            "to bf16 at every bf16 tensor)")
        if mean > 2e-3 or max(errs.values()) > 1e-2 or max(aerr.values()) > 5e-2:
            raise AssertionError(f"K10/K11 ({name}) disagree with their references")
        fl, bl = _half_block_flops(P, C, C, C if spatial else 0, hid if spatial else 0, spatial)
        io = 2 * P * C * (3 if spatial else 2)  # K10: h (, style), out
        io_bwd = io + 2 * P * C * (2 if spatial else 1)  # K11: h (, style), g, dh (, dsty)
        r = dict(
            k10=dict(max_abs_err=mx, ms=cuda_ms(run_fk, 3), plain_ms=cuda_ms(run_fp, 1),
                     **bound(fl, io)),
            k11=dict(max_abs_err=max(errs.values()), ms=cuda_ms(run_bk, 3),
                     plain_ms=cuda_ms(run_bp, 1), **bound(bl, io_bwd)))
        log(f"  time: K10 kernel {r['k10']['ms']:.3f} ms plain {r['k10']['plain_ms']:.3f} ms "
            f"bound {r['k10']['bound_ms']:.3f} ms ({r['k10']['bound_by']}); K11 (with its "
            f"weight-gradient products) kernel {r['k11']['ms']:.3f} ms plain "
            f"{r['k11']['plain_ms']:.3f} ms bound {r['k11']['bound_ms']:.3f} ms "
            f"({r['k11']['bound_by']})")
        r["k10"].update(k10_split(args))
        k = r["k10"]
        log(f"  K10 {name} split: glue {k['glue_ms']:.3f} ms (of it the weight pack "
            f"{k['pack_ms']:.3f} ms), body {k['body_ms']:.3f} ms; shared memory a CTA (the C "
            f"entry's) {k['smem_bytes']} bytes, weight ring {k['ring_stages']} stages of "
            f"{k['stage_bytes']} bytes")
        o1, o2 = run_fk(), run_fk()
        same = torch.equal(o1, o2)
        log(f"  K10 {name}: two calls on the same inputs bit-equal: {same}")
        if not same:
            raise AssertionError("K10 is not deterministic from run to run")
        del o1, o2
        r["k11"]["split"] = k11_split(bargs, g)
        log_k11_split(name, r["k11"]["split"])
        d1, d2 = run_bk(), run_bk()
        same = all(torch.equal(d1[k], d2[k]) for k in d1 if d1[k] is not None)
        log(f"  K11 {name}: two calls on the same inputs bit-equal: {same}")
        if not same:
            raise AssertionError("K11 is not deterministic from run to run")
        del d1, d2
        op = st.bwd_operands(**bargs, g=g)
        st.bwd_body(op)
        r["k11"]["weight_gradient_reduction"] = check_wgrad(f"K11 {name}", [
            (k, X, Y) for k, (X, Y) in op["prods"].items()])
        del op
        res[name] = r
        del args, g, bargs
        torch.cuda.empty_cache()
    for k, source in (("k10", "synthesis_train.cu"), ("k11", "synthesis_train_bwd.cu")):
        core = ptxas_of(source)
        log(f"  {k.upper()} ptxas: {core['registers']} registers, {core['spill_stores']} bytes "
            f"spill stores, {core['spill_loads']} bytes spill loads, "
            f"{core['wgmma_serialized']} warnings of serialized wgmma")
        if k == "k10" and (core["spill_stores"] is None or core["spill_loads"] is None):
            raise AssertionError(f"no ptxas spill numbers for {source}: its build log is missing")
        if k == "k10" and (core["spill_stores"] or core["spill_loads"]):
            raise AssertionError(f"{source} spills registers: {core}")
        res["spatial"][k].update(ptxas=core)
    return res


# ---------------------------------------------------------------------------
# K4-K6: the generator's other kernel selections
# ---------------------------------------------------------------------------

SELECTIONS = {"K4": dict(pallas_fold_film=False), "K5": dict(pallas_fuse_geo=True),
              "K6": dict(pallas_geo=False, pallas_knn=True)}


def check_knn(inp, meta):
    """K6 against its plain version on the three sets of ``nn_sets``, two
    calls bit for bit, the scanned pairs; cdist + min as the library
    yardstick."""
    import torch

    from threedhumangan_tpu_torch.ops import geo, knn

    res, first = {}, None
    for case in nn_sets(inp, meta):
        pts, verts, layout = case["points"], case["vertices"], case["layout"]
        B, P, _ = pts.shape
        V = verts.shape[1]
        pairs = torch.zeros(1, dtype=torch.int64, device="cuda")
        dk, ik = knn.nn_points_cuda(pts, verts, layout, pairs)
        again = knn.nn_points(pts, verts, layout)
        dp, ip = knn.nn_points_plain(pts, verts, point_chunk=1024)
        torch.cuda.synchronize()
        agree = float((ik == ip).float().mean())
        mx = float((dk - dp).abs().max())
        equal = torch.equal(dk, again[0]) and torch.equal(ik, again[1])
        share = int(pairs) / (B * P * V)
        ms = cuda_ms(lambda: knn.nn_points_cuda(pts, verts, layout), 5)
        log(f"check K6 1-NN, {case['name']}: {tuple(pts.shape)} points x {V} vertices, layout "
            f"{layout}: index agreement {agree * 100:.6f}%  distance max|d| {mx:.3e}  two calls "
            f"{'bit-equal' if equal else 'DIFFER'}  scanned {share:.4f} of P x V  kernel "
            f"{ms:.3f} ms")
        if case["perm"] is not None:
            d0 = knn.nn_points_plain(inp["points"], inp["vertices"], point_chunk=1024)[0]
            log(f"  distances equal to the unshuffled plain version's: {torch.equal(dk, d0)}")
            if not torch.equal(dk, d0):
                raise AssertionError("K6's distances changed with the vertex order")
        if agree != 1.0 or mx > 0 or not equal:
            raise AssertionError(f"K6 disagrees with its plain version ({case['name']})")
        res[case["name"]] = dict(index_agreement=agree, max_abs_err=mx, ms=ms,
                                 scanned_share=share)
        if first is None:
            first = dict(pts=pts, verts=verts, layout=layout, pairs=int(pairs), ms=ms,
                         best_d=dp[..., 0])
    log("  tolerance: index agreement 100% and distance max|d| == 0 (the same elementwise f32 "
        "distance as the plain version, lowest index on ties); the same output from two calls")
    pts, verts, layout = first["pts"], first["verts"], first["layout"]
    run_p = lambda: knn.nn_points_plain(pts, verts, point_chunk=1024)
    plain_ms = cuda_ms(run_p, 1)
    # one PyTorch call pair computes the same function: cdist, then min (a
    # (B, P, V) float32 matrix of 32.5 GB at this shape)
    lib_ms = cuda_ms(lambda: torch.cdist(pts, verts).min(-1), 1)
    torch.cuda.empty_cache()
    build_ms = cuda_ms(lambda: geo.vertex_clusters(verts), 5)
    B, P, _ = pts.shape
    V = verts.shape[1]
    bd = nn_bounds(B, P, V, first["pairs"], needed_pairs(pts, verts, first["best_d"]),
                   4 * (B * P * (3 + 1 + 1) + B * V * 3))
    ms = first["ms"]
    shuffled_ms = res["slice, vertex order shuffled"]["ms"]
    if res["slice"]["scanned_share"] > 0.35:
        raise AssertionError(f"K6's search scanned {res['slice']['scanned_share']:.4f} of the "
                             "slice's pairs (at most 0.35)")
    log(f"  time (slice, layout {layout}): kernel {ms:.3f} ms, of which the cluster build "
        f"alone {build_ms:.3f} ms ({build_ms / ms * 100:.1f}%); shuffled vertices "
        f"{shuffled_ms:.3f} ms ({(shuffled_ms / ms - 1) * 100:+.1f}%); plain {plain_ms:.3f} ms; "
        f"library (torch.cdist + min, two calls) {lib_ms:.3f} ms; bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']}: {bd['needed_share']:.4f} of P x V needed, {bd['scanned_share']:.4f} "
        f"scanned; brute force {bd['brute_force_bound_ms']:.3f} ms)")
    return dict(max_abs_err=max(r["max_abs_err"] for r in res.values()), ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, build_ms=build_ms, shuffled_ms=shuffled_ms,
                sets=res, library_call="torch.cdist(points, verts).min(-1): two calls", **bd)


def _narrow_field(H, NB, F=24):
    import torch

    from threedhumangan_tpu_torch.models.siren import CoordConcatSiren
    from threedhumangan_tpu_torch.ops import raymarch as rm

    field = CoordConcatSiren(3, H, 31, F, NB,
                             generator=torch.Generator().manual_seed(SEED + H + NB))
    with torch.no_grad():  # a positive density, or a random field may sit below the clamp
        field.sigma_layer.bias.fill_(0.5)
    return rm.flat_weights(field.cuda())


def _narrow_film(B, NB, H, gcuda):
    import torch

    from threedhumangan_tpu_torch.ops import raymarch as rm

    fr = 0.1 * torch.randn(B, NB * H, generator=gcuda, device="cuda")
    ph = 0.1 * torch.randn(B, NB * H, generator=gcuda, device="cuda")
    return rm.film_tables(fr, ph, NB)


NARROW_CASES = ((32, 4, False, False), (32, 4, True, True), (40, 4, True, False),
                (32, 1, False, True))  # hidden (40 pads to 48), blocks, noise, last_back


def geo_bound(packed, out, meta, V):
    """K5's bound: the field pass (``field_bound``: bf16 products, packed in
    and map out) or the f32 1-NN scan (~9 operations a (sample, vertex),
    with the vertex tables read), whichever is longer: the tensor cores and
    the f32 units run side by side."""
    scan = bound(9 * packed.shape[0] * packed.shape[1] * V, packed.shape[0] * V * 22 * 4, PEAK_F32)
    return max(field_bound(packed, out, meta, backward=0), scan, key=lambda d: d["bound_ms"])


# K4/K5 at full width against their plain versions: a few times above the
# sound readings (PERF.md section 6), and a share of bad rays and a worst
# image, so that a fault confined to a few CTAs or one image fails
RENDER_LIMITS = dict(mean=5e-4, p99=1e-3, image_p99=1e-3, bad_rays=5e-4, depth_mean=1e-4)
BAD_RAY = 1e-2  # a ray is bad when one of its channels is off by more


def check_render_stats(what, o_k, d_k, o_p, d_p, prefix=""):
    """Log and hold a full-width render (B, R, C) + depth against its plain
    version at ``RENDER_LIMITS``; returns the map's max |d|."""
    import torch

    mx, mean, p99 = diff_stats(o_k, o_p)
    dmx, dmean, _ = diff_stats(d_k, d_p)
    d = (o_k.float() - o_p.float()).abs()
    # p99 and not the mean per image: the few far flips of a sound run
    # (|d| ~ 1 on every channel of a ray) move one image's mean by ~1e-4 each
    image_p99 = max(float(torch.quantile(x.flatten(), 0.99)) for x in d)
    bad = float((d.amax(-1) > BAD_RAY).float().mean())
    log(f"check {what}: {prefix}map max|d| {mx:.3e} mean|d| {mean:.3e} p99|d| {p99:.3e} "
        f"worst image p99|d| {image_p99:.3e} rays with |d| > {BAD_RAY:g} {bad:.3e}; "
        f"depth max|d| {dmx:.3e} mean|d| {dmean:.3e}")
    lim = RENDER_LIMITS
    log(f"  tolerance: map mean|d| <= {lim['mean']:g}, p99|d| <= {lim['p99']:g}, worst image "
        f"p99|d| <= {lim['image_p99']:g}, share of bad rays <= {lim['bad_rays']:g}, depth "
        f"mean|d| <= {lim['depth_mean']:g}")
    if (mean > lim["mean"] or p99 > lim["p99"] or image_p99 > lim["image_p99"]
            or bad > lim["bad_rays"] or dmean > lim["depth_mean"]):
        raise AssertionError(f"{what}: disagrees with its plain version")
    return mx


def check_unfolded(gen, inp, geo_feats, meta, gcuda):
    """K4 against its plain version: narrow pointwise, full width by
    statistics; K4 against K2 on the same inputs for information."""
    import torch

    from threedhumangan_tpu_torch.ops import raymarch as rm

    bf16 = torch.bfloat16
    S = meta["num_steps"]
    Bn, Rn = 2, 256
    for H, NB, noise, last_back in NARROW_CASES:
        w = _narrow_field(H, NB)
        fk, pk_ = _narrow_film(Bn, NB, H, gcuda)
        packed = 0.5 * torch.randn(Bn, Rn * S, rm.INPUT_PACK + noise, generator=gcuda,
                                   device="cuda")
        zv = torch.sort(torch.rand(Bn, Rn, S, generator=gcuda, device="cuda") + 1.0, -1).values
        kw = dict(white_back=not last_back, last_back=last_back, exact_sin=True)
        o_k, d_k = rm.field_render_unfolded_cuda(w, packed, fk, pk_, zv, S, **kw)
        o_p, d_p = rm.field_render_unfolded_plain(w, packed, fk, pk_, zv, S, compute_dtype=bf16,
                                                  **kw)
        mx, mean, p99 = diff_stats(torch.cat([o_k, d_k], -1), torch.cat([o_p, d_p], -1))
        log(f"check K4 unfolded field narrow (hidden {H}, {NB} blocks, exact sin, noise {noise}, "
            f"last_back {last_back}): max|d| {mx:.3e} mean|d| {mean:.3e} p99|d| {p99:.3e}")
        log("  tolerance: max|d| <= 5e-3, mean|d| <= 1e-5 (as K2: f32 sums in another order flip "
            "occasional bf16 roundings of activations, which the omega-30 SIREN amplifies)")
        if mx > 5e-3 or mean > 1e-5:
            raise AssertionError("K4 (narrow) disagrees with its plain version")

    # full width, the slice's inputs and weights: statistics
    packed = rm.pack_field_inputs(inp["points"], geo_feats, inp["dirs"], 2.0 / meta["side_length"])
    w = rm.flat_weights(gen.neural_field)
    fk, pk_ = rm.film_tables(inp["freq"], inp["phase"], meta["neural_field_blocks"])
    kw = dict(white_back=meta["white_back"], last_back=meta["last_back"],
              exact_sin=not meta["fast_math"])
    run_k = lambda: rm.field_render_unfolded_cuda(w, packed, fk, pk_, inp["z_vals"], S, **kw)
    run_p = lambda: rm.field_render_unfolded_plain(w, packed, fk, pk_, inp["z_vals"], S,
                                                   compute_dtype=bf16, **kw)
    (o_k, d_k), (o_p, d_p) = run_k(), run_p()
    mx = check_render_stats(f"K4 unfolded field full width {tuple(o_k.shape)}", o_k, d_k, o_p, d_p)
    o_2, d_2 = run_k()
    same = torch.equal(o_k, o_2) and torch.equal(d_k, d_2)
    log(f"  two K4 calls on the same inputs bit for bit: {same}")
    if not same:
        raise AssertionError("two K4 calls on the same inputs differ")
    o_2, _ = rm.fused_field_render(gen.neural_field, packed, inp["freq"], inp["phase"],
                                   inp["z_vals"], S, compute_dtype=bf16, **kw)
    fmx, fmean, fp99 = diff_stats(o_k, o_2)
    log(f"  K4 vs K2 (folded) on the same inputs, for information: map max|d| {fmx:.3e} mean|d| "
        f"{fmean:.3e} p99|d| {fp99:.3e} (folding rounds the freq-scaled weights to bf16)")
    ms = cuda_ms(run_k, 3)
    plain_ms = cuda_ms(run_p, 1)
    bd = field_bound(packed, o_k, meta, backward=0)
    log(f"  time: kernel {ms:.3f} ms (with its weight pack)  plain {plain_ms:.3f} ms  bound "
        f"{bd['bound_ms']:.3f} ms ({bd['bound_by']})")
    lm = field_core_metrics(w, meta["neural_field_blocks"], "raymarch_unfolded.cu", True)
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms, **bd, **lm)


def _geo_case(inp, B, samples):
    """Raw packed [points | dirs] of the slice's first ``samples`` samples of ``B`` images."""
    import torch

    return dict(packed=torch.cat([inp["points"][:B, :samples], inp["dirs"][:B, :samples]], -1),
                verts=inp["vertices"][:B], vfeat=inp["vfeat"][:B], skel=inp["skeletons"][:B])


def _geo_compare(w, fk, pk_, zv, case, S, scaler, legacy, kw, noise=None):
    """K5 and its plain version on one case: outputs, depth, index agreement."""
    import torch

    from threedhumangan_tpu_torch.ops import geo
    from threedhumangan_tpu_torch.ops import raymarch as rm

    packed = case["packed"] if noise is None else torch.cat([case["packed"], noise], -1)
    args = (w, packed, fk, pk_, zv, case["verts"], case["vfeat"], case["skel"], S, scaler)
    o_k, d_k, idx = rm.field_render_geo_cuda(*args, legacy_mode=legacy, return_index=True, **kw)
    o_p, d_p = rm.field_render_geo_plain(*args, compute_dtype=torch.bfloat16, legacy_mode=legacy,
                                         **kw)
    _, ref_idx = geo.nearest_vertex(packed[..., :3], case["verts"], point_chunk=1024)
    torch.cuda.synchronize()
    agree = float((idx.long() == ref_idx).float().mean())
    return (o_k, d_k), (o_p, d_p), agree, packed, args


def check_geo_fused(gen, inp, meta, gcuda):
    """K5 against its plain version: narrow pointwise (with the slice's body
    and rays), full width by statistics; 1-NN index agreement 100%."""
    import torch

    from threedhumangan_tpu_torch.ops import raymarch as rm

    S = meta["num_steps"]
    scaler = 2.0 / meta["side_length"]
    legacy = meta["legacy_mode"]
    Bn, Rn = 2, 256
    narrow = _geo_case(inp, Bn, Rn * S)
    zn = inp["z_vals"][:Bn, :Rn].contiguous()
    for H, NB, noise, last_back in NARROW_CASES:
        w = _narrow_field(H, NB)
        fk, pk_ = _narrow_film(Bn, NB, H, gcuda)
        nz = (0.5 * torch.randn(Bn, Rn * S, 1, generator=gcuda, device="cuda")) if noise else None
        kw = dict(white_back=not last_back, last_back=last_back, exact_sin=True)
        (o_k, d_k), (o_p, d_p), agree, _, _ = _geo_compare(w, fk, pk_, zn, narrow, S, scaler,
                                                           legacy, kw, nz)
        mx, mean, p99 = diff_stats(torch.cat([o_k, d_k], -1), torch.cat([o_p, d_p], -1))
        log(f"check K5 geo-fused field narrow (hidden {H}, {NB} blocks, exact sin, noise {noise}, "
            f"last_back {last_back}, legacy {legacy}): index agreement {agree * 100:.6f}%  "
            f"max|d| {mx:.3e} mean|d| {mean:.3e} p99|d| {p99:.3e}")
        log("  tolerance: index agreement 100% (the 1-NN distance is K1's elementwise form); "
            "max|d| <= 5e-3, mean|d| <= 1e-5 as K4 (FMA contraction in the geo columns and f32 "
            "sums in another order flip occasional bf16 roundings)")
        if agree != 1.0 or mx > 5e-3 or mean > 1e-5:
            raise AssertionError("K5 (narrow) disagrees with its plain version")

    # full width: the slice's field, rays and body
    full = _geo_case(inp, BATCH, inp["points"].shape[1])
    w = rm.flat_weights(gen.neural_field)
    fk, pk_ = rm.film_tables(inp["freq"], inp["phase"], meta["neural_field_blocks"])
    kw = dict(white_back=meta["white_back"], last_back=meta["last_back"],
              exact_sin=not meta["fast_math"])
    (o_k, d_k), (o_p, d_p), agree, packed, args = _geo_compare(w, fk, pk_, inp["z_vals"], full, S,
                                                               scaler, legacy, kw)
    mx = check_render_stats(f"K5 geo-fused field full width {tuple(o_k.shape)}", o_k, d_k, o_p,
                            d_p, f"index agreement {agree * 100:.6f}% (must be 100%)  ")
    if agree != 1.0:
        raise AssertionError("K5 (full width) picks other nearest vertices than its plain version")
    run_k = lambda: rm.field_render_geo_cuda(*args, legacy_mode=legacy, **kw)
    run_p = lambda: rm.field_render_geo_plain(*args, compute_dtype=torch.bfloat16,
                                              legacy_mode=legacy, **kw)
    runs = [rm.field_render_geo_cuda(*args, legacy_mode=legacy, return_index=True, **kw)
            for _ in range(2)]
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    log(f"  two K5 calls on the same inputs bit for bit (map, depth, nearest vertex): {same}")
    if not same:
        raise AssertionError("two K5 calls on the same inputs differ")
    del runs
    ms = cuda_ms(run_k, 3)
    plain_ms = cuda_ms(run_p, 1)
    bd = geo_bound(packed, o_k, meta, full["verts"].shape[1])
    log(f"  time: kernel {ms:.3f} ms (with its weight pack)  plain {plain_ms:.3f} ms  bound "
        f"{bd['bound_ms']:.3f} ms ({bd['bound_by']})")
    # the prologue's 1-NN scan: the same call over the body's first 8 vertices
    few = list(args)
    few[5], few[6] = (full[k][:, :8].contiguous() for k in ("verts", "vfeat"))
    scan_ms = ms - cuda_ms(lambda: rm.field_render_geo_cuda(*few, legacy_mode=legacy, **kw), 3)
    log(f"  of which the 1-NN scan over {full['verts'].shape[1]} vertices: {scan_ms:.3f} ms (the "
        "kernel's time less its time over 8 vertices)")
    lm = field_core_metrics(w, meta["neural_field_blocks"], "raymarch_geo.cu", True)
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms, scan_ms=scan_ms, **bd, **lm)


def check_train_unfolded(G, meta, cond, gcuda):
    """At the MAP3DBN training shapes: K5 with the noise column against its
    plain version, and one ``FieldRender`` forward + backward with
    ``fold_film=False`` (K4, then K8 + K9) against autograd through the
    plain unfolded render."""
    import torch

    from threedhumangan_tpu_torch.ops import raymarch as rm
    from threedhumangan_tpu_torch.ops import raymarch_bwd as rb
    from threedhumangan_tpu_torch.ops.geo import build_vertex_features

    bf16 = torch.bfloat16
    fr, ph, pts, zv, geo_feats, dirs, noise = train_field_inputs(G, meta, cond, gcuda)
    S, B = meta["num_steps"], pts.shape[0]
    scaler = 2.0 / meta["side_length"]
    legacy = meta.get("legacy_mode", False)
    field = G.neural_field
    w = rb.flat_weights(field)
    fk, pk_ = rm.film_tables(fr, ph, meta["neural_field_blocks"])
    wb, lb, exact = meta["white_back"], meta["last_back"], not meta["fast_math"]
    kw = dict(white_back=wb, last_back=lb, exact_sin=exact)
    vfeat = build_vertex_features(cond["tpose_vertices"], cond["fk_matrices"],
                                  cond["lbs_weights"])
    inp = dict(points=pts, dirs=dirs, vertices=cond["vertices"].float().contiguous(),
               skeletons=cond["skeletons_xyz"].float().contiguous(), vfeat=vfeat)
    case = _geo_case(inp, B, pts.shape[1])
    (o_k, d_k), (o_p, d_p), agree, packed, args = _geo_compare(w, fk, pk_, zv, case, S, scaler,
                                                               legacy, kw, noise)
    mx = check_render_stats(
        f"K5 geo-fused field training shapes {tuple(packed.shape)} raw packed, noise 0.5", o_k,
        d_k, o_p, d_p, f"index agreement {agree * 100:.6f}% (must be 100%)  ")
    if agree != 1.0:
        raise AssertionError("K5 (training shapes) picks other nearest vertices than its plain "
                             "version")
    run_k = lambda: rm.field_render_geo_cuda(*args, legacy_mode=legacy, **kw)
    run_p = lambda: rm.field_render_geo_plain(*args, compute_dtype=bf16, legacy_mode=legacy, **kw)
    k5_train = dict(max_abs_err=mx, ms=cuda_ms(run_k, 3), plain_ms=cuda_ms(run_p, 1),
                    **geo_bound(packed, o_k, meta, case["verts"].shape[1]))
    log(f"  time: kernel {k5_train['ms']:.3f} ms  plain {k5_train['plain_ms']:.3f} ms  bound "
        f"{k5_train['bound_ms']:.3f} ms ({k5_train['bound_by']})")
    del o_k, d_k, o_p, d_p, args, case
    torch.cuda.empty_cache()

    # FieldRender with the K4 forward, on the 38-column packed inputs
    pk = rm.pack_field_inputs(pts, geo_feats, dirs, scaler, noise)
    go = torch.randn(B, zv.shape[1], meta["feature_dim"] + 3, generator=gcuda, device="cuda")
    gd = torch.randn(B, zv.shape[1], 1, generator=gcuda, device="cuda")
    names = [n for n, _ in field.named_parameters()]

    def grads(fn, **extra):
        frq, phs = fr.clone().requires_grad_(), ph.clone().requires_grad_()
        out, depth = fn(field, pk, frq, phs, zv, S, wb, lb, bf16, exact, **extra)
        g = torch.autograd.grad((out * go).sum() + (depth * gd).sum(),
                                list(field.parameters()) + [frq, phs])
        return out.detach(), dict(zip(names + ["freq", "phase"], g))

    reset_counts()
    out_k, g_k = grads(rb.field_render_trainable, fold_film=False)
    torch.cuda.synchronize()
    counts = read_counts()
    out_u, g_u = grads(rb.field_render_unfolded)
    mx, mean, p99 = diff_stats(out_k, out_u)
    aerr = {k: rel_l2(g_k[k], g_u[k]) for k in g_u}
    worst = max(aerr, key=aerr.get)
    log(f"check FieldRender with fold_film=False at the training shapes (K4 forward, K8 + K9 "
        f"backward): forward vs the plain unfolded render max|d| {mx:.3e} mean|d| {mean:.3e} "
        f"p99|d| {p99:.3e}; grads rel L2 vs autograd worst {aerr[worst]:.2e} ({worst}); "
        f"launches {counts}")
    lim = RENDER_LIMITS
    log(f"  tolerance: forward mean|d| <= {lim['mean']:g} and p99|d| <= {lim['p99']:g} (as K4 "
        "alone); grads rel L2 <= 5e-2 per tensor (as K8+K9 vs autograd); K4, K8 and K9 launch "
        "and K2 does not")
    if mean > lim["mean"] or p99 > lim["p99"] or aerr[worst] > 5e-2:
        raise AssertionError("FieldRender (fold_film=False) disagrees with autograd")
    if min(counts[k] for k in ("K4", "K8", "K9")) <= 0 or counts["K2"]:
        raise AssertionError(f"FieldRender (fold_film=False) ran the wrong kernels: {counts}")
    # K4 alone at these shapes
    run_k = lambda: rm.field_render_unfolded_cuda(w, pk, fk, pk_, zv, S, **kw)
    run_p = lambda: rm.field_render_unfolded_plain(w, pk, fk, pk_, zv, S, compute_dtype=bf16, **kw)
    k4_train = dict(max_abs_err=mx, ms=cuda_ms(run_k, 3), plain_ms=cuda_ms(run_p, 1),
                    **field_bound(pk, out_k, meta, backward=0))
    log(f"  time: K4 kernel {k4_train['ms']:.3f} ms  plain {k4_train['plain_ms']:.3f} ms  bound "
        f"{k4_train['bound_ms']:.3f} ms ({k4_train['bound_by']})")
    return k4_train, k5_train


def reset_counts():
    from threedhumangan_tpu_torch.ops import (geo, knn, rasterize, raymarch, raymarch_bwd,
                                              synthesis_kernel, synthesis_train)

    for mod in (geo, knn, raymarch, rasterize, synthesis_kernel):
        mod.launches = 0
    rasterize.launches_bins = 0
    geo.launches_clusters = 0
    raymarch.launches_unfolded = raymarch.launches_geo = 0
    raymarch_bwd.launches_stats = raymarch_bwd.launches_bwd = raymarch_bwd.launches_wgrad = 0
    synthesis_train.launches_fwd = synthesis_train.launches_bwd = 0
    synthesis_train.launches_wgrad = 0


def read_counts():
    from threedhumangan_tpu_torch.ops import (geo, knn, rasterize, raymarch, raymarch_bwd,
                                              synthesis_kernel, synthesis_train)

    return {"K1": geo.launches, "K2": raymarch.launches, "K3": synthesis_kernel.launches,
            "K4": raymarch.launches_unfolded, "K5": raymarch.launches_geo, "K6": knn.launches,
            "K1/K6 vertex clusters": geo.launches_clusters,
            "K7": rasterize.launches, "K7 bins": rasterize.launches_bins,
            "K8": raymarch_bwd.launches_stats,
            "K9": raymarch_bwd.launches_bwd,
            "K9 weight-gradient reduction": raymarch_bwd.launches_wgrad,
            "K10": synthesis_train.launches_fwd, "K11": synthesis_train.launches_bwd,
            "K11 weight-gradient reduction": synthesis_train.launches_wgrad}


def run_train_slice(ts, batch, pre, meta, gcuda):
    """WARMUP + TIMED pair steps through ``train_step_pair``; the per-op or
    fused synthesis as ``meta['pallas_synthesis_train']`` says."""
    import torch

    from threedhumangan_tpu_torch.trainers.phase_trainer import train_step_pair

    fused = meta.get("pallas_synthesis_train", False)
    phase = meta["phases"][3]
    timer = PairTimer()
    before = [p.detach().clone() for p in list(ts.G.parameters()) + list(ts.D.parameters())]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls = []
    split = PreprocessSplit(pre)
    with split.patched():
        for it in range(WARMUP + TIMED):
            timer.on = split.on = it >= WARMUP
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, stats = train_step_pair(ts, batch, gcuda, meta, split, phase, 1e-4, 4e-4, 0.5,
                                        stage=timer.stage)
            torch.cuda.synchronize()
            if timer.on:
                walls.append(time.perf_counter() - t0)
    counts = read_counts()
    stage_ms = timer.per_pair_ms(TIMED)
    split_ms = split.per_pair_ms(TIMED)
    log(f"train ({'fused K10/K11' if fused else 'per-op'} synthesis): MAP3DBN D+G+R1 batch "
        f"{BATCH} bf16, phase slot 3, {TIMED} timed pair steps after {WARMUP} warm-up")
    labels = {"preprocess": "preprocess (camera + K7), D and G", "d_fakes": "D-step fakes",
              "d_step": "D fwd + R1 + bwd", "d_r1": "  of which R1", "d_optimizer": "D optimizer",
              "g_forward": "G fwd (G + D)", "g_backward": "G bwd",
              "g_optimizer": "G optimizer + EMA"}
    for k, lab in labels.items():
        log(f"  stage {lab:<36} {stage_ms.get(k, float('nan')):9.3f} ms/pair")
        if k == "preprocess":
            log("    split, ms/pair: " + ", ".join(f"{p} {v:.3f}" for p, v in split_ms.items())
                + f" (sum {sum(split_ms.values()):.3f})")
    total = sum(walls) / len(walls)
    top = sum(v for k, v in stage_ms.items() if k != "d_r1")
    log(f"  total {total * 1e3:.3f} ms/pair (host clock)  {BATCH / total:.3f} imgs/s  "
        f"stage sum {top:.3f} ms")
    log(f"  launches during the slice: {counts}")
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    losses = {k: float(stats[k][1]) for k in ("d_loss", "g_loss", "r1")}
    log(f"  last pair: {losses}")
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite losses {losses}")
    names = ([f"G.{n}" for n, _ in ts.G.named_parameters()]
             + [f"D.{n}" for n, _ in ts.D.named_parameters()])
    after = list(ts.G.parameters()) + list(ts.D.parameters())
    still = [n for n, a, b in zip(names, before, after) if torch.equal(a, b)]
    moved = len(after) - len(still)
    log(f"  parameter tensors moved: {moved} of {len(after)}; not moved (no gradient on this "
        f"path): {', '.join(still)}")
    if moved < len(after) // 2:
        raise AssertionError("the parameters did not move")
    path = ("K1", "K2", "K7", "K8", "K9") + (("K10", "K11") if fused else ())
    if min(counts[k] for k in path) <= 0:
        raise AssertionError(f"a kernel did not launch during the training slice: {counts}")
    if counts["K7 bins"] != counts["K7"]:
        raise AssertionError(f"K7 ran without its pre-pass, or the other way: {counts}")
    pairs = WARMUP + TIMED
    if fused and (counts["K10"] != 36 * pairs or counts["K11"] != 18 * pairs):
        raise AssertionError(f"expected 36 K10 and 18 K11 launches a pair: {counts}")
    if not fused and counts["K10"] + counts["K11"]:
        raise AssertionError(f"the per-op path launched K10/K11: {counts}")
    return dict(counts=counts, ms_per_pair=total * 1e3, imgs_per_s=BATCH / total,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, stage_ms=stage_ms,
                preprocess_ms=split_ms)


def run_trainer(smpl):
    """``Trainer`` on MAP3DBN at full width, batch 8, 32 synthetic images:
    4 steps with a checkpoint every 2 and EMA samples at step 4, then a
    second ``Trainer`` in the same directory resumes at step 4 and runs to 6.
    Returns the launch counts of both runs."""
    import contextlib
    import io
    import os
    import tempfile
    import types

    import torch

    from threedhumangan_tpu_torch import configs
    from threedhumangan_tpu_torch.trainers.base_trainer import Trainer

    config = configs.get_config(types.SimpleNamespace(config="MAP3DBN", tune="", variant=0))
    for k in config:
        if isinstance(k, int) and config[k]:
            config[k]["batch_size"] = BATCH
    config.update(dataset_length=32, dataroot="synthetic")
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        opt = types.SimpleNamespace(output_dir=tmp, device="cuda", model_save_interval=2,
                                    model_keep_interval=4, sample_interval=4, n_epochs=100,
                                    seed=SEED, tensorboard=1)
        walls = []
        for max_steps in (4, 6):
            t0 = time.perf_counter()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                trainer = Trainer(0, 1, opt, config, smpl_model=smpl)
                trainer.run(max_steps=max_steps)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            for line in out.getvalue().splitlines():
                log("  trainer: " + line)
            if trainer.step != max_steps:
                raise AssertionError(f"the trainer stopped at step {trainer.step}")
            del trainer
            torch.cuda.empty_cache()
        if "resumed from" not in out.getvalue() or "at step 4" not in out.getvalue():
            raise AssertionError("the second trainer did not resume at step 4")
        run_dir = os.path.join(tmp, config["name"])
        files = sorted(os.listdir(run_dir))
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        bad = [r for r in rows if not all(math.isfinite(v) for v in r.values())]
        if not rows or bad:
            raise AssertionError(f"metrics.jsonl: {len(rows)} rows, non-finite: {bad}")
        for want in ("00000004_checkpoint.npz", "00000006_checkpoint.npz",
                     "00000004_fixed_ema.png", "00000004_tilted_dseg.png"):
            if want not in files:
                raise AssertionError(f"{want} missing from {files}")
    counts = read_counts()
    log(f"trainer: MAP3DBN batch {BATCH} bf16, 32 synthetic images, fused synthesis: steps "
        f"0-4 (checkpoints at 2 and 4, EMA samples at 4) in {walls[0]:.1f} s, resumed at 4 and "
        f"ran to 6 in {walls[1]:.1f} s (set-up included); files {files}")
    log(f"  metrics.jsonl: {rows}")
    log(f"  launches during both runs: {counts}")
    need = ("K1", "K2", "K3", "K7", "K8", "K9", "K10", "K11")
    if min(counts[k] for k in need) <= 0:
        raise AssertionError(f"a kernel did not launch in the trainer: {counts}")
    return counts


# ---------------------------------------------------------------------------
# MAP3DBN512L at its own batch 32 on an SHHQ-layout tree
# ---------------------------------------------------------------------------

TREE_ITEMS = 64
TREE_SIZE = (1024, 512)  # SHHQ's images, masks and labels
L_BATCH = 32             # MAP3DBN512L's batch (configs/map3d.py)
L_WARMUP, L_TIMED = 2, 3
FILTERS = (0, 1, 2, 3, 4)  # PNG rows cycle through every filter type


def _tree_item(root, i, model, palette):
    """Item i (files i + 1): a smooth body-like image with its mask, palette
    body-part labels, an inversion latent and a VIBE-style SMPL prediction."""
    import pickle

    import numpy as np
    import torch

    from threedhumangan_tpu_torch.data.utils import write_png
    from threedhumangan_tpu_torch.models.smpl import batch_rodrigues

    rs = np.random.RandomState(1000 + i)
    H, W = TREE_SIZE
    y, x = np.mgrid[0:H, 0:W].astype(np.float32) / H
    cx, top, bot = 0.25 + 0.02 * rs.randn(), 0.08 + 0.02 * rs.rand(), 0.92 - 0.02 * rs.rand()
    yr = (y - top) / (bot - top)
    body = (np.abs(x - cx) < 0.05 + 0.06 * np.sin(np.pi * np.clip(yr, 0, 1))) & (yr > 0.12) & \
        (yr < 1)
    head = (x - cx) ** 2 + (y - top - 0.05) ** 2 < 0.05 ** 2
    sil = body | head
    img = np.empty((H, W, 3), np.float32)
    for c in range(3):
        f = rs.uniform(1, 4, 2)
        img[..., c] = 128 + 70 * np.sin(2 * np.pi * (f[0] * x + f[1] * y) + rs.uniform(0, 6))
        img[..., c] += sil * 50 * np.cos(9 * np.pi * yr + c)
    img += rs.randn(H, W, 3).astype(np.float32) * 1.5
    name = f"{i + 1:06d}"
    write_png(os.path.join(root, "images", name + ".png"),
              np.clip(img, 0, 255).astype(np.uint8), filters=FILTERS)
    write_png(os.path.join(root, "masks", name + ".png"), sil.astype(np.uint8) * 255,
              filters=FILTERS)
    seg = np.where(sil, 1 + np.clip(yr * 24, 0, 23), 0).astype(np.uint8)
    write_png(os.path.join(root, "body_seg", name + ".png"), seg, palette=palette,
              filters=FILTERS)
    np.save(os.path.join(root, "inversions", name + ".npy"),
            rs.randn(512).astype(np.float32))
    J = model.num_joints
    rot = batch_rodrigues(torch.as_tensor(0.2 * rs.randn(1, J, 3).astype(np.float32)))
    betas = torch.as_tensor(0.5 * rs.randn(1, 10).astype(np.float32))
    with torch.no_grad():
        out = model.forward(betas, rot, pose2rot=False)
    pred = {"orig_cam": np.asarray([[1.8, 1.8, 0.01 * rs.randn(), 0.01 * rs.randn()]],
                                   np.float32),
            "joints": out["joints"].numpy(), "full_pose": rot.numpy(),
            "tpose_vertices": out["tpose_vertices"].numpy(),
            "fk_matrices": out["fk_matrices"].numpy(), "lbs_weights": model.lbs_weights.numpy(),
            "betas": betas.numpy()}
    with open(os.path.join(root, "smpl", name + ".pkl"), "wb") as f:
        pickle.dump(pred, f)


def write_shhq_tree(root):
    """An SHHQ-layout tree of TREE_ITEMS items at SHHQ's 1024 x 512, and its
    SMPL_NEUTRAL.pkl written from the 6,890-vertex synthetic SMPL model (its
    grid keeps 6,844) and loaded back through ``get_smpl_model``.  Returns
    (the loaded model, MB written, seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from threedhumangan_tpu_torch.models.smpl import (get_smpl_model, save_smpl_model,
                                                      synthetic_smpl_model)

    t0 = time.perf_counter()
    for sub in ("images", "masks", "body_seg", "inversions", "smpl"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    src = synthetic_smpl_model(num_verts=6890, num_faces=13776)
    asset = os.path.join(root, "SMPL_NEUTRAL.pkl")
    save_smpl_model(src, asset)
    model = get_smpl_model(asset)
    if not (model.num_verts == src.num_verts and len(model.faces) == 13776
            and bool((model.posedirs == src.posedirs).all())):
        raise AssertionError("SMPL_NEUTRAL.pkl did not load back as the model it was written from")
    palette = np.random.RandomState(5).randint(0, 256, (25, 3)).astype(np.uint8)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda i: _tree_item(root, i, model, palette), range(TREE_ITEMS)))
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    return model, size / 1e6, time.perf_counter() - t0


def run_512l_trainer(tree, smpl, out_dir):
    """``Trainer`` on MAP3DBN512L (only ``dataroot`` and ``dataset_length``
    pointed at the tree): L_WARMUP + L_TIMED steps at batch L_BATCH with the
    trainer's own batch_split and remat.  Each pair is timed by the host
    clock synchronized at both ends and split into stages by CUDA events
    (``PairTimer``, the timed pairs); peak memory over the timed pairs; the
    loader's ms a batch (the dataset's numpy batches) beside it."""
    import contextlib
    import io
    import types

    import numpy as np
    import torch

    from threedhumangan_tpu_torch import configs
    from threedhumangan_tpu_torch.data import native
    from threedhumangan_tpu_torch.data.dataset import SHHQDataset
    from threedhumangan_tpu_torch.trainers import phase_trainer
    from threedhumangan_tpu_torch.trainers.base_trainer import Trainer

    config = configs.get_config(types.SimpleNamespace(config="MAP3DBN512L", tune="", variant=0))
    config.update(dataroot=tree, dataset_length=TREE_ITEMS)
    opt = types.SimpleNamespace(output_dir=out_dir, device="cuda", model_save_interval=10**9,
                                model_keep_interval=10**9, sample_interval=0, n_epochs=100,
                                seed=SEED, tensorboard=0)
    timer, walls, state = PairTimer(), [], {}
    real = phase_trainer.train_step_pair

    def timed_pair(ts, data, gen, meta, pre, phase, lr_g, lr_d, noise, draws=None, stage=None):
        timed = trainer.step >= L_WARMUP
        if timed and "counts" not in state:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state["counts"] = read_counts()
        timer.on = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, stats = real(ts, data, gen, meta, pre, phase, lr_g, lr_d, noise, draws, timer.stage)
        torch.cuda.synchronize()
        if timed:
            walls.append(time.perf_counter() - t0)
        state["stats"] = stats
        return ts, stats

    reset_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    phase_trainer.train_step_pair = timed_pair
    try:
        with contextlib.redirect_stdout(printed):
            trainer = Trainer(0, 1, opt, config, smpl_model=smpl)
            setup_s = time.perf_counter() - t0
            before = [p.detach().clone() for p in trainer.ts.G.parameters()]
            lat0 = trainer.ts.G.latent_pool.latents[0].detach().cpu().numpy()
            trainer.run(max_steps=L_WARMUP + L_TIMED)
    finally:
        phase_trainer.train_step_pair = real
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in printed.getvalue().splitlines():
        log("  trainer: " + line)
    meta = trainer._stage_meta
    split, remat = int(meta["batch_split"]), bool(meta.get("remat_synthesis"))
    if not isinstance(trainer.dataset, SHHQDataset) or trainer.step != L_WARMUP + L_TIMED:
        raise AssertionError(f"the trainer ran {type(trainer.dataset).__name__} to step "
                             f"{trainer.step}")
    if native.get_lib() is None:
        raise AssertionError("the native loader core did not build: the loader ran its numpy "
                             "versions")
    inv = np.load(os.path.join(tree, "inversions", "000001.npy"))[:lat0.shape[0]]
    if not np.array_equal(lat0, 2 * inv):
        raise AssertionError("the latent pool did not start at the tree's inversions x 2")
    losses = {k: float(v[1]) for k, v in state["stats"].items() if k in ("d_loss", "g_loss")}
    moved = sum(not torch.equal(a, b) for a, b in zip(before, trainer.ts.G.parameters()))
    if not all(math.isfinite(v) for v in losses.values()) or moved < len(before) // 2:
        raise AssertionError(f"the 512L run: losses {losses}, {moved} generator tensors moved")
    per_pair = {k: (counts[k] - state["counts"][k]) / L_TIMED for k in counts}
    if min(per_pair[k] for k in ("K1", "K2", "K7", "K8", "K9", "K10", "K11")) <= 0:
        raise AssertionError(f"a kernel did not launch in the 512L pairs: {per_pair}")
    # per micro-batch: K10 18 in the D-step fakes, 18 in the G forward and,
    # under remat, again in the G backward up to the last tensor a block saves
    if per_pair["K11"] != 18 * split or not (
            (36 * split < per_pair["K10"] <= 54 * split) if remat
            else per_pair["K10"] == 36 * split):
        raise AssertionError(f"K10/K11 launches a pair at split {split}, remat {remat}: "
                             f"{per_pair}")
    loader = trainer.loader_fn(seed=1, shuffle=True)
    loads = []
    for _ in range(2):
        t1 = time.perf_counter()
        batch = next(loader)
        loads.append(time.perf_counter() - t1)
    img, msk = batch["images"], batch["masks"]
    if (img.shape != (L_BATCH, meta["gen_height"], meta["gen_width"], 3)
            or not (img[msk < 0] == 1.0).all()):
        raise AssertionError(f"the loader's images: {img.shape}, white background "
                             f"{(img[msk < 0] == 1.0).all()}")
    stage_ms = timer.per_pair_ms(L_TIMED)
    ms = 1e3 * sum(walls) / len(walls)
    with open(os.path.join(trainer.output_dir, "metrics.jsonl")) as f:
        metrics_jsonl = f.read()  # the apps phase exports it (the directory goes)
    res = dict(batch=L_BATCH, batch_split=split, micro_batch=L_BATCH // split, remat=remat,
               ms_per_pair=ms, ms_per_pair_runs=[1e3 * w for w in walls],
               imgs_per_s=L_BATCH / (ms / 1e3), stage_ms=stage_ms, peak_gib=peak,
               loader_ms_per_batch=1e3 * sum(loads) / len(loads), setup_s=setup_s, run_s=run_s,
               launches_per_pair=per_pair, counts=counts, losses=losses,
               metrics_jsonl=metrics_jsonl)
    log(f"train 512L: MAP3DBN512L batch {L_BATCH} on the SHHQ tree through Trainer, "
        f"{L_TIMED} timed pairs after {L_WARMUP}: batch_split {split} (micro-batch "
        f"{L_BATCH // split}), remat {remat}")
    labels = {"preprocess": "preprocess (camera + K7), D and G", "d_fakes": "D-step fakes",
              "d_step": "D fwd + bwd", "d_optimizer": "D optimizer",
              "g_forward": "G fwd (G + D)", "g_backward": "G bwd",
              "g_optimizer": "G optimizer + EMA"}
    for k, lab in labels.items():
        log(f"  stage {lab:<36} {stage_ms.get(k, float('nan')):10.3f} ms/pair")
    log(f"  total {ms:.3f} ms/pair (host clock; runs "
        + ", ".join(f"{1e3 * w:.3f}" for w in walls) + f")  {L_BATCH / (ms / 1e3):.3f} imgs/s  "
        f"stage sum {sum(v for k, v in stage_ms.items() if k != 'd_r1'):.3f} ms")
    log(f"  peak memory {peak:.2f} GiB over the timed pairs; loader {res['loader_ms_per_batch']:.1f}"
        f" ms a batch of {L_BATCH} (native core; host, one thread) beside {ms:.1f} ms a pair; "
        f"set-up {setup_s:.1f} s, whole run {run_s:.1f} s")
    log(f"  launches a pair: {per_pair}")
    log(f"  last pair: {losses}; generator tensors moved {moved} of {len(before)}")
    del trainer
    torch.cuda.empty_cache()
    return res


def check_field_512l(G, meta, cond, gcuda, micro):
    """K2 (nerf-noise column), K8 and K9 at MAP3DBN512L's width on the
    tree's conditions: each kernel against its plain version on the last two
    images; the full batch's launch bit-equal on those two images to their
    own launch (K2's map and depth, K8's sigma and f.g, K9's per-image
    freq/phase gradients); K9's batch-reduced weight gradients against the
    plain f32 X^T Y summed over its launches; times at ``micro`` images."""
    import torch

    from threedhumangan_tpu_torch.ops import raymarch as rm
    from threedhumangan_tpu_torch.ops import raymarch_bwd as rb

    bf16 = torch.bfloat16
    S, W, H = meta["num_steps"], meta["render_width"], meta["render_height"]
    field, NB = G.neural_field, meta["neural_field_blocks"]
    fr, ph, pts, zv, geo, dirs, noise = train_field_inputs(G, meta, cond, gcuda)
    B = pts.shape[0]
    with torch.no_grad():
        pk = rm.pack_field_inputs(pts, geo, dirs, 2.0 / meta["side_length"], noise).to(bf16)
    del pts, geo, dirs, noise
    go = torch.randn(B, W * H, meta["feature_dim"] + 3, generator=gcuda, device="cuda")
    gd = torch.randn(B, W * H, 1, generator=gcuda, device="cuda")
    exact, wb, lb = not meta["fast_math"], meta["white_back"], meta["last_back"]
    two, sub = slice(B - 2, B), lambda t, s: t[s].contiguous()
    out = {}

    # K2
    wt = rm.flat_weights(field)
    k2 = lambda s: rm.field_render_cuda(wt, rm.film_tables(fr[s], ph[s], NB), sub(pk, s),
                                        sub(zv, s), S, wb, lb, exact)
    with torch.no_grad():
        sh, pi = rm.fold_film_tables(field, fr[two], ph[two], bf16)
    (o2, d2), (op_, dp_) = k2(two), rm.field_render_plain(sh, pi, sub(pk, two), sub(zv, two), S,
                                                         wb, lb, bf16, exact)
    (oB, dB) = k2(slice(0, B))
    same2 = torch.equal(oB[two], o2) and torch.equal(dB[two], d2)
    mx, mean, p99 = diff_stats(o2, op_)
    dmean = diff_stats(d2, dp_)[1]
    log(f"check K2 at 512L, noise 0.5, {tuple(pk.shape)} packed: last two images vs plain: map "
        f"max|d| {mx:.3e} mean|d| {mean:.3e} p99|d| {p99:.3e}, depth mean|d| {dmean:.3e}; "
        f"bit-equal in the {B}-image launch: {same2}")
    log("  tolerance: map mean|d| <= 2e-3, p99|d| <= 5e-3, depth mean|d| <= 1e-4 (the "
        "generation check's); the batch's launch bit-equal image by image")
    if mean > 2e-3 or p99 > 5e-3 or dmean > 1e-4 or not same2:
        raise AssertionError("K2 at 512L disagrees with its plain version or across batches")
    m = slice(0, micro)
    out["K2"] = dict(max_abs_err=mx, ms=cuda_ms(lambda: k2(m), 3),
                     plain_ms=cuda_ms(lambda: rm.field_render_plain(
                         sh, pi, sub(pk, two), sub(zv, two), S, wb, lb, bf16, exact), 1),
                     plain_images=2, images=micro, **field_bound(pk[m], oB[m], meta, backward=0))
    del oB, dB, o2, d2, op_, dp_, sh, pi

    # K8 and K9
    w = rb.flat_weights(field)
    smx, gmx, errs, k9mx, _ = _bwd_compare(w, sub(pk, two), fr[two], ph[two], sub(zv, two),
                                           sub(go, two), sub(gd, two), S, wb, lb, exact)
    tabs = lambda s: rb.film_tables(fr[s], ph[s], NB)
    fk2, pk2_ = tabs(two)
    s2, g2 = rb.field_stats_cuda(w, sub(pk, two), fk2, pk2_, sub(go, two), S, exact_sin=exact)
    fkB, pkB_ = tabs(slice(0, B))
    sB, gB = rb.field_stats_cuda(w, pk, fkB, pkB_, go, S, exact_sin=exact)
    same8 = torch.equal(sB[two], s2) and torch.equal(gB[two], g2)
    coef2, dsig2 = rb.backward_tables(s2, g2, sub(zv, two), sub(go, two), sub(gd, two), wb, lb)
    _, df2, dp2 = rb.field_bwd_step_cuda(w, sub(pk, two), fk2, pk2_, sub(go, two), coef2, dsig2,
                                         S, exact_sin=exact)
    coefB, dsigB = rb.backward_tables(sB, gB, zv, go, gd, wb, lb)
    op = rb.field_bwd_step_operands(w, pk, fkB, pkB_, go, coefB, dsigB, S, exact_sin=exact)
    gw, ref, parts = {}, {}, []
    for b0 in range(0, B, rb.IMAGES_PER_LAUNCH):
        rb.field_bwd_step_body(op, b0)
        for k, g in rb.field_bwd_step_products(op, b0).items():
            gw[k] = gw[k] + g if k in gw else g
        for k, (X, Y) in rb.field_bwd_step_pairs(op, b0).items():
            r = rb.wgrad_plain(X, Y)
            ref[k] = ref[k] + r if k in ref else r
        parts.append(rb.field_bwd_step_partials(op, b0))
    _, dfB, dpB = rb.field_bwd_step_reduce(op, gw, torch.cat(parts, 0))
    same9 = torch.equal(dfB[two], df2) and torch.equal(dpB[two], dp2)
    red = max(float((gw[k] - ref[k]).abs().max() / (ref[k].abs().max() + 1e-30)) for k in gw)
    log(f"check K8/K9 at 512L (hidden {meta['hidden_dim']}, {NB} blocks, R {W * H}, S {S}, noise "
        f"0.5): last two images vs plain: K8 sigma max|d| {smx:.3e} f.g max|d| {gmx:.3e}; K9 "
        f"worst rel L2 {max(errs.values()):.2e} ({max(errs, key=errs.get)}); the {B}-image "
        f"launches bit-equal on them: K8 {same8}, K9 freq/phase {same9}; K9's weight gradients "
        f"over the {B} images vs the plain f32 X^T Y: max|d|/max|ref| {red:.3e}")
    log("  tolerance: K8 max|d| <= 5e-2, K9 rel L2 <= 2e-2 per tensor (the MAP3DBN full-width "
        "check's); bit-equal image by image; the weight gradients within 1e-3 of max")
    if smx > 5e-2 or gmx > 5e-2 or max(errs.values()) > 2e-2 or not (same8 and same9) or red > 1e-3:
        raise AssertionError("K8/K9 at 512L disagree with their references or across batches")
    del op, gw, ref, parts, sB, gB, coefB, dsigB
    torch.cuda.empty_cache()
    fkm, pkm_ = tabs(m)
    sm, gm_ = rb.field_stats_cuda(w, pk[m], fkm, pkm_, go[m], S, exact_sin=exact)
    cm, dm = rb.backward_tables(sm, gm_, zv[m], go[m], gd[m], wb, lb)
    out["K8"] = dict(max_abs_err=smx, images=micro, plain_images=2,
                     ms=cuda_ms(lambda: rb.field_stats_cuda(w, pk[m], fkm, pkm_, go[m], S,
                                                            exact_sin=exact), 3),
                     plain_ms=cuda_ms(lambda: rb.field_stats_plain(
                         w, sub(pk, two), fk2, pk2_, sub(go, two), S, exact_sin=exact), 1),
                     **field_bound(pk[m], go[m], meta, backward=1))
    out["K9"] = dict(max_abs_err=k9mx, images=micro, plain_images=2, weight_gradient_rel=red,
                     ms=cuda_ms(lambda: rb.field_bwd_step_cuda(w, pk[m], fkm, pkm_, go[m], cm, dm,
                                                               S, exact_sin=exact), 2),
                     plain_ms=cuda_ms(lambda: rb.field_bwd_step_plain(
                         w, sub(pk, two), fk2, pk2_, sub(go, two), coef2, dsig2, S,
                         exact_sin=exact), 1),
                     **field_bound(pk[m], go[m], meta, backward=2))
    for k in ("K2", "K8", "K9"):
        r = out[k]
        log(f"  time at {micro} images: {k} kernel {r['ms']:.3f} ms  plain (2 images) "
            f"{r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
    return out


def check_half_blocks_512l(gcuda, B, H, W, C, hid, micro):
    """K10/K11 at MAP3DBN512L's widths on B images of H x W, spatial
    without the fixed row (the isolated mode's mod blocks) and rank-1: each
    against its plain version on the last two images; the B-image launch's
    last two images bit-equal to their own launch with the same moments
    (K10's output; K11's dh and dstyle, or its per-image dgamma/dbeta); its
    batch-reduced weight gradients against the plain f32 X^T Y; times at
    ``micro`` images."""
    import torch

    from threedhumangan_tpu_torch.ops import synthesis_train as st

    per_image = ("h", "style", "gam", "bet")
    res = {}
    for spatial, name in ((True, "spatial"), (False, "rank1")):
        args, g = _half_block_case(B, H, W, C, C, C, hid, spatial, False, gcuda)
        cut = lambda s: {k: (v[s].contiguous() if k in per_image and v is not None else v)
                         for k, v in args.items()}
        two = slice(B - 2, B)
        a2, g2 = cut(two), g[two].contiguous()
        b2 = {k: v for k, v in a2.items() if k != "c"}
        o2 = st.half_block_forward_cuda(**a2)
        oB = st.half_block_forward_cuda(**args)
        same10 = torch.equal(oB[two], o2)
        del oB
        _, mean, _ = diff_stats(o2, st.half_block_forward(**a2))
        d2 = st.half_block_backward_cuda(**b2, g=g2)
        dp = st.half_block_backward(**b2, g=g2)
        errs = {k: rel_l2(d2[k], dp[k]) for k in dp if dp[k] is not None}
        del dp
        bargs = {k: v for k, v in args.items() if k != "c"}
        dB = st.half_block_backward_cuda(**bargs, g=g)
        keys = ("dh", "dsty") if spatial else ("dh", "dgam", "dbet")
        same11 = all(torch.equal(dB[k][two], d2[k]) for k in keys)
        del dB
        torch.cuda.empty_cache()
        log(f"check K10/K11 at 512L ({B}, {H}, {W}, {C}), hidden {hid}, {name}: last two images "
            f"vs plain: K10 mean|d| {mean:.3e}, K11 worst rel L2 {max(errs.values()):.2e} "
            f"({max(errs, key=errs.get)}); the {B}-image launch bit-equal on them: K10 "
            f"{same10}, K11 {'/'.join(keys)} {same11}")
        log("  tolerance: K10 mean|d| <= 2e-3, K11 rel L2 <= 1e-2 per tensor (the MAP3DBN "
            "check's); bit-equal image by image")
        if mean > 2e-3 or max(errs.values()) > 1e-2 or not (same10 and same11):
            raise AssertionError(f"K10/K11 ({name}) at 512L disagree with their plain versions "
                                 "or across batches")
        op = st.bwd_operands(**bargs, g=g)
        st.bwd_body(op)
        wg = check_wgrad(f"K11 512L {name}, {B} images",
                         [(k, X, Y) for k, (X, Y) in op["prods"].items()])
        del op
        torch.cuda.empty_cache()
        m = slice(0, micro)
        am = cut(m)
        bm = {k: v for k, v in am.items() if k != "c"}
        gm = g[m].contiguous()
        P = micro * H * W
        fl, bl = _half_block_flops(P, C, C, C if spatial else 0, hid if spatial else 0, spatial)
        io = 2 * P * C * (3 if spatial else 2)
        io_bwd = io + 2 * P * C * (2 if spatial else 1)
        res[name] = dict(
            k10=dict(max_abs_err=mean, images=micro, plain_images=2,
                     ms=cuda_ms(lambda: st.half_block_forward_cuda(**am), 3),
                     plain_ms=cuda_ms(lambda: st.half_block_forward(**a2), 1), **bound(fl, io)),
            k11=dict(max_abs_err=max(errs.values()), images=micro, plain_images=2,
                     ms=cuda_ms(lambda: st.half_block_backward_cuda(**bm, g=gm), 2),
                     plain_ms=cuda_ms(lambda: st.half_block_backward(**b2, g=g2), 1),
                     weight_gradient_reduction=wg, **bound(bl, io_bwd)))
        for k in ("k10", "k11"):
            r = res[name][k]
            log(f"  time at {micro} images: {k.upper()} {name} kernel {r['ms']:.3f} ms  plain "
                f"(2 images) {r['plain_ms']:.3f} ms  bound {r['bound_ms']:.3f} ms "
                f"({r['bound_by']})")
        del args, g, a2, g2, b2, am, bm, gm, d2, o2
        torch.cuda.empty_cache()
    return res


def check_remat_on_card(smpl, gcuda):
    """One fused G step of MAP3DBN at batch BATCH with remat off, one with
    it on and one off again, from the same state and draws: the gradients
    within the fused path's tolerance (the two runs without remat give the
    spread of the step itself), and the synthesis BN running stats, their
    counts and the spectral-norm u identical."""
    import torch

    from threedhumangan_tpu_torch.data.dataset import (SyntheticSHHQDataset, iterate_batches,
                                                       to_tensors)
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.trainers import phase_trainer as pt

    base = dict(train_meta(), pallas_synthesis_train=True)
    batch = to_tensors(next(iterate_batches(SyntheticSHHQDataset(smpl_model=smpl, **base), BATCH,
                                            shuffle=False)))
    pre = get_preprocessor(base, smpl)
    z = torch.randn(BATCH, base["latent_dim"], generator=gcuda, device="cuda")
    draws = {"z": z, "coin": torch.tensor(0.3, device="cuda"),
             "h_rotation": torch.zeros(BATCH, device="cuda"),
             "v_rotation": torch.zeros(BATCH, device="cuda")}
    real, runs = pt.adam_step, []
    for remat in (False, True, False):
        meta = dict(base, remat_synthesis=remat)
        ts = pt.init_train_state(meta, torch.Generator().manual_seed(SEED))
        seen = []

        def adam_step(opt, grads, lr, clip):
            if opt is ts.opt_G:
                seen.append([g.float().clone() for g in grads])
            return real(opt, grads, lr, clip)

        pt.adam_step = adam_step
        torch.cuda.reset_peak_memory_stats()
        try:
            pt.g_train_step(ts, batch, torch.Generator(device="cuda").manual_seed(SEED), 1e-4,
                            0.5, pre, meta, meta["phases"][3], draws=draws)
        finally:
            pt.adam_step = real
        bufs = {k: v.clone() for k, v in ts.G.named_buffers()
                if k.startswith("synthesis_network.network.")}
        runs.append((seen[0], bufs, torch.cuda.max_memory_allocated() / 2**30))
        del ts
        torch.cuda.empty_cache()
    (g0, b0, p0), (g1, b1, p1), (g2, b2, _) = runs
    rel = lambda x, y: float(torch.sqrt(sum(torch.sum(torch.square(a - b)) for a, b in zip(x, y))
                                        / sum(torch.sum(torch.square(a)) for a in x)))
    on_off, off_off = rel(g0, g1), rel(g0, g2)
    same = all(torch.equal(b0[k], b1[k]) and torch.equal(b0[k], b2[k]) for k in b0)
    log(f"check remat on the card: one fused MAP3DBN G step at batch {BATCH}: gradients rel L2 "
        f"remat on vs off {on_off:.3e}, off vs off {off_off:.3e}; BN running stats, counts and "
        f"spectral-norm u identical: {same}; G-step peak {p1:.2f} GiB with remat, {p0:.2f} "
        f"without")
    log("  tolerance: rel L2 <= 1e-2 (the fused K11 check's; the recompute runs the same "
        "kernels on the same inputs, and cuDNN's backward through D need not sum in one order)")
    if on_off > 1e-2 or not same:
        raise AssertionError("the remat G step differs from the plain one")
    return dict(grad_rel_l2=on_off, grad_rel_l2_off_vs_off=off_off, state_identical=same,
                peak_gib_remat=p1, peak_gib_plain=p0)


def run_512l(gcuda):
    """The MAP3DBN512L phase: the tree, the trainer, the kernels at its
    shapes (the checks on L_BATCH images, the times at the trainer's
    micro-batch), and remat against no remat on the card."""
    import tempfile

    import torch

    from threedhumangan_tpu_torch import configs
    from threedhumangan_tpu_torch.data.dataset import SHHQDataset, iterate_batches, to_tensors
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.trainers.phase_trainer import init_train_state

    with tempfile.TemporaryDirectory() as tmp:
        tree = os.path.join(tmp, "shhq")
        smpl, mb, secs = write_shhq_tree(tree)
        log(f"tree: {TREE_ITEMS} SHHQ-layout items at {TREE_SIZE[0]} x {TREE_SIZE[1]} (PNG rows "
            f"cycling through the five filter types, palette body_seg), {mb:.1f} MB in "
            f"{secs:.1f} s; SMPL_NEUTRAL.pkl loaded back: {smpl.num_verts} vertices, "
            f"{len(smpl.faces)} faces")
        train = run_512l_trainer(tree, smpl, os.path.join(tmp, "out"))
        meta = dict(configs.extract_metadata(configs.MAP3DBN512L, 0), dataroot=tree,
                    dataset_length=TREE_ITEMS)
        ds = SHHQDataset(smpl_model=smpl, **{k: v for k, v in meta.items()
                                             if k not in ("dataset", "name", "batch_size")})
        batch = to_tensors(next(iterate_batches(ds, L_BATCH, shuffle=False)))
        pre = get_preprocessor(meta, smpl)
        cond = pre(batch, rotate=True, generator=gcuda)
        del batch
        log(f"check the kernels at MAP3DBN512L's shapes on the tree's first {L_BATCH} items "
            f"(times at the trainer's micro-batch, {train['micro_batch']} images)")
        k7, k7_device = check_raster(pre, cond, meta)
        k1 = check_geo_train(meta, cond, gcuda)
        G = init_train_state(meta, torch.Generator().manual_seed(SEED)).G
        field = check_field_512l(G, meta, cond, gcuda, train["micro_batch"])
        del G, cond
        torch.cuda.empty_cache()
        hb = check_half_blocks_512l(gcuda, L_BATCH, meta["gen_height"], meta["gen_width"],
                                    meta["hidden_dim"], 128, train["micro_batch"])
    remat = check_remat_on_card(smpl, gcuda)
    return dict(train=train, k1=k1, k7=k7, k7_device=k7_device, hb=hb, remat=remat, **field)


# ---------------------------------------------------------------------------
# 12. ranks: the trainer across processes
# ---------------------------------------------------------------------------

RANKS_STEPS = 4       # steps of each two-rank run of phase 12 (b); it saves at 2
RANKS_A_STEPS = 8     # steps of each run of phase 12 (a): one cycle of the phase slots
RANKS_TIMEOUT = 600   # seconds the two rank processes may take, together


def deterministic(on):
    """PyTorch's deterministic algorithms, under which phase 12 compares runs
    bit for bit: in the default mode two identical MAP3DBN runs on the card
    differ in the last bits of the first G step's gradients (~1e-7), so a
    difference there would not show that the process group or the resume
    changed anything.  cuBLAS needs CUBLAS_WORKSPACE_CONFIG for it."""
    import torch

    if on:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(on)


def ranks_config(batch):
    """MAP3DBN at full width, global batch ``batch``, 32 synthetic images."""
    import types

    from threedhumangan_tpu_torch import configs

    config = configs.get_config(types.SimpleNamespace(config="MAP3DBN", tune="", variant=0))
    for k in config:
        if isinstance(k, int) and config[k]:
            config[k]["batch_size"] = batch
    config.update(dataset_length=32, dataroot="synthetic")
    return config


def replica_state(trainer):
    """A host copy of what every rank must hold alike: G's and D's
    parameters and buffers (BN running stats, u), the EMA and both Adam
    states."""
    import torch

    ts = trainer.ts
    host = lambda v: v.detach().cpu().clone()
    out = {f"G.{k}": host(v) for k, v in ts.G.state_dict().items()}
    out.update({f"D.{k}": host(v) for k, v in ts.D.state_dict().items()})
    out.update({f"ema.{k}": host(v) for k, v in ts.ema["params"].items()})
    for name, opt in (("opt_G", ts.opt_G), ("opt_D", ts.opt_D)):
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": host(v) for k, v in st.items() if torch.is_tensor(v)})
    return out


def state_diff(a, b):
    """The names of the tensors in which two replica states differ."""
    import torch

    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or not torch.equal(a[k], b[k]))


def timed_trainer(config, out_dir, rank=0, world=1, smpl=None, sample_interval=0,
                  save_interval=10**9, steps=RANKS_STEPS):
    """``Trainer(rank, world)`` run to ``steps``; each pair timed by the host
    clock synchronized at both ends.  Returns (trainer, ms of each pair,
    what it printed)."""
    import contextlib
    import io
    import types

    import torch

    from threedhumangan_tpu_torch.trainers import phase_trainer
    from threedhumangan_tpu_torch.trainers.base_trainer import Trainer

    opt = types.SimpleNamespace(output_dir=out_dir, device="cuda",
                                model_save_interval=save_interval,
                                model_keep_interval=save_interval, sample_interval=sample_interval,
                                n_epochs=100, seed=SEED, tensorboard=0, bs_factor=1)
    real, walls = phase_trainer.train_step_pair, []

    def timed_pair(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        return out

    printed = io.StringIO()
    phase_trainer.train_step_pair = timed_pair
    try:
        with contextlib.redirect_stdout(printed):
            trainer = Trainer(rank, world, opt, config, smpl_model=smpl)
            trainer.run(max_steps=steps)
    finally:
        phase_trainer.train_step_pair = real
    if trainer.step != steps:
        raise AssertionError(f"rank {rank}: the trainer stopped at step {trainer.step}")
    return trainer, walls, printed.getvalue()


def run_ranks_nccl1(smpl):
    """(a) ``Trainer`` on MAP3DBN b8 for RANKS_A_STEPS steps without a
    process group and in an NCCL group of one rank, twice each in turns:
    every run bit-equal to the first; ms a pair of each (the difference is
    the group's own cost: its collectives)."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as tdist

    from threedhumangan_tpu_torch.parallel import dist

    config, runs = ranks_config(BATCH), []
    deterministic(True)
    with tempfile.TemporaryDirectory() as tmp:
        for i, grouped in enumerate((False, True, False, True)):
            if grouped:
                tdist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_init{i}",
                                         rank=0, world_size=1,
                                         timeout=datetime.timedelta(seconds=300))
            n0 = dist.collectives
            reset_counts()
            try:
                trainer, walls, _ = timed_trainer(config, os.path.join(tmp, str(i)), smpl=smpl,
                                                  steps=RANKS_A_STEPS)
            finally:
                if grouped:
                    tdist.destroy_process_group()
            runs.append(dict(grouped=grouped, state=replica_state(trainer), ms=walls,
                             counts=read_counts(), collectives=dist.collectives - n0))
            del trainer
            torch.cuda.empty_cache()
    deterministic(False)
    steady = lambda r: sum(r["ms"][1:]) / len(r["ms"][1:])
    mean = lambda g: sum(steady(r) for r in runs if r["grouped"] == g) / 2
    log(f"ranks (a): Trainer MAP3DBN b{BATCH} bf16 fused synthesis, {RANKS_A_STEPS} steps (the "
        f"8 phase slots), without a group and in an NCCL group of one rank, in turns "
        f"(deterministic algorithms on)")
    for r in runs:
        log(f"  {'NCCL group of 1' if r['grouped'] else 'no group'}: ms a pair (host clock) "
            + ", ".join(f"{w:.3f}" for w in r["ms"])
            + f"; mean of pairs 2-{RANKS_A_STEPS} {steady(r):.3f}; collectives "
            f"{r['collectives']}")
    cost = mean(True) - mean(False)
    per_step = sum(r["collectives"] for r in runs) / 2 / RANKS_A_STEPS
    log(f"  the group's own cost: {cost:.3f} ms a pair ({mean(True):.3f} against "
        f"{mean(False):.3f}), {per_step:.1f} collectives a step (stats pulls, the start-up "
        f"checksum and the closing barrier included)")
    for r in runs[1:]:
        diff = state_diff(runs[0]["state"], r["state"])
        if diff:
            raise AssertionError(f"a run {'in' if r['grouped'] else 'without'} the group "
                                 f"differs from the first: {diff[:8]}")
    log(f"  states after {RANKS_A_STEPS} steps: every run's {len(runs[0]['state'])} tensors "
        f"bit-equal to the first run's")
    if any(bool(r["collectives"]) != r["grouped"] for r in runs):
        raise AssertionError(f"collectives: {[(r['grouped'], r['collectives']) for r in runs]}")
    return dict(ms_no_group=mean(False), ms_nccl1=mean(True), counts=runs[-1]["counts"])


def tiny_two_rank_step(rank, world):
    """(c) one TINY D+G pair of this rank (2 images of a global 4, its own
    draws) on the card and on the CPU, in the same gloo group: the stats of
    each, and the ranks' replicas held equal after each."""
    import torch

    from threedhumangan_tpu_torch import configs
    from threedhumangan_tpu_torch.data.dataset import (
        SyntheticSHHQDataset, iterate_batches, to_tensors)
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
    from threedhumangan_tpu_torch.parallel import dist
    from threedhumangan_tpu_torch.trainers.phase_trainer import init_train_state, train_step_pair

    meta = dict(configs.extract_metadata(configs.MAP3DBN_TINY, 0))
    meta.update(nerf_noise=0, perturb_rays=False, use_mixed_precision=True,
                pallas_synthesis_train=True)
    smpl = synthetic_smpl_model(num_verts=384, num_faces=512)
    batch = next(iterate_batches(SyntheticSHHQDataset(smpl_model=smpl, **meta), 2 * world,
                                 shuffle=False))
    batch = {k: v[2 * rank:2 * rank + 2] for k, v in batch.items()}
    gz = torch.Generator().manual_seed(SEED + rank)
    draws = {"z": torch.randn(2, meta["latent_dim"], generator=gz), "coin": torch.tensor(0.3),
             "h_rotation": torch.zeros(2), "v_rotation": torch.zeros(2)}
    res = {}
    for dev in ("cuda", "cpu"):
        ts = init_train_state(meta, torch.Generator().manual_seed(SEED), dev)
        with torch.no_grad():  # a positive density, so that the G step reaches the field
            ts.G.neural_field.sigma_layer.bias.fill_(0.5)
        dd = {k: v.to(dev) for k, v in draws.items()}
        _, stats = train_step_pair(ts, to_tensors(batch, dev), torch.Generator(device=dev), meta,
                                   get_preprocessor(meta, smpl), meta["phases"][3], 1e-4, 4e-4,
                                   0.0, draws={"d": dd, "g": dd})
        named = {f"G.{k}": v for k, v in ts.G.state_dict().items()}
        named.update({f"D.{k}": v for k, v in ts.D.state_dict().items()})
        dist.check_replicas(named, torch.device(dev))
        res[dev] = {k: v.detach().cpu() for k, v in stats.items()}
    return res


def ranks_worker(rank, world, init_file, work):
    """One rank of phase 12 (b) and (c), in a process of its own on cuda:0
    (``chip_smoke.py --ranks-worker RANK WORLD INIT_FILE WORK_DIR``): the TINY
    card-vs-CPU step, then ``Trainer`` on MAP3DBN at a global batch of
    BATCH for RANKS_STEPS steps with a checkpoint at 2 and rank 0's samples
    at the last step, then a second ``Trainer`` resumed from the step-2
    checkpoint, copied alone into a directory of its own, to RANKS_STEPS.
    Writes its readings to WORK_DIR/rank<RANK>.pt."""
    import datetime
    import shutil

    import torch
    import torch.distributed as tdist

    from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
    from threedhumangan_tpu_torch.parallel import dist

    torch.cuda.set_device(0)
    deterministic(True)
    torch.set_num_threads(4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                             world_size=world, timeout=datetime.timedelta(seconds=RANKS_TIMEOUT))
    out = {"tiny": tiny_two_rank_step(rank, world)}
    config = ranks_config(BATCH)
    smpl = synthetic_smpl_model(num_verts=6890, num_faces=13776)
    straight, resumed = os.path.join(work, "straight"), os.path.join(work, "resumed")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer, walls, printed = timed_trainer(config, straight, rank, world, smpl,
                                            sample_interval=RANKS_STEPS, save_interval=2)
    out.update(counts=read_counts(), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               ms=walls, state=replica_state(trainer), printed=printed)
    del trainer
    torch.cuda.empty_cache()
    if rank == 0:
        os.makedirs(os.path.join(resumed, config["name"]))
        shutil.copy(os.path.join(straight, config["name"], "00000002_checkpoint.npz"),
                    os.path.join(resumed, config["name"]))
    dist.barrier()
    trainer, _, printed = timed_trainer(config, resumed, rank, world, smpl, save_interval=2)
    out.update(resumed_state=replica_state(trainer), resumed_printed=printed)
    del trainer
    tdist.destroy_process_group()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    print(f"rank {rank}: done", flush=True)


def run_ranks_gloo():
    """(b) and (c): two rank processes sharing the card under gloo (NCCL
    refuses two ranks on one device)."""
    import tempfile

    import torch

    torch.cuda.empty_cache()
    world = 2
    with tempfile.TemporaryDirectory() as work:
        init = os.path.join(work, "gloo_init")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ranks-worker",
                                   str(r), str(world), init, work], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                left = max(1.0, RANKS_TIMEOUT - (time.perf_counter() - t0))
                outs.append(p.communicate(timeout=left)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode:
                raise AssertionError(f"rank {r} exited with {p.returncode}:\n{text[-6000:]}")
        res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
               for r in range(world)]

    # (c) the TINY pair of both ranks, card against CPU
    summed = {dev: {k: sum(r["tiny"][dev][k] for r in res) for k in res[0]["tiny"][dev]}
              for dev in ("cuda", "cpu")}
    vals = {dev: {k: float(v[1]) for k, v in summed[dev].items()
                  if k in ("d_loss", "g_loss") or "grad_norm" in k} for dev in summed}
    worst = {k: abs(vals["cuda"][k] - vals["cpu"][k]) / (abs(vals["cpu"][k]) + 1e-12)
             for k in vals["cpu"] if vals["cpu"][k] != 0}
    log(f"ranks (c): TINY D+G, R1, bf16, fused synthesis, {world} gloo ranks of 2 images, card "
        "vs CPU plain, summed over ranks: "
        + " ".join(f"{k} {vals['cuda'][k]:.5g}/{vals['cpu'][k]:.5g}" for k in sorted(vals["cpu"])))
    log("  tolerance: phase 6's, losses within 2% and grad group norms within 3% relative")
    for k, v in worst.items():
        if v > (0.02 if k.endswith("loss") else 0.03):
            raise AssertionError(f"two ranks on the card disagree with two on the CPU on {k}: "
                                 f"{v:.3e}")
    if vals["cuda"]["g_grad_norm/neural_field"] <= 0:
        raise AssertionError("the two-rank TINY G step did not reach the field")

    # (b) MAP3DBN at a global batch of BATCH on two ranks
    log(f"ranks (b): Trainer MAP3DBN b{BATCH} ({BATCH // world} a rank) bf16 fused synthesis, "
        f"{world} gloo ranks sharing the card, {RANKS_STEPS} steps (checkpoint at 2, rank 0's "
        f"samples at {RANKS_STEPS}), then a resume from step 2 to {RANKS_STEPS}, deterministic "
        f"algorithms on; both processes in {wall:.1f} s")
    for r, x in enumerate(res):
        for line in x["printed"].splitlines() + x["resumed_printed"].splitlines():
            log(f"  rank {r} trainer: {line}")
        log(f"  rank {r}: ms a pair (host clock) " + ", ".join(f"{w:.3f}" for w in x["ms"])
            + f"; peak memory {x['peak_gib']:.2f} GiB; launches {x['counts']}")
    log("  (two ranks time-share one card: these ms and this memory say nothing of how the "
        "training scales over cards)")
    diff = state_diff(res[0]["state"], res[1]["state"])
    log(f"  replicas after {RANKS_STEPS} steps: {len(res[0]['state']) - len(diff)} of "
        f"{len(res[0]['state'])} tensors bit-equal across the ranks")
    if diff:
        raise AssertionError(f"the ranks' replicas differ: {diff[:8]}")
    for r, x in enumerate(res):
        d = state_diff(x["state"], x["resumed_state"])
        if d:
            raise AssertionError(f"rank {r}: the resume from step 2 differs from the "
                                 f"uninterrupted run in {len(d)} tensors: {d[:8]}")
        if "resumed from" not in x["resumed_printed"] or "at step 2" not in x["resumed_printed"]:
            raise AssertionError(f"rank {r} did not resume at step 2")
        need = ("K1", "K2", "K7", "K8", "K9", "K10", "K11") + (("K3",) if r == 0 else ())
        if min(x["counts"][k] for k in need) <= 0 or (r and x["counts"]["K3"]):
            raise AssertionError(f"rank {r}'s launches: {x['counts']}")
    log(f"  resume from step 2 bit-equal to the uninterrupted run on each rank; K1, K2, K7-K11 "
        f"launched on each rank, K3 on rank 0 alone")
    return dict(counts=[x["counts"] for x in res], peak_gib=[x["peak_gib"] for x in res],
                ms=[x["ms"] for x in res])



# ---------------------------------------------------------------------------
# 13. apps: the inference and eval apps at MAP3DBN512L
# ---------------------------------------------------------------------------

APP_CONFIG = "MAP3DBN512L"
APP_SEEDS = (1, 2)            # sample_from_generator: seeds x angles frames
APP_ANGLES = 8
APP_SWEEP = 16                # eval_consistency's angles
APP_PARITY_SEEDS = (1, 2, 3, 4)
APP_FID_N, APP_FID_BATCH = 64, 8
APP_DENSITY_BIAS = 0.5        # the field's density bias in the apps' weights


def apps_meta(tree):
    """MAP3DBN512L with the apps' eval settings, on the tree's first items."""
    import types

    from threedhumangan_tpu_torch.apps.common import eval_config

    return eval_config(types.SimpleNamespace(config=APP_CONFIG, tune="", variant=0),
                       dataroot=tree, dataset_length=BATCH)


def check_batch1(gen, pre, meta, cond, z):
    """K7, K1, K2 and K3 on the apps' path at batch 1: each image's own
    launch bit-equal to that image of the batch's launch (kernel by kernel,
    on the same inputs), the last image against the plain version at the
    slice's tolerances, and the batch-1 times beside the plain version's and
    the bound."""
    import torch

    from threedhumangan_tpu_torch.models.generator import resize_feature_maps
    from threedhumangan_tpu_torch.ops import geo
    from threedhumangan_tpu_torch.ops import rasterize as ras
    from threedhumangan_tpu_torch.ops import raymarch as rm
    from threedhumangan_tpu_torch.ops import synthesis_kernel as sk

    bf16 = torch.bfloat16
    B = z.shape[0]
    one = lambda t, i: t[i:i + 1].contiguous()
    last = B - 1
    res = {}

    def batch_equal(name, full, per_image):
        same = all(all(torch.equal(f[i:i + 1], p) for f, p in zip(full, per_image(i)))
                   for i in range(B))
        log(f"  {name}: each of the {B} images' batch-1 launch bit-equal to its image of the "
            f"batch-{B} launch: {same}")
        if not same:
            raise AssertionError(f"{name} at batch 1 differs from its image of a batch-{B} launch")

    # K7 (the bin pre-pass and the z-test)
    size, tile = (meta["gen_height"], meta["gen_width"]), pre.raster_tile
    verts, faces = pre.screen_vertices(cond), pre.faces.cuda()
    K = -(-min(pre.raster_faces_per_tile, faces.shape[0]) // 128) * 128
    k7 = lambda v: ras.rasterize_mesh_cuda(v, faces, size, tile, K)
    batch_equal("K7", k7(verts), lambda i: k7(one(verts, i)))
    v1 = one(verts, last)
    (fk, bk, zk), (fp, bp, zp) = k7(v1), ras.rasterize_mesh_plain(v1, faces, size, tile, K)
    agree = float((fk == fp).float().mean())
    mx = max(float((bk - bp).abs().max()), float((zk - zp).abs().max()))
    log(f"check K7 at batch 1 ({faces.shape[0]} faces onto {size}): face-id agreement "
        f"{agree * 100:.6f}%, bary/z max|d| {mx:.3e} (tolerance: 100% and 0, as the slice's)")
    if agree != 1.0 or mx > 0:
        raise AssertionError("K7 at batch 1 disagrees with its plain version")
    needed, _ = raster_needed_pairs(v1, faces, size, tile, K)
    run_p = lambda: ras.rasterize_mesh_plain(v1, faces, size, tile, K)
    res["K7"] = dict(max_abs_err=mx, ms=cuda_ms(lambda: k7(v1), 5), plain_ms=cuda_ms(run_p, 1),
                     **bound(20 * needed, v1.numel() * 4 + faces.shape[0] * 24
                             + size[0] * size[1] * 20, PEAK_F32))

    # K1
    inp = field_inputs(gen, cond, z, meta)
    legacy, layout = meta.get("legacy_mode", False), (meta["render_width"], meta["num_steps"])
    gargs = (inp["points"], inp["vertices"], inp["vfeat"], inp["skeletons"])
    k1 = lambda a: geo.geo_features(*a, legacy_mode=legacy, return_index=True, ray_layout=layout)
    full = k1(gargs)
    batch_equal("K1", full, lambda i: k1(tuple(one(t, i) for t in gargs)))
    a1 = tuple(one(t, last) for t in gargs)
    (f1, i1), (fp1, ip1) = k1(a1), geo.geo_features_plain(*a1, legacy_mode=legacy,
                                                           point_chunk=1024)
    agree, mx = float((i1.long() == ip1).float().mean()), diff_stats(f1, fp1)[0]
    log(f"check K1 at batch 1 ({a1[0].shape[1]} points x {a1[1].shape[1]} vertices): index "
        f"agreement {agree * 100:.6f}%  max|d| {mx:.3e} (tolerance: 100% and 1e-5, as the slice's)")
    if agree != 1.0 or mx > 1e-5:
        raise AssertionError("K1 at batch 1 disagrees with its plain version")
    pairs = torch.zeros(1, dtype=torch.int64, device="cuda")
    geo._geo_cuda(*a1, legacy, True, layout, pairs)
    needed = needed_pairs(a1[0], a1[1], geo.nearest_vertex(a1[0], a1[1], 1024)[0])
    P, V = a1[0].shape[1], a1[1].shape[1]
    res["K1"] = dict(max_abs_err=mx, ms=cuda_ms(lambda: k1(a1), 5),
                     plain_ms=cuda_ms(lambda: geo.geo_features_plain(
                         *a1, legacy_mode=legacy, point_chunk=1024), 1),
                     **nn_bounds(1, P, V, int(pairs), needed,
                                 4 * (P * 35 + V * (3 + a1[2].shape[2]))))

    # K2, on K1's features
    S, field, NB = meta["num_steps"], gen.neural_field, meta["neural_field_blocks"]
    packed = rm.pack_field_inputs(inp["points"], full[0], inp["dirs"],
                                  2.0 / meta["side_length"]).to(bf16).contiguous()
    w, exact = rm.flat_weights(field), not meta["fast_math"]
    kw = dict(white_back=meta["white_back"], last_back=meta["last_back"])
    k2 = lambda s: rm.field_render_cuda(w, rm.film_tables(inp["freq"][s], inp["phase"][s], NB),
                                        packed[s].contiguous(), inp["z_vals"][s].contiguous(), S,
                                        exact_sin=exact, **kw)
    o8, d8 = k2(slice(0, B))
    batch_equal("K2", (o8, d8), lambda i: k2(slice(i, i + 1)))
    s1 = slice(last, B)
    with torch.no_grad():
        sh, pi = rm.fold_film_tables(field, inp["freq"][s1], inp["phase"][s1], bf16)
    run_p = lambda: rm.field_render_plain(sh, pi, packed[s1], inp["z_vals"][s1], S,
                                          compute_dtype=bf16, exact_sin=exact, **kw)
    (o1, dd1), (op1, dp1) = k2(s1), run_p()
    mx = check_render_stats("K2 at batch 1", o1, dd1, op1, dp1)
    res["K2"] = dict(max_abs_err=mx, ms=cuda_ms(lambda: k2(s1), 5), plain_ms=cuda_ms(run_p, 1),
                     **field_bound(packed[s1], o1, meta, backward=0))

    # K3, on K2's feature maps resized as the generator resizes them
    rh, rw = meta["render_height"], meta["render_width"]
    with torch.no_grad():
        style = resize_feature_maps(o8[..., 3:].reshape(B, rh, rw, -1).to(bf16),
                                    meta["gen_height"], meta["gen_width"])
        styles = gen.synthesis_mapping_network(z, bf16)[1]
        folded = sk.fold_synthesis_params(gen.synthesis_network, gen.synthesis_input,
                                          meta["spatial_normalization"])
    NBs, mods, mode = meta["synthesis_blocks"], tuple(meta["mod_blocks"]), meta["map3d_mode"]
    k3 = lambda s: sk.synthesis_cuda(folded, style[s].contiguous(), styles[s].contiguous(),
                                     NBs, mods, mode)
    # the wrapper forms the fixed-style rows by a cuBLAS product, whose last
    # bits may change with the batch: the launch-by-launch comparison hands
    # every launch its images' rows of one batch-B product
    gab = sk.rank1_rows(folded, styles, sk.rank1_blocks_of(NBs, mods, mode), bf16)

    def k3_rows(s):
        real = sk.rank1_rows
        sk.rank1_rows = lambda *a, **kw: gab[s].contiguous()
        try:
            return k3(s)
        finally:
            sk.rank1_rows = real

    full = k3_rows(slice(0, B))
    batch_equal("K3", (full,), lambda i: (k3_rows(slice(i, i + 1)),))
    whole = max(float((k3(slice(i, i + 1)) - full[i:i + 1]).abs().max()) for i in range(B))
    log(f"  K3's whole call at batch 1 (its fixed-style rows formed at batch 1 by cuBLAS) "
        f"against the batch-{B} call: max|d| {whole:.3e} (information)")
    run_p = lambda: sk.synthesis_plain(folded, style[s1], styles[s1], NBs, mods, mode, bf16,
                                       pixel_chunk=32768)
    r1, rp1 = k3(s1), run_p()
    mx, mean, p99 = diff_stats(r1, rp1)
    log(f"check K3 at batch 1 {tuple(r1.shape)}: max|d| {mx:.3e} mean|d| {mean:.3e} p99|d| "
        f"{p99:.3e} (tolerance: mean <= 3e-3, p99 <= 2e-2, as the slice's)")
    if mean > 3e-3 or p99 > 2e-2:
        raise AssertionError("K3 at batch 1 disagrees with its plain version")
    res["K3"] = dict(max_abs_err=mx, ms=cuda_ms(lambda: k3(s1), 5),
                     plain_ms=cuda_ms(run_p, 1), whole_call_vs_batch_max_abs=whole,
                     **synthesis_bound(meta, style[s1], r1))
    for k in ("K7", "K1", "K2", "K3"):
        r = res[k]
        log(f"  time at batch 1: {k} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.3f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return res


def time_frame(gen, pre, meta, cond, z, avg):
    """One frame at batch 1 as the apps render it (camera, rasterizer,
    ``staged_forward`` in bf16): WARMUP + TIMED frames, host clock
    synchronized at both ends, stages by CUDA events."""
    import torch

    from threedhumangan_tpu_torch.models.generator import staged_forward

    timer, walls = StageTimer(), []
    zero = torch.zeros(1, device="cuda")
    for it in range(WARMUP + TIMED):
        timer.on = it >= WARMUP
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer.stage("rasterize"):
            c = pre.forward_with_rotation(cond, zero + 0.1 * it, zero, zero)
        staged_forward(gen, z, c, meta, avg_latent=avg, compute_dtype=torch.bfloat16,
                       stage=timer.stage)
        torch.cuda.synchronize()
        if timer.on:
            walls.append(time.perf_counter() - t0)
    stage_ms = timer.mean_ms()
    ms = 1e3 * sum(walls) / len(walls)
    log(f"one frame at batch 1 (MAP3DBN512L, bf16, {TIMED} timed after {WARMUP}): {ms:.3f} ms "
        f"(host clock), stages (CUDA events): "
        + ", ".join(f"{k} {stage_ms[k]:.3f}" for k in ("rasterize", "mapping", "rays", "geo",
                                                        "field", "resize", "synthesis")))
    return dict(ms=ms, stage_ms=stage_ms)



def plain_frame_f32(gen, meta, cond, z, avg):
    """One frame through the plain versions in float32 on the card, the JAX
    apps' dtype: ``staged_forward``'s stages with K1, K2 and K3 replaced by
    ``geo_features_plain``, ``field_render_plain`` on f32 tables and
    ``synthesis_plain`` (``cond`` posed and rasterized already)."""
    import torch

    from threedhumangan_tpu_torch.models import volume_rendering as vr
    from threedhumangan_tpu_torch.models.generator import resize_feature_maps
    from threedhumangan_tpu_torch.ops import geo
    from threedhumangan_tpu_torch.ops import raymarch as rm
    from threedhumangan_tpu_torch.ops import synthesis_kernel as sk

    f32 = torch.float32
    S, W, H = meta["num_steps"], meta["render_width"], meta["render_height"]
    psi = meta["truncation_psi"]
    freq, phase = gen.neural_field_mapping_network(z, f32)
    styles = gen.synthesis_mapping_network(z, f32)[1]
    _, a_freq, a_phase, a_styles = avg
    freq = a_freq + psi * (freq - a_freq)
    phase = a_phase + psi * (phase - a_phase)
    styles = a_styles + psi * (styles - a_styles)
    pts_cam, z_vals, d_cam = vr.get_initial_rays_weak_perspective(
        cond["intrinsics"][:, 0, 0], cond["scales"].float(), S, (W, H), meta["ray_start"],
        meta["ray_end"])
    pts, z_vals, ray_dirs = vr.transform_sampled_points(pts_cam, z_vals, d_cam,
                                                        cond["cam2world_matrices"])
    pts = pts.reshape(1, -1, 3).contiguous()
    dirs = vr.expand_ray_directions(ray_dirs, S)
    if meta.get("lock_view_dependence", False):
        dirs = torch.zeros_like(dirs)
        dirs[..., -1] = -1.0
    vfeat = geo.build_vertex_features(cond["tpose_vertices"], cond["fk_matrices"],
                                      cond["lbs_weights"])
    feats = geo.geo_features_plain(pts, cond["vertices"].float(), vfeat,
                                   cond["skeletons_xyz"].float(),
                                   legacy_mode=meta.get("legacy_mode", False), point_chunk=1024)[0]
    packed = rm.pack_field_inputs(pts, feats, dirs, 2.0 / meta["side_length"])
    shared, per_image = rm.fold_film_tables(gen.neural_field, freq, phase, f32)
    out, _ = rm.field_render_plain(shared, per_image, packed, z_vals.reshape(1, W * H, S), S,
                                   meta["white_back"], meta["last_back"], f32,
                                   exact_sin=not meta["fast_math"])
    style = resize_feature_maps(out[..., 3:].reshape(1, H, W, -1), meta["gen_height"],
                                meta["gen_width"])
    folded = sk.fold_synthesis_params(gen.synthesis_network, gen.synthesis_input,
                                      meta["spatial_normalization"])
    return sk.synthesis_plain(folded, style, styles, meta["synthesis_blocks"],
                              tuple(meta["mod_blocks"]), meta["map3d_mode"], f32)


def bf16_against_f32(gen, pre, meta, cond, z, avg):
    """A frame on the apps' route (kernels, bf16) against the same frame
    through the plain versions in float32 on the card: a reading, no gate."""
    import torch

    from threedhumangan_tpu_torch.models.generator import staged_forward

    zero = torch.zeros(1, device="cuda")
    c = pre.forward_with_rotation(cond, zero, zero, zero)
    got = staged_forward(gen, z, c, meta, avg_latent=avg, compute_dtype=torch.bfloat16)["rgbs"]
    ref = plain_frame_f32(gen, meta, c, z, avg)
    mx, mean, p99 = diff_stats(got, ref)
    log(f"bf16 kernels vs float32 plain versions, one MAP3DBN512L frame (rgb in [-1, 1], "
        f"f32 |x| mean {float(ref.abs().mean()):.4f}): mean|d| {mean:.4e} p99|d| {p99:.4e} "
        f"max|d| {mx:.4e} (a reading, not a gate)")
    return dict(mean_abs=mean, p99_abs=p99, max_abs=mx)


def _wall(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_sample_app(meta, ckpt, out_dir):
    """sample_from_generator through its CLI entry: APP_SEEDS x APP_ANGLES
    frames on the card; the PNGs read back equal the frames; the counts rise
    by one K1, K2, K3 and K7 (and its pre-pass, and K1's cluster build) a
    frame and by nothing else."""
    import numpy as np

    from threedhumangan_tpu_torch.apps import sample_from_generator
    from threedhumangan_tpu_torch.data.utils import read_png

    argv = ["--config", APP_CONFIG, "--checkpoint", ckpt, "--seeds", *map(str, APP_SEEDS),
            "--n_angles", str(APP_ANGLES), "--save", "png", "--output_dir", out_dir,
            "--dataroot", os.path.join("datasets", "shhq_train_40000"),
            "--dataset_length", str(BATCH)]
    reset_counts()
    written, secs = _wall(lambda: sample_from_generator.main(argv))
    counts = read_counts()
    frames = len(APP_SEEDS) * APP_ANGLES
    want = {k: frames if k in ("K1", "K2", "K3", "K7", "K7 bins", "K1/K6 vertex clusters")
            else 0 for k in counts}
    log(f"sample_from_generator: {len(APP_SEEDS)} seeds x {APP_ANGLES} angles in {secs:.2f} s; "
        f"launches {counts}")
    if counts != want:
        raise AssertionError(f"the sampler's launches {counts}, expected {want}")
    for seed, (base, f, s) in written.items():
        same = (np.array_equal(read_png(base + "_uncond.png"), np.concatenate(list(f), axis=1))
                and np.array_equal(read_png(base + "_smpl.png"), np.concatenate(list(s), axis=1)))
        if not same or f.std() == 0 or f.shape != (APP_ANGLES, meta["gen_height"],
                                                   meta["gen_width"], 3):
            raise AssertionError(f"seed {seed}: PNGs read back equal {same}, frames "
                                 f"{f.shape} std {f.std():.3f}")
    log(f"  PNG strips read back (read_png) equal to the frames in memory; frames "
        f"{tuple(f.shape)} uint8")
    return dict(seconds=secs, counts=counts, frames=frames)


def run_parity_app(gen, pre, meta, ds, ckpt, tmp):
    """eval_parity: goldens of APP_PARITY_SEEDS from the saved state_dict,
    bit-equal to the in-memory G's renders of the same seeds; then the app
    against them (max_abs < 1e-5, feature Frechet < 1e-3)."""
    import numpy as np
    import torch

    from threedhumangan_tpu_torch.apps import eval_parity
    from threedhumangan_tpu_torch.models.generator import generate_avg_latent
    from threedhumangan_tpu_torch.trainers.phase_trainer import compute_dtype

    goldens = os.path.join(tmp, "goldens")
    base = ["--config", APP_CONFIG, "--torch_checkpoint", ckpt, "--seeds",
            *map(str, APP_PARITY_SEEDS), "--dataroot", os.path.join("datasets", "shhq_train_40000"),
            "--dataset_length", str(BATCH), "--output_dir", os.path.join(tmp, "parity")]
    eval_parity.main(base + ["--write_goldens", goldens])
    summary, secs = _wall(lambda: eval_parity.main(base + ["--goldens", goldens]))
    avg = generate_avg_latent(gen, meta, torch.Generator(device="cuda").manual_seed(1))
    same = []
    for seed in APP_PARITY_SEEDS:
        zs = torch.randn(1, meta["latent_dim"], device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(seed))
        img = eval_parity.render_seed(gen, pre, meta, zs,
                                      eval_parity.seed_conditions(ds, seed, "cuda"), avg,
                                      compute_dtype(meta))
        gold = np.load(os.path.join(goldens, f"seed_{seed:03d}.npy"))
        same.append(np.array_equal(img.float().cpu().numpy(), gold))
    deltas = [d["max_abs"] for d in summary["per_pixel"].values()]
    log(f"eval_parity: {len(deltas)} seeds against its own goldens in {secs:.2f} s: max_abs "
        f"{deltas}, feature Frechet {summary.get('feature_frechet')} "
        f"({summary.get('feature_space')}); the saved state_dict's renders bit-equal to the "
        f"in-memory G's: {same}")
    if (len(deltas) != len(APP_PARITY_SEEDS) or max(deltas) >= 1e-5 or not all(same)
            or not abs(summary["feature_frechet"]) < 1e-3):
        raise AssertionError(f"eval_parity: {summary}, bit-equal {same}")
    return dict(seconds=secs, max_abs=max(deltas), feature_frechet=summary["feature_frechet"])


def run_fid_app(ckpt):
    """eval_fid at APP_FID_N images in batches of APP_FID_BATCH, its
    generation and its feature extraction timed apart."""
    from threedhumangan_tpu_torch.apps import eval_fid

    spent = {"generation": 0.0, "features": 0.0}
    real = {"generation": eval_fid.generate_fakes, "features": eval_fid.fid_between}

    def timed(name):
        def call(*a, **kw):
            out, secs = _wall(lambda: real[name](*a, **kw))
            spent[name] += secs
            return out
        return call

    eval_fid.generate_fakes, eval_fid.fid_between = timed("generation"), timed("features")
    try:
        res, secs = _wall(lambda: eval_fid.main(
            ["--config", APP_CONFIG, "--checkpoint", ckpt, "--n", str(APP_FID_N),
             "--batch", str(APP_FID_BATCH)]))
    finally:
        eval_fid.generate_fakes, eval_fid.fid_between = real["generation"], real["features"]
    log(f"eval_fid: n {APP_FID_N}, batch {APP_FID_BATCH}: value {res['value']} in {secs:.2f} s "
        f"(generation {spent['generation']:.2f} s, feature extraction and distance "
        f"{spent['features']:.2f} s)")
    if not math.isfinite(res["value"]) or "NOT Inception-FID" not in res["metric"]:
        raise AssertionError(f"eval_fid: {res}")
    return dict(seconds=secs, **{f"{k}_s": v for k, v in spent.items()}, value=res["value"])


def _wire_fields(buf: bytes):
    """(field, wire type, value) of one protobuf message: ints for varints,
    bytes otherwise."""
    i, out = 0, []
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            v, i = buf[i:i + n], i + n
        elif wire == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"protobuf wire type {wire}")
        out.append((field, wire, v))
    return out


def _read_varint(buf: bytes, i: int):
    shift = val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def read_scalars(path: str):
    """The scalars of an event file as (tag, step, value), in file order,
    read without TensorBoard.  Raises ValueError on a record whose length or
    crc does not hold."""
    from threedhumangan_tpu_torch.utils.tb import _masked_crc

    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        if len(header) < 8 or struct.unpack("<I", data[pos + 8:pos + 12])[0] != _masked_crc(header):
            raise ValueError(f"{path}: bad record header at byte {pos}")
        (n,) = struct.unpack("<Q", header)
        payload = data[pos + 12:pos + 12 + n]
        crc = data[pos + 12 + n:pos + 16 + n]
        if len(payload) < n or len(crc) < 4 or struct.unpack("<I", crc)[0] != _masked_crc(payload):
            raise ValueError(f"{path}: bad record at byte {pos}")
        pos += 16 + n
        ev = _wire_fields(payload)
        step = next((v for f, _, v in ev if f == 2), 0)
        for f, _, summary in ev:
            if f != 5:
                continue
            for _, _, value in _wire_fields(summary):
                fields = {vf: v for vf, _, v in _wire_fields(value)}
                if 2 in fields:
                    out.append((fields[1].decode(), step, struct.unpack("<f", fields[2])[0]))
    return out


def run_export_app(metrics_jsonl, tmp):
    """export_tensorboard over phase 10's metrics.jsonl: the event file reads
    back with as many scalars as it reports, equal to the numbers."""
    from threedhumangan_tpu_torch.apps import export_tensorboard

    run = os.path.join(tmp, "run512l")
    os.makedirs(run, exist_ok=True)
    with open(os.path.join(run, "metrics.jsonl"), "w") as f:
        f.write(metrics_jsonl)
    path, n = export_tensorboard.main(["--run_dir", run])
    back = read_scalars(path)
    rows = [json.loads(line) for line in metrics_jsonl.splitlines() if line.strip()]
    want = [(f"train/{k}", row["step"], v) for row in rows for k, v in row.items()
            if k != "step" and isinstance(v, (int, float))]
    ok = len(back) == len(want) == n > 0 and all(t == w[0] and s == w[1] and math.isclose(
        v, w[2], rel_tol=1e-6, abs_tol=1e-30) for (t, s, v), w in zip(back, want))
    log(f"export_tensorboard over phase 10's metrics.jsonl: {n} scalars reported, {len(back)} "
        f"read back, equal to the rows' values in float32: {ok}")
    if not ok:
        raise AssertionError(f"export_tensorboard: {n} reported, read back {back[:4]}")
    return dict(scalars=n)


def run_apps(metrics_jsonl, gcuda):
    """The apps at MAP3DBN512L on an SHHQ-layout tree of the synthetic body
    (6,844 vertices, 13,776 faces), from a directory laid out as a user's
    checkout (``datasets/SMPL_NEUTRAL.pkl``, ``datasets/shhq_train_40000``): the
    kernels at batch 1, one frame timed, bf16 against float32, then each
    app through its CLI entry on weights saved with ``torch.save``."""
    import shutil
    import tempfile

    import torch

    from threedhumangan_tpu_torch.apps import eval_consistency
    from threedhumangan_tpu_torch.data.dataset import SHHQDataset, iterate_batches, to_tensors
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.generator import generate_avg_latent, init_generator

    out = {}
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        tree = os.path.join(tmp, "datasets", "shhq_train_40000")
        smpl, mb, secs = write_shhq_tree(tree)
        shutil.copy(os.path.join(tree, "SMPL_NEUTRAL.pkl"),
                    os.path.join(tmp, "datasets", "SMPL_NEUTRAL.pkl"))
        log(f"apps: {APP_CONFIG}, the eval settings, a {TREE_ITEMS}-item SHHQ tree ({mb:.1f} MB "
            f"in {secs:.1f} s) of the {smpl.num_verts}-vertex, {len(smpl.faces)}-face synthetic "
            f"body; random weights (seed {SEED}) with the field's density bias "
            f"{APP_DENSITY_BIAS}, saved with torch.save")
        meta = apps_meta(tree)
        gen = init_generator(meta, torch.Generator().manual_seed(SEED), "cuda")
        gen.neural_field.sigma_layer.bias.fill_(APP_DENSITY_BIAS)
        ckpt = os.path.join(tmp, "g.pth")
        torch.save(gen.state_dict(), ckpt)
        ds = SHHQDataset(smpl_model=smpl, inference=True,
                         **{k: v for k, v in meta.items() if k not in ("dataset", "name")})
        pre = get_preprocessor(meta, smpl)
        batch = to_tensors(next(iterate_batches(ds, BATCH, shuffle=False)))
        h = torch.linspace(-math.pi / 6, math.pi / 6, BATCH, device="cuda")
        zeros = torch.zeros(BATCH, device="cuda")
        cond = pre.forward_with_rotation(batch, h, zeros, zeros)
        z = torch.randn(BATCH, meta["latent_dim"], generator=gcuda, device="cuda")
        out["kernels"] = check_batch1(gen, pre, meta, cond, z)
        del cond
        one = {k: v[:1] for k, v in batch.items()}
        avg = generate_avg_latent(gen, meta, torch.Generator(device="cuda").manual_seed(1))
        out["frame"] = time_frame(gen, pre, meta, one, z[:1], avg)
        out["bf16_vs_f32"] = bf16_against_f32(gen, pre, meta, one, z[:1], avg)
        torch.cuda.empty_cache()
        with contextlib.chdir(tmp):
            out["sample"] = run_sample_app(meta, ckpt, os.path.join(tmp, "samples"))
            res, secs = _wall(lambda: eval_consistency.main(
                ["--config", APP_CONFIG, "--checkpoint", ckpt, "--n_angles", str(APP_SWEEP)]))
            log(f"eval_consistency: {APP_SWEEP} angles in {secs:.2f} s: {json.dumps(res)}")
            if not all(math.isfinite(res[k]) for k in ("seg_iou_mean", "reproj_l1",
                                                        "adjacent_view_l1")):
                raise AssertionError(f"eval_consistency: {res}")
            out["sweep"] = dict(seconds=secs, **res)
            out["parity"] = run_parity_app(gen, pre, meta, ds, ckpt, tmp)
            out["fid"] = run_fid_app(ckpt)
        out["export"] = run_export_app(metrics_jsonl, tmp)
    torch.cuda.empty_cache()
    return out


def main():
    import torch

    # ---- 1. card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    log(f"card: {card}")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}  torch {torch.__version__}  cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from threedhumangan_tpu_torch import _build
    from threedhumangan_tpu_torch.data.dataset import (
        SyntheticSHHQDataset, iterate_batches, to_tensors)
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.generator import init_generator
    from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
    from threedhumangan_tpu_torch.trainers.phase_trainer import init_train_state

    # ---- 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.BUILD_INFO.get('path')})")
    if _build.BUILD_INFO.get("log"):
        with open(_build.BUILD_INFO["log"]) as f:
            for line in f:
                if "registers" in line or "spill" in line or "Function properties" in line:
                    log("  ptxas: " + line.strip())

    # ---- 3. kernels against their plain versions, at the slice's shapes
    meta = slice_meta()
    dev = torch.device("cuda")
    gcpu = torch.Generator().manual_seed(SEED)
    gcuda = torch.Generator(device=dev).manual_seed(SEED)
    smpl = synthetic_smpl_model(num_verts=6890, num_faces=13776)
    ds = SyntheticSHHQDataset(smpl_model=smpl, **meta)
    batch = to_tensors(next(iterate_batches(ds, BATCH, shuffle=False)), dev)
    pre = get_preprocessor(meta)
    gen = init_generator(meta, gcpu, dev)
    z0 = torch.randn(BATCH, meta["latent_dim"], generator=gcuda, device=dev)

    cond = pre(batch, rotate=True, generator=gcuda)
    inp = field_inputs(gen, cond, z0, meta)
    with torch.no_grad():
        _, styles = gen.synthesis_mapping_network(z0, torch.bfloat16)
        geo_feats, k1 = check_geo(inp, meta)
        k2 = check_field(gen, inp, geo_feats, meta)
        k3 = check_synthesis(gen, meta, styles, gcuda)
        # K6, K4, K5 at the slice's shapes (a generator of their own keeps
        # the draws of every other phase as they were)
        gsel = torch.Generator(device=dev).manual_seed(SEED + 4)
        k6 = check_knn(inp, meta)
        k4 = check_unfolded(gen, inp, geo_feats, meta, gsel)
        k5 = check_geo_fused(gen, inp, meta, gsel)
    del inp, geo_feats
    torch.cuda.empty_cache()

    # ---- 4. the slice through the port's entry point
    torch.cuda.reset_peak_memory_stats()
    default = run_generation(gen, pre, batch, z0, meta, gcuda, "slice", ("K1", "K2", "K3"),
                             ("K4", "K5", "K6"))
    counts = default["counts"]
    check_small_config()
    check_small_config(sigma_bias=0.5)  # the default path with a rendered body

    # ---- 4b. the generator's other kernel selections, same weights and latents
    gpath = torch.Generator(device=dev).manual_seed(SEED + 5)
    need = {"K4": ("K1", "K4", "K3"), "K5": ("K5", "K3"), "K6": ("K6", "K2", "K3")}
    forbid = {"K4": ("K2", "K5", "K6"), "K5": ("K1", "K2", "K4", "K6"), "K6": ("K1", "K4", "K5")}
    sel_runs = {}
    for k, flags in SELECTIONS.items():
        torch.cuda.reset_peak_memory_stats()
        sel_runs[k] = run_generation(gen, pre, batch, z0, dict(meta, **flags), gpath,
                                     f"slice on {k} ({flags})", need[k], forbid[k])
        check_small_config(flags, sigma_bias=0.5)
    log("  generation by selection, ms/batch (imgs/s): "
        + ", ".join(f"{k} {r['ms_per_batch']:.3f} ({r['imgs_per_s']:.3f})"
                    for k, r in {"default K1+K2": default, **sel_runs}.items()))
    del gen
    torch.cuda.empty_cache()

    # ---- 5. training-path kernels against their plain versions
    tmeta = train_meta()
    tds = SyntheticSHHQDataset(smpl_model=smpl, **tmeta)
    tbatch = to_tensors(next(iterate_batches(tds, BATCH, shuffle=False)), dev)
    tpre = get_preprocessor(tmeta, smpl)
    ts = init_train_state(tmeta, torch.Generator().manual_seed(SEED), dev)
    tcond = tpre(tbatch, rotate=True, generator=gcuda)
    k7, k7_device_times = check_raster(tpre, tcond, tmeta)
    syncs = check_preprocess_syncs(tpre, tbatch, tmeta,
                                   torch.Generator(device=dev).manual_seed(SEED + 9))
    k1_train = check_geo_train(tmeta, tcond, torch.Generator(device=dev).manual_seed(SEED + 8))
    k2_train, k8, k9 = check_field_bwd(ts.G, tmeta, tcond, gcuda)
    k4_train, k5_train = check_train_unfolded(ts.G, tmeta, tcond,
                                              torch.Generator(device=dev).manual_seed(SEED + 6))
    del tcond
    torch.cuda.empty_cache()

    # ---- 6. the training slice through the port's entry point, per-op synthesis
    per_op = run_train_slice(ts, tbatch, tpre, tmeta, gcuda)
    check_small_train()

    # ---- 7. K10/K11 against their plain versions at the training shapes
    hb = check_half_blocks(gcuda, BATCH, tmeta["gen_height"], tmeta["gen_width"],
                           tmeta["hidden_dim"], 128)

    # ---- 8. the training slice on the fused half-blocks (the trainer's default)
    fmeta = dict(tmeta, pallas_synthesis_train=True)
    fused = run_train_slice(ts, tbatch, tpre, fmeta, gcuda)
    log(f"  fused vs per-op synthesis: {fused['ms_per_pair']:.3f} vs {per_op['ms_per_pair']:.3f} "
        f"ms/pair, peak {fused['peak_gib']:.2f} vs {per_op['peak_gib']:.2f} GiB")
    del ts, tbatch
    torch.cuda.empty_cache()
    check_small_train(fused=True)

    # ---- 9. the training loop: save, resume
    trainer_counts = run_trainer(smpl)

    # ---- 10. MAP3DBN512L at its batch 32 on an SHHQ-layout tree, the
    # kernels at its shapes, remat against no remat
    l512 = run_512l(torch.Generator(device=dev).manual_seed(SEED + 10))

    # ---- 12. ranks: NCCL at world size 1, two gloo ranks sharing the card
    ranks_a = run_ranks_nccl1(smpl)
    ranks_b = run_ranks_gloo()

    # ---- 13. the inference and eval apps at MAP3DBN512L, the kernels at batch 1
    apps = run_apps(l512["train"]["metrics_jsonl"],
                    torch.Generator(device=dev).manual_seed(SEED + 13))

    # ---- 11. result
    k7.update(k7_device_times())
    l512["k7"].update(l512.pop("k7_device")())
    src = "threedhumangan_tpu_torch/csrc/"
    paths = {"generation": counts, "training_per_op": per_op["counts"],
             "training_fused": fused["counts"], "trainer": trainer_counts,
             "trainer_512l": l512["train"]["counts"], "ranks_nccl1": ranks_a["counts"],
             "ranks_gloo_rank0": ranks_b["counts"][0], "ranks_gloo_rank1": ranks_b["counts"][1],
             "sample_from_generator": apps["sample"]["counts"]}
    paths.update({f"generation_{k}": r["counts"] for k, r in sel_runs.items()})
    by_path = lambda k: {p: c.get(k, 0) for p, c in paths.items()}
    tc, fc = per_op["counts"], fused["counts"]
    kernels = [
        dict(name="K1 geo features", route="cuda", source=src + "geo.cu",
             replaces="threedhumangan_tpu/ops/geo.py:94", launches=counts["K1"],
             search_source=src + "nn_prune.cuh", build_source=src + "nn_clusters.cu",
             training_shapes=k1_train, **k1),
        dict(name="K2 folded field render", route="cuda", source=src + "raymarch.cu",
             replaces="threedhumangan_tpu/ops/raymarch.py:525", launches=counts["K2"],
             training_shapes=k2_train, **k2),
        dict(name="K3 fused SPADE synthesis", route="cuda", source=src + "synthesis.cu",
             replaces="threedhumangan_tpu/ops/synthesis_kernel.py:91", launches=counts["K3"],
             **k3),
        dict(name="K7 rasterizer tile z-test", route="cuda", source=src + "rasterize.cu",
             replaces="threedhumangan_tpu/ops/rasterize.py:335", launches=tc["K7"],
             prepass_launches=tc["K7 bins"], preprocess_ms_per_pair_fused=fused["preprocess_ms"],
             preprocess_syncs=syncs, **k7),
        dict(name="K8 field backward stats", route="cuda", source=src + "field_core.cuh",
             entry_source=src + "raymarch_bwd.cu",
             replaces="threedhumangan_tpu/ops/raymarch_bwd.py:132", launches=tc["K8"], **k8),
        dict(name="K9 field backward step", route="cuda", source=src + "field_core.cuh",
             entry_source=src + "raymarch_bwd.cu",
             replaces="threedhumangan_tpu/ops/raymarch_bwd.py:154", launches=tc["K9"],
             reduction_source=src + "wgrad.cu",
             weight_gradient_reduction_launches=tc["K9 weight-gradient reduction"], **k9),
        dict(name="K10 fused SPADE half-block forward", route="cuda",
             source=src + "synthesis_train.cu",
             replaces="threedhumangan_tpu/ops/synthesis_train.py:185", launches=fc["K10"],
             case="spatial with the fixed row", rank1=hb["rank1"]["k10"],
             **hb["spatial"]["k10"]),
        dict(name="K11 fused SPADE half-block backward", route="cuda",
             source=src + "synthesis_train_bwd.cu", reduction_source=src + "wgrad.cu",
             replaces="threedhumangan_tpu/ops/synthesis_train.py:225", launches=fc["K11"],
             weight_gradient_reduction_launches=fc["K11 weight-gradient reduction"],
             case="spatial with the fixed row", rank1=hb["rank1"]["k11"],
             **hb["spatial"]["k11"]),
        dict(name="K4 unfolded field render", route="cuda", source=src + "field_core.cuh",
             entry_source=src + "raymarch_unfolded.cu",
             replaces="threedhumangan_tpu/ops/raymarch.py:149",
             launches=sel_runs["K4"]["counts"]["K4"], training_shapes=k4_train, **k4),
        dict(name="K5 geo-fused field render", route="cuda", source=src + "field_core.cuh",
             entry_source=src + "raymarch_geo.cu",
             replaces="threedhumangan_tpu/ops/raymarch.py:1037",
             launches=sel_runs["K5"]["counts"]["K5"], training_shapes=k5_train, **k5),
        dict(name="K6 1-NN search", route="cuda", source=src + "knn.cu",
             replaces="threedhumangan_tpu/ops/knn.py:80", launches=sel_runs["K6"]["counts"]["K6"],
             search_source=src + "nn_prune.cuh", build_source=src + "nn_clusters.cu", **k6),
    ]
    # time above the bound, ms per iteration of the kernel's main path(s):
    # launches per batch (generation; K4-K6 on their selections) or per
    # fused pair (training) x (ms - bound).  K9's and K11's ms are per call
    # (K9: a call is BATCH / IMAGES_PER_LAUNCH launches); K10/K11 run spatial
    # on the mod blocks' half-blocks (6 of 18 in MAP3DBN) and rank-1 on the
    # rest.
    from threedhumangan_tpu_torch.ops.raymarch_bwd import IMAGES_PER_LAUNCH

    it = WARMUP + TIMED
    gap = lambda d: d["ms"] - d["bound_ms"]
    sp = len(tmeta["mod_blocks"]) / tmeta["synthesis_blocks"]
    split = lambda r: sp * gap(r["spatial"]) + (1 - sp) * gap(r["rank1"])
    excess = {
        "K1": gap(k1) * counts["K1"], "K2": gap(k2) * counts["K2"] + gap(k2_train) * fc["K2"],
        "K3": gap(k3) * counts["K3"], "K4": gap(k4) * sel_runs["K4"]["counts"]["K4"],
        "K5": gap(k5) * sel_runs["K5"]["counts"]["K5"],
        "K6": gap(k6) * sel_runs["K6"]["counts"]["K6"], "K7": gap(k7) * fc["K7"],
        "K8": gap(k8) * fc["K8"], "K9": gap(k9) * fc["K9"] / (BATCH // IMAGES_PER_LAUNCH),
        "K10": split({c: hb[c]["k10"] for c in hb}) * fc["K10"],
        "K11": split({c: hb[c]["k11"] for c in hb}) * fc["K11"]}
    for k in kernels:
        # no single PyTorch call computes the other functions (PERF.md)
        k.setdefault("library_ms", None)
        k["launches_by_path"] = by_path(k["name"].split()[0])
        k["excess_ms_per_iteration"] = excess[k["name"].split()[0]] / it
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            if not math.isfinite(k[key]):
                raise AssertionError(f"{k['name']}: {key} is not finite")
    # the MAP3DBN512L b32 path: launches a pair, and each kernel at its shapes
    lp = l512["train"]["launches_per_pair"]
    at_512l = {"K1": l512["k1"], "K2": l512["K2"], "K7": l512["k7"], "K8": l512["K8"],
               "K9": l512["K9"], "K10": l512["hb"]["spatial"]["k10"],
               "K11": l512["hb"]["spatial"]["k11"]}
    for k in kernels:
        key = k["name"].split()[0]
        if key in at_512l:
            k["map3dbn512l_b32"] = dict(at_512l[key], launches_per_pair=lp[key],
                                        batch_split=l512["train"]["batch_split"],
                                        remat=l512["train"]["remat"])
            if key in ("K10", "K11"):
                k["map3dbn512l_b32"]["rank1"] = l512["hb"]["rank1"][key.lower()]
    # the apps' path: each kernel at batch 1, and its launches in the sampler
    for k in kernels:
        key = k["name"].split()[0]
        if key in apps["kernels"]:
            k["batch1"] = dict(apps["kernels"][key],
                               launches_sample_app=apps["sample"]["counts"][key])
    order = sorted(kernels, key=lambda k: -k["excess_ms_per_iteration"])
    log("kernels by ms above their bound per main-path iteration (a batch or a fused pair): "
        + ", ".join(f"{k['name'].split()[0]} {k['excess_ms_per_iteration']:.3f}" for k in order))
    t = l512["train"]
    log(f"512L b{t['batch']}: {t['ms_per_pair']:.3f} ms/pair, {t['imgs_per_s']:.3f} imgs/s, peak "
        f"{t['peak_gib']:.2f} GiB, batch_split {t['batch_split']}, remat {t['remat']}, loader "
        f"{t['loader_ms_per_batch']:.1f} ms a batch; remat vs none on the card: grads rel L2 "
        f"{l512['remat']['grad_rel_l2']:.3e}, state identical {l512['remat']['state_identical']}")
    f, p, fid = apps["frame"], apps["bf16_vs_f32"], apps["fid"]
    log(f"apps (512L): a frame at batch 1 {f['ms']:.3f} ms; the {APP_SWEEP}-angle sweep "
        f"{apps['sweep']['seconds']:.2f} s; the {APP_FID_N}-image FID {fid['seconds']:.2f} s "
        f"(generation {fid['generation_s']:.2f}, features {fid['features_s']:.2f}); bf16 vs f32 "
        f"mean|d| {p['mean_abs']:.3e} p99|d| {p['p99_abs']:.3e} max|d| {p['max_abs']:.3e}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ranks-worker"]:
        ranks_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    sys.exit(main())
