#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (threedhumangan_tpu_torch) on one
CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (exit code != 0):

  1. card     — nvidia-smi name and power limit; TF32 off for the references.
  2. build    — nvcc builds K1-K11 and the weight-gradient reduction of K9
                and K11 from threedhumangan_tpu_torch/csrc, one process per
                source.
  3. check    — K1-K3 against their plain PyTorch versions at the generation
                slice's shapes (and K2/K3 pointwise at a narrow width), with
                the tolerance and its reason; kernel, plain and bound times.
  4. generate — MAP3DBN512L generation at batch 8 in bf16 with seeded random
                weights: 2 warm-up + 5 timed batches through
                ``generator_forward``, per-stage ms/batch, imgs/s; the output
                must be (8, 512, 256, 3), finite and not constant, K1-K3 must
                launch, and a small config run on the card must agree with
                the same run on the CPU.
  5. check    — K7, K2 (with the nerf-noise column), K8 and K9 against their
                plain versions at the training slice's shapes (K8/K9 also
                pointwise at a narrow width, and against autograd through the
                plain unfolded render); the weight-gradient reduction against
                the plain f32 X^T Y at K9's ragged widths.
  6. train    — the MAP3DBN D+G+R1 step at batch 8 in bf16, phase slot 3
                (R1 on), nerf noise 0.5, lr_d 4e-4 / lr_g 1e-4, per-op
                synthesis (``pallas_synthesis_train=False``): 2 warm-up + 5
                timed pair steps through ``train_step_pair``, per-stage
                ms/pair, imgs/s, peak memory; losses finite, parameters
                moved, K1, K2, K7, K8 and K9 launched; and a TINY D+G step on
                the card against the same step on the CPU.
  7. check    — K10/K11 against their plain versions (and K11 against
                autograd through the plain forward) at the training shapes,
                spatial with the fixed row and rank-1, and pointwise on a
                narrow case with a ragged last tile; K11's call split into
                host glue (and its weight pack), body, each weight-gradient
                product (beside its bound and torch.matmul) and host sums;
                two K11 calls bit for bit; the reduction against the plain
                f32 X^T Y on K11's own operands.
  8. train    — phase 6 on the fused half-blocks
                (``pallas_synthesis_train=True``): 36 K10 and 18 K11 launches
                a pair; and the TINY card-vs-CPU step on them.
  9. trainer  — ``Trainer`` on MAP3DBN at full width, batch 8: 4 steps with
                checkpoints and EMA samples, then a second ``Trainer`` resumes
                at step 4 and runs to 6; finite metrics; K1-K3 and K7-K11
                launched.
 10. result   — a JSON line of the kernels (times, bounds, launches by path),
                the card line, and the final {"ok": true, "device": ...} line.
"""

import contextlib
import json
import math
import os
import re
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


def check_geo(inp, meta):
    import torch

    from threedhumangan_tpu_torch.ops import geo

    args = (inp["points"], inp["vertices"], inp["vfeat"], inp["skeletons"])
    legacy = meta["legacy_mode"]
    feats, idx = geo.geo_features(*args, legacy_mode=legacy, return_index=True)
    ref, ref_idx = geo.geo_features_plain(*args, legacy_mode=legacy, point_chunk=1024)
    torch.cuda.synchronize()
    agree = float((idx.long() == ref_idx).float().mean())
    mx, mean, p99 = diff_stats(feats, ref)
    log(f"check K1 geo: shape {tuple(feats.shape)}  index agreement {agree * 100:.6f}%  "
        f"max|d| {mx:.3e} mean|d| {mean:.3e}")
    log("  tolerance: index agreement 100% and max|d| <= 1e-5 (the distance is formed "
        "with the same f32 op order in both, so the argmin is bit-identical; the features "
        "differ only by FMA contraction)")
    if agree != 1.0 or mx > 1e-5:
        raise AssertionError("K1 disagrees with its plain version")
    ms = cuda_ms(lambda: geo.geo_features(*args, legacy_mode=legacy), 3)
    plain_ms = cuda_ms(lambda: geo.geo_features_plain(*args, legacy_mode=legacy,
                                                      point_chunk=1024), 1)
    B, P, _ = inp["points"].shape
    V, Cf = inp["vfeat"].shape[1:]
    # ~9 float32 operations a (point, vertex) distance (csrc/geo.cu)
    bd = bound(9 * B * P * V, 4 * (B * P * (3 + 31 + 1) + B * V * (3 + Cf)), PEAK_F32)
    log(f"  time: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']})")
    return feats, dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms, **bd)


def check_field(gen, inp, geo_feats, meta):
    import torch

    from threedhumangan_tpu_torch.models.siren import CoordConcatSiren
    from threedhumangan_tpu_torch.ops import raymarch as rm

    bf16 = torch.bfloat16
    S = meta["num_steps"]
    kw = dict(white_back=meta["white_back"], last_back=meta["last_back"])

    # narrow, exact sine: pointwise
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    small = CoordConcatSiren(3, 32, 31, 32, 4, generator=torch.Generator().manual_seed(SEED + 1))
    small = small.cuda()
    Bn, Rn = 2, 256
    # 37 columns, or 38 with the nerf-noise column of the training path
    pk38 = torch.randn(Bn, Rn * S, rm.INPUT_PACK + 1, generator=g, device="cuda") * 0.5
    pk38[..., 34:37] = (pk38.view(Bn, Rn, S, -1)[:, :, :1, 34:37].expand(Bn, Rn, S, 3)
                        .reshape(Bn, Rn * S, 3))
    zv = torch.sort(torch.rand(Bn, Rn, S, generator=g, device="cuda") + 1.0, -1).values
    fr = 0.1 * torch.randn(Bn, 4 * 32, generator=g, device="cuda")
    ph = 0.1 * torch.randn(Bn, 4 * 32, generator=g, device="cuda")
    with torch.no_grad():
        sh, pi = rm.fold_film_tables(small, fr, ph, bf16)
    # both residual routings (the bench's last_back=False, the sampler's
    # True), and the noise column
    for last_back, noise in ((False, False), (True, False), (False, True)):
        pk = pk38 if noise else pk38[..., :rm.INPUT_PACK].contiguous()
        nkw = dict(white_back=meta["white_back"], last_back=last_back)
        o_k, d_k = rm.field_render_cuda(sh, pi, pk, zv, S, exact_sin=True, **nkw)
        o_p, d_p = rm.field_render_plain(sh, pi, pk, zv, S, compute_dtype=bf16, exact_sin=True,
                                         **nkw)
        mx, mean, p99 = diff_stats(torch.cat([o_k, d_k], -1), torch.cat([o_p, d_p], -1))
        log(f"check K2 field narrow (hidden 32, exact sin, bf16 operands, last_back "
            f"{last_back}, noise {noise}): max|d| {mx:.3e} mean|d| {mean:.3e} p99|d| {p99:.3e}")
        log("  tolerance: max|d| <= 5e-3, mean|d| <= 1e-5 (f32 sums in another order flip "
            "occasional bf16 roundings of activations, which the omega-30 SIREN amplifies)")
        if mx > 5e-3 or mean > 1e-5:
            raise AssertionError("K2 (narrow) disagrees with its plain version")

    # full width, the slice's inputs and weights: statistics
    packed = rm.pack_field_inputs(inp["points"], geo_feats, inp["dirs"],
                                  2.0 / meta["side_length"]).to(bf16).contiguous()
    with torch.no_grad():
        sh, pi = rm.fold_film_tables(gen.neural_field, inp["freq"], inp["phase"], bf16)
    exact = not meta["fast_math"]
    run_k = lambda: rm.field_render_cuda(sh, pi, packed, inp["z_vals"], S, exact_sin=exact, **kw)
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
    ms = cuda_ms(run_k, 3)
    plain_ms = cuda_ms(run_p, 1)
    bd = field_bound(packed, o_k, meta, backward=0)
    log(f"  time: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']})")
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms, **bd)


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
    H, F = meta["hidden_dim"], meta["feature_dim"]
    n_mod = NB if mode == "all" else len(mods)
    per_px = 2 * (2 * H + NB * 2 * H * H + n_mod * 2 * (F * 128 + 2 * 128 * H)
                  + (NB - NB // 2 + 1) * 3 * H)
    bd = bound(per_px * style.shape[0] * style.shape[1] * style.shape[2],
               style.numel() * style.element_size() + r_k.numel() * r_k.element_size())
    log(f"  time: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']})")
    hp = round16(H)
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


def ptxas_of(source):
    """Registers and spill bytes that ``ptxas -v`` reported for the kernels of
    one csrc source in this run's build log (the most over its kernels);
    None when this run built nothing, since a log on disk may be another
    build's."""
    from threedhumangan_tpu_torch import _build

    out = dict(registers=None, spill_stores=None, spill_loads=None)
    path = _build.BUILD_INFO.get("log")  # none when this run loaded a cached library
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
                   spill_loads=max(ld, default=None))
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
        f"stage sum {sum(stage_ms.values()):.3f} ms")
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


def check_raster(pre, cond, meta):
    import torch

    from threedhumangan_tpu_torch.ops import rasterize as ras

    H, W, tile = meta["gen_height"], meta["gen_width"], pre.raster_tile
    F = pre.faces.shape[0]
    K = -(-min(pre.raster_faces_per_tile, F) // 128) * 128
    _, tiles_x, xs, ys, span = ras._grid((H, W), tile)
    tri = ras.bin_candidates(pre.screen_vertices(cond), pre.faces.cuda(), (H, W), tile, K)
    run_k = lambda: ras.rasterize_tiles_cuda(tri, tiles_x, tile, xs, ys, span)
    run_p = lambda: ras.rasterize_tiles_plain(tri, tiles_x, tile, xs, ys, span)
    (fk, bk, zk), (fp, bp, zp) = run_k(), run_p()
    torch.cuda.synchronize()
    agree = float((fk == fp).float().mean())
    cover = fp >= 0
    bmx = float((bk - bp).abs().max())
    zmx = float(torch.where(cover, (zk - zp).abs(), torch.zeros_like(zk)).max())
    log(f"check K7 rasterizer {tuple(tri.shape)} candidates, {F} faces: face-id agreement "
        f"{agree * 100:.6f}% (coverage {float(cover.float().mean()) * 100:.2f}%), bary max|d| "
        f"{bmx:.3e}, z max|d| {zmx:.3e}")
    log("  tolerance: 100% face-id agreement and bary/z max|d| == 0 (the kernel rounds every "
        "step in the plain version's op order, and the lowest candidate row wins z ties)")
    if agree != 1.0 or bmx > 0 or zmx > 0:
        raise AssertionError("K7 disagrees with its plain version")
    ms = cuda_ms(run_k, 5)
    plain_ms = cuda_ms(run_p, 1)
    # ~20 float32 operations a (pixel, valid candidate) pair (csrc/rasterize.cu)
    n_valid = int((tri[..., 9] > 0).sum())
    bd = bound(20 * n_valid * tile * tile, tri.numel() * 4 + fk.numel() * 4 * 5, PEAK_F32)
    log(f"  time: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']}, {n_valid} valid candidates)")
    return dict(max_abs_err=bmx, ms=ms, plain_ms=plain_ms, **bd)


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
                               cond["tpose_vertices"], cond["fk_matrices"], cond["lbs_weights"])
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
    # routings; hidden 40 pads to 48 channels
    for hidden, noise, last_back in ((32, False, False), (32, True, False), (40, True, True),
                                     (32, False, True)):
        field, pk, zv, fr, ph, go, gd = _random_field_case(hidden, 4, noise, gcuda)
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
    run_k = lambda: rm.field_render_cuda(sh, pi, pk, zv, S, wb, lb, exact)
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
    log(f"  time: kernel {k2_train['ms']:.3f} ms  plain {k2_train['plain_ms']:.3f} ms  bound "
        f"{k2_train['bound_ms']:.3f} ms ({k2_train['bound_by']})")
    del o_k, d_k, o_p, d_p, sh, pi

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
    ms8 = cuda_ms(lambda: rb.field_stats_cuda(w, pk, fk, pk_, go, S, exact_sin=exact), 3)
    plain8 = cuda_ms(lambda: rb.field_stats_plain(w, pk, fk, pk_, go, S, exact_sin=exact), 1)
    ms9 = cuda_ms(lambda: rb.field_bwd_step_cuda(w, pk, fk, pk_, go, coef, dsig, S,
                                                 exact_sin=exact), 3)
    plain9 = cuda_ms(lambda: rb.field_bwd_step_plain(w, pk, fk, pk_, go, coef, dsig, S,
                                                     exact_sin=exact), 1)
    b8, b9 = field_bound(pk, go, meta, backward=1), field_bound(pk, go, meta, backward=2)
    # the reduction at K9's ragged widths: the first layer's narrow K (k0p)
    # and the 16-column-padded colour layer (hp + 16), at one launch's rows
    _, dims = rb.kernel_tables(w, fk, pk_)
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
    return (k2_train, dict(max_abs_err=smx, ms=ms8, plain_ms=plain8, **b8),
            dict(max_abs_err=k9mx, ms=ms9, plain_ms=plain9, **b9))


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
    # last tile of 22; and MAP3DBN512L's width 420 (padded to 432, K11's
    # largest shared-memory layout)
    for ci, cs, spatial, with_fixed in ((40, 24, True, True), (40, 24, True, False),
                                        (40, 24, False, False), (420, 420, True, True)):
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
    core = ptxas_of("synthesis_train_bwd.cu")
    log(f"  K11 ptxas: {core['registers']} registers, {core['spill_stores']} bytes spill stores, "
        f"{core['spill_loads']} bytes spill loads (None: this run loaded a cached build)")
    res["spatial"]["k11"].update(ptxas=core)
    return res


# ---------------------------------------------------------------------------
# K4-K6: the generator's other kernel selections
# ---------------------------------------------------------------------------

SELECTIONS = {"K4": dict(pallas_fold_film=False), "K5": dict(pallas_fuse_geo=True),
              "K6": dict(pallas_geo=False, pallas_knn=True)}


def check_knn(inp):
    """K6 against its plain version at the slice's shapes; cdist + min as
    the library yardstick."""
    import torch

    from threedhumangan_tpu_torch.ops import knn

    pts, verts = inp["points"], inp["vertices"]
    run_k = lambda: knn.nn_points_cuda(pts, verts)
    run_p = lambda: knn.nn_points_plain(pts, verts, point_chunk=1024)
    (dk, ik), (dp, ip) = run_k(), run_p()
    torch.cuda.synchronize()
    agree = float((ik == ip).float().mean())
    mx = float((dk - dp).abs().max())
    log(f"check K6 1-NN {tuple(pts.shape)} points x {verts.shape[1]} vertices: index agreement "
        f"{agree * 100:.6f}%  distance max|d| {mx:.3e}")
    log("  tolerance: index agreement 100% and distance max|d| == 0 (the same elementwise f32 "
        "distance as the plain version, lowest index on ties)")
    if agree != 1.0 or mx > 0:
        raise AssertionError("K6 disagrees with its plain version")
    ms = cuda_ms(run_k, 3)
    plain_ms = cuda_ms(run_p, 1)
    # one PyTorch call pair computes the same function: cdist, then min (a
    # (B, P, V) float32 matrix of 32.5 GB at this shape)
    lib_ms = cuda_ms(lambda: torch.cdist(pts, verts).min(-1), 1)
    torch.cuda.empty_cache()
    B, P, _ = pts.shape
    V = verts.shape[1]
    # ~9 float32 operations a (point, vertex) distance (csrc/nn_scan.cuh)
    bd = bound(9 * B * P * V, 4 * (B * P * (3 + 1 + 1) + B * V * 3), PEAK_F32)
    log(f"  time: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  library (torch.cdist + min, two "
        f"calls) {lib_ms:.3f} ms  bound {bd['bound_ms']:.3f} ms ({bd['bound_by']})")
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_call="torch.cdist(points, verts).min(-1): two calls", **bd)


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
    o_2, _ = rm.fused_field_render(gen.neural_field, packed, inp["freq"], inp["phase"],
                                   inp["z_vals"], S, compute_dtype=bf16, **kw)
    fmx, fmean, fp99 = diff_stats(o_k, o_2)
    log(f"  K4 vs K2 (folded) on the same inputs, for information: map max|d| {fmx:.3e} mean|d| "
        f"{fmean:.3e} p99|d| {fp99:.3e} (folding rounds the freq-scaled weights to bf16)")
    ms = cuda_ms(run_k, 3)
    plain_ms = cuda_ms(run_p, 1)
    bd = field_bound(packed, o_k, meta, backward=0)
    log(f"  time: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']})")
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms, **bd)


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
    ms = cuda_ms(run_k, 3)
    plain_ms = cuda_ms(run_p, 1)
    bd = geo_bound(packed, o_k, meta, full["verts"].shape[1])
    log(f"  time: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bd['bound_ms']:.3f} ms "
        f"({bd['bound_by']})")
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms, **bd)


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
    raymarch.launches_unfolded = raymarch.launches_geo = 0
    raymarch_bwd.launches_stats = raymarch_bwd.launches_bwd = raymarch_bwd.launches_wgrad = 0
    synthesis_train.launches_fwd = synthesis_train.launches_bwd = 0
    synthesis_train.launches_wgrad = 0


def read_counts():
    from threedhumangan_tpu_torch.ops import (geo, knn, rasterize, raymarch, raymarch_bwd,
                                              synthesis_kernel, synthesis_train)

    return {"K1": geo.launches, "K2": raymarch.launches, "K3": synthesis_kernel.launches,
            "K4": raymarch.launches_unfolded, "K5": raymarch.launches_geo, "K6": knn.launches,
            "K7": rasterize.launches, "K8": raymarch_bwd.launches_stats,
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
    for it in range(WARMUP + TIMED):
        timer.on = it >= WARMUP
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, stats = train_step_pair(ts, batch, gcuda, meta, pre, phase, 1e-4, 4e-4, 0.5,
                                    stage=timer.stage)
        torch.cuda.synchronize()
        if timer.on:
            walls.append(time.perf_counter() - t0)
    counts = read_counts()
    stage_ms = timer.per_pair_ms(TIMED)
    log(f"train ({'fused K10/K11' if fused else 'per-op'} synthesis): MAP3DBN D+G+R1 batch "
        f"{BATCH} bf16, phase slot 3, {TIMED} timed pair steps after {WARMUP} warm-up")
    labels = {"preprocess": "preprocess (camera + K7), D and G", "d_fakes": "D-step fakes",
              "d_step": "D fwd + R1 + bwd", "d_r1": "  of which R1", "d_optimizer": "D optimizer",
              "g_forward": "G fwd (G + D)", "g_backward": "G bwd",
              "g_optimizer": "G optimizer + EMA"}
    for k, lab in labels.items():
        log(f"  stage {lab:<36} {stage_ms.get(k, float('nan')):9.3f} ms/pair")
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
    pairs = WARMUP + TIMED
    if fused and (counts["K10"] != 36 * pairs or counts["K11"] != 18 * pairs):
        raise AssertionError(f"expected 36 K10 and 18 K11 launches a pair: {counts}")
    if not fused and counts["K10"] + counts["K11"]:
        raise AssertionError(f"the per-op path launched K10/K11: {counts}")
    return dict(counts=counts, ms_per_pair=total * 1e3, imgs_per_s=BATCH / total,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, stage_ms=stage_ms)


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
        k6 = check_knn(inp)
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
    k7 = check_raster(tpre, tcond, tmeta)
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

    # ---- 10. result
    src = "threedhumangan_tpu_torch/csrc/"
    paths = {"generation": counts, "training_per_op": per_op["counts"],
             "training_fused": fused["counts"], "trainer": trainer_counts}
    paths.update({f"generation_{k}": r["counts"] for k, r in sel_runs.items()})
    by_path = lambda k: {p: c.get(k, 0) for p, c in paths.items()}
    tc, fc = per_op["counts"], fused["counts"]
    kernels = [
        dict(name="K1 geo features", route="cuda", source=src + "geo.cu",
             replaces="threedhumangan_tpu/ops/geo.py:94", launches=counts["K1"], **k1),
        dict(name="K2 folded field render", route="cuda", source=src + "raymarch.cu",
             replaces="threedhumangan_tpu/ops/raymarch.py:525", launches=counts["K2"],
             training_shapes=k2_train, **k2),
        dict(name="K3 fused SPADE synthesis", route="cuda", source=src + "synthesis.cu",
             replaces="threedhumangan_tpu/ops/synthesis_kernel.py:91", launches=counts["K3"],
             **k3),
        dict(name="K7 rasterizer tile z-test", route="cuda", source=src + "rasterize.cu",
             replaces="threedhumangan_tpu/ops/rasterize.py:335", launches=tc["K7"], **k7),
        dict(name="K8 field backward stats", route="cuda", source=src + "raymarch_bwd.cu",
             replaces="threedhumangan_tpu/ops/raymarch_bwd.py:132", launches=tc["K8"], **k8),
        dict(name="K9 field backward step", route="cuda", source=src + "raymarch_bwd.cu",
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
        dict(name="K4 unfolded field render", route="cuda", source=src + "raymarch_unfolded.cu",
             replaces="threedhumangan_tpu/ops/raymarch.py:149",
             launches=sel_runs["K4"]["counts"]["K4"], training_shapes=k4_train, **k4),
        dict(name="K5 geo-fused field render", route="cuda", source=src + "raymarch_geo.cu",
             replaces="threedhumangan_tpu/ops/raymarch.py:1037",
             launches=sel_runs["K5"]["counts"]["K5"], training_shapes=k5_train, **k5),
        dict(name="K6 1-NN search", route="cuda", source=src + "knn.cu",
             replaces="threedhumangan_tpu/ops/knn.py:80", launches=sel_runs["K6"]["counts"]["K6"],
             **k6),
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
    order = sorted(kernels, key=lambda k: -k["excess_ms_per_iteration"])
    log("kernels by ms above their bound per main-path iteration (a batch or a fused pair): "
        + ", ".join(f"{k['name'].split()[0]} {k['excess_ms_per_iteration']:.3f}" for k in order))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
