#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (threedhumangan_tpu_torch) on one
CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (exit code != 0):

  1. card   — nvidia-smi name and power limit; TF32 off for the references.
  2. build  — nvcc builds K1-K3 from threedhumangan_tpu_torch/csrc.
  3. check  — each kernel against its plain PyTorch version at the slice's
              shapes (and K2/K3 pointwise at a narrow width), with the
              tolerance and its reason; kernel and plain times from CUDA
              events after a warm-up.
  4. slice  — MAP3DBN512L generation at batch 8 in bf16 with seeded random
              weights: 2 warm-up + 5 timed batches through
              ``generator_forward``, per-stage ms/batch, imgs/s; the output
              must be (8, 512, 256, 3), finite and not constant, every
              kernel's launch count must rise, and a small config run on
              the card must agree with the same run on the CPU.
  5. result — a JSON line of the kernels, the card line, and the final
              {"ok": true, "device": ...} line.
"""

import contextlib
import json
import math
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
    log(f"  time: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
    return feats, dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms)


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
    pk = torch.randn(Bn, Rn * S, rm.INPUT_PACK, generator=g, device="cuda") * 0.5
    pk[..., 34:] = pk.view(Bn, Rn, S, -1)[:, :, :1, 34:].expand(Bn, Rn, S, 3).reshape(Bn, Rn * S, 3)
    zv = torch.sort(torch.rand(Bn, Rn, S, generator=g, device="cuda") + 1.0, -1).values
    fr = 0.1 * torch.randn(Bn, 4 * 32, generator=g, device="cuda")
    ph = 0.1 * torch.randn(Bn, 4 * 32, generator=g, device="cuda")
    with torch.no_grad():
        sh, pi = rm.fold_film_tables(small, fr, ph, bf16)
    # both residual routings: the bench's last_back=False, the sampler's True
    for last_back in (False, True):
        nkw = dict(white_back=meta["white_back"], last_back=last_back)
        o_k, d_k = rm.field_render_cuda(sh, pi, pk, zv, S, exact_sin=True, **nkw)
        o_p, d_p = rm.field_render_plain(sh, pi, pk, zv, S, compute_dtype=bf16, exact_sin=True,
                                         **nkw)
        mx, mean, p99 = diff_stats(torch.cat([o_k, d_k], -1), torch.cat([o_p, d_p], -1))
        log(f"check K2 field narrow (hidden 32, exact sin, bf16 operands, last_back "
            f"{last_back}): max|d| {mx:.3e} mean|d| {mean:.3e} p99|d| {p99:.3e}")
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
    log(f"  time: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms)


def check_synthesis(gen, meta, styles, gcuda):
    import torch

    from threedhumangan_tpu_torch.models import synthesis as syn
    from threedhumangan_tpu_torch.ops import synthesis_kernel as sk

    bf16 = torch.bfloat16
    NB, mods, mode = meta["synthesis_blocks"], tuple(meta["mod_blocks"]), meta["map3d_mode"]

    # narrow: pointwise, in every map3d mode (the slice runs "isolated")
    for narrow_mode in ("isolated", "mixed", "all"):
        g = torch.Generator(device="cuda").manual_seed(SEED + 2)
        net = syn.SynthesisNetwork(32, 32, 32, NB, mods, "batch_norm", narrow_mode)
        net.reset_parameters(torch.Generator().manual_seed(SEED + 2))
        sin_ = syn.SynthesisInput(2, 32)
        sin_.reset_parameters(torch.Generator().manual_seed(SEED + 3))
        net, sin_ = net.cuda(), sin_.cuda()
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    n = m.running_mean.shape
                    m.running_mean.copy_(0.1 * torch.randn(n, generator=g, device="cuda"))
                    m.running_var.copy_(1.0 + 0.2 * torch.rand(n, generator=g, device="cuda"))
            folded = sk.fold_synthesis_params(net, sin_, "batch_norm")
        st = torch.randn(2, 32, 64, 32, generator=g, device="cuda").to(bf16)
        fx = torch.randn(2, 1, 32, generator=g, device="cuda")
        r_k = sk.synthesis_cuda(folded, st, fx, NB, mods, narrow_mode)
        r_p = sk.synthesis_plain(folded, st, fx, NB, mods, narrow_mode, bf16)
        mx, mean, p99 = diff_stats(r_k, r_p)
        log(f"check K3 synthesis narrow (hidden 32, {narrow_mode}): max|d| {mx:.3e} "
            f"mean|d| {mean:.3e} p99|d| {p99:.3e} (rgb mean|x| {float(r_p.abs().mean()):.3e})")
        log("  tolerance: max|d| <= 2e-2, mean|d| <= 1e-4 (bf16 activations; f32 sums in "
            "another order flip occasional bf16 roundings)")
        if mx > 2e-2 or mean > 1e-4:
            raise AssertionError(f"K3 (narrow, {narrow_mode}) disagrees with its plain version")

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
    log(f"  time: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms)


def check_small_config():
    """A small legacy/isolated config through generator_forward on the card
    (kernels) and on the CPU (plain versions), same weights and inputs."""
    import torch

    from threedhumangan_tpu_torch import configs
    from threedhumangan_tpu_torch.data.dataset import (
        SyntheticSHHQDataset, iterate_batches, to_tensors)
    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.generator import generator_forward, init_generator
    from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model

    meta = dict(configs.extract_metadata(configs.MAP3DBN_TINY, 0))
    meta.update(nerf_noise=0, perturb_rays=False, legacy_mode=True, map3d_mode="isolated")
    smpl = synthetic_smpl_model(num_verts=384, num_faces=512)
    batch = next(iterate_batches(SyntheticSHHQDataset(smpl_model=smpl, **meta), 2, shuffle=False))
    z = torch.randn(2, meta["latent_dim"], generator=torch.Generator().manual_seed(SEED))
    outs = {}
    for dev in ("cuda", "cpu"):
        gen = init_generator(meta, torch.Generator().manual_seed(SEED), dev)
        cond = get_preprocessor(meta).forward_with_rotation(
            to_tensors(batch, dev), *(torch.zeros(2, device=dev),) * 3)
        outs[dev] = generator_forward(gen, z.to(dev), cond, meta, compute_dtype=torch.bfloat16)
    res = {}
    for k in ("rgbs_render", "rgbs"):
        mx, mean, _ = diff_stats(outs["cuda"][k].cpu(), outs["cpu"][k])
        res[k] = (mx, mean)
    log(f"check small config (TINY, legacy, isolated, bf16) card vs CPU plain: "
        f"rgbs_render max|d| {res['rgbs_render'][0]:.3e} mean|d| {res['rgbs_render'][1]:.3e}; "
        f"rgbs max|d| {res['rgbs'][0]:.3e} mean|d| {res['rgbs'][1]:.3e}")
    log("  tolerance: mean|d| <= 2e-2 for both (bf16 end to end, see the kernel checks)")
    if res["rgbs_render"][1] > 2e-2 or res["rgbs"][1] > 2e-2:
        raise AssertionError("the card disagrees with the CPU plain path")


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
    from threedhumangan_tpu_torch.models.generator import generator_forward, init_generator
    from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
    from threedhumangan_tpu_torch.ops import geo, raymarch, synthesis_kernel

    # ---- 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.BUILD_INFO.get('path')})")
    if _build.BUILD_INFO.get("log"):
        with open(_build.BUILD_INFO["log"]) as f:
            for line in f:
                if "registers" in line or "spill" in line:
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
    del inp, geo_feats
    torch.cuda.empty_cache()

    # ---- 4. the slice through the port's entry point
    timer = StageTimer()
    for mod in (geo, raymarch, synthesis_kernel):
        mod.launches = 0
    walls = []
    for it in range(WARMUP + TIMED):
        timer.on = it >= WARMUP
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timer.stage("conditions"):
            cond = pre(batch, rotate=True, generator=gcuda)
        out = generator_forward(gen, z0 + 0.01 * it, cond, meta, gcuda,
                                compute_dtype=torch.bfloat16, stage=timer.stage)
        torch.cuda.synchronize()
        if timer.on:
            walls.append(time.perf_counter() - t0)
    counts = {"K1": geo.launches, "K2": raymarch.launches, "K3": synthesis_kernel.launches}
    stage_ms = timer.mean_ms()
    rgbs = out["rgbs"]
    log(f"slice: MAP3DBN512L batch {BATCH} bf16, {TIMED} timed batches after {WARMUP} warm-up")
    for k in ("conditions", "mapping", "rays", "geo", "field", "resize", "synthesis"):
        log(f"  stage {k:<10} {stage_ms[k]:9.3f} ms/batch")
    total = sum(walls) / len(walls)
    log(f"  total {total * 1e3:.3f} ms/batch (host clock)  {BATCH / total:.3f} imgs/s  "
        f"stage sum {sum(stage_ms.values()):.3f} ms")
    log(f"  launches during the slice: {counts}")
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if tuple(rgbs.shape) != (BATCH, meta["gen_height"], meta["gen_width"], 3):
        raise AssertionError(f"bad output shape {tuple(rgbs.shape)}")
    if not torch.isfinite(rgbs).all() or not torch.isfinite(out["rgbs_render"]).all():
        raise AssertionError("non-finite output")
    if float(rgbs.float().std()) <= 0.0:
        raise AssertionError("constant output")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel did not launch during the slice: {counts}")
    log(f"  output {tuple(rgbs.shape)} mean {float(rgbs.mean()):.4f} std {float(rgbs.std()):.4f}")
    check_small_config()

    # ---- 5. result
    src = "threedhumangan_tpu_torch/csrc/"
    kernels = [
        dict(name="K1 geo features", route="cuda", source=src + "geo.cu",
             replaces="threedhumangan_tpu/ops/geo.py:94", launches=counts["K1"], **k1),
        dict(name="K2 folded field render", route="cuda", source=src + "raymarch.cu",
             replaces="threedhumangan_tpu/ops/raymarch.py:525", launches=counts["K2"], **k2),
        dict(name="K3 fused SPADE synthesis", route="cuda", source=src + "synthesis.cu",
             replaces="threedhumangan_tpu/ops/synthesis_kernel.py:91", launches=counts["K3"], **k3),
    ]
    for k in kernels:
        for key in ("max_abs_err", "ms", "plain_ms"):
            if not math.isfinite(k[key]):
                raise AssertionError(f"{k['name']}: {key} is not finite")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
