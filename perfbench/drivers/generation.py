"""Generation: a closed loop of batches through the port's inference entry.

Mix parameters (``perfbench/traffic/<mix>.json``): ``batch`` images a batch,
``pool`` posed bodies made in set-up, ``sample`` batches compared with the
reference, ``host_trace_seconds`` of a traced run's host-traced stretch (at
most ``--seconds``), ``smpl_vertices`` / ``smpl_faces`` of the synthetic body.

Set-up makes, from the seed: the SMPL pose parameters of the pool (posed by
the port's loader code, as a user's data is), the generator's weights (on
the card, ``perfbench.reference.weights``) and a draw generator.  Each
batch takes the next ``batch`` bodies of a seeded order of the pool and new
draws from a generator seeded by (seed, batch index): latents, the camera's
yaw and pitch, the rays' jitter and the nerf noise.  It runs the port's
preprocessor (camera half) and ``generator_forward`` with ``with_depth`` at
truncation 1, which is ``staged_forward`` with the draws handed in, and ends
when its images are on the host.  After the window, a reservoir sample of
the batches (seeded) is worked out again by the plain reference from the
same raw inputs, and compared.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import numpy as np

from perfbench import flops
from perfbench.harness import Profiled, Record, Stages, step_meta, sub_seed

# the numbers compared with the reference, and the outputs each is of
QUANTITIES = {"rgb_rel_l2": "rgbs", "render_rel_l2": "rgbs_render", "depth_rel_l2": "depths"}
WARMUP = 2  # batches: the first finds the kernels built and fills the port's caches


def pose_params(seed: int, n: int, joints: int = 24):
    """Axis-angle (n, J, 3) and betas (n, 10) of the pool, as the synthetic
    loader draws them (0.2 and 0.5 standard deviations)."""
    rng = np.random.default_rng(sub_seed(seed, "poses"))
    aa = (0.2 * rng.standard_normal((n, joints, 3))).astype(np.float32)
    betas = (0.5 * rng.standard_normal((n, 10))).astype(np.float32)
    return aa, betas


def program_pool(smpl_arrays, aa, betas, meta, device):
    """The pool's conditions posed by the port's own loader code
    (``SMPLModel.forward`` and ``preprocess_smpl_fix_body``), on ``device``."""
    import torch

    from threedhumangan_tpu_torch.data.dataset import preprocess_smpl_fix_body, to_tensors
    from threedhumangan_tpu_torch.models.smpl import SMPLModel, batch_rodrigues

    t = lambda k: torch.as_tensor(smpl_arrays[k])
    model = SMPLModel(v_template=t("v_template"), shapedirs=t("shapedirs"),
                      posedirs=t("posedirs"), J_regressor=t("J_regressor"),
                      parents=smpl_arrays["parents"], lbs_weights=t("lbs_weights"),
                      faces=smpl_arrays["faces"])
    items = []
    joints = list(meta.get("joints", range(model.num_joints)))
    with torch.no_grad():
        for a, b in zip(aa, betas):
            rot = batch_rodrigues(torch.as_tensor(a)[None])[0]
            out = model.forward(torch.as_tensor(b)[None], rot[None], pose2rot=False)
            pred = {"orig_cam": np.asarray([[1.8, 1.8, 0.0, 0.0]], np.float32),
                    "joints": out["joints"].numpy(), "full_pose": rot[None].numpy(),
                    "tpose_vertices": out["tpose_vertices"].numpy(),
                    "fk_matrices": out["fk_matrices"].numpy(),
                    "lbs_weights": model.lbs_weights.numpy(), "betas": b[None]}
            items.append(preprocess_smpl_fix_body(pred, joints, model.v_template.numpy()))
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    return to_tensors(batch, device)


def draws(meta, gen, B):
    """One batch's draws, in this order: latents, the camera's yaw and pitch
    (the preprocessor's random orbit), the rays' jitter, the nerf noise."""
    import torch

    dev = gen.device
    R, S = meta["render_width"] * meta["render_height"], meta["num_steps"]
    z = torch.randn(B, meta["latent_dim"], generator=gen, device=dev)
    h = torch.randn(B, generator=gen, device=dev) * meta["h_stddev"] + meta["h_mean"]
    v = torch.randn(B, generator=gen, device=dev) * meta["v_stddev"] + meta["v_mean"]
    perturb = torch.rand(B, R, S, 1, generator=gen, device=dev)
    noise = torch.randn(B, R * S, 1, generator=gen, device=dev)
    return z, h, v, {"perturb": perturb, "noise": noise}


class Batches:
    """Batch ``i``'s pool rows and its draw generator's seed."""

    def __init__(self, seed, pool, B, device):
        import torch

        self.seed = seed
        order = np.random.default_rng(sub_seed(seed, "order")).permutation(pool)
        cycle = pool // math.gcd(pool, B)
        self.rows = [torch.as_tensor(order[(i * B + np.arange(B)) % pool], device=device)
                     for i in range(cycle)]
        self.gen = torch.Generator(device=device)

    def __call__(self, i, tag="window"):
        self.gen.manual_seed(sub_seed(self.seed, tag, i))
        return self.rows[i % len(self.rows)], self.gen


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Record:
    import torch

    from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
    from threedhumangan_tpu_torch.models.generator import Map3DGenerator, generator_forward
    from threedhumangan_tpu_torch.trainers.phase_trainer import compute_dtype
    from perfbench.reference import smpl as ref_smpl
    from perfbench.reference.weights import generator_leaves, make_state

    meta = step_meta(cell.config)
    tr = cell.traffic
    B, pool = int(tr["batch"]), int(tr["pool"])
    cdt = compute_dtype(meta)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from threedhumangan_tpu_torch import _build

        _build.library()
    smpl_arrays = ref_smpl.synthetic_smpl_arrays(num_verts=tr["smpl_vertices"],
                                                 num_faces=tr["smpl_faces"])
    aa, betas = pose_params(seed, pool)
    data = program_pool(smpl_arrays, aa, betas, meta, device)
    wgen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    state = make_state(generator_leaves(meta), wgen, device)
    with torch.device(device):
        G = Map3DGenerator(meta)
    G.load_state_dict(state, strict=True)
    G.eval()
    pre = get_preprocessor(meta)
    batches = Batches(seed, pool, B, device)
    stages = Stages()
    psi = meta.get("truncation_psi", 1.0)

    host = []  # two pinned image buffers, in turns: a batch ends when its copy has landed

    def one(i, tag="window", keep=False):
        rows, gen = batches(i, tag)
        z, h, v, dr = draws(meta, gen, B)
        cond = {k: t.index_select(0, rows) for k, t in data.items()}
        with stages.stage("conditions"):
            cond = pre.forward_with_rotation(cond, h, v, torch.zeros_like(h))
        out = generator_forward(G, z, cond, meta, gen, compute_dtype=cdt, truncation_psi=psi,
                                with_depth=True, stage=stages.stage, draws=dr)
        with stages.stage("to_host"):
            if len(host) < 2:
                host.append(torch.empty(out["rgbs"].shape, dtype=out["rgbs"].dtype,
                                        pin_memory=on_card))
            host[i % 2].copy_(out["rgbs"])
        # a sampled batch keeps its outputs where they are, the images that
        # were copied among them, and adds no work to the window
        return {k: out[k] for k in QUANTITIES.values()} if keep else None

    for i in range(WARMUP):
        one(i, "warmup")
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way, as a serving process does
    rec = Record(work=flops.generation(meta, B))
    traced = trace and on_card
    if on_card:
        torch.cuda.synchronize()
    k = int(tr["sample"])
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    slots, kept = [None] * k, {}  # a seeded reservoir sample of the window's batches
    i = 0
    if traced:
        # first a stretch with the host's operations traced (the device time
        # launched inside each stage, the idle gaps by what the host did),
        # then the window with CUDA events in the stages and the device alone
        # profiled
        stages.ranges_on = True
        prof = Profiled(host=True)
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < min(seconds, float(tr.get("host_trace_seconds",
                                                                   seconds))):
            one(i, "traced")
            i += 1
        rec.spans = prof.stop(time.perf_counter() - t1)
        stages.ranges_on, stages.events_on = False, True
        prof = Profiled(host=False)
    t0 = time.perf_counter()
    rec.setup_s = t0 - t_start
    first = i
    while True:
        n = i - first
        slot = n if n < k else int(rng.integers(0, n + 1))
        slot = slot if slot < k else None
        s = time.perf_counter()
        out = one(i, keep=slot is not None)
        e = time.perf_counter()
        rec.requests.append((s, e, B))
        if slot is not None:
            kept.pop(slots[slot], None)
            slots[slot], kept[i] = i, out
        i += 1
        if e - t0 >= seconds:
            break
    rec.window_start, rec.window_end = t0, e
    if traced:
        rec.trace = prof.stop(e - t0)
        rec.stage_ms = stages.ms()
        stages.events_on = False
    if on_card:
        rec.peak_bytes = torch.cuda.max_memory_allocated()  # set-up's and the window's
    del G, data, pre
    if on_card:
        torch.cuda.empty_cache()
    rec.checks, rec.failed = check(meta, tr, seed, state, smpl_arrays, aa, betas, kept, device)
    return rec


def reference_batch(meta, tr, seed, i, state, smpl_arrays, aa, betas, device, products=None):
    """The reference's outputs of window batch ``i`` from the raw inputs."""
    import torch

    from perfbench.reference import smpl as ref_smpl
    from perfbench.reference.generator import ReferenceGenerator
    from perfbench.reference.precision import Products

    B, pool = int(tr["batch"]), int(tr["pool"])
    batches = Batches(seed, pool, B, device)
    rows, gen = batches(i)
    z, h, v, dr = draws(meta, gen, B)
    r = rows.cpu().numpy()
    cond = ref_smpl.pose_conditions(smpl_arrays, torch.as_tensor(aa[r], device=device),
                                    torch.as_tensor(betas[r], device=device),
                                    meta.get("joints"))
    cond["cam2world_matrices"] = ref_smpl.fix_body_camera(cond, h, v)
    ref = ReferenceGenerator(state, meta, products or Products())
    return ref.forward(z, cond, dr)


def compare(pairs) -> Dict[str, float]:
    """The numbers judged, over (program, reference) output pairs of the
    compared batches together: the relative L2 distance of the images, of
    the field's render and of the depth map (inf where the program's are
    not finite)."""
    import torch

    out = {}
    for name, key in QUANTITIES.items():
        num = den = 0.0
        for got, ref in pairs:
            g, r = got[key].float().cpu(), ref[key].float().cpu()
            if not torch.isfinite(g).all():
                num = float("inf")
            num += float(torch.sum((g - r) ** 2))
            den += float(torch.sum(r ** 2))
        out[name] = (num / max(den, 1e-30)) ** 0.5
    return out


def check(meta, tr, seed, state, smpl_arrays, aa, betas, kept, device):
    """(the numbers over the sampled batches against the reference's, the
    sampled batches whose images are not all finite)."""
    import torch

    from perfbench.reference.precision import tf32_off

    tf32_off()
    pairs = [(got, reference_batch(meta, tr, seed, i, state, smpl_arrays, aa, betas, device))
             for i, got in sorted(kept.items())]
    return compare(pairs), sum(not bool(torch.isfinite(g["rgbs"]).all()) for g, _ in pairs)


def control(cell, seed: int, device, dtype) -> Dict[str, float]:
    """The control's numbers: the reference with its products in ``dtype``
    put in the program's place, against the float32 reference, over the
    first ``sample`` window batches of ``seed``."""
    import torch

    from perfbench.reference import smpl as ref_smpl
    from perfbench.reference.precision import Products, tf32_off
    from perfbench.reference.weights import generator_leaves, make_state

    tf32_off()
    meta = step_meta(cell.config)
    tr = cell.traffic
    smpl_arrays = ref_smpl.synthetic_smpl_arrays(num_verts=tr["smpl_vertices"],
                                                 num_faces=tr["smpl_faces"])
    aa, betas = pose_params(seed, int(tr["pool"]))
    wgen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    state = make_state(generator_leaves(meta), wgen, device)
    args = (meta, tr, seed)
    pairs = [(reference_batch(*args, i, state, smpl_arrays, aa, betas, device, Products(dtype)),
              reference_batch(*args, i, state, smpl_arrays, aa, betas, device))
             for i in range(int(tr["sample"]))]
    return compare(pairs)
