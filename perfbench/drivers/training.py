"""Training: a user's run of the port's ``Trainer`` on the configuration,
at its own batch, on its synthetic data.

Mix parameters (``perfbench/traffic/<mix>.json``): ``warmup`` pairs of
set-up (covering the phase slots up to the first R1 slot, so every shape of
the window is built), ``compare`` pairs that the reference follows (the
first ones, from the weights the seed makes), ``host_trace_seconds`` of the
traced run's host-traced stretch, ``smpl_vertices`` / ``smpl_faces`` of the
synthetic body.

Set-up builds one ``Trainer`` (its dataset, preprocessor with the K7
rasterizer, stage, optimizers), loads the weights made from the seed into
its generator and discriminator (and their EMA), and drives ``Trainer.run``
once, with its own loader and prefetch thread.  The benchmark wraps the
port's ``train_step_pair`` (and the ``generator_forward`` its steps call) to
hand each pair the draws made from (seed, pair): the latents, the coins,
the cameras' yaw and pitch, the rays' jitter and the nerf noise.  The first
``warmup`` pairs are set-up; the window starts at the next pair boundary
and ends at the first pair boundary after ``--seconds``, with the device
synchronised at both ends.  The run then stops (no checkpoint is written;
the ``Trainer``'s output directory goes under ``TMPDIR`` and is removed).
With ``--trace 1`` a stretch of ``host_trace_seconds`` (at most
``--seconds``) after set-up traces the host's operations as well, and the
window that follows records CUDA events in the steps' stage hooks and a
device-only profile.

The comparison reads the program's losses of the first ``compare`` pairs,
each leaf's first gradient as Adam holds it after one step (betas (0, 0.9):
the clipped gradient itself), and each leaf's change (parameters and EMA)
after ``compare`` pairs, and holds them against ``perfbench.reference.
training.follow`` run from the same seed after the window.
"""

from __future__ import annotations

import gc
import os
import shutil
import statistics
import tempfile
import time
import types
from typing import Dict, Optional

import numpy as np

from perfbench import flops
from perfbench.harness import HERE, Profiled, Record, Stages, step_meta, sub_seed

RULE = 1e-3  # leaves whose reference gradient is under this share of the median leaf's


class StopRun(Exception):
    """Ends ``Trainer.run`` at the window's end."""


def pair_draws(meta: Dict, phase: Dict, seed: int, k: int, B: int, device) -> Dict:
    """Pair ``k``'s draws for its two steps: latents, the coin, the camera's
    yaw and pitch (scaled to zero on unrotated slots, as the preprocessor
    does), the rays' jitter and the nerf noise."""
    import torch

    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "pair", k))
    R, S = meta["render_width"] * meta["render_height"], meta["num_steps"]
    rot = 1.0 if phase["rotate"] else 0.0
    out = {}
    for part in ("d", "g"):
        z = torch.randn(B, meta["latent_dim"], generator=gen, device=device)
        coin = torch.rand((), generator=gen, device=device)
        h = torch.randn(B, generator=gen, device=device) * (meta["h_stddev"] * rot) \
            + meta["h_mean"]
        v = torch.randn(B, generator=gen, device=device) * (meta["v_stddev"] * rot) \
            + meta["v_mean"]
        perturb = torch.rand(B, R, S, 1, generator=gen, device=device)
        noise = torch.randn(B, R * S, 1, generator=gen, device=device)
        out[part] = {"z": z, "coin": coin, "h_rotation": h, "v_rotation": v,
                     "perturb": perturb, "noise": noise}
    return out


def halved(data: Dict, draws: Dict) -> tuple:
    """The first half of a batch and of its draws (the half-batch fault)."""
    n = data["images"].shape[0] // 2
    cut = lambda t: t if t.ndim == 0 else t[:n]
    return ({k: cut(v) for k, v in data.items()},
            {p: {k: cut(v) for k, v in d.items()} for p, d in draws.items()})


def curriculum(config: Dict, meta: Dict, k: int):
    """(lr_g, lr_d, nerf noise) of step ``k``."""
    blk = step_meta(config, k)
    return blk["gen_lr"], blk["disc_lr"], max(0.0, 1.0 - k / 5000.0)


def smpl_model_of(arrays):
    import torch

    from threedhumangan_tpu_torch.models.smpl import SMPLModel

    t = lambda k: torch.as_tensor(arrays[k])
    return SMPLModel(v_template=t("v_template"), shapedirs=t("shapedirs"),
                     posedirs=t("posedirs"), J_regressor=t("J_regressor"),
                     parents=arrays["parents"], lbs_weights=t("lbs_weights"),
                     faces=arrays["faces"])


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault: Optional[str] = None) -> Record:
    """One run; ``fault`` ('half') plants the half-batch fault in the steps."""
    import torch

    from threedhumangan_tpu_torch.trainers import base_trainer, phase_trainer
    from perfbench.reference import smpl as ref_smpl
    from perfbench.reference import training as ref

    meta = step_meta(cell.config)
    tr = cell.traffic
    warm, n_cmp = int(tr["warmup"]), int(tr["compare"])
    B = int(meta["batch_size"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from threedhumangan_tpu_torch import _build

        _build.library()
    traced = trace and on_card
    host_s = min(seconds, float(tr.get("host_trace_seconds", seconds)))
    arrays = ref_smpl.synthetic_smpl_arrays(num_verts=tr["smpl_vertices"],
                                            num_faces=tr["smpl_faces"])
    out_dir = tempfile.mkdtemp(prefix="perfbench-trainer-")
    opt = types.SimpleNamespace(device=str(torch.device(device)), output_dir=out_dir, seed=0,
                                n_epochs=3000, sample_interval=1000, model_save_interval=1000,
                                model_keep_interval=5000, bs_factor=1, tensorboard=1)
    trainer = base_trainer.Trainer(0, 1, opt, cell.config, smpl_model=smpl_model_of(arrays))
    ts = trainer.ts
    wgen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    g_state, d_state = ref.weights(meta, wgen, device)
    ts.G.load_state_dict(g_state, strict=True)
    ts.D.load_state_dict(d_state, strict=True)
    with torch.no_grad():
        for k, p in ts.G.named_parameters():
            ts.ema["params"][k].copy_(p)
    del g_state, d_state

    rec = Record()
    stages = Stages()
    work = flops.training(meta, B)
    per_pair = []  # the model's products of each window pair
    prog = {"losses": [], "grad": {}, "change": {}}
    st = {"k": 0, "phase": "setup", "p0": None, "pending": [], "prof": None}
    real_pair, real_forward = phase_trainer.train_step_pair, phase_trainer.generator_forward

    def forward(*a, **kw):
        if kw.get("draws") is None and st["pending"]:
            kw["draws"] = st["pending"].pop(0)
        return real_forward(*a, **kw)

    def named(module):
        return dict(module.named_parameters())

    def pair(ts, data, generator, meta_s, preprocessor, phase, lr_g, lr_d, nerf_noise,
             draws=None, stage=None, ada_p=0.0):
        k = st["k"]
        dr = pair_draws(meta, phase, seed, k, B, device)
        if fault == "half":
            data, dr = halved(data, dr)
        st["pending"] = [{"perturb": dr[p].pop("perturb"), "noise": dr[p].pop("noise")}
                         for p in ("d", "g")]
        if k == 0:
            st["p0"] = {m: {n: p.detach().clone() for n, p in named(mod).items()}
                        for m, mod in (("D", ts.D), ("G", ts.G))}
        if k == warm and traced:
            stages.ranges_on, st["phase"] = True, "B"
            st["prof"], st["tB"] = Profiled(host=True), time.perf_counter()
        if st["phase"] == "toA" or (k == warm and not traced):
            start_window()
        s = time.perf_counter()
        ts, stats = real_pair(ts, data, generator, meta_s, preprocessor, phase, lr_g, lr_d,
                              nerf_noise, draws=dr, stage=stages.stage if traced else None,
                              ada_p=ada_p)
        e = time.perf_counter()
        st["k"] += 1
        if k < n_cmp:
            prog["losses"].append([(stats[n][1] / stats[n][0]).clone()
                                   for n in ("d_loss", "g_loss")])
        if k == 0:
            prog["grad"] = {m: {n: _first_grad(opt_, p) for n, p in named(mod).items()}
                            for m, mod, opt_ in (("D", ts.D, ts.opt_D), ("G", ts.G, ts.opt_G))}
        if k == n_cmp - 1:
            p0 = st.pop("p0")
            prog["change"] = {m: {n: float(torch.linalg.norm((p.detach() - p0[m][n]).float()))
                                  for n, p in named(mod).items()}
                              for m, mod in (("D", ts.D), ("G", ts.G))}
            prog["change"]["EMA"] = {n: float(torch.linalg.norm((e_ - p0["G"][n]).float()))
                                     for n, e_ in ts.ema["params"].items()}
            del p0
        if st["phase"] == "A":
            rec.requests.append((s, e, data["images"].shape[0]))
            per_pair.append(work["pair_r1" if phase["do_r1"] and meta["r1_lambda"] > 0
                                 else "pair"]["flops"])
            if e - rec.window_start >= seconds:
                end_window()
        elif st["phase"] == "B" and time.perf_counter() - st["tB"] >= host_s:
            rec.spans = st["prof"].stop(time.perf_counter() - st["tB"])
            stages.ranges_on, st["phase"] = False, "toA"
        return ts, stats

    def start_window():
        if on_card:
            torch.cuda.synchronize()
            rec.peak_bytes = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        gc.collect()
        if traced:
            stages.events_on = True
            st["prof"] = Profiled(host=False)
        st["phase"] = "A"
        rec.window_start = time.perf_counter()
        rec.setup_s = rec.window_start - t_start

    def end_window():
        if on_card:
            torch.cuda.synchronize()
        rec.window_end = time.perf_counter()
        if on_card:
            rec.window_peak_bytes = torch.cuda.max_memory_allocated()
            rec.peak_bytes = max(rec.peak_bytes, rec.window_peak_bytes)
        if traced:
            rec.trace = st["prof"].stop(rec.window_end - rec.window_start)
            rec.stage_ms = stages.ms()
            stages.events_on = False
        raise StopRun

    phase_trainer.train_step_pair, phase_trainer.generator_forward = pair, forward
    try:
        trainer.run()
        raise RuntimeError("the Trainer ended before the window did")
    except StopRun:
        pass
    finally:
        phase_trainer.train_step_pair, phase_trainer.generator_forward = real_pair, real_forward
        stages.ranges_on = False
    rec.work = dict(work, model={"flops": statistics.fmean(per_pair), "bytes": 0.0})
    prog["losses"] = [[float(x) for x in pl] for pl in prog["losses"]]
    del trainer, ts
    gc.collect()
    shutil.rmtree(out_dir, ignore_errors=True)
    if on_card:
        torch.cuda.empty_cache()
    readings = reference_readings(cell, seed, device)
    rec.checks = compare(prog, readings, sorted(cell.limits))
    rec.notes = details(prog, readings)
    rec.failed = sum(not np.isfinite(x) for pl in prog["losses"] for x in pl)
    return rec


def _first_grad(opt, p) -> float:
    """The norm of the gradient Adam took at its first step (its first
    moment at beta1 0); 0 where it holds no state."""
    import torch

    state = opt.state.get(p)
    if not state or "exp_avg" not in state:
        return 0.0
    b1 = opt.param_groups[0]["betas"][0]
    return float(torch.linalg.norm(state["exp_avg"].float())) / (1.0 - b1)


def reference_readings(cell, seed: int, device, products=None, half: bool = False) -> Dict:
    """``reference.training.follow`` of the cell's first ``compare`` pairs
    from ``seed``, with the same weights, batches and draws."""
    import torch

    from perfbench.reference import smpl as ref_smpl
    from perfbench.reference import training as ref
    from perfbench.reference.precision import Products, tf32_off

    tf32_off()
    meta = step_meta(cell.config)
    tr = cell.traffic
    n_cmp, B = int(tr["compare"]), int(meta["batch_size"])
    arrays = ref_smpl.synthetic_smpl_arrays(num_verts=tr["smpl_vertices"],
                                            num_faces=tr["smpl_faces"])
    labels = ref.face_labels(len(arrays["faces"]), os.path.dirname(HERE))
    wgen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    g_state, d_state = ref.weights(meta, wgen, device)
    phases = meta["phases"]
    draws = [pair_draws(meta, phases[k % len(phases)], seed, k, B, device) for k in range(n_cmp)]
    batches = lambda k: ref.synthetic_batch(ref.batch_indices(meta["dataset_length"], B, k),
                                            arrays, meta, device)
    lrs = [curriculum(cell.config, meta, k) for k in range(n_cmp)]
    out = ref.follow(meta, phases, g_state, d_state, arrays, labels, batches, draws, lrs, n_cmp,
                     products or Products(), half)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def _median(d: Dict[str, float], keep) -> float:
    vals = [v for k, v in d.items() if keep(k)]
    return statistics.median(vals) if vals else 0.0


def leaf_gaps(prog: Dict, ref: Dict, what: str) -> Dict[str, Dict[str, float]]:
    """By module, each leaf's gap between the program's norm and the
    reference's over the larger of the reference's norm of that leaf and of
    the module's median leaf (inf where the program's reading is missing or
    not finite).  For the changes (``what`` 'change': D, G and the EMA) the
    leaves whose reference gradient is under ``RULE`` of the median leaf's
    are left out: they move by round-off alone."""
    out = {}
    for m in (("D", "G") if what == "grad" else ("D", "G", "EMA")):
        g = ref["grad"]["G" if m == "EMA" else m]
        gmed = _median(g, lambda _: True)
        keep = (lambda k: True) if what == "grad" else (lambda k: g[k] >= RULE * gmed)
        r, p = ref[what][m], prog[what].get(m, {})
        med = _median(r, keep)
        gaps = {}
        for k, rv in r.items():
            if keep(k):
                gap = abs(p.get(k, float("nan")) - rv) / max(rv, med, 1e-30)
                gaps[k] = gap if np.isfinite(gap) else float("inf")
        out[m] = gaps
    return out


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number the comparison can judge.  ``loss_gap``: the largest
    relative gap of a step's loss (either step of each compared pair);
    ``loss1_gap``: that of the first pair alone, from the same weights on
    both sides.  ``grad_gap`` / ``grad_median_gap``: the worst and the
    median leaf's gap of the first gradient (``leaf_gaps``), over D's and
    G's leaves.  ``change_gap`` / ``change_median_gap``: the same of the
    change after the compared pairs.  The cell's limits name the ones
    judged."""
    rel = lambda p, r: abs(p - r) / max(abs(r), 1e-30) if np.isfinite(p) else float("inf")
    gaps = [[rel(p, r) for p, r in zip(pl, rl)] for pl, rl in zip(prog["losses"], ref["losses"])]
    missing = len(prog["losses"]) != len(ref["losses"])
    out = {"loss_gap": float("inf") if missing else max(max(g) for g in gaps),
           "loss1_gap": max(gaps[0]) if gaps else float("inf")}
    for what in ("grad", "change"):
        every = [v for m in leaf_gaps(prog, ref, what).values() for v in m.values()]
        out[f"{what}_gap"] = max(every)
        out[f"{what}_median_gap"] = statistics.median(every)
    return out


def details(prog: Dict, ref: Dict) -> Dict:
    """For the look: every number, each step's loss gaps, and the three
    worst leaves of each module's gradient and change."""
    out = {"numbers": numbers(prog, ref), "losses": [prog["losses"], ref["losses"]]}
    for what in ("grad", "change"):
        for m, g in leaf_gaps(prog, ref, what).items():
            worst = sorted(g.items(), key=lambda kv: -kv[1])[:3]
            out[f"{what}.{m}"] = [[k, v, prog[what].get(m, {}).get(k), ref[what][m][k]]
                                  for k, v in worst]
    return out


def compare(prog: Dict, ref: Dict, names) -> Dict[str, float]:
    """The judged numbers (``numbers``) named in ``names``: the cell's limits'."""
    every = numbers(prog, ref)
    return {k: every[k] for k in names}


def control(cell, seed: int, device, dtype) -> Dict:
    """The control's readings: the reference with every product's operands
    in ``dtype`` (per-tensor scaled; the backward's too) put in the
    program's place, against the float32 reference."""
    from perfbench.reference.precision import Products

    low = reference_readings(cell, seed, device, Products(dtype, scaled=True, grads=True))
    return details(low, reference_readings(cell, seed, device))


def half_batch(cell, seed: int, device) -> Dict:
    """The half-batch fault read with the reference put in the program's
    place: every step on the first half of its batch, against the whole."""
    return details(reference_readings(cell, seed, device, half=True),
                   reference_readings(cell, seed, device))
