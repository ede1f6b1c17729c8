"""One rank of a test of the port's data parallelism (tests/test_torch_dist.py).

    python tests/_torch_dist_worker.py MODE SPEC OUT RANK WORLD_SIZE INIT_FILE

It imports torch and the port only (the tests' conftest imports JAX, so the
ranks are separate processes started from the test), joins a gloo group of
``WORLD_SIZE`` through ``file://INIT_FILE`` (no port to collide on) unless
WORLD_SIZE is 0 (no group), reads its inputs from ``SPEC`` (``torch.save``)
and writes its results to ``OUT``.  Modes:

  moments  the sync-BN moments of this rank's rows of ``x``, the running
           stats they give, and the gradient of this rank's loss
           ``sum(mean * gm) + sum(var * gv)`` with respect to its rows;
  step     one D step then one G step from the given weights and draws, on
           this rank's rows of the batch;
  remat    a G step with synthesis remat and without it, the moments the
           remat backward recomputed beside those of its forward;
  trainer  ``Trainer.run`` (NANO, synthetic data, the CPU); ``fail_rank``
           runs out of memory in that rank's first G step;
  plain    ``trainer`` without a group, then in a one-rank group;
  cli      ``apps/train.py``'s ``main(spec["argv"])`` under ``torchrun``
           (RANK and WORLD_SIZE from the environment; it joins the group);
  ada      the trainer's ADA controller (``Trainer.update_augment``) on this
           rank's ``real_signs`` (tests/test_torch_objective.py).

Every mode ends by checking that no module of JAX or of the JAX package was
imported and that no kernel was launched, and prints ``WORKER_OK``.
"""

import os
import sys
import types

import torch
import torch.distributed as tdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from threedhumangan_tpu_torch import configs  # noqa: E402
from threedhumangan_tpu_torch.models import synthesis as syn  # noqa: E402
from threedhumangan_tpu_torch.models.discriminator import UNetDiscriminator  # noqa: E402
from threedhumangan_tpu_torch.models.generator import Map3DGenerator  # noqa: E402
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor  # noqa: E402
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model  # noqa: E402
from threedhumangan_tpu_torch.ops import (  # noqa: E402
    geo,
    knn,
    rasterize,
    raymarch,
    raymarch_bwd,
    synthesis_kernel,
    synthesis_train,
)
from threedhumangan_tpu_torch.parallel import dist  # noqa: E402
from threedhumangan_tpu_torch.parallel.stats import moments as stat_moments  # noqa: E402
from threedhumangan_tpu_torch.trainers import base_trainer  # noqa: E402
from threedhumangan_tpu_torch.trainers import phase_trainer as pt  # noqa: E402


def _rows(x, rank, world):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _clone(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


def moments(spec, rank, world):
    x = _rows(spec["x"], rank, world).clone().requires_grad_(True)
    block = syn.SPADEBlock(x.shape[-1], x.shape[-1], 4)
    mean, var = syn.batch_moments(x)
    block.update_running_stats([(mean, var), (mean, var)], x)
    loss = (mean * spec["gm"][rank]).sum() + (var * spec["gv"][rank]).sum()
    (grad,) = torch.autograd.grad(loss, [x])
    norm = block.spade_0.first_norm
    return {"mean": mean.detach(), "var": var.detach(), "grad": grad,
            "running_mean": norm.running_mean.clone(), "running_var": norm.running_var.clone()}


def _state(spec, meta):
    G, D = Map3DGenerator(meta), UNetDiscriminator(meta)
    G.load_state_dict(spec["G"])
    D.load_state_dict(spec["D"])
    opt_G, opt_D = pt.make_optimizers(G, D, meta)
    ema = {"params": _clone(spec["ema"]["params"]), "count": spec["ema"]["count"]}
    return pt.TrainState(G, D, opt_G, opt_D, ema)


def _preprocessor(meta):
    return get_preprocessor(meta, synthetic_smpl_model(num_verts=96, num_faces=160))


def step(spec, rank, world):
    meta = spec["meta"]
    ts = _state(spec, meta)
    data = {k: _rows(v, rank, world) for k, v in spec["data"].items()}
    pre = _preprocessor(meta)
    ts, stats_d = pt.d_train_step(ts, data, torch.Generator().manual_seed(0), spec["lr_d"], 0.0,
                                  pre, meta, spec["phase"], spec["draws"][rank]["d"])
    D_after_d, G_after_d = _clone(ts.D.state_dict()), _clone(ts.G.state_dict())
    ts, stats_g = pt.g_train_step(ts, data, torch.Generator().manual_seed(1), spec["lr_g"], 0.0,
                                  pre, meta, spec["phase"], spec["draws"][rank]["g"])
    return {"stats_d": stats_d, "stats_g": stats_g, "D_after_d": D_after_d,
            "G_after_d": G_after_d, "G": _clone(ts.G.state_dict()),
            "D": _clone(ts.D.state_dict()), "ema": _clone(ts.ema["params"]), "step": ts.step}


def remat(spec, rank, world):
    """Per case (fused or per op): the G step's gradients and G's buffers with
    remat and without it, and, with it, the moments the forward reduced and
    those the backward's recompute reduced again."""
    out = []
    real_mean, real_grads = dist.mean_across_ranks, pt._grads
    for fused in (False, True):
        case = {}
        for on in (False, True):
            meta = dict(spec["meta"], pallas_synthesis_train=fused, remat_synthesis=on)
            ts = _state(spec, meta)
            data = {k: _rows(v, rank, world) for k, v in spec["data"].items()}
            seen = {"forward": [], "backward": []}
            phase = ["forward"]

            def mean(x):
                y = real_mean(x)
                seen[phase[0]].append(y.detach().clone())
                return y

            def grads(loss, params):
                phase[0] = "backward"
                try:
                    return real_grads(loss, params)
                finally:
                    phase[0] = "forward"

            captured = []
            real_adam = pt.adam_step

            def adam(opt, gs, lr, clip):
                if opt is ts.opt_G:
                    captured.append([g.clone() for g in gs])
                return real_adam(opt, gs, lr, clip)

            dist.mean_across_ranks, pt._grads, pt.adam_step = mean, grads, adam
            try:
                before = _clone(dict(ts.G.named_buffers()))
                pt.g_train_step(ts, data, torch.Generator().manual_seed(1), 1e-4, 0.0,
                                _preprocessor(meta), meta, spec["phase"],
                                spec["draws"][rank]["g"])
            finally:
                dist.mean_across_ranks, pt._grads, pt.adam_step = real_mean, real_grads, real_adam
            case[on] = {"grads": captured[0], "before": before,
                        "after": _clone(dict(ts.G.named_buffers())), "seen": seen}
        out.append(case)
    return out


def _opt(spec, out_dir):
    base = dict(output_dir=out_dir, device="cpu", model_save_interval=2, model_keep_interval=2,
                sample_interval=0, n_epochs=10, seed=3, tensorboard=0, bs_factor=1)
    base.update(spec.get("opt", {}))
    return types.SimpleNamespace(**base)


def _trainer_state(trainer):
    ts = trainer.ts
    return {"G": _clone(ts.G.state_dict()), "D": _clone(ts.D.state_dict()),
            "ema": _clone(ts.ema["params"]), "opt_G": ts.opt_G.state_dict(),
            "opt_D": ts.opt_D.state_dict(), "rng": trainer.generator.get_state(),
            "step": trainer.step}


def _run_trainer(spec, rank, world, out_dir):
    config = configs.get_config(types.SimpleNamespace(config="MAP3DBN_NANO", tune="", variant=0))
    config.update(spec.get("config", {}))
    trainer = base_trainer.Trainer(rank, world, _opt(spec, out_dir), config)
    if rank == 0:  # rank 0's samples and histograms: counted, and no collective
        real_image, real_weights = trainer.log_image, trainer.log_weights
        counts = trainer.sample_collectives = []

        def log_image(meta):
            n = dist.collectives
            real_image(meta)
            counts.append(dist.collectives - n)

        def log_weights():
            n = dist.collectives
            real_weights()
            counts.append(dist.collectives - n)

        trainer.log_image, trainer.log_weights = log_image, log_weights
    if spec.get("fail_rank") == rank:
        real_g = pt.g_train_step

        def g_step(*a, **k):
            raise torch.cuda.OutOfMemoryError("injected: out of memory")

        pt.g_train_step = g_step
        try:
            trainer.run(max_steps=spec["max_steps"])
        finally:
            pt.g_train_step = real_g
    else:
        trainer.run(max_steps=spec["max_steps"])
    res = _trainer_state(trainer)
    res["sample_collectives"] = getattr(trainer, "sample_collectives", [])
    return res


def trainer(spec, rank, world):
    return _run_trainer(spec, rank, world, spec["output_dir"])


def plain(spec, rank, world, init_file):
    """The same run without a group, then in a one-rank gloo group."""
    alone = _run_trainer(spec, 0, 1, os.path.join(spec["output_dir"], "alone"))
    alone["collectives"] = dist.collectives
    tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=0, world_size=1)
    grouped = _run_trainer(spec, 0, 1, os.path.join(spec["output_dir"], "group"))
    grouped["collectives"] = dist.collectives - alone["collectives"]
    return {"alone": alone, "group": grouped}


def ada(spec, rank, world):
    """p after one controller update from ``p0`` on this rank's signs, and
    the collectives it issued."""
    state = types.SimpleNamespace(ada_p=spec["p0"])
    before = dist.collectives
    signs = torch.as_tensor(spec["signs"][rank])
    base_trainer.Trainer.update_augment(state, spec["meta"], {"real_signs": stat_moments(signs)})
    return {"ada_p": state.ada_p, "collectives": dist.collectives - before}


def _check_clean():
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "threedhumangan_tpu" or m.startswith("threedhumangan_tpu."))
    assert not bad, bad
    counts = (geo.launches, geo.launches_clusters, knn.launches, rasterize.launches,
              raymarch.launches, raymarch.launches_unfolded, raymarch.launches_geo,
              raymarch_bwd.launches_stats, raymarch_bwd.launches_bwd,
              raymarch_bwd.launches_wgrad, synthesis_kernel.launches,
              synthesis_train.launches_fwd, synthesis_train.launches_bwd,
              synthesis_train.launches_wgrad)
    assert not any(counts), counts


def main():
    mode, spec_path, out_path, rank, world, init_file = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    if mode == "plain":
        result = plain(spec, rank, world, init_file)
    elif mode == "cli":
        from threedhumangan_tpu_torch.apps import train

        rank = int(os.environ["RANK"])
        out_path = f"{out_path}.{rank}"
        result = _trainer_state(train.main(spec["argv"]))
    else:
        if world > 0:
            tdist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                     world_size=world)
        result = {"moments": moments, "step": step, "remat": remat,
                  "trainer": trainer, "ada": ada}[mode](spec, rank, max(world, 1))
    _check_clean()
    torch.save(result, out_path)
    if tdist.is_initialized():
        tdist.destroy_process_group()
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    main()
