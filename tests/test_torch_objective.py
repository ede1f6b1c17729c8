"""The JAX package's whole training objective in the port, on the CPU in
float32 at MAP3DBN_NANO against the JAX jitted steps (``_d_step_jit``,
``_g_step_jit``): ADA on D's inputs (every group on, p = 0.6, gan_lambda 1)
with dual discrimination and a conditional phase with the perceptual and
photometric terms, in one meta; a render-modal phase at a render size
JAX's discriminator accepts; and batch_split 2 with ADA (one augmentation
for both micro-batches).  Draws come from the JAX keys (``jax_draws``
replays ``augment_pipe``'s).  Plus: D's dual and render-modal inputs, the
shipped render sizes refused on both sides, the ADA controller against
JAX's ``update_augment``, ``ada_p`` through save and resume, and two gloo
ranks with different local signs that end with one p."""

import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_augment import jax_draws
from threedhumangan_tpu import configs as jconfigs
from threedhumangan_tpu.data import augment as jaug
from threedhumangan_tpu.data import preprocessor as jpre
from threedhumangan_tpu.models import discriminator as jdisc
from threedhumangan_tpu.models import smpl as jsmpl
from threedhumangan_tpu.parallel.stats import Collector as JCollector
from threedhumangan_tpu.trainers import base_trainer as jbt
from threedhumangan_tpu.trainers import phase_trainer as jpt
from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.data import augment as aug
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models.discriminator import UNetDiscriminator
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.parallel.stats import moments
from threedhumangan_tpu_torch.trainers import base_trainer
from threedhumangan_tpu_torch.trainers import phase_trainer as pt
from threedhumangan_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from threedhumangan_tpu_torch.utils.weights import (
    discriminator_state,
    from_jax_params,
    train_state_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
T = torch.as_tensor
N = lambda x: np.array(x)
B = 2
LR_D, LR_G, ADA_P = 4e-4, 1e-4, 0.6
# the tolerances of tests/test_torch_train.py's D + G parity
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL, GRAD_NORM_ATOL = 1e-3, 1e-7
U_RTOL, U_ATOL = 1e-5, 1e-6
RUNNING_RTOL, RUNNING_ATOL = 1e-4, 1e-6
ADAM_ATOL = 0.01  # of lr, on weights the JAX step moved by >= 0.99 lr

SHIPPED_ADA = configs.extract_metadata(configs.MAP3DBN, 0)["ada_aug"]
# the JAX step reads ada_aug as it is, so it is given AugmentPipe's whole cfg
ALL_GROUPS_ADA = jaug.AugmentPipe(**{**SHIPPED_ADA, **{g: 1 for g in aug.GROUPS}}).cfg


def _nano(**kw):
    meta = dict(jconfigs.extract_metadata(jconfigs.MAP3DBN_NANO, 0))
    meta.update({"nerf_noise": 0, "perturb_rays": False, "fast_math": False, **kw})
    return meta


def _phase(**kw):
    return {"name": "p", "uncond": True, "rotate": False, "gen_modal": "rgbs", "do_r1": True,
            **kw}


CASES = {
    "ada_dual_conditional": (
        dict(ada_interval=4, gan_lambda=1, dual_discrimination=True, ada_aug=ALL_GROUPS_ADA,
             perceptual_lambda=[1, 1, 1, 1], photometric_lambda=1),
        _phase(uncond=False)),
    # render 16 x 8 = NANO's image size: the size its discriminator accepts
    "render_modal": (dict(render_height=16, render_width=8), _phase(gen_modal="rgbs_render")),
    "split2_ada": (
        dict(batch_split=2, ada_interval=4, gan_lambda=1,
             ada_aug=jaug.AugmentPipe(**SHIPPED_ADA).cfg),
        _phase()),
}


def _setup(meta):
    smpl = synthetic_smpl_model(num_verts=96, num_faces=160)
    batch = next(ds.iterate_batches(ds.SyntheticSHHQDataset(smpl_model=smpl, **meta), B,
                                    shuffle=False))
    jp = jpre.get_preprocessor(meta, smpl_model=jsmpl.synthetic_smpl_model(num_verts=96,
                                                                            num_faces=160))
    return batch, jp, get_preprocessor(meta, smpl)


def _draws(key, n_keys, meta, shapes):
    """The step's draws from its JAX key: z (key 1), coin (key 3), no camera
    jitter, and each augmentation (``shapes``: draw name -> (key, shape))."""
    keys = jax.random.split(key, n_keys)
    out = {"z": T(N(jax.random.normal(keys[1], (B, meta["latent_dim"])))),
           "coin": T(N(jax.random.uniform(keys[3], ()))),
           "h_rotation": torch.zeros(B), "v_rotation": torch.zeros(B)}
    if meta.get("ada_interval", 0):
        out.update({name: jax_draws(keys[i], meta["ada_aug"], shape)
                    for name, (i, shape) in shapes.items()})
    return out


def _jax_step(fn, jts, jdata, key, lr, meta, phase, jp):
    return fn(jts, jdata, key, jnp.float32(lr), jnp.float32(0.0), jnp.float32(ADA_P),
              jnp.asarray(phase["rotate"]), jnp.asarray(phase["do_r1"]), jp,
              jpt.register_meta(meta), phase["uncond"], phase["gen_modal"])


def _terms(stats):
    return sorted(k for k in stats if "_norm/" not in k)


def _close(got, want, what, rtol=LOSS_RTOL, atol=0.0):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, atol=atol, err_msg=what)


def _grad_norms_close(stats, jstats, prefix):
    keys = [k for k in jstats if k.startswith(prefix)]
    assert keys
    for k in keys:
        _close(stats[k][1], N(jstats[k])[1], k, GRAD_NORM_RTOL, GRAD_NORM_ATOL)


def _adam_held(name, new, old, want_new, lr):
    """Weights the JAX step moved by >= 0.99 lr, held to ADAM_ATOL of lr
    (tests/test_torch_train.py::_adam_delta_close); returns (held, total)."""
    got, want = new - old, want_new - old
    big = np.abs(want) >= 0.99 * lr
    np.testing.assert_allclose(got[big], want[big], rtol=0, atol=ADAM_ATOL * lr, err_msg=name)
    return int(big.sum()), big.size


@pytest.mark.heavy
@pytest.mark.parametrize("case", list(CASES))
def test_objective_d_and_g_step_match_jax(case):
    kw, phase = CASES[case]
    meta = _nano(**kw)
    port_meta = dict(meta, pallas_synthesis_train=False, remat_synthesis=False)
    jts = jpt.init_train_state(jax.random.PRNGKey(0), meta)
    pool = jnp.asarray(np.random.RandomState(4).randn(meta["dataset_length"],
                                                       meta["latent_dim"]), jnp.float32)
    jts = jts._replace(params_G={**jts.params_G, "latent_pool": pool},
                       ema={**jts.ema, "params": {**jts.ema["params"], "latent_pool": pool}})
    batch, jp, pre = _setup(meta)
    ts = train_state_from_jax(jts, port_meta, "cpu")
    data = ds.to_tensors(batch, "cpu")
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    gh, gw = meta["gen_height"], meta["gen_width"]
    cf = 6 if meta.get("dual_discrimination") else 3
    n_split = meta.get("batch_split", 1)

    # ---- D step
    kd, kg = jax.random.PRNGKey(10), jax.random.PRNGKey(11)
    old_D = {k: v.clone().numpy() for k, v in ts.D.state_dict().items()}
    old_state = {k: v.clone() for k, v in ts.G.state_dict().items() if "running" in k}
    d_draws = _draws(kd, 7, meta, {"aug_real": (5, (B, gh, gw, 3)),
                                   "aug_fake": (6, (B, gh, gw, cf))})
    ts, stats = pt.d_train_step(ts, data, torch.Generator().manual_seed(0), LR_D, 0.0, pre,
                                port_meta, phase, draws=d_draws, ada_p=ADA_P)
    jts, jstats = _jax_step(jpt._d_step_jit, jts, jdata, kd, LR_D, meta, phase, jp)
    assert _terms(stats) == _terms(jstats)
    _close(stats["d_loss"][1], N(jstats["d_loss"])[1], "d_loss")
    _close(stats["r1"][1], N(jstats["r1"])[1], "r1", atol=1e-6)
    if meta["gan_lambda"]:
        np.testing.assert_array_equal(stats["real_signs"].numpy(), N(jstats["real_signs"]))
    _grad_norms_close(stats, jstats, "d_grad_norm/")
    want_D = discriminator_state(jts.params_D, jts.state_D)
    held = []
    for k, v in ts.D.state_dict().items():
        if k.endswith("weight_u"):
            np.testing.assert_allclose(v.numpy(), want_D[k].numpy(), rtol=U_RTOL, atol=U_ATOL)
        else:
            held.append(_adam_held(k, v.numpy(), old_D[k], want_D[k].numpy(), LR_D))
    assert sum(h for h, _ in held) > 0.5 * sum(n for _, n in held)
    want_G = from_jax_params(jts.params_G, jts.state_G)
    for k, v in ts.G.state_dict().items():
        if "running" in k or "num_batches" in k:
            np.testing.assert_allclose(v.numpy(), want_G[k].numpy(), rtol=RUNNING_RTOL,
                                       atol=RUNNING_ATOL, err_msg=k)
        if phase["gen_modal"] != "rgbs" and k in old_state:  # no synthesis ran
            assert torch.equal(v, old_state[k]), k

    # ---- G step
    old_G = {k: v.detach().clone().numpy() for k, v in ts.G.named_parameters()}
    g_draws = _draws(kg, 6, meta, {"aug": (5, (B // n_split, gh, gw, cf))})
    ts, stats = pt.g_train_step(ts, data, torch.Generator().manual_seed(1), LR_G, 0.0, pre,
                                port_meta, phase, draws=g_draws, ada_p=ADA_P)
    jts, jstats = _jax_step(jpt._g_step_jit, jts, jdata, kg, LR_G, meta, phase, jp)
    assert _terms(stats) == _terms(jstats)
    for k in ("g_loss", "g_segmentation_loss", "perceptual_loss", "photometric_loss"):
        if k in jstats:
            _close(stats[k][1], N(jstats[k])[1], k)
            assert stats[k][0] == N(jstats[k])[0] == n_split  # a moment a micro-batch
    _grad_norms_close(stats, jstats, "g_grad_norm/")
    assert float(stats["g_grad_norm/neural_field"][1]) > 0
    want_G = from_jax_params(jts.params_G, jts.state_G)
    # each weight against its own group's lr (the field and its mapping at 0.05)
    lr_mul = {id(p): g["lr_mul"] for g in ts.opt_G.param_groups for p in g["params"]}
    held = [_adam_held(k, v.detach().numpy(), old_G[k], want_G[k].numpy(), LR_G * lr_mul[id(v)])
            for k, v in ts.G.named_parameters()]
    # render-modal: only the field and its mapping get gradients
    frac = 0.05 if phase["gen_modal"] != "rgbs" else 0.4
    assert sum(h for h, _ in held) > frac * sum(n for _, n in held)
    if not phase["uncond"]:  # the conditional phase's latents moved
        assert float(stats["g_grad_norm/latent_pool"][1]) > 0
    assert ts.step == int(jts.step) == 1


def test_disc_inputs_match_jax():
    """Dual discrimination (the antialiased downsample of the reals) and the
    render-modal inputs against the JAX step's own functions."""
    rs = np.random.RandomState(0)
    for gh, gw, rh, rw in ((16, 8, 8, 4), (64, 32, 16, 8), (512, 256, 96, 48)):
        meta = {"gen_height": gh, "gen_width": gw, "render_height": rh, "render_width": rw}
        real = rs.uniform(-1, 1, (1, gh, gw, 3)).astype(np.float32)
        gen = {"rgbs": rs.uniform(-1, 1, (1, gh, gw, 3)).astype(np.float32),
               "rgbs_render": rs.uniform(-1, 1, (1, rh, rw, 3)).astype(np.float32)}
        for dual, modal in ((True, "rgbs"), (False, "rgbs_render"), (False, "rgbs")):
            m, ph = dict(meta, dual_discrimination=dual), _phase(gen_modal=modal)
            got = pt._disc_input_real(T(real), ph, m)
            want = jpt._disc_input_real(jnp.asarray(real), ph, m)
            np.testing.assert_allclose(got.numpy(), N(want), rtol=0, atol=1e-5)
            got = pt._disc_input_gen({k: T(v) for k, v in gen.items()}, ph, m)
            want = jpt._disc_input_gen({k: jnp.asarray(v) for k, v in gen.items()}, ph, m)
            np.testing.assert_allclose(got.numpy(), N(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["MAP3DBN_NANO", "MAP3DBN"])
def test_shipped_render_size_fails_on_both_sides(name):
    """A render-modal phase feeds D render-size images: at the shipped render
    sizes neither discriminator takes them (same shapes, same failure)."""
    meta = dict(jconfigs.extract_metadata(getattr(jconfigs, name), 0))
    shape = (1, meta["render_height"], meta["render_width"], 3)
    D = UNetDiscriminator(meta)
    with pytest.raises(RuntimeError):
        D(torch.zeros(shape))
    params, state = jdisc.init_discriminator(jax.random.PRNGKey(0), meta)
    with pytest.raises((TypeError, ValueError)):
        jdisc.discriminator_forward(params, state, jnp.zeros(shape))


@pytest.mark.parametrize("signs,p0", [(np.ones(12), 0.0), (-np.ones(12), 0.3),
                                      (np.r_[np.ones(7), -np.ones(5)], 0.99),
                                      (np.r_[np.ones(4), -np.ones(2)], 0.5)])
def test_ada_controller_matches_jax(signs, p0):
    """``update_augment`` on given stats, beside the JAX trainer's (a mean of
    1/6 below, at and above the target 0.6; p clipped to [0, 1])."""
    meta = dict(configs.extract_metadata(configs.MAP3DBN, 0), ada_interval=4, ada_kimg=0.1)
    stats = {"real_signs": moments(T(signs.astype(np.float32)))}
    mine = types.SimpleNamespace(ada_p=p0)
    base_trainer.Trainer.update_augment(mine, meta, stats)
    ref = types.SimpleNamespace(ada_p=p0, ada_collector=JCollector("real_signs.*"))
    jbt.Trainer.update_augment(ref, meta, {"real_signs": jnp.asarray(N(stats["real_signs"]))})
    assert mine.ada_p == ref.ada_p
    assert 0.0 <= mine.ada_p <= 1.0
    # without real_signs (gan_lambda 0) p stays, as in the JAX trainer
    base_trainer.Trainer.update_augment(mine, meta, {})
    assert mine.ada_p == ref.ada_p


def _ada_config(batch_size=2):
    config = configs.get_config(types.SimpleNamespace(config="MAP3DBN_NANO", tune="", variant=0))
    # delta = ada_interval * batch / (ada_kimg * 1000) = 0.1; a target under
    # any mean of signs moves p up at every update
    config.update(ada_interval=2, ada_kimg=0.04, ada_target=-2.0, gan_lambda=1)
    return config


def _opt(out, **kw):
    base = dict(output_dir=out, device="cpu", model_save_interval=2, model_keep_interval=2,
                sample_interval=0, n_epochs=10, seed=3, tensorboard=0)
    return types.SimpleNamespace(**{**base, **kw})


def test_ada_p_survives_save_and_resume(tmp_path):
    """p moves at steps 2 and 4; a run stopped at 2 and resumed reaches the
    uninterrupted run's p and weights; a checkpoint without the key loads 0."""
    straight = base_trainer.Trainer(0, 1, _opt(str(tmp_path / "a")), _ada_config())
    straight.run(max_steps=4)
    base_trainer.Trainer(0, 1, _opt(str(tmp_path / "b")), _ada_config()).run(max_steps=2)
    resumed = base_trainer.Trainer(0, 1, _opt(str(tmp_path / "b")), _ada_config())
    assert resumed.step == 2 and resumed.ada_p == pytest.approx(0.1)
    resumed.run(max_steps=4)
    assert straight.ada_p == resumed.ada_p == pytest.approx(0.2)
    for (k, a), b in zip(straight.ts.G.state_dict().items(), resumed.ts.G.state_dict().values()):
        assert torch.equal(a, b), k
    run_dir = tmp_path / "b" / "map3dbn_nano"
    payload = load_checkpoint(str(run_dir / "00000004_checkpoint.npz"))
    assert payload["ada_p"] == resumed.ada_p
    payload.pop("ada_p")
    save_checkpoint(str(run_dir), 6, {k: v for k, v in payload.items() if k != "step"})
    assert base_trainer.Trainer(0, 1, _opt(str(tmp_path / "b")), _ada_config()).ada_p == 0.0


def test_two_ranks_end_with_one_p(tmp_path):
    """Two gloo ranks whose own signs lie on either side of the target: the
    update sums them over ranks first, in one collective, so both hold the
    p of the summed signs, which rank 0's signs alone would not give."""
    meta = dict(configs.extract_metadata(configs.MAP3DBN, 0), ada_interval=4, ada_kimg=0.1)
    signs = [np.ones(6, np.float32), -np.ones(6, np.float32)]
    spec = {"meta": meta, "signs": signs, "p0": 0.5}
    torch.save(spec, tmp_path / "ada.spec.pt")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, "ada", str(tmp_path / "ada.spec.pt"),
                               str(tmp_path / f"ada.{r}.out.pt"), str(r), "2",
                               str(tmp_path / "ada.init")], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in stdout, stderr[-3000:]
    got = [torch.load(tmp_path / f"ada.{r}.out.pt") for r in range(2)]
    summed = types.SimpleNamespace(ada_p=0.5)
    base_trainer.Trainer.update_augment(
        summed, meta, {"real_signs": moments(T(np.concatenate(signs)))})
    alone = types.SimpleNamespace(ada_p=0.5)
    base_trainer.Trainer.update_augment(alone, meta, {"real_signs": moments(T(signs[0]))})
    assert got[0]["ada_p"] == got[1]["ada_p"] == summed.ada_p != alone.ada_p
    assert got[0]["collectives"] == got[1]["collectives"] == 1
