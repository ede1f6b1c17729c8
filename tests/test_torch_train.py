"""The PyTorch port's training path (threedhumangan_tpu_torch/trainers,
models/discriminator.py, train-mode synthesis, utils/ema.py) on the CPU in
float32 against the JAX package at NANO/TINY sizes: the discriminator and
its spectral-norm state, the losses (R1 with an absolute tolerance), the
train-mode synthesis and its state, Adam with clipping and lr groups, the
EMA, and one D + G step from the same weights and draws.  Plus: a NANO
D + G step of the port never imports JAX, and launches no kernel on the
CPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu import configs
from threedhumangan_tpu.data import preprocessor as jpre
from threedhumangan_tpu.models import discriminator as jdisc
from threedhumangan_tpu.models import smpl as jsmpl
from threedhumangan_tpu.models import synthesis as jsyn
from threedhumangan_tpu.trainers import losses as JL
from threedhumangan_tpu.trainers import optim as jopt
from threedhumangan_tpu.trainers import phase_trainer as jpt
from threedhumangan_tpu.utils import ema as jema
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models import synthesis as syn
from threedhumangan_tpu_torch.models.discriminator import UNetDiscriminator
from threedhumangan_tpu_torch.models.generator import Map3DGenerator
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.ops import geo, rasterize, raymarch, raymarch_bwd
from threedhumangan_tpu_torch.trainers import losses as L
from threedhumangan_tpu_torch.trainers import optim
from threedhumangan_tpu_torch.trainers import phase_trainer as pt
from threedhumangan_tpu_torch.utils import ema
from threedhumangan_tpu_torch.utils.weights import (
    discriminator_state,
    from_jax_params,
    synthesis_network_state,
    train_state_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.as_tensor
N = lambda x: np.array(x)


def _nano(**kw):
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
    meta.update({"nerf_noise": 0, "perturb_rays": False, "fast_math": False, **kw})
    return meta


@pytest.fixture(scope="module")
def jax_state():
    """One JAX NANO TrainState for the tests of this file."""
    return jpt.init_train_state(jax.random.PRNGKey(0), _nano())


# ---------------------------------------------------------------------------
# discriminator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gen_size,train", [((16, 8), True), ((16, 8), False), ((16, 16), True)])
def test_discriminator_forward_and_spectral_state_match_jax(gen_size, train, jax_state):
    meta = _nano(gen_height=gen_size[0], gen_width=gen_size[1])
    if gen_size == (16, 8):
        params, state = jax_state.params_D, jax_state.state_D
    else:
        params, state = jdisc.init_discriminator(jax.random.PRNGKey(0), meta)
    D = UNetDiscriminator(meta)
    D.load_state_dict(discriminator_state(params, state))
    img = np.random.RandomState(0).uniform(-1, 1, (2,) + gen_size + (3,)).astype(np.float32)
    got = D(T(img), train=train)
    ref, ref_state = jdisc.discriminator_forward(params, state, jnp.asarray(img), train=train)
    assert got["segments"].shape == (2,) + gen_size + (meta["label_dim"],)
    for k in ("prediction", "segments", "latents"):
        np.testing.assert_allclose(got[k].detach().numpy(), N(ref[k]), rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    if gen_size == (16, 16):
        assert np.abs(N(ref["latents"])).max() > 0  # a 2x2 bottleneck: the latent head runs
    new_u = discriminator_state(params, ref_state)
    for k, v in D.state_dict().items():
        if k.endswith("weight_u"):
            np.testing.assert_allclose(v.numpy(), new_u[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["cross_entropy_balanced", "cross_entropy", "softplus",
                                  "cross_entropy_multiclass"])
def test_segmentation_loss_matches_jax(mode):
    rs = np.random.RandomState(1)
    seg = rs.randn(2, 8, 6, 26).astype(np.float32)
    gt = rs.randint(0, 26, (2, 8, 6)).astype(np.int32)
    prior = rs.uniform(0.5, 2.0, 26).astype(np.float32)
    for pw in (None, prior):
        got = L.segmentation_loss(T(seg), T(gt), 26, mode, pw)
        ref = JL.segmentation_loss(jnp.asarray(seg), jnp.asarray(gt), 26, mode, pw)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), N(b), rtol=1e-5, atol=1e-6)
    # no foreground: plain CE; a label map at another size: nearest resize
    zero = np.zeros((2, 4, 3), np.int32)
    for g in (np.zeros_like(gt), zero):
        got = L.segmentation_loss(T(seg), T(g), 26, mode)[0]
        ref = JL.segmentation_loss(jnp.asarray(seg), jnp.asarray(g), 26, mode)[0]
        np.testing.assert_allclose(got.numpy(), N(ref), rtol=1e-5, atol=1e-6)


def test_gan_losses_and_smooth_l1_match_jax():
    rs = np.random.RandomState(2)
    a, b = (rs.randn(4, 5, 3, 1).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(L.gan_loss_d(T(a), T(b)).numpy(),
                               N(JL.gan_loss_d(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    meta = {"topk_interval": 10, "topk_v": 0.6}
    for step in (0, 30):
        np.testing.assert_allclose(L.gan_loss_g_topk(T(a), step, meta).numpy(),
                                   N(JL.gan_loss_g_topk(jnp.asarray(a), step, meta)), rtol=1e-5)
    np.testing.assert_allclose(L.smooth_l1(T(a), T(b)).numpy(),
                               N(JL.smooth_l1(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


@pytest.mark.parametrize("gan_lambda", [0.0, 1.0])
def test_r1_matches_jax(gan_lambda, jax_state):
    """R1 of sum(softmax(segments)) is analytically 0 (softmax sums to 1 per
    pixel), so both sides are rounding noise: held to an absolute 1e-6.  The
    prediction-head R1 (gan_lambda > 0) is a real penalty: relative 1e-4."""
    meta = _nano()
    params, state = jax_state.params_D, jax_state.state_D
    D = UNetDiscriminator(meta)
    D.load_state_dict(discriminator_state(params, state))
    img = np.random.RandomState(3).uniform(-1, 1, (2, 16, 8, 3)).astype(np.float32)
    got = L.r1_regularization(lambda x: D(x), T(img), 0.25, gan_lambda, 1.0)
    ref = jax.jit(lambda x: JL.r1_regularization(
        lambda y: jdisc.discriminator_forward(params, state, y)[0], x, 0.25, gan_lambda, 1.0))(
        jnp.asarray(img))
    if gan_lambda == 0:
        assert abs(got.item()) < 1e-6 and abs(float(ref)) < 1e-6
    else:
        np.testing.assert_allclose(got.detach().numpy(), N(ref), rtol=1e-4)
    # the penalty is differentiable w.r.t. the discriminator (double backward)
    grads = torch.autograd.grad(got, list(D.parameters()), allow_unused=True)
    assert any(g is not None for g in grads)


# ---------------------------------------------------------------------------
# synthesis train mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["mixed", "isolated"])
def test_train_mode_synthesis_and_state_match_jax(mode):
    nb, mods, C = 3, (0,), 16
    params, state, meta = jsyn.init_synthesis_network(jax.random.PRNGKey(4), C, C, C, nb, mods,
                                                       "batch_norm", mode)
    net = syn.SynthesisNetwork(C, C, C, nb, mods, "batch_norm", mode)
    net.load_state_dict(synthesis_network_state(params, state))
    rs = np.random.RandomState(4)
    x = rs.randn(2, 8, 4, C).astype(np.float32)
    style = rs.randn(2, 8, 4, C).astype(np.float32)
    fixed = rs.randn(2, 1, C).astype(np.float32)
    got = net(T(x), T(style), T(fixed), train=True)
    ref, new_state = jsyn.apply_synthesis_network(params, state, meta, jnp.asarray(x),
                                                  jnp.asarray(style), jnp.asarray(fixed),
                                                  train=True)
    np.testing.assert_allclose(got.detach().numpy(), N(ref["final"]), rtol=1e-4, atol=1e-5)
    want = synthesis_network_state(params, new_state)
    for k, v in net.state_dict().items():
        if "running" in k or "weight_u" in k or "num_batches" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# optimizer and EMA
# ---------------------------------------------------------------------------


def test_adam_with_clip_and_lr_groups_matches_jax(jax_state):
    meta = _nano()
    params, state = jax_state.params_G, jax_state.state_G
    G = Map3DGenerator(meta)
    from_jax_params(params, state, G)
    opt = optim.make_adam(optim.param_groups(G, optim.generator_lr_multipliers(meta)),
                          meta["betas"])
    assert len(opt.param_groups) == 5
    jo = jopt.make_adam(tuple(meta["betas"]))
    jstate = jo.init(params)
    mults = jopt.generator_lr_multipliers(params, meta)
    jstep = jax.jit(lambda st, g, p: jopt.adam_step(jo, st, g, p, jnp.float32(1e-2),
                                                    lr_multipliers=mults, grad_clip=1.0))
    rs = np.random.RandomState(5)
    for step in range(2):
        jgrads = jax.tree.map(lambda p: jnp.asarray(rs.randn(*np.shape(p)), jnp.float32), params)
        sd_grads = from_jax_params(jgrads, state)
        names = {id(p): n for n, p in G.named_parameters()}
        tp = [p for g in opt.param_groups for p in g["params"]]
        optim.adam_step(opt, [sd_grads[names[id(p)]].clone() for p in tp], 1e-2, grad_clip=1.0)
        params, jstate = jstep(jstate, jgrads, params)
        want = from_jax_params(params, state)
        for k, v in G.named_parameters():
            np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} {k}")


def test_ema_matches_jax():
    lin = torch.nn.Linear(4, 3)
    e = ema.ema_init(lin)
    je = jema.ema_init({k: jnp.asarray(v.detach().numpy()) for k, v in lin.named_parameters()})
    for _ in range(3):
        with torch.no_grad():
            for p in lin.parameters():
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(6)))
        ema.ema_update(e, lin)
        je = jema.ema_update(je, {k: jnp.asarray(v.detach().numpy())
                                  for k, v in lin.named_parameters()})
    for k, v in e["params"].items():
        np.testing.assert_allclose(v.numpy(), N(je["params"][k]), rtol=1e-6, atol=1e-7)
    assert e["count"] == int(je["count"]) == 3


# ---------------------------------------------------------------------------
# one D + G step against the JAX step
# ---------------------------------------------------------------------------

PHASE = {"name": "uncond", "uncond": True, "rotate": False, "gen_modal": "rgbs", "do_r1": True}


def _step_setup(meta, jts):
    B = 2
    smpl = synthetic_smpl_model(num_verts=96, num_faces=160)
    batch = next(ds.iterate_batches(ds.SyntheticSHHQDataset(smpl_model=smpl, **meta), B,
                                    shuffle=False))
    jp = jpre.get_preprocessor(meta, smpl_model=jsmpl.synthetic_smpl_model(num_verts=96,
                                                                            num_faces=160))
    return batch, jts, jp, get_preprocessor(meta, smpl)


def _jax_draws(rng, n_keys, B, meta):
    keys = jax.random.split(rng, n_keys)
    return {"z": T(N(jax.random.normal(keys[1], (B, meta["latent_dim"])))),
            "coin": T(N(jax.random.uniform(keys[3], ()))),
            "h_rotation": torch.zeros(B), "v_rotation": torch.zeros(B)}


def _adam_delta_close(name, new, old, want_new, lr):
    """Adam's first step moves a weight by lr * g / (|g| + eps), eps 1e-8.
    Where the JAX step moved it by at least 0.99 lr (|g| >= ~100 eps) the
    step is insensitive to the gradient's last digits: held to 1% of lr.
    A gradient within a few eps of zero is rounding noise on both sides
    (e.g. the bias of a conv that batch norm follows, whose gradient is 0
    analytically), so its step is not held; the gradients themselves are
    held by their group norms.  Returns (held, total) counts."""
    got, want = new - old, want_new - old
    big = np.abs(want) >= 0.99 * lr
    np.testing.assert_allclose(got[big], want[big], rtol=0, atol=0.01 * lr, err_msg=name)
    return int(big.sum()), big.size


def _jax_step(fn, jts, jdata, key, lr, meta):
    """The JAX package's jitted step (its own training entry, phase_trainer.py:465)."""
    return fn(jts, jdata, key, jnp.float32(lr), jnp.float32(0.0), jnp.float32(0.0),
              jnp.asarray(PHASE["rotate"]), jnp.asarray(PHASE["do_r1"]), JAX_PRE[0],
              jpt.register_meta(meta), PHASE["uncond"], PHASE["gen_modal"])


JAX_PRE = []


def _grad_norms_close(stats, jstats, prefix, skip=()):
    """Group norms of the grads before clipping: relative 1e-3."""
    keys = [k for k in jstats if k.startswith(prefix) and k.split("/")[1] not in skip]
    assert keys
    for k in keys:
        np.testing.assert_allclose(stats[k][1].numpy(), N(jstats[k])[1], rtol=1e-3, atol=1e-7,
                                   err_msg=k)


def test_d_and_g_step_match_jax(jax_state):
    _d_and_g_step_vs_jax(jax_state, fused=False)


def test_fused_synthesis_d_and_g_step_match_jax(jax_state):
    """The port's step on the fused half-blocks (``pallas_synthesis_train``,
    the plain K10/K11 on the CPU) against the JAX jitted step on its fused
    half-blocks (Pallas in interpret mode; its D and G steps compile in
    ~10 s each here), at the tolerances of the per-op comparison."""
    _d_and_g_step_vs_jax(jax_state, fused=True)


def _d_and_g_step_vs_jax(jax_state, fused):
    port_meta = _nano(pallas_synthesis_train=fused)
    meta = (_nano(pallas_synthesis_train=True, pallas_interpret=True, remat_synthesis=False)
            if fused else _nano())
    batch, jts, jp, pre = _step_setup(meta, jax_state)
    B = 2
    ts = train_state_from_jax(jts, meta, "cpu")
    data = ds.to_tensors(batch, "cpu")
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    lr_d, lr_g = 4e-4, 1e-4

    JAX_PRE[:] = [jp]
    kd, kg = jax.random.PRNGKey(10), jax.random.PRNGKey(11)
    old_D = {k: v.clone().numpy() for k, v in ts.D.state_dict().items()}
    ts, stats = pt.d_train_step(ts, data, torch.Generator().manual_seed(0), lr_d, 0.0, pre,
                                port_meta, PHASE, draws=_jax_draws(kd, 7, B, meta))
    jts, jstats = _jax_step(jpt._d_step_jit, jts, jdata, kd, lr_d, meta)
    np.testing.assert_allclose(stats["d_loss"][1].numpy(), N(jstats["d_loss"])[1], rtol=1e-4)
    _grad_norms_close(stats, jstats, "d_grad_norm/")
    np.testing.assert_allclose(stats["r1"][1].numpy(), N(jstats["r1"])[1], rtol=0, atol=1e-6)
    want_D = discriminator_state(jts.params_D, jts.state_D)
    held = []
    for k, v in ts.D.state_dict().items():
        if k.endswith("weight_u"):
            np.testing.assert_allclose(v.numpy(), want_D[k].numpy(), rtol=1e-5, atol=1e-6)
        else:
            held.append(_adam_delta_close(k, v.numpy(), old_D[k], want_D[k].numpy(), lr_d))
    assert sum(h for h, _ in held) > 0.5 * sum(n for _, n in held)  # most weights are held
    # the D step's generator forward updated the synthesis BN state
    want_G = from_jax_params(jts.params_G, jts.state_G)
    for k, v in ts.G.state_dict().items():
        if "running" in k or "num_batches" in k:
            np.testing.assert_allclose(v.numpy(), want_G[k].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)

    old_G = {k: v.detach().clone().numpy() for k, v in ts.G.named_parameters()}
    ts, stats = pt.g_train_step(ts, data, torch.Generator().manual_seed(1), lr_g, 0.0, pre,
                                port_meta, PHASE, draws=_jax_draws(kg, 6, B, meta))
    jts, jstats = _jax_step(jpt._g_step_jit, jts, jdata, kg, lr_g, meta)
    np.testing.assert_allclose(stats["g_loss"][1].numpy(), N(jstats["g_loss"])[1], rtol=1e-4)
    _grad_norms_close(stats, jstats, "g_grad_norm/")
    assert float(stats["g_grad_norm/neural_field"][1]) > 0  # the step reached the field
    want_G = from_jax_params(jts.params_G, jts.state_G)
    held = [_adam_delta_close(k, v.detach().numpy(), old_G[k], want_G[k].numpy(), lr_g)
            for k, v in ts.G.named_parameters()]
    # the latent pool and the style-input head get no gradient in this phase
    assert sum(h for h, _ in held) > 0.4 * sum(n for _, n in held)
    # the EMA's first update (warm-up decay 2/11) of the stepped weights;
    # test_ema_matches_jax holds the update itself against the JAX package
    d = min(0.999, 2.0 / 11.0)
    for k, v in ts.G.named_parameters():
        np.testing.assert_allclose(ts.ema["params"][k].numpy(),
                                   old_G[k] + (1 - d) * (v.detach().numpy() - old_G[k]),
                                   rtol=0, atol=1e-8, err_msg=k)
    assert ts.step == int(jts.step) == 1


_NO_JAX = r"""
import sys
import torch
from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.data.dataset import SyntheticSHHQDataset, iterate_batches, to_tensors
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.trainers.phase_trainer import init_train_state, train_step_pair
meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
g = torch.Generator().manual_seed(0)
smpl = synthetic_smpl_model(num_verts=96, num_faces=160)
batch = to_tensors(next(iterate_batches(SyntheticSHHQDataset(smpl_model=smpl, **meta), 2,
                                        shuffle=False)), "cpu")
ts = init_train_state(meta, g, "cpu")
before = [p.detach().clone() for p in ts.G.parameters()]
ts, stats = train_step_pair(ts, batch, g, meta, get_preprocessor(meta, smpl), meta["phases"][3],
                            1e-4, 4e-4, 0.5)
assert all(bool(torch.isfinite(v).all()) for v in stats.values())
assert any(not torch.equal(a, b) for a, b in zip(before, ts.G.parameters()))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not bad, bad
ref = sorted(m for m in sys.modules if m == "threedhumangan_tpu"
             or m.startswith("threedhumangan_tpu."))
assert not ref, ref
print("NO_JAX_OK")
"""


def test_port_train_step_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


@pytest.mark.parametrize("batch_split", [1, 2])
def test_cpu_train_step_runs_and_launches_no_kernel(batch_split):
    """A rotated phase with noise and ray jitter, whole or in two
    micro-batches: finite losses and grads, and no kernel launch on the CPU."""
    meta = _nano(batch_split=batch_split, nerf_noise=0.5, perturb_rays=True)
    smpl = synthetic_smpl_model(num_verts=96, num_faces=160)
    batch = ds.to_tensors(next(ds.iterate_batches(
        ds.SyntheticSHHQDataset(smpl_model=smpl, **meta), 4, shuffle=False)), "cpu")
    g = torch.Generator().manual_seed(1)
    ts = pt.init_train_state(meta, g, "cpu")
    _, stats = pt.train_step_pair(ts, batch, g, meta, get_preprocessor(meta, smpl),
                                  meta["phases"][1], 1e-4, 4e-4, 0.5)
    assert stats["g_loss"][0] == batch_split  # one loss moment per micro-batch
    assert all(bool(torch.isfinite(v).all()) for v in stats.values())
    counts = (geo.launches, raymarch.launches, raymarch_bwd.launches_stats,
              raymarch_bwd.launches_bwd, raymarch_bwd.launches_wgrad, rasterize.launches)
    assert counts == (0, 0, 0, 0, 0, 0)
