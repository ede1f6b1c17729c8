"""The PyTorch port's data parallelism (threedhumangan_tpu_torch/parallel/
dist.py and its uses in models/synthesis.py, trainers/, data/dataset.py and
apps/train.py) on the CPU, over gloo, against the JAX package's mesh step on
this process's virtual CPU devices.

The ranks run in processes of their own (tests/_torch_dist_worker.py, torch
and the port only), which join a gloo group through a file in the test's
temporary directory, so no port is shared between parallel test workers;
every wait on them has a time limit.  Held here:
  * the two-rank sync-BN moments, running stats and gradients against
    ``sync_bn_moments`` under ``shard_map`` on a two-device mesh;
  * the two-rank D + G step (per op and on the fused half-blocks, batch_split
    1 and 2) against the JAX package's two-replica step, at this file's own
    tolerances, which are those of the one-process parity test
    (test_torch_train.py) and stand on their own;
  * synthesis remat at two ranks: the recompute reduces the forward's
    moments again, bit for bit, and changes no state;
  * the Trainer at two ranks: replicas bit-equal after 3 steps, resume
    bit-equal, rank 0's samples make no collective, and an out-of-memory
    error on one rank ends both without a hang;
  * a Trainer in a one-rank group is bit-equal to one without a group;
  * the rank-sharded loader yields the JAX package's indices;
  * ``torchrun`` of the CLI on two CPU ranks;
  * no rank imports JAX or launches a kernel (every worker checks).
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from threedhumangan_tpu import configs
from threedhumangan_tpu.data import dataset as jds
from threedhumangan_tpu.data import preprocessor as jpre
from threedhumangan_tpu.models import smpl as jsmpl
from threedhumangan_tpu.models import synthesis as jsyn
from threedhumangan_tpu.parallel.mesh import create_mesh
from threedhumangan_tpu.trainers import phase_trainer as jpt
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.utils.weights import (
    discriminator_state,
    from_jax_params,
    train_state_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
T = torch.as_tensor
N = lambda x: np.array(x)

# this file's tolerances (those of the one-process D + G parity)
MOMENTS_RTOL, MOMENTS_ATOL = 1e-5, 1e-6   # sync-BN moments, running stats, their gradients
LOSS_RTOL = 1e-4                          # the summed loss moments
GRAD_NORM_RTOL, GRAD_NORM_ATOL = 1e-3, 1e-7
R1_ATOL = 1e-6
U_RTOL, U_ATOL = 1e-5, 1e-6               # spectral-norm u after the D step
RUNNING_RTOL, RUNNING_ATOL = 1e-4, 1e-6   # BN running stats after the D step
ADAM_ATOL = 0.01                          # of lr, on weights Adam moved by >= 0.99 lr
EMA_ATOL = 1e-8
REMAT_REL_L2 = 1e-6                       # G gradients with remat vs without
WORKER_TIMEOUT = 300                      # seconds a group of workers may take

PHASE = {"name": "uncond", "uncond": True, "rotate": False, "gen_modal": "rgbs", "do_r1": True}


def _launch(tmp_path, mode, spec, world, name=None, expect_ok=True):
    """Run ``world`` ranks of the worker (one process without a group when
    ``world`` is 0); returns [(returncode, stdout, stderr, result or None)]."""
    name = name or mode
    spec_path = str(tmp_path / f"{name}.spec.pt")
    torch.save(spec, spec_path)
    init = str(tmp_path / f"{name}.init")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["OMP_NUM_THREADS"] = "1"
    outs = [str(tmp_path / f"{name}.{r}.out.pt") for r in range(max(world, 1))]
    procs = [subprocess.Popen([sys.executable, WORKER, mode, spec_path, out, str(r), str(world),
                               init], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r, out in enumerate(outs)]
    got = []
    try:
        for p, out in zip(procs, outs):
            stdout, stderr = p.communicate(timeout=WORKER_TIMEOUT)
            ok = p.returncode == 0 and "WORKER_OK" in stdout
            got.append((p.returncode, stdout, stderr,
                        torch.load(out, weights_only=False) if ok else None))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if expect_ok:
        for r, (rc, stdout, stderr, _) in enumerate(got):
            assert rc == 0 and "WORKER_OK" in stdout, (r, rc, stdout[-2000:], stderr[-4000:])
    return got


def _assert_equal_dicts(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), f"{what}: {k}"
        elif isinstance(a[k], dict):
            _assert_equal_dicts(a[k], b[k], f"{what}/{k}")
        else:
            assert a[k] == b[k], f"{what}: {k}"


# ---------------------------------------------------------------------------
# sync-BN moments
# ---------------------------------------------------------------------------


def test_sync_bn_moments_match_jax_two_replicas(tmp_path):
    """The moments of an NHWC input split by rows over two gloo ranks against
    ``sync_bn_moments`` under ``shard_map`` on a two-device mesh: the mean,
    the var, the running stats (unbiased by the global count) and the
    gradient of each rank's own loss with respect to its rows (the
    all-reduce's backward against the transpose of JAX's ``pmean``)."""
    rs = np.random.RandomState(0)
    x = (rs.randn(4, 3, 5, 6) * 2 + 1).astype(np.float32)
    gm, gv = rs.randn(2, 6).astype(np.float32), rs.randn(2, 6).astype(np.float32)
    _, state = jsyn.init_sync_batch_norm(6)

    def body(x, gm, gv):
        def loss(x):
            mean, var, st = jsyn.sync_bn_moments(state, x, "data")
            return jnp.sum(mean * gm[0]) + jnp.sum(var * gv[0]), (mean, var, st)

        (_, (mean, var, st)), g = jax.value_and_grad(loss, has_aux=True)(x)
        return mean, var, st["mean"], st["var"], g

    fn = jax.jit(shard_map(body, mesh=create_mesh(n_data=2), in_specs=(P("data"),) * 3,
                           out_specs=(P(), P(), P(), P(), P("data")), check_rep=False))
    mean, var, rmean, rvar, grad = (N(v) for v in fn(x, gm, gv))

    ranks = [r[3] for r in _launch(tmp_path, "moments",
                                   {"x": T(x), "gm": T(gm), "gv": T(gv)}, 2)]
    for r, got in enumerate(ranks):
        tol = dict(rtol=MOMENTS_RTOL, atol=MOMENTS_ATOL)
        np.testing.assert_allclose(got["mean"].numpy(), mean, **tol)
        np.testing.assert_allclose(got["var"].numpy(), var, **tol)
        np.testing.assert_allclose(got["running_mean"].numpy(), rmean, **tol)
        np.testing.assert_allclose(got["running_var"].numpy(), rvar, **tol)
        np.testing.assert_allclose(got["grad"].numpy(), grad[2 * r:2 * r + 2], **tol)
    for k in ("mean", "var", "running_mean", "running_var"):
        assert torch.equal(ranks[0][k], ranks[1][k]), k  # every rank holds the same
    # a rank's gradient carries the other rank's cotangents: not its own alone
    own = jax.jit(jax.grad(lambda x: jnp.sum(jsyn.sync_bn_moments(state, x)[0] * gm[0])
                           + jnp.sum(jsyn.sync_bn_moments(state, x)[1] * gv[0])))(x[:2])
    assert not np.allclose(N(own), grad[:2], rtol=1e-3)


# ---------------------------------------------------------------------------
# the two-rank D + G step against the JAX package's two-replica step
# ---------------------------------------------------------------------------


def _nano(**kw):
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
    meta.update({"nerf_noise": 0, "perturb_rays": False, "fast_math": False, **kw})
    return meta


@pytest.fixture(scope="module")
def jax_state():
    return jpt.init_train_state(jax.random.PRNGKey(0), _nano())


def _batch(meta, B=4):
    smpl = synthetic_smpl_model(num_verts=96, num_faces=160)
    return next(ds.iterate_batches(ds.SyntheticSHHQDataset(smpl_model=smpl, **meta), B,
                                   shuffle=False))


def _jax_pre(meta):
    return jpre.get_preprocessor(meta, smpl_model=jsmpl.synthetic_smpl_model(num_verts=96,
                                                                              num_faces=160))


def _jax_draws(rng, n_keys, B, meta):
    """The draws of the JAX step's key ``rng`` (its split into ``n_keys``)."""
    keys = jax.random.split(rng, n_keys)
    return {"z": T(N(jax.random.normal(keys[1], (B, meta["latent_dim"])))),
            "coin": T(N(jax.random.uniform(keys[3], ()))),
            "h_rotation": torch.zeros(B), "v_rotation": torch.zeros(B)}


def _mesh_step(fn, meta, jp, lr):
    """``fn`` (the JAX d/g step) on a two-device mesh with the batch split by
    rows and the key folded with the replica index, as
    ``make_mesh_train_pair`` runs it."""
    def body(ts, data, key):
        key = jax.random.fold_in(key, jax.lax.axis_index("data"))
        return fn(ts, data, key, jnp.float32(lr), jnp.float32(0.0), jp, meta, PHASE,
                  axis_name="data")

    return jax.jit(shard_map(body, mesh=create_mesh(n_data=2), in_specs=(P(), P("data"), P()),
                             out_specs=(P(), P()), check_rep=False))


def _adam_delta_close(name, new, old, want_new, lr):
    """Adam's first step moves a weight by lr * g / (|g| + eps): where the
    JAX step moved it by at least 0.99 lr the step is held to ADAM_ATOL of
    lr; a gradient within a few eps of zero is rounding noise on both sides
    and is held by its group norm instead.  Returns (held, total)."""
    got, want = new - old, want_new - old
    big = np.abs(want) >= 0.99 * lr
    np.testing.assert_allclose(got[big], want[big], rtol=0, atol=ADAM_ATOL * lr, err_msg=name)
    return int(big.sum()), big.size


def _summed(ranks, key, name):
    return sum(r[key][name] for r in ranks)


def _grad_norms_close(ranks, key, jstats, prefix):
    names = [k for k in jstats if k.startswith(prefix)]
    assert names
    for k in names:
        got = _summed(ranks, key, k)
        np.testing.assert_allclose(got[1].numpy(), N(jstats[k])[1], rtol=GRAD_NORM_RTOL,
                                   atol=GRAD_NORM_ATOL, err_msg=k)


@pytest.mark.heavy
@pytest.mark.parametrize("fused,split", [(False, 1), (False, 2), (True, 1), (True, 2)])
def test_two_rank_d_and_g_step_matches_jax_two_replicas(tmp_path, jax_state, fused, split):
    """Global batch 4 (2 a rank), per op and on the fused half-blocks (their
    plain versions here; JAX's in interpret mode), batch_split 1 and 2: each
    rank's draws are the JAX replica's, from ``fold_in(key, rank)``; the
    summed losses and grad norms, D's u and weights, the BN running stats
    after the D step's fakes, G's weights and the EMA against the JAX
    two-replica step; the two ranks' states bit-equal."""
    lr_d, lr_g = 4e-4, 1e-4
    kd, kg = jax.random.PRNGKey(10), jax.random.PRNGKey(11)
    base = _nano()
    batch = _batch(base)
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    ts0 = train_state_from_jax(jax_state, base, "cpu")
    spec = {"G": ts0.G.state_dict(), "D": ts0.D.state_dict(), "ema": ts0.ema,
            "data": ds.to_tensors(batch, "cpu"), "phase": PHASE, "lr_d": lr_d, "lr_g": lr_g,
            "draws": [{"d": _jax_draws(jax.random.fold_in(kd, r), 7, 2, base),
                       "g": _jax_draws(jax.random.fold_in(kg, r), 6, 2, base)}
                      for r in range(2)],
            "meta": _nano(pallas_synthesis_train=fused, remat_synthesis=False,
                          batch_split=split)}
    got = [r[3] for r in _launch(tmp_path, "step", spec, 2)]
    old_D = {k: v.numpy() for k, v in spec["D"].items()}
    old_G = {k: v.detach().numpy() for k, v in ts0.G.named_parameters()}

    meta = _nano(batch_split=split, **({"pallas_synthesis_train": True,
                                        "pallas_interpret": True,
                                        "remat_synthesis": False} if fused else {}))
    jp = _jax_pre(meta)
    jts, jstats = _mesh_step(jpt.d_train_step, meta, jp, lr_d)(jax_state, jdata, kd)
    np.testing.assert_allclose(_summed(got, "stats_d", "d_loss")[1].numpy(),
                               N(jstats["d_loss"])[1], rtol=LOSS_RTOL)
    _grad_norms_close(got, "stats_d", jstats, "d_grad_norm/")
    np.testing.assert_allclose(_summed(got, "stats_d", "r1")[1].numpy(),
                               N(jstats["r1"])[1], rtol=0, atol=R1_ATOL)
    want_D = discriminator_state(jts.params_D, jts.state_D)
    held = []
    for k, v in got[0]["D_after_d"].items():
        if k.endswith("weight_u"):
            np.testing.assert_allclose(v.numpy(), want_D[k].numpy(), rtol=U_RTOL,
                                       atol=U_ATOL, err_msg=k)
        else:
            held.append(_adam_delta_close(k, v.numpy(), old_D[k], want_D[k].numpy(), lr_d))
    assert sum(h for h, _ in held) > 0.5 * sum(n for _, n in held)
    want_G = from_jax_params(jts.params_G, jts.state_G)
    for k, v in got[0]["G_after_d"].items():
        if "running" in k or "num_batches" in k:
            np.testing.assert_allclose(v.numpy(), want_G[k].numpy(), rtol=RUNNING_RTOL,
                                       atol=RUNNING_ATOL, err_msg=k)

    jts, jstats = _mesh_step(jpt.g_train_step, meta, jp, lr_g)(jts, jdata, kg)
    g_loss = _summed(got, "stats_g", "g_loss")
    assert float(g_loss[0]) == float(N(jstats["g_loss"])[0]) == 2 * split
    np.testing.assert_allclose(g_loss[1].numpy(), N(jstats["g_loss"])[1], rtol=LOSS_RTOL)
    _grad_norms_close(got, "stats_g", jstats, "g_grad_norm/")
    want_G = from_jax_params(jts.params_G, jts.state_G)
    held = [_adam_delta_close(k, got[0]["G"][k].numpy(), old_G[k], want_G[k].numpy(), lr_g)
            for k in old_G]
    assert sum(h for h, _ in held) > 0.4 * sum(n for _, n in held)
    d = min(0.999, 2.0 / 11.0)
    for k in old_G:
        np.testing.assert_allclose(got[0]["ema"][k].numpy(),
                                   old_G[k] + (1 - d) * (got[0]["G"][k].numpy() - old_G[k]),
                                   rtol=0, atol=EMA_ATOL, err_msg=k)
    assert got[0]["step"] == got[1]["step"] == int(jts.step) == 1
    for key in ("D_after_d", "G_after_d", "G", "D", "ema"):
        _assert_equal_dicts(got[0][key], got[1][key], key)


# ---------------------------------------------------------------------------
# synthesis remat at two ranks
# ---------------------------------------------------------------------------


def test_two_rank_remat_recomputes_the_forward_moments_and_changes_no_state(tmp_path,
                                                                           jax_state):
    """A two-rank G step with remat and without it, per op and fused: the
    moments the remat backward reduced again are bit-equal to ones its
    forward reduced, the G gradients agree within REMAT_REL_L2, and G's BN
    running stats, counts and u are identical, each advanced once."""
    meta = _nano()
    rs = np.random.RandomState(4)
    draws = [{"g": {"z": T(rs.randn(2, meta["latent_dim"]).astype(np.float32)),
                    "coin": T(np.float32(0.2)), "h_rotation": torch.zeros(2),
                    "v_rotation": torch.zeros(2)}} for _ in range(2)]
    ts0 = train_state_from_jax(jax_state, meta, "cpu")
    spec = {"G": ts0.G.state_dict(), "D": ts0.D.state_dict(), "ema": ts0.ema, "meta": meta,
            "data": ds.to_tensors(_batch(meta), "cpu"), "phase": PHASE, "draws": draws}
    for rank in _launch(tmp_path, "remat", spec, 2):
        for case in rank[3]:
            off, on = case[False], case[True]
            assert not off["seen"]["backward"]
            fwd = {t.numpy().tobytes() for t in on["seen"]["forward"]}
            assert on["seen"]["backward"]
            assert all(t.numpy().tobytes() in fwd for t in on["seen"]["backward"])
            num = sum(torch.sum(torch.square(a - b)) for a, b in zip(off["grads"], on["grads"]))
            den = sum(torch.sum(torch.square(a)) for a in off["grads"])
            assert den > 0 and float(torch.sqrt(num / den)) < REMAT_REL_L2
            keys = [k for k in on["after"] if k.startswith("synthesis_network.network.")]
            assert keys
            for k in keys:
                assert torch.equal(off["after"][k], on["after"][k]), k
                if k.endswith("num_batches_tracked"):
                    assert int(on["after"][k]) == int(on["before"][k]) + 1, k


# ---------------------------------------------------------------------------
# the Trainer across ranks
# ---------------------------------------------------------------------------


def _split_config():
    """NANO at a global batch of 4 (2 a rank), two micro-batches, on the
    fused half-blocks (their plain versions here)."""
    config = configs.get_config(types.SimpleNamespace(config="MAP3DBN_NANO", tune="",
                                                      variant=0))
    return {0: dict(config[0], batch_size=4, batch_split=2), "pallas_synthesis_train": True}


def test_two_rank_trainer_keeps_replicas_bit_equal(tmp_path):
    """3 steps at world size 2: both ranks' weights, buffers (BN running
    stats, u), optimizer states and EMA are bit-equal, their random streams
    differ; rank 0 alone wrote the metrics, and its samples at step 2 made
    no collective."""
    spec = {"max_steps": 3, "output_dir": str(tmp_path / "run"), "config": _split_config(),
            "opt": {"sample_interval": 2}}
    r0, r1 = (r[3] for r in _launch(tmp_path, "trainer", spec, 2))
    for key in ("G", "D", "ema", "opt_G", "opt_D"):
        _assert_equal_dicts(r0[key], r1[key], key)
    assert r0["step"] == r1["step"] == 3
    assert not torch.equal(r0["rng"], r1["rng"])
    assert r0["sample_collectives"] == [0, 0] and r1["sample_collectives"] == []
    run = tmp_path / "run" / "map3dbn_nano"
    with open(run / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1]
    assert (run / "00000002_fixed_ema.png").exists()


def test_two_rank_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    """Two ranks checkpointed at step 2 and resumed to step 4, against two
    ranks run straight to 4: each rank's state and random stream."""
    config = _split_config()
    straight = {"max_steps": 4, "output_dir": str(tmp_path / "b"), "config": config}
    first = {"max_steps": 2, "output_dir": str(tmp_path / "a"), "config": config}
    _launch(tmp_path, "trainer", first, 2, name="first")
    got = _launch(tmp_path, "trainer", dict(first, max_steps=4), 2, name="resumed")
    for r, (_, stdout, _, _) in enumerate(got):
        assert f"rank {r}: resumed from" in stdout and "at step 2" in stdout, stdout
    resumed = [g[3] for g in got]
    ref = [r[3] for r in _launch(tmp_path, "trainer", straight, 2, name="straight")]
    for r in range(2):
        for key in ("G", "D", "ema", "opt_G", "opt_D"):
            _assert_equal_dicts(resumed[r][key], ref[r][key], f"rank {r} {key}")
        assert torch.equal(resumed[r]["rng"], ref[r]["rng"]), r
        assert resumed[r]["step"] == ref[r]["step"] == 4


def test_one_rank_group_is_bit_equal_to_no_group(tmp_path):
    """A Trainer in a one-rank gloo group (collectives issued) against one
    without a group (none issued): the state after 2 steps and the logged
    metrics but the clock's."""
    spec = {"max_steps": 2, "output_dir": str(tmp_path / "p"), "config": _split_config()}
    (_, _, _, got), = _launch(tmp_path, "plain", spec, 1)
    alone, grouped = got["alone"], got["group"]
    assert alone["collectives"] == 0 and grouped["collectives"] > 0
    for key in ("G", "D", "ema", "opt_G", "opt_D"):
        _assert_equal_dicts(alone[key], grouped[key], key)
    assert torch.equal(alone["rng"], grouped["rng"])
    rows = {}
    for name in ("alone", "group"):
        with open(tmp_path / "p" / name / "map3dbn_nano" / "metrics.jsonl") as f:
            rows[name] = [{k: v for k, v in json.loads(line).items() if "per_sec" not in k}
                          for line in f]
    assert rows["alone"] == rows["group"] and rows["alone"]


def test_out_of_memory_on_one_rank_ends_every_rank(tmp_path):
    """Rank 1 runs out of memory in its first G step while rank 0 waits in
    a collective of its G forward: both end with a non-zero code well inside
    the time limit, rank 1 naming itself and --bs_factor."""
    spec = {"max_steps": 3, "output_dir": str(tmp_path / "o"), "fail_rank": 1}
    got = _launch(tmp_path, "trainer", spec, 2, expect_ok=False)
    (rc0, _, err0, _), (rc1, out1, err1, _) = got
    assert rc0 != 0 and rc1 != 0, (rc0, rc1)
    assert "rank 1" in out1 and "--bs_factor" in out1, out1
    assert "bs_factor" in err1, err1[-2000:]


def test_torchrun_trains_two_cpu_ranks(tmp_path):
    """``torchrun --standalone --nproc_per_node=2`` of the CLI (NANO, gloo,
    3 steps): both ranks finish at step 3 with the same weights."""
    out = str(tmp_path / "t")
    spec = {"argv": ["--config", "MAP3DBN_NANO", "--device", "cpu", "--max_steps", "3",
                     "--output_dir", out, "--model_save_interval", "2",
                     "--model_keep_interval", "2", "--sample_interval", "0",
                     "--tensorboard", "0"]}
    spec_path = str(tmp_path / "cli.spec.pt")
    torch.save(spec, spec_path)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node=2", WORKER, "cli", spec_path,
                           str(tmp_path / "cli.out.pt"), "0", "2", "-"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=WORKER_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for r in range(2):
        assert f"rank {r}: training finished at step 3" in proc.stdout
    r0, r1 = (torch.load(str(tmp_path / f"cli.out.pt.{r}"), weights_only=False)
              for r in range(2))
    for key in ("G", "D", "ema"):
        _assert_equal_dicts(r0[key], r1[key], key)
    assert os.path.exists(os.path.join(out, "map3dbn_nano", "00000003_checkpoint.npz"))


# ---------------------------------------------------------------------------
# the rank-sharded loader
# ---------------------------------------------------------------------------


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i)}


@pytest.mark.parametrize("world_size", [1, 2, 4])
def test_rank_sharded_loader_matches_jax(world_size, monkeypatch):
    for n, batch, shuffle, seed in ((10, 1, True, 0), (11, 2, True, 5), (17, 3, False, 0)):
        data = _Indices(n)
        for rank in range(world_size):
            want = [b["i"].tolist() for b in jds.iterate_batches(
                data, batch, shuffle=shuffle, seed=seed, world_size=world_size, rank=rank)]
            for start in range(3):
                got = [b["i"].tolist() for b in ds.iterate_batches(
                    data, batch, shuffle=shuffle, seed=seed, start=start,
                    world_size=world_size, rank=rank)]
                assert got == want[start:], (n, batch, rank, start)
        # the distributed loader stops every rank at the batches each one has
        stop = ds.batches_per_rank(n, batch, world_size)
        monkeypatch.setattr(ds, "make_dataset", lambda kind, **meta: data)
        for rank in range(world_size):
            loader = ds.get_dataset_distributed("x", world_size, rank, batch)[0]
            assert len(list(loader(seed=seed, shuffle=shuffle))) == stop
            assert len(list(loader(seed=seed, shuffle=shuffle, start=1))) == max(stop - 1, 0)

