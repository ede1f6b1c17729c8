"""The PyTorch port's training loop (threedhumangan_tpu_torch/trainers/
base_trainer.py, apps/train.py) and the modules under it, on the CPU: the
port's copy of the configs against the JAX package's, checkpoint names and
pruning, a NANO run of the CLI and its bit-equal resume, the ``Collector``,
the prefetch worker, out-of-memory recovery, and the entry points' CUDA
default (a call without a device raises on a host without CUDA)."""

import json
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu import configs as jconfigs
from threedhumangan_tpu.parallel import stats as jstats
from threedhumangan_tpu.utils import checkpoint as jckpt
from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.apps import train as app
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data.prefetch import prefetch
from threedhumangan_tpu_torch.models import discriminator, generator
from threedhumangan_tpu_torch.parallel.stats import Collector
from threedhumangan_tpu_torch.trainers import base_trainer, phase_trainer
from threedhumangan_tpu_torch.utils import checkpoint, weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["MAP3DBN", "MAP3DBN512", "MAP3DBN512L", "MAP3DBN_TINY", "MAP3DBN_NANO"]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_config_copy_matches_jax_metadata(name):
    mine, ref = getattr(configs, name), getattr(jconfigs, name)
    for step in (0, 1000, 1001, 140001, 300001):
        assert configs.extract_metadata(mine, step) == jconfigs.extract_metadata(ref, step), step
        if "batch_size" in configs.extract_metadata(mine, step):
            assert configs.next_upsample_step(mine, step) == jconfigs.next_upsample_step(ref, step)
            assert configs.last_upsample_step(mine, step) == jconfigs.last_upsample_step(ref, step)


@pytest.mark.parametrize("name", NAMES)
def test_config_copy_matches_jax_get_config(name):
    sweeps = [("", 0)] + [("lr", v) for v in range(4)] + [("map3d_mode", v) for v in range(3)]
    for tune, variant in sweeps:
        opt = types.SimpleNamespace(config=name, tune=tune, variant=variant)
        assert configs.get_config(opt) == jconfigs.get_config(opt), (tune, variant)
    with pytest.raises(NotImplementedError):
        configs.get_config(types.SimpleNamespace(config=name, tune="bogus", variant=0))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_names_and_pruning_match_jax(tmp_path):
    steps = [1, 2, 4, 5, 10, 15, 20, 1000, 5000, 5001, 10000]
    for d in ("mine", "ref"):
        os.makedirs(tmp_path / d)
        for s in steps:
            (tmp_path / d / f"{s:08d}_checkpoint.npz").write_bytes(b"")
    checkpoint.prune_checkpoints(str(tmp_path / "mine"), 5)
    jckpt.prune_checkpoints(str(tmp_path / "ref"), 5)
    assert sorted(os.listdir(tmp_path / "mine")) == sorted(os.listdir(tmp_path / "ref"))
    assert (checkpoint.latest_checkpoint(str(tmp_path / "mine")).replace("mine", "ref")
            == jckpt.latest_checkpoint(str(tmp_path / "ref")))
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None


def test_checkpoint_round_trip_is_data_only(tmp_path):
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(lin.parameters(), lr=1e-3, betas=(0.0, 0.9))
    lin(torch.randn(4, 3)).sum().backward()
    opt.step()
    payload = {"m": lin.state_dict(), "opt": opt.state_dict(), "rng": torch.Generator().get_state(),
               "ema": {"count": 3, "params": {"w": torch.ones(2)}}, "name": "x"}
    path = checkpoint.save_checkpoint(str(tmp_path), 7, checkpoint.to_host(payload),
                                      keep_interval=7)
    assert os.path.basename(path) == "00000007_checkpoint.npz"
    got = checkpoint.load_checkpoint(path)
    assert got["step"] == 7 and got["name"] == "x" and got["ema"]["count"] == 3
    assert got["opt"]["param_groups"][0]["betas"] == (0, 0.9)
    assert set(got["opt"]["state"]) == {0, 1}
    for k, v in lin.state_dict().items():
        assert torch.equal(got["m"][k], v)
    assert torch.equal(got["rng"], payload["rng"])
    with np.load(path, allow_pickle=False) as z:  # plain arrays, no object entries
        assert all(z[k].dtype != object for k in z.files)


# ---------------------------------------------------------------------------
# the CLI and resume
# ---------------------------------------------------------------------------

NANO = ["--config", "MAP3DBN_NANO", "--device", "cpu", "--model_save_interval", "2",
        "--model_keep_interval", "2", "--seed", "3"]


def _final_state(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: np.array(z[k]) for k in z.files}


def test_cli_run_then_resume_matches_an_uninterrupted_run(tmp_path, capsys):
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    app.main(NANO + ["--output_dir", out_a, "--max_steps", "2", "--sample_interval", "2"])
    run_dir = os.path.join(out_a, "map3dbn_nano")
    for f in ("00000002_checkpoint.npz", "00000002_fixed_ema.png", "00000002_tilted_dseg.png",
              "options.txt"):
        assert os.path.exists(os.path.join(run_dir, f)), f
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(run_dir))
    trainer = app.main(NANO + ["--output_dir", out_a, "--max_steps", "4", "--sample_interval", "0"])
    printed = capsys.readouterr().out
    assert "resumed from" in printed and "at step 2" in printed
    assert "training finished at step 4" in printed and trainer.step == 4
    app.main(NANO + ["--output_dir", out_b, "--max_steps", "4", "--sample_interval", "0"])
    a = _final_state(os.path.join(run_dir, "00000004_checkpoint.npz"))
    b = _final_state(os.path.join(out_b, "map3dbn_nano", "00000004_checkpoint.npz"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1]  # logged at step 1 and every 10th
    for r in rows:
        assert all(np.isfinite(v) for v in r.values()), r


_NO_JAX = r"""
import sys
from threedhumangan_tpu_torch.apps import train
train.main(["--config", "MAP3DBN_NANO", "--device", "cpu", "--output_dir", sys.argv[1],
            "--max_steps", "1", "--model_save_interval", "1", "--model_keep_interval", "1"])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "threedhumangan_tpu" or m.startswith("threedhumangan_tpu."))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_cli_never_imports_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout and "training finished at step 1" in proc.stdout


# ---------------------------------------------------------------------------
# statistics and prefetch
# ---------------------------------------------------------------------------


def test_collector_matches_jax():
    rs = np.random.RandomState(0)
    steps = [{"a": rs.randn(5), "b": rs.randn(3)}, {"a": rs.randn(4)},
             {"b": np.zeros(0), "c": rs.randn(2)}]
    mine, ref = Collector("[ab]"), jstats.Collector("[ab]")
    for st in steps:
        mine.update({k: torch.as_tensor(np.array(jstats.moments(jnp.asarray(v))))
                     for k, v in st.items()})
        ref.update({k: jstats.moments(jnp.asarray(v)) for k, v in st.items()})
    assert sorted(mine.names()) == sorted(ref.names()) == ["a", "b"]
    for n in ("a", "b", "c"):
        assert mine.num(n) == ref.num(n)
        np.testing.assert_allclose([mine.mean(n), mine.std(n)], [ref.mean(n), ref.std(n)],
                                   rtol=1e-6, equal_nan=True)
    mine.reset()
    assert mine.names() == []


def test_prefetch_keeps_order_and_transforms():
    it = prefetch(iter(range(7)), depth=2, transform=lambda x: x * 10)
    assert list(it) == [0, 10, 20, 30, 40, 50, 60]
    with pytest.raises(StopIteration):
        next(it)
    early = prefetch(iter(range(100)), depth=2)
    assert next(early) == 0
    early.close()  # the worker stops though 98 items remain


def test_prefetch_surfaces_worker_errors():
    def items():
        yield 1
        raise KeyError("bad item")

    it = prefetch(items(), depth=1)
    assert next(it) == 1
    with pytest.raises(KeyError, match="bad item"):
        next(it)


# ---------------------------------------------------------------------------
# out-of-memory recovery
# ---------------------------------------------------------------------------


def _opt(out, **kw):
    base = dict(output_dir=out, device="cpu", model_save_interval=2, model_keep_interval=2,
                sample_interval=0, n_epochs=10, seed=3, tensorboard=0)
    return types.SimpleNamespace(**{**base, **kw})


def _failing_pair(monkeypatch, at_step, after_d_step):
    """train_step_pair that runs out of memory once at ``at_step``, before any
    update or after the D optimizer stepped."""
    real = phase_trainer.train_step_pair
    state = {"failed": False}

    def pair(ts, data, gen, meta, pre, phase, lr_g, lr_d, noise, draws=None, stage=None):
        if ts.step == at_step and not state["failed"]:
            state["failed"] = True
            if after_d_step:
                phase_trainer.d_train_step(ts, data, gen, lr_d, noise, pre, meta, phase)
            raise torch.cuda.OutOfMemoryError("injected: out of memory")
        return real(ts, data, gen, meta, pre, phase, lr_g, lr_d, noise, draws, stage)

    monkeypatch.setattr(phase_trainer, "train_step_pair", pair)
    return state


@pytest.mark.parametrize("after_d_step", [False, True])
def test_oom_doubles_batch_split_and_recovers(tmp_path, monkeypatch, capsys, after_d_step):
    state = _failing_pair(monkeypatch, 3, after_d_step)
    config = configs.get_config(types.SimpleNamespace(config="MAP3DBN_NANO", tune="", variant=0))
    trainer = base_trainer.Trainer(0, 1, _opt(str(tmp_path)), config)
    trainer.run(max_steps=5)
    printed = capsys.readouterr().out
    assert state["failed"] and trainer.step == 5
    assert trainer._stage_meta["batch_split"] == 2
    if after_d_step:  # restored from step 2's checkpoint, then 3 more pairs
        assert "restored" in printed and "at step 2" in printed
    else:             # the failed step is retried in place
        assert "restored" not in printed
    steps = [base_trainer._opt_steps(o) for o in (trainer.ts.opt_D, trainer.ts.opt_G)]
    assert steps == [5, 5]


def test_non_oom_errors_are_not_caught(tmp_path, monkeypatch):
    def pair(*a, **k):
        raise RuntimeError("CUDA out of memory (a message, not the OOM type)")

    monkeypatch.setattr(phase_trainer, "train_step_pair", pair)
    config = configs.get_config(types.SimpleNamespace(config="MAP3DBN_NANO", tune="", variant=0))
    trainer = base_trainer.Trainer(0, 1, _opt(str(tmp_path)), config)
    with pytest.raises(RuntimeError, match="a message"):
        trainer.run(max_steps=2)
    assert trainer._stage_meta["batch_split"] == 1


# ---------------------------------------------------------------------------
# entry points default to the card
# ---------------------------------------------------------------------------

_META = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
_CALLS = {
    "init_generator": lambda: generator.init_generator(_META, torch.Generator()),
    "init_discriminator": lambda: discriminator.init_discriminator(_META, torch.Generator()),
    "init_train_state": lambda: phase_trainer.init_train_state(_META, torch.Generator()),
    "train_state_from_jax": lambda: weights.train_state_from_jax(None, _META),
    "to_tensors": lambda: ds.to_tensors({"x": np.zeros(2)}),
    "generate_avg_latent": lambda: generator.generate_avg_latent(None, _META, torch.Generator()),
    "Trainer": lambda: base_trainer.Trainer(0, 1, types.SimpleNamespace(output_dir="unused"),
                                            configs.MAP3DBN_NANO),
}


@pytest.mark.parametrize("entry", list(_CALLS))
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _CALLS[entry]()
