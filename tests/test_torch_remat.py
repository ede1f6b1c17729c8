"""Synthesis remat in the PyTorch port (``remat_synthesis``,
``models/synthesis.py``; ``auto_remat_synthesis``, ``models/generator.py``;
the trainer's decision, ``trainers/base_trainer.py``) on the CPU: a G step
with remat equals the step without it, per op and on the fused half-blocks
(their plain versions), and advances the synthesis state once; the residual
estimate is the JAX package's; the trainer decides for one micro-batch and
decides again after running out of memory.  The remat step against the JAX
package's is in ``test_torch_train.py``, beside the JAX steps it reuses."""

import types

import pytest
import torch

from threedhumangan_tpu import configs as jconfigs
from threedhumangan_tpu.models import generator as jgen
from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models import generator
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.trainers import base_trainer
from threedhumangan_tpu_torch.trainers import phase_trainer as pt

SHIPPED = ["MAP3DBN", "MAP3DBN512", "MAP3DBN512L", "MAP3DBN_TINY", "MAP3DBN_NANO"]


def _nano(**kw):
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
    meta.update(kw)
    return meta


def _g_step(meta, monkeypatch):
    """One G step of a fresh NANO state (seeded) in a rotated phase with nerf
    noise; returns (the gradients it stepped with, G's buffers before, after)."""
    smpl = synthetic_smpl_model(num_verts=96, num_faces=160)
    batch = ds.to_tensors(next(ds.iterate_batches(
        ds.SyntheticSHHQDataset(smpl_model=smpl, **meta), 2, shuffle=False)), "cpu")
    ts = pt.init_train_state(meta, torch.Generator().manual_seed(0), "cpu")
    before = {k: v.clone() for k, v in ts.G.named_buffers()}
    seen = []
    real = pt.adam_step

    def adam_step(opt, grads, lr, clip):
        if opt is ts.opt_G:
            seen.append([g.clone() for g in grads])
        return real(opt, grads, lr, clip)

    monkeypatch.setattr(pt, "adam_step", adam_step)
    pt.g_train_step(ts, batch, torch.Generator().manual_seed(1), 1e-4, 0.5,
                    get_preprocessor(meta, smpl), meta, meta["phases"][1])
    return seen[0], before, dict(ts.G.named_buffers())


@pytest.mark.parametrize("fused", [False, True])
def test_remat_g_step_equals_no_remat(fused, monkeypatch):
    """Gradients within 1e-6 relative L2; BN running stats, their counts and
    the spectral-norm ``u`` identical, each advanced once."""
    runs = {remat: _g_step(_nano(pallas_synthesis_train=fused, remat_synthesis=remat),
                           monkeypatch) for remat in (False, True)}
    (g0, before, b0), (g1, _, b1) = runs[False], runs[True]
    num = sum(torch.sum(torch.square(a - b)) for a, b in zip(g0, g1))
    den = sum(torch.sum(torch.square(a)) for a in g0)
    assert den > 0 and float(torch.sqrt(num / den)) < 1e-6
    syn_keys = [k for k in b0 if k.startswith("synthesis_network.network.")]
    assert syn_keys
    for k in syn_keys:
        assert torch.equal(b0[k], b1[k]), k
        if k.endswith("num_batches_tracked"):
            assert int(b1[k]) == int(before[k]) + 1, k
        elif k.endswith(("weight_u", "running_mean", "running_var")):
            assert not torch.equal(b1[k], before[k]), k


def test_remat_recomputes_only_in_the_backward(monkeypatch):
    """Remat runs each block once in the forward and again in the backward;
    the recompute updates no state (counted by the half-blocks' plain
    forward)."""
    from threedhumangan_tpu_torch.ops import synthesis_train

    calls = []
    real = synthesis_train.half_block_forward

    def counted(*a, **k):
        calls.append(torch.is_grad_enabled())
        return real(*a, **k)

    monkeypatch.setattr(synthesis_train, "half_block_forward", counted)
    counts = {}
    for remat in (False, True):
        calls.clear()
        _g_step(_nano(pallas_synthesis_train=True, remat_synthesis=remat), monkeypatch)
        counts[remat] = len(calls)
    blocks = configs.MAP3DBN_NANO["synthesis_blocks"]
    assert counts[False] == 2 * blocks
    # the recompute stops at the last saved tensor: at least the first half
    # of every block runs again, at most both halves
    assert blocks <= counts[True] - counts[False] <= 2 * blocks


@pytest.mark.parametrize("name", SHIPPED)
def test_residual_bytes_are_the_jax_estimate(name):
    meta = configs.extract_metadata(getattr(configs, name), 0)
    jmeta = jconfigs.extract_metadata(getattr(jconfigs, name), 0)
    for micro in range(1, 33):
        got = generator.synthesis_residual_bytes(meta, micro)
        assert got == (2 * meta.get("synthesis_blocks", 9) * micro * meta["gen_height"]
                       * meta["gen_width"] * meta["hidden_dim"] * 2)
        # the JAX decision is this estimate against the JAX budget
        assert jgen.auto_remat_synthesis(jmeta, micro) == (
            got > jgen._AUTO_REMAT_RESIDUAL_BUDGET)
        assert generator.auto_remat_synthesis(meta, micro) == (
            got > generator.REMAT_RESIDUAL_BUDGET)


def _opt(out):
    return types.SimpleNamespace(output_dir=out, device="cpu", model_save_interval=10,
                                 model_keep_interval=10, sample_interval=0, n_epochs=10, seed=3,
                                 tensorboard=0)


def _config(**kw):
    config = configs.get_config(types.SimpleNamespace(config="MAP3DBN_NANO", tune="", variant=0))
    config.update(kw)
    return config


def test_trainer_decides_remat_per_micro_batch_and_again_after_oom(tmp_path, monkeypatch,
                                                                   capsys):
    """NANO at batch 2 with a budget between the estimates of micro-batches
    1 and 2: remat at split 1; the first pair runs out of memory after its D
    step (no checkpoint yet), the D step is undone, the split doubles and the
    trainer decides again: no remat at micro-batch 1."""
    meta = _nano()
    one, two = (generator.synthesis_residual_bytes(meta, m) for m in (1, 2))
    monkeypatch.setattr(generator, "REMAT_RESIDUAL_BUDGET", (one + two) // 2)
    real = pt.train_step_pair
    seen = []

    def pair(ts, data, gen, meta, pre, phase, lr_g, lr_d, noise, draws=None, stage=None,
             ada_p=0.0):
        seen.append((meta["batch_split"], meta["remat_synthesis"]))
        if len(seen) == 1:
            pt.d_train_step(ts, data, gen, lr_d, noise, pre, meta, phase)
            raise torch.cuda.OutOfMemoryError("injected: out of memory")
        return real(ts, data, gen, meta, pre, phase, lr_g, lr_d, noise, draws, stage, ada_p)

    monkeypatch.setattr(pt, "train_step_pair", pair)
    trainer = base_trainer.Trainer(0, 1, _opt(str(tmp_path)),
                                   _config(pallas_synthesis_train=True))
    assert trainer._stage_meta["remat_synthesis"] is True
    trainer.run(max_steps=2)
    assert seen == [(1, True), (2, False), (2, False)]
    assert "restored" not in capsys.readouterr().out
    steps = [base_trainer._opt_steps(o) for o in (trainer.ts.opt_D, trainer.ts.opt_G)]
    assert steps == [2, 2]  # the undone D step is not counted


def test_trainer_keeps_a_pinned_remat_and_skips_it_per_op(tmp_path):
    pinned = base_trainer.Trainer(0, 1, _opt(str(tmp_path / "a")),
                                  _config(pallas_synthesis_train=True, remat_synthesis=False))
    assert pinned._stage_meta["remat_synthesis"] is False
    per_op = base_trainer.Trainer(0, 1, _opt(str(tmp_path / "b")), _config())
    assert not per_op._stage_meta["pallas_synthesis_train"]
    assert "remat_synthesis" not in per_op._stage_meta
