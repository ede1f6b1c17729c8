"""The port's inference and eval apps against the JAX package's, on the CPU
at MAP3DBN_NANO in float32.

Both sides take the port's random weights: the JAX side through
``convert_generator_state_dict(port.state_dict(), meta)``, patched in place
of ``init_generator`` where a JAX app's ``main`` builds its generator.  The
port takes the JAX apps' latents and truncation averages, which
``jax.random`` draws and torch cannot reproduce.  Also: the
``export_tensorboard`` round trip, the weight loaders, each app's CLI with
``--device cpu`` and its refusal without CUDA, and no JAX import in a
process that runs the apps."""

import json
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apps.eval_consistency as jcons
import apps.eval_fid as jfidapp
import apps.eval_parity as jparity
import apps.export_tensorboard as jexport
import apps.sample_from_generator as jsample
from tests.test_tb import _decode_scalar_event, _read_records
from threedhumangan_tpu.data import get_dataset as jget_dataset
from threedhumangan_tpu.data import get_preprocessor as jget_preprocessor
from threedhumangan_tpu.models import generator as jgen
from threedhumangan_tpu.utils.torch_convert import convert_generator_state_dict
from threedhumangan_tpu_torch.apps import (eval_consistency, eval_fid, eval_parity,
                                           export_tensorboard, sample_from_generator)
from threedhumangan_tpu_torch.apps.common import eval_config, load_weights
from threedhumangan_tpu_torch.data.dataset import get_dataset, iterate_batches, to_tensors
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.data.utils import read_png
from threedhumangan_tpu_torch.models.generator import init_generator
from threedhumangan_tpu_torch.utils import weights
from threedhumangan_tpu_torch.utils.checkpoint import save_checkpoint
from threedhumangan_tpu_torch.utils.fid import fid_between

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "MAP3DBN_NANO"


def _scalars(path):
    evs = [_decode_scalar_event(r) for r in _read_records(path)[1:]]
    return [(e["tag"], e["step"], e["value"]) for e in evs]


def _opt(**kw):
    return types.SimpleNamespace(config=CONFIG, tune="", variant=0, **kw)


def _t(x):
    return torch.as_tensor(np.array(x))


def _avg(params, key, meta):
    return tuple(_t(a) for a in jgen.generate_avg_latent(params, key, meta))


@pytest.fixture(scope="module")
def nano():
    """Port G (random, seed 0) and its weights converted for JAX, for the
    sample app's config (eval settings, last_back = eval_last_back).  The
    field's density bias is 0.5: at these random weights every density
    otherwise stays below the clamp, the render is the empty background and
    the silhouette and reprojection metrics are 0 on both sides."""
    meta = eval_config(_opt(), dataroot="./datasets/shhq_example_dataset", dataset_length=10)
    gen = init_generator(meta, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        gen.neural_field.sigma_layer.bias.fill_(0.5)
    sd = {k: v.numpy() for k, v in gen.state_dict().items()}
    params, state = convert_generator_state_dict(sd, meta)
    return types.SimpleNamespace(meta=meta, gen=gen, sd=sd, params=params, state=state)


def _port_gen(meta, nano):
    """A port G built for ``meta``, holding the fixture's weights."""
    gen = init_generator(meta, torch.Generator(), "cpu")
    return weights.load_generator_state_dict(gen, {k: _t(v) for k, v in nano.sd.items()})


def _patch_init(monkeypatch, nano):
    monkeypatch.setattr(jgen, "init_generator", lambda key, config: (nano.params, nano.state))


def _run_jax_main(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    capsys.readouterr()
    module.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_generate_frames_matches_jax(nano):
    meta, seed, n = nano.meta, 7, 3
    _, jds = jget_dataset(meta["dataset"], inference=True, **meta)
    jpre = jget_preprocessor(meta, smpl_model=jds.smpl_model)
    data = next(iterate_batches(jds, 1, shuffle=False))
    javg = jgen.generate_avg_latent(nano.params, jax.random.PRNGKey(1), meta)
    ref_f, ref_s = jsample.generate_frames(
        nano.params, nano.state, jpre, meta, seed, {k: jnp.asarray(v) for k, v in data.items()},
        n, math.pi / 6, 0, False, javg)
    # JAX draws the latent from the seed (apps/sample_from_generator.py:52-53)
    z = _t(jax.random.normal(jax.random.split(jax.random.PRNGKey(seed))[0],
                             (1, meta["latent_dim"])))
    _, ds = get_dataset(meta["dataset"], inference=True, **meta)
    pre = get_preprocessor(meta, smpl_model=ds.smpl_model)
    frames, semantics = sample_from_generator.generate_frames(
        nano.gen, pre, meta, z, to_tensors(data, "cpu"), n, math.pi / 6, 0, False,
        tuple(_t(a) for a in javg))
    assert frames.shape == ref_f.shape == (n, meta["gen_height"], meta["gen_width"], 3)
    np.testing.assert_array_equal(semantics, ref_s)
    d = np.abs(frames.astype(np.int32) - ref_f.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 0.005, (d.max(), (d > 0).mean())


def test_eval_consistency_matches_jax_main(nano, monkeypatch, capsys):
    n, seed = 3, 1
    _patch_init(monkeypatch, nano)
    # the JAX app's per-pair reprojection errors and valid-pixel counts,
    # unrounded, as its main hands them to np.average
    pairs, average = [], np.average

    def spy(a, weights=None, **kw):
        pairs.append((list(a), list(weights)))
        return average(a, weights=weights, **kw)

    monkeypatch.setattr(np, "average", spy)
    ref = _run_jax_main(jcons, ["--config", CONFIG, "--n_angles", str(n), "--seed", str(seed)],
                        monkeypatch, capsys)
    monkeypatch.setattr(np, "average", average)
    assert len(pairs) == 1
    meta = eval_config(_opt())
    gen = _port_gen(meta, nano)
    # the JAX app's draws: z from the seed's key, view i's truncation
    # average from split(keys[i])[0] (generator_forward without avg_latent)
    key = jax.random.PRNGKey(seed)
    z = _t(jax.random.normal(key, (1, meta["latent_dim"])))
    keys = jax.random.split(key, n)
    avgs = [_avg(nano.params, jax.random.split(k)[0], meta) for k in keys]
    angles = np.linspace(-math.pi / 6, math.pi / 6, n)
    _, ds = get_dataset(meta["dataset"], inference=True, **meta)
    pre = get_preprocessor(meta, smpl_model=ds.smpl_model)
    data = next(iterate_batches(ds, 1, shuffle=False))
    metrics, views = eval_consistency.consistency_sweep(
        gen, pre, meta, z, to_tensors(data, "cpu"), angles, avgs)
    for k in ("seg_iou_mean", "reproj_l1", "adjacent_view_l1"):
        assert abs(metrics[k] - ref[k]) <= 1e-3, (k, metrics[k], ref[k])
    # each pair's reprojection, unrounded, within 1e-3 of its own size
    for (vi, vj), want, want_n in zip(zip(views[:-1], views[1:]), *pairs[0]):
        l1, cnt = eval_consistency.reproject(meta, vi["depth"], vi["rgb_small"], vi["cam"],
                                             vj["rgb_small"], vj["cam"], vi["focal"], vi["scale"])
        assert want > 0 and cnt == want_n and abs(l1 - want) <= 1e-3 * want, (l1, want, cnt, want_n)
    # the masks, as the JAX app's one_view forms them
    _, jds = jget_dataset(meta["dataset"], inference=True, **meta)
    jpre = jget_preprocessor(meta, smpl_model=jds.smpl_model)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    zero = jnp.zeros((1,))
    frames = []
    for h, k, view in zip(angles, keys, views):
        cond = jpre.forward_with_rotation(jdata, jnp.asarray([h]), zero, zero)
        out, _ = jgen.staged_forward(nano.params, nano.state, jnp.asarray(z), cond, k, meta)
        depth = out["depths"][..., 0]
        raster = jax.image.resize((cond["rasterized_segments"] > 1).astype(jnp.float32),
                                  depth.shape, method="nearest") > 0.5
        np.testing.assert_array_equal(view["raster_mask"].numpy(), np.asarray(raster[0]))
        np.testing.assert_array_equal(view["render_mask"].numpy(), np.asarray(depth[0] < 0.999))
        frames.append(np.asarray(out["rgbs"][0]))
    # the adjacent-view L1 of the JAX views, unrounded
    adjacent = float(np.mean(np.abs(np.diff(np.stack(frames), axis=0))))
    assert adjacent > 0 and abs(metrics["adjacent_view_l1"] - adjacent) <= 1e-3 * adjacent


def test_render_seed_and_parity_against_jax_main(nano, tmp_path, monkeypatch, capsys):
    seeds = (1, 2, 3)
    meta = eval_config(_opt(), dataroot="synthetic", dataset_length=4)
    gen = _port_gen(meta, nano)
    params, state = convert_generator_state_dict(
        {k: v.numpy() for k, v in gen.state_dict().items()}, meta)
    javg = jgen.generate_avg_latent(params, jax.random.PRNGKey(1), meta)
    _, ds = get_dataset(meta["dataset"], inference=True, **meta)
    pre = get_preprocessor(meta, smpl_model=ds.smpl_model)
    _, jds = jget_dataset(meta["dataset"], inference=True, **meta)
    jpre = jget_preprocessor(meta, smpl_model=jds.smpl_model)
    renders = {}
    for seed in seeds:
        cond = eval_parity.seed_conditions(ds, seed, "cpu")
        jcond = {k: jnp.asarray(np.asarray(v)[None]) for k, v in jds[seed % len(jds)].items()}
        z = _t(jax.random.normal(jax.random.PRNGKey(seed), (1, meta["latent_dim"])))
        got = eval_parity.render_seed(gen, pre, meta, z, cond, tuple(_t(a) for a in javg))
        ref = np.asarray(jparity.render_seed(params, state, jpre, meta, seed, jcond, javg))
        assert got.shape == ref.shape and np.abs(got.numpy() - ref).max() <= 1e-3
        renders[seed] = got.numpy()
    # the JAX app on the port's saved state_dict and the port's goldens
    ckpt, goldens = str(tmp_path / "g.pth"), str(tmp_path / "goldens")
    torch.save(gen.state_dict(), ckpt)
    eval_parity.save_goldens(renders, goldens)
    monkeypatch.setattr(sys, "argv", [
        "eval_parity", "--config", CONFIG, "--seeds", *map(str, seeds), "--dataset_length", "4",
        "--output_dir", str(tmp_path / "out"), "--torch_checkpoint", ckpt, "--goldens", goldens])
    capsys.readouterr()
    assert jparity.main() == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["weights"] == "released-checkpoint"
    assert len(summary["per_pixel"]) == len(seeds)
    for d in summary["per_pixel"].values():
        assert d["max_abs"] <= 1e-3, d


def test_eval_fid_matches_jax_main(nano, monkeypatch, capsys):
    n, batch, seed = 16, 8, 0
    _patch_init(monkeypatch, nano)
    ref = _run_jax_main(jfidapp, ["--config", CONFIG, "--n", str(n), "--batch", str(batch),
                                  "--seed", str(seed)], monkeypatch, capsys)
    meta = eval_config(_opt(), eval_last_back=False)
    meta["dataset_length"] = max(meta["dataset_length"], n)
    gen = _port_gen(meta, nano)
    _, ds = get_dataset(meta["dataset"], batch_size=batch, **meta)
    pre = get_preprocessor(meta, smpl_model=ds.smpl_model)
    batches = [b for _, b in zip(range(n // batch), iterate_batches(ds, batch, shuffle=False))]
    # the JAX app's draws (apps/eval_fid.py:82-83): z from fold_in(key, i);
    # the truncation average from split(split(fold_in(key, 1000 + i))[1])[0]
    key = jax.random.PRNGKey(seed)
    zs = [_t(jax.random.normal(jax.random.fold_in(key, i), (batch, meta["latent_dim"])))
          for i in range(len(batches))]
    avgs = [_avg(nano.params, jax.random.split(jax.random.split(
        jax.random.fold_in(key, 1000 + i))[1])[0], meta) for i in range(len(batches))]
    fakes, reals = eval_fid.generate_fakes(gen, pre, meta, batches, zs, avgs, device="cpu")
    value = fid_between(fakes, reals, device="cpu")
    assert abs(value - ref["value"]) <= 1e-3 * abs(ref["value"]), (value, ref["value"])


def test_export_tensorboard_round_trip(tmp_path):
    run = tmp_path / "run"
    os.makedirs(run)
    rows = [{"step": 10, "g_loss": 1.0, "note": "x"}, {"step": 20, "g_loss": 0.5, "d_loss": 2}]
    with open(run / "metrics.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n\n")
    path, n = export_tensorboard.main(["--run_dir", str(run), "--out", str(tmp_path / "tb")])
    want = [("train/g_loss", 10, 1.0), ("train/g_loss", 20, 0.5), ("train/d_loss", 20, 2.0)]
    # read back by the JAX package's tests' decoder; the JAX app's export alike
    assert n == 3 and _scalars(path) == want
    assert _scalars(jexport.export(str(run), str(tmp_path / "jtb"))) == want
    with pytest.raises(FileNotFoundError):
        export_tensorboard.export(str(tmp_path / "none"))


def test_weight_loaders(nano, tmp_path):
    meta = nano.meta
    g = torch.Generator().manual_seed(5)
    ema = {k: p.detach() + 0.01 * torch.randn(p.shape, generator=g)
           for k, p in nano.gen.named_parameters()}
    sd = {k: v.clone() for k, v in nano.gen.state_dict().items()}
    sd["synthesis_network.network.m3d_0.spade_0.first_norm.running_mean"] += 0.5
    ckpt = save_checkpoint(str(tmp_path), 3, {"G": sd, "D": {}, "ema": {"params": ema,
                                                                        "count": 3}})
    # an app's G for another dataset length: the pool takes the checkpoint's size
    other = init_generator(dict(meta, dataset_length=3), torch.Generator(), "cpu")
    assert load_weights(other, ckpt) == "trainer-checkpoint-ema"
    for k, p in other.named_parameters():
        assert torch.equal(p, ema[k]), k
    for k, b in other.named_buffers():
        assert torch.equal(b, sd[k]), k
    # a reference-key-space state_dict with torch's spectral-norm v and no pool
    path = str(tmp_path / "ema.pth")
    ref = {k: v for k, v in sd.items() if k != "latent_pool.latents"}
    ref["synthesis_network.network.m3d_0.conv_0.weight_v"] = torch.zeros(3)
    torch.save(ref, path)
    fresh = init_generator(meta, torch.Generator().manual_seed(9), "cpu")
    pool = fresh.latent_pool.latents.detach().clone()
    assert load_weights(fresh, path) == "torch-state_dict"
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, pool if k == "latent_pool.latents" else sd[k]), k
    torch.save(dict(ref, extra=torch.zeros(1)), path)
    with pytest.raises(KeyError):
        load_weights(fresh, path)
    with pytest.raises(FileNotFoundError):
        load_weights(fresh, str(tmp_path / "missing.pth"))


def test_sample_app_cli_writes_its_frames(tmp_path):
    out = sample_from_generator.main(["--config", CONFIG, "--device", "cpu", "--seeds", "3", "4",
                                      "--n_angles", "2", "--save", "png", "--output_dir",
                                      str(tmp_path)])
    assert sorted(out) == [3, 4]
    for base, frames, semantics in out.values():
        np.testing.assert_array_equal(read_png(base + "_uncond.png"),
                                      np.concatenate(list(frames), axis=1))
        np.testing.assert_array_equal(read_png(base + "_smpl.png"),
                                      np.concatenate(list(semantics), axis=1))


@pytest.mark.parametrize("app", [sample_from_generator, eval_consistency, eval_parity, eval_fid])
def test_apps_need_cuda_unless_asked_for_the_cpu(app):
    # this host has no CUDA: the default device raises before any work
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app.main(["--config", CONFIG])


def test_apps_run_on_cpu_without_jax(tmp_path):
    """The eval apps' CLIs at NANO with --device cpu in a fresh process: each
    prints its JSON, and no module of JAX or of the JAX package is loaded."""
    code = f"""
import json, sys
from threedhumangan_tpu_torch.apps import eval_consistency, eval_fid, eval_parity
c = eval_consistency.main(["--config", "{CONFIG}", "--device", "cpu", "--n_angles", "2"])
f = eval_fid.main(["--config", "{CONFIG}", "--device", "cpu", "--n", "8", "--batch", "4"])
g = "{tmp_path}/goldens"
eval_parity.main(["--config", "{CONFIG}", "--device", "cpu", "--seeds", "1", "2",
                  "--dataset_length", "4", "--output_dir", "{tmp_path}", "--write_goldens", g])
p = eval_parity.main(["--config", "{CONFIG}", "--device", "cpu", "--seeds", "1", "2",
                      "--dataset_length", "4", "--output_dir", "{tmp_path}", "--goldens", g])
bad = [m for m in sys.modules if m in ("jax", "threedhumangan_tpu")
       or m.startswith(("jax.", "threedhumangan_tpu."))]
print(json.dumps(dict(c=c, f=f, p=p, bad=bad)))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert all(math.isfinite(res["c"][k]) for k in ("seg_iou_mean", "reproj_l1",
                                                    "adjacent_view_l1"))
    assert math.isfinite(res["f"]["value"]) and "NOT Inception-FID" in res["f"]["metric"]
    assert all(d["max_abs"] == 0.0 for d in res["p"]["per_pixel"].values())
    assert abs(res["p"]["feature_frechet"]) < 1e-3
