"""The generator's kernel selections in the PyTorch port: each JAX meta flag
that picks a field-path kernel reaches the port's counterpart.

  pallas_fold_film=False / pallas_march_loop=True   K4 (unfolded render)
  pallas_fuse_geo=True                              K5 (geo-fused render)
  pallas_geo=False (pallas_knn True / False)        K6 / the plain search
  pallas_synthesis, pallas_raster (False)           no role: K3 and K7 always

Each selection's ``generator_forward`` (plain versions on the CPU, float32,
exact sine) is held against the JAX package's ``generator_forward`` on its
XLA path with the same weights and inputs; spies on the plain versions show
which path each flag takes, on inference and on both training renders; and
no selection imports JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import _meta, _setup
from threedhumangan_tpu.models import generator as jgen
from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models import generator as gen
from threedhumangan_tpu_torch.models import smpl
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.ops import geo, knn
from threedhumangan_tpu_torch.ops import raymarch as rm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELECTIONS = {
    "k4": dict(pallas_fold_film=False),
    "k4_march_loop": dict(pallas_march_loop=True),
    "k5": dict(pallas_fuse_geo=True),
    "k6": dict(pallas_geo=False),
    "plain_knn": dict(pallas_geo=False, pallas_knn=False),
}


@pytest.fixture(scope="module")
def slice_case():
    """MAP3DBN512L's layout at TINY size; the JAX XLA reference once."""
    meta = _meta("legacy_isolated")
    params, state, g, cond, jcond, z = _setup(meta, seed=5)
    ref, _ = jgen.generator_forward(params, state, jnp.asarray(z), jcond, jax.random.PRNGKey(0),
                                    meta)
    return meta, g, cond, z, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("selection", sorted(SELECTIONS))
def test_generator_forward_selection_matches_jax(slice_case, selection):
    meta, g, cond, z, ref = slice_case
    got = gen.generator_forward(g, torch.as_tensor(z), cond, dict(meta, **SELECTIONS[selection]))
    # as tests/test_torch_slice.py::test_generator_forward_matches_jax
    np.testing.assert_allclose(got["rgbs_render"].numpy(), ref["rgbs_render"], rtol=2e-3,
                               atol=2e-4)
    np.testing.assert_allclose(got["rgbs"].numpy(), ref["rgbs"], rtol=2e-2, atol=2e-3)


# plain function -> (module holding the name its caller looks up)
_SPIED = {"geo_features_plain": geo, "nn_points_plain": knn, "knn_points": smpl,
          "field_render_plain": rm, "field_render_unfolded_plain": rm,
          "field_render_geo_plain": rm}


@pytest.fixture
def spy(monkeypatch):
    """Record each spied plain function's calls (name, packed width)."""
    calls = []
    for name, mod in _SPIED.items():
        orig = getattr(mod, name)

        def wrapped(*a, _name=name, _orig=orig, **k):
            shapes = [x.shape[-1] for x in a if isinstance(x, torch.Tensor) and x.dim() == 3]
            calls.append((_name, shapes[0] if shapes else None))
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


def _nano(**kw):
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
    meta.update(dict(nerf_noise=0, perturb_rays=False), **kw)
    g = torch.Generator().manual_seed(0)
    batch = ds.to_tensors(next(ds.iterate_batches(ds.SyntheticSHHQDataset(
        smpl_model=synthetic_smpl_model(num_verts=96, num_faces=64), **meta), 2,
        shuffle=False)), "cpu")
    cond = get_preprocessor(meta)(batch, rotate=True, generator=g)
    return meta, gen.init_generator(meta, g, "cpu"), cond


@pytest.mark.parametrize("flags,path", [
    ({}, ["geo_features_plain", "field_render_plain"]),
    (dict(pallas_fold_film=False), ["geo_features_plain", "field_render_unfolded_plain"]),
    (dict(pallas_march_loop=True), ["geo_features_plain", "field_render_unfolded_plain"]),
    (dict(pallas_fuse_geo=True), ["field_render_geo_plain"]),
    (dict(pallas_geo=False), ["nn_points_plain", "field_render_plain"]),
    (dict(pallas_geo=False, pallas_knn=False), ["knn_points", "field_render_plain"]),
])
def test_each_flag_reaches_its_path(spy, flags, path):
    meta, g, cond = _nano(**flags)
    out = gen.generator_forward(g, torch.randn(2, meta["latent_dim"]), cond, meta)
    assert torch.isfinite(out["rgbs"]).all()
    assert [name for name, _ in spy] == path


def test_fused_geo_serves_the_d_fakes_with_noise_and_never_the_grad_path(spy):
    """pallas_fuse_geo: the D step's fakes (no grad) render on K5 with the
    noise column (7 raw columns); the G step's grad path renders through
    FieldRender on the folded kernel, after K1 (JAX generator.py:215-220)."""
    meta, g, cond = _nano(pallas_fuse_geo=True, nerf_noise=0.5)
    z = torch.randn(2, meta["latent_dim"])
    freq, phase = g.neural_field_mapping_network(z)
    with torch.no_grad():
        gen.render(g, freq, phase, cond, meta, torch.Generator().manual_seed(1))
    assert spy == [("field_render_geo_plain", rm.GEO_PACK + 1)]
    spy.clear()
    rgb, feats, _ = gen.render(g, freq, phase, cond, meta, torch.Generator().manual_seed(1),
                               grad_field=True)
    assert spy == [("geo_features_plain", 3), ("field_render_plain", rm.INPUT_PACK + 1)]
    (rgb.sum() + feats.sum()).backward()
    assert g.neural_field.sigma_layer.weight.grad is not None


def test_fused_geo_stays_off_without_modulation(spy):
    meta, g, cond = _nano(pallas_fuse_geo=True, disable_modulation=True)
    gen.generator_forward(g, torch.randn(2, meta["latent_dim"]), cond, meta)
    assert [name for name, _ in spy] == ["field_render_plain"]


def test_pallas_synthesis_false_gives_the_default_output():
    """pallas_synthesis has no role in the port (models/generator.py): the JAX
    flag chooses between two computations of one function; the port runs K3."""
    meta, g, cond = _nano()
    z = torch.randn(2, meta["latent_dim"], generator=torch.Generator().manual_seed(3))
    ref = gen.generator_forward(g, z, cond, meta)
    got = gen.generator_forward(g, z, cond, dict(meta, pallas_synthesis=False))
    for k in ("rgbs", "rgbs_render"):
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


def test_pallas_raster_false_gives_the_default_output():
    """pallas_raster has no role in the port (data/preprocessor.py): the JAX
    flag chooses its tile kernel or its XLA rasterizer; the port runs K7."""
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0), nerf_noise=0)
    model = synthetic_smpl_model(num_verts=96, num_faces=64)
    batch = ds.to_tensors(next(ds.iterate_batches(ds.SyntheticSHHQDataset(
        smpl_model=model, **meta), 2, shuffle=False)), "cpu")
    outs = [get_preprocessor(m, model)(batch, rotate=True,
                                       generator=torch.Generator().manual_seed(2))
            for m in (meta, dict(meta, pallas_raster=False))]
    for k in ("rasterized_segments", "rasterized_semantics"):
        torch.testing.assert_close(outs[1][k], outs[0][k], rtol=0, atol=0)


@pytest.mark.parametrize("key", ["pallas_field", "pallas_field_train", "pallas_field_bwd"])
def test_unported_field_paths_raise(spy, key):
    """Once refused, these keys are ported (tests/test_torch_field_options.py
    holds their values against the JAX package) and no longer raise:
    ``pallas_field=False`` renders on the XLA field path (K1, no field
    kernel) at eval and in the G step; ``pallas_field_train=False`` takes it
    in the G step only; ``pallas_field_bwd=False`` keeps the field kernel's
    forward in the G step and backs it by autograd through the unfolded
    render."""
    meta, g, cond = _nano(**{key: False})
    z = torch.randn(2, meta["latent_dim"])
    out = gen.generator_forward(g, z, cond, meta)
    assert torch.isfinite(out["rgbs"]).all()
    kernel = [] if key == "pallas_field" else ["field_render_plain"]
    assert [name for name, _ in spy] == ["geo_features_plain"] + kernel
    spy.clear()
    freq, phase = g.neural_field_mapping_network(z)
    rgb, feats, _ = gen.render(g, freq, phase, cond, meta, grad_field=True)
    (rgb.sum() + feats.sum()).backward()
    assert g.neural_field.sigma_layer.weight.grad is not None
    kernel = ["field_render_plain"] if key == "pallas_field_bwd" else []
    assert [name for name, _ in spy] == ["geo_features_plain"] + kernel


_NO_JAX = r"""
import sys
import torch
from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.data.dataset import SyntheticSHHQDataset, iterate_batches, to_tensors
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models.generator import init_generator, staged_forward
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.ops import knn, raymarch
g = torch.Generator().manual_seed(0)
for flags in SELECTIONS:
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
    meta.update(nerf_noise=0, perturb_rays=False, **flags)
    batch = to_tensors(next(iterate_batches(SyntheticSHHQDataset(
        smpl_model=synthetic_smpl_model(num_verts=96, num_faces=64), **meta), 2, shuffle=False)),
        "cpu")
    cond = get_preprocessor(meta)(batch, rotate=True, generator=g)
    out = staged_forward(init_generator(meta, g, "cpu"),
                         torch.randn(2, meta["latent_dim"], generator=g), cond, meta, g)
    assert bool(torch.isfinite(out["rgbs"]).all()), flags
assert (knn.launches, raymarch.launches_unfolded, raymarch.launches_geo) == (0, 0, 0)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "threedhumangan_tpu" or m.startswith("threedhumangan_tpu."))
assert not bad, bad
print("NO_JAX_OK")
"""


def test_kernel_selections_never_import_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    script = _NO_JAX.replace("SELECTIONS", repr(list(SELECTIONS.values())))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
