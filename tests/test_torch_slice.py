"""The port's generation slice end to end on the CPU: threedhumangan_tpu_torch
``generator_forward`` / ``staged_forward`` (plain versions of K1-K3) against
the JAX package's ``generator_forward`` on its XLA path, with the same
weights (moved with ``from_jax_params``), the same batch and latents.  Plus:
importing the port and running a forward never imports JAX, and no kernel
launches on the CPU."""

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
from threedhumangan_tpu.models import generator as jgen
from threedhumangan_tpu.models import smpl as jsmpl
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models import generator as gen
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.ops import geo, raymarch, synthesis_kernel
from threedhumangan_tpu_torch.utils.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meta(variant):
    meta = dict(configs.extract_metadata(configs.MAP3DBN_TINY, 0))
    # fast_math off: the folded (port) and unfolded (JAX XLA) SIRENs are
    # compared pointwise in float32, as tests/test_raymarch.py:51 does
    meta.update(nerf_noise=0, perturb_rays=False, fast_math=False)
    if variant == "legacy_isolated":  # MAP3DBN512L's field/synthesis layout
        meta.update(legacy_mode=True, map3d_mode="isolated")
    return meta


def _setup(meta, B=2, seed=0):
    """Same weights, batch, camera and latents on both sides."""
    params, state = jgen.init_generator(jax.random.PRNGKey(seed), meta)
    g = gen.Map3DGenerator(meta)
    from_jax_params(params, state, g)
    g.eval()
    batch = next(ds.iterate_batches(
        ds.SyntheticSHHQDataset(smpl_model=synthetic_smpl_model(num_verts=96, num_faces=64),
                                **meta), B, shuffle=False))
    rs = np.random.RandomState(seed)
    h, v = (rs.uniform(-0.3, 0.3, B).astype(np.float32) for _ in range(2))
    r = np.zeros(B, np.float32)
    cond = get_preprocessor(meta).forward_with_rotation(
        ds.to_tensors(batch), *map(torch.as_tensor, (h, v, r)))
    jp = jpre.get_preprocessor(meta, smpl_model=jsmpl.synthetic_smpl_model(96, 64))
    jcond = jp.forward_with_rotation({k: jnp.asarray(x) for k, x in batch.items()},
                                     *map(jnp.asarray, (h, v, r)))
    z = rs.randn(B, meta["latent_dim"]).astype(np.float32)
    return params, state, g, cond, jcond, z


@pytest.mark.parametrize("variant", ["tiny", "legacy_isolated"])
def test_generator_forward_matches_jax(variant):
    meta = _meta(variant)
    params, state, g, cond, jcond, z = _setup(meta)
    got = gen.generator_forward(g, torch.as_tensor(z), cond, meta)
    ref, _ = jgen.generator_forward(params, state, jnp.asarray(z), jcond,
                                    jax.random.PRNGKey(0), meta)
    assert got["rgbs"].shape == ref["rgbs"].shape == (2, meta["gen_height"], meta["gen_width"], 3)
    # as tests/test_raymarch.py::test_generator_pallas_flag_matches_xla
    np.testing.assert_allclose(got["rgbs_render"].numpy(), np.asarray(ref["rgbs_render"]),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got["rgbs"].numpy(), np.asarray(ref["rgbs"]),
                               rtol=2e-2, atol=2e-3)


def test_staged_forward_truncation_and_depth_match_jax():
    meta = _meta("legacy_isolated")
    meta["last_back"] = True  # the sampler's eval_last_back
    params, state, g, cond, jcond, z = _setup(meta, seed=1)
    # the same average latent on both sides (JAX draws it from its own PRNG)
    avg = jgen.generate_avg_latent(params, jax.random.PRNGKey(2), meta, n=64)
    got = gen.staged_forward(g, torch.as_tensor(z), cond, meta, truncation_psi=0.7,
                             avg_latent=tuple(torch.as_tensor(np.array(a)) for a in avg))
    ref, _ = jgen.staged_forward(params, state, jnp.asarray(z), jcond, jax.random.PRNGKey(0),
                                 meta, truncation_psi=0.7, avg_latent=avg)
    for k, tol in (("rgbs_render", (2e-3, 2e-4)), ("rgbs", (2e-2, 2e-3)),
                   ("depths", (2e-3, 2e-4)), ("skeletons", (1e-6, 1e-6))):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=tol[0], atol=tol[1],
                                   err_msg=k)


def test_generate_avg_latent_matches_jax_on_the_same_latents():
    meta = _meta("tiny")
    params, state, g, _, _, _ = _setup(meta, seed=3)
    z = np.random.RandomState(3).randn(32, meta["latent_dim"]).astype(np.float32)
    freq, _ = g.neural_field_mapping_network(torch.as_tensor(z))
    jfreq, _ = jgen.apply_mapping_network(params["neural_field_mapping_network"],
                                               jnp.asarray(z))
    np.testing.assert_allclose(freq.mean(0).detach().numpy(), np.asarray(jfreq.mean(0)),
                               rtol=1e-5, atol=1e-6)
    avg = gen.generate_avg_latent(g, meta, torch.Generator().manual_seed(0), n=16)
    assert [tuple(a.shape) for a in avg] == [
        (1, meta["latent_dim"]), (1, meta["neural_field_blocks"] * meta["hidden_dim"]),
        (1, meta["neural_field_blocks"] * meta["hidden_dim"]), (1, 1, meta["feature_dim"])]


def test_cpu_forward_launches_no_kernel():
    meta = _meta("tiny")
    _, _, g, cond, _, z = _setup(meta, seed=4)
    out = gen.generator_forward(g, torch.as_tensor(z), cond, meta, compute_dtype=torch.bfloat16)
    assert torch.isfinite(out["rgbs"]).all()
    assert (geo.launches, raymarch.launches, synthesis_kernel.launches) == (0, 0, 0)


_NO_JAX = r"""
import sys
import torch
from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.data.dataset import SyntheticSHHQDataset, iterate_batches, to_tensors
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models.generator import init_generator, staged_forward
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
meta.update(nerf_noise=0, perturb_rays=False)
g = torch.Generator().manual_seed(0)
batch = to_tensors(next(iterate_batches(SyntheticSHHQDataset(
    smpl_model=synthetic_smpl_model(num_verts=96, num_faces=64), **meta), 2, shuffle=False)))
cond = get_preprocessor(meta)(batch, rotate=True, generator=g)
out = staged_forward(init_generator(meta, g), torch.randn(2, meta["latent_dim"], generator=g),
                     cond, meta, g, truncation_psi=1.0)
assert out["rgbs"].shape == (2, meta["gen_height"], meta["gen_width"], 3)
assert bool(torch.isfinite(out["rgbs"]).all())
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not bad, bad
# of the JAX package, only its plain-Python configs
ref = sorted(m for m in sys.modules if m.startswith("threedhumangan_tpu.")
             and not m.startswith("threedhumangan_tpu.configs"))
assert not ref, ref
print("NO_JAX_OK")
"""


def test_port_forward_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
