"""K2 of the PyTorch port (threedhumangan_tpu_torch/ops/raymarch.py), plain
version on the CPU in float32, against the JAX package's folded field
kernel in interpret mode and its XLA packed render; plus fast_sin, the
folded tables and ray integration.  Inputs drawn with numpy from a seed.
The CUDA kernel is checked against the plain version by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu.models import volume_rendering as jvr
from threedhumangan_tpu.models.siren import init_coordconcat_siren
from threedhumangan_tpu.ops import raymarch as jrm
from threedhumangan_tpu_torch.models import volume_rendering as vr
from threedhumangan_tpu_torch.models.siren import CoordConcatSiren
from threedhumangan_tpu_torch.ops import raymarch as rm
from threedhumangan_tpu_torch.utils.weights import neural_field_state

B, R, S = 2, 8, 4
H, G, F, NB = 16, 31, 8, 4
SCALE = 2.0 / 2.85


def _field(seed=0):
    params = init_coordconcat_siren(jax.random.PRNGKey(seed), 3, H, G, F, NB)
    field = CoordConcatSiren(3, H, G, F, NB)
    field.load_state_dict(neural_field_state(params))
    return params, field


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    points = f32(0.5 * rs.randn(B, R * S, 3))
    geo = f32(0.3 * rs.randn(B, R * S, G))
    # per-ray directions repeated over the steps (the folded kernel's contract)
    dirs = f32(np.repeat(rs.randn(B, R, 3), S, axis=1))
    freq = f32(0.1 * rs.randn(B, NB * H))
    phase = f32(0.1 * rs.randn(B, NB * H))
    z_vals = f32(np.sort(rs.uniform(size=(B, R, S)) + 1.0, axis=-1))
    packed = np.concatenate([points * np.float32(SCALE), geo, dirs], -1)
    return packed, freq, phase, z_vals


def _port_render(field, packed, freq, phase, z_vals, **kw):
    t = torch.as_tensor
    with torch.no_grad():
        out, depth = rm.fused_field_render(field, t(packed), t(freq), t(phase), t(z_vals), S,
                                           compute_dtype=torch.float32, **kw)
    return out.numpy(), depth.numpy()


@pytest.mark.parametrize("white_back,last_back", [(True, False), (False, True), (False, False)])
def test_plain_field_matches_jax_folded_kernel_and_xla(white_back, last_back):
    params, field = _field()
    packed, freq, phase, z_vals = _inputs()
    out, depth = _port_render(field, packed, freq, phase, z_vals, exact_sin=True,
                              white_back=white_back, last_back=last_back)
    j = lambda a: jnp.asarray(a)
    k_out, k_depth = jrm.fused_field_render(
        params, j(packed), j(freq), j(phase), j(z_vals), num_steps=S, tile_rays=4,
        white_back=white_back, last_back=last_back, compute_dtype=jnp.float32,
        interpret=True, exact_sin=True, fold_film=True, step_pack=2)
    # as tests/test_raymarch.py::test_folded_kernel_matches_unfolded
    np.testing.assert_allclose(out, np.asarray(k_out), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(depth, np.asarray(k_depth), rtol=2e-3, atol=1e-4)
    x_out, x_depth = jrm._xla_packed_render(
        params, j(packed), j(freq), j(phase), j(z_vals), S, white_back, last_back,
        jnp.float32, True)
    np.testing.assert_allclose(out, np.asarray(x_out), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(depth, np.asarray(x_depth), rtol=2e-4, atol=2e-5)


def test_plain_field_fast_sin_close_to_jax_folded_kernel():
    params, field = _field(1)
    packed, freq, phase, z_vals = _inputs(1)
    out, _ = _port_render(field, packed, freq, phase, z_vals, exact_sin=False, white_back=True)
    j = lambda a: jnp.asarray(a)
    k_out, _ = jrm.fused_field_render(
        params, j(packed), j(freq), j(phase), j(z_vals), num_steps=S, tile_rays=4,
        white_back=True, compute_dtype=jnp.float32, interpret=True, exact_sin=False)
    np.testing.assert_allclose(out, np.asarray(k_out), rtol=2e-3, atol=1e-4)


def test_fast_sin_matches_jax_elementwise():
    x = np.linspace(-120.0, 120.0, 200001, dtype=np.float32)
    got = rm.fast_sin(torch.as_tensor(x)).numpy()
    ref = np.asarray(jrm.fast_sin(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert np.abs(got - np.sin(x.astype(np.float64))).max() < 5e-5


def test_fold_film_tables_match_jax():
    params, field = _field(2)
    _, freq, phase, _ = _inputs(2)
    with torch.no_grad():
        shared, per_image = rm.fold_film_tables(field, torch.as_tensor(freq),
                                                torch.as_tensor(phase), torch.float32)
    j_shared, j_per = jrm._fold_film_tables(params, jnp.asarray(freq), jnp.asarray(phase),
                                            jnp.float32)
    for ours, ref in ((shared, j_shared), (per_image, j_per)):
        assert set(ours) == set(ref)
        for k in ref:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("white_back,last_back", [(True, False), (False, True)])
def test_ray_integration_matches_jax(white_back, last_back):
    rs = np.random.RandomState(3)
    field_out = rs.randn(2, 6, 5, 4).astype(np.float32)
    z_vals = np.sort(rs.uniform(size=(2, 6, 5, 1)) + 1.0, axis=2).astype(np.float32)
    got = vr.ray_integration(torch.as_tensor(field_out), torch.as_tensor(z_vals),
                             white_back=white_back, last_back=last_back)
    ref = jvr.ray_integration(jnp.asarray(field_out), jnp.asarray(z_vals), noise_std=0.0,
                              white_back=white_back, last_back=last_back)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_field_cpu_path_launches_no_kernel():
    _, field = _field(5)
    _port_render(field, *_inputs(5))
    assert rm.launches == 0


def test_field_kernel_wrapper_rejects_malformed_input():
    """The CUDA entry checks the packed width and the ray/step tiling
    before it builds or launches anything."""
    _, field = _field(6)
    packed, freq, phase, z_vals = map(torch.as_tensor, _inputs(6))
    with torch.no_grad():
        shared, per_image = rm.fold_film_tables(field, freq, phase, torch.bfloat16)
    with pytest.raises(ValueError, match="columns"):
        rm.field_render_cuda(shared, per_image, packed[..., :-1], z_vals, S)
    with pytest.raises(ValueError, match="num_steps"):  # 3 steps do not tile 64 rows
        rm.field_render_cuda(shared, per_image, packed[:, :R * 3], z_vals[..., :3], 3)
