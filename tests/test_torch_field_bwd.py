"""K8/K9 of the PyTorch port (threedhumangan_tpu_torch/ops/raymarch_bwd.py)
and K2's noise column, plain versions on the CPU in float32, against the
JAX package: ``fused_field_render`` (interpret mode) and
``_xla_packed_render`` for the forward, ``fused_field_render_bwd``
(interpret mode) and ``jax.vjp`` of ``_xla_packed_render`` for the
backward; ``FieldRender`` against torch autograd through the port's plain
unfolded render.  Inputs drawn with numpy from a seed.  The CUDA kernels
are checked against the plain versions by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu.models.siren import init_coordconcat_siren
from threedhumangan_tpu.ops import raymarch as jrm
from threedhumangan_tpu.ops.raymarch_bwd import fused_field_render_bwd as jax_bwd
from threedhumangan_tpu_torch.models.siren import CoordConcatSiren
from threedhumangan_tpu_torch.ops import raymarch as rm
from threedhumangan_tpu_torch.ops import raymarch_bwd as rb
from threedhumangan_tpu_torch.utils.weights import neural_field_state

B, R, S = 2, 8, 4
H, G, F, NB = 16, 31, 8, 4
SCALE = 2.0 / 2.85
# JAX param-tree path -> the port's flat weight stem
STEMS = {"first_coord": "coord", "first_mod": "geo", "sigma": "sigma", "color_sine": "color",
         "color_linear": "rgb", "feature_linear": "feat"}


def _field(seed=0):
    params = init_coordconcat_siren(jax.random.PRNGKey(seed), 3, H, G, F, NB)
    field = CoordConcatSiren(3, H, G, F, NB)
    field.load_state_dict(neural_field_state(params))
    return params, field


def _inputs(seed=0, noise=False):
    rs = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    cols = [f32(0.5 * rs.randn(B, R * S, 3)) * np.float32(SCALE), f32(0.3 * rs.randn(B, R * S, G)),
            f32(np.repeat(rs.randn(B, R, 3), S, axis=1))]
    if noise:
        cols.append(f32(0.3 * rs.randn(B, R * S, 1)))
    freq = f32(0.1 * rs.randn(B, NB * H))
    phase = f32(0.1 * rs.randn(B, NB * H))
    z_vals = f32(np.sort(rs.uniform(size=(B, R, S)) + 1.0, axis=-1))
    g_out = f32(rs.randn(B, R, F + 3))
    g_depth = f32(rs.randn(B, R, 1))
    return np.concatenate(cols, -1), freq, phase, z_vals, g_out, g_depth


def _jax_grads_flat(dp):
    out = {}
    for k, stem in STEMS.items():
        out["w_" + stem], out["b_" + stem] = dp[k]["w"], dp[k]["b"]
    for i, layer in enumerate(dp["network"]):
        out[f"w_net{i}"], out[f"b_net{i}"] = layer["w"], layer["b"]
    return {k: np.asarray(v) for k, v in out.items()}


def test_pack_field_inputs_noise_column():
    rs = np.random.RandomState(0)
    t = lambda *s: torch.as_tensor(rs.randn(*s).astype(np.float32))
    pts, geo, dirs, noise = t(2, 5, 3), t(2, 5, 31), t(2, 5, 3), t(2, 5, 1)
    got = rm.pack_field_inputs(pts, geo, dirs, SCALE, noise=noise).numpy()
    ref = np.asarray(jrm.pack_field_inputs(*(jnp.asarray(x.numpy()) for x in (pts, geo, dirs)),
                                           SCALE, noise=jnp.asarray(noise.numpy())))
    assert got.shape == (2, 5, rm.INPUT_PACK + 1)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("white_back,last_back", [(True, False), (False, True)])
def test_plain_field_noise_column_matches_jax(white_back, last_back):
    params, field = _field(1)
    packed, freq, phase, z_vals, _, _ = _inputs(1, noise=True)
    t = torch.as_tensor
    with torch.no_grad():
        out, depth = rm.fused_field_render(field, t(packed), t(freq), t(phase), t(z_vals), S,
                                           white_back, last_back, torch.float32, exact_sin=True)
    j = jnp.asarray
    k_out, k_depth = jrm.fused_field_render(
        params, j(packed), j(freq), j(phase), j(z_vals), num_steps=S, tile_rays=4,
        white_back=white_back, last_back=last_back, compute_dtype=jnp.float32,
        interpret=True, exact_sin=True, fold_film=True, step_pack=2)
    # the folded form's reduction order (tests/test_raymarch.py:426)
    np.testing.assert_allclose(out.numpy(), np.asarray(k_out), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), np.asarray(k_depth), rtol=2e-3, atol=1e-4)
    x_out, x_depth = jrm._xla_packed_render(params, j(packed), j(freq), j(phase), j(z_vals), S,
                                            white_back, last_back, jnp.float32, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(x_out), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(depth.numpy(), np.asarray(x_depth), rtol=2e-4, atol=2e-5)
    # the unfolded plain render is the same function
    with torch.no_grad():
        u_out, u_depth = rb.field_render_unfolded(field, t(packed), t(freq), t(phase), t(z_vals),
                                                  S, white_back, last_back, exact_sin=True)
    np.testing.assert_allclose(u_out.numpy(), np.asarray(x_out), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(u_depth.numpy(), np.asarray(x_depth), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("white_back,last_back,noise,exact_sin", [
    (True, False, False, True), (False, True, True, True),
    (True, False, True, False), (False, True, False, False)])
def test_plain_bwd_matches_jax_kernel_and_vjp(white_back, last_back, noise, exact_sin):
    params, field = _field(2)
    packed, freq, phase, z_vals, g_out, g_depth = _inputs(2, noise=noise)
    t = torch.as_tensor
    grads, d_freq, d_phase = rb.fused_field_render_bwd(
        rb.flat_weights(field), t(packed), t(freq), t(phase), t(z_vals), t(g_out), t(g_depth),
        S, white_back, last_back, torch.float32, exact_sin)
    j = jnp.asarray
    dp_k, df_k, dph_k = jax_bwd(params, j(packed), j(freq), j(phase), j(z_vals), j(g_out),
                                j(g_depth), num_steps=S, tile_rays=4, white_back=white_back,
                                last_back=last_back, compute_dtype=jnp.float32, interpret=True,
                                exact_sin=exact_sin)

    def xla(p, f, ph):
        return jrm._xla_packed_render(p, j(packed), f, ph, j(z_vals), S, white_back, last_back,
                                      jnp.float32, exact_sin)

    _, vjp_fn = jax.vjp(xla, params, j(freq), j(phase))
    dp_x, df_x, dph_x = vjp_fn((j(g_out), j(g_depth)))
    # as tests/test_raymarch.py::test_pallas_bwd_matches_xla_vjp
    for dp, df, dph in ((dp_k, df_k, dph_k), (dp_x, df_x, dph_x)):
        ref = _jax_grads_flat(dp)
        assert set(ref) == set(grads)
        for k in ref:
            np.testing.assert_allclose(grads[k].numpy(), ref[k], rtol=2e-4, atol=2e-5, err_msg=k)
        np.testing.assert_allclose(d_freq.numpy(), np.asarray(df), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(d_phase.numpy(), np.asarray(dph), rtol=2e-4, atol=2e-5)


def test_backward_tables_saturated_rays_stay_finite():
    """The division-free recurrence: a fully opaque first sample gives
    alpha = 1, where A_s / (1 - a_s) would be 0/0."""
    sigma = torch.tensor([[[1e4, 1.0, 2.0, 0.5]]])
    z = torch.tensor([[[1.0, 1.1, 1.2, 1.3]]])
    coef, dsig = rb.backward_tables(sigma, torch.ones(1, 1, 4), z, torch.ones(1, 1, 3),
                                    torch.ones(1, 1, 1), True, False)
    assert torch.isfinite(coef).all() and torch.isfinite(dsig).all()


@pytest.mark.parametrize("noise,last_back", [(False, False), (True, True)])
def test_field_render_grads_match_autograd_through_unfolded(noise, last_back):
    _, field = _field(3)
    packed, freq, phase, z_vals, g_out, g_depth = map(torch.as_tensor, _inputs(3, noise=noise))
    kw = dict(white_back=not last_back, last_back=last_back, compute_dtype=torch.float32,
              exact_sin=True)

    def run(fn):
        field.zero_grad()
        fr, ph = freq.clone().requires_grad_(), phase.clone().requires_grad_()
        out, depth = fn(field, packed, fr, ph, z_vals, S, **kw)
        ((out * g_out).sum() + (depth * g_depth).sum()).backward()
        return [p.grad.clone() for p in field.parameters()] + [fr.grad, ph.grad], out.detach()

    got, out_k = run(rb.field_render_trainable)
    ref, out_u = run(rb.field_render_unfolded)
    # folded forward vs unfolded: reduction order only
    torch.testing.assert_close(out_k, out_u, rtol=2e-3, atol=1e-4)
    for (name, _), a, b in zip(list(field.named_parameters()) + [("freq", 0), ("phase", 0)],
                               got, ref):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5, msg=name)


def test_bwd_cpu_path_launches_no_kernel():
    _, field = _field(4)
    packed, freq, phase, z_vals, g_out, g_depth = map(torch.as_tensor, _inputs(4))
    rb.fused_field_render_bwd(rb.flat_weights(field), packed, freq, phase, z_vals, g_out, g_depth,
                              S, compute_dtype=torch.float32)
    assert (rb.launches_stats, rb.launches_bwd, rb.launches_wgrad) == (0, 0, 0)


def test_bwd_kernel_wrappers_reject_malformed_input():
    """The CUDA entries check the packed width and the row tiling before
    they build or launch anything."""
    _, field = _field(5)
    packed, freq, phase, z_vals, g_out, _ = map(torch.as_tensor, _inputs(5))
    w = rb.flat_weights(field)
    fk, pk = rb._film_tables(freq, phase, NB)
    with pytest.raises(ValueError, match="columns"):
        rb.field_stats_cuda(w, packed[..., :-1], fk, pk, g_out, S)
    with pytest.raises(ValueError, match="divisible"):  # 32 rows do not tile 64
        rb.field_bwd_step_cuda(w, packed, fk, pk, g_out, z_vals, z_vals, S)
