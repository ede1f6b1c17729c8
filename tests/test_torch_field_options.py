"""The generator's field options in the PyTorch port against the JAX
package, on the CPU in float32 with the exact sine: ``ray_integration``
(both density clamps, nerf noise, ``fill_mode``), ``sample_pdf``, the camera
helpers, ``render`` on the XLA field path (``pallas_field=False``, the
softplus clamp, hierarchical sampling, nerf noise at eval on either path),
and the gradients of the remat backward (``pallas_field_bwd=False``) and
of the XLA path in training.

The JAX package draws its randomness from keys inside its functions; the
tests rebuild those draws with ``jax.random`` from the same keys and hand
the port the same tensors (``draws``).  The JAX forwards run under
``jax.jit`` with meta closed over.  The field's density bias is set to 0.5
on both sides, so that a body renders at these random weights."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_field_bwd import S, _field, _inputs, _jax_grads_flat
from threedhumangan_tpu import configs
from threedhumangan_tpu.models import generator as jgen
from threedhumangan_tpu.models import volume_rendering as jvr
from threedhumangan_tpu.ops import raymarch as jrm
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models import generator as gen
from threedhumangan_tpu_torch.models import volume_rendering as vr
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.ops import raymarch_bwd as rb
from threedhumangan_tpu_torch.utils.weights import from_jax_params

T = lambda a: torch.as_tensor(np.array(a))
J = jnp.asarray


def setup(extra, B=2, seed=0, sigma_bias=0.5):
    """NANO meta with ``extra``, the same weights on both sides (the field's
    density bias ``sigma_bias``), the port's conditions (camera and the
    plain K7) handed to both, and latents."""
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
    meta.update({"nerf_noise": 0, "perturb_rays": False, "fast_math": False, **extra})
    params, state = jgen.init_generator(jax.random.PRNGKey(seed), meta)
    if sigma_bias is not None:
        params["neural_field"]["sigma"]["b"] = jnp.full_like(params["neural_field"]["sigma"]["b"],
                                                             sigma_bias)
    g = gen.Map3DGenerator(meta)
    from_jax_params(params, state, g)
    g.eval()
    smpl = synthetic_smpl_model(num_verts=96, num_faces=160)
    batch = next(ds.iterate_batches(ds.SyntheticSHHQDataset(smpl_model=smpl, **meta), B,
                                    shuffle=False))
    rs = np.random.RandomState(seed)
    h, v = (T(rs.uniform(-0.3, 0.3, B).astype(np.float32)) for _ in range(2))
    cond = get_preprocessor(meta, smpl).forward_with_rotation(ds.to_tensors(batch, "cpu"), h, v,
                                                              torch.zeros(B))
    jcond = {k: J(x.numpy()) for k, x in cond.items()}
    z = rs.randn(B, meta["latent_dim"]).astype(np.float32)
    return meta, params, state, g, cond, jcond, z


def jax_render_draws(meta, rng, B):
    """The draws of JAX ``render`` from ``rng`` (``generator.py:290-399``):
    the perturbation, the nerf noise of the final integration, and under
    hierarchical sampling the coarse pass's noise and the pdf uniforms."""
    R, S_ = meta["render_width"] * meta["render_height"], meta["num_steps"]
    k_transform, k_noise = jax.random.split(rng)
    k_perturb, _ = jax.random.split(k_transform)
    d = {"perturb": jax.random.uniform(k_perturb, (B, R, S_, 1))}
    steps = S_
    if meta.get("hierarchical_sample", False):
        k_noise, k_hier, k_pdf = jax.random.split(k_noise, 3)
        d["hier_noise"] = jax.random.normal(k_hier, (B, R, S_, 1))
        d["pdf"] = jax.random.uniform(k_pdf, (B * R, S_))
        steps = 2 * S_
    d["noise"] = jax.random.normal(k_noise, (B, R, steps, 1))
    return {k: T(v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# volume rendering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clamp,fill,noise,back", [
    ("relu", None, True, "last"), ("softplus", None, True, "white"),
    ("relu", "debug", False, None), ("softplus", "weight", True, "last")])
def test_ray_integration_matches_jax(clamp, fill, noise, back):
    rs = np.random.RandomState(0)
    B, R, S_, C = 2, 6, 8, 5
    field = rs.randn(B, R, S_, C + 1).astype(np.float32)
    field[..., -1] *= 8.0  # sigmas on both sides of softplus's threshold of 20
    field[0, 0, :, -1] = 30.0
    z = np.sort(rs.uniform(1.0, 2.0, (B, R, S_, 1)), axis=2).astype(np.float32)
    key = jax.random.PRNGKey(1)
    kw = dict(last_back=back == "last", white_back=back == "white", clamp_mode=clamp,
              fill_mode=fill)
    ref = jvr.ray_integration(J(field), J(z), noise_std=0.7, rng=key if noise else None, **kw)
    draw = T(jax.random.normal(key, (B, R, S_, 1))) if noise else None
    got = vr.ray_integration(T(field), T(z), noise_std=0.7, noise=draw, **kw)
    for a, b in zip(got, ref):  # features, depth, weights
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    if noise:  # a generator draws the same shape
        drawn = vr.ray_integration(T(field), T(z), noise_std=0.7,
                                   generator=torch.Generator().manual_seed(0), **kw)
        assert drawn[0].shape == got[0].shape and torch.isfinite(drawn[0]).all()


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf_matches_jax(det):
    rs = np.random.RandomState(2)
    N_, M, n = 64, 7, 9
    bins = np.sort(rs.uniform(0.0, 3.0, (N_, M + 1)), axis=1).astype(np.float32)
    weights = rs.uniform(0.0, 1.0, (N_, M)).astype(np.float32)
    weights[:4] = 0.0  # an empty ray: the uniform pdf of eps
    weights[4:8, 2:] = 0.0
    key = jax.random.PRNGKey(3)
    ref = jvr.sample_pdf(J(bins), J(weights), n, rng=key, det=det)
    u = None if det else T(jax.random.uniform(key, (N_, n)))
    got = vr.sample_pdf(T(bins), T(weights), n, u=u, det=det)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_camera_helpers_match_jax_pointwise():
    rs = np.random.RandomState(4)
    origin = rs.randn(3, 3).astype(np.float32)
    fwd = -origin
    np.testing.assert_allclose(vr.create_cam2world_matrix(T(fwd), T(origin)).numpy(),
                               np.asarray(jvr.create_cam2world_matrix(J(fwd), J(origin))),
                               rtol=1e-5, atol=1e-6)
    rays = jax.jit(lambda: jvr.get_initial_rays_trig(2, 5, 12.0, (8, 4), 0.8, 1.2))()
    for a, b in zip(vr.get_initial_rays_trig(2, 5, 12.0, (8, 4), 0.8, 1.2), rays):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    # a camera at the means (mode None) and the perturbation of the JAX key
    pts, z, dirs = vr.get_initial_rays_trig(2, 5, 12.0, (8, 4), 0.8, 1.2)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda *a: jvr.transform_sampled_points(
        *a, key, mode=None, h_mean=0.3, v_mean=1.2, perturb=True))(J(pts), J(z), J(dirs))
    u = T(jax.random.uniform(jax.random.split(key)[0], z.shape))
    got = vr.transform_sampled_points(pts, z, dirs, perturb=True, perturb_u=u, mode=None,
                                      h_mean=0.3, v_mean=1.2)
    for a, b in zip(got, ref[:4]):  # points, z_vals, dirs, ray origins
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("mode", ["uniform", "normal", "gaussian", "truncated_gaussian",
                                  "spherical_uniform", "hybrid"])
def test_camera_sampling_statistics_match_jax(mode):
    """The draws differ (torch and JAX generators), so their statistics are
    compared: each angle's mean and standard deviation within 6 standard
    errors of JAX's over 20,000 cameras, the ranges, and |origin| = r.  The
    hybrid mode flips one coin a call: each of 40 calls is wholly uniform
    (at twice the spread) or wholly normal, and both occur."""
    hs, vs, hm, vm, r = 0.3, 0.2, 1.4, 1.7, 2.5
    g = torch.Generator().manual_seed(0)
    if mode == "hybrid":
        kinds = []
        for i in range(40):
            _, _, theta = vr.sample_camera_positions(2000, r, hs, vs, hm, vm, mode, g)
            dev = (theta - hm).abs().max() / hs
            std = float(theta.std()) / hs
            kinds.append("uniform" if dev <= 2.0 and abs(std - 4 / math.sqrt(12)) < 0.06
                         else "normal" if dev > 2.0 and abs(std - 1.0) < 0.06 else "mixed")
        assert "mixed" not in kinds and 8 <= kinds.count("uniform") <= 32, kinds
        return
    n = 20000
    origin, phi, theta = vr.sample_camera_positions(n, r, hs, vs, hm, vm, mode, g)
    jo, jphi, jtheta = jvr.sample_camera_positions(jax.random.PRNGKey(6), n, r, hs, vs, hm, vm,
                                                   mode)
    np.testing.assert_allclose(origin.norm(dim=-1).numpy(), r, rtol=1e-5)
    for a, b in ((theta, jtheta), (phi, jphi)):
        a, b = a.numpy()[:, 0].astype(np.float64), np.asarray(b)[:, 0].astype(np.float64)
        se = b.std() / math.sqrt(n)
        assert abs(a.mean() - b.mean()) < 6 * math.sqrt(2) * se
        assert abs(a.std() - b.std()) < 6 * math.sqrt(2) * se  # ~ sd/sqrt(2n) for the sd
        assert a.min() >= b.min() - 0.05 * b.std() or mode in ("normal", "gaussian")
        assert a.max() <= b.max() + 0.05 * b.std() or mode in ("normal", "gaussian")
    if mode == "truncated_gaussian":
        assert float((theta - hm).abs().max()) <= 2 * hs + 1e-6


# ---------------------------------------------------------------------------
# render on the XLA field path
# ---------------------------------------------------------------------------


RENDER_CASES = {
    "xla": dict(pallas_field=False),
    "xla_softplus_noise": dict(pallas_field=False, clamp_mode="softplus", nerf_noise=0.5),
    "kernels_noise": dict(nerf_noise=0.5, perturb_rays=True),
    "hierarchical": dict(hierarchical_sample=True),
    "hierarchical_noise_last_back": dict(hierarchical_sample=True, nerf_noise=0.5,
                                         perturb_rays=True, last_back=True),
    "hierarchical_no_modulation": dict(hierarchical_sample=True, disable_modulation=True,
                                       white_back=True),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_options_match_jax(case):
    """The XLA path against JAX's (pallas_field False there, by default):
    the same unfolded SIREN and integration, rtol 1e-4 / atol 1e-5 on the
    render and depth (hierarchical sampling moves a sample where the two
    cdfs round differently at a bin edge; none does at these inputs); the
    synthesis after it as tests/test_torch_slice.py holds it.  On the
    kernels' path (nerf noise at eval) the folded render, as the slice."""
    meta, params, state, g, cond, jcond, z = setup(RENDER_CASES[case])
    rng = jax.random.PRNGKey(7)
    fn = jax.jit(lambda p, s, zz, c: jgen.generator_forward(p, s, zz, c, rng, meta,
                                                            with_depth=True)[0])
    ref = {k: np.asarray(v) for k, v in fn(params, state, J(z), jcond).items()}
    got = gen.generator_forward(g, T(z), cond, meta, with_depth=True,
                                draws=jax_render_draws(meta, rng, 2))
    tol = (2e-3, 2e-4) if case.startswith("kernels") else (1e-4, 1e-5)
    for k in ("rgbs_render", "depths"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=tol[0], atol=tol[1], err_msg=k)
    np.testing.assert_allclose(got["rgbs"].numpy(), ref["rgbs"], rtol=2e-2, atol=2e-3)
    assert float(np.std(ref["rgbs_render"])) > 1e-3  # a body rendered


def test_hierarchical_takes_k1_then_k6(monkeypatch):
    """The coarse geo features on K1 (``pallas_geo``), the fine ones through
    torch around K6 (JAX passes only ``use_pallas_knn`` there): one call of
    each plain version a batch, and no field kernel."""
    from threedhumangan_tpu_torch.ops import geo, knn
    from threedhumangan_tpu_torch.ops import raymarch as rm

    calls = []
    for mod, name in ((geo, "geo_features_plain"), (knn, "nn_points_plain"),
                      (rm, "field_render_plain"), (rm, "field_render_unfolded_plain")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _o=orig, **k: calls.append(_n)
                            or _o(*a, **k))
    meta, _, _, g, cond, _, z = setup(dict(hierarchical_sample=True))
    out = gen.generator_forward(g, T(z), cond, meta, torch.Generator().manual_seed(0))
    assert torch.isfinite(out["rgbs"]).all()
    assert calls == ["geo_features_plain", "nn_points_plain"]


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fold_film,noise", [(True, False), (False, True)])
def test_remat_backward_matches_jax_grad(fold_film, noise):
    """``pallas_field_bwd=False``: the K2 (folded) or K4 forward and autograd
    through the unfolded render recomputed, against ``jax.grad`` through
    JAX's ``fused_field_render_trainable(pallas_bwd=False)`` (its Pallas
    forward in interpret mode, the vjp of ``_xla_packed_render``): the
    gradient is the unfolded function's in both, rtol 2e-4 / atol 2e-5 as
    tests/test_torch_field_bwd.py holds K8/K9."""
    params, field = _field(6)
    packed, freq, phase, z_vals, g_out, g_depth = _inputs(6, noise=noise)
    kw = dict(white_back=not noise, last_back=noise)

    def jloss(p, f, ph):
        out, depth = jrm.fused_field_render_trainable(
            p, J(packed), f, ph, J(z_vals), num_steps=S, tile_rays=4, compute_dtype=jnp.float32,
            interpret=True, exact_sin=True, pallas_bwd=False, fold_film=fold_film, step_pack=2,
            **kw)
        return jnp.sum(out * J(g_out)) + jnp.sum(depth * J(g_depth))

    dp, df, dph = jax.grad(jloss, argnums=(0, 1, 2))(params, J(freq), J(phase))
    fr, ph = T(freq).requires_grad_(), T(phase).requires_grad_()
    out, depth = rb.field_render_trainable(field, T(packed), fr, ph, T(z_vals), S,
                                           compute_dtype=torch.float32, exact_sin=True,
                                           fold_film=fold_film, pallas_bwd=False, **kw)
    ((out * T(g_out)).sum() + (depth * T(g_depth)).sum()).backward()
    ref = _jax_grads_flat(dp)
    got = rb.flat_weights(field)
    names = rb.layer_names(field)
    for name, prm in field.named_parameters():
        path, kind = name.rsplit(".", 1)
        key = f"{'w' if kind == 'weight' else 'b'}_{names[path]}"
        grad = prm.grad.t() if kind == "weight" else prm.grad
        assert key in got
        np.testing.assert_allclose(grad.numpy(), ref[key], rtol=2e-4, atol=2e-5, err_msg=key)
    np.testing.assert_allclose(fr.grad.numpy(), np.asarray(df), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ph.grad.numpy(), np.asarray(dph), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", ["hierarchical", "field_train_off"])
def test_training_render_gradients_match_jax(case):
    """The training forward's gradients on the XLA path (the field under
    ``torch.utils.checkpoint``, remat_field on as JAX's default): the
    hierarchical G step's flow through the merge (JAX
    tests/test_end_to_end.py:137-157) and ``pallas_field_train=False``,
    against ``jax.grad`` of the same loss, mean(rgbs^2) + mean(render^2),
    on each parameter group's norm (rtol 1e-3, as the D+G step tests) and
    the field's gradients pointwise (rtol 1e-3 / atol 1e-6)."""
    extra = (dict(hierarchical_sample=True, nerf_noise=0.5) if case == "hierarchical"
             else dict(pallas_field_train=False))
    meta, params, state, g, cond, jcond, z = setup(dict(extra, remat_synthesis=False))
    rng = jax.random.PRNGKey(8)

    def jloss(p):
        out, _ = jgen.generator_forward(p, state, J(z), jcond, rng, meta, train=True,
                                        pallas_ok=False)
        return jnp.mean(out["rgbs"] ** 2) + jnp.mean(out["rgbs_render"] ** 2)

    jg = jax.jit(jax.grad(jloss))(params)
    out, _ = gen.generator_forward(g, T(z), cond, meta, train=True, pallas_ok=False,
                                   draws=jax_render_draws(meta, rng, 2))
    loss = out["rgbs"].pow(2).mean() + out["rgbs_render"].pow(2).mean()
    loss.backward()
    want = from_jax_params(jg, state)
    for group in ("neural_field", "neural_field_mapping_network", "synthesis_network",
                  "synthesis_mapping_network"):
        got_n = math.sqrt(sum(float(p.grad.pow(2).sum()) for n, p in g.named_parameters()
                              if n.startswith(group) and p.grad is not None))
        want_n = math.sqrt(sum(float(want[n].pow(2).sum()) for n, _ in g.named_parameters()
                               if n.startswith(group)))
        assert want_n > 0, group
        np.testing.assert_allclose(got_n, want_n, rtol=1e-3, err_msg=group)
    for n, p in g.neural_field.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want["neural_field." + n].numpy(), rtol=1e-3,
                                   atol=1e-6, err_msg=n)
