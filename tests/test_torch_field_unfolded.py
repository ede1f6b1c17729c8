"""K4 and K5 of the PyTorch port (threedhumangan_tpu_torch/ops/raymarch.py),
plain versions on the CPU in float32 with the exact sine, against the JAX
package's unfolded field kernel (``fused_field_render(fold_film=False)``)
and geo-fused kernel (``fused_field_render_geo``) in interpret mode; plus
``FieldRender`` with the K4 forward against autograd through the plain
unfolded render.  Inputs drawn with numpy from a seed.  The CUDA kernels
are checked against the plain versions by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu.models.siren import init_coordconcat_siren
from threedhumangan_tpu.ops import raymarch as jrm
from threedhumangan_tpu_torch.models.siren import CoordConcatSiren
from threedhumangan_tpu_torch.ops import raymarch as rm
from threedhumangan_tpu_torch.ops import raymarch_bwd as rb
from threedhumangan_tpu_torch.ops.geo import build_vertex_features
from threedhumangan_tpu_torch.utils.weights import neural_field_state

B, R, S = 2, 8, 4
H, G, F, NB = 16, 31, 8, 4
J, V = 24, 96
SCALE = 2.0 / 2.85
TOL = dict(rtol=2e-4, atol=2e-5)      # tests/test_raymarch.py:46
GEO_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_raymarch.py:224
t, j = torch.as_tensor, jnp.asarray


def _field(seed=0, n_blocks=NB):
    params = init_coordconcat_siren(jax.random.PRNGKey(seed), 3, H, G, F, n_blocks)
    field = CoordConcatSiren(3, H, G, F, n_blocks)
    field.load_state_dict(neural_field_state(params))
    return params, field


def _inputs(seed=0, noise=False, n_blocks=NB):
    rs = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    cols = [f32(0.5 * rs.randn(B, R * S, 3)) * np.float32(SCALE), f32(0.3 * rs.randn(B, R * S, G)),
            f32(rs.randn(B, R * S, 3))]  # directions vary along a ray: no folded contract here
    if noise:
        cols.append(f32(0.5 * rs.randn(B, R * S, 1)))
    freq = f32(0.1 * rs.randn(B, n_blocks * H))
    phase = f32(0.1 * rs.randn(B, n_blocks * H))
    z_vals = f32(np.sort(rs.uniform(size=(B, R, S)) + 1.0, axis=-1))
    return np.concatenate(cols, -1), freq, phase, z_vals


def _jax_unfolded(params, packed, freq, phase, z_vals, **kw):
    out, depth = jrm.fused_field_render(
        params, j(packed), j(freq), j(phase), j(z_vals), num_steps=S, tile_rays=4,
        compute_dtype=jnp.float32, interpret=True, exact_sin=True, **kw)
    return np.asarray(out), np.asarray(depth)


@pytest.mark.parametrize("white_back,last_back,noise,march_loop", [
    (True, False, False, False), (False, True, True, False), (True, False, True, True),
    (False, False, False, True)])
def test_plain_unfolded_matches_jax_kernel(white_back, last_back, noise, march_loop):
    """The JAX kernel in either march mode against the port's one K4."""
    params, field = _field(1)
    packed, freq, phase, z_vals = _inputs(1, noise)
    kw = dict(white_back=white_back, last_back=last_back)
    with torch.no_grad():
        out, depth = rm.fused_field_render(field, t(packed), t(freq), t(phase), t(z_vals), S,
                                           compute_dtype=torch.float32, exact_sin=True,
                                           fold_film=False, **kw)
    k_out, k_depth = _jax_unfolded(params, packed, freq, phase, z_vals, fold_film=False,
                                   march_loop=march_loop, **kw)
    np.testing.assert_allclose(out.numpy(), k_out, **TOL)
    np.testing.assert_allclose(depth.numpy(), k_depth, **TOL)


def test_single_block_field_takes_k4(monkeypatch):
    """A field with one trunk block renders unfolded even with fold_film on
    (JAX raymarch.py:348), as the JAX package routes it."""
    params, field = _field(2, n_blocks=1)
    packed, freq, phase, z_vals = _inputs(2, n_blocks=1)
    calls = []
    orig = rm.field_render_unfolded_plain
    monkeypatch.setattr(rm, "field_render_unfolded_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    with torch.no_grad():
        out, depth = rm.fused_field_render(field, t(packed), t(freq), t(phase), t(z_vals), S,
                                           white_back=True, compute_dtype=torch.float32,
                                           exact_sin=True)
    assert calls == [1]
    k_out, k_depth = _jax_unfolded(params, packed, freq, phase, z_vals, white_back=True)
    np.testing.assert_allclose(out.numpy(), k_out, **TOL)
    np.testing.assert_allclose(depth.numpy(), k_depth, **TOL)


@pytest.mark.parametrize("noise,last_back", [(False, False), (True, True)])
def test_field_render_k4_forward_grads_match_autograd(noise, last_back):
    """FieldRender with fold_film=False: the K4 forward is the unfolded
    render, and the K8/K9 backward gives autograd's gradients through it."""
    _, field = _field(3)
    packed, freq, phase, z_vals = map(t, _inputs(3, noise))
    rs = np.random.RandomState(13)
    g_out, g_depth = t(rs.randn(B, R, F + 3).astype(np.float32)), t(
        rs.randn(B, R, 1).astype(np.float32))
    kw = dict(white_back=not last_back, last_back=last_back, compute_dtype=torch.float32,
              exact_sin=True)

    def run(fn, **extra):
        field.zero_grad()
        fr, ph = freq.clone().requires_grad_(), phase.clone().requires_grad_()
        out, depth = fn(field, packed, fr, ph, z_vals, S, **kw, **extra)
        ((out * g_out).sum() + (depth * g_depth).sum()).backward()
        return [p.grad.clone() for p in field.parameters()] + [fr.grad, ph.grad], out.detach()

    got, out_k = run(rb.field_render_trainable, fold_film=False)
    ref, out_u = run(rb.field_render_unfolded)
    torch.testing.assert_close(out_k, out_u, **TOL)
    for (name, _), a, b in zip(list(field.named_parameters()) + [("freq", 0), ("phase", 0)],
                               got, ref):
        torch.testing.assert_close(a, b, msg=name, **TOL)


# ---------------------------------------------------------------------------
# K5: the geo-fused render
# ---------------------------------------------------------------------------


def _body(seed):
    """Posed vertices, T-pose vertices, joints, FK and skinning weights of
    one synthetic body per image (tests/test_raymarch.py:178-196)."""
    rs = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    verts, tpose, skel = (f32(0.5 * rs.randn(B, n, 3)) for n in (V, V, J))
    fk = np.tile(np.eye(4, dtype=np.float32), (B, J, 1, 1))
    for b in range(B):
        for k in range(J):
            fk[b, k, :3, :3] = np.linalg.qr(rs.randn(3, 3))[0]
            fk[b, k, :3, 3] = 0.3 * rs.randn(3)
    logits = rs.randn(B, V, J)
    lbs = f32(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    return verts, tpose, skel, fk, lbs


def _geo_case(seed, noise):
    rs = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    cols = [f32(0.5 * rs.randn(B, R * S, 3)), f32(rs.randn(B, R * S, 3))]
    if noise:
        cols.append(f32(0.5 * rs.randn(B, R * S, 1)))
    freq, phase = (f32(0.1 * rs.randn(B, NB * H)) for _ in range(2))
    z_vals = f32(np.sort(rs.uniform(size=(B, R, S)) + 1.0, axis=-1))
    verts, tpose, skel, fk, lbs = _body(seed + 100)
    vfeat = build_vertex_features(t(tpose), t(fk), t(lbs)).numpy()
    return np.concatenate(cols, -1), freq, phase, z_vals, verts, vfeat, skel


@pytest.mark.parametrize("legacy_mode,noise", [(False, False), (True, True), (True, False)])
def test_plain_geo_fused_matches_jax_kernel(legacy_mode, noise):
    params, field = _field(4)
    packed, freq, phase, z_vals, verts, vfeat, skel = _geo_case(4, noise)
    kw = dict(white_back=True, legacy_mode=legacy_mode)
    with torch.no_grad():
        out, depth = rm.fused_field_render_geo(
            field, t(packed), t(freq), t(phase), t(z_vals), t(verts), t(vfeat), t(skel), S,
            SCALE, compute_dtype=torch.float32, exact_sin=True, **kw)
    k_out, k_depth = jrm.fused_field_render_geo(
        params, j(packed), j(freq), j(phase), j(z_vals), j(verts), j(vfeat), j(skel),
        num_steps=S, input_scaler=SCALE, tile_rays=4, compute_dtype=jnp.float32,
        interpret=True, exact_sin=True, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(k_out), **GEO_TOL)
    np.testing.assert_allclose(depth.numpy(), np.asarray(k_depth), **GEO_TOL)


@pytest.mark.parametrize("legacy_mode", [False, True])
def test_geo_slab_matches_jax(legacy_mode):
    """The 31 geo columns of K5's plain version against the JAX kernel's
    ``_geo_slab`` on its padded vertex-major tables."""
    _, _, _, _, verts, vfeat, skel = _geo_case(5, False)
    pts = np.random.RandomState(6).randn(40, 3).astype(np.float32) * 0.5
    got = rm.geo_slab(t(pts), t(verts[0]), t(vfeat[0]), t(skel[0]), legacy_mode).numpy()
    pad = 128 - V
    vp = np.pad(verts[0], ((0, pad), (0, 0)), constant_values=1e6)
    ref = jrm._geo_slab(j(pts), j(vp.T), j((vp ** 2).sum(-1)[None]),
                        j(np.pad(vfeat[0], ((0, pad), (0, 0))).T), j(skel[0].T),
                        j((skel[0] ** 2).sum(-1)[None]), legacy_mode)
    assert got.shape == (40, 31)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_unfolded_and_geo_cpu_paths_launch_no_kernel():
    _, field = _field(7)
    packed, freq, phase, z_vals = map(t, _inputs(7))
    gp, gf, gph, gz, verts, vfeat, skel = map(t, _geo_case(7, False))
    with torch.no_grad():
        rm.fused_field_render(field, packed, freq, phase, z_vals, S, fold_film=False)
        rm.fused_field_render_geo(field, gp, gf, gph, gz, verts, vfeat, skel, S, SCALE)
    assert (rm.launches, rm.launches_unfolded, rm.launches_geo) == (0, 0, 0)


def test_unfolded_and_geo_wrappers_reject_malformed_input():
    """The CUDA entries check the packed width, the ray/step tiling and the
    joint count before they build or launch anything."""
    _, field = _field(8)
    packed, freq, phase, z_vals = map(t, _inputs(8))
    w = rm.flat_weights(field)
    fk, pk = rm.film_tables(freq, phase, NB)
    with pytest.raises(ValueError, match="columns"):
        rm.field_render_unfolded_cuda(w, packed[..., :-1], fk, pk, z_vals, S)
    with pytest.raises(ValueError, match="num_steps"):  # 3 steps do not tile 64 rows
        rm.field_render_unfolded_cuda(w, packed[:, :R * 3], fk, pk, z_vals[..., :3], 3)
    gp, _, _, gz, verts, vfeat, skel = map(t, _geo_case(8, False))
    with pytest.raises(ValueError, match="columns"):
        rm.field_render_geo_cuda(w, gp[..., :5], fk, pk, gz, verts, vfeat, skel, S, SCALE)
    with pytest.raises(ValueError, match="joints"):
        rm.field_render_geo_cuda(w, gp.repeat(1, 16, 1), fk, pk, gz.repeat(1, 16, 1), verts,
                                 vfeat, skel[:, :20], S, SCALE)
    with pytest.raises(ValueError, match="unsupported device"):
        m = torch.empty(1, 64, 7, device="meta")
        rm.fused_field_render_geo(field, m, freq[:1], phase[:1], z_vals[:1], verts, vfeat, skel,
                                  S, SCALE)
