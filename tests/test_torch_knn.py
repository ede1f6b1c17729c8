"""K6 of the PyTorch port (threedhumangan_tpu_torch/ops/knn.py), plain
version on the CPU, against the JAX package's 1-NN kernel in interpret mode
and its XLA search; and the two non-K1 branches of
``models.smpl.get_geo_features`` (K6, and the plain expanded-form search)
against JAX ``get_geo_features``.  Inputs drawn with numpy from a seed.  The
CUDA kernel is checked against the plain version by chip_smoke.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu.models.smpl import get_geo_features as jax_get_geo_features
from threedhumangan_tpu.ops import knn as jknn
from threedhumangan_tpu_torch.models.smpl import get_geo_features
from threedhumangan_tpu_torch.ops import knn

t = torch.as_tensor


def _cloud(seed, B, P, V, duplicate=False):
    rs = np.random.RandomState(seed)
    pts = rs.randn(B, P, 3).astype(np.float32)
    verts = rs.randn(B, V // 2 if duplicate else V, 3).astype(np.float32)
    if duplicate:  # every vertex twice, half a mesh apart: exact ties
        verts = np.concatenate([verts, verts], 1)
    return pts, verts


def _jax_nn(pts, verts):
    d, i = jknn.nn_points_pallas(jnp.asarray(pts), jnp.asarray(verts), tile_p=32, v_chunk=16,
                                 interpret=True)
    return np.asarray(d), np.asarray(i)


def test_plain_nn_matches_jax_kernel():
    pts, verts = _cloud(0, 2, 100, 50)
    d, i = knn.nn_points(t(pts), t(verts))
    assert d.shape == i.shape == (2, 100, 1) and i.dtype == torch.int32
    jd, ji = _jax_nn(pts, verts)
    # as tests/test_ops.py::test_nn_pallas_matches_bruteforce
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-4, atol=1e-5)
    full = ((pts[:, :, None] - verts[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i.numpy()[..., 0], full.argmin(-1))


def test_plain_nn_tie_keeps_lowest_index():
    """Duplicated vertices: the lowest index wins, as in the JAX kernel (its
    masked-iota argmin and strict-less chunk merge), also across chunks."""
    pts, verts = _cloud(1, 1, 128, 64, duplicate=True)
    _, i = knn.nn_points_plain(t(pts), t(verts), point_chunk=40)
    assert int(i.max()) < 32  # never the second copy
    np.testing.assert_array_equal(i.numpy(), _jax_nn(pts, verts)[1])


@pytest.mark.parametrize("k", [1, 3])
def test_knn_points_matches_jax(k):
    pts, verts = _cloud(2, 2, 70, 40)
    d, i = knn.knn_points(t(pts), t(verts), k=k, chunk=16)
    jd, ji = jknn.knn_points(jnp.asarray(pts), jnp.asarray(verts), k=k, chunk=16)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


def test_knn_gather_matches_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 6, 4).astype(np.float32)
    idx = rs.randint(0, 6, (2, 5, 2))
    got = knn.knn_gather(t(x), t(idx)).numpy()
    ref = jknn.knn_gather(jnp.asarray(x), jnp.asarray(idx))
    np.testing.assert_array_equal(got, np.asarray(ref))


def _rigid(rs, n):
    """Random rigid 4x4 transforms (QR rotations, small translations)."""
    M = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for k in range(n):
        M[k, :3, :3] = np.linalg.qr(rs.randn(3, 3))[0]
        M[k, :3, 3] = 0.3 * rs.randn(3)
    return M


def _geo_inputs(seed, B=2, P=96, V=200, J=24):
    rs = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    logits = 2.0 * rs.randn(B, V, J)
    return (f32(rs.randn(B, P, 3)), f32(rs.randn(B, J, 3)), f32(rs.randn(B, V, 3)),
            f32(0.5 * rs.randn(B, V, 3)), _rigid(rs, B * J).reshape(B, J, 4, 4),
            f32(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)))


@pytest.mark.parametrize("use_pallas_knn,legacy_mode", [(True, False), (True, True), (False, True)])
def test_get_geo_features_knn_branches_match_jax(monkeypatch, use_pallas_knn, legacy_mode):
    """The torch branch of get_geo_features with K6's plain version or the
    expanded-form search, against the JAX branch of the same flags (its
    Pallas 1-NN in interpret mode) and against the port's K1 path, at the
    tolerance of tests/test_geo_kernel.py."""
    args = _geo_inputs(4)
    monkeypatch.setattr(jknn, "nn_points_pallas", functools.partial(
        jknn.nn_points_pallas, tile_p=32, v_chunk=16, interpret=True))
    got = get_geo_features(*map(t, args), legacy_mode=legacy_mode,
                           use_pallas_knn=use_pallas_knn, use_pallas_geo=False).numpy()
    assert got.shape == (2, 96, 31)
    ref = jax_get_geo_features(*map(jnp.asarray, args), legacy_mode=legacy_mode,
                               use_pallas_knn=use_pallas_knn)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=2e-5)
    k1 = get_geo_features(*map(t, args), legacy_mode=legacy_mode).numpy()
    np.testing.assert_allclose(got, k1, atol=2e-5, rtol=2e-5)


def test_nn_cpu_path_launches_no_kernel():
    pts, verts = _cloud(5, 1, 20, 10)
    knn.nn_points(t(pts), t(verts))
    get_geo_features(*map(t, _geo_inputs(5, B=1, P=16, V=20)), use_pallas_geo=False)
    assert knn.launches == 0


def test_nn_kernel_wrapper_rejects_malformed_input():
    """The CUDA entry checks device, dtype, layout and shape before it
    builds or launches anything."""
    pts, verts = map(t, _cloud(6, 1, 16, 8))
    meta = torch.empty(1, 4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        knn.nn_points(meta, meta)
    with pytest.raises(ValueError, match="float32"):
        knn.nn_points_cuda(pts.double(), verts)
    with pytest.raises(ValueError, match="contiguous"):
        knn.nn_points_cuda(pts, verts.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        knn.nn_points_cuda(pts, verts[..., :2].contiguous())
