"""K1 of the PyTorch port (threedhumangan_tpu_torch/ops/geo.py), plain
version on the CPU, against the JAX package's geo kernel in interpret mode
and its XLA reference path (models/smpl.get_geo_features).  Inputs are drawn
with numpy from a seed and handed to both.  The CUDA kernel itself is
checked against the plain version by chip_smoke.py on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu.models.smpl import get_geo_features as jax_get_geo_features
from threedhumangan_tpu.ops.geo import build_vertex_features as jax_build_vertex_features
from threedhumangan_tpu.ops.geo import geo_features_pallas
from threedhumangan_tpu_torch.models.smpl import get_geo_features
from threedhumangan_tpu_torch.ops import geo

TOL = dict(atol=2e-5, rtol=2e-5)  # as tests/test_geo_kernel.py


def _rigid(rs, n):
    """Random invertible rigid 4x4 transforms (Rodrigues rotations)."""
    axis = rs.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True) + 1e-8
    ang = rs.uniform(-1.0, 1.0, (n, 1, 1))
    kx = np.cross(np.eye(3)[None], axis[:, None, :])
    R = np.eye(3)[None] + np.sin(ang) * kx + (1 - np.cos(ang)) * (kx @ kx)
    M = np.zeros((n, 4, 4))
    M[:, :3, :3], M[:, :3, 3], M[:, 3, 3] = R, 0.3 * rs.randn(n, 3), 1.0
    return M.astype(np.float32)


def _inputs(seed, B, P, V, J=24, duplicate=False, identity=False):
    rs = np.random.RandomState(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    points = f32(rs.randn(B, P, 3))
    verts = f32(rs.randn(B, V // 2, 3)) if duplicate else f32(rs.randn(B, V, 3))
    if duplicate:  # every vertex twice, half a mesh apart: exact ties
        verts = np.concatenate([verts, verts], 1)
    tpose = f32(0.5 * rs.randn(B, V, 3))
    skel = f32(rs.randn(B, J, 3))
    if identity:
        fk = np.broadcast_to(np.eye(4, dtype=np.float32), (B, J, 4, 4)).copy()
        lbs = np.full((B, V, J), 1.0 / J, np.float32)
    else:
        fk = _rigid(rs, B * J).reshape(B, J, 4, 4)
        logits = 2.0 * rs.randn(B, V, J)
        lbs = f32(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    return points, skel, verts, tpose, fk, lbs


def _port(args, legacy_mode=False):
    return get_geo_features(*map(torch.as_tensor, args), legacy_mode=legacy_mode).numpy()


def _jax_kernel(args, legacy_mode=False, **kw):
    points, skel, verts, tpose, fk, lbs = map(jnp.asarray, args)
    vfeat = jax_build_vertex_features(tpose, fk, lbs)
    return np.asarray(geo_features_pallas(points, verts, vfeat, skel,
                                          legacy_mode=legacy_mode, interpret=True, **kw))


@pytest.mark.parametrize("legacy_mode", [False, True])
def test_plain_geo_matches_jax_kernel_and_xla_path(legacy_mode):
    args = _inputs(0, B=2, P=96, V=200)
    got = _port(args, legacy_mode)
    assert got.shape == (2, 96, 31)
    np.testing.assert_allclose(got, _jax_kernel(args, legacy_mode), **TOL)
    ref = jax_get_geo_features(*map(jnp.asarray, args), legacy_mode=legacy_mode)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_plain_geo_tiebreak_keeps_lowest_index():
    """Duplicated vertices: the lowest index wins, as torch argmin and the
    JAX kernel do, so the gathered T-pose coords match exactly."""
    args = _inputs(1, B=1, P=128, V=64, duplicate=True, identity=True)
    got = _port(args)
    np.testing.assert_allclose(got, np.asarray(jax_get_geo_features(*map(jnp.asarray, args))),
                               **TOL)
    np.testing.assert_allclose(got, _jax_kernel(args), **TOL)
    _, idx = geo.nearest_vertex(torch.as_tensor(args[0]), torch.as_tensor(args[2]))
    assert int(idx.max()) < 32  # never the second copy


def test_plain_geo_vertex_chunk_merge():
    """Scanning the vertices in chunks (as the kernel stages them) with a
    strict-less merge gives the single-scan result bitwise, including ties
    that straddle chunk boundaries."""
    points, skel, verts, tpose, fk, lbs = _inputs(2, B=2, P=256, V=288, duplicate=True,
                                                  identity=True)
    t = lambda a: torch.as_tensor(a)
    vfeat = geo.build_vertex_features(t(tpose), t(fk), t(lbs))
    one, idx_one = geo.geo_features_plain(t(points), t(verts), vfeat, t(skel))
    many, idx_many = geo.geo_features_plain(t(points), t(verts), vfeat, t(skel),
                                            point_chunk=100, vertex_chunk=50)
    np.testing.assert_array_equal(idx_many.numpy(), idx_one.numpy())
    np.testing.assert_array_equal(many.numpy(), one.numpy())
    np.testing.assert_allclose(one.numpy(), _jax_kernel((points, skel, verts, tpose, fk, lbs),
                                                        vertex_chunks=3), **TOL)


def test_build_vertex_features_matches_jax():
    _, _, _, tpose, fk, lbs = _inputs(3, B=2, P=8, V=50)
    got = geo.build_vertex_features(*map(torch.as_tensor, (tpose, fk, lbs))).numpy()
    ref = np.asarray(jax_build_vertex_features(*map(jnp.asarray, (tpose, fk, lbs))))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_geo_cpu_path_launches_no_kernel():
    args = _inputs(4, B=1, P=32, V=40)
    before = geo.launches
    _port(args)
    assert geo.launches == before == 0


def test_geo_rejects_unsupported_device():
    meta = torch.empty(1, 4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        geo.geo_features(meta, meta, torch.empty(1, 4, 19, device="meta"),
                         torch.empty(1, 24, 3, device="meta"))


def test_geo_kernel_wrapper_rejects_malformed_input():
    """The CUDA entry checks dtype, layout and shape before it builds or
    launches anything."""
    points, skel, verts, tpose, fk, lbs = map(torch.as_tensor, _inputs(5, B=1, P=16, V=20))
    vfeat = geo.build_vertex_features(tpose, fk, lbs)
    with pytest.raises(ValueError, match="float32"):
        geo._geo_cuda(points.double(), verts, vfeat, skel, False, False)
    with pytest.raises(ValueError, match="contiguous"):
        geo._geo_cuda(points, verts, vfeat.transpose(1, 2).contiguous().transpose(1, 2),
                      skel, False, False)
    with pytest.raises(ValueError, match="24 joints"):
        geo._geo_cuda(points, verts, vfeat, skel[:, :20].contiguous(), False, False)
