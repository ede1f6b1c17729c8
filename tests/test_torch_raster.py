"""K7 of the PyTorch port (threedhumangan_tpu_torch/ops/rasterize.py), plain
version on the CPU, against the JAX package's Pallas tile rasterizer
(interpret mode) and its dense z-buffer, with exact face ids; the port's
dense rasterizer; duplicate and degenerate faces and the candidate cap
(tests/test_rasterizer.py); and the rasterizing half of the preprocessor
against the JAX preprocessor.  The CUDA kernel is checked against the
plain version by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu import configs
from threedhumangan_tpu.data import preprocessor as jpre
from threedhumangan_tpu.models import smpl as jsmpl
from threedhumangan_tpu.ops import rasterize as jras
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor, load_face_labels
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.ops import rasterize as ras


def _mesh(num_verts, num_faces, B=2):
    """The JAX test mesh (tests/test_rasterizer.py:87): a synthetic body with
    z spread so the z-test matters; a second, scaled copy per extra image."""
    model = jsmpl.synthetic_smpl_model(seed=3, num_verts=num_verts, num_faces=num_faces)
    v = np.asarray(model.v_template, np.float32)[None] * np.float32(1.2)
    z = 1.5 + 0.3 * (v[..., 2] - v[..., 2].min())
    vs = np.concatenate([v[..., :2], z[..., None]], -1)
    vs = np.concatenate([vs * np.float32(0.9 ** i) for i in range(B)], 0).astype(np.float32)
    return vs, np.asarray(model.faces, np.int64)


def _port(vs, faces, size, **kw):
    return [x.numpy() for x in ras.rasterize_mesh_tiled(torch.as_tensor(vs),
                                                        torch.as_tensor(faces), size, **kw)]


@pytest.mark.parametrize("num_faces,tile,kmax,k_chunk", [
    (256, 16, 256, 64),    # the JAX test's mesh
    (320, 16, 256, 128),   # tiled quads: duplicate faces, and a cap below the overlap count
    (256, 32, 640, 128)])  # the preprocessor's tile size
def test_plain_k7_matches_jax_pallas_and_dense(num_faces, tile, kmax, k_chunk):
    vs, faces = _mesh(128, num_faces)
    size = (64, 32)
    p, b, z = _port(vs, faces, size, tile=tile, max_faces_per_tile=kmax, k_chunk=k_chunk)
    jv, jf = jnp.asarray(vs), jnp.asarray(faces, jnp.int32)
    pp, bp, zp = jras.rasterize_mesh_pallas(jv, jf, size, tile=tile, max_faces_per_tile=kmax,
                                            k_chunk=k_chunk, interpret=True)
    np.testing.assert_array_equal(p, np.asarray(pp))
    cover = p >= 0
    assert cover.mean() > 0.2
    np.testing.assert_array_equal(z[cover], np.asarray(zp)[cover])
    np.testing.assert_allclose(b[cover], np.asarray(bp)[cover], rtol=0, atol=1e-6)
    if kmax >= num_faces:  # no cap: the dense z-buffer is the same function
        pd, bd, zd = jras.rasterize_mesh(jv, jf, size)
        np.testing.assert_array_equal(p, np.asarray(pd))
        np.testing.assert_allclose(z[cover], np.asarray(zd)[cover], rtol=1e-5)
        np.testing.assert_allclose(b[cover], np.asarray(bd)[cover], rtol=1e-4, atol=1e-5)


def test_port_dense_rasterizer_matches_jax_dense():
    vs, faces = _mesh(96, 160)
    size = (32, 16)
    got = [x.numpy() for x in ras.rasterize_mesh(torch.as_tensor(vs), torch.as_tensor(faces),
                                                  size, face_chunk=64)]
    ref = [np.asarray(x) for x in jras.rasterize_mesh(jnp.asarray(vs), jnp.asarray(faces), size)]
    np.testing.assert_array_equal(got[0], ref[0])
    cover = got[0] >= 0
    np.testing.assert_allclose(got[1][cover], ref[1][cover], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2][cover], ref[2][cover], rtol=1e-6)


def _stack(n, dz):
    tri = [[-0.8, -0.8], [0.8, -0.8], [0.0, 0.9]]
    verts = [[x, y, 1.0 + i * dz] for i in range(n) for x, y in tri]
    return np.asarray(verts, np.float32)[None], np.arange(3 * n).reshape(n, 3)


def test_duplicate_faces_lowest_index_wins():
    """Equal z everywhere: the lowest face wins every pixel, also across
    candidate chunks (mirrors tests/test_rasterizer.py:52 and :113)."""
    vs, faces = _stack(6, 0.0)
    p, b, _ = _port(vs, faces, (16, 16), tile=8, max_faces_per_tile=8, k_chunk=2)
    assert set(np.unique(p)) == {-1, 0}
    d, _, _ = [x.numpy() for x in ras.rasterize_mesh(torch.as_tensor(vs), torch.as_tensor(faces),
                                                      (16, 16), face_chunk=4)]
    np.testing.assert_array_equal(p, d)


def test_degenerate_faces_never_win():
    verts = np.asarray([[[-0.8, -0.8, 1.0], [0.8, -0.8, 1.0], [0.0, 0.9, 1.0],
                         [0.0, 0.0, 0.1]]], np.float32)
    faces = np.asarray([[0, 1, 2], [3, 3, 3]])
    p, _, _ = _port(verts, faces, (8, 8), tile=8, max_faces_per_tile=2, k_chunk=2)
    assert (p != 1).all() and (p == 0).any()


def test_truncation_cap_keeps_lowest_indices():
    """64 stacked faces, K = 8: the kept candidates are the lowest indices,
    here also the closest, so the centre picks face 0 (tests/test_rasterizer.py:134)."""
    vs, faces = _stack(64, 0.01)
    p, _, _ = _port(vs, faces, (16, 16), tile=8, max_faces_per_tile=8, k_chunk=8)
    assert ((p >= -1) & (p < 64)).all()
    assert p[0, 8, 8] == 0


def test_k7_cpu_path_launches_no_kernel():
    vs, faces = _mesh(96, 64, B=1)
    _port(vs, faces, (32, 16), tile=16)
    assert ras.launches == 0


def test_forward_rasterize_matches_jax_preprocessor():
    meta = dict(configs.extract_metadata(configs.MAP3DBN_TINY, 0))
    B = 2
    smpl = synthetic_smpl_model(num_verts=256, num_faces=512)
    batch = next(ds.iterate_batches(ds.SyntheticSHHQDataset(smpl_model=smpl, **meta), B,
                                    shuffle=False))
    rs = np.random.RandomState(0)
    h, v = (rs.uniform(-0.3, 0.3, B).astype(np.float32) for _ in range(2))
    r = np.zeros(B, np.float32)
    got = get_preprocessor(meta, smpl).forward_with_rotation(
        ds.to_tensors(batch, "cpu"), *map(torch.as_tensor, (h, v, r)))
    jp = jpre.get_preprocessor(meta, smpl_model=jsmpl.synthetic_smpl_model(num_verts=256, num_faces=512))
    ref = jp.forward_with_rotation({k: jnp.asarray(x) for k, x in batch.items()},
                                   *map(jnp.asarray, (h, v, r)))
    seg = got["rasterized_segments"].numpy()
    jseg = np.asarray(ref["rasterized_segments"])
    assert seg.shape == (B, meta["gen_height"], meta["gen_width"]) and seg.dtype == np.int32
    assert (seg > 1).mean() > 0.05  # the body covers part of the picture
    np.testing.assert_array_equal(seg, jseg)
    np.testing.assert_allclose(got["rasterized_semantics"].numpy(),
                               np.asarray(ref["rasterized_semantics"]), rtol=0, atol=1e-6)


def test_face_labels_match_jax():
    faces = synthetic_smpl_model(num_verts=6890, num_faces=13776).faces
    np.testing.assert_array_equal(load_face_labels(faces), jpre.load_face_labels(faces))
    small = np.zeros((100, 3), np.int64)
    np.testing.assert_array_equal(load_face_labels(small), jpre.load_face_labels(small))
