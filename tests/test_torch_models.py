"""Modules of the PyTorch port without a kernel — mapping networks, bias_act,
SMPL/LBS, the synthetic dataset, the camera preprocessor, rays, the SIREN,
the feature-map resize and the weight bridge — each against its JAX
counterpart on inputs drawn with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu import configs
from threedhumangan_tpu.data import dataset as jds
from threedhumangan_tpu.data import preprocessor as jpre
from threedhumangan_tpu.models import generator as jgen
from threedhumangan_tpu.models import mapping as jmap
from threedhumangan_tpu.models import siren as jsiren
from threedhumangan_tpu.models import smpl as jsmpl
from threedhumangan_tpu.models import volume_rendering as jvr
from threedhumangan_tpu.ops.bias_act import bias_act as jax_bias_act
from threedhumangan_tpu.utils.torch_convert import convert_generator_state_dict
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data import preprocessor as pre
from threedhumangan_tpu_torch.models import generator as gen
from threedhumangan_tpu_torch.models import siren, smpl
from threedhumangan_tpu_torch.models import volume_rendering as vr
from threedhumangan_tpu_torch.ops import bias_act
from threedhumangan_tpu_torch.utils.weights import from_jax_params, neural_field_state

T = torch.as_tensor
J = jnp.asarray


def _close(got, ref, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _tiny_meta(**kw):
    meta = dict(configs.extract_metadata(configs.MAP3DBN_TINY, 0))
    meta.update(nerf_noise=0, perturb_rays=False, **kw)
    return meta


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mapping_networks_match_jax(compute_dtype):
    jd, td = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    meta = _tiny_meta()
    params, state = jgen.init_generator(jax.random.PRNGKey(0), meta)
    g = gen.Map3DGenerator(meta)
    from_jax_params(params, state, g)
    z = np.random.RandomState(0).randn(3, meta["latent_dim"]).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5) if compute_dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    freq, phase = g.neural_field_mapping_network(T(z), td)
    jfreq, jphase = jmap.apply_mapping_network(params["neural_field_mapping_network"], J(z), jd)
    _close(freq, jfreq, **tol)
    _close(phase, jphase, **tol)
    imp, styles = g.synthesis_mapping_network(T(z), td)
    jimp, jstyles = jmap.apply_two_part_mapping_network(params["synthesis_mapping_network"],
                                                        J(z), jd)
    _close(imp, jimp, **tol)
    _close(styles, jstyles, **tol)


@pytest.mark.parametrize("act", ["linear", "relu", "lrelu", "sigmoid", "swish"])
def test_bias_act_matches_jax(act):
    rs = np.random.RandomState(1)
    x, b = rs.randn(4, 5).astype(np.float32), rs.randn(5).astype(np.float32)
    _close(bias_act.bias_act(T(x), T(b), act=act, clamp=1.5),
           jax_bias_act(J(x), J(b), act=act, clamp=1.5))


def test_rotations_match_jax():
    rs = np.random.RandomState(2)
    aa = (0.7 * rs.randn(5, 3)).astype(np.float32)
    _close(smpl.batch_rodrigues(T(aa)), jsmpl.batch_rodrigues(J(aa)))
    _close(smpl.euler_angles_to_matrix_xyz(T(aa)), jsmpl.euler_angles_to_matrix_xyz(J(aa)))


def test_synthetic_smpl_and_lbs_match_jax():
    tm = smpl.synthetic_smpl_model(num_verts=96, num_faces=64)
    jm = jsmpl.synthetic_smpl_model(num_verts=96, num_faces=64)
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    np.testing.assert_array_equal(tm.parents, jm.parents)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    rs = np.random.RandomState(3)
    betas = (0.5 * rs.randn(2, 10)).astype(np.float32)
    pose = (0.3 * rs.randn(2, 24 * 3)).astype(np.float32)
    got = tm.forward(T(betas), T(pose))
    ref = jm.forward(J(betas), J(pose))
    for k in ("fk_matrices", "tpose_vertices", "vertices", "joints_shaped", "joints"):
        _close(got[k], ref[k], rtol=1e-4, atol=1e-5)


def test_synthetic_dataset_matches_jax():
    meta = _tiny_meta()
    tm = smpl.synthetic_smpl_model(num_verts=96, num_faces=64)
    jm = jsmpl.synthetic_smpl_model(num_verts=96, num_faces=64)
    got = next(ds.iterate_batches(ds.SyntheticSHHQDataset(smpl_model=tm, **meta), 2,
                                  shuffle=False))
    ref = next(jds.iterate_batches(jds.SyntheticSHHQDataset(smpl_model=jm, **meta), 2,
                                   shuffle=False))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", ["fix_body", "fix_camera"])
def test_camera_preprocessor_matches_jax(mode):
    meta = _tiny_meta(coordinate_mode=mode)
    tm = smpl.synthetic_smpl_model(num_verts=96, num_faces=64)
    batch = next(ds.iterate_batches(ds.SyntheticSHHQDataset(smpl_model=tm, **meta), 2,
                                    shuffle=False))
    if mode == "fix_camera":  # the keys the fix_camera dataset adds
        batch["tpose_vertices_shaped"] = batch["tpose_vertices"]
    rs = np.random.RandomState(4)
    h, v, r = (rs.uniform(-0.5, 0.5, 2).astype(np.float32) for _ in range(3))
    p = pre.get_preprocessor(meta)
    got = p.forward_with_rotation(ds.to_tensors(batch, "cpu"), T(h), T(v), T(r))
    jp = jpre.get_preprocessor(meta, smpl_model=jsmpl.synthetic_smpl_model(96, 64))
    jb = {k: J(x) for k, x in batch.items()}
    step = jp._forward_fix_body if mode == "fix_body" else jp._forward_fix_camera
    ref = step(jb, J(h), J(v), J(r))
    keys = (["cam2world_matrices"] if mode == "fix_body"
            else ["fk_matrices", "vertices", "skeletons_xyz"])
    for k in keys:
        _close(got[k], ref[k], rtol=1e-4, atol=1e-5)


def test_rays_and_transform_match_jax():
    rs = np.random.RandomState(5)
    focals = np.full(2, 9.5, np.float32)
    scales = np.asarray([0.9, 1.1], np.float32)
    got = vr.get_initial_rays_weak_perspective(T(focals), T(scales), 6, (8, 16), -0.5, 0.55)
    ref = jvr.get_initial_rays_weak_perspective(J(focals), J(scales), 6, (8, 16), -0.5, 0.55)
    for a, b in zip(got, ref):
        _close(a, b, rtol=1e-5, atol=2e-6)
    c2w = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    euler = rs.randn(2, 3).astype(np.float32)
    c2w[:, :3, :3] = np.asarray(jsmpl.euler_angles_to_matrix_xyz(J(euler)))
    c2w[:, :3, 3] = rs.randn(2, 3)
    tg = vr.transform_sampled_points(*got, T(c2w))
    jg = jvr.transform_sampled_points(*ref, jax.random.PRNGKey(0), cam2world_matrix=J(c2w),
                                      perturb=False)
    for a, b in zip(tg, jg[:3]):  # points, z_vals, dirs
        _close(a, b, rtol=1e-5, atol=2e-6)
    dirs = rs.randn(2, 5, 3).astype(np.float32)
    _close(vr.expand_ray_directions(T(dirs), 4), jvr.expand_ray_directions(J(dirs), 4))


@pytest.mark.parametrize("fast_math", [False, True])
def test_siren_matches_jax(fast_math):
    H, G, F, NB = 16, 31, 8, 4
    params = jsiren.init_coordconcat_siren(jax.random.PRNGKey(6), 3, H, G, F, NB)
    field = siren.CoordConcatSiren(3, H, G, F, NB)
    field.load_state_dict(neural_field_state(params))
    rs = np.random.RandomState(6)
    pts, geo, dirs = (rs.randn(2, 10, n).astype(np.float32) for n in (3, G, 3))
    freq, phase = (0.1 * rs.randn(2, NB * H).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = field(T(pts), T(freq), T(phase), T(geo), T(dirs), input_scaler=0.7,
                    fast_math=fast_math)
    ref = jsiren.apply_coordconcat_siren(params, J(pts), J(freq), J(phase), J(geo), J(dirs),
                                         input_scaler=0.7, fast_math=fast_math)
    _close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((16, 8), (64, 32)), ((96, 48), (512, 256)),
                                     ((5, 3), (11, 7))])
def test_feature_map_resize_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(7).randn(2, *src, 3).astype(np.float32)
    got = gen.resize_feature_maps(T(x), *dst)
    ref = jax.image.resize(J(x), (2, *dst, 3), method="bilinear")
    _close(got, ref, rtol=1e-5, atol=1e-5)


def test_weight_bridge_round_trip():
    """JAX params -> port modules -> port state_dict -> the JAX package's
    converter gives back the same trees, leaf for leaf."""
    meta = _tiny_meta()
    params, state = jgen.init_generator(jax.random.PRNGKey(8), meta)
    g = gen.Map3DGenerator(meta)
    from_jax_params(params, state, g)
    sd = {k: v.detach().numpy() for k, v in g.state_dict().items()}
    p2, s2 = convert_generator_state_dict(sd, meta)
    for ref_tree, got_tree in ((params, p2), (state, s2)):
        ref_leaves = jax.tree_util.tree_leaves_with_path(ref_tree)
        got_leaves = jax.tree_util.tree_leaves_with_path(got_tree)
        assert [p for p, _ in ref_leaves] == [p for p, _ in got_leaves]
        for (path, a), (_, b) in zip(ref_leaves, got_leaves):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-7, atol=0,
                                       err_msg=jax.tree_util.keystr(path))


def test_configs_are_shared_with_the_jax_package():
    """The port keeps its own copy of the configs (it imports nothing of the
    JAX package); the copy holds the same values
    (tests/test_torch_trainer.py compares the metadata and the sweeps)."""
    from threedhumangan_tpu_torch import configs as port_configs

    for name in ("MAP3DBN", "MAP3DBN512", "MAP3DBN512L", "MAP3DBN_TINY", "MAP3DBN_NANO"):
        assert getattr(port_configs, name) == getattr(configs, name)
        assert getattr(port_configs, name) is not getattr(configs, name)
    assert port_configs.extract_metadata.__module__ == "threedhumangan_tpu_torch.configs"


def test_port_init_shapes_match_jax_init():
    meta = _tiny_meta()
    params, state = jgen.init_generator(jax.random.PRNGKey(9), meta)
    mine = gen.init_generator(meta, torch.Generator().manual_seed(0), "cpu").state_dict()
    ref = from_jax_params(params, state)
    shapes = lambda sd: {k: tuple(v.shape) for k, v in sd.items()}
    assert shapes(mine) == shapes(ref)
