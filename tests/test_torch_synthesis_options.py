"""The synthesis variants of the PyTorch port against the JAX package, on
the CPU in float32: instance norm, adaptive batch norm and the pixelwise
blocks of ``spatial_normalization='none'``, the condition-image style head
(``disable_render``), the config-level ``disable_synthesis``,
``2d_label_input`` / ``2d_latent_input`` and every feature-map resize, at
eval through ``generator_forward`` (with truncation) and in train mode
through ``SynthesisNetwork`` (outputs, the new state, gradients); the
weight bridge for every block kind; and a D+G pair through
``train_step_pair`` on each new option.  The JAX forwards run under
``jax.jit`` with meta closed over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_field_options import J, T, setup
from threedhumangan_tpu import configs
from threedhumangan_tpu.models import generator as jgen
from threedhumangan_tpu.models import synthesis as jsyn
from threedhumangan_tpu.utils.torch_convert import convert_generator_state_dict
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models import generator as gen
from threedhumangan_tpu_torch.models import synthesis as syn
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.ops import synthesis_kernel
from threedhumangan_tpu_torch.trainers.phase_trainer import init_train_state, train_step_pair
from threedhumangan_tpu_torch.utils import image
from threedhumangan_tpu_torch.utils.weights import from_jax_params, synthesis_network_state

# case -> (meta keys, the eval synthesis the JAX rule selects: K3 or per op)
EVAL_CASES = {
    "instance_norm_cubic": (dict(spatial_normalization="instance_norm",
                                 feature_map_interpolation="cubic"), "per_op"),
    "none_lanczos3": (dict(spatial_normalization="none", feature_map_interpolation="lanczos3"),
                      "per_op"),
    "adaptive_nearest": (dict(spatial_normalization="adaptive_batch_norm",
                              feature_map_interpolation="nearest"), "K3"),
    "2d_label_latent_lanczos5": (dict({"2d_label_input": True, "2d_latent_input": True},
                                      feature_map_interpolation="lanczos5"), "per_op"),
    "disable_render": (dict(disable_render=True), "K3"),
    "disable_render_no_latent": (dict(disable_render=True, spade_latent_input=False,
                                      spatial_normalization="adaptive_batch_norm"), "K3"),
    "disable_synthesis": (dict(disable_synthesis=True), None),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_eval_variant_matches_jax(case, monkeypatch):
    """``generator_forward`` at eval with truncation 0.7 on the same average
    latent, against JAX's XLA path: rtol 1e-4 / atol 1e-5 on every output
    (float32; K3's plain version and the per-op stack are the same math),
    and the synthesis the JAX selection rule picks."""
    extra, path = EVAL_CASES[case]
    meta, params, state, g, cond, jcond, z = setup(dict(extra, pallas_field=False), seed=1)
    avg = jgen.generate_avg_latent(params, jax.random.PRNGKey(2), meta, n=64)
    fn = jax.jit(lambda p, s, zz, c, a: jgen.generator_forward(
        p, s, zz, c, jax.random.PRNGKey(0), meta, truncation_psi=0.7, avg_latent=a,
        with_depth=True)[0])
    ref = fn(params, state, J(z), jcond, avg)
    calls = []
    orig = synthesis_kernel.synthesis_plain
    monkeypatch.setattr(synthesis_kernel, "synthesis_plain",
                        lambda *a, **k: calls.append("K3") or orig(*a, **k))
    got = gen.generator_forward(g, T(z), cond, meta, truncation_psi=0.7,
                                avg_latent=tuple(T(a) for a in avg), with_depth=True)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert calls == (["K3"] if path == "K3" else [])
    if extra.get("disable_render"):
        assert not got["rgbs_render"].any() and float(got["rgbs"].std()) > 0


@pytest.mark.parametrize("method", ["nearest", "linear", "bilinear", "cubic", "lanczos3",
                                    "lanczos5"])
def test_resize_matches_jax(method):
    """``utils.image.resize`` (and ``resize_feature_maps``) against
    ``jax.image.resize`` up and down, float32 within 2e-6, and bfloat16
    within one bf16 ulp of its magnitude."""
    rs = np.random.RandomState(3)
    for src, dst in (((6, 4), (24, 12)), ((16, 9), (5, 4)), ((7, 5), (7, 11))):
        x = rs.randn(2, *src, 3).astype(np.float32)
        ref = np.asarray(jax.image.resize(J(x), (2, *dst, 3), method=method))
        np.testing.assert_allclose(image.resize(T(x), *dst, method).numpy(), ref, rtol=0,
                                   atol=2e-6)
        np.testing.assert_allclose(gen.resize_feature_maps(T(x), *dst, method).numpy(), ref,
                                   rtol=0, atol=2e-6)
        refb = np.asarray(jax.image.resize(J(x).astype(jnp.bfloat16), (2, *dst, 3),
                                           method=method).astype(jnp.float32))
        gotb = image.resize(T(x).bfloat16(), *dst, method).float().numpy()
        np.testing.assert_allclose(gotb, refb, rtol=2 ** -7, atol=2 ** -7)


# ---------------------------------------------------------------------------
# train mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm,mode,remat", [
    ("adaptive_batch_norm", "isolated", True), ("adaptive_batch_norm", "mixed", False),
    ("instance_norm", "all", True), ("none", "isolated", True), ("none", "mixed", False)])
def test_train_synthesis_matches_jax(norm, mode, remat):
    """``SynthesisNetwork(train=True)`` against JAX
    ``apply_synthesis_network(train=True)``: the rgb (rtol 1e-4 / atol
    1e-5), the new state (adaptive batch norm's running stats and count,
    each ``u``; rtol 1e-5 / atol 1e-6), and the gradients of sum(rgb * g)
    for every parameter, the input and the style (rtol 1e-3 / atol 1e-5).
    Remat changes memory, not values: its run is held alike."""
    nb, mods, C = 3, (0,), 16
    params, state, jmeta = jsyn.init_synthesis_network(jax.random.PRNGKey(4), C, C, C, nb, mods,
                                                        norm, mode)
    net = syn.SynthesisNetwork(C, C, C, nb, mods, norm, mode)
    net.load_state_dict(synthesis_network_state(params, state))
    rs = np.random.RandomState(4)
    x, style = (rs.randn(2, 8, 4, C).astype(np.float32) for _ in range(2))
    fixed = rs.randn(2, 1, C).astype(np.float32)
    g_rgb = rs.randn(2, 8, 4, 3).astype(np.float32)

    def jloss(p, xx, st):
        out, new_state = jsyn.apply_synthesis_network(p, state, jmeta, xx, st, J(fixed),
                                                      train=True, remat=remat)
        return jnp.sum(out["final"] * J(g_rgb)), (out["final"], new_state)

    (_, (ref, new_state)), (dp, dx, dst) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(params, J(x), J(style))
    xt, st = T(x).requires_grad_(), T(style).requires_grad_()
    got = net(xt, st, T(fixed), train=True, remat=remat)
    (got * T(g_rgb)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    want = synthesis_network_state(params, new_state)
    for k, v in net.state_dict().items():
        if "running" in k or "weight_u" in k or "num_batches" in k:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    want_g = synthesis_network_state(dp, new_state)
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(dst), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_spade_without_norm_matches_jax(train):
    """SPADE2d's 'none' branch (JAX apply_spade2d :328-330): gamma at unit
    second moment, no beta; rtol 1e-5 / atol 1e-6."""
    C, Cs = 8, 6
    params, _ = jsyn.init_spade2d(jax.random.PRNGKey(5), C, Cs, "none")
    spade = syn.SPADE2d(C, Cs, "none")
    sd = {}
    for name, key in (("mlp_shared.0", "mlp_shared"), ("mlp_gamma", "mlp_gamma"),
                      ("mlp_beta", "mlp_beta")):
        sd[name + ".weight"] = T(np.asarray(params[key]["w"]).T[:, :, None, None])
        sd[name + ".bias"] = T(params[key]["b"])
    spade.load_state_dict(sd)
    rs = np.random.RandomState(5)
    x, fm = rs.randn(2, 4, 3, C).astype(np.float32), rs.randn(2, 4, 3, Cs).astype(np.float32)
    ref, _ = jsyn.apply_spade2d(params, {}, J(x), J(fm), "none", train)
    if train:
        normalized, moments = spade.train_normalize(T(x), None)
        got = spade.modulate(normalized, T(fm))
        assert moments is None
    else:
        got = spade(T(x), T(fm))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["batch_norm", "adaptive_batch_norm", "instance_norm", "none"])
def test_weight_bridge_round_trip(norm):
    """JAX -> port -> JAX (``convert_generator_state_dict``, which reads
    SPADE blocks only) -> port is the identity on every key under the SPADE
    norms; the pixelwise blocks go JAX -> port and load with the keys of
    the JAX tree.  The port's own init has the same key set and shapes."""
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0), spatial_normalization=norm)
    params, state = jgen.init_generator(jax.random.PRNGKey(6), meta)
    sd = from_jax_params(params, state, gen.Map3DGenerator(meta))
    own = gen.Map3DGenerator(meta, torch.Generator().manual_seed(0)).state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: tuple(v.shape)
                                                           for k, v in sd.items()}
    if norm == "none":
        assert "synthesis_network.network.m3d_0.mod1.affine.weight" in sd
        assert not any("first_norm" in k or "conv_0" in k for k in sd)
        return
    assert any("first_norm" in k for k in sd) == (norm != "instance_norm")
    back = from_jax_params(*convert_generator_state_dict({k: v.numpy() for k, v in sd.items()},
                                                         meta))
    assert sorted(back) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k].numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# the trainer's step
# ---------------------------------------------------------------------------


PAIR_CASES = {
    "hierarchical_instance_norm": dict(hierarchical_sample=True,
                                       spatial_normalization="instance_norm"),
    "field_train_off_pixelwise": {"pallas_field_train": False, "spatial_normalization": "none"},
    "field_bwd_off_adaptive": dict(pallas_field_bwd=False,
                                   spatial_normalization="adaptive_batch_norm"),
    "condition_image_2d_inputs": {"disable_render": True, "2d_label_input": True,
                                  "2d_latent_input": True, "feature_map_interpolation": "cubic"},
}


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_train_step_pair_takes_each_option(case):
    """A NANO D+G pair with R1 (phase slot 3), nerf noise 0.5, through
    ``train_step_pair`` on each option: finite stats, moved generator
    weights (the field's too where it renders), the synthesis state
    advanced where it has one (adaptive batch norm's stats and count)."""
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0), **PAIR_CASES[case])
    smpl = synthetic_smpl_model(num_verts=96, num_faces=160)
    g = torch.Generator().manual_seed(0)
    batch = ds.to_tensors(next(ds.iterate_batches(ds.SyntheticSHHQDataset(smpl_model=smpl,
                                                                          **meta), 2,
                                                  shuffle=False)), "cpu")
    ts = init_train_state(meta, g, "cpu")
    with torch.no_grad():
        ts.G.neural_field.sigma_layer.bias.fill_(0.5)
    before = {k: v.detach().clone() for k, v in ts.G.state_dict().items()}
    ts, stats = train_step_pair(ts, batch, g, meta, get_preprocessor(meta, smpl),
                                meta["phases"][3], 1e-4, 4e-4, 0.5)
    assert all(bool(torch.isfinite(v).all()) for v in stats.values())
    assert "r1" in stats
    after = ts.G.state_dict()
    moved = {k.split(".")[0] for k, v in after.items() if not torch.equal(v, before[k])}
    assert {"synthesis_network", "synthesis_input", "synthesis_mapping_network"} <= moved
    assert ("neural_field" in moved) == (not meta.get("disable_render", False))
    if meta.get("disable_render"):
        assert "synthesis_style_input" in moved
    if meta.get("spatial_normalization") == "adaptive_batch_norm":
        key = "synthesis_network.network.m3d_0.spade_0.first_norm.num_batches_tracked"
        assert int(after[key]) == 2  # the D step's fakes and the G step
