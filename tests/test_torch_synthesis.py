"""K3 of the PyTorch port (threedhumangan_tpu_torch/ops/synthesis_kernel.py),
plain version on the CPU in float32, against the JAX package's fused
synthesis kernel in interpret mode and its XLA eval stack; plus the port's
eval SynthesisNetwork and the parameter folds.  The CUDA kernel is checked
against the plain version by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu.models import synthesis as jsyn
from threedhumangan_tpu.ops.synthesis_kernel import _LRELU as jax_lrelu
from threedhumangan_tpu.ops.synthesis_kernel import fold_synthesis_params as jax_fold
from threedhumangan_tpu.ops.synthesis_kernel import fused_synthesis as jax_fused
from threedhumangan_tpu_torch.models import synthesis as syn
from threedhumangan_tpu_torch.ops import synthesis_kernel as sk
from threedhumangan_tpu_torch.utils.weights import synthesis_input_state, synthesis_network_state

B, H, W, Fd, NB, MODS = 1, 8, 8, 16, 4, (0, 1)
TOL = dict(rtol=5e-3, atol=5e-4)  # as tests/test_synthesis_kernel.py


def _networks(mode, seed=0):
    rng = jax.random.PRNGKey(seed)
    params, state, meta = jsyn.init_synthesis_network(
        rng, input_dim=Fd, style_dim=Fd, hidden_dim=Fd, num_blocks=NB, mod_blocks=MODS,
        spatial_normalization="batch_norm", map3d_mode=mode)
    for b in state["blocks"]:  # non-trivial running stats
        for s in ("spade_0", "spade_1"):
            n = b[s]["norm"]["mean"].shape[0]
            b[s]["norm"]["mean"] = 0.1 * jnp.arange(n, dtype=jnp.float32)
            b[s]["norm"]["var"] = 1.0 + 0.05 * jnp.arange(n, dtype=jnp.float32)
    syn_input = jsyn.init_synthesis_input(jax.random.split(rng)[0], 2, Fd)
    net = syn.SynthesisNetwork(Fd, Fd, Fd, NB, MODS, "batch_norm", mode)
    net.load_state_dict(synthesis_network_state(params, state))
    sin_ = syn.SynthesisInput(2, Fd)
    sin_.load_state_dict(synthesis_input_state(syn_input))
    return (params, state, meta, syn_input), (net.eval(), sin_)


def _styles(seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, H, W, Fd).astype(np.float32), rs.randn(B, 1, Fd).astype(np.float32))


@pytest.mark.parametrize("mode", ["mixed", "isolated", "all"])
def test_plain_synthesis_matches_jax_kernel_and_xla(mode):
    (params, state, meta, syn_input), (net, sin_) = _networks(mode)
    style, fixed = _styles()
    with torch.no_grad():
        folded = sk.fold_synthesis_params(net, sin_, "batch_norm")
        got = sk.fused_synthesis(folded, torch.as_tensor(style), torch.as_tensor(fixed), NB,
                                 MODS, mode, torch.float32).numpy()
    j_folded = jax_fold(params, state, syn_input, "batch_norm")
    ref_k = jax_fused(j_folded, jnp.asarray(style), jnp.asarray(fixed), num_blocks=NB,
                      mod_blocks=MODS, map3d_mode=mode, tile_rows=4,
                      compute_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref_k), **TOL)
    x0 = jsyn.apply_synthesis_input(syn_input, jsyn.get_2d_coords(B, H, W))
    ref_x, _ = jsyn.apply_synthesis_network(params, state, meta, x0, jnp.asarray(style),
                                            jnp.asarray(fixed), train=False)
    np.testing.assert_allclose(got, np.asarray(ref_x["final"]), **TOL)


@pytest.mark.parametrize("mode", ["mixed", "isolated", "all"])
def test_plain_synthesis_bf16_matches_jax_kernel(mode):
    """bf16, the slice's dtype: the plain version rounds where the JAX
    kernel does, so only f32 summation order separates them (a flipped
    bf16 rounding now and then, as in the slice tolerances)."""
    (params, state, _, syn_input), (net, sin_) = _networks(mode, seed=9)
    style, fixed = _styles(10)
    with torch.no_grad():
        folded = sk.fold_synthesis_params(net, sin_, "batch_norm")
        got = sk.fused_synthesis(folded, torch.as_tensor(style), torch.as_tensor(fixed), NB,
                                 MODS, mode, torch.bfloat16).numpy()
    ref = np.asarray(jax_fused(jax_fold(params, state, syn_input, "batch_norm"),
                               jnp.asarray(style), jnp.asarray(fixed), num_blocks=NB,
                               mod_blocks=MODS, map3d_mode=mode, tile_rows=4,
                               compute_dtype=jnp.bfloat16, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3)
    assert np.abs(got - ref).mean() <= 5e-4


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lrelu_slope_matches_jax_kernel(dtype):
    """The JAX kernel's slope is a weakly typed 0.2: in bf16 it is
    0.2001953125, and the port (plain version and kernel) uses the same."""
    x = np.random.RandomState(11).randn(4096).astype(np.float32)
    got = sk._lrelu(torch.as_tensor(x).to(getattr(torch, dtype))).float().numpy()
    ref = np.asarray(jax_lrelu(jnp.asarray(x).astype(getattr(jnp, dtype))).astype(jnp.float32))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", ["mixed", "isolated", "all"])
def test_synthesis_network_eval_matches_jax(mode):
    (params, state, meta, syn_input), (net, sin_) = _networks(mode, seed=2)
    style, fixed = _styles(3)
    with torch.no_grad():
        x0 = sin_(syn.get_2d_coords(B, H, W))
        got = net(x0, torch.as_tensor(style), torch.as_tensor(fixed)).numpy()
    jx0 = jsyn.apply_synthesis_input(syn_input, jsyn.get_2d_coords(B, H, W))
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=1e-5, atol=1e-6)
    ref, _ = jsyn.apply_synthesis_network(params, state, meta, jx0, jnp.asarray(style),
                                          jnp.asarray(fixed), train=False)
    np.testing.assert_allclose(got, np.asarray(ref["final"]), rtol=1e-4, atol=1e-5)


def test_fold_synthesis_params_matches_jax():
    (params, state, _, syn_input), (net, sin_) = _networks("isolated", seed=4)
    with torch.no_grad():
        got = sk.fold_synthesis_params(net, sin_, "batch_norm")
    ref = jax_fold(params, state, syn_input, "batch_norm")
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_get_2d_coords_matches_jax():
    np.testing.assert_allclose(syn.get_2d_coords(2, 5, 7).numpy(),
                               np.asarray(jsyn.get_2d_coords(2, 5, 7)), rtol=0, atol=2e-7)


def test_synthesis_cpu_path_launches_no_kernel():
    _, (net, sin_) = _networks("isolated", seed=5)
    style, fixed = _styles(6)
    with torch.no_grad():
        folded = sk.fold_synthesis_params(net, sin_, "batch_norm")
        sk.fused_synthesis(folded, torch.as_tensor(style), torch.as_tensor(fixed), NB, MODS,
                           "isolated", torch.bfloat16)
    assert sk.launches == 0


def test_synthesis_kernel_wrapper_rejects_malformed_input():
    """The CUDA entry checks widths and the pixel tiling before it builds
    or launches anything."""
    _, (net, sin_) = _networks("isolated", seed=7)
    style, fixed = map(torch.as_tensor, _styles(8))
    with torch.no_grad():
        folded = sk.fold_synthesis_params(net, sin_, "batch_norm")
    with pytest.raises(ValueError, match="feature_dim == hidden_dim"):
        sk.synthesis_cuda(folded, style[..., :-1], fixed, NB, MODS, "isolated")
    with pytest.raises(ValueError, match="divisible by 64"):
        sk.synthesis_cuda(folded, style[:, :, :7], fixed, NB, MODS, "isolated")
