"""K10/K11 of the PyTorch port (threedhumangan_tpu_torch/ops/synthesis_train.py)
and the fused train-mode synthesis, on the CPU against the JAX package:
the plain half-block forward and the ``HalfBlock`` backward against the JAX
Pallas kernels in interpret mode and their custom VJP (f32, where only the
reduction order differs; and a bf16 forward), the fused ``SPADEBlock`` and
``SynthesisNetwork`` against ``apply_spade_block_fused`` and
``apply_synthesis_network(fused_train=True)``: outputs, BN running stats,
spectral-norm ``u`` and parameter gradients.  The CUDA kernels are checked
against the plain versions by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu.models import synthesis as jsyn
from threedhumangan_tpu.ops import synthesis_train as jst
from threedhumangan_tpu_torch.models import synthesis as syn
from threedhumangan_tpu_torch.ops import synthesis_train as st
from threedhumangan_tpu_torch.utils.weights import synthesis_network_state

B, H, W, C, CS, HID = 2, 4, 8, 16, 12, 8
TILE_ROWS = 2
T = torch.as_tensor
N = np.asarray

# (spatial, with the fixed row)
VARIANTS = {"spatial_fixed": (True, True), "spatial": (True, False), "rank1": (False, False)}


def _inputs(spatial, with_fixed, seed=0):
    """numpy inputs of one half-block (f32): h, style/fixed or gam/bet rows,
    the batch moments of h, BN affine, SPADE MLP, conv."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    h = 1.5 * f(B, H, W, C) + 0.3
    m = h.mean((0, 1, 2))
    r = 1.0 / np.sqrt(np.square(h - m).mean((0, 1, 2)) + 1e-5)
    x = dict(h=h, m=m, r=r.astype(np.float32), a=1.0 + 0.2 * f(C), b=0.2 * f(C),
             w=f(C, C) / 4, c=0.1 * f(C))
    if spatial:
        x["style"] = f(B, H, W, CS)
        if with_fixed:
            x["fixed"] = f(B, CS)
        x.update(sh_w=f(CS, HID) / 3, sh_b=0.1 * f(HID), g_w=f(HID, C) / 3, g_b=0.1 * f(C),
                 bt_w=f(HID, C) / 3, bt_b=0.1 * f(C))
    else:
        x.update(gam=1.0 + 0.3 * f(B, C), bet=0.3 * f(B, C))
    return x


def _jax_half_block(x, cdt=jnp.float32):
    j = {k: jnp.asarray(v) for k, v in x.items()}
    if "style" in j:
        mlp = {n: j[n] for n in st.MLP_NAMES}
        return jst.spade_half_block_spatial(j["h"], j["style"], j.get("fixed"), j["m"], j["r"],
                                            j["a"], j["b"], mlp, j["w"], j["c"],
                                            tile_rows=TILE_ROWS, compute_dtype=cdt,
                                            interpret=True)
    return jst.spade_half_block_rank1(j["h"], j["gam"], j["bet"], j["m"], j["r"], j["a"], j["b"],
                                      j["w"], j["c"], tile_rows=TILE_ROWS, compute_dtype=cdt,
                                      interpret=True)


def _torch_half_block(t, cdt=torch.float32):
    if "style" in t:
        mlp = {n: t[n] for n in st.MLP_NAMES}
        return st.spade_half_block_spatial(t["h"], t["style"], t.get("fixed"), t["m"], t["r"],
                                           t["a"], t["b"], mlp, t["w"], t["c"], cdt)
    return st.spade_half_block_rank1(t["h"], t["gam"], t["bet"], t["m"], t["r"], t["a"], t["b"],
                                     t["w"], t["c"], cdt)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_half_block_forward_matches_jax_kernel(variant):
    """f32: the two differ only by reduction order (as tests/test_synthesis_train.py:62)."""
    x = _inputs(*VARIANTS[variant])
    got = _torch_half_block({k: T(v) for k, v in x.items()})
    np.testing.assert_allclose(got.numpy(), N(_jax_half_block(x)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_half_block_backward_matches_jax_vjp(variant):
    """The autograd.Function's backward (the plain K11 on the CPU) against
    jax.grad through the custom VJP, for every input; scale-normalised atol
    2e-4 with a mean loss (tests/test_synthesis_train.py:90-110)."""
    x = _inputs(*VARIANTS[variant])
    names = sorted(x)
    ref = jax.grad(lambda a: jnp.mean(jnp.square(_jax_half_block(dict(zip(names, a))))))(
        [jnp.asarray(x[n]) for n in names])
    leaves = {n: T(x[n]).requires_grad_() for n in names}
    out = _torch_half_block(leaves)
    got = torch.autograd.grad(torch.mean(torch.square(out)), [leaves[n] for n in names])
    for n, a, b in zip(names, got, ref):
        scale = max(float(np.abs(N(b)).max()), 1e-3)
        np.testing.assert_allclose(a.numpy() / scale, N(b) / scale, atol=2e-4, err_msg=n)


@pytest.mark.parametrize("variant", ["spatial_fixed", "rank1"])
def test_bf16_half_block_forward_matches_jax_kernel(variant):
    """bf16 compute: the same roundings on both sides; f32 sums in another
    order flip an occasional bf16 rounding (one ulp, 2^-8 relative)."""
    x = _inputs(*VARIANTS[variant], seed=1)
    x["h"] = np.array(jnp.asarray(x["h"]).astype(jnp.bfloat16).astype(jnp.float32))
    t = {k: T(v) for k, v in x.items()}
    t["h"] = t["h"].to(torch.bfloat16)
    got = _torch_half_block(t, torch.bfloat16).float().numpy()
    jx = dict(x, h=jnp.asarray(x["h"]).astype(jnp.bfloat16))
    ref = N(_jax_half_block(jx, jnp.bfloat16).astype(jnp.float32))
    d = np.abs(got - ref)
    assert d.mean() <= 1e-3 and d.max() <= 2e-2 * np.abs(ref).max(), (d.mean(), d.max())
    assert (d == 0).mean() > 0.9  # most outputs are bit-identical


# ---------------------------------------------------------------------------
# the fused block and network
# ---------------------------------------------------------------------------


def _jax_block(seed=0):
    params, state = jsyn.init_spade_block(jax.random.PRNGKey(seed), C, C, CS, "batch_norm")
    params["spade_0"]["norm"] = {"scale": jnp.linspace(0.5, 1.5, C),
                                 "bias": jnp.linspace(-0.2, 0.2, C)}
    params["spade_1"]["norm"] = {"scale": jnp.linspace(1.2, 0.8, C),
                                 "bias": jnp.linspace(0.1, -0.1, C)}
    return params, state


def _block_state(params, state):
    sd = synthesis_network_state({"blocks": [params], "to_rgbs": []}, {"blocks": [state]})
    return {k[len("network.m3d_0."):]: v for k, v in sd.items()}


def _close_states(module, want, prefix=""):
    for k, v in module.state_dict().items():
        if "running" in k or "weight_u" in k or "num_batches" in k:
            np.testing.assert_allclose(v.numpy(), want[prefix + k].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def _close_grads(got: dict, want: dict, atol):
    assert set(got) == set(want)
    for k in got:
        scale = max(float(np.abs(want[k]).max()), 1e-3)
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, atol=atol, err_msg=k)


@pytest.mark.parametrize("style_kind", ["spatial", "spatial_fixed", "global"])
def test_fused_spade_block_matches_jax(style_kind):
    """SPADEBlock.forward_fused vs apply_spade_block_fused (f32, interpret):
    output, running stats and u; and the parameter gradients of a mean loss."""
    params, state = _jax_block()
    rs = np.random.RandomState(2)
    x = rs.randn(B, H, W, C).astype(np.float32)
    style = (rs.randn(B, H, W, CS) if style_kind != "global" else rs.randn(B, 1, CS)).astype(
        np.float32)
    fixed = rs.randn(B, CS).astype(np.float32) if style_kind == "spatial_fixed" else None
    jfixed = None if fixed is None else jnp.asarray(fixed)

    def jrun(p):
        return jsyn.apply_spade_block_fused(p, state, jnp.asarray(x), jnp.asarray(style), jfixed,
                                            skip=True, compute_dtype=jnp.float32,
                                            tile_rows=TILE_ROWS, interpret=True)

    ref, ref_state = jrun(params)
    jgrads = jax.grad(lambda p: jnp.mean(jnp.square(jrun(p)[0])))(params)
    blk = syn.SPADEBlock(C, C, CS)
    blk.load_state_dict(_block_state(params, state))
    out = blk.forward_fused(T(x), T(style), None if fixed is None else T(fixed), True,
                            torch.float32)
    np.testing.assert_allclose(out.detach().numpy(), N(ref), rtol=1e-4, atol=1e-4)
    _close_states(blk, _block_state(params, ref_state))
    names = [n for n, _ in blk.named_parameters()]
    grads = torch.autograd.grad(torch.mean(torch.square(out)), list(blk.parameters()),
                                allow_unused=True)
    want = _block_state(jgrads, state)
    got = {n: (g if g is not None else torch.zeros_like(p)).numpy()
           for n, g, p in zip(names, grads, blk.parameters())}
    _close_grads(got, {n: want[n].numpy() for n in names}, 2e-4)


@pytest.mark.parametrize("mode", ["isolated", "mixed", "all"])
def test_fused_synthesis_network_matches_jax(mode):
    """The fused SynthesisNetwork (4 blocks, mod_blocks (0, 1): skip, ToRGB,
    spatial and rank-1 half-blocks) vs apply_synthesis_network(fused_train)
    in interpret mode: rgb, BN running stats and u, parameter gradients."""
    nb, mods = 4, (0, 1)
    params, state, meta = jsyn.init_synthesis_network(
        jax.random.PRNGKey(3), C, CS, hidden_dim=C, num_blocks=nb, mod_blocks=mods,
        spatial_normalization="batch_norm", map3d_mode=mode)
    rs = np.random.RandomState(3)
    x = rs.randn(B, H, W, C).astype(np.float32)
    style = rs.randn(B, H, W, CS).astype(np.float32)
    fixed = rs.randn(B, 1, CS).astype(np.float32)
    meta_f = dict(meta, fused_train=True, fused_tile_rows=TILE_ROWS, fused_interpret=True)

    def jrun(p):
        out, new_state = jsyn.apply_synthesis_network(
            p, state, meta_f, jnp.asarray(x), jnp.asarray(style), jnp.asarray(fixed),
            train=True, compute_dtype=jnp.float32)
        return out["final"], new_state

    ref, ref_state = jrun(params)
    jgrads = jax.grad(lambda p: jnp.mean(jnp.square(jrun(p)[0])))(params)
    net = syn.SynthesisNetwork(C, CS, C, nb, mods, "batch_norm", mode)
    net.load_state_dict(synthesis_network_state(params, state))
    out = net(T(x), T(style), T(fixed), torch.float32, train=True, fused=True)
    np.testing.assert_allclose(out.detach().numpy(), N(ref), rtol=2e-4, atol=2e-4)
    _close_states(net, synthesis_network_state(params, ref_state))
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(torch.mean(torch.square(out)), list(net.parameters()),
                                allow_unused=True)
    want = synthesis_network_state(jgrads, state)
    got = {n: (g if g is not None else torch.zeros_like(p)).numpy()
           for n, g, p in zip(names, grads, net.parameters())}
    _close_grads(got, {n: want[n].numpy() for n in names}, 3e-4)


def test_fused_and_per_op_synthesis_agree():
    """In f32 the port's fused and per-op train-mode paths differ by
    reduction order only (mixed mode: the per-op path adds the fixed row in
    f32, the fused one in the compute dtype, equal in f32)."""
    torch.manual_seed(4)
    net = syn.SynthesisNetwork(C, CS, C, 3, (0,), "batch_norm", "mixed")
    net.reset_parameters(torch.Generator().manual_seed(4))
    x, style, fixed = torch.randn(B, H, W, C), torch.randn(B, H, W, CS), torch.randn(B, 1, CS)
    saved = {k: v.clone() for k, v in net.state_dict().items()}
    outs, grads = [], []
    for fused in (False, True):
        net.load_state_dict(saved)
        out = net(x, style, fixed, torch.float32, train=True, fused=fused)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(torch.mean(torch.square(out)), list(net.parameters())))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-5)
    for a, b in zip(grads[1], grads[0]):
        scale = max(float(b.abs().max()), 1e-3)
        torch.testing.assert_close(a / scale, b / scale, rtol=0, atol=2e-4)


def test_cpu_half_block_launches_no_kernel_and_other_devices_raise():
    x = {k: T(v) for k, v in _inputs(True, True).items()}
    _torch_half_block(x)
    assert (st.launches_fwd, st.launches_bwd, st.launches_wgrad) == (0, 0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        st._dispatch(torch.empty(1, device="meta"), "forward")
