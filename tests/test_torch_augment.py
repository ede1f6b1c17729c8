"""The port's ADA pipe (threedhumangan_tpu_torch/data/augment.py) against the
JAX package's ``augment_pipe`` on the CPU in float32: each group alone at
p = 1 and all of them together, on 2:1 and square images (rotate90 takes
its pad path on 2:1), at 3 and 6 channels, with the JAX package's draws
replayed in its order; the identity at p = 0; the VJP of the warp and the
colour transform against ``jax.vjp``; and the pieces around them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu.data import augment as jaug
from threedhumangan_tpu_torch import configs
from threedhumangan_tpu_torch.data import augment as aug

T = torch.as_tensor
N = lambda x: np.array(x)
SHAPES = [(2, 16, 8, 3), (2, 8, 8, 3), (2, 16, 8, 6), (2, 8, 8, 6)]
WARP_COLOUR = dict(scale=1, rotate=1, aniso=1, xfrac=1, xint=1, brightness=1, contrast=1,
                   lumaflip=1, hue=1, saturation=1)


def jax_draws(key, cfg, shape):
    """The draws ``augment_pipe`` takes from ``key``, in its order (one
    ``next(k)`` of 40 split keys each), under the port's names."""
    cfg = aug.augment_config(cfg)
    B, _, _, C = shape
    k = iter(jax.random.split(key, 40))
    u = lambda *s: jax.random.uniform(next(k), s)
    n = lambda *s: jax.random.normal(next(k), s)
    sym = lambda *s: jax.random.uniform(next(k), s, minval=-1, maxval=1)
    own = {"rotate90": ("n", lambda: jax.random.randint(next(k), (B,), 0, 4)),
           "xint": ("t", lambda: sym(B, 2)), "rotate": ("t", lambda: sym(B)),
           "xfrac": ("n", lambda: n(B, 2)), "lumaflip": ("t", lambda: u(B)),
           "hue": ("t", lambda: u(B)), "cutout": ("c", lambda: u(B, 2))}
    d = {}
    for g in aug.GROUPS:
        if not aug._enabled(cfg, g, C):
            continue
        if g == "imgfilter":
            cols = [(n(B), u(B)) for _ in cfg["imgfilter_bands"]]
            d["imgfilter_n"] = jnp.stack([a for a, _ in cols], -1)
            d["imgfilter_u"] = jnp.stack([b for _, b in cols], -1)
        elif g == "noise":
            d["noise_sigma"], d["noise_u"], d["noise_n"] = n(B), u(B), n(*shape)
        else:
            d[f"{g}_u"] = u(B)
            suffix, make = own.get(g, ("n", lambda: n(B)))
            if g != "xflip":
                d[f"{g}_{suffix}"] = make()
    return {name: T(N(v)) for name, v in d.items()}


def _images(shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _compare(cfg, shape, p, seed=0):
    img = _images(shape, seed)
    key = jax.random.PRNGKey(seed + 7)
    got = aug.apply_augment(T(img), cfg, p, jax_draws(key, cfg, shape))
    want = jaug.augment_pipe(jnp.asarray(img), key, jaug.AugmentPipe(**cfg).cfg, p)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got.numpy(), N(want), rtol=0, atol=1e-5)
    return img, got


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[1:])))
@pytest.mark.parametrize("group", aug.GROUPS + ("all",))
def test_augment_group_matches_jax(group, shape):
    """One group alone at p = 1 (every gate open), or all of them."""
    cfg = {g: 1 for g in aug.GROUPS} if group == "all" else {group: 1}
    img, got = _compare(cfg, shape, 1.0)
    if group in ("hue", "saturation") and shape[-1] == 3 or group in ("xflip", "rotate90"):
        assert not np.allclose(got.numpy(), img)  # the group did something


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(map(str, s[1:])))
def test_augment_shipped_config_at_partial_p_matches_jax(shape):
    """The shipped ``ada_aug`` (completed with AugmentPipe's defaults) at
    p = 0.6, where some gates are shut."""
    cfg = configs.extract_metadata(configs.MAP3DBN, 0)["ada_aug"]
    _compare(cfg, shape, 0.6, seed=3)


def test_augment_identity_at_p0():
    cfg = {g: 1 for g in aug.GROUPS}
    for shape in SHAPES:
        img, got = _compare(cfg, shape, 0.0)
        np.testing.assert_allclose(got.numpy(), img, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2]], ids=["C3", "C6"])
def test_augment_vjp_matches_jax(shape):
    """The cotangent of the input through the warp and the colour matrix."""
    img = _images(shape, 1)
    ct = _images(shape, 2)
    key = jax.random.PRNGKey(5)
    x = T(img).requires_grad_(True)
    out = aug.apply_augment(x, WARP_COLOUR, 0.8, jax_draws(key, WARP_COLOUR, shape))
    (got,) = torch.autograd.grad(out, x, T(ct))
    full = jaug.AugmentPipe(**WARP_COLOUR).cfg
    _, vjp = jax.vjp(lambda a: jaug.augment_pipe(a, key, full, 0.8), jnp.asarray(img))
    (want,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(got.numpy(), N(want), rtol=0, atol=1e-5)
    assert np.abs(N(want)).max() > 0.1


def test_augment_defaults_and_the_reference_key_error():
    """The port's defaults are AugmentPipe's; the JAX train step hands the
    raw ``ada_aug`` to ``augment_pipe``, which has none: the shipped
    ``ada_aug`` raises there, and runs in the port."""
    assert aug.augment_config({}) == jaug.AugmentPipe().cfg
    shipped = configs.extract_metadata(configs.MAP3DBN, 0)["ada_aug"]
    img = _images(SHAPES[0])
    with pytest.raises(KeyError):
        jaug.augment_pipe(jnp.asarray(img), jax.random.PRNGKey(0), shipped, 0.5)
    draws = aug.sample_augment(shipped, img.shape, torch.Generator().manual_seed(0), "cpu")
    out = aug.apply_augment(T(img), shipped, 0.5, draws)
    assert out.shape == img.shape and bool(torch.isfinite(out).all())


def test_sample_augment_draws_match_the_jax_names_and_shapes():
    cfg = {g: 1 for g in aug.GROUPS}
    for shape in SHAPES:
        mine = aug.sample_augment(cfg, shape, torch.Generator().manual_seed(0), "cpu")
        ref = jax_draws(jax.random.PRNGKey(0), cfg, shape)
        assert sorted(mine) == sorted(ref)
        for k, v in mine.items():
            assert v.shape == ref[k].shape, k
        assert bool(((mine["rotate90_n"] >= 0) & (mine["rotate90_n"] < 4)).all())
        assert bool(((mine["xint_t"] >= -1) & (mine["xint_t"] < 1)).all())


def test_reflect_index_is_numpy_reflect():
    for n in (1, 2, 3, 8, 16):
        for pad in (0, 1, 5, 21, 40):
            got = aug._reflect_index(n, pad, "cpu").numpy()
            want = np.pad(np.arange(n), pad, mode="reflect") if n > 1 else np.zeros(n + 2 * pad)
            np.testing.assert_array_equal(got, want, err_msg=f"n {n} pad {pad}")


def test_wavelet_fbank_matches_jax():
    for bands in (1, 2, 4):
        np.testing.assert_array_equal(aug._wavelet_fbank(bands), jaug._wavelet_fbank(bands))


def test_augment_in_float64_is_the_float32_reference():
    """float64 images give float64 transforms and output (the card check's
    reference for float32's rounding), within float32's rounding of the
    float32 pipe."""
    cfg = {g: 1 for g in aug.GROUPS}
    shape = SHAPES[2]
    draws = jax_draws(jax.random.PRNGKey(3), cfg, shape)
    img = T(_images(shape, 4))
    lo = aug.apply_augment(img, cfg, 0.7, draws)
    wide = {k: v.double() if v.is_floating_point() else v for k, v in draws.items()}
    hi = aug.apply_augment(img.double(), cfg, 0.7, wide)
    assert lo.dtype == torch.float32 and hi.dtype == torch.float64
    np.testing.assert_allclose(lo.numpy(), hi.numpy(), rtol=0, atol=1e-5)
