"""The port's image ops and feature extractors against the JAX package's, on
the CPU: ``grid_sample`` (``data/augment.py``), the three resizes the apps
use (``utils/image.py`` against ``jax.image.resize``), the VGG16 features and
perceptual loss (``trainers/perceptual.py``), InceptionV3 pool3
(``utils/inception.py``, on the weights ``inception_from_jax`` carries
over), the random weight draws of both extractors, and the Frechet
distance and its statistics (``utils/fid.py``).  Inputs are numpy draws
from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedhumangan_tpu import ops as jops
from threedhumangan_tpu.trainers import perceptual as jperc
from threedhumangan_tpu.utils import fid as jfid
from threedhumangan_tpu.utils import inception as jinc
from threedhumangan_tpu_torch import ops
from threedhumangan_tpu_torch.data.augment import grid_sample_bilinear
from threedhumangan_tpu_torch.trainers import perceptual
from threedhumangan_tpu_torch.utils import fid, inception
from threedhumangan_tpu_torch.utils.image import resize_bilinear, resize_nearest
from threedhumangan_tpu_torch.utils.weights import inception_from_jax, vgg16_from_jax


def _rel_max(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def test_grid_sample_matches_jax():
    rs = np.random.RandomState(0)
    img = rs.uniform(-1, 1, (2, 24, 12, 3)).astype(np.float32)
    # a quarter of the points outside [-1, 1]: zero padding, and the edge rows
    grid = rs.uniform(-1.3, 1.3, (2, 20, 10, 2)).astype(np.float32)
    ref = np.asarray(jops.grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    got = grid_sample_bilinear(torch.as_tensor(img), torch.as_tensor(grid)).numpy()
    assert np.abs(got - ref).max() <= 1e-6
    assert torch.equal(ops.grid_sample(torch.as_tensor(img), torch.as_tensor(grid)),
                       torch.as_tensor(got))


@pytest.mark.parametrize("size", [(299, 299), (96, 48)])
def test_bilinear_resize_matches_jax(size):
    """512 x 256 -> 299 x 299 (Inception: one axis shrinks, one grows) and
    -> 96 x 48 (the consistency sweep's render grid)."""
    x = np.random.RandomState(1).uniform(-1, 1, (2, 512, 256, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 3), "bilinear"))
    got = resize_bilinear(torch.as_tensor(x), *size).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5


def test_nearest_resize_matches_jax():
    m = (np.random.RandomState(2).rand(1, 512, 256) > 0.5).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(m), (1, 96, 48), "nearest"))
    got = resize_nearest(torch.as_tensor(m), 96, 48).numpy()
    np.testing.assert_array_equal(got, ref)


def test_random_weights_are_the_jax_draws():
    jv = vgg16_from_jax(jperc.init_vgg16_features())
    pv = perceptual.init_vgg16_features(device="cpu")
    assert len(jv) == len(pv) == 10
    for a, b in zip(jv, pv):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    ji = inception_from_jax(jinc.init_random_inception(3))
    pi = inception.init_random_inception(3, device="cpu")
    assert set(ji) == set(pi) and len(pi) == 2 * len(inception.CONV_TABLE)
    for k in pi:
        assert torch.equal(ji[k], pi[k]), k
    assert inception.conv_input_channels() == jinc.conv_input_channels()
    assert inception.CONV_TABLE == jinc.CONV_TABLE


def test_vgg16_features_and_perceptual_loss_match_jax():
    convs = jperc.init_vgg16_features()
    pconvs = vgg16_from_jax(convs)
    rs = np.random.RandomState(3)
    x = rs.rand(2, 64, 32, 3).astype(np.float32)
    y = rs.rand(2, 64, 32, 3).astype(np.float32)
    ref = jperc.vgg16_features(convs, jnp.asarray(x))
    got = perceptual.vgg16_features(pconvs, torch.as_tensor(x))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel_max(g.numpy(), r) <= 1e-4
    jl = jperc.perceptual_loss(convs, jnp.asarray(x), jnp.asarray(y))
    pl = perceptual.perceptual_loss(pconvs, torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose([float(v) for v in pl], [float(v) for v in jl], rtol=1e-4)


def test_inception_pool3_matches_jax():
    params = jinc.init_random_inception(0)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    ref = np.asarray(jinc.inception_pool3(params, jnp.asarray(x), resize=False))
    got = inception.inception_pool3(inception_from_jax(params), torch.as_tensor(x),
                                    resize=False).numpy()
    assert got.shape == ref.shape == (2, 2048)
    assert _rel_max(got, ref) <= 1e-4


def test_frechet_distance_and_statistics_equal_jax():
    rs = np.random.RandomState(5)
    a = rs.randn(40, 12)
    b = 0.5 + 1.3 * rs.randn(30, 12)
    (mu_a, s_a), (mu_b, s_b) = fid.compute_statistics(a), fid.compute_statistics(b)
    (jmu_a, js_a), (jmu_b, js_b) = jfid.compute_statistics(a), jfid.compute_statistics(b)
    for got, ref in ((mu_a, jmu_a), (s_a, js_a), (mu_b, jmu_b), (s_b, js_b)):
        np.testing.assert_array_equal(got, ref)
    assert fid.frechet_distance(mu_a, s_a, mu_b, s_b) == jfid.frechet_distance(
        jmu_a, js_a, jmu_b, js_b)
    assert abs(fid.frechet_distance(mu_a, s_a, mu_a, s_a)) < 1e-9


def test_fid_between_matches_jax():
    """The VGG route end to end (``get_extractor('auto')`` without weight
    files), with the label the JAX package prints."""
    rs = np.random.RandomState(6)
    a = rs.uniform(-1, 1, (12, 32, 16, 3)).astype(np.float32)
    b = np.clip(a + 0.3 * rs.randn(*a.shape), -1, 1).astype(np.float32)
    ref = jfid.fid_between(a, b)
    got = fid.fid_between(a, b, device="cpu")
    assert abs(got - ref) <= 1e-3 * abs(ref)
    _, label = fid.get_extractor("auto", device="cpu")
    assert label == jfid.get_extractor("auto")[1]
    assert "NOT Inception-FID" in label
