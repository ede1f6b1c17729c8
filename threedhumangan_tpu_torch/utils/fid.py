"""Frechet distance between feature statistics (threedhumangan_tpu/utils/fid.py).

``compute_statistics``, ``_sqrtm_psd`` and ``frechet_distance`` are the JAX
module's numpy, in float64.  The features come from ``get_extractor``:
InceptionV3 pool3 with real weights when ``INCEPTION_WEIGHTS_NPZ`` names a
file (the feature space of published FID), else the VGG16 stack of
``trainers.perceptual`` with fixed random weights (unless
``VGG16_WEIGHTS_NPZ`` is set): a deterministic two-sample discrepancy,
comparable across runs of this program and not to published FID, and its
label says so.  The extractors run on ``device`` (the card unless the caller
names the CPU).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from threedhumangan_tpu_torch.utils.misc import resolve_device


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """features: (N, D) -> (mu (D,), sigma (D, D))."""
    feats = np.asarray(features, np.float64)
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2) -> float:
    """|mu1 - mu2|^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)), with
    Tr sqrt(s1 s2) = Tr sqrt(s1^1/2 s2 s1^1/2)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.asarray(sigma1, np.float64)
    sigma2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    inner = _sqrtm_psd(s1_half @ sigma2 @ s1_half)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(inner))


def get_extractor(kind: str = "auto", device="cuda"):
    """(feats_fn, label): ``feats_fn`` maps a (B, H, W, 3) batch in [-1, 1] on
    ``device`` to (B, D) features.  ``kind``: 'inception' (needs
    ``INCEPTION_WEIGHTS_NPZ``), 'inception-random' (fixed random weights),
    'vgg' (VGG16, real weights when ``VGG16_WEIGHTS_NPZ`` is set), or 'auto'
    (inception where its npz exists, else vgg)."""
    device = resolve_device(device)
    inception_npz = os.environ.get("INCEPTION_WEIGHTS_NPZ", "")
    if kind == "auto":
        kind = "inception" if inception_npz and os.path.exists(inception_npz) else "vgg"

    if kind in ("inception", "inception-random"):
        from threedhumangan_tpu_torch.utils.inception import (
            inception_pool3,
            init_random_inception,
            load_inception_npz,
        )

        if kind == "inception":
            if not (inception_npz and os.path.exists(inception_npz)):
                raise FileNotFoundError("kind='inception' needs INCEPTION_WEIGHTS_NPZ")
            params = load_inception_npz(inception_npz, device)
            label = "Inception-pool3 (real weights): standard FID"
        else:
            params = init_random_inception(device=device)
            label = "Inception-pool3 topology, FIXED RANDOM weights: NOT Inception-FID"
        return (lambda batch: inception_pool3(params, batch)), label

    from threedhumangan_tpu_torch.trainers.perceptual import init_vgg16_features

    convs = init_vgg16_features(device=device)
    real = bool(os.environ.get("VGG16_WEIGHTS_NPZ", ""))
    label = ("VGG16 features (real weights)" if real
             else "VGG16 topology, FIXED RANDOM weights: NOT Inception-FID")
    return (lambda batch: _vgg_pooled(convs, batch)), label


@torch.no_grad()
def _vgg_pooled(convs, batch: torch.Tensor) -> torch.Tensor:
    from threedhumangan_tpu_torch.trainers.perceptual import vgg16_features

    return vgg16_features(convs, batch.float() * 0.5 + 0.5)[-1].mean(dim=(1, 2))


def extract_features(images, batch_size: int = 16, kind: str = "auto",
                     device="cuda") -> np.ndarray:
    """images: (N, H, W, 3) in [-1, 1] (numpy or a tensor) -> (N, D) numpy
    features of ``get_extractor(kind)``, ``batch_size`` images at a time on
    ``device``."""
    device = resolve_device(device)
    feats, _ = get_extractor(kind, device)
    out = []
    for i in range(0, len(images), batch_size):
        batch = images[i:i + batch_size]
        batch = batch if torch.is_tensor(batch) else torch.as_tensor(np.asarray(batch))
        out.append(feats(batch.to(device)).float().cpu().numpy())
    return np.concatenate(out, axis=0)


def fid_between(images_a, images_b, device="cuda") -> float:
    """The Frechet distance of the two image sets' 'auto' features."""
    fa = extract_features(images_a, device=device)
    fb = extract_features(images_b, device=device)
    return frechet_distance(*compute_statistics(fa), *compute_statistics(fb))
