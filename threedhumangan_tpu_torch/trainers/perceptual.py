"""VGG16 perceptual features and loss (threedhumangan_tpu/trainers/perceptual.py).

Four VGG16 feature blocks (conv1_2, conv2_2, conv3_3, conv4_3) on inputs
normalised with the ImageNet statistics; the loss is a smooth-L1 per block.
The G step of a conditional phase adds it when ``perceptual_lambda`` sums
above 0 (no shipped config does); ``utils.fid`` uses the features.  Images
are taken in float32, as the JAX package's normalisation promotes them.

Weights load from ``VGG16_WEIGHTS_NPZ`` (``conv{i}_w`` HWIO, ``conv{i}_b``)
when it is set, else they are fixed random draws of
``np.random.RandomState(0)``, the JAX package's draws.  Convolutions are
``F.conv2d`` (cuDNN on the card); images are NHWC in and out.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from threedhumangan_tpu_torch.trainers.losses import smooth_l1
from threedhumangan_tpu_torch.utils.misc import resolve_device

# VGG16's blocks as (out channels, convs); the taps close the slices the
# original repo takes (features[:4], [4:9], [9:16], [16:23])
_VGG_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3)]
_TAPS = (2, 4, 7, 10)  # convs done at each tap
_POOLS_AFTER = (2, 4, 7)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def init_vgg16_features(weights_path: str = "", device="cuda") -> List[Dict[str, torch.Tensor]]:
    """[{'w' OIHW, 'b'}] of VGG16's first 10 convs on ``device``."""
    device = resolve_device(device)
    path = weights_path or os.environ.get("VGG16_WEIGHTS_NPZ", "")
    hwio = []
    if path and os.path.exists(path):
        data = np.load(path)
        i = 0
        while f"conv{i}_w" in data:
            hwio.append((data[f"conv{i}_w"], data[f"conv{i}_b"]))
            i += 1
    else:
        rs = np.random.RandomState(0)
        cin = 3
        for cout, reps in _VGG_BLOCKS:
            for _ in range(reps):
                if len(hwio) >= _TAPS[-1]:
                    break
                std = np.sqrt(2.0 / (9 * cin))
                hwio.append((std * rs.randn(3, 3, cin, cout).astype(np.float32),
                             np.zeros((cout,), np.float32)))
                cin = cout
    return [{"w": torch.as_tensor(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)),
                                  dtype=torch.float32, device=device),
             "b": torch.as_tensor(np.asarray(b), dtype=torch.float32, device=device)}
            for w, b in hwio]


def vgg16_features(convs: Sequence[Dict[str, torch.Tensor]], x: torch.Tensor
                   ) -> List[torch.Tensor]:
    """x: NHWC in [0, 1].  The four tap activations, NHWC, float32."""
    x = x.float()
    mean = x.new_tensor(_IMAGENET_MEAN)
    std = x.new_tensor(_IMAGENET_STD)
    h = ((x - mean) / std).permute(0, 3, 1, 2)
    taps = []
    for i, conv in enumerate(convs, 1):
        h = F.relu(F.conv2d(h, conv["w"], conv["b"], padding=1))
        if i in _TAPS:
            taps.append(h.permute(0, 2, 3, 1))
        if i in _POOLS_AFTER:
            h = F.max_pool2d(h, 2, 2)
    return taps


def perceptual_loss(convs: Sequence[Dict[str, torch.Tensor]], x: torch.Tensor,
                    y: torch.Tensor) -> List[torch.Tensor]:
    """Smooth-L1 feature distance per block; x, y NHWC in [0, 1]."""
    fx = vgg16_features(convs, x)
    fy = vgg16_features(convs, y.detach())
    return [smooth_l1(a, b) for a, b in zip(fx, fy)]
