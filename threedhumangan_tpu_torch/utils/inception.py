"""InceptionV3 pool3 features, the standard FID feature space
(threedhumangan_tpu/utils/inception.py).

The torchvision ``inception_v3`` eval graph through its final average pool
(2048-d "pool3" features), with BatchNorm folded into the conv weights, so
the forward is convolutions, ReLU and pools.  ``CONV_TABLE`` and
``conv_input_channels`` are the port's own copy of the JAX module's tables.
Weights: ``load_inception_npz(path)`` reads a BN-folded npz (HWIO convs, as
the JAX package's ``utils/export_weights.py`` writes it), and
``init_random_inception(seed)`` draws fixed random weights with the same
``np.random.RandomState(seed)`` draws as the JAX package.  Both return
``{name + '.w': OIHW, name + '.b': (O,)}`` tensors; convolutions are
``F.conv2d`` (cuDNN on the card).  Images are NHWC.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from threedhumangan_tpu_torch.utils.image import resize_bilinear
from threedhumangan_tpu_torch.utils.misc import resolve_device


def _a(name, pool):  # InceptionA
    return [
        (f"{name}.branch1x1", 64, 1, 1, 1, (0, 0)),
        (f"{name}.branch5x5_1", 48, 1, 1, 1, (0, 0)),
        (f"{name}.branch5x5_2", 64, 5, 5, 1, (2, 2)),
        (f"{name}.branch3x3dbl_1", 64, 1, 1, 1, (0, 0)),
        (f"{name}.branch3x3dbl_2", 96, 3, 3, 1, (1, 1)),
        (f"{name}.branch3x3dbl_3", 96, 3, 3, 1, (1, 1)),
        (f"{name}.branch_pool", pool, 1, 1, 1, (0, 0)),
    ]


def _b(name):  # InceptionB
    return [
        (f"{name}.branch3x3", 384, 3, 3, 2, (0, 0)),
        (f"{name}.branch3x3dbl_1", 64, 1, 1, 1, (0, 0)),
        (f"{name}.branch3x3dbl_2", 96, 3, 3, 1, (1, 1)),
        (f"{name}.branch3x3dbl_3", 96, 3, 3, 2, (0, 0)),
    ]


def _c(name, c7):  # InceptionC
    return [
        (f"{name}.branch1x1", 192, 1, 1, 1, (0, 0)),
        (f"{name}.branch7x7_1", c7, 1, 1, 1, (0, 0)),
        (f"{name}.branch7x7_2", c7, 1, 7, 1, (0, 3)),
        (f"{name}.branch7x7_3", 192, 7, 1, 1, (3, 0)),
        (f"{name}.branch7x7dbl_1", c7, 1, 1, 1, (0, 0)),
        (f"{name}.branch7x7dbl_2", c7, 7, 1, 1, (3, 0)),
        (f"{name}.branch7x7dbl_3", c7, 1, 7, 1, (0, 3)),
        (f"{name}.branch7x7dbl_4", c7, 7, 1, 1, (3, 0)),
        (f"{name}.branch7x7dbl_5", 192, 1, 7, 1, (0, 3)),
        (f"{name}.branch_pool", 192, 1, 1, 1, (0, 0)),
    ]


def _d(name):  # InceptionD
    return [
        (f"{name}.branch3x3_1", 192, 1, 1, 1, (0, 0)),
        (f"{name}.branch3x3_2", 320, 3, 3, 2, (0, 0)),
        (f"{name}.branch7x7x3_1", 192, 1, 1, 1, (0, 0)),
        (f"{name}.branch7x7x3_2", 192, 1, 7, 1, (0, 3)),
        (f"{name}.branch7x7x3_3", 192, 7, 1, 1, (3, 0)),
        (f"{name}.branch7x7x3_4", 192, 3, 3, 2, (0, 0)),
    ]


def _e(name):  # InceptionE
    return [
        (f"{name}.branch1x1", 320, 1, 1, 1, (0, 0)),
        (f"{name}.branch3x3_1", 384, 1, 1, 1, (0, 0)),
        (f"{name}.branch3x3_2a", 384, 1, 3, 1, (0, 1)),
        (f"{name}.branch3x3_2b", 384, 3, 1, 1, (1, 0)),
        (f"{name}.branch3x3dbl_1", 448, 1, 1, 1, (0, 0)),
        (f"{name}.branch3x3dbl_2", 384, 3, 3, 1, (1, 1)),
        (f"{name}.branch3x3dbl_3a", 384, 1, 3, 1, (0, 1)),
        (f"{name}.branch3x3dbl_3b", 384, 3, 1, 1, (1, 0)),
        (f"{name}.branch_pool", 192, 1, 1, 1, (0, 0)),
    ]


# (name, out channels, kh, kw, stride, (ph, pw)) of every conv; the input
# channels follow from the graph, so the table pins every weight's shape
CONV_TABLE: List[Tuple[str, int, int, int, int, Tuple[int, int]]] = (
    [
        ("Conv2d_1a_3x3", 32, 3, 3, 2, (0, 0)),
        ("Conv2d_2a_3x3", 32, 3, 3, 1, (0, 0)),
        ("Conv2d_2b_3x3", 64, 3, 3, 1, (1, 1)),
        ("Conv2d_3b_1x1", 80, 1, 1, 1, (0, 0)),
        ("Conv2d_4a_3x3", 192, 3, 3, 1, (0, 0)),
    ]
    + _a("Mixed_5b", 32) + _a("Mixed_5c", 64) + _a("Mixed_5d", 64)
    + _b("Mixed_6a")
    + _c("Mixed_6b", 128) + _c("Mixed_6c", 160) + _c("Mixed_6d", 160)
    + _c("Mixed_6e", 192)
    + _d("Mixed_7a")
    + _e("Mixed_7b") + _e("Mixed_7c")
)

# a chained branch reads the conv before it in its chain
_CHAINS = {
    "branch5x5_2": "branch5x5_1",
    "branch3x3dbl_2": "branch3x3dbl_1",
    "branch3x3dbl_3": "branch3x3dbl_2",
    "branch7x7_2": "branch7x7_1", "branch7x7_3": "branch7x7_2",
    "branch7x7dbl_2": "branch7x7dbl_1",
    "branch7x7dbl_3": "branch7x7dbl_2",
    "branch7x7dbl_4": "branch7x7dbl_3",
    "branch7x7dbl_5": "branch7x7dbl_4",
    "branch3x3_2": "branch3x3_1",
    "branch7x7x3_2": "branch7x7x3_1",
    "branch7x7x3_3": "branch7x7x3_2",
    "branch7x7x3_4": "branch7x7x3_3",
    "branch3x3_2a": "branch3x3_1", "branch3x3_2b": "branch3x3_1",
    "branch3x3dbl_3a": "branch3x3dbl_2",
    "branch3x3dbl_3b": "branch3x3dbl_2",
}
_STEM_IN = {"Conv2d_1a_3x3": 3, "Conv2d_2a_3x3": 32, "Conv2d_2b_3x3": 32,
            "Conv2d_3b_1x1": 64, "Conv2d_4a_3x3": 80}
_BLOCK_IN = {"Mixed_5b": 192, "Mixed_5c": 256, "Mixed_5d": 288, "Mixed_6a": 288,
             "Mixed_6b": 768, "Mixed_6c": 768, "Mixed_6d": 768, "Mixed_6e": 768,
             "Mixed_7a": 768, "Mixed_7b": 1280, "Mixed_7c": 2048}


def conv_input_channels() -> Dict[str, int]:
    """Input channels of each conv, from the graph's topology."""
    ins = dict(_STEM_IN)
    out_ch = {name: o for name, o, *_ in CONV_TABLE}
    for name, *_ in CONV_TABLE:
        if "." not in name:
            continue
        blk, branch = name.split(".", 1)
        ins[name] = (out_ch[f"{blk}.{_CHAINS[branch]}"] if branch in _CHAINS
                     else _BLOCK_IN[blk])
    return ins


def _params(hwio: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in hwio.items():
        v = np.asarray(v, np.float32)
        if k.endswith(".w"):
            v = np.ascontiguousarray(v.transpose(3, 2, 0, 1))
        out[k] = torch.as_tensor(v, device=device)
    return out


def init_random_inception(seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Fixed random weights of the production shapes (the JAX package's
    ``RandomState(seed)`` draws, HWIO, then OIHW here)."""
    rng = np.random.RandomState(seed)
    ins = conv_input_channels()
    hwio = {}
    for name, out, kh, kw, _, _ in CONV_TABLE:
        hwio[name + ".w"] = (rng.randn(kh, kw, ins[name], out).astype(np.float32)
                             / np.sqrt(ins[name] * kh * kw))
        hwio[name + ".b"] = np.zeros((out,), np.float32)
    return _params(hwio, resolve_device(device))


def load_inception_npz(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    """A BN-folded npz of HWIO convs -> the port's weights."""
    data = np.load(path)
    ins = conv_input_channels()
    hwio = {}
    for name, out, kh, kw, _, _ in CONV_TABLE:
        w = data[name + ".w"]
        if w.shape != (kh, kw, ins[name], out):
            raise ValueError(f"{path}: {name}.w has shape {w.shape}, not "
                             f"{(kh, kw, ins[name], out)}")
        hwio[name + ".w"], hwio[name + ".b"] = w, data[name + ".b"]
    return _params(hwio, resolve_device(device))


_SPECS = {name: (s, pd) for name, _, _, _, s, pd in CONV_TABLE}


def _c2(p, name, x):
    stride, pad = _SPECS[name]
    return F.relu(F.conv2d(x, p[name + ".w"], p[name + ".b"], stride=stride, padding=pad))


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)  # 3x3 stride 2, VALID


def _avgpool3(x):
    # 3x3 stride 1, padding 1, dividing by 9 at the borders too
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _block_a(p, n, x):
    b1 = _c2(p, f"{n}.branch1x1", x)
    b5 = _c2(p, f"{n}.branch5x5_2", _c2(p, f"{n}.branch5x5_1", x))
    b3 = _c2(p, f"{n}.branch3x3dbl_3",
             _c2(p, f"{n}.branch3x3dbl_2", _c2(p, f"{n}.branch3x3dbl_1", x)))
    bp = _c2(p, f"{n}.branch_pool", _avgpool3(x))
    return torch.cat([b1, b5, b3, bp], 1)


def _block_b(p, n, x):
    b3 = _c2(p, f"{n}.branch3x3", x)
    bd = _c2(p, f"{n}.branch3x3dbl_3",
             _c2(p, f"{n}.branch3x3dbl_2", _c2(p, f"{n}.branch3x3dbl_1", x)))
    return torch.cat([b3, bd, _maxpool(x)], 1)


def _block_c(p, n, x):
    b1 = _c2(p, f"{n}.branch1x1", x)
    b7 = _c2(p, f"{n}.branch7x7_3",
             _c2(p, f"{n}.branch7x7_2", _c2(p, f"{n}.branch7x7_1", x)))
    bd = x
    for i in (1, 2, 3, 4, 5):
        bd = _c2(p, f"{n}.branch7x7dbl_{i}", bd)
    bp = _c2(p, f"{n}.branch_pool", _avgpool3(x))
    return torch.cat([b1, b7, bd, bp], 1)


def _block_d(p, n, x):
    b3 = _c2(p, f"{n}.branch3x3_2", _c2(p, f"{n}.branch3x3_1", x))
    b7 = x
    for i in (1, 2, 3, 4):
        b7 = _c2(p, f"{n}.branch7x7x3_{i}", b7)
    return torch.cat([b3, b7, _maxpool(x)], 1)


def _block_e(p, n, x):
    b1 = _c2(p, f"{n}.branch1x1", x)
    b3 = _c2(p, f"{n}.branch3x3_1", x)
    b3 = torch.cat([_c2(p, f"{n}.branch3x3_2a", b3), _c2(p, f"{n}.branch3x3_2b", b3)], 1)
    bd = _c2(p, f"{n}.branch3x3dbl_2", _c2(p, f"{n}.branch3x3dbl_1", x))
    bd = torch.cat([_c2(p, f"{n}.branch3x3dbl_3a", bd), _c2(p, f"{n}.branch3x3dbl_3b", bd)], 1)
    bp = _c2(p, f"{n}.branch_pool", _avgpool3(x))
    return torch.cat([b1, b3, bd, bp], 1)


@torch.no_grad()
def inception_pool3(params: Dict[str, torch.Tensor], images: torch.Tensor,
                    resize: bool = True) -> torch.Tensor:
    """images (N, H, W, 3) in [-1, 1] -> (N, 2048) pool3 features, after a
    bilinear resize to 299 x 299 of the [-1, 1] image (as published FID
    preprocesses; bilinear commutes with the affine scaling)."""
    x = images.float()
    if resize:
        x = resize_bilinear(x, 299, 299)
    x = x.permute(0, 3, 1, 2)
    for n in ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"):
        x = _c2(params, n, x)
    x = _maxpool(x)
    x = _c2(params, "Conv2d_3b_1x1", x)
    x = _c2(params, "Conv2d_4a_3x3", x)
    x = _maxpool(x)
    for n in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _block_a(params, n, x)
    x = _block_b(params, "Mixed_6a", x)
    for n in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _block_c(params, n, x)
    x = _block_d(params, "Mixed_7a", x)
    x = _block_e(params, "Mixed_7b", x)
    x = _block_e(params, "Mixed_7c", x)
    return x.mean(dim=(2, 3))  # global average pool -> (N, 2048)
