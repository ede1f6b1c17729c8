"""ctypes bridge to the port's native data-loader core
(``threedhumangan_tpu_torch/native/dataloader.cpp``; the JAX package's
``data/native.py`` counterpart).

On first use the source compiles with ``g++ -O3 -shared -fPIC`` into
``build/threedhumangan_tpu_torch/dataloader_<source hash>.so`` beside the
kernels (git-ignored), so an edited source rebuilds and an unchanged one
loads the existing build.  Without a compiler every function runs its numpy
version, which gives the same bytes as the native one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from threedhumangan_tpu_torch._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native",
                    "dataloader.cpp")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"dataloader_{digest}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, so_path)  # another process may build the same file
    lib = ctypes.CDLL(so_path)
    i64 = ctypes.c_int64
    u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    lib.normalize_masked_image.argtypes = [u8p, u8p, f32p, i64, i64, i64]
    lib.resize_nearest_u8.argtypes = [u8p, u8p, i64, i64, i64, i64, i64]
    lib.resize_bilinear_u8.argtypes = [u8p, u8p, i64, i64, i64, i64, i64]
    lib.shift_segment_labels.argtypes = [ctypes.POINTER(ctypes.c_int64), i64]
    lib.png_unfilter.argtypes = [u8p, u8p, i64, i64, i64]
    lib.png_unfilter.restype = i64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None without a compiler."""
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        try:
            _lib = _build()
        except (OSError, subprocess.CalledProcessError):
            _lib = None
    return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def normalize_masked_image(rgb: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    """uint8 HWC (+ mask HW) -> float32 HWC in [-1, 1], white background."""
    lib = get_lib()
    h, w, c = rgb.shape
    if mask is not None and mask.shape != (h, w):
        raise ValueError(f"mask {mask.shape} does not match the image's {(h, w)}")
    if lib is None:
        out = rgb.astype(np.float32) * (np.float32(1.0) / np.float32(127.5)) - np.float32(1.0)
        if mask is not None:
            out[mask == 0] = 1.0
        return out
    rgb = np.ascontiguousarray(rgb, np.uint8)
    out = np.empty((h, w, c), np.float32)
    mask_ptr = (_ptr(np.ascontiguousarray(mask, np.uint8), ctypes.c_uint8)
                if mask is not None else ctypes.POINTER(ctypes.c_uint8)())
    lib.normalize_masked_image(_ptr(rgb, ctypes.c_uint8), mask_ptr, _ptr(out, ctypes.c_float),
                               h, w, c)
    return out


def _source_rows(dst: int, src: int):
    """The native bilinear resize's taps and weights along one axis."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    i0 = np.trunc(f).astype(np.int64)
    neg = f < 0
    f[neg], i0[neg] = 0.0, 0
    return i0, np.minimum(i0 + 1, src - 1), f - i0


def _resize_numpy(src: np.ndarray, dh: int, dw: int, nearest: bool) -> np.ndarray:
    sh, sw, _ = src.shape
    if nearest:
        ys = np.minimum(sh - 1, ((np.arange(dh) + 0.5) * sh / dh).astype(np.int64))
        xs = np.minimum(sw - 1, ((np.arange(dw) + 0.5) * sw / dw).astype(np.int64))
        return src[ys][:, xs]
    y0, y1, wy = _source_rows(dh, sh)
    x0, x1, wx = _source_rows(dw, sw)
    s = src.astype(np.float64)
    wx = wx[None, :, None]
    top = s[y0][:, x0] + (s[y0][:, x1] - s[y0][:, x0]) * wx
    bot = s[y1][:, x0] + (s[y1][:, x1] - s[y1][:, x0]) * wx
    v = np.clip(top + (bot - top) * wy[:, None, None], 0.0, 255.0)
    return (v + 0.5).astype(np.uint8)


def resize_u8(src: np.ndarray, dh: int, dw: int, nearest: bool = False) -> np.ndarray:
    """uint8 HWC (or HW) resize: nearest, or bilinear with half-pixel centres."""
    lib = get_lib()
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, c = src.shape
    if lib is None:
        dst = _resize_numpy(src, dh, dw, nearest)
    else:
        dst = np.empty((dh, dw, c), np.uint8)
        fn = lib.resize_nearest_u8 if nearest else lib.resize_bilinear_u8
        fn(_ptr(src, ctypes.c_uint8), _ptr(dst, ctypes.c_uint8), sh, sw, dh, dw, c)
    return dst[..., 0] if squeeze else dst


def shift_segment_labels(seg: np.ndarray) -> np.ndarray:
    """0 stays reserved for fake; foreground labels + 1; background -> 1."""
    lib = get_lib()
    seg = np.ascontiguousarray(seg, np.int64)
    if lib is None:
        out = seg.copy()
        fg = out > 0
        out[fg] += 1
        out[~fg] = 1
        return out
    lib.shift_segment_labels(_ptr(seg, ctypes.c_int64), seg.size)
    return seg


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_numpy(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, x = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            row = x
        elif kind == 1:  # Sub: a running sum over the pixels of each byte lane
            row = np.cumsum(x.reshape(-1, bpp), 0).reshape(-1) & 255
        elif kind == 2:
            row = (x + prev) & 255
        elif kind in (3, 4):  # Average, Paeth: one pixel after the other
            row = np.zeros(stride, np.int64)
            zero = np.zeros(bpp, np.int64)
            for i in range(0, stride, bpp):
                a = row[i - bpp:i] if i else zero
                b = prev[i:i + bpp]
                pred = ((a + b) >> 1 if kind == 3
                        else _paeth(a, b, prev[i - bpp:i] if i else zero))
                row[i:i + bpp] = (x[i:i + bpp] + pred) & 255
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = row
        prev = row
    return out


def png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The inflated IDAT bytes (h rows of a filter byte and ``stride``
    bytes) -> the (h, stride) unfiltered bytes."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (stride + 1)}")
    lib = get_lib()
    if lib is None:
        return _unfilter_numpy(raw, h, stride, bpp)
    out = np.empty((h, stride), np.uint8)
    bad = lib.png_unfilter(_ptr(raw, ctypes.c_uint8), _ptr(out, ctypes.c_uint8), h, stride, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type {raw[(bad - 1) * (stride + 1)]}")
    return out
