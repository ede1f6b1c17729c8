"""Image helpers (threedhumangan_tpu/data/utils.py): the trainer's sample
grids (``make_grid``, ``colorize_labels``) and PNG files with no image
library: ``write_png`` and ``read_png`` take them apart and put them
together with ``zlib`` (the card's installed packages have no PIL)."""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """NHWC batch -> one HWC grid image, ``nrow`` images a row."""
    n, h, w, c = images.shape
    ncol = nrow
    nr = -(-n // ncol)
    canvas = np.full((nr * (h + pad) + pad, ncol * (w + pad) + pad, c), pad_value, images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        canvas[y0:y0 + h, x0:x0 + w] = images[i]
    return canvas


def colorize_labels(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """(N, H, W) int labels -> (N, H, W, 3) float RGB in [0, 1]: class 0
    (fake) black, class 1 (background) white, body parts on an HSV wheel."""
    labels = np.asarray(labels).astype(np.int64)
    palette = np.zeros((max(num_classes, 2), 3), np.float32)
    palette[1] = 1.0
    n_parts = max(num_classes - 2, 1)
    for i in range(2, num_classes):
        h = (i - 2) / n_parts * 6.0
        x = 1.0 - abs(h % 2.0 - 1.0)
        palette[i] = [(1, x, 0), (x, 1, 0), (0, 1, x), (0, x, 1), (x, 0, 1), (1, 0, x)][int(h) % 6]
    return palette[np.clip(labels, 0, num_classes - 1)]


_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels of an 8-bit image (3: palette indices)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(img: np.ndarray, bpp: int, filters) -> bytes:
    """The filtered scanlines, row y with filter type filters[y % len]."""
    h = img.shape[0]
    x = img.reshape(h, -1).astype(np.int64)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[:, bpp:] = up[:, :-bpp]
    preds = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)]
    kinds = np.asarray([filters[y % len(filters)] for y in range(h)], np.uint8)
    out = np.empty((h, x.shape[1] + 1), np.uint8)
    out[:, 0] = kinds
    for k in set(kinds.tolist()):
        rows = kinds == k
        out[rows, 1:] = ((x - preds[k])[rows] & 255).astype(np.uint8)
    return out.tobytes()


def write_png(path: str, image: np.ndarray, palette: Optional[np.ndarray] = None,
              filters=(0,)) -> None:
    """Write an 8-bit PNG: an HWC image with 1-4 channels (gray, gray +
    alpha, RGB, RGBA), float in [0, 1] or uint8; or, with ``palette`` (N, 3)
    uint8, an HW array of palette indices.  Row y takes the filter type
    ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    kind = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, kind, 0, 0, 0)
    plte = (chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
            if palette is not None else b"")
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", header) + plte
                + chunk(b"IDAT", zlib.compress(_filter_rows(img, c, tuple(filters)), 6))
                + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG as ``np.asarray(PIL.Image.open(path))``
    gives it: (H, W) for gray and for palette images (the palette indices),
    (H, W, 2) gray + alpha, (H, W, 3) RGB, (H, W, 4) RGBA.  The rows are
    unfiltered by the native loader core (``data.native.png_unfilter``).
    Raises ValueError on other bit depths and on interlaced files."""
    from threedhumangan_tpu_torch.data.native import png_unfilter

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, kind, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth}; only 8-bit PNG files are read")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG files are not read")
    if kind not in _CHANNELS:
        raise ValueError(f"{path}: unknown colour type {kind}")
    c = _CHANNELS[kind]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = png_unfilter(raw, h, w * c, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img
