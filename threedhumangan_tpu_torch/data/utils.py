"""Image helpers for the trainer's sample grids (threedhumangan_tpu/data/utils.py):
``make_grid``, ``colorize_labels`` and ``write_png`` (zlib, no image library)."""

from __future__ import annotations

import struct
import zlib

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


def write_png(path: str, image: np.ndarray) -> None:
    """Write an HWC image with 1 or 3 channels, float in [0, 1] or uint8, as PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, c = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2}[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
