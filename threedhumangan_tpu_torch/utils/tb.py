"""Dependency-free TensorBoard event-file writer (the port's copy of
threedhumangan_tpu/utils/tb.py, numpy only).

It emits the tfevents wire format directly: a TFRecord stream (length /
masked-crc32c framing) of hand-encoded ``Event`` protobuf messages — scalars
as ``Summary.Value.simple_value`` and histograms as ``HistogramProto`` with
TensorBoard's standard exponential bucketing.  Files open in stock
TensorBoard (``tensorboard --logdir ...``).  The trainer writes the scalars
of ``metrics.jsonl`` and, at ``sample_interval``, weight histograms;
``apps/export_tensorboard.py`` converts a ``metrics.jsonl`` afterwards.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven — required by the TFRecord framing
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding (only what Event/Summary/Histogram need)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _f_packed_doubles(field: int, vals) -> bytes:
    body = b"".join(struct.pack("<d", float(v)) for v in vals)
    return _f_bytes(field, body)


def _histogram_proto(values: np.ndarray) -> bytes:
    """tensorboard.HistogramProto with the stock exponential buckets
    (1.1 growth), matching what torch's SummaryWriter emits."""
    v = np.asarray(values, np.float64).ravel()
    if v.size == 0:
        v = np.zeros((1,))
    limits = [0.0]
    x = 1e-12
    while x < 1e20:
        limits.append(x)
        x *= 1.1
    limits = np.asarray(sorted(set([-l for l in limits] + limits)))
    counts, _ = np.histogram(v, bins=np.concatenate([[-np.inf], limits]))
    nz = np.nonzero(counts)[0]
    if nz.size:
        lo, hi = nz[0], nz[-1] + 1
        bucket_limit, bucket = limits[lo:hi], counts[lo:hi]
    else:  # pragma: no cover
        bucket_limit, bucket = limits[:1], counts[:1]
    return (_f_double(1, float(v.min())) + _f_double(2, float(v.max())) +
            _f_double(3, float(v.size)) + _f_double(4, float(v.sum())) +
            _f_double(5, float(np.square(v).sum())) +
            _f_packed_doubles(6, bucket_limit) +
            _f_packed_doubles(7, bucket))


def _summary_value(tag: str, *, simple: Optional[float] = None,
                   histo: Optional[bytes] = None) -> bytes:
    body = _f_bytes(1, tag.encode())
    if simple is not None:
        body += _f_float(2, float(simple))
    if histo is not None:
        body += _f_bytes(5, histo)
    return _f_bytes(1, body)  # Summary.value (repeated field 1)


def _event(step: int, summary_body: Optional[bytes] = None,
           file_version: Optional[str] = None,
           wall_time: Optional[float] = None) -> bytes:
    body = _f_double(1, time.time() if wall_time is None else wall_time)
    if file_version is not None:
        body += _f_bytes(3, file_version.encode())
    if step:
        body += _f_int(2, int(step))
    if summary_body is not None:
        body += _f_bytes(5, summary_body)
    return body


class EventWriter:
    """Append-only tfevents writer (scalars + histograms)."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname()
        name = f"events.out.tfevents.{int(time.time())}.{host}{filename_suffix}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._record(_event(0, file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        val = float(np.asarray(value))
        if not np.isfinite(val):
            val = float(np.nan_to_num(val))
        self._record(_event(step, _summary_value(tag, simple=val),
                            wall_time=wall_time))

    def add_histogram(self, tag: str, values, step: int) -> None:
        self._record(_event(
            step, _summary_value(tag, histo=_histogram_proto(values))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
