"""K6: 1-NN search of field points among the posed SMPL vertices.

Replaces threedhumangan_tpu/ops/knn.py: ``_nn_kernel`` (Pallas), which
``models.smpl.get_geo_features`` runs when the fused geo kernel is off
(``use_pallas_geo=False``, ``use_pallas_knn=True``), and ``knn_points``,
the XLA formulation it runs with both off.

``nn_points`` launches csrc/knn.cu on a CUDA tensor and runs
``nn_points_plain`` on a CPU tensor.  Both form the squared distance
elementwise, in the op order of ``ops.geo.nearest_vertex`` (which the plain
version is), so the kernel's argmin — lowest index on exact ties — is
bit-identical to the plain version's.  The kernel is K1's pruned search on
``ops.geo.vertex_clusters`` without the features, and takes K1's
``ray_layout``.  The TPU kernel expands
``|p|^2 - 2 p.v + |v|^2`` for its matrix unit; the two forms differ by float32
rounding only.

``knn_points`` keeps the JAX package's expanded form and its k nearest
(pytorch3d ``knn_points`` semantics).  It is plain PyTorch on every device:
the JAX package has no kernel there either.
"""

from __future__ import annotations

from typing import Tuple

import torch

from threedhumangan_tpu_torch import _build
from threedhumangan_tpu_torch.ops.geo import (pairs_ptr, nearest_vertex, ray_layout_args,
                                              vertex_clusters)

launches = 0  # K6 launches (the CUDA path only)


def knn_points(points: torch.Tensor, verts: torch.Tensor, k: int = 1,
               chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest vertices of each point: (squared distances (B, P, k) float32,
    clamped at 0, ascending; indices (B, P, k) int64).  The distance matrix
    is formed in point chunks as ``|p|^2 - 2 p.v + |v|^2`` (the JAX order)."""
    points, verts = points.float(), verts.float()
    v_sq = torch.sum(torch.square(verts), -1)[:, None, :]  # (B, 1, V)
    dists, idx = [], []
    for p0 in range(0, points.shape[1], chunk):
        p = points[:, p0:p0 + chunk]
        cross = torch.matmul(p, verts.transpose(1, 2))
        d = torch.sum(torch.square(p), -1, keepdim=True) - 2.0 * cross + v_sq
        if k == 1:
            i = torch.argmin(d, -1, keepdim=True)
            dists.append(torch.gather(d, -1, i))
        else:
            neg, i = torch.topk(-d, k, -1)
            dists.append(-neg)
        idx.append(i)
    return torch.clamp(torch.cat(dists, 1), min=0.0), torch.cat(idx, 1)


def knn_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Features at the neighbour indices: x (B, V, C), idx (B, P, K) ->
    (B, P, K, C) (pytorch3d ``knn_gather`` semantics)."""
    B, P, K = idx.shape
    flat = idx.long().reshape(B, P * K, 1).expand(B, P * K, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(B, P, K, x.shape[-1])


def nn_points_plain(points: torch.Tensor, verts: torch.Tensor,
                    point_chunk: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K6: (squared distance (B, P, 1) float32, index (B, P, 1) int32)."""
    d, i = nearest_vertex(points, verts, point_chunk)
    return d[..., None], i.to(torch.int32)[..., None]


def nn_points(points: torch.Tensor, verts: torch.Tensor,
              ray_layout=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN of (B, P, 3) points among (B, V, 3) vertices: (squared distance
    (B, P, 1) float32, index (B, P, 1) int32).  CUDA tensors launch K6; CPU
    tensors take ``nn_points_plain``.  ``ray_layout`` as in
    ``ops.geo.geo_features``: the result does not depend on it."""
    if points.device.type == "cpu":
        ray_layout_args(points.shape[1], ray_layout)
        return nn_points_plain(points, verts)
    if points.device.type != "cuda":
        raise ValueError(f"nn_points: unsupported device {points.device}")
    return nn_points_cuda(points, verts, ray_layout)


def nn_points_cuda(points: torch.Tensor, verts: torch.Tensor, ray_layout=None,
                   pairs: torch.Tensor | None = None):
    """Launch the cluster build and K6; same contract as
    ``nn_points_plain``.  ``pairs`` as in ``ops.geo._geo_cuda``."""
    global launches
    B, P, _ = points.shape
    V = verts.shape[1]
    dev = points.device
    for name, t, shape in (("points", points, (B, P, 3)), ("verts", verts, (B, V, 3))):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32 on {dev}, got {t.dtype} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if V == 0:
        raise ValueError("verts: no vertices")
    row_len, steps = ray_layout_args(P, ray_layout)
    table, boxes = vertex_clusters(verts)
    dist = torch.empty(B, P, 1, dtype=torch.float32, device=dev)
    idx = torch.empty(B, P, 1, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.thgt_nn(points.data_ptr(), table.data_ptr(), boxes.data_ptr(), dist.data_ptr(),
                          idx.data_ptr(), pairs_ptr(pairs, dev), B, P, V, boxes.shape[1],
                          row_len, steps, stream)
    _build.check(err, "thgt_nn")
    launches += 1
    return dist, idx
