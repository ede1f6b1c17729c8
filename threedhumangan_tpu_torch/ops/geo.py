"""K1: fused geo features (1-NN + gather + canonicalisation).

Replaces threedhumangan_tpu/ops/geo.py::_geo_kernel (Pallas).  For every
field point: the nearest posed SMPL vertex (lowest index on exact ties), that
vertex's [blended inverse-FK 4x4 (16); T-pose xyz (3)] row, and from them
the 31-d conditioning of ``models.smpl.get_geo_features``.

``geo_features`` launches csrc/geo.cu on a CUDA tensor and runs
``geo_features_plain`` on a CPU tensor.  Both form the squared distance the
same way — elementwise ``((px-vx)^2 + (py-vy)^2) + (pz-vz)^2`` in float32,
each op rounded once — so the kernel's argmin (strict-less scan, lowest
index wins) is bit-identical to the plain version's ``argmin``.
"""

from __future__ import annotations

import torch

from threedhumangan_tpu_torch import _build

GEO_DIM = 31
VFEAT_DIM = 19  # blended inverse-FK (16) + T-pose xyz (3)

launches = 0  # K1 launches (the CUDA path only)


def build_vertex_features(tpose_vertices: torch.Tensor, fk_matrices: torch.Tensor,
                          lbs_weights: torch.Tensor) -> torch.Tensor:
    """Per-vertex [blended inverse-FK (16); T-pose (3)] table (B, V, 19)."""
    B, V, _ = tpose_vertices.shape
    ik = torch.linalg.inv_ex(fk_matrices.float()).inverse  # no error check: no host sync
    vertex_ik = torch.einsum("bvj,bjkl->bvkl", lbs_weights.float(), ik)
    return torch.cat([vertex_ik.reshape(B, V, 16), tpose_vertices.float()], -1).contiguous()


def nearest_vertex(points: torch.Tensor, vertices: torch.Tensor, point_chunk: int = 2048,
                   vertex_chunk: int | None = None):
    """1-NN of every point among the vertices: (squared distance (B, P),
    index (B, P) int64), lowest index on exact ties.  Vertex chunks merge
    in ascending order with a strict-less compare, as the kernel does."""
    B, P, _ = points.shape
    V = vertices.shape[1]
    vertex_chunk = vertex_chunk or V
    best_d = torch.empty(B, P, dtype=torch.float32, device=points.device)
    best_i = torch.empty(B, P, dtype=torch.int64, device=points.device)
    for p0 in range(0, P, point_chunk):
        p = points[:, p0:p0 + point_chunk].float()
        d_run = i_run = None
        for v0 in range(0, V, vertex_chunk):
            v = vertices[:, v0:v0 + vertex_chunk].float()
            d = None
            for c in range(3):
                dc = p[:, :, None, c] - v[:, None, :, c]
                dc = dc * dc
                d = dc if d is None else d + dc
            idx = torch.argmin(d, dim=-1)
            dmin = torch.gather(d, -1, idx[..., None])[..., 0]
            idx = idx + v0
            if d_run is None:
                d_run, i_run = dmin, idx
            else:
                better = dmin < d_run
                d_run = torch.where(better, dmin, d_run)
                i_run = torch.where(better, idx, i_run)
        best_d[:, p0:p0 + point_chunk] = d_run
        best_i[:, p0:p0 + point_chunk] = i_run
    return best_d, best_i


def geo_features_plain(points, vertices, vfeat, skeletons, legacy_mode: bool = False,
                       point_chunk: int = 2048, vertex_chunk: int | None = None):
    """Plain PyTorch K1: returns (features (B, P, 31) f32, index (B, P))."""
    points = points.float()
    d2, idx = nearest_vertex(points, vertices, point_chunk, vertex_chunk)
    diff = points[:, :, None, :] - skeletons.float()[:, None, :, :]
    joint_dists = torch.sqrt(torch.sum(diff * diff, -1) + 1e-12) / 2.4
    g = torch.gather(vfeat.float(), 1, idx[..., None].expand(*idx.shape, VFEAT_DIM))
    x, y, z = points[..., 0], points[..., 1], points[..., 2]

    def row(i):
        return g[..., 4 * i] * x + g[..., 4 * i + 1] * y + g[..., 4 * i + 2] * z + g[..., 4 * i + 3]

    cano = torch.stack([row(0) / 2.0, (row(1) + 0.2) / 2.0, row(2) / 1.3], -1)
    tpose = torch.stack([g[..., 16], g[..., 17], g[..., 18] / 0.2], -1)
    ndist = (torch.sqrt(d2) / 1.3)[..., None]
    cols = ([joint_dists, cano, tpose, ndist] if legacy_mode
            else [cano, joint_dists, tpose, ndist])
    return torch.cat(cols, -1), idx


def geo_features(points, vertices, vfeat, skeletons, legacy_mode: bool = False,
                 return_index: bool = False):
    """(B, P, 31) f32 geo features (and the (B, P) nearest-vertex index when
    ``return_index``).  CUDA tensors launch K1; CPU tensors take the plain
    version."""
    if points.device.type == "cpu":
        feats, idx = geo_features_plain(points, vertices, vfeat, skeletons, legacy_mode)
        return (feats, idx.to(torch.int32)) if return_index else feats
    if points.device.type != "cuda":
        raise ValueError(f"geo_features: unsupported device {points.device}")
    return _geo_cuda(points, vertices, vfeat, skeletons, legacy_mode, return_index)


def _check(t: torch.Tensor, name: str, shape, device):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: needs contiguous float32 on {device}, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _geo_cuda(points, vertices, vfeat, skeletons, legacy_mode, return_index):
    global launches
    B, P, _ = points.shape
    V, J = vertices.shape[1], skeletons.shape[1]
    dev = points.device
    _check(points, "points", (B, P, 3), dev)
    _check(vertices, "vertices", (B, V, 3), dev)
    _check(vfeat, "vfeat", (B, V, VFEAT_DIM), dev)
    _check(skeletons, "skeletons", (B, J, 3), dev)
    if J + 7 != GEO_DIM:
        raise ValueError(f"geo kernel writes {GEO_DIM} features, i.e. takes 24 joints, got {J}")
    out = torch.empty(B, P, GEO_DIM, dtype=torch.float32, device=dev)
    idx = torch.empty(B, P, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.thgt_geo(points.data_ptr(), vertices.data_ptr(), vfeat.data_ptr(),
                           skeletons.data_ptr(), out.data_ptr(), idx.data_ptr(),
                           B, P, V, J, int(legacy_mode), stream)
    _build.check(err, "thgt_geo")
    launches += 1
    return (out, idx) if return_index else out
