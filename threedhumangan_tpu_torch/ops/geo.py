"""K1: fused geo features (1-NN + gather + canonicalisation).

Replaces threedhumangan_tpu/ops/geo.py::_geo_kernel (Pallas).  For every
field point: the nearest posed SMPL vertex (lowest index on exact ties), that
vertex's [blended inverse-FK 4x4 (16); T-pose xyz (3)] row, and from them
the 31-d conditioning of ``models.smpl.get_geo_features``.

``geo_features`` launches csrc/geo.cu on a CUDA tensor and runs
``geo_features_plain`` on a CPU tensor.  Both form the squared distance the
same way — elementwise ``((px-vx)^2 + (py-vy)^2) + (pz-vz)^2`` in float32,
each op rounded once — so the kernel's argmin is bit-identical to the plain
version's ``argmin``.

The kernel (and K6's, ops/knn.py) searches the vertex clusters that
``vertex_clusters`` builds (csrc/nn_clusters.cu; ``vertex_clusters_plain``
is its plain version): a warp takes a tile of 32 points and scans only
the clusters whose box lies no farther from the tile's points' box than the
warp's largest current best (csrc/nn_prune.cuh).  The tiles group points
that lie close together when the caller passes the points' ``ray_layout`` =
(rays a row, points a ray); the result is the same with or without it.
"""

from __future__ import annotations

import torch

from threedhumangan_tpu_torch import _build

GEO_DIM = 31
VFEAT_DIM = 19  # blended inverse-FK (16) + T-pose xyz (3)

CLUSTER = 32        # vertices a cluster (csrc/nn_prune.cuh kCluster)
MAX_VERTS = 8192    # the cluster table lies whole in a CTA's shared memory

launches = 0           # K1 launches (the CUDA path only)
launches_clusters = 0  # vertex_clusters launches (K1's and K6's, CUDA only)


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


def _spread(x: torch.Tensor) -> torch.Tensor:
    """The 6 low bits of x spread to every third bit (csrc/nn_clusters.cu)."""
    x = x & 0x3F
    x = (x | (x << 8)) & 0x0000F00F
    x = (x | (x << 4)) & 0x000C30C3
    return (x | (x << 2)) & 0x00249249


def vertex_clusters_plain(vertices: torch.Tensor):
    """Plain version of csrc/nn_clusters.cu, bit for bit: per image, the
    vertices (B, V, 3) in the order of (Morton code of their cell in a 64^3
    grid over the image's box, index), cut into clusters of ``CLUSTER``,
    each cluster's members in ascending index.  Returns (table (B, n *
    CLUSTER, 4) float32: x, y, z and the original index's int32 bits,
    padded with NaN vertices of index 2^31 - 1; boxes (B, n, 8) float32:
    min xyz, 0, max xyz, 0), n = ceil(V / CLUSTER)."""
    v = vertices.float()
    B, V, _ = v.shape
    _check_vertex_count(V)
    n = -(-V // CLUSTER)
    lo, hi = v.amin(1, keepdim=True), v.amax(1, keepdim=True)
    extent = torch.clamp(hi - lo, min=1e-30)
    scale = torch.full_like(extent, 63.0) / extent  # true division, as __fdiv_rn
    cell = torch.clamp(((v - lo) * scale).to(torch.int32), max=63).to(torch.int64)
    code = _spread(cell[..., 0]) | (_spread(cell[..., 1]) << 1) | (_spread(cell[..., 2]) << 2)
    index = torch.arange(V, device=v.device)
    order = torch.argsort((code << 13) | index, dim=1)  # distinct keys: one order
    pad = n * CLUSTER - V
    member = torch.cat([order, order.new_full((B, pad), 2**31 - 1)], 1).reshape(B, n, CLUSTER)
    member = torch.sort(member, dim=-1).values.reshape(B, n * CLUSTER)
    real = member < V
    xyz = torch.gather(v, 1, torch.where(real, member, 0)[..., None].expand(-1, -1, 3))
    nan = torch.tensor(0x7FC00000, dtype=torch.int32).view(torch.float32)
    xyz = torch.where(real[..., None], xyz, nan.to(v.device))
    table = torch.cat([xyz, member.to(torch.int32).view(torch.float32)[..., None]], -1)
    inf = float("inf")
    r3 = real.reshape(B, n, CLUSTER, 1)
    c3 = xyz.reshape(B, n, CLUSTER, 3)
    zero = torch.zeros(B, n, 1, device=v.device)
    boxes = torch.cat([torch.where(r3, c3, inf).amin(2), zero,
                       torch.where(r3, c3, -inf).amax(2), zero], -1)
    return table.contiguous(), boxes.contiguous()


def _check_vertex_count(V: int):
    # the table lies in a CTA's shared memory; the sort key holds 13 index bits
    if not 0 < V <= MAX_VERTS:
        raise ValueError(f"vertices: the kernels take 1 to {MAX_VERTS} vertices, got {V}")


def vertex_clusters(vertices: torch.Tensor):
    """``vertex_clusters_plain``'s (table, boxes) of CUDA vertices, by
    csrc/nn_clusters.cu."""
    global launches_clusters
    B, V, _ = vertices.shape
    dev = vertices.device
    _check(vertices, "vertices", (B, V, 3), dev)
    _check_vertex_count(V)
    n = -(-V // CLUSTER)
    table = torch.empty(B, n * CLUSTER, 4, dtype=torch.float32, device=dev)
    boxes = torch.empty(B, n, 8, dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.thgt_nn_clusters(vertices.data_ptr(), table.data_ptr(), boxes.data_ptr(),
                                   B, V, n, stream)
    _build.check(err, "thgt_nn_clusters")
    launches_clusters += 1
    return table, boxes


def ray_layout_args(P: int, ray_layout) -> tuple:
    """(row_len, steps) of the C entries: (0, 0) without a layout."""
    if ray_layout is None:
        return 0, 0
    row_len, steps = (int(x) for x in ray_layout)
    if row_len <= 0 or steps <= 0 or P % steps:
        raise ValueError(f"ray_layout {tuple(ray_layout)}: needs rays a row > 0 and points a "
                         f"ray > 0 dividing the {P} points")
    return row_len, steps


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
                 return_index: bool = False, ray_layout=None):
    """(B, P, 31) f32 geo features (and the (B, P) nearest-vertex index when
    ``return_index``).  CUDA tensors launch K1; CPU tensors take the plain
    version.  ``ray_layout`` = (rays a row, points a ray) of the points, if
    they are rays x steps (rays row-major): the kernel then tiles points that
    lie close together; the result does not depend on it."""
    if points.device.type == "cpu":
        ray_layout_args(points.shape[1], ray_layout)
        feats, idx = geo_features_plain(points, vertices, vfeat, skeletons, legacy_mode)
        return (feats, idx.to(torch.int32)) if return_index else feats
    if points.device.type != "cuda":
        raise ValueError(f"geo_features: unsupported device {points.device}")
    return _geo_cuda(points, vertices, vfeat, skeletons, legacy_mode, return_index, ray_layout)


def _check(t: torch.Tensor, name: str, shape, device):
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: needs contiguous float32 on {device}, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _geo_cuda(points, vertices, vfeat, skeletons, legacy_mode, return_index, ray_layout=None,
              pairs: torch.Tensor | None = None):
    """Launch the cluster build and K1: features (B, P, 31) (and the index
    (B, P) int32 when ``return_index``).  ``pairs``, a (1,) int64 tensor on
    the device, receives the (point, vertex) pairs the search scanned (None
    on the main path)."""
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
    row_len, steps = ray_layout_args(P, ray_layout)
    table, boxes = vertex_clusters(vertices)
    out = torch.empty(B, P, GEO_DIM, dtype=torch.float32, device=dev)
    idx = torch.empty(B, P, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.thgt_geo(points.data_ptr(), table.data_ptr(), boxes.data_ptr(),
                           vfeat.data_ptr(), skeletons.data_ptr(), out.data_ptr(), idx.data_ptr(),
                           pairs_ptr(pairs, dev), B, P, V, boxes.shape[1], J, int(legacy_mode),
                           row_len, steps, stream)
    _build.check(err, "thgt_geo")
    launches += 1
    return (out, idx) if return_index else out


def pairs_ptr(pairs, dev):
    """The device pointer of a scanned-pairs counter (K1, K6), or None."""
    if pairs is None:
        return None
    if pairs.device != dev or pairs.dtype != torch.int64 or pairs.numel() != 1:
        raise ValueError(f"pairs: needs one int64 on {dev}, got {pairs.dtype} {tuple(pairs.shape)} "
                         f"on {pairs.device}")
    return pairs.data_ptr()
