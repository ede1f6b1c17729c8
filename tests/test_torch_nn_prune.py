"""The pruned 1-NN search of K1 and K6 (threedhumangan_tpu_torch/csrc/
nn_prune.cuh, nn_clusters.cu) on the CPU: the cluster build's plain version
(ops/geo.py::vertex_clusters_plain), a mirror of the kernels' tile map
(``warp_tiles``, its patch read from nn_prune.cuh) and an emulation of the kernels' warp search with the kernels' bound, held to the
brute-force ``nearest_vertex`` exactly.  The kernels themselves are checked
against the plain versions by chip_smoke.py on the card.  Inputs are made
from seeds with numpy; no JAX function is compiled here."""

import re
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from threedhumangan_tpu_torch.models.smpl import get_geo_features, synthetic_smpl_model
from threedhumangan_tpu_torch.ops import geo, knn

INT_MAX = 2**31 - 1
HEADER = (Path(__file__).resolve().parents[1] / "threedhumangan_tpu_torch" / "csrc"
          / "nn_prune.cuh").read_text()


def _const(name):
    return int(re.search(rf"\b{name} = (\d+)", HEADER).group(1))


# a tile's rays a row, rows and steps under a ray layout (nn_prune.cuh)
PATCH = tuple(_const(k) for k in ("kPatchCols", "kPatchRows", "kPatchSteps"))


def warp_tiles(P, ray_layout=None):
    """The kernels' tiles (nn_prune.cuh tile_point): (tiles, 32) point
    indices, -1 where a lane has none.  Without a layout, 32 consecutive
    points; with (row_len, steps), lane l of a tile holds step
    PATCH[2] t_s + l // (PATCH[0] PATCH[1]) of the ray in row PATCH[1] t_r +
    (l // PATCH[0]) % PATCH[1], column PATCH[0] t_c + l % PATCH[0], the step
    group t_s running fastest over the tiles."""
    row_len, steps = geo.ray_layout_args(P, ray_layout)
    if not row_len:
        idx = torch.arange(-(-P // 32) * 32)
        return torch.where(idx < P, idx, -1).reshape(-1, 32)
    cols, rows_a_tile, steps_a_tile = PATCH
    assert cols * rows_a_tile * steps_a_tile == 32
    rays = P // steps
    rows = -(-rays // row_len)
    n_s, n_c = -(-steps // steps_a_tile), -(-row_len // cols)
    n_r = -(-rows // rows_a_tile)
    t = torch.arange(n_s * n_c * n_r)[:, None]
    lane = torch.arange(32)[None]
    patch = t // n_s
    s = (t % n_s) * steps_a_tile + lane // (cols * rows_a_tile)
    c = (patch % n_c) * cols + lane % cols
    r = (patch // n_c) * rows_a_tile + (lane // cols) % rows_a_tile
    ray = r * row_len + c
    ok = (c < row_len) & (s < steps) & (ray < rays)
    return torch.where(ok, ray * steps + s, -1)


def _body(seed=0, V=6890):
    """The slice's capsule body (synthetic_smpl_model(6890): 6,844
    vertices), posed by a seeded rigid turn and offset."""
    v = synthetic_smpl_model(num_verts=V).v_template.numpy()
    rs = np.random.RandomState(seed)
    a = rs.uniform(-np.pi, np.pi)
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    return (v @ rot.T + 0.1 * rs.randn(3)).astype(np.float32)


def _rays(verts, row_len, rows, steps, seed=0):
    """Points of a rows x row_len ray grid with `steps` samples a ray
    (rays row-major, steps contiguous) through the body's box, as a weak
    perspective camera's rays are: parallel, a span of depths each."""
    rs = np.random.RandomState(seed)
    lo, hi = verts.min(0), verts.max(0)
    xs = np.linspace(lo[0] - 0.3, hi[0] + 0.3, row_len)
    ys = np.linspace(lo[1] - 0.1, hi[1] + 0.1, rows)
    zs = np.linspace(-1.2, 1.2, steps) + rs.uniform(-0.01, 0.01, steps)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    pts = np.stack([np.broadcast_to(gx.reshape(-1, 1), (rows * row_len, steps)),
                    np.broadcast_to(gy.reshape(-1, 1), (rows * row_len, steps)),
                    np.broadcast_to(zs, (rows * row_len, steps))], -1)
    return pts.reshape(-1, 3).astype(np.float32)


def _case(name):
    """(points (P, 3), vertices (V, 3), ray_layout) of one input set."""
    rs = np.random.RandomState(zlib.crc32(name.encode()))
    body = _body()
    if name == "body":
        return _rays(body, 48, 8, 32), body, (48, 32)
    if name == "body_consecutive":  # no layout: tiles of 32 consecutive points
        return _rays(body, 48, 6, 32), body, None
    if name == "shuffled":
        return _rays(body, 48, 6, 32, 1), body[rs.permutation(len(body))], (48, 32)
    if name == "duplicated":  # 40 copies of one vertex span two clusters; each vertex twice
        half = body[::2]
        v = np.concatenate([half, half, np.repeat(half[:1], 40, 0)])
        pts = np.concatenate([v[rs.randint(0, len(v), 500)], _rays(body, 10, 10, 5)])
        return pts[: len(pts) // 5 * 5], v, (10, 5)
    if name == "on_and_between":  # points on vertices and at midpoints of pairs
        v = body[rs.permutation(len(body))[:3000]]
        i, j = rs.randint(0, len(v), 800), rs.randint(0, len(v), 800)
        pts = np.concatenate([v[i], 0.5 * (v[i] + v[j]), v[:64]])
        return pts, v, None
    if name == "ragged_grid":  # 5 rays a row, 3 steps, a last row of 3 rays
        return _rays(body, 5, 21, 3)[: 103 * 3], body, (5, 3)
    if name == "v100":
        v = rs.randn(100, 3).astype(np.float32)
        return rs.randn(300, 3).astype(np.float32), v, (10, 3)
    if name == "v7":
        v = rs.randn(7, 3).astype(np.float32)
        return rs.randn(70, 3).astype(np.float32), np.concatenate([v, v[:2]]), (7, 2)
    raise KeyError(name)


CASES = ["body", "body_consecutive", "shuffled", "duplicated", "on_and_between", "ragged_grid",
         "v100", "v7"]


def _lower_bound_keys(pts, valid, boxes):
    """The kernel's keys (nn_prune.cuh warp_search): the rounded squared gap
    between each tile's point box and each cluster's box, its low 8 bits
    replaced by the cluster's number."""
    inf = torch.tensor(float("inf"))
    lo = torch.where(valid[..., None], pts, inf).amin(1)[:, None]   # (T, 1, 3)
    hi = torch.where(valid[..., None], pts, -inf).amax(1)[:, None]
    mn, mx = boxes[None, :, :3], boxes[None, :, 4:7]
    g = torch.clamp(torch.maximum(mn - hi, lo - mx), min=0.0)       # (T, n, 3)
    lb = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
    c = torch.arange(boxes.shape[0])
    return (lb.view(torch.int32).to(torch.int64) & ~0xFF) | c, lb


def _nn_dist(p, v):
    dx, dy, dz = (p[..., k] - v[..., k] for k in range(3))
    return (dx * dx + dy * dy) + dz * dz


def emulate_search(points, table, boxes, V, tiles):
    """The kernels' warp search, one tile a row: clusters in ascending key
    order until a key's bound exceeds the largest best of the tile's valid
    lanes; a cluster scanned in member order with a strict-less compare from
    +inf, merged by distance then original index.  Returns (distance (P,),
    index (P,), pairs scanned)."""
    tiles = tiles[(tiles >= 0).any(1)]
    valid = tiles >= 0
    pts = points[tiles.clamp(min=0)]                                 # (T, 32, 3)
    keys, _ = _lower_bound_keys(pts, valid, boxes)
    order = torch.argsort(keys, 1)
    T, n = keys.shape
    inf_bits = 0x7F800000
    best = torch.full((T, 32), float("inf"))
    best_i = torch.full((T, 32), INT_MAX, dtype=torch.int64)
    worst = torch.full((T,), inf_bits, dtype=torch.int64)
    live = torch.ones(T, dtype=torch.bool)
    n_valid = valid.sum(1)
    pairs = 0
    members = table.reshape(n, geo.CLUSTER, 4)
    index = table[:, 3].contiguous().view(torch.int32).to(torch.int64).reshape(n, geo.CLUSTER)
    counts = torch.clamp(V - torch.arange(n) * geo.CLUSTER, max=geo.CLUSTER)
    for k in range(n):
        c = order[:, k]
        live &= (keys[torch.arange(T), c] & ~0xFF) <= worst
        if not live.any():
            break
        d = _nn_dist(pts[:, :, None, :], members[c][:, None, :, :3])  # (T, 32, 32)
        d = torch.where(torch.isnan(d), float("inf"), d)
        cb, at = d.min(-1)                                           # first minimum: strict-less
        ci = torch.where(cb < float("inf"), torch.gather(index[c], 1, at), INT_MAX)
        better = live[:, None] & ((cb < best) | ((cb == best) & (ci < best_i)))
        best, best_i = torch.where(better, cb, best), torch.where(better, ci, best_i)
        worst = torch.where(valid, best, 0.0).amax(1).view(torch.int32).to(torch.int64)
        pairs += int((live * n_valid * counts[c]).sum())
    best_i = torch.where(best_i == INT_MAX, 0, best_i)
    d_out = torch.empty(len(points))
    i_out = torch.empty(len(points), dtype=torch.int64)
    d_out[tiles[valid]], i_out[tiles[valid]] = best[valid], best_i[valid]
    return d_out, i_out, pairs


@pytest.mark.parametrize("name", ["body", "shuffled", "duplicated", "v100", "v7"])
def test_vertex_clusters_complete_and_boxed(name):
    """The build's plain version: every vertex once, in clusters cut from
    the Morton order, members by index, NaN padding at the end, tight boxes."""
    _, verts, _ = _case(name)
    v = torch.as_tensor(verts)[None]
    table, boxes = geo.vertex_clusters_plain(v)
    V, n = v.shape[1], boxes.shape[1]
    assert n == -(-V // geo.CLUSTER) and table.shape == (1, n * geo.CLUSTER, 4)
    member = table[0, :, 3].contiguous().view(torch.int32).to(torch.int64)
    real = member != INT_MAX
    assert real.sum() == V and not real[V:].any()
    assert torch.equal(torch.sort(member[real]).values, torch.arange(V))
    assert torch.isnan(table[0, ~real, :3]).all()
    assert torch.equal(table[0, real, :3], v[0, member[real]])
    m = member.reshape(n, geo.CLUSTER)
    assert ((m[:, 1:] > m[:, :-1]) | (m[:, 1:] == INT_MAX)).all()
    # the clusters are consecutive runs of the (Morton code, index) order
    lo, hi = v[0].amin(0), v[0].amax(0)
    cell = torch.clamp(((v[0] - lo) * (torch.full_like(lo, 63.0) / (hi - lo))).to(torch.int32),
                       max=63).to(torch.int64)
    code = sum(((cell[:, a:a + 1] >> torch.arange(6)) & 1) << (3 * torch.arange(6) + a)
               for a in range(3)).sum(1)  # bit b of axis a at 3 b + a
    ref = torch.argsort((code << 13) | torch.arange(V))
    for c in range(n):
        run = ref[c * geo.CLUSTER:(c + 1) * geo.CLUSTER]
        assert torch.equal(torch.sort(run).values, m[c][m[c] != INT_MAX])
        xyz = v[0, run]
        assert torch.equal(boxes[0, c, :3], xyz.amin(0)) and torch.equal(boxes[0, c, 4:7], xyz.amax(0))
    assert (boxes[0, :, 3] == 0).all() and (boxes[0, :, 7] == 0).all()


@pytest.mark.parametrize("name", CASES)
def test_search_emulation_matches_nearest_vertex(name):
    """The warp search with the kernels' bound and stop rule returns
    nearest_vertex's distance and index exactly, and scans fewer pairs than
    brute force on the body's ray grids."""
    points, verts, layout = _case(name)
    p, v = torch.as_tensor(points), torch.as_tensor(verts)
    table, boxes = geo.vertex_clusters_plain(v[None])
    tiles = warp_tiles(len(p), layout)
    d, i, pairs = emulate_search(p, table[0], boxes[0], len(v), tiles)
    ref_d, ref_i = geo.nearest_vertex(p[None], v[None])
    assert torch.equal(d, ref_d[0]) and torch.equal(i, ref_i[0])
    share = pairs / (len(p) * len(v))
    assert 0 < share <= 1
    if name in ("body", "shuffled"):
        assert share < 0.5, share


def test_lower_bound_never_exceeds_a_rounded_distance():
    """Rounding is monotone, so the bound formed with nn_dist's ops from the
    boxes' gaps is <= every (point, member) distance as nn_dist rounds it,
    also where points and members sit a few ulps from the boxes' faces, far
    from the origin."""
    rs = np.random.RandomState(3)
    for scale in (1e-3, 1.0, 1e3):
        base = scale * rs.randn(64, 1, 3)
        pts = (base + scale * 1e-6 * rs.randn(64, 32, 3)).astype(np.float32)
        verts = (base[:, :, :] + scale * 1e-6 * rs.randn(64, 32, 3)
                 + scale * 1e-6 * rs.randint(0, 3, (64, 1, 3))).astype(np.float32)
        p, v = torch.as_tensor(pts), torch.as_tensor(verts)
        boxes = torch.cat([v.amin(1), torch.zeros(64, 1), v.amax(1), torch.zeros(64, 1)], -1)
        _, lb = _lower_bound_keys(p, torch.ones(64, 32, dtype=torch.bool), boxes)  # (64, 64)
        d = _nn_dist(p[:, None, :, None, :], v[None, :, None, :, :])              # (64, 64, 32, 32)
        assert (lb[..., None, None] <= d).all()
        assert (lb > 0).any()


@pytest.mark.parametrize("P,layout", [(1000, None), (309, (5, 3)), (48 * 96 * 32, (48, 32)),
                                      (24, (4, 2)), (6 * 7 * 5, (7, 5))])
def test_warp_tiles_hold_every_point_once(P, layout):
    tiles = warp_tiles(P, layout)
    got = tiles[tiles >= 0]
    assert torch.equal(torch.sort(got).values, torch.arange(P))
    if layout is not None:  # a tile's points lie in one patch of 4 x 4 rays and 2 steps
        row_len, steps = layout
        for t in tiles[(tiles >= 0).sum(1) > 1][:50]:
            t = t[t >= 0]
            ray, s = t // steps, t % steps
            assert (ray % row_len).max() - (ray % row_len).min() < 4
            assert (ray // row_len).max() - (ray // row_len).min() < 4
            assert s.max() - s.min() < 2


def test_layout_does_not_change_the_cpu_output():
    """geo_features, nn_points and get_geo_features on the CPU give the same
    output with and without the ray layout, and refuse a layout that does
    not divide the points."""
    points, verts, layout = _case("ragged_grid")
    rs = np.random.RandomState(5)
    p, v = torch.as_tensor(points)[None], torch.as_tensor(verts)[None]
    V = v.shape[1]
    vfeat = torch.as_tensor(rs.randn(1, V, geo.VFEAT_DIM).astype(np.float32))
    skel = torch.as_tensor(rs.randn(1, 24, 3).astype(np.float32))
    a = geo.geo_features(p, v, vfeat, skel, return_index=True)
    b = geo.geo_features(p, v, vfeat, skel, return_index=True, ray_layout=layout)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(knn.nn_points(p, v), knn.nn_points(p, v, layout)))
    tpose = torch.as_tensor(rs.randn(1, V, 3).astype(np.float32))
    fk = torch.eye(4).expand(1, 24, 4, 4).contiguous()
    lbs = torch.full((1, V, 24), 1.0 / 24)
    for flags in (dict(), dict(use_pallas_geo=False)):
        x = get_geo_features(p, skel, v, tpose, fk, lbs, **flags)
        y = get_geo_features(p, skel, v, tpose, fk, lbs, ray_layout=layout, **flags)
        assert torch.equal(x, y)
    for bad in ((5, 4), (0, 3), (5, 0)):
        with pytest.raises(ValueError):
            geo.geo_features(p, v, vfeat, skel, ray_layout=bad)
        with pytest.raises(ValueError):
            knn.nn_points(p, v, bad)


def test_python_constants_match_the_kernels():
    """ops/geo.py's cluster size and vertex limit are nn_prune.cuh's."""
    assert geo.CLUSTER == _const("kCluster") and geo.MAX_VERTS == _const("kMaxVerts")
    assert PATCH == (4, 4, 2)  # tile_point's lane map is written for this patch


def test_more_vertices_than_a_table_holds_are_refused():
    """The kernels keep an image's clusters in one CTA's shared memory and
    13 index bits in the build's sort key: more than MAX_VERTS vertices is
    a ValueError, from the build's plain version too."""
    v = torch.zeros(1, geo.MAX_VERTS + 1, 3)
    with pytest.raises(ValueError, match="vertices"):
        geo.vertex_clusters_plain(v)
    table, boxes = geo.vertex_clusters_plain(torch.zeros(1, geo.MAX_VERTS, 3))
    assert table.shape == (1, geo.MAX_VERTS, 4) and boxes.shape == (1, geo.MAX_VERTS // 32, 8)
