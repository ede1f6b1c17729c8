"""What K7 (threedhumangan_tpu_torch/csrc/rasterize.cu) relies on, in plain
form on the CPU: the valid candidate rows of ``bin_candidates`` form a
prefix; the warps' sub-tiles (their size read from rasterize.cu) cover every
pixel of a tile once; and the sub-tile cull, mirrored here in torch with the
kernel's formula and constants, never drops a (sub-tile, candidate) pair for
which ``rasterize_tiles_plain``'s arithmetic finds a pixel inside, on random
meshes, slivers, edges through pixel centres and tiled duplicate quads, at
tiles of 16 and 20 pixels (a ragged last sub-tile).  An
emulation of the culled z-test is held to the plain version bit for bit.
The kernel itself is checked against the plain version by chip_smoke.py on
the card.  Inputs are made from seeds with numpy; no JAX function is
compiled here."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.ops import rasterize as ras

SOURCE = (Path(__file__).resolve().parents[1] / "threedhumangan_tpu_torch" / "csrc"
          / "rasterize.cu").read_text()


def _const(name):
    text = re.search(rf"constexpr \w+ {name} = ([^;]+);", SOURCE).group(1).strip().rstrip("f")
    return float.fromhex(text) if "0x" in text else float(text)


SUB_W, SUB_H = int(_const("kSubW")), int(_const("kSubH"))
REL, REL0, ABS, HUGE = (_const(k) for k in ("kRel", "kRel0", "kAbs", "kHuge"))
SIZE = (64, 32)


def _body(num_verts=128, num_faces=320, B=2, seed=3):
    """A synthetic body with z spread so the z-test matters, a scaled copy
    per extra image (320 faces tile the 224 quads: duplicate faces)."""
    model = synthetic_smpl_model(seed=seed, num_verts=num_verts, num_faces=num_faces)
    v = model.v_template.numpy()[None] * np.float32(1.2)
    z = 1.5 + 0.3 * (v[..., 2] - v[..., 2].min())
    vs = np.concatenate([v[..., :2], z[..., None]], -1)
    vs = np.concatenate([vs * np.float32(0.9 ** i) for i in range(B)], 0).astype(np.float32)
    return vs, model.faces.astype(np.int64)


def _grid_centres(size, tile):
    """Every pixel centre of the padded tile grid, as the plain version
    rounds it: (px (W_pad,), py (H_pad,)) float32 in image columns / rows."""
    tiles_y, tiles_x, x_step, y_step, span = ras._grid(size, tile)
    f32 = torch.float32
    c = torch.arange(tiles_x * tile)
    r = torch.arange(tiles_y * tile)
    x0 = -torch.tensor(span, dtype=f32) + ((c // tile) * tile).to(f32) * torch.tensor(x_step)
    y0 = -1.0 + ((r // tile) * tile).to(f32) * torch.tensor(y_step)
    return x0 + (c % tile).to(f32) * torch.tensor(x_step), y0 + (r % tile).to(f32) * torch.tensor(
        y_step)


def _slivers(n=600, seed=5):
    """Triangles whose rounded denom lies in (1e-9, 1e-6], their long edge on
    a pixel row or column so that pixel centres fall on or next to them."""
    rs = np.random.RandomState(seed)
    px, py = (t.numpy() for t in _grid_centres(SIZE, 16))
    out = []
    while len(out) < n:
        a = np.asarray([px[rs.randint(len(px))], py[rs.randint(len(py))]], np.float32)
        L = np.float32(rs.uniform(0.1, 0.8) * rs.choice([-1, 1]))
        h = np.float32(10 ** rs.uniform(-8.7, -5.7) / abs(L) * rs.choice([-1, 1]))
        t = np.float32(rs.uniform(0.0, 1.0))
        if rs.rand() < 0.5:
            b, c = a + [L, 0], a + [t * L, h]
        else:
            b, c = a + [0, L], a + [h, t * L]
        tri = np.stack([a, b, c]).astype(np.float32)
        v0, v1 = tri[1] - tri[0], tri[2] - tri[0]
        denom = np.float32(v0[0] * v1[1]) - np.float32(v0[1] * v1[0])
        if 1e-9 < abs(denom) <= 1e-6:
            out.append(np.concatenate([tri, rs.uniform(1, 2, (3, 1))], 1))
    verts = np.concatenate(out, 0).astype(np.float32)[None]
    return verts, np.arange(len(verts[0])).reshape(-1, 3)


def _edge_grid(seed=6):
    """Triangles with their vertices on pixel centres, edges along rows,
    columns and diagonals through further pixel centres."""
    rs = np.random.RandomState(seed)
    px, py = (t.numpy() for t in _grid_centres(SIZE, 16))
    out = []
    for _ in range(400):
        i, j = rs.randint(0, len(px) - 12), rs.randint(0, len(py) - 12)
        di, dj = rs.randint(1, 12, 2)
        corners = [(i, j), (i + di, j), (i, j + dj), (i + di, j + dj)]
        a, b, c = (corners[k] for k in rs.permutation(4)[:3])
        tri = [[px[x], py[y], 1.0 + rs.rand()] for x, y in (a, b, c)]
        out.append(tri)
    verts = np.asarray(out, np.float32).reshape(1, -1, 3)
    return verts, np.arange(verts.shape[1]).reshape(-1, 3)


def _quads(copies=3, seed=7):
    """A jittered grid of quads, two triangles each, repeated with equal z."""
    rs = np.random.RandomState(seed)
    n = 9
    gx, gy = np.meshgrid(np.linspace(-0.45, 0.45, n), np.linspace(-0.9, 0.9, n))
    v = np.stack([gx + 0.01 * rs.randn(n, n), gy + 0.01 * rs.randn(n, n),
                  np.full((n, n), 1.5)], -1).reshape(-1, 3)
    faces = []
    for r in range(n - 1):
        for c in range(n - 1):
            q = r * n + c
            faces += [[q, q + 1, q + n], [q + 1, q + n + 1, q + n]]
    return v.astype(np.float32)[None], np.tile(np.asarray(faces), (copies, 1))


CASES = {"body": _body, "slivers": _slivers, "edges": _edge_grid, "quads": _quads}


def _table(case, tile=16, kmax=256):
    vs, faces = CASES[case]()
    F = faces.shape[0]
    K = -(-min(kmax, F) // 64) * 64
    return ras.bin_candidates(torch.as_tensor(vs), torch.as_tensor(faces), SIZE, tile, K)


def subtile_map(tile):
    """(warps, 32) pixel index row * tile + col of each lane, -1 outside the
    tile (rasterize.cu: a warp takes SUB_W x SUB_H pixels)."""
    sub_x, sub_y = -(-tile // SUB_W), -(-tile // SUB_H)
    w = torch.arange(sub_x * sub_y)[:, None]
    lane = torch.arange(32)[None]
    col = (w % sub_x) * SUB_W + lane % SUB_W
    row = (w // sub_x) * SUB_H + lane // SUB_W
    return torch.where((col < tile) & (row < tile), row * tile + col, -1)


def _centres(T, tiles_x, tile, x_step, y_step, span):
    """(T, P) pixel centres as the plain version rounds them."""
    f32 = torch.float32
    lane = torch.arange(tile * tile)
    t = torch.arange(T)
    x_step, y_step, span = (torch.tensor(float(v), dtype=f32) for v in (x_step, y_step, span))
    x0 = -span + ((t % tiles_x) * tile).to(f32) * x_step
    y0 = -1.0 + ((t // tiles_x) * tile).to(f32) * y_step
    return (x0[:, None] + (lane % tile).to(f32)[None] * x_step,
            y0[:, None] + (lane // tile).to(f32)[None] * y_step)


def _coefficients(tri_k):
    """The kernel's fill: (B, T, K, 6) float32 [c1x c1y c1c c2x c2y c2c], ok."""
    ax, ay, _, bx, by, _, cx, cy, _, valid, _ = tri_k.unbind(-1)
    v0x, v0y, v1x, v1y = bx - ax, by - ay, cx - ax, cy - ay
    denom = v0x * v1y - v0y * v1x
    ok = (denom.abs() > 1e-9) & (valid > 0)
    inv = torch.where(ok, 1.0 / torch.where(ok, denom, torch.ones_like(denom)),
                      torch.zeros_like(denom))
    coef = torch.stack([inv * v1y, -inv * v1x, inv * (ay * v1x - ax * v1y),
                        -inv * v0y, inv * v0x, inv * (v0y * ax - v0x * ay)], -1)
    return coef, ok


def _inside(coef, ok, px, py):
    """rasterize_tiles_plain's inside test: (B, T, K, P)."""
    c = coef[..., None]
    px, py = px[None, :, None], py[None, :, None]
    w1 = c[..., 0, :] * px + c[..., 1, :] * py + c[..., 2, :]
    w2 = c[..., 3, :] * px + c[..., 4, :] * py + c[..., 5, :]
    w0 = 1.0 - w1 - w2
    return (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok[..., None], w0, w1, w2


def face_rows(coef, ok, mx, my):
    """The pre-pass's cull constants, op for op in float32: k1, k2, k0 and
    c1x + c2x, c1y + c2y; infinite constants where a coefficient is above
    HUGE in size or not finite."""
    c1x, c1y, c1c, c2x, c2y, c2c = coef.unbind(-1)
    a1 = (c1x.abs() * mx + c1y.abs() * my) + c1c.abs()
    a2 = (c2x.abs() * mx + c2y.abs() * my) + c2c.abs()
    k1, k2 = c1c + (REL * a1 + ABS), c2c + (REL * a2 + ABS)
    k0 = ((1.0 - c1c) - c2c) + (REL0 * ((a1 + a2) + 1.0) + ABS)
    wild = ~(coef.abs() <= HUGE).all(-1)
    k1, k2, k0 = (torch.where(wild, torch.inf, k) for k in (k1, k2, k0))
    return k1, k2, k0, c1x + c2x, c1y + c2y


def cover_masks(coef, ok, px, py, tile, mx, my):
    """The kernel's ``covers`` for every warp's sub-tile: (B, T, K, warps)
    bool, False only where the candidate is inside at no pixel of the
    sub-tile.  coef (B, T, K, 6) float32, ok (B, T, K); px, py (T, P) the
    plain version's pixel centres; mx, my the image's largest |px|, |py|."""
    c1x, c1y, _, c2x, c2y, _ = coef.unbind(-1)
    k1, k2, k0, sx, sy = face_rows(coef, ok, mx, my)
    sub_x, sub_y = -(-tile // SUB_W), -(-tile // SUB_H)
    xs, ys = px[:, :tile], py[:, ::tile]  # (T, tile): columns, rows
    t = lambda v: v[None, :, None]  # a (T,) per-tile value against (B, T, K)
    at = lambda c, lo, hi: torch.where(c >= 0, t(hi), t(lo))  # the larger product's corner
    keep = []
    for r in range(sub_y):
        ylo, yhi = ys[:, r * SUB_H], ys[:, min(r * SUB_H + SUB_H, tile) - 1]
        for j in range(sub_x):
            xlo, xhi = xs[:, j * SUB_W], xs[:, min(j * SUB_W + SUB_W, tile) - 1]
            x1, x2 = k1 + c1x * at(c1x, xlo, xhi), k2 + c2x * at(c2x, xlo, xhi)
            x0 = k0 - sx * at(sx, xhi, xlo)
            keep.append(~(x1 + c1y * at(c1y, ylo, yhi) < 0) & ~(x2 + c2y * at(c2y, ylo, yhi) < 0)
                        & ~(x0 - sy * at(sy, yhi, ylo) < 0))
    return ok[..., None] & torch.stack(keep, -1)


def _cull(tri_k, tile):
    """(keep (B, T, K, warps), inside (B, T, K, P), w0, w1, w2, pixel map)."""
    B, T, K, _ = tri_k.shape
    tiles_y, tiles_x, x_step, y_step, span = ras._grid(SIZE, tile)
    px, py = _centres(T, tiles_x, tile, x_step, y_step, span)
    coef, ok = _coefficients(tri_k)
    inside, w0, w1, w2 = _inside(coef, ok, px, py)
    mx, my = ras.pixel_bounds(SIZE, tile)
    assert mx >= float(px.abs().max()) and my >= float(py.abs().max())
    return (cover_masks(coef, ok, px, py, tile, mx, my), inside, (w0, w1, w2),
            subtile_map(tile))


@pytest.mark.parametrize("num_faces,kmax", [(320, 64), (320, 512), (40, 128)])
def test_valid_rows_are_a_prefix(num_faces, kmax):
    """topk's rows come sorted, so the valid ones lead every tile, also when
    K > F pads the table with never-valid columns."""
    vs, faces = _body(num_faces=num_faces)
    K = -(-min(kmax, faces.shape[0]) // 64) * 64 if kmax <= num_faces else kmax
    tri = ras.bin_candidates(torch.as_tensor(vs), torch.as_tensor(faces), SIZE, 16, K)
    valid = tri[..., 9] > 0
    assert valid.any() and (~valid).any()
    assert (valid[..., 1:] <= valid[..., :-1]).all()
    n = valid.sum(-1)
    assert (n <= min(K, num_faces)).all()


@pytest.mark.parametrize("tile", [32, 16, 8, 20])
def test_subtiles_cover_each_pixel_once(tile):
    m = subtile_map(tile)
    p = m[m >= 0]
    assert torch.equal(p.sort().values, torch.arange(tile * tile))
    assert m.shape[0] * 32 <= 1024


@pytest.mark.parametrize("tile", [16, 20])
@pytest.mark.parametrize("case", list(CASES))
def test_cull_never_drops_a_covered_pair(case, tile):
    tri = _table(case, tile)
    keep, inside, _, pix = _cull(tri, tile)
    covered = torch.stack([inside[..., p[p >= 0]].any(-1) for p in pix], -1)
    assert covered.any()
    assert not (covered & ~keep).any()
    valid = tri[..., 9] > 0
    share = float(keep.sum() / (valid.sum() * pix.shape[0]))
    if case in ("body", "quads"):  # the cull is no pass-through
        assert share < 0.5, share


def _emulate(tri, tile):
    """The culled z-test: a pixel tests only what its warp kept, the first
    strictly smallest z wins; (face (B, T, P), bary (B, T, P, 3), z)."""
    keep, inside, (w0, w1, w2), pix = _cull(tri, tile)
    P = tile * tile
    warp_of = torch.empty(P, dtype=torch.long)
    for w, p in enumerate(pix):
        warp_of[p[p >= 0]] = w
    keep_pix = keep[..., warp_of]  # (B, T, K, P)
    az, bz, cz = tri[..., 2, None], tri[..., 5, None], tri[..., 8, None]
    z = az + w1 * (bz - az) + w2 * (cz - az)
    zf = torch.where(inside & keep_pix, z, torch.full_like(z, ras.BIG))
    zmin, k = zf.min(2)
    pick = lambda v: torch.gather(v, 2, k[:, :, None])[:, :, 0]
    fid = tri[..., 10, None].expand_as(zf)
    hit = zmin < ras.BIG
    face = torch.where(hit, pick(fid), torch.full_like(zmin, -1.0)).to(torch.int32)
    bary = torch.stack([torch.where(hit, pick(w), torch.zeros_like(zmin)) for w in (w0, w1, w2)],
                       -1)
    return face, bary, zmin


@pytest.mark.parametrize("tile", [16, 20])
@pytest.mark.parametrize("case", list(CASES))
def test_culled_z_test_matches_plain(case, tile):
    tri = _table(case, tile)
    tiles_y, tiles_x, x_step, y_step, span = ras._grid(SIZE, tile)
    f, b, z = ras.rasterize_tiles_plain(tri, tiles_x, tile, x_step, y_step, span, k_chunk=64)
    fe, be, ze = _emulate(tri, tile)
    assert (f >= 0).any()
    assert torch.equal(f, fe)
    assert torch.equal(z, ze)
    assert torch.equal(b, be)


def _overlap(vs, faces, tile):
    """The pre-pass's test: (B, T, F) bool, face f's box overlaps tile t; a
    NaN corner overlaps nothing, as NaN boxes do in ``bin_candidates``."""
    tri = torch.as_tensor(vs)[:, torch.as_tensor(faces).reshape(-1)].reshape(
        vs.shape[0], -1, 3, 3)
    x0, x1, y0, y1 = ras.tile_edges(SIZE, tile, "cpu")[:, None, :, None]
    xs, ys = tri[..., 0], tri[..., 1]
    nan = (xs.isnan() | ys.isnan()).any(-1)[:, None]
    return ((xs.amin(-1)[:, None] <= x1) & (xs.amax(-1)[:, None] >= x0)
            & (ys.amin(-1)[:, None] <= y1) & (ys.amax(-1)[:, None] >= y0) & ~nan)


def bin_words(overlap):
    """The pre-pass's table: (B, T, ceil(F / 32)) words, bit f % 32 of word
    f // 32 set where face f overlaps the tile."""
    B, T, F = overlap.shape
    pad = torch.zeros(B, T, -(-F // 32) * 32 - F, dtype=torch.bool)
    bits = torch.cat([overlap, pad], -1).reshape(B, T, -1, 32).long()
    return (bits << torch.arange(32)).sum(-1)


def expand(words, K):
    """The kernel's list: each tile's first K set bits in index order, by a
    popcount prefix over its words; (B, T, K) face ids, -1 past the end."""
    B, T, W = words.shape
    bits = ((words[..., None] >> torch.arange(32)) & 1).bool()  # (B, T, W, 32)
    counts = bits.sum(-1)
    offset = counts.cumsum(-1) - counts  # exclusive prefix over the words
    rank = offset[..., None] + bits.long().cumsum(-1) - 1
    keep = bits & (rank < K)
    out = torch.full((B, T, K + 1), -1, dtype=torch.long)
    face = torch.arange(W * 32).reshape(W, 32).expand_as(bits)
    out.scatter_(-1, torch.where(keep, rank, K).reshape(B, T, -1), face.reshape(B, T, -1))
    return out[..., :K]


def compact(overlap, K):
    """Index-order compaction: the faces whose running count stays within K."""
    pos = overlap.long().cumsum(-1) - 1
    keep = overlap & (pos < K)
    out = torch.full(overlap.shape[:2] + (K + 1,), -1, dtype=torch.long)
    face = torch.arange(overlap.shape[-1]).expand_as(overlap)
    out.scatter_(-1, torch.where(keep, pos, K), face)
    return out[..., :K]


def _with_nan(vs, faces):
    vs = vs.copy()
    vs[0, faces[5, 1], 0] = np.nan
    vs[-1, faces[9, 2], 1] = np.nan
    return vs, faces


@pytest.mark.parametrize("case,kmax", [("body", 512), ("body", 64), ("quads", 128),
                                       ("slivers", 256), ("nan", 256)])
def test_bins_select_exactly_topk_rows(case, kmax):
    """The pre-pass's bit table, expanded by popcount prefixes, and a plain
    cumsum compaction both list ``bin_candidates``' valid rows, also where
    the cap binds and where a corner is NaN."""
    vs, faces = _with_nan(*_body()) if case == "nan" else CASES[case]()
    tile = 16
    K = -(-min(kmax, faces.shape[0]) // 64) * 64
    tri = ras.bin_candidates(torch.as_tensor(vs), torch.as_tensor(faces), SIZE, tile, K)
    valid = tri[..., 9] > 0
    want = torch.where(valid, tri[..., 10].long(), -1)
    over = _overlap(vs, faces, tile)
    assert torch.equal(compact(over, K), want)
    assert torch.equal(expand(bin_words(over), K), want)
    if kmax == 64:
        assert (valid.sum(-1) == K).any()  # the cap binds
    if case == "nan":
        assert not (want[0] == 5).any() and not (want[-1] == 9).any()


def test_cuda_entries_refuse_cpu_tensors():
    """No fallback: the kernel's wrapper raises on CPU tensors, which only
    ``rasterize_mesh_tiled`` hands to the plain version."""
    vs, faces = _body(B=1)
    v, f = torch.as_tensor(vs), torch.as_tensor(faces)
    with pytest.raises(ValueError):
        ras.rasterize_mesh_cuda(v, f, SIZE, 16, 64)
    got = ras.rasterize_mesh_tiled(v, f, SIZE, tile=16, max_faces_per_tile=64, k_chunk=64)
    want = ras.rasterize_mesh_plain(v, f, SIZE, 16, 64, k_chunk=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ras.launches == 0 and ras.launches_bins == 0
