"""K7: tile-binned triangle rasterizer (threedhumangan_tpu/ops/rasterize.py).

Replaces ``_rasterize_tile_kernel`` (Pallas): the screen is cut into 32x32
pixel tiles, every tile keeps its K lowest-indexed candidate faces whose
bounding boxes overlap it (``bin_candidates``, plain torch: a (B, T, F)
overlap test and ``torch.topk`` of ``F - face``), and the kernel z-tests
each tile's candidates against its pixels with a running (z, face, bary)
minimum.  Barycentrics come from the edge functions of each candidate at
the pixel centres, in the JAX kernel's operation order; the lowest
candidate row wins a tie in z (duplicate faces are common on tiled
meshes).

``rasterize_mesh_tiled`` launches csrc/rasterize.cu on CUDA tensors and
runs ``rasterize_tiles_plain`` on CPU tensors.  ``rasterize_mesh`` is the
dense z-buffer (every face against every pixel): the tests' reference.

Camera convention: vertices already projected onto the renderer's ray
grid — y in [-1, 1] over rows, x in [-W/H, W/H] over columns, +z away from
the camera (smaller is closer).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from threedhumangan_tpu_torch import _build

BIG = 1e10
launches = 0  # K7 launches (the CUDA path only)


def _grid(image_size, tile: int):
    """Tile counts and the pixel-centre steps as float32 (the JAX constants)."""
    H, W = image_size
    span = W / H
    return (-(-H // tile), -(-W // tile), np.float32(2 * span / max(W - 1, 1)),
            np.float32(2.0 / max(H - 1, 1)), np.float32(span))


def _triangles(verts_screen, faces):
    B = verts_screen.shape[0]
    F = faces.shape[0]
    return verts_screen.float()[:, faces.reshape(-1)].reshape(B, F, 3, 3)


def bin_candidates(verts_screen, faces, image_size, tile: int, K: int):
    """Per-tile candidate table (B, T, K, 11) = [9 vertex coords, valid,
    face id] with the K lowest-indexed faces whose bounding box overlaps the
    tile (``_bin_candidates``)."""
    H, W = image_size
    tiles_y, tiles_x, x_step, y_step, span = _grid(image_size, tile)
    dev = verts_screen.device
    tri = _triangles(verts_screen, faces)
    B, F = tri.shape[:2]
    tx0 = -float(span) + torch.arange(tiles_x, device=dev) * tile * float(x_step)
    ty0 = -1.0 + torch.arange(tiles_y, device=dev) * tile * float(y_step)
    tile_x0 = tx0.float().repeat(tiles_y)
    tile_y0 = ty0.float().repeat_interleave(tiles_x)
    # the tile's last pixel centre: the offset is formed in double, as the
    # JAX package forms it in Python
    tile_x1 = tile_x0 + float(np.float32((tile - 1) * 2 * W / H / max(W - 1, 1)))
    tile_y1 = tile_y0 + float(np.float32((tile - 1) * 2.0 / max(H - 1, 1)))
    fx0, fx1 = tri[..., 0].amin(2), tri[..., 0].amax(2)
    fy0, fy1 = tri[..., 1].amin(2), tri[..., 1].amax(2)
    overlap = ((fx0[:, None] <= tile_x1[None, :, None]) & (fx1[:, None] >= tile_x0[None, :, None])
               & (fy0[:, None] <= tile_y1[None, :, None]) & (fy1[:, None] >= tile_y0[None, :, None]))
    scores = torch.where(overlap, float(F) - torch.arange(F, device=dev, dtype=torch.float32),
                         torch.tensor(-1.0, device=dev))
    if K > F:  # whole chunks: pad with never-valid columns
        scores = torch.cat([scores, scores.new_full(scores.shape[:2] + (K - F,), -1.0)], -1)
    top, cand = torch.topk(scores, K, dim=-1)
    cand = cand.clamp(max=F - 1)
    T = tiles_y * tiles_x
    tri9 = torch.gather(tri.reshape(B, 1, F, 9).expand(B, T, F, 9), 2,
                        cand[..., None].expand(B, T, K, 9))
    return torch.cat([tri9, (top > 0).float()[..., None], cand.float()[..., None]], -1)


def rasterize_tiles_plain(tri_k, tiles_x: int, tile: int, x_step, y_step, span,
                          k_chunk: int = 128):
    """Plain K7: (B, T, K, 11) candidates -> face (B, T, P) int32 (-1 empty),
    bary (B, T, P, 3), zbuf (B, T, P), P = tile * tile."""
    B, T, K, _ = tri_k.shape
    dev = tri_k.device
    f32 = torch.float32
    P = tile * tile
    lane = torch.arange(P, device=dev)
    row_i, col_i = lane // tile, lane % tile
    t = torch.arange(T, device=dev)
    tx, ty = t % tiles_x, t // tiles_x
    x_step, y_step, span = (torch.tensor(float(v), dtype=f32, device=dev)
                            for v in (x_step, y_step, span))
    x0 = -span + (tx * tile).to(f32) * x_step
    y0 = -1.0 + (ty * tile).to(f32) * y_step
    px = (x0[:, None] + col_i.to(f32)[None] * x_step)[None, :, None]  # (1, T, 1, P)
    py = (y0[:, None] + row_i.to(f32)[None] * y_step)[None, :, None]
    best_z = tri_k.new_full((B, T, P), BIG)
    best_f = tri_k.new_full((B, T, P), -1.0)
    best_w = tri_k.new_zeros(3, B, T, P)
    for c0 in range(0, K, k_chunk):
        c = tri_k[:, :, c0:c0 + k_chunk, :, None]  # (B, T, Kc, 11, 1)
        ax, ay, az, bx, by, bz, cx, cy, cz, valid, fid = c.unbind(3)
        v0x, v0y = bx - ax, by - ay
        v1x, v1y = cx - ax, cy - ay
        denom = v0x * v1y - v0y * v1x
        ok = (denom.abs() > 1e-9) & (valid > 0.0)
        inv = torch.where(ok, 1.0 / torch.where(ok, denom, torch.ones_like(denom)),
                          torch.zeros_like(denom))
        c1x, c1y, c1c = inv * v1y, -inv * v1x, inv * (ay * v1x - ax * v1y)
        c2x, c2y, c2c = -inv * v0y, inv * v0x, inv * (v0y * ax - v0x * ay)
        w1 = c1x * px + c1y * py + c1c  # (B, T, Kc, P)
        w2 = c2x * px + c2y * py + c2c
        w0 = 1.0 - w1 - w2
        inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0) & ok
        z = az + w1 * (bz - az) + w2 * (cz - az)
        zf = torch.where(inside, z, torch.tensor(BIG, dtype=f32, device=dev))
        zmin, kbest = zf.min(2)  # the lowest row among ties
        pick = lambda v: torch.gather(v.expand_as(zf), 2, kbest[:, :, None])[:, :, 0]
        closer = zmin < best_z
        best_f = torch.where(closer, pick(fid), best_f)
        best_w = torch.where(closer, torch.stack([pick(w0), pick(w1), pick(w2)]), best_w)
        best_z = torch.where(closer, zmin, best_z)
    best_f = torch.where(best_z < BIG, best_f, torch.full_like(best_f, -1.0))
    return best_f.to(torch.int32), best_w.permute(1, 2, 3, 0), best_z


def _untile(x, image_size, tile):
    """(B, T, P[, C]) tile-major -> (B, H, W[, C])."""
    H, W = image_size
    tiles_y, tiles_x = -(-H // tile), -(-W // tile)
    B = x.shape[0]
    ch = x.shape[3:]
    x = x.reshape(B, tiles_y, tiles_x, tile, tile, *ch).transpose(2, 3)
    return x.reshape(B, tiles_y * tile, tiles_x * tile, *ch)[:, :H, :W]


def rasterize_mesh_tiled(verts_screen, faces, image_size: Tuple[int, int], tile: int = 32,
                         max_faces_per_tile: int = 640, k_chunk: int = 128):
    """Tile-binned rasterization (``rasterize_mesh_pallas``).  verts_screen
    (B, V, 3), faces (F, 3) long.  Returns pix_to_face (B, H, W) int32 (-1
    background), bary (B, H, W, 3), zbuf (B, H, W).  CUDA tensors launch K7;
    CPU tensors take ``rasterize_tiles_plain``."""
    F = faces.shape[0]
    K = -(-min(max_faces_per_tile, F) // k_chunk) * k_chunk
    tiles_y, tiles_x, x_step, y_step, span = _grid(image_size, tile)
    tri_k = bin_candidates(verts_screen, faces, image_size, tile, K)
    if tri_k.device.type == "cpu":
        face, bary, zbuf = rasterize_tiles_plain(tri_k, tiles_x, tile, x_step, y_step, span,
                                                 k_chunk)
    elif tri_k.device.type == "cuda":
        face, bary, zbuf = rasterize_tiles_cuda(tri_k, tiles_x, tile, x_step, y_step, span)
    else:
        raise ValueError(f"rasterize_mesh_tiled: unsupported device {tri_k.device}")
    return (_untile(face, image_size, tile), _untile(bary, image_size, tile),
            _untile(zbuf, image_size, tile))


def rasterize_tiles_cuda(tri_k, tiles_x: int, tile: int, x_step, y_step, span):
    """Launch K7 on (B, T, K, 11) float32 candidates; same outputs as
    ``rasterize_tiles_plain``."""
    global launches
    B, T, K, n = tri_k.shape
    if n != 11 or tile * tile > 1024 or not tri_k.is_cuda:
        raise ValueError(f"rasterizer kernel needs (B, T, K, 11) CUDA candidates and tiles of "
                         f"at most 32 x 32 pixels (got {tuple(tri_k.shape)}, tile {tile})")
    tri_k = tri_k.float().contiguous()
    P = tile * tile
    dev = tri_k.device
    face = torch.empty(B, T, P, dtype=torch.int32, device=dev)
    bary = torch.empty(B, T, P, 3, dtype=torch.float32, device=dev)
    zbuf = torch.empty(B, T, P, dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.thgt_rasterize(tri_k.data_ptr(), face.data_ptr(), bary.data_ptr(),
                                 zbuf.data_ptr(), B, T, K, tiles_x, tile, float(x_step),
                                 float(y_step), float(span), stream)
    _build.check(err, "thgt_rasterize")
    launches += 1
    return face, bary, zbuf


def rasterize_mesh(verts_screen, faces, image_size: Tuple[int, int], face_chunk: int = 512):
    """Dense z-buffer (JAX ``rasterize_mesh``): every face against every
    pixel, the lowest face index winning ties.  The tests' reference."""
    H, W = image_size
    span = W / H
    dev = verts_screen.device
    xs = torch.linspace(-span, span, W, dtype=torch.float32, device=dev)
    ys = torch.linspace(-1.0, 1.0, H, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    px, py = gx.reshape(1, 1, -1), gy.reshape(1, 1, -1)
    tri = _triangles(verts_screen, faces)
    B, F = tri.shape[:2]
    zbuf = tri.new_full((B, H * W), BIG)
    face = torch.full((B, H * W), -1, dtype=torch.int32, device=dev)
    bary = tri.new_zeros(B, H * W, 3)
    for f0 in range(0, F, face_chunk):
        t = tri[:, f0:f0 + face_chunk]
        a, b, c = t[:, :, 0, :, None], t[:, :, 1, :, None], t[:, :, 2, :, None]
        v0x, v0y = b[:, :, 0] - a[:, :, 0], b[:, :, 1] - a[:, :, 1]
        v1x, v1y = c[:, :, 0] - a[:, :, 0], c[:, :, 1] - a[:, :, 1]
        denom = v0x * v1y - v0y * v1x
        valid = denom.abs() > 1e-9
        inv = torch.where(valid, 1.0 / torch.where(valid, denom, torch.ones_like(denom)),
                          torch.zeros_like(denom))
        v2x, v2y = px - a[:, :, 0], py - a[:, :, 1]
        w1 = (v2x * v1y - v2y * v1x) * inv
        w2 = (v0x * v2y - v0y * v2x) * inv
        w0 = 1.0 - w1 - w2
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & valid
        z = w0 * a[:, :, 2] + w1 * b[:, :, 2] + w2 * c[:, :, 2]
        z = torch.where(inside, z, torch.tensor(BIG, device=dev))
        zmin, best = z.min(1)
        closer = zmin < zbuf
        take = lambda v: torch.gather(v, 1, best[:, None])[:, 0]
        zbuf = torch.where(closer, zmin, zbuf)
        face = torch.where(closer, (f0 + best).to(torch.int32), face)
        bary = torch.where(closer[..., None], torch.stack([take(w0), take(w1), take(w2)], -1),
                           bary)
    return face.reshape(B, H, W), bary.reshape(B, H, W, 3), zbuf.reshape(B, H, W)
