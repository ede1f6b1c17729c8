// K7: tile-binned triangle rasterizer, binning included.
//
// Replaces threedhumangan_tpu/ops/rasterize.py::_rasterize_tile_kernel
// (Pallas, TPU) and the XLA binning before it (``_bin_candidates``: each
// 32 x 32 pixel tile keeps the K lowest-indexed faces whose bounding box
// overlaps it).  Two kernels:
//
// bins_kernel, the pre-pass: a warp takes 32 consecutive faces of one image,
// forms each face's bounding box (exact min / max of its corners) and, for
// every tile, ballots the overlap test against the tile's first and last
// pixel centres (the f32 edges ``ops/rasterize.py::tile_edges`` forms, as
// ``bin_candidates`` does) into one word of a (B, T, ceil(F / 32)) bit
// table.  Each word has one writer, so the table needs no zeroing and no
// atomics, and it is the same whatever order the warps run in.
//
// rasterize_kernel: a CTA takes 8 sub-tiles of 8 x 4 pixels of one (image,
// tile of at most 32 x 32 pixels), two warps a sub-tile (lane l: column
// l % 8, row l / 8 of it), one pixel a lane.  It expands the tile's first K
// set bits in index order (a popcount prefix over the words) into a list of
// face ids, which is ``bin_candidates``' valid rows exactly.  The list then
// streams through shared memory one candidate a thread: each thread gathers
// its face's corners, forms the edge-function coefficients (w1 = c1x px +
// c1y py + c1c, w2 alike, z = az + w1 (bz - az) + w2 (cz - az)) in the plain
// version's operation order and tests them against the CTA's 8 sub-tiles
// (``covers``), one cover bit each.  Each warp takes every other group of 32
// candidates: a ballot of its sub-tile's bits, then the whole warp tests
// the candidates kept, in ascending order, keeping a running (z, face,
// bary) minimum.  A candidate replaces the best
// only when its z is strictly smaller, so the first candidate with the
// smallest z wins; the two warps' bests then merge by (z, face id), and the
// face ids ascend with the list, so the lowest candidate wins ties, as in
// the plain version (duplicate faces are common on tiled meshes).  Every
// step of a pixel's test is rounded in the JAX kernel's operation order
// (__fmul_rn / __fadd_rn, no FMA contraction), so the outputs are the plain
// version's bit for bit; they are written in (B, H, W) layout, masked at the
// ragged edge of the image.
//
// The cull is conservative under that rounding.  w1, w2 and w0 are affine
// in (px, py) with the rounded coefficients, so their largest exact value
// over a sub-tile lies at a corner of the box of its pixel centres; that box
// is spanned by the corner pixels' own rounded centres, since x0 + col *
// x_step is monotone in col under rounding, and c * (c >= 0 ? hi : lo) picks
// the larger product, rounded or not.  Let u = 2^-24, mx and my bound |px|
// and |py| over the image, and A = |cx| mx + |cy| my + |c| for w1 or w2.  A
// pixel's rounded w1 exceeds its exact value by at most gamma_3 A <= 3.0001
// u A; w0 = (1 - w1) - w2 adds two roundings, at most 6.0001 u (A1 + A2 +
// 1) in all.  The test forms k1 = c1c + (kRel A1 + kAbs), then (k1 + c1x
// xc) + c1y yc at the maximizing corner, in float32: five roundings, at
// most 4.0001 u (A1 + kRel A1 + kAbs) above or below the exact sum; w0's,
// k0 - (c1x + c2x) xc - (c1y + c2y) yc with k0 = (1 - c1c) - c2c + (kRel0
// (A1 + A2 + 1) + kAbs), at most 6.0001 u (A1 + A2 + 1 + the margin).  So a
// test value below 0 means the exact corner maximum plus gamma_3 A (6.0001 u
// (A1 + A2 + 1) for w0) is below 0 once the margin kRel = 16 u (kRel0 = 32
// u) exceeds the two errors together (7.0002 u, 12.0002 u), and kAbs = 1e-30
// covers the absolute error of subnormal results: that weight is then
// negative at every pixel of the sub-tile, and the warp skips the candidate.
// A face whose coefficients exceed 1e30 in size, or are not finite, gets
// infinite constants and is never skipped; slivers with denom just above
// 1e-9 get huge coefficients whose margin skips them only far from any pixel
// they could cover.  A face that is not ``ok`` (|denom| <= 1e-9) is never
// inside, so every warp skips it.
//
// What bounds it on an H100: ~20 float32 operations a (pixel, candidate)
// pair for the pairs the inputs need, those whose pixel centre lies inside
// the candidate's bounding box (chip_smoke.py counts them), and its inputs
// (the vertices and faces) and outputs.  The TPU kernel's port tested all K
// rows of a table built in torch against every pixel of the tile; this one
// bins on the card and tests a sub-tile only against the candidates the
// cull keeps (chip_smoke.py prints the share of the (pixel, valid
// candidate) pairs tested beside the share needed).  Two warps a sub-tile
// halve the longest warp's serial chain of tests on the heaviest tiles.
#include <cuda_runtime.h>

namespace {

constexpr int kSubW = 8;  // a warp's sub-tile: kSubW columns x kSubH rows
constexpr int kSubH = 4;
constexpr int kSubs = 8;   // a CTA takes kSubs sub-tiles of its tile
constexpr int kSplit = 2;  // warps a sub-tile: each tests every kSplit-th group of 32
constexpr int kThreads = kSubs * kSplit * 32;
constexpr int kChunk = kThreads;  // candidates a chunk: one a thread
constexpr float kBig = 1e10f;
constexpr float kRel = 0x1p-20f;   // 16 u: w1, w2
constexpr float kRel0 = 0x1p-19f;  // 32 u: w0
constexpr float kAbs = 1e-30f;
constexpr float kHuge = 1e30f;

__device__ __forceinline__ float centre(float start, int i, float step) {
  return __fadd_rn(start, __fmul_rn((float)i, step));
}

// A face's coefficients for the z-test and the cull: [c1x c1y c1c c2x]
// [c2y c2c az dbz] [dcz k1 k2 k0] [c1x + c2x, c1y + c2y, ok, 0].
struct Row {
  float4 q0, q1, q2, q3;
};

__device__ __forceinline__ Row face_row(const float* a, const float* b, const float* c, float mx,
                                        float my) {
  const float ax = a[0], ay = a[1], az = a[2], bx = b[0], by = b[1], bz = b[2];
  const float cx = c[0], cy = c[1], cz = c[2];
  const float v0x = __fsub_rn(bx, ax), v0y = __fsub_rn(by, ay);
  const float v1x = __fsub_rn(cx, ax), v1y = __fsub_rn(cy, ay);
  const float denom = __fsub_rn(__fmul_rn(v0x, v1y), __fmul_rn(v0y, v1x));
  const bool ok = fabsf(denom) > 1e-9f;
  const float inv = ok ? __fdiv_rn(1.f, denom) : 0.f;
  const float c1x = __fmul_rn(inv, v1y), c1y = __fmul_rn(-inv, v1x);
  const float c1c = __fmul_rn(inv, __fsub_rn(__fmul_rn(ay, v1x), __fmul_rn(ax, v1y)));
  const float c2x = __fmul_rn(-inv, v0y), c2y = __fmul_rn(inv, v0x);
  const float c2c = __fmul_rn(inv, __fsub_rn(__fmul_rn(v0y, ax), __fmul_rn(v0x, ay)));
  const float a1 = __fadd_rn(__fadd_rn(__fmul_rn(fabsf(c1x), mx), __fmul_rn(fabsf(c1y), my)),
                             fabsf(c1c));
  const float a2 = __fadd_rn(__fadd_rn(__fmul_rn(fabsf(c2x), mx), __fmul_rn(fabsf(c2y), my)),
                             fabsf(c2c));
  float k1 = __fadd_rn(c1c, __fadd_rn(__fmul_rn(kRel, a1), kAbs));
  float k2 = __fadd_rn(c2c, __fadd_rn(__fmul_rn(kRel, a2), kAbs));
  float k0 = __fadd_rn(__fsub_rn(__fsub_rn(1.f, c1c), c2c),
                       __fadd_rn(__fmul_rn(kRel0, __fadd_rn(__fadd_rn(a1, a2), 1.f)), kAbs));
  // not finite or above 1e30 in size: never skipped (a NaN fails every <=)
  if (!(fabsf(c1x) <= kHuge && fabsf(c1y) <= kHuge && fabsf(c1c) <= kHuge &&
        fabsf(c2x) <= kHuge && fabsf(c2y) <= kHuge && fabsf(c2c) <= kHuge))
    k1 = k2 = k0 = INFINITY;
  Row r;
  r.q0 = make_float4(c1x, c1y, c1c, c2x);
  r.q1 = make_float4(c2y, c2c, az, __fsub_rn(bz, az));
  r.q2 = make_float4(__fsub_rn(cz, az), k1, k2, k0);
  r.q3 = make_float4(__fadd_rn(c1x, c2x), __fadd_rn(c1y, c2y), ok ? 1.f : 0.f, 0.f);
  return r;
}

// The box of a warp's pixel centres: its corner pixels' rounded centres.
struct Box {
  float xlo, xhi, ylo, yhi;
};

// False only if the face is inside at no pixel of the box (see the header
// for why the test is conservative; a NaN value fails every < 0).
__device__ __forceinline__ bool covers(const Row& r, const Box& b) {
  const float c1x = r.q0.x, c1y = r.q0.y, c2x = r.q0.w, c2y = r.q1.x, sx = r.q3.x, sy = r.q3.y;
  const float x1 = __fadd_rn(r.q2.y, __fmul_rn(c1x, c1x >= 0.f ? b.xhi : b.xlo));
  const float x2 = __fadd_rn(r.q2.z, __fmul_rn(c2x, c2x >= 0.f ? b.xhi : b.xlo));
  const float x0 = __fsub_rn(r.q2.w, __fmul_rn(sx, sx >= 0.f ? b.xlo : b.xhi));
  return (r.q3.z > 0.f) & !(__fadd_rn(x1, __fmul_rn(c1y, c1y >= 0.f ? b.yhi : b.ylo)) < 0.f) &
         !(__fadd_rn(x2, __fmul_rn(c2y, c2y >= 0.f ? b.yhi : b.ylo)) < 0.f) &
         !(__fsub_rn(x0, __fmul_rn(sy, sy >= 0.f ? b.ylo : b.yhi)) < 0.f);
}

// A chunk of candidates, one a thread, and their cover bits (bit w: warp w
// tests the candidate).  A pixel's test reads two float4 and one float, each
// a broadcast.
struct Chunk {
  float4 q0[kChunk], q1[kChunk];  // c1x c1y c1c c2x, c2y c2c az dbz
  float dcz[kChunk];
  int fid[kChunk];
  unsigned cover[kChunk];
};

struct Best {
  float z = kBig, w0 = 0.f, w1 = 0.f, w2 = 0.f;
  int f = -1;
};

// Face f of the image into the chunk at k: its row, and its cover bits for
// the CTA's sub-tiles s0 <= s < s1 (bit s - s0).
__device__ __forceinline__ void fill(Chunk& ch, int k, const float* vb, const long long* faces,
                                     int f, float mx, float my, const float* xs, const float* ys,
                                     int sub_x, int s0, int s1) {
  const Row r = face_row(vb + 3 * faces[3 * (size_t)f], vb + 3 * faces[3 * (size_t)f + 1],
                         vb + 3 * faces[3 * (size_t)f + 2], mx, my);
  ch.q0[k] = r.q0;
  ch.q1[k] = r.q1;
  ch.dcz[k] = r.q2.x;
  ch.fid[k] = f;
  unsigned bits = 0u;
  for (int s = s0; s < s1; ++s) {
    const int j = s % sub_x, i = s / sub_x;
    const Box b{xs[2 * j], xs[2 * j + 1], ys[2 * i], ys[2 * i + 1]};
    bits |= (unsigned)covers(r, b) << (s - s0);
  }
  ch.cover[k] = bits;
}

// A warp's pass over its groups of a filled chunk of n candidates (group
// split, split + kSplit, ...; sub-tile sub): a ballot of their cover bits,
// then the kept ones at every lane's pixel in ascending order, in the plain
// version's op order.  A candidate replaces the best only when strictly
// closer: the first of equal z wins.
__device__ __forceinline__ void test_chunk(const Chunk& ch, int n, int sub, int split, float px,
                                           float py, Best& best, unsigned& tested) {
  const int lane = threadIdx.x & 31;
  for (int g = 32 * split; g < n; g += 32 * kSplit) {
    unsigned keep = __ballot_sync(0xffffffffu, g + lane < n && (ch.cover[g + lane] >> sub & 1u));
    tested += __popc(keep);
    for (; keep; keep &= keep - 1) {
      const int k = g + __ffs(keep) - 1;
      const float4 a = ch.q0[k], c = ch.q1[k];  // c1x c1y c1c c2x, c2y c2c az dbz
      const float w1 = __fadd_rn(__fadd_rn(__fmul_rn(a.x, px), __fmul_rn(a.y, py)), a.z);
      const float w2 = __fadd_rn(__fadd_rn(__fmul_rn(a.w, px), __fmul_rn(c.x, py)), c.y);
      const float w0 = __fsub_rn(__fsub_rn(1.f, w1), w2);
      const float z = __fadd_rn(__fadd_rn(c.z, __fmul_rn(w1, c.w)), __fmul_rn(w2, ch.dcz[k]));
      if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f && z < best.z) {
        best.z = z;
        best.f = ch.fid[k];
        best.w0 = w0;
        best.w1 = w1;
        best.w2 = w2;
      }
    }
  }
}

// Exclusive prefix of c over the CTA; ws holds 33 ints of shared memory,
// ws[32] the total on return.
__device__ __forceinline__ int block_prefix(int c, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int own = lane < warps ? ws[lane] : 0;
    int v = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    ws[lane] = v - own;
    if (lane == 31) ws[32] = v;
  }
  __syncthreads();
  return ws[warp] + incl - c;
}

__global__ void __launch_bounds__(256) bins_kernel(const float* verts, const long long* faces,
                                                   const float* edges, unsigned* bins, int B,
                                                   int V, int F, int T, int words) {
  const int gw = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (gw >= B * words) return;  // uniform over the warp
  const int b = gw / words, w = gw % words, f = w * 32 + lane;
  float x0 = 0.f, x1 = 0.f, y0 = 0.f, y1 = 0.f;
  bool any = f < F;
  if (any) {
    const float* vb = verts + (size_t)b * V * 3;
    const float* p = vb + 3 * faces[3 * (size_t)f];
    const float* q = vb + 3 * faces[3 * (size_t)f + 1];
    const float* r = vb + 3 * faces[3 * (size_t)f + 2];
    x0 = fminf(fminf(p[0], q[0]), r[0]);
    x1 = fmaxf(fmaxf(p[0], q[0]), r[0]);
    y0 = fminf(fminf(p[1], q[1]), r[1]);
    y1 = fmaxf(fmaxf(p[1], q[1]), r[1]);
    // a NaN corner makes the plain version's box NaN, which overlaps nothing
    any = !(isnan(p[0]) || isnan(q[0]) || isnan(r[0]) || isnan(p[1]) || isnan(q[1]) ||
            isnan(r[1]));
  }
  unsigned* out = bins + (size_t)b * T * words + w;
  for (int t = 0; t < T; ++t) {
    const bool hit = any && x0 <= edges[T + t] && x1 >= edges[t] && y0 <= edges[3 * T + t] &&
                     y1 >= edges[2 * T + t];
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) out[(size_t)t * words] = m;
  }
}

__global__ void __launch_bounds__(kThreads) rasterize_kernel(
    const float* verts, const long long* faces, const unsigned* bins, int* face, float* bary,
    float* zbuf, unsigned long long* pairs, int V, int T, int words, int K, int tiles_x, int tile,
    int H, int W, float x_step, float y_step, float span, float mx, float my) {
  // dynamic: the chunk, then the tile's first K face ids; the chunk's space
  // holds the warps' partial bests at the end
  extern __shared__ __align__(16) unsigned char smem[];
  Chunk& ch = *reinterpret_cast<Chunk*>(smem);
  int* list = reinterpret_cast<int*>(smem + sizeof(Chunk));
  __shared__ int ws[33];
  __shared__ float xs[2 * (32 / kSubW)], ys[2 * (32 / kSubH)];  // sub-tile corners
  const int sub_x = (tile + kSubW - 1) / kSubW, sub_y = (tile + kSubH - 1) / kSubH;
  const int subs = sub_x * sub_y, per_tile = (subs + kSubs - 1) / kSubs;  // CTAs a tile
  const int t = blockIdx.x / per_tile, b = blockIdx.y;
  const int s0 = blockIdx.x % per_tile * kSubs, s1 = min(s0 + kSubs, subs);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = warp % kSubs, split = warp / kSubs;
  const int col0 = ((s0 + sub) % sub_x) * kSubW, row0 = ((s0 + sub) / sub_x) * kSubH;
  const int col = col0 + lane % kSubW, row = row0 + lane / kSubW;
  const int tx = t % tiles_x, ty = t / tiles_x;
  const float x0 = centre(-span, tx * tile, x_step), y0 = centre(-1.f, ty * tile, y_step);
  const float px = centre(x0, col, x_step), py = centre(y0, row, y_step);
  const int i = threadIdx.x;
  if (i < sub_x) {
    xs[2 * i] = centre(x0, i * kSubW, x_step);
    xs[2 * i + 1] = centre(x0, min(i * kSubW + kSubW, tile) - 1, x_step);
  }
  if (i < sub_y) {
    ys[2 * i] = centre(y0, i * kSubH, y_step);
    ys[2 * i + 1] = centre(y0, min(i * kSubH + kSubH, tile) - 1, y_step);
  }

  // the tile's first K faces in index order (its barriers also publish xs, ys)
  const unsigned* row_bits = bins + ((size_t)b * T + t) * words;
  int n = 0;
  for (int w0 = 0; w0 < words && n < K; w0 += blockDim.x) {
    const int w = w0 + (int)threadIdx.x;
    unsigned word = w < words ? row_bits[w] : 0u;
    int at = n + block_prefix(__popc(word), ws);
    for (; word && at < K; word &= word - 1) list[at++] = w * 32 + __ffs(word) - 1;
    n += ws[32];
    __syncthreads();  // ws is read before the next round writes it, list before it is read
  }
  n = min(n, K);

  Best best;
  unsigned tested = 0;
  const float* vb = verts + (size_t)b * V * 3;
  for (int k0 = 0; k0 < n; k0 += blockDim.x) {
    if (k0) __syncthreads();  // the previous chunk is no longer read
    if (k0 + i < n) fill(ch, i, vb, faces, list[k0 + i], mx, my, xs, ys, sub_x, s0, s1);
    __syncthreads();
    if (s0 + sub < s1) test_chunk(ch, min((int)blockDim.x, n - k0), sub, split, px, py, best, tested);
  }

  // the kSplit partial bests of a pixel: the smallest z, then the lowest face
  // id, which is the first candidate with that z
  if (kSplit > 1) {
    __syncthreads();  // the chunk's space is free
    Best* part = reinterpret_cast<Best*>(smem);
    part[threadIdx.x] = best;
    __syncthreads();
    if (split == 0) {
      for (int o = 1; o < kSplit; ++o) {
        const Best q = part[threadIdx.x + o * kSubs * 32];
        if (q.z < best.z || (q.z == best.z && q.f < best.f)) best = q;
      }
    }
  }
  const int gy = ty * tile + row, gx = tx * tile + col;
  if (split == 0 && s0 + sub < s1 && col < tile && row < tile && gy < H && gx < W) {
    const size_t o = ((size_t)b * H + gy) * W + gx;
    face[o] = best.f;
    bary[o * 3] = best.w0;
    bary[o * 3 + 1] = best.w1;
    bary[o * 3 + 2] = best.w2;
    zbuf[o] = best.z;
  }
  if (pairs && lane == 0 && tested) {
    const int w = min(col0 + kSubW, tile) - col0, h = min(row0 + kSubH, tile) - row0;
    atomicAdd(pairs, (unsigned long long)tested * (unsigned long long)(w * h));
  }
}

}  // namespace

// The pre-pass into bins (B, T, ceil(F / 32) words), then the z-test; mx and
// my bound |px| and |py| over the image.
extern "C" int thgt_rasterize(const float* verts, const long long* faces, const float* edges,
                              unsigned* bins, int* face, float* bary, float* zbuf,
                              unsigned long long* pairs, int B, int V, int F, int T, int K,
                              int tiles_x, int tile, int H, int W, float x_step, float y_step,
                              float span, float mx, float my, cudaStream_t stream) {
  const long long smem = (long long)sizeof(Chunk) + 4LL * K;  // the chunk, the list of K ids
  if (tile <= 0 || tile > 32 || K <= 0 || B <= 0 || F <= 0 || T <= 0 || smem > 232448 - 1024)
    return (int)cudaErrorInvalidValue;
  const int words = (F + 31) / 32;
  const size_t lanes = (size_t)B * words * 32;
  bins_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, stream>>>(verts, faces, edges, bins, B, V,
                                                                   F, T, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rasterize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int subs = ((tile + kSubW - 1) / kSubW) * ((tile + kSubH - 1) / kSubH);
  const int per_tile = (subs + kSubs - 1) / kSubs;
  rasterize_kernel<<<dim3(T * per_tile, B), kThreads, (size_t)smem, stream>>>(
      verts, faces, bins, face, bary, zbuf, pairs, V, T, words, K, tiles_x, tile, H, W, x_step,
      y_step, span, mx, my);
  return (int)cudaGetLastError();
}
