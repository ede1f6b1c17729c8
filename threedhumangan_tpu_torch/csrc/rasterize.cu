// K7: per-tile z-test of binned candidate faces.
//
// Replaces threedhumangan_tpu/ops/rasterize.py::_rasterize_tile_kernel
// (Pallas, TPU).  One CTA takes one (image, 32 x 32 tile) and one thread
// one pixel; the tile's K candidate faces ([9 vertex coords, valid, face
// id] rows, lowest face index first) stream through shared memory 128 at a
// time.  For each chunk the first threads turn every candidate into its
// edge-function coefficients once (w1 = c1x px + c1y py + c1c, w2 alike,
// z = az + w1 (bz - az) + w2 (cz - az)), then every pixel tests all of
// them and keeps a running (z, face, bary) minimum.  A candidate replaces
// the best only when its z is strictly smaller, so the lowest candidate
// row wins ties: duplicate faces with equal z are common on tiled meshes.
// Every step is rounded in the JAX kernel's operation order
// (__fmul_rn / __fadd_rn, no FMA contraction), so pixels on an edge of the
// inside test fall the same way as in the plain version.
//
// What bounds it on an H100: ~20 float32 operations per (pixel, candidate)
// pair — 8 x 32 tiles x 2,048 candidates x 1,024 pixels = 5.4e8 pairs for
// the training slice, ~11 GFLOP of FP32 issue; the inputs (90 KB per tile)
// and outputs are small.  The coefficients are computed once per candidate
// and read by all 1,024 threads as shared-memory broadcasts.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kCols = 11;
constexpr float kBig = 1e10f;

__global__ void __launch_bounds__(1024) rasterize_kernel(const float* tri, int* face, float* bary,
                                                         float* zbuf, int T, int K, int tiles_x,
                                                         int tile, float x_step, float y_step,
                                                         float span) {
  __shared__ float coef[12][kChunk];  // c1x c1y c1c c2x c2y c2c az dbz dcz ok fid
  const int t = blockIdx.x, b = blockIdx.y, p = threadIdx.x;
  const int P = tile * tile;
  const int tx = t % tiles_x, ty = t / tiles_x;
  const int row = p / tile, col = p % tile;
  const float x0 = __fadd_rn(-span, __fmul_rn((float)(tx * tile), x_step));
  const float y0 = __fadd_rn(-1.f, __fmul_rn((float)(ty * tile), y_step));
  const float px = __fadd_rn(x0, __fmul_rn((float)col, x_step));
  const float py = __fadd_rn(y0, __fmul_rn((float)row, y_step));
  float best_z = kBig, best_f = -1.f, bw0 = 0.f, bw1 = 0.f, bw2 = 0.f;
  const float* tb = tri + ((size_t)b * T + t) * K * kCols;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int nk = min(kChunk, K - k0);
    __syncthreads();  // the previous chunk's coefficients are no longer read
    for (int k = threadIdx.x; k < nk; k += blockDim.x) {
      const float* r = tb + (size_t)(k0 + k) * kCols;
      const float ax = r[0], ay = r[1], az = r[2], bx = r[3], by = r[4], bz = r[5];
      const float cx = r[6], cy = r[7], cz = r[8], valid = r[9];
      const float v0x = __fsub_rn(bx, ax), v0y = __fsub_rn(by, ay);
      const float v1x = __fsub_rn(cx, ax), v1y = __fsub_rn(cy, ay);
      const float denom = __fsub_rn(__fmul_rn(v0x, v1y), __fmul_rn(v0y, v1x));
      const bool ok = fabsf(denom) > 1e-9f && valid > 0.f;
      const float inv = ok ? __fdiv_rn(1.f, denom) : 0.f;
      coef[0][k] = __fmul_rn(inv, v1y);
      coef[1][k] = __fmul_rn(-inv, v1x);
      coef[2][k] = __fmul_rn(inv, __fsub_rn(__fmul_rn(ay, v1x), __fmul_rn(ax, v1y)));
      coef[3][k] = __fmul_rn(-inv, v0y);
      coef[4][k] = __fmul_rn(inv, v0x);
      coef[5][k] = __fmul_rn(inv, __fsub_rn(__fmul_rn(v0y, ax), __fmul_rn(v0x, ay)));
      coef[6][k] = az;
      coef[7][k] = __fsub_rn(bz, az);
      coef[8][k] = __fsub_rn(cz, az);
      coef[9][k] = ok ? 1.f : 0.f;
      coef[10][k] = r[10];
    }
    __syncthreads();
    if (p < P) {
      for (int k = 0; k < nk; ++k) {
        const float w1 = __fadd_rn(__fadd_rn(__fmul_rn(coef[0][k], px), __fmul_rn(coef[1][k], py)),
                                   coef[2][k]);
        const float w2 = __fadd_rn(__fadd_rn(__fmul_rn(coef[3][k], px), __fmul_rn(coef[4][k], py)),
                                   coef[5][k]);
        const float w0 = __fsub_rn(__fsub_rn(1.f, w1), w2);
        const bool inside = w0 >= 0.f && w1 >= 0.f && w2 >= 0.f && coef[9][k] > 0.f;
        const float z = __fadd_rn(__fadd_rn(coef[6][k], __fmul_rn(w1, coef[7][k])),
                                  __fmul_rn(w2, coef[8][k]));
        if (inside && z < best_z) {
          best_z = z;
          best_f = coef[10][k];
          bw0 = w0;
          bw1 = w1;
          bw2 = w2;
        }
      }
    }
  }
  if (p < P) {
    const size_t o = ((size_t)b * T + t) * P + p;
    face[o] = best_z < kBig ? (int)best_f : -1;
    bary[o * 3] = bw0;
    bary[o * 3 + 1] = bw1;
    bary[o * 3 + 2] = bw2;
    zbuf[o] = best_z;
  }
}

}  // namespace

extern "C" int thgt_rasterize(const float* tri, int* face, float* bary, float* zbuf, int B, int T, int K,
                              int tiles_x, int tile, float x_step, float y_step, float span,
                              cudaStream_t stream) {
  const int P = tile * tile;
  if (P <= 0 || P > 1024 || K <= 0) return (int)cudaErrorInvalidValue;
  const int threads = ((P + 31) / 32) * 32;
  dim3 grid(T, B);
  rasterize_kernel<<<grid, threads, 0, stream>>>(tri, face, bary, zbuf, T, K, tiles_x, tile, x_step,
                                                 y_step, span);
  return (int)cudaGetLastError();
}
