// K3: fused SPADE synthesis (inference) — the whole 9-block network per
// pixel tile; only RGB leaves the kernel.
//
// Replaces threedhumangan_tpu/ops/synthesis_kernel.py::_synthesis_kernel
// (Pallas, TPU).  Per pixel: coords from the pixel index -> sin(coords @ W_in
// + b); per block, twice: x*gamma + beta (per-pixel SPADE MLP style -> 128 ->
// gamma, beta for the blocks modulated by the style map; per-image rows from
// the host for the rank-1 blocks), lrelu, 1x1 conv; skip add for blocks >=
// NB/2, ToRGB sum for blocks >= NB/2 - 1.  Spectral norm, the eval
// batch-norm affine and the rank-1 rows are folded on the host.
//
// What bounds it on an H100: ~8.7 TFLOP of matrix products per batch of 8
// at 512x256 and width 420 (nine blocks of two 420x420 convs + three
// SPADE MLPs per pixel) — tensor-core work; the style map read (0.9 GB
// bf16, only by the mod blocks) and the RGB write are the only device-memory
// streams.  At this CTA shape the operand traffic bounds it, not the
// products: every 64-pixel tile re-reads about 8.7 MB of weights from L2
// through shared memory, and the element-wise epilogues run per element
// through a float scratch tile.  One 16-warp CTA fits an SM.
//
// Design: a CTA owns 64 pixels and keeps their activations in shared memory
// in bf16 — the block input, the half-block output and one modulated-input
// buffer (3 x 64 x 440 bf16) plus the 64 x 136 SPADE hidden tile.  A
// 420x420 bf16 conv weight (353 KB) exceeds the 227 KB a CTA may hold, so
// weights are not resident as on the TPU: they pass through a double-
// buffered shared-memory ring 16 rows at a time (tile_mma.cuh).  For the
// mod blocks gamma and beta are computed 16 columns at a time (two products
// sharing the SPADE hidden tile, their B fragments read from L2) and
// applied in the epilogue, so they never exist whole.  Element-wise steps
// round to bf16 where the JAX kernel does.
#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace {

using namespace thgt;

constexpr int kSpade = 128;

struct Args {
  const bf16* style;   // (B, H, W, F)
  const bf16* fixed;   // (B, F)
  const float* gab;    // (B, n_gab, hp): rank-1 rows [ga0, gb0, ga1, gb1] per block
  const float* in_w;   // (2, hp), bf16-rounded values
  const float* in_b;   // (hp)
  const bf16* conv_w;  // (NB, 2, hp, hp)
  const float* conv_b; // (NB, 2, hp)
  const bf16* sh_w;    // (n_mod, 2, fp, 128)
  const float* sh_b;   // (n_mod, 2, 128)
  const bf16* g_w;     // (n_mod, 2, 128, hp)
  const float* g_b;    // (n_mod, 2, hp)
  const bf16* bt_w;    // (n_mod, 2, 128, hp)
  const float* bt_b;   // (n_mod, 2, hp)
  const float* rgb_w;  // (NB, hp, 3), bf16-rounded values
  const float* rgb_b;  // (NB, 3)
  float* rgb_out;      // (B, H, W, 3)
  int B, H, W, F, fp, hp, num_blocks, n_gab, add_fixed;
  unsigned mod_mask;   // bit i: block i reads the style map; else rank-1 rows
};

__global__ void __launch_bounds__(kThreads, 1) synthesis_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hp = a.hp, ld = smem_ld(max(a.hp, a.fp)), lda = smem_ld(kSpade);
  const int b = blockIdx.y, pix0 = blockIdx.x * kRows, HW = a.H * a.W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  bf16* cur = reinterpret_cast<bf16*>(smem);
  bf16* nxt = cur + kRows * ld;
  bf16* tmod = nxt + kRows * ld;
  bf16* act = tmod + kRows * ld;
  float* scratch = reinterpret_cast<float*>(act + kRows * lda) + warp * 256;
  float* rgb = reinterpret_cast<float*>(act + kRows * lda) + kWarps * 256;
  bf16* ring = reinterpret_cast<bf16*>(rgb + kRows * 3);  // weight chunks (tile_mma.cuh)

  // input features from the pixel coordinates (coords rounded to bf16 as the
  // JAX kernel's matmul operand)
  const float sy = 2.0f / (float)(a.H - 1), sx = 2.0f / (float)(a.W - 1);
  for (int e = tid; e < kRows * hp; e += kThreads) {
    const int r = e / hp, c = e % hp, p = pix0 + r;
    const float gi = bf(__fsub_rn(__fmul_rn((float)(p / a.W), sy), 1.f));
    const float gj = bf(__fsub_rn(__fmul_rn((float)(p % a.W), sx), 1.f));
    const float v = gi * a.in_w[c] + gj * a.in_w[hp + c];
    cur[r * ld + c] = __float2bfloat16(sinf(v + a.in_b[c]));
  }
  for (int e = tid; e < kRows * 3; e += kThreads) rgb[e] = 0.f;
  __syncthreads();

  const bf16* style = a.style + ((size_t)b * HW + pix0) * a.F;
  for (int blk = 0; blk < a.num_blocks; ++blk) {
    const bool mod = (a.mod_mask >> blk) & 1u;
    const int mods_below = __popc(a.mod_mask & ((1u << blk) - 1u));
    for (int half = 0; half < 2; ++half) {
      const bf16* src = half == 0 ? cur : nxt;
      if (!mod) {
        // rank-1 block: x -> lrelu(x*ga + gb) with per-image rows
        const int row = 4 * (blk - mods_below) + 2 * half;
        const float* ga = a.gab + ((size_t)b * a.n_gab + row) * hp;
        const float* gb = ga + hp;
        for (int e = tid; e < kRows * hp; e += kThreads) {
          const int r = e / hp, c = e % hp;
          const float x = __bfloat162float(src[r * ld + c]);
          tmod[r * ld + c] = __float2bfloat16(lrelu_bf(bf(bf(x * ga[c]) + gb[c])));
        }
      } else {
        const int k = mods_below * 2 + half;
        // stage the style tile (+ the fixed row in mixed/all modes)
        for (int e = tid; e < kRows * a.fp; e += kThreads) {
          const int r = e / a.fp, c = e % a.fp;
          float v = 0.f;
          if (c < a.F) {
            v = __bfloat162float(style[(size_t)r * a.F + c]);
            if (a.add_fixed) v = bf(v + __bfloat162float(a.fixed[(size_t)b * a.F + c]));
          }
          tmod[r * ld + c] = __float2bfloat16(v);
        }
        __syncthreads();
        // SPADE hidden: relu(style @ W_shared + b)
        const float* shb = a.sh_b + (size_t)k * kSpade;
        layer(tmod, ld, a.sh_w + (size_t)k * a.fp * kSpade, kSpade, a.fp, kSpade, ring, scratch,
              [&](int r, int c, float v) { act[r * lda + c] = __float2bfloat16(fmaxf(v + shb[c], 0.f)); });
        __syncthreads();
        // gamma/beta 16 columns at a time, applied in the epilogue
        const float* gbias = a.g_b + (size_t)k * hp;
        const float* bbias = a.bt_b + (size_t)k * hp;
        for (int n0 = warp * 16; n0 < hp; n0 += kWarps * 16) {
          FragC accg[kRowTiles], accb[kRowTiles];
          warp_gemm2<kRowTiles>(act, lda, a.g_w + (size_t)k * kSpade * hp,
                                a.bt_w + (size_t)k * kSpade * hp, hp, n0, kSpade, accg, accb);
#pragma unroll
          for (int m = 0; m < kRowTiles; ++m) {
            float gamma[8];  // this lane's elements e = lane + 32 i
            stage(scratch, accg[m]);
#pragma unroll
            for (int i = 0; i < 8; ++i) gamma[i] = bf(scratch[lane + 32 * i] + gbias[n0 + (lane & 15)]);
            __syncwarp();
            stage(scratch, accb[m]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int e = lane + 32 * i, r = m * 16 + (e >> 4), c = n0 + (e & 15);
              const float beta = bf(scratch[e] + bbias[c]);
              const float x = __bfloat162float(src[r * ld + c]);
              tmod[r * ld + c] = __float2bfloat16(lrelu_bf(bf(bf(x * gamma[i]) + beta)));
            }
            __syncwarp();
          }
        }
      }
      __syncthreads();
      // 1x1 conv (spectral norm folded) [+ skip from the block input]
      const bool skip = half == 1 && blk >= a.num_blocks / 2;
      const float* cb = a.conv_b + (size_t)(blk * 2 + half) * hp;
      layer(tmod, ld, a.conv_w + (size_t)(blk * 2 + half) * hp * hp, hp, hp, hp, ring, scratch,
            [&](int r, int c, float v) {
              float y = bf(v + cb[c]);
              if (skip) y = bf(y + __bfloat162float(cur[r * ld + c]));
              nxt[r * ld + c] = __float2bfloat16(y);
            });
      __syncthreads();
    }
    if (blk >= a.num_blocks / 2 - 1) {
      const float* rw = a.rgb_w + (size_t)blk * hp * 3;
      for (int t = tid; t < kRows * 3; t += kThreads) {
        const int r = t / 3, j = t % 3;
        float s = 0.f;
        for (int c = 0; c < hp; ++c) s += __bfloat162float(nxt[r * ld + c]) * rw[c * 3 + j];
        rgb[t] += s + a.rgb_b[blk * 3 + j];
      }
      __syncthreads();
    }
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int t = tid; t < kRows * 3; t += kThreads) a.rgb_out[((size_t)b * HW + pix0) * 3 + t] = rgb[t];
}

}  // namespace

extern "C" int thgt_synthesis(const bf16* style, const bf16* fixed, const float* gab,
                              const float* in_w, const float* in_b, const bf16* conv_w,
                              const float* conv_b, const bf16* sh_w, const float* sh_b,
                              const bf16* g_w, const float* g_b, const bf16* bt_w,
                              const float* bt_b, const float* rgb_w, const float* rgb_b,
                              float* rgb_out, int B, int H, int W, int F, int fp, int hp,
                              int num_blocks, int n_gab, int add_fixed, int mod_mask,
                              cudaStream_t stream) {
  if ((H * W) % kRows || fp % 16 || hp % 16 || F > fp || num_blocks > 32)
    return (int)cudaErrorInvalidValue;
  Args a{style, fixed, gab, in_w, in_b, conv_w, conv_b, sh_w, sh_b, g_w, g_b, bt_w, bt_b,
         rgb_w, rgb_b, rgb_out, B, H, W, F, fp, hp, num_blocks, n_gab, add_fixed,
         (unsigned)mod_mask};
  const int ld = smem_ld(hp > fp ? hp : fp);
  const size_t smem = sizeof(bf16) * kRows * (3 * ld + smem_ld(kSpade)) +
                      sizeof(float) * (kWarps * 256 + kRows * 3) + sizeof(bf16) * kWeightRing;
  cudaError_t err = cudaFuncSetAttribute(synthesis_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H * W / kRows, B);
  synthesis_kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
