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
// at 512x256 and width 420 (nine blocks of two 420x420 convs + three SPADE
// MLPs per pixel) — tensor-core work, 8.8 ms at the bf16 peak; the style map
// read (0.9 GB bf16, only by the mod blocks) and the RGB write are the only
// device-memory streams.  At this CTA shape the weights come next: each
// 64-pixel tile streams the whole 8.7 MB weight set from L2, ~143 GB a
// batch of 16,384 tiles, an estimated 15-30 ms at the L2 read rate.  The
// element-wise epilogues (bias, roundings, skip, modulation, ToRGB) and the
// barriers between phases take the rest of its time.
//
// Design (synthesis_core.cuh): a CTA owns 64 pixels and keeps their
// activations in shared memory in bf16 — the block input, the half-block
// output and one modulated-input buffer (3 x 64 x 440 bf16) plus the 64 x
// 136 SPADE hidden tile.  A 420x420 bf16 conv weight (353 KB) exceeds the
// 227 KB a CTA may hold, so the weights arrive as one pre-packed stream of
// 16-row chunk images in wgmma's B layout (ops/synthesis_kernel.py::
// pack_weight_stream): a producer lane keeps two chunks in flight with
// cp.async.bulk into a three-stage mbarrier ring while three consumer
// warpgroups multiply the third with wgmma, A from registers.  Every
// epilogue runs on the accumulators in registers, in bf16 pairs where the
// JAX kernel computes in bf16: bias, relu or lrelu, the skip add, the
// gamma/beta modulation (both heads in one chunk, so a thread holds gamma
// and beta of the same elements), the next half-block's rank-1 modulation
// when there is one (so no element-wise pass remains) and the ToRGB dot
// products, summed over a quad by shuffles and over the 3 warpgroups in
// fixed order in shared memory.
#include <cuda_runtime.h>

#include "synthesis_core.cuh"

namespace {

using namespace syn;

// registers a thread: per SM sub-partition one producer warp and three
// consumer warps, 32 x (40 + 3 x 152) <= 16,384
constexpr int kProducerRegs = 40, kConsumerRegs = 152;

struct Args {
  const bf16* style;             // (B, H, W, F)
  const bf16* fixed;             // (B, F)
  const float* gab;              // (B, n_gab, hp): rank-1 rows [ga0, gb0, ga1, gb1] per block, bf16 values
  const float* in_w;             // (2, hp), bf16-rounded values
  const float* in_b;             // (hp)
  const unsigned char* wstream;  // chunk images, pack_weight_stream
  const float* conv_b;           // (NB, 2, hp)
  const float* sh_b;             // (n_mod, 2, 128)
  const float* g_b;              // (n_mod, 2, hp)
  const float* bt_b;             // (n_mod, 2, hp)
  const float* rgb_w;            // (NB, hp, 3), bf16-rounded values
  const float* rgb_b;            // (NB, 3)
  float* rgb_out;                // (B, H, W, 3)
  int B, H, W, F, fp, hp, num_blocks, n_gab, add_fixed;
  unsigned mod_mask;             // bit i: block i reads the style map; else rank-1 rows
  int stage_bytes;
};

// bytes of one chunk image of a product with n columns
__host__ __device__ constexpr int chunk_bytes(int n) { return kChunkRows * n * (int)sizeof(bf16); }

// The producer walks the stream as the consumers consume it: per half-block,
// for the mod blocks the SPADE shared layer (fp/16 chunks of 16 x 128) and
// the gamma/beta heads (2 column passes x 8 chunks of 16 x hp), then the
// conv (hp/16 chunks of 16 x hp).
__device__ void produce(const Args& a, Producer& p) {
  for (int blk = 0; blk < a.num_blocks; ++blk) {
    const bool mod = (a.mod_mask >> blk) & 1u;
    for (int half = 0; half < 2; ++half) {
      if (mod) {
        p.put(a.fp / kChunkRows, chunk_bytes(kSpade));
        p.put(2 * kSpade / kChunkRows, chunk_bytes(a.hp));
      }
      p.put(a.hp / kChunkRows, chunk_bytes(a.hp));
    }
  }
}

// the style tile (+ the fixed row in mixed/all modes) into tile, zero
// columns F..fp
__device__ void stage_style(const Args& a, const bf16* style, const bf16* fixed, bf16* tile,
                            int ld) {
  const int tid = threadIdx.x, F = a.F;
  const int q = F / 4;  // 8-byte vectors: rows of F bf16 stay 8-byte aligned (F % 4 == 0)
  for (int e = tid; e < kRows * q; e += kConsumers) {
    const int r = e / q, c = (e % q) * 4;
    cp_async8(tile + r * ld + c, style + (size_t)r * F + c);
  }
  cp_async_wait_all();
  if (a.add_fixed) {  // each thread rounds the vectors it copied
    for (int e = tid; e < kRows * q; e += kConsumers) {
      const int r = e / q, c = (e % q) * 4;
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const float2 s = __bfloat1622float2(at2(tile + r * ld + c + j));
        const float2 f = __bfloat1622float2(*reinterpret_cast<const bf2*>(fixed + c + j));
        at2(tile + r * ld + c + j) = __floats2bfloat162_rn(s.x + f.x, s.y + f.y);
      }
    }
  }
  const int pad = a.fp - F;
  for (int e = tid; e < kRows * pad; e += kConsumers)
    tile[(e / pad) * ld + F + e % pad] = __float2bfloat16(0.f);
}

// The per-image (gamma, beta) rows of half-block (blk, half) when it is
// rank-1 (ga; gb = ga + hp), else null: that half's input is x ->
// lrelu(x*ga + gb), applied where x is produced.
__device__ __forceinline__ const float* rank1_rows(const Args& a, int b, int blk, int half) {
  if (blk >= a.num_blocks || ((a.mod_mask >> blk) & 1u)) return nullptr;
  const int mods_below = __popc(a.mod_mask & ((1u << blk) - 1u));
  return a.gab + ((size_t)b * a.n_gab + 4 * (blk - mods_below) + 2 * half) * a.hp;
}
__device__ __forceinline__ float rank1(float x, float ga, float gb) {
  return lrelu_bf(bf(bf(x * ga) + gb));
}

__global__ void __launch_bounds__(kThreads, 1) synthesis_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hp = a.hp, ld = smem_ld(a.hp), lda = smem_ld(kSpade);  // fp <= hp
  const int b = blockIdx.y, pix0 = blockIdx.x * kRows, HW = a.H * a.W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  bf16* cur = reinterpret_cast<bf16*>(smem);
  bf16* nxt = cur + kRows * ld;
  bf16* tmod = nxt + kRows * ld;
  bf16* act = tmod + kRows * ld;
  float* rgb = reinterpret_cast<float*>(act + kRows * lda);
  float* part = reinterpret_cast<float*>(act);  // ToRGB partial sums: the hidden tile idles in a conv
  unsigned char* stages = reinterpret_cast<unsigned char*>(rgb + kRows * 3);  // 128-byte aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * a.stage_bytes);
  uint64_t* empty = full + kStages;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp >= kConsumerWarps) {  // the producer warpgroup: one lane streams the weights
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      Producer p{stages, full, empty, a.stage_bytes, a.wstream, 0};
      produce(a, p);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  Ring ring{stages, full, empty, a.stage_bytes, 0};

  // input features from the pixel coordinates (coords rounded to bf16 as the
  // JAX kernel's matmul operand), and block 0's rank-1 input
  const int h2 = hp / 2;
  {
    const float sy = 2.0f / (float)(a.H - 1), sx = 2.0f / (float)(a.W - 1);
    const float* r1 = rank1_rows(a, b, 0, 0);
    for (int e = tid; e < kRows * h2; e += kConsumers) {
      const int r = e / h2, c = 2 * (e % h2), p = pix0 + r;
      const float gi = bf(__fsub_rn(__fmul_rn((float)(p / a.W), sy), 1.f));
      const float gj = bf(__fsub_rn(__fmul_rn((float)(p % a.W), sx), 1.f));
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float v = gi * a.in_w[c + j] + gj * a.in_w[hp + c + j];
        x[j] = bf(sinf(v + a.in_b[c + j]));
      }
      at2(cur + r * ld + c) = __floats2bfloat162_rn(x[0], x[1]);
      if (r1)
        at2(tmod + r * ld + c) = __floats2bfloat162_rn(rank1(x[0], r1[c], r1[hp + c]),
                                                       rank1(x[1], r1[c + 1], r1[hp + c + 1]));
    }
  }
  if (tid < kRows * 3) rgb[tid] = 0.f;
  consumer_sync();

  // this thread's accumulator rows (+ 8) and column pair within an n8 tile
  const int wg = warp >> 2, row0 = (warp & 3) * 16 + (lane >> 2), col0 = (lane & 3) * 2;
  const bf16* style = a.style + ((size_t)b * HW + pix0) * a.F;
  const bf16* fixed = a.fixed + (size_t)b * a.F;
  for (int blk = 0; blk < a.num_blocks; ++blk) {
    const bool mod = (a.mod_mask >> blk) & 1u;
    const int mods_below = __popc(a.mod_mask & ((1u << blk) - 1u));
    for (int half = 0; half < 2; ++half) {
      // a rank-1 half finds its input in tmod already; a mod half makes it
      if (mod) {
        bf16* src = half == 0 ? cur : nxt;
        const int k = mods_below * 2 + half;
        stage_style(a, style, fixed, tmod, ld);
        consumer_sync();
        // SPADE hidden: relu(style @ W_shared + b)
        const float* shb = a.sh_b + (size_t)k * kSpade;
        product<6, 1>(ring, tmod, ld, a.fp / kChunkRows, kSpade / 8, false,
                      [&](int t, const float* v) {
                        const int c = t * 8 + col0;
                        const float2 bi = ld_f2(shb + c);
#pragma unroll
                        for (int h = 0; h < 2; ++h)
                          at2(act + (row0 + 8 * h) * lda + c) = __floats2bfloat162_rn(
                              fmaxf(v[2 * h] + bi.x, 0.f), fmaxf(v[2 * h + 1] + bi.y, 0.f));
                      });
        consumer_sync();
        // gamma and beta in two column passes; a unit is the n8 tile of gamma
        // and the same columns of beta, applied to x in the epilogue
        const float* gbias = a.g_b + (size_t)k * hp;
        const float* bbias = a.bt_b + (size_t)k * hp;
        for (int pass = 0; pass < 2; ++pass) {
          product<kMaxTiles, 2>(ring, act, lda, kSpade / kChunkRows, h2 / 8, false,
                                [&](int u, const float* v) {  // gamma v[0..3], beta v[4..7]
                                  const int c = pass * h2 + u * 8 + col0;
                                  const float2 gi = ld_f2(gbias + c), bi = ld_f2(bbias + c);
#pragma unroll
                                  for (int h = 0; h < 2; ++h) {
                                    const int r = row0 + 8 * h;
                                    const bf2 g = __floats2bfloat162_rn(v[2 * h] + gi.x,
                                                                        v[2 * h + 1] + gi.y);
                                    const bf2 be = __floats2bfloat162_rn(v[4 + 2 * h] + bi.x,
                                                                         v[5 + 2 * h] + bi.y);
                                    at2(tmod + r * ld + c) = modulate2(at2(src + r * ld + c), g, be);
                                  }
                                });
        }
        consumer_sync();
      }
      // 1x1 conv (spectral norm folded) [+ skip from the block input]
      // [+ this thread's ToRGB dot products] [+ the next half's rank-1 input,
      // once every warp has read tmod]
      const bool skip = half == 1 && blk >= a.num_blocks / 2;
      const bool torgb = half == 1 && blk >= a.num_blocks / 2 - 1;
      const float* cb = a.conv_b + (size_t)(blk * 2 + half) * hp;
      const float* rw = a.rgb_w + (size_t)blk * hp * 3;
      const float* r1 = rank1_rows(a, b, blk + half, half ^ 1);
      float rs[2][3] = {};  // [row, row + 8][channel]
      product<kMaxTiles, 1>(
          ring, tmod, ld, hp / kChunkRows, hp / 8, r1 != nullptr, [&](int t, const float* v) {
            const int c = t * 8 + col0;
            const float2 bi = ld_f2(cb + c);
            bf2 ga = __float2bfloat162_rn(0.f), gb = ga;
            if (r1) {
              ga = __float22bfloat162_rn(ld_f2(r1 + c));
              gb = __float22bfloat162_rn(ld_f2(r1 + hp + c));
            }
            float2 w[3] = {};  // rgb_w rows c, c + 1: w[0].x w[0].y w[1].x | w[1].y w[2].x w[2].y
            if (torgb) {
#pragma unroll
              for (int j = 0; j < 3; ++j) w[j] = ld_f2(rw + c * 3 + 2 * j);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = row0 + 8 * h;
              bf2 y = __floats2bfloat162_rn(v[2 * h] + bi.x, v[2 * h + 1] + bi.y);
              if (skip) y = __hadd2(y, at2(cur + r * ld + c));
              at2(nxt + r * ld + c) = y;
              if (r1) at2(tmod + r * ld + c) = modulate2(y, ga, gb);
              if (torgb) {
                const float2 yf = __bfloat1622float2(y);
                rs[h][0] += yf.x * w[0].x + yf.y * w[1].y;
                rs[h][1] += yf.x * w[0].y + yf.y * w[2].x;
                rs[h][2] += yf.x * w[1].x + yf.y * w[2].y;
              }
            }
          });
      if (torgb) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            float s = rs[h][j];
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if ((lane & 3) == 0) part[wg * kRows * 3 + (row0 + 8 * h) * 3 + j] = s;
          }
      }
      consumer_sync();
      if (torgb && tid < kRows * 3) {
        float s = 0.f;
        for (int g = 0; g < kColGroups; ++g) s += part[g * kRows * 3 + tid];
        rgb[tid] += s + a.rgb_b[blk * 3 + tid % 3];
      }
    }
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (tid < kRows * 3) a.rgb_out[((size_t)b * HW + pix0) * 3 + tid] = rgb[tid];
}

}  // namespace

extern "C" int thgt_synthesis(const bf16* style, const bf16* fixed, const float* gab,
                              const float* in_w, const float* in_b, const void* wstream,
                              const float* conv_b, const float* sh_b, const float* g_b,
                              const float* bt_b, const float* rgb_w, const float* rgb_b,
                              float* rgb_out, int B, int H, int W, int F, int fp, int hp,
                              int num_blocks, int n_gab, int add_fixed, int mod_mask,
                              long long stream_bytes, cudaStream_t stream) {
  if ((H * W) % kRows || F % 4 || fp % 16 || hp % 16 || F > fp || num_blocks > 32 ||
      hp > 8 * kMaxTiles * kColGroups || fp > hp || (reinterpret_cast<size_t>(wstream) & 15))
    return (int)cudaErrorInvalidValue;
  // the stream must hold exactly what the producer walks
  long long expect = 0;
  for (int blk = 0; blk < num_blocks; ++blk)
    expect += 2 * (((mod_mask >> blk) & 1) ? (long long)fp * kSpade * 2 + 2LL * kSpade * hp * 2 : 0) +
              2LL * hp * hp * 2;
  if (expect != stream_bytes) return (int)cudaErrorInvalidValue;
  const int stage_bytes = chunk_bytes(hp > kSpade ? hp : kSpade);
  const int ld = smem_ld(hp);
  const size_t smem = sizeof(bf16) * kRows * (3 * ld + smem_ld(kSpade)) + sizeof(float) * kRows * 3 +
                      (size_t)kStages * stage_bytes + 2 * kStages * sizeof(uint64_t);
  Args a{style, fixed, gab, in_w, in_b, static_cast<const unsigned char*>(wstream), conv_b, sh_b,
         g_b, bt_b, rgb_w, rgb_b, rgb_out, B, H, W, F, fp, hp, num_blocks, n_gab, add_fixed,
         (unsigned)mod_mask, stage_bytes};
  cudaError_t err = cudaFuncSetAttribute(synthesis_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H * W / kRows, B);
  synthesis_kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
