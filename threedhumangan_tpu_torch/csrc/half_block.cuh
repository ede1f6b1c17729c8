// What the two trainable SPADE half-block kernels share, on K3's core
// (synthesis_core.cuh): K10 (csrc/synthesis_train.cu, whose header states
// the math and the rounding points) and K11 (csrc/synthesis_train_bwd.cu).
// Their register split, the ring stage of the SPADE hidden width, the BN
// and modulation steps as the JAX kernels round them, and the consumer
// warps' copies of 64-row activation tiles between global and shared
// memory.
#pragma once

#include "synthesis_core.cuh"

namespace {

using namespace syn;

// registers a thread, as K3: 32 x (40 + 3 x 152) <= 16,384 a sub-partition
constexpr int kProducerRegs = 40, kConsumerRegs = 152;
// chunks of the SPADE hidden width (16 x hidp, 4 KB at 128) a ring stage
// holds: a stage costs about the same wait and release at any size
constexpr int kHidSub = 3;
constexpr size_t kMaxSmem = 232448;  // the shared memory a CTA may have

__host__ __device__ constexpr int imax(int x, int y) { return x > y ? x : y; }
__host__ __device__ constexpr int chunk_bytes(int n) { return kChunkRows * n * (int)sizeof(bf16); }

__device__ __forceinline__ float norm_hat(float h, float m, float r) {
  return __fmul_rn(__fsub_rn(h, m), r);
}
__device__ __forceinline__ float affine_u(float nhat, float a, float b) {
  return bf(__fadd_rn(__fmul_rn(nhat, a), b));
}
__device__ __forceinline__ float modulate(float u, float gam, float bet) {
  return bf(bf(u * gam) + bet);
}
__device__ __forceinline__ float2 f2(bf2 x) { return __bfloat1622float2(x); }
__device__ __forceinline__ bf2 to2(float x, float y) { return __floats2bfloat162_rn(x, y); }

// 16 bytes global -> shared that skip the registers, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 64 rows x ncp columns into shared memory (row stride lds) from a row-major
// global matrix of nc columns; rows >= nv and columns >= nc read as 0.  The
// copies of one call are one cp.async group, in flight until the caller's
// cp_async_wait; its consumer barrier then makes the tile visible.
__device__ void load_tile(bf16* s, int lds, const bf16* g, int nc, int ncp, int nv) {
  if ((nc & 7) == 0) {
    const int vecs = ncp / 8;
    for (int e = threadIdx.x; e < kRows * vecs; e += kConsumers) {
      const int r = e / vecs, c = (e % vecs) * 8;
      const bool v = r < nv && c < nc;
      cp_async16(s + r * lds + c, v ? g + (size_t)r * nc + c : g, v);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * ncp; e += kConsumers) {
      const int r = e / ncp, c = e % ncp;
      s[r * lds + c] = (r < nv && c < nc) ? g[(size_t)r * nc + c] : __float2bfloat16(0.f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// rows [0, nv) x columns [0, nc) of a shared tile to a row-major global matrix of nc columns
__device__ void store_tile(bf16* g, const bf16* s, int lds, int nc, int nv) {
  if ((nc & 7) == 0) {
    const int vecs = nc / 8;
    for (int e = threadIdx.x; e < nv * vecs; e += kConsumers) {
      const int r = e / vecs, c = (e % vecs) * 8;
      *reinterpret_cast<uint4*>(g + (size_t)r * nc + c) = *reinterpret_cast<const uint4*>(s + r * lds + c);
    }
  } else {
    for (int e = threadIdx.x; e < nv * nc; e += kConsumers) {
      const int r = e / nc, c = e % nc;
      g[(size_t)r * nc + c] = s[r * lds + c];
    }
  }
}

}  // namespace
