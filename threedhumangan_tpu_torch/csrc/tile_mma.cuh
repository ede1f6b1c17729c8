// Tile-GEMM helpers shared by the field (raymarch.cu, raymarch_bwd.cu) and
// synthesis (synthesis.cu, synthesis_train.cu) kernels: one CTA holds a
// 64-row activation tile in shared memory (bf16) and multiplies it by each
// layer's weights on tensor cores through nvcuda::wmma bf16 16x16x16
// fragments with float32 accumulation.
//
// Weights (L2-resident: every CTA of a launch reads the same ones) are
// copied by the whole CTA, 16 rows at a time, into a double-buffered
// shared-memory ring with 16-byte cp.async, so the copy of chunk k+1
// overlaps the products of chunk k.  A warp owns up to kTilesPerWarp
// 16-column tiles of the output for all four 16-row tiles of the CTA and
// keeps their accumulators in registers for the whole K loop; it loads
// each A fragment of a chunk once and uses it for all its column tiles.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace thgt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;          // activation rows a CTA holds
constexpr int kRowTiles = kRows / 16;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Row stride (elements) of a shared-memory activation buffer of width n
// (n a multiple of 16): +8 bf16 staggers consecutive rows by 16 bytes, so
// the 8 row segments a fragment load touches fall in distinct banks.
__host__ __device__ constexpr int smem_ld(int n) { return n + 8; }

constexpr int kPanel = 432;  // output columns per pass of the staged GEMM
constexpr int kTilesPerWarp = (kPanel / 16 + kWarps - 1) / kWarps;
// shared-memory elements of the weight ring: two chunks of 16 x kPanel
constexpr int kWeightRing = 2 * 16 * (kPanel + 8);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// src (kRows, K) in shared memory x W (K, N) in global memory.  For each
// output column tile n0 a warp owns, tile_epi(n0, acc) receives the float32
// accumulators of the kRowTiles row tiles.  K, N multiples of 16; every
// thread of the CTA must call it (it synchronises the CTA).
template <typename TileEpi>
__device__ __forceinline__ void gemm_staged(const bf16* src, int lds, const bf16* W, int ldw,
                                            int K, int N, bf16* ring, TileEpi tile_epi) {
  constexpr int ldr = smem_ld(kPanel);
  const int warp = threadIdx.x >> 5;
  const int nk = K / 16;
  for (int p0 = 0; p0 < N; p0 += kPanel) {
    const int pn = min(kPanel, N - p0);
    const int vecs = pn / 8;  // 16-byte vectors per weight row
    auto load_chunk = [&](int kc) {
      bf16* dst = ring + (kc & 1) * 16 * ldr;
      const bf16* g = W + (size_t)kc * 16 * ldw + p0;
      for (int e = threadIdx.x; e < 16 * vecs; e += kThreads) {
        const int r = e / vecs, v = e % vecs;
        cp_async16(dst + r * ldr + v * 8, g + (size_t)r * ldw + v * 8);
      }
      cp_async_commit();
    };
    FragC acc[kTilesPerWarp][kRowTiles];
#pragma unroll
    for (int t = 0; t < kTilesPerWarp; ++t)
#pragma unroll
      for (int m = 0; m < kRowTiles; ++m) wmma::fill_fragment(acc[t][m], 0.0f);
    load_chunk(0);
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) {
        load_chunk(kc + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* wb = ring + (kc & 1) * 16 * ldr;
      FragA a[kRowTiles];
#pragma unroll
      for (int m = 0; m < kRowTiles; ++m)
        wmma::load_matrix_sync(a[m], src + (size_t)m * 16 * lds + kc * 16, lds);
#pragma unroll
      for (int t = 0; t < kTilesPerWarp; ++t) {
        const int tile = warp + t * kWarps;
        if (tile * 16 < pn) {
          FragB b;
          wmma::load_matrix_sync(b, wb + tile * 16, ldr);
#pragma unroll
          for (int m = 0; m < kRowTiles; ++m) wmma::mma_sync(acc[t][m], a[m], b, acc[t][m]);
        }
      }
      __syncthreads();  // the next iteration refills the buffer just read
    }
#pragma unroll
    for (int t = 0; t < kTilesPerWarp; ++t) {
      const int tile = warp + t * kWarps;
      if (tile * 16 < pn) tile_epi(p0 + tile * 16, acc[t]);
    }
  }
}

// Two products sharing A (the SPADE gamma and beta heads).
template <int MT>
__device__ __forceinline__ void warp_gemm2(const bf16* A, int lda, const bf16* B1,
                                           const bf16* B2, int ldb, int n0, int K,
                                           FragC (&acc1)[MT], FragC (&acc2)[MT]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    wmma::fill_fragment(acc1[m], 0.0f);
    wmma::fill_fragment(acc2[m], 0.0f);
  }
  for (int k = 0; k < K; k += 16) {
    FragB b1, b2;
    wmma::load_matrix_sync(b1, B1 + (size_t)k * ldb + n0, ldb);
    wmma::load_matrix_sync(b2, B2 + (size_t)k * ldb + n0, ldb);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      FragA a;
      wmma::load_matrix_sync(a, A + (size_t)m * 16 * lda + k, lda);
      wmma::mma_sync(acc1[m], a, b1, acc1[m]);
      wmma::mma_sync(acc2[m], a, b2, acc2[m]);
    }
  }
}

// Store one accumulator (16x16) into the warp's float scratch, row-major,
// and make it visible to the whole warp.
__device__ __forceinline__ void stage(float* scratch, const FragC& acc) {
  wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
  __syncwarp();
}

// One dense layer over the CTA's kRows rows: epi(row, col, (src @ W)[row,
// col]) with the float32 product, element by element through the warp's
// float scratch tile (16 x 16).  Every thread of the CTA must call it.
template <typename Epi>
__device__ __forceinline__ void layer(const bf16* src, int lds, const bf16* W, int ldw, int K,
                                      int N, bf16* ring, float* scratch, Epi epi) {
  const int lane = threadIdx.x & 31;
  gemm_staged(src, lds, W, ldw, K, N, ring, [&](int n0, FragC(&acc)[kRowTiles]) {
#pragma unroll
    for (int m = 0; m < kRowTiles; ++m) {
      stage(scratch, acc[m]);
      for (int e = lane; e < 256; e += 32) epi(m * 16 + (e >> 4), n0 + (e & 15), scratch[e]);
      __syncwarp();
    }
  });
}

// One dense layer over the CTA's rows whose epilogue also reduces NS column
// sums: epi(row, col, value, s) adds its contributions to s[0..NS).  A warp
// owns each 16-column tile, so colacc[j * acc_ld + col] is written by one
// warp: a lane sums its 8 rows of a column tile, the two lanes sharing a
// column combine, and lane < 16 adds to the accumulator.
template <int NS, typename Epi>
__device__ __forceinline__ void layer_colsum(const bf16* src, int lds, const bf16* W, int ldw, int K,
                                             int N, bf16* ring, float* scratch, float* colacc,
                                             int acc_ld, Epi epi) {
  const int lane = threadIdx.x & 31;
  gemm_staged(src, lds, W, ldw, K, N, ring, [&](int n0, FragC(&acc)[kRowTiles]) {
    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
#pragma unroll
    for (int m = 0; m < kRowTiles; ++m) {
      stage(scratch, acc[m]);
      for (int e = lane; e < 256; e += 32) epi(m * 16 + (e >> 4), n0 + (e & 15), scratch[e], s);
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 16);
      if (lane < 16) colacc[j * acc_ld + n0 + lane] += s[j];
    }
  });
}

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16(x)); }

// lrelu as the JAX kernels' bf16 min/max algebra: max(x,0) + bf(s*min(x,0)),
// their weakly typed slope 0.2 taken in bf16 (0.2001953125)
__device__ __forceinline__ float lrelu_bf(float v) { return v >= 0.f ? v : bf(0.2001953125f * v); }

}  // namespace thgt
