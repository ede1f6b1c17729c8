// The weight-gradient reduction of K9 and K11: out (K, N) f32 = sum over
// rows of X^T Y, X (rows, K) and Y (rows, N) bf16 row-major, K and N
// multiples of 16, as per-chunk partials that the host sums in a fixed order
// (ops/raymarch_bwd.py::wgrad).  No atomics: the same bits from run to run.
//
// Replaces the in-kernel dW accumulation of the TPU kernels
// threedhumangan_tpu/ops/raymarch_bwd.py::_bwd_step_kernel (K9) and
// ops/synthesis_train.py::_bwd_kernel (K11, acc("dw", _outer(t, g))), which
// carry a sum over the sequential grid in VMEM; blocks of the card run in no
// order, so each CTA sums one chunk of rows and writes its partial.
//
// What bounds it on an H100: at K11's conv product (262,144 rows, K = N =
// 384) 77 GFLOP of bf16 products (0.078 ms at 989 TFLOP/s) against 403 MB of
// operands (0.120 ms at 3.35 TB/s): the bytes, if each operand leaves device
// memory once.  The design keeps that: a CTA owns a 128 x 128 output tile
// and a chunk of rows; the CTAs of one chunk run in the same wave, so an
// operand row leaves device memory once and the L2 serves its other reads.
//
// Design: the reduction runs over rows, so a row-major X chunk is A^T
// (M-major) and a Y chunk is N-major; both are described to wgmma from
// shared memory with the transpose bits (bf16 allows them).  The producer
// warpgroup copies each 64-row chunk of X and Y with 16-byte cp.async into
// wgmma's MN-major layout with the 128-byte swizzle (an atom is 8 rows of 64
// consecutive columns, 128 bytes a row, its 16-byte groups permuted by the
// row; the 8-row groups 1024 bytes apart, the 64-column atoms 8192), so
// the tensor cores read it without bank conflicts; it zero-fills columns
// past K or N and arrives on the stage's "full" mbarrier when its copies
// land (cp.async.mbarrier.arrive.noinc), four stages deep.  Two consumer
// warpgroups each issue wgmma m64n128k16 on their 64 output rows, four per
// chunk, and release a stage once those retire.  Nothing synchronises the
// CTA inside the row loop.
#include <cuda_runtime.h>

#include "synthesis_core.cuh"

namespace {

using syn::bf16;

constexpr int kTileM = 128;              // output rows (columns of X) a CTA owns
constexpr int kTileN = 128;              // output columns (columns of Y)
constexpr int kChunk = 64;               // rows of X and Y a ring stage holds
constexpr int kStages = 4;
constexpr int kConsumerGroups = kTileM / 64;
constexpr int kThreads = (kConsumerGroups + 1) * 128;  // + the producer warpgroup
constexpr int kOperandBytes = kChunk * kTileM * 2;      // 16 KB: kTileM == kTileN
constexpr int kStageBytes = 2 * kOperandBytes;
// the MN-major 128-byte-swizzled layout of a stage operand (1024-byte
// aligned): byte of (row k, 16-byte column group cg)
constexpr int kAtomBytes = kChunk * 128;  // 64 columns of 64 rows

__device__ __forceinline__ uint32_t tile_byte(int k, int cg) {
  return (cg >> 3) * kAtomBytes + (k >> 3) * 1024 + (k & 7) * 128 + (((cg & 7) ^ (k & 7)) << 4);
}

// MN-major, 128-byte swizzle: the 64-column atoms kAtomBytes apart (leading
// offset), the 8-row (K) groups 1024 bytes apart (stride offset)
__device__ __forceinline__ uint64_t desc_mn(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(kAtomBytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// arrive on bar once this thread's cp.async so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(syn::smem_u32(bar))
               : "memory");
}
// order the copies seen through the mbarrier before wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 128 f32, 64 a thread) += A (64 x 16, M-major) x B (16 x 128, N-major)
__device__ __forceinline__ void wgmma_n128_tt(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

struct Args {
  const bf16* X;
  const bf16* Y;
  float* part;  // (n_chunks, K, N)
  int K, N, rows, chunk_rows;
};

__global__ void __launch_bounds__(kThreads, 1) wgrad_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle pattern follows address bits 4-9: stages start on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (syn::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * kTileM;
  const int p_begin = blockIdx.z * a.chunk_rows, p_end = min(a.rows, p_begin + a.chunk_rows);
  const int nk = (p_end - p_begin + kChunk - 1) / kChunk;
  const int tid = threadIdx.x, warp = tid >> 5, wg = warp >> 2;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      syn::mbar_init(&full[s], 128);
      syn::mbar_init(&empty[s], 4 * kConsumerGroups);
    }
    syn::mbar_fence_init();
  }
  __syncthreads();
  const uint32_t base = syn::smem_u32(smem);

  if (wg == kConsumerGroups) {  // the producer warpgroup: 8 + 8 copies a thread a chunk
    const int t = tid - kConsumerGroups * 128;
    for (int it = 0; it < nk; ++it) {
      const int st = it % kStages;
      syn::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);  // a fresh stage passes at once
      const int p0 = p_begin + it * kChunk;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // 8 threads a row of an atom: its 128 bytes are one read and one
        // conflict-free write
        const int u = t + 128 * i;
        const int k = (u >> 3) & 63, cg = (u >> 9) * 8 + (u & 7);
        const int p = p0 + k;
        const uint32_t dst = base + st * kStageBytes + tile_byte(k, cg);
        const bool rv = p < p_end;
        const int cx = m0 + cg * 8, cy = n0 + cg * 8;
        const bool vx = rv && cx < a.K, vy = rv && cy < a.N;
        cp_async16(dst, vx ? a.X + (size_t)p * a.K + cx : a.X, vx);
        cp_async16(dst + kOperandBytes, vy ? a.Y + (size_t)p * a.N + cy : a.Y, vy);
      }
      cp_async_arrive(&full[st]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const uint32_t a_off = wg * kAtomBytes;  // this warpgroup's 64 columns of X
  int held = -1;
  for (int it = 0; it < nk; ++it) {
    const int st = it % kStages;
    syn::mbar_wait(&full[st], (it / kStages) & 1);
    fence_proxy_async();
    syn::wgmma_fence();
    const uint32_t sx = base + st * kStageBytes, sy = sx + kOperandBytes;
#pragma unroll
    for (int j = 0; j < kChunk / 16; ++j)  // a k16 step spans two 8-row groups
      wgmma_n128_tt(acc, desc_mn(sx + a_off + j * 2048), desc_mn(sy + j * 2048));
    syn::wgmma_commit();
    syn::wgmma_wait<1>();
    if (held >= 0) syn::warp_arrive(&empty[held]);
    held = st;
  }
  syn::wgmma_wait<0>();
  if (held >= 0) syn::warp_arrive(&empty[held]);

  // accumulator (row 16 (warp % 4) + lane / 4 [+ 8], columns 8 t + 2 (lane % 4) [+ 1])
  const int lane = tid & 31;
  const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  float* out = a.part + (size_t)blockIdx.z * a.K * a.N;
#pragma unroll
  for (int t = 0; t < kTileN / 8; ++t) {
    const int c = n0 + t * 8 + (lane & 3) * 2;
    if (c >= a.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < a.K)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8 * h) * a.N + c) =
            make_float2(acc[4 * t + 2 * h], acc[4 * t + 2 * h + 1]);
  }
}

}  // namespace

extern "C" int thgt_wgrad(const bf16* X, const bf16* Y, float* part, int K, int N, int rows,
                          int chunk_rows, int n_chunks, cudaStream_t stream) {
  if (K % 16 || N % 16 || K <= 0 || N <= 0 || chunk_rows <= 0 || chunk_rows % kChunk ||
      (long long)chunk_rows * n_chunks < rows || (long long)chunk_rows * (n_chunks - 1) >= rows ||
      (reinterpret_cast<size_t>(X) & 15) || (reinterpret_cast<size_t>(Y) & 15))
    return (int)cudaErrorInvalidValue;
  const int smem = 1024 + kStages * kStageBytes + 2 * kStages * (int)sizeof(uint64_t);
  cudaError_t err =
      cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kTileN - 1) / kTileN, (K + kTileM - 1) / kTileM, n_chunks);
  wgrad_kernel<<<grid, kThreads, smem, stream>>>(Args{X, Y, part, K, N, rows, chunk_rows});
  return (int)cudaGetLastError();
}
