// K3's core (csrc/synthesis.cu): a weight stream on an mbarrier ring and
// wgmma products, A from registers, whose epilogues run on the accumulators
// in registers.
//
// The wrapper (ops/synthesis_kernel.py::pack_weight_stream) writes every
// weight the kernel reads into one bf16 stream of chunk images, in the
// order the kernel consumes them.  A chunk holds 16 K-rows of one product
// (or of the gamma and beta heads together) as 8 x 16-byte core matrices,
// wgmma's K-major layout without swizzle: for the 8-column group s and the
// K half kb, the 8 columns' rows of 8 K values lie at byte s * 256 + kb *
// 128 + n * 16.  One producer lane copies the chunks with 1-D cp.async.bulk
// into a ring of kStages stages, each with a "full" mbarrier (expect_tx)
// and an "empty" one the consumer warps arrive on; nothing else
// synchronises inside a product's K loop.
//
// Three consumer warpgroups split a 64-row product by columns, each all 64
// rows: a warp loads its 16 rows of A with ldmatrix.x4 from the row-major
// activation tile (rows staggered by 16 bytes, smem_ld) and the warpgroup
// issues wgmma m64nNk16 bf16 -> f32 with B described in the ring stage.  A
// thread holds, for each n8 tile, the rows 16 (warp % 4) + lane / 4 and + 8
// and the columns 2 (lane % 4) and + 1: the epilogue applies there.  The
// producer warpgroup gives its registers to the consumers (setmaxnreg).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma_tiles.cuh"

namespace syn {

using bf16 = __nv_bfloat16;
using bf2 = __nv_bfloat162;

constexpr int kRows = 64;               // pixels (activation rows) a CTA holds
constexpr int kColGroups = 3;           // consumer warpgroups, each all 64 rows
constexpr int kConsumerWarps = 4 * kColGroups;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kStages = 3;              // weight ring depth
constexpr int kChunkRows = 16;          // K rows of a chunk image
constexpr int kMaxTiles = 18;           // n8 tiles a warpgroup owns: N <= 432
constexpr int kSlice = 9;               // n8 tiles of one wgmma m64n72k16
constexpr int kSpade = 128;             // SPADE hidden width
// a wait this long means the stream and the consumers disagree: fault, not hang
constexpr long long kWatchdogCycles = 1ll << 32;

// Row stride (elements) of an activation tile of width n (a multiple of 16):
// +8 bf16 staggers consecutive rows by 16 bytes, so the 8 rows an ldmatrix
// phase reads fall in distinct banks.
__host__ __device__ constexpr int smem_ld(int n) { return n + 8; }

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16(x)); }

// lrelu as the JAX kernel's bf16 min/max algebra: max(x,0) + bf(s*min(x,0)),
// its weakly typed slope 0.2 taken in bf16 (0.2001953125)
__device__ __forceinline__ float lrelu_bf(float v) { return v >= 0.f ? v : bf(0.2001953125f * v); }

// The same on a bf16 pair, and the modulation lrelu(bf(bf(x * g) + b)) of a
// bf16 pair by bf16 pairs: each step rounds to bf16 as the JAX kernel's
// bf16 arithmetic does (an _rn product is never contracted into an FMA).
__device__ __forceinline__ bf2 lrelu2(bf2 x) {
  const bf2 z = __float2bfloat162_rn(0.f), s = __float2bfloat162_rn(0.2001953125f);
  return __hadd2(__hmax2(x, z), __hmul2_rn(__hmin2(x, z), s));
}
__device__ __forceinline__ bf2 modulate2(bf2 x, bf2 g, bf2 b) {
  return lrelu2(__hadd2(__hmul2_rn(x, g), b));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ bf2& at2(bf16* p) { return *reinterpret_cast<bf2*>(p); }
__device__ __forceinline__ float2 ld_f2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// ---- mbarriers and the bulk copy
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Lane 0 of the warp arrives on bar (predicated: no branch may sit between
// the wgmma in flight and their wait, or they are issued one at a time).
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %1, 0;\n @p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(threadIdx.x & 31)
      : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > kWatchdogCycles) {
      __trap();
    }
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the consumer warps alone (named barrier 1; the producer never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// 8-byte copy global -> shared that skips the registers
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ---- A fragments and wgmma
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// B's shared-memory descriptor: K-major core matrices without swizzle, the
// two K halves 128 bytes apart (leading offset), the 8-column groups 256
// bytes apart (stride offset)
__device__ __forceinline__ uint64_t desc_b(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d (64 x 72 f32, 36 a thread) += a (64 x 16 bf16, 4 registers a thread) x B (16 x 72)
__device__ __forceinline__ void wgmma_n72(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma_n8(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// The consumers' view of a ring of S stages: `it` counts the chunks
// consumed, so chunk it sits in stage it % S, filled in phase (it / S) & 1.
template <int S>
struct RingT {
  static constexpr int kS = S;
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  int stage_bytes;
  uint32_t it;
};
using Ring = RingT<kStages>;

// The producer: copy `n` chunks of `bytes` each, in order, from `src`.
template <int S>
struct ProducerT {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  int stage_bytes;
  const unsigned char* src;
  uint32_t it;

  __device__ __forceinline__ void put(int n, uint32_t bytes) {
    for (int c = 0; c < n; ++c, ++it, src += bytes) {
      const int st = it % S;
      mbar_wait(&empty[st], ((it / S) & 1) ^ 1);  // a fresh stage passes at once
      mbar_expect_tx(&full[st], bytes);
      bulk_copy(stages + st * stage_bytes, src, bytes, &full[st]);
    }
  }
  // n chunks of `bytes` each, `sub` consecutive ones to a stage with one copy
  // (the last stage may hold fewer): k_loop<.., kSub = sub> consumes them
  __device__ __forceinline__ void put(int n, uint32_t bytes, int sub) {
    for (int c = 0; c < n; c += sub, ++it) {
      const uint32_t b = bytes * (uint32_t)min(sub, n - c);
      const int st = it % S;
      mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
      mbar_expect_tx(&full[st], b);
      bulk_copy(stages + st * stage_bytes, src, b, &full[st]);
      src += b;
    }
  }
};
using Producer = ProducerT<kStages>;

// The K loop of a warpgroup that owns NT n8 tiles: per chunk, wgmma
// m64n72k16 on each full 72-column slice and m64n8k16 on the rest, all
// unconditional; A loaded per warp into two register sets in turn; a stage
// is released once the wgmma that read it have retired (wait_group 1 after
// the next chunk's).  With kSub > 1 a stage holds kSub consecutive chunks
// of img_bytes each (Producer::put(n, bytes, kSub)): one wait and one
// release a stage.  With kOne a k step is one wgmma over all NT tiles
// (wgmma_tiles.cuh).
template <int NT, int MT, int kSub = 1, bool kOne = false, typename R>
__device__ __forceinline__ void k_loop(R& ring, float (&acc)[MT][4], uint32_t a_addr,
                                       uint32_t b_off, int nk, uint32_t img_bytes = 0) {
  uint32_t a0[4], a1[4];
  int held = -1;
  int st = 0;
  auto step = [&](uint32_t(&a)[4], int kc) {
    const int sub = kSub == 1 ? 0 : kc % kSub;
    if (sub == 0) {
      st = ring.it % R::kS;
      mbar_wait(&ring.full[st], (ring.it / R::kS) & 1);
    }
    if constexpr (NT > 0) {
      ldsm_x4(a, a_addr + kc * 32);
      wgmma_fence();
      const uint32_t b = smem_u32(ring.stages + st * ring.stage_bytes) + b_off + sub * img_bytes;
      if constexpr (kOne) {
        wgmma_tiles<NT>(&acc[0][0], a, desc_b(b));
      } else {
#pragma unroll
        for (int s = 0; s < NT / kSlice; ++s)
          wgmma_n72(&acc[kSlice * s][0], a, desc_b(b + s * kSlice * 256));
#pragma unroll
        for (int t = NT / kSlice * kSlice; t < NT; ++t) wgmma_n8(&acc[t][0], a, desc_b(b + t * 256));
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    if (sub == 0) {
      if (held >= 0) warp_arrive(&ring.empty[held]);
      held = st;
      ++ring.it;
    }
  };
  int kc = 0;
  for (; kc + 1 < nk; kc += 2) {
    step(a0, kc);
    step(a1, kc + 1);
  }
  if (kc < nk) step(a0, kc);
  wgmma_wait<0>();
  warp_arrive(&ring.empty[held]);
}

// One product of the CTA's 64-row activation tile A (row-major bf16, row
// stride lda) with the next nk chunks of the ring (kSub to a stage; kOne:
// one wgmma a k step), whose images hold `units` column units of U n8
// tiles each.  Warpgroup g owns a contiguous
// run of at most MT / U units; its K loop is instantiated for its tile
// count.  After the K loop (and, with sync_first, a barrier of the
// consumers, so the epilogue may overwrite A), epi(unit, v) receives for
// each of its units the U x 4 float32 accumulators of this thread (see the
// note at the top).  Every consumer thread must call it with the same
// arguments.
template <int MT, int U, int kSub = 1, bool kOne = false, typename R, typename Epi>
__device__ __forceinline__ void product(R& ring, const bf16* A, int lda, int nk, int units,
                                        bool sync_first, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int per = units / kColGroups, rem = units % kColGroups;
  const int cnt = per + (wg < rem), u0 = wg * per + min(wg, rem);
  float acc[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  const uint32_t a_addr = smem_u32(A + ((warp & 3) * 16 + (lane & 15)) * lda + (lane >> 4) * 8);
  const uint32_t b_off = u0 * U * 256, img = units * U * 256;
  switch (cnt * U) {
#define SYN_K_LOOP(n)                                                 \
  case n:                                                             \
    if constexpr (n <= MT)                                            \
      k_loop<n, MT, kSub, kOne>(ring, acc, a_addr, b_off, nk, img);  \
    break;
    SYN_K_LOOP(0) SYN_K_LOOP(1) SYN_K_LOOP(2) SYN_K_LOOP(3) SYN_K_LOOP(4) SYN_K_LOOP(5)
    SYN_K_LOOP(6) SYN_K_LOOP(7) SYN_K_LOOP(8) SYN_K_LOOP(9) SYN_K_LOOP(10) SYN_K_LOOP(11)
    SYN_K_LOOP(12) SYN_K_LOOP(13) SYN_K_LOOP(14) SYN_K_LOOP(15) SYN_K_LOOP(16) SYN_K_LOOP(17)
    SYN_K_LOOP(18)
#undef SYN_K_LOOP
    default:
      __trap();
  }
  if (sync_first) consumer_sync();
#pragma unroll
  for (int u = 0; u < MT / U; ++u)
    if (u < cnt) epi(u0 + u, &acc[u * U][0]);
}

}  // namespace syn
