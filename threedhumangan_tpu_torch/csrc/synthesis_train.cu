// K10: the trainable fused SPADE half-block (train-mode synthesis), forward,
// on K3's core (synthesis_core.cuh).
//
// Replaces threedhumangan_tpu/ops/synthesis_train.py::_fwd_kernel (Pallas,
// TPU).  Per pixel of one half-block:
//
//   nhat = (h - m) r,  u = bf(nhat a + b)                 (f32, no FMA)
//   spatial: st = bf(style + fixed), z0 = st sh_w + sh_b, actv = bf(relu z0),
//            gam = bf(bf(actv g_w + g_b) + 1), bet = bf(actv bt_w + bt_b)
//   rank-1:  gam, bet = the image's rows
//   s = bf(bf(u gam) + bet),  t = lrelu(s) (slope bf16 0.2001953125),
//   out = bf(t W + c)
//
// Rounding follows the JAX kernels (ops/synthesis_train.py:159-177).  The
// backward (K11) is csrc/synthesis_train_bwd.cu; what both share is
// csrc/half_block.cuh.
//
// What bounds it on an H100: at MAP3DBN's shapes (8 x 256 x 128 pixels,
// Ci = Co = Cs = 384, hidden 128) the products are 590 kFLOP a pixel for a
// spatial half-block (155 GFLOP) and 295 kFLOP for a rank-1 one; the
// device-memory streams (h, style, out: ~0.6 GB bf16) take 0.18 ms at
// 3.35 TB/s against 0.16 ms of bf16 tensor-core time, so the chain is near
// the machine balance: the products must not wait on the weights, and the
// epilogues must not wait on shared memory.
//
// Design: K11's recompute half (without its operand writes) plus the conv.
// Every weight reaches the kernel as one host-packed bf16 stream of 16-row
// chunk images in wgmma's K-major B layout, in the order the products
// consume them (ops/synthesis_train.py::pack_fwd_stream): sh_w, the
// gamma/beta heads interleaved a column group at a time (gamma_beta_pass),
// W.  One producer lane copies the chunks with cp.async.bulk into K3's
// mbarrier ring (four stages, each released as soon as its own wgmma have
// retired; the chunks of the SPADE hidden width three to a stage); three
// consumer warpgroups split each 64-row product by columns
// and issue one wgmma a k step over their whole column run, A from
// registers (ldmatrix from the row-major tiles).  Every epilogue runs on the accumulators in
// registers, in bf16 pairs: the SPADE layer's writes actv, the heads' form
// gamma, beta, u (from the h tile), s and t and write t over the style
// tile (no warpgroup reads style once the SPADE layer is done), and the
// conv's writes bf(v + c) over the h tile (read until the heads end).  The
// h and style tiles load with cp.async; h lands while the SPADE layer runs.
// The output tile leaves shared memory with 16-byte stores.
#include <cuda_runtime.h>

#include "half_block.cuh"

namespace {

using namespace syn;

struct Args {
  const bf16* h;         // (B, HW, ci)
  const bf16* style;     // (B, HW, cs)
  const bf16* fixed;     // (B, cs), or null
  const bf16* gam;       // (B, cip) rank-1 rows
  const bf16* bet;       // (B, cip)
  const float* m;        // (cip) batch mean
  const float* r;        // (cip) rsqrt(var + eps)
  const float* a;        // (cip) BN scale
  const float* b;        // (cip) BN bias
  const float* sh_b;     // (hidp)
  const float* g_b;      // (cip)
  const float* bt_b;     // (cip)
  const float* c;        // (cop) conv bias
  const unsigned char* wstream;  // chunk images, pack_fwd_stream
  bf16* out;             // (B, HW, co)
  int B, HW, ci, cs, co, cip, csp, cop, hidp, spatial, add_fixed, stage_bytes;
};

// The producer walks the stream as the consumers consume it.
template <typename P>
__device__ void produce(const Args& a, P& p) {
  if (a.spatial) {
    p.put(a.csp / kChunkRows, chunk_bytes(a.hidp), kHidSub);  // SPADE shared layer
    p.put(2 * a.hidp / kChunkRows, chunk_bytes(a.cip));       // gamma/beta heads, two passes
  }
  p.put(a.cip / kChunkRows, chunk_bytes(a.cop));              // W
}

// Ring depth and the kEager release of the products that take one chunk a
// stage (synthesis_core.cuh::k_loop: a stage is released once its own
// wgmma have retired, a chunk earlier): the fastest of 4 or 6 stages with
// or without kEager on an H100 (PERF.md).
constexpr int kRingStages = 4;
constexpr bool kEagerRelease = true;

// Row strides of the tiles: h -> out, style -> t, actv
__host__ __device__ inline int ld_h(int cip, int cop) { return smem_ld(imax(cip, cop)); }
__host__ __device__ inline int ld_t(int cip, int csp) { return smem_ld(imax(cip, csp)); }
__host__ __device__ inline int ld_act(int hidp, int spatial) { return spatial ? smem_ld(hidp) : 0; }

__host__ __device__ inline size_t tiles_bytes(int cip, int csp, int cop, int hidp, int spatial) {
  const size_t t = sizeof(bf16) * kRows *
                   (ld_h(cip, cop) + ld_t(cip, csp) + ld_act(hidp, spatial));
  return (t + 127) & ~size_t(127);
}

int stage_bytes(int cip, int cop, int hidp, int spatial) {
  return spatial ? imax(chunk_bytes(imax(cip, cop)), kHidSub * chunk_bytes(hidp))
                 : chunk_bytes(cop);
}

size_t fwd_smem(int cip, int csp, int cop, int hidp, int spatial) {
  return tiles_bytes(cip, csp, cop, hidp, spatial) +
         (size_t)kRingStages * stage_bytes(cip, cop, hidp, spatial) +
         2 * kRingStages * sizeof(uint64_t);
}

// kMT n8 tiles at most a warpgroup owns in a product
template <int kMT>
__global__ void __launch_bounds__(kThreads, 1) half_block_fwd(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bimg = blockIdx.y, p0 = blockIdx.x * kRows, nv = min(kRows, a.HW - p0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t px0 = (size_t)bimg * a.HW + p0;
  const int cip = a.cip;
  const int ldh = ld_h(cip, a.cop), ldt = ld_t(cip, a.csp), lda = ld_act(a.hidp, a.spatial);
  bf16* hbuf = reinterpret_cast<bf16*>(smem);  // h -> out
  bf16* tbuf = hbuf + kRows * ldh;              // style -> t
  bf16* act = tbuf + kRows * ldt;               // actv
  unsigned char* stages = smem + tiles_bytes(cip, a.csp, a.cop, a.hidp, a.spatial);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kRingStages * a.stage_bytes);
  uint64_t* empty = full + kRingStages;

  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp >= kConsumerWarps) {  // the producer warpgroup: one lane streams the weights
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      ProducerT<kRingStages> p{stages, full, empty, a.stage_bytes, a.wstream, 0};
      produce(a, p);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  RingT<kRingStages> ring{stages, full, empty, a.stage_bytes, 0};

  // this thread's accumulator rows (+ 8) and column pair within an n8 tile
  const int row0 = (warp & 3) * 16 + (lane >> 2), col0 = (lane & 3) * 2;

  // ---- t = lrelu(s), into the t tile.  The h tile lands during the SPADE
  // shared layer.
  if (a.spatial) load_tile(tbuf, ldt, a.style + px0 * a.cs, a.cs, a.csp, nv);
  load_tile(hbuf, ldh, a.h + px0 * a.ci, a.ci, cip, nv);
  if (a.spatial)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  consumer_sync();
  if (a.spatial) {
    if (a.add_fixed) {
      const bf16* fx = a.fixed + (size_t)bimg * a.cs;
      const int step = 2 - (a.cs & 1);  // bf16 pairs when the rows keep them aligned
      for (int r = warp; r < kRows; r += kConsumerWarps) {
        bf16* row = tbuf + r * ldt;
        for (int c = step * lane; c < a.cs; c += 32 * step) {
          if (step == 2) {
            const float2 x = f2(at2(row + c)), y = f2(*reinterpret_cast<const bf2*>(fx + c));
            at2(row + c) = to2(x.x + y.x, x.y + y.y);
          } else {
            row[c] = __float2bfloat16(__bfloat162float(row[c]) + __bfloat162float(fx[c]));
          }
        }
      }
      consumer_sync();
    }
    // SPADE hidden: actv = relu(st sh_w + sh_b)
    product<6, 1, kHidSub, true>(ring, tbuf, ldt, a.csp / kChunkRows, a.hidp / 8, false,
                                 [&](int t, const float* v) {
                                   const int c = t * 8 + col0;
                                   const float2 bi = ld_f2(a.sh_b + c);
#pragma unroll
                                   for (int h = 0; h < 2; ++h)
                                     at2(act + (row0 + 8 * h) * lda + c) =
                                         to2(fmaxf(v[2 * h] + bi.x, 0.f), fmaxf(v[2 * h + 1] + bi.y, 0.f));
                                 });
    cp_async_wait<0>();  // h
    consumer_sync();
    // gamma and beta in two column passes; a unit is the n8 tile of gamma and
    // the same columns of beta: u, s and t in the epilogue
    const int h2 = cip / 2;
    for (int pass = 0; pass < 2; ++pass) {
      product<kMT, 2, 1, true, kEagerRelease>(ring, act, lda, a.hidp / kChunkRows, h2 / 8, false,
                               [&](int u, const float* v) {  // gamma v[0..3], beta v[4..7]
                                 const int c = pass * h2 + u * 8 + col0;
                                 const float2 gi = ld_f2(a.g_b + c), bi = ld_f2(a.bt_b + c);
                                 const float2 mm = ld_f2(a.m + c), rr = ld_f2(a.r + c);
                                 const float2 aa = ld_f2(a.a + c), bb = ld_f2(a.b + c);
#pragma unroll
                                 for (int h = 0; h < 2; ++h) {
                                   const int r = row0 + 8 * h;
                                   const float2 hv = f2(at2(hbuf + r * ldh + c));
                                   const float g0 = bf(bf(v[2 * h] + gi.x) + 1.f);
                                   const float g1 = bf(bf(v[2 * h + 1] + gi.y) + 1.f);
                                   const float s0 = modulate(affine_u(norm_hat(hv.x, mm.x, rr.x), aa.x, bb.x),
                                                             g0, bf(v[4 + 2 * h] + bi.x));
                                   const float s1 = modulate(affine_u(norm_hat(hv.y, mm.y, rr.y), aa.y, bb.y),
                                                             g1, bf(v[5 + 2 * h] + bi.y));
                                   at2(tbuf + r * ldt + c) = to2(lrelu_bf(s0), lrelu_bf(s1));
                                 }
                               });
    }
  } else {
    const bf16* gr = a.gam + (size_t)bimg * cip;
    const bf16* br = a.bet + (size_t)bimg * cip;
    const int h2 = cip / 2;
    for (int e = tid; e < kRows * h2; e += kConsumers) {
      const int r = e / h2, c = 2 * (e % h2);
      const float2 hv = f2(at2(hbuf + r * ldh + c));
      const float2 gm = f2(*reinterpret_cast<const bf2*>(gr + c));
      const float2 bt = f2(*reinterpret_cast<const bf2*>(br + c));
      const float2 mm = ld_f2(a.m + c), rr = ld_f2(a.r + c), aa = ld_f2(a.a + c), bb = ld_f2(a.b + c);
      const float s0 = modulate(affine_u(norm_hat(hv.x, mm.x, rr.x), aa.x, bb.x), gm.x, bt.x);
      const float s1 = modulate(affine_u(norm_hat(hv.y, mm.y, rr.y), aa.y, bb.y), gm.y, bt.y);
      at2(tbuf + r * ldt + c) = to2(lrelu_bf(s0), lrelu_bf(s1));
    }
  }
  // every warpgroup's t is in the tile; no one reads h any more
  consumer_sync();

  // ---- out = bf(t W + c), over the h tile
  product<kMT, 1, 1, true, kEagerRelease>(ring, tbuf, ldt, cip / kChunkRows, a.cop / 8, false,
                           [&](int t, const float* v) {
                             const int c = t * 8 + col0;
                             const float2 cc = ld_f2(a.c + c);
#pragma unroll
                             for (int h = 0; h < 2; ++h)
                               at2(hbuf + (row0 + 8 * h) * ldh + c) =
                                   to2(v[2 * h] + cc.x, v[2 * h + 1] + cc.y);
                           });
  consumer_sync();
  store_tile(a.out + px0 * a.co, hbuf, ldh, a.co, nv);
}

// widths up to 384 (MAP3DBN's) take 16 tiles a warpgroup, wider ones 18
// (kMaxTiles)
bool narrow(int cip, int cop) { return imax(cip, cop) <= 8 * 16 * kColGroups; }

}  // namespace

// The shared memory a K10 CTA takes at these widths, and its ring (stages,
// bytes a stage) in ring[0..1].
extern "C" int thgt_half_block_fwd_smem(int cip, int csp, int cop, int hidp, int spatial, int* ring) {
  ring[0] = kRingStages;
  ring[1] = stage_bytes(cip, cop, hidp, spatial);
  return (int)fwd_smem(cip, csp, cop, hidp, spatial);
}

extern "C" int thgt_half_block_fwd(const bf16* h, const bf16* style, const bf16* fixed, const bf16* gam,
                                   const bf16* bet, const float* m, const float* r, const float* sa,
                                   const float* sb, const float* sh_b, const float* g_b,
                                   const float* bt_b, const float* c, const void* wstream, bf16* out,
                                   int B, int HW, int ci, int cs, int co, int cip, int csp, int cop,
                                   int hidp, int spatial, int add_fixed, long long stream_bytes,
                                   cudaStream_t stream) {
  Args a{h, style, fixed, gam, bet, m, r, sa, sb, sh_b, g_b, bt_b, c,
         static_cast<const unsigned char*>(wstream), out,
         B, HW, ci, cs, co, cip, csp, cop, hidp, spatial, add_fixed, 0};
  // widths: every product's n8 tiles fit a warpgroup's kMaxTiles (the SPADE
  // hidden ones the 6 of their instantiation)
  const int cap = 8 * kMaxTiles * kColGroups;
  if (cip % 16 || cop % 16 || csp % 16 || hidp % 16 || ci > cip || co > cop || cs > csp || B < 1 ||
      HW < 1 || cip < 16 || cop < 16 || cip > cap || cop > cap ||
      (spatial && (cs < 1 || hidp < 16 || hidp > 8 * 6 * kColGroups || csp > cap ||
                   (add_fixed && !fixed))) ||
      (reinterpret_cast<size_t>(wstream) & 15))
    return (int)cudaErrorInvalidValue;
  // the stream must hold exactly what the producer walks
  const long long expect = 2LL * cip * cop + (spatial ? 2LL * (csp * hidp + 2LL * hidp * cip) : 0LL);
  if (expect != stream_bytes) return (int)cudaErrorInvalidValue;
  a.stage_bytes = stage_bytes(cip, cop, hidp, spatial);
  const size_t smem = fwd_smem(cip, csp, cop, hidp, spatial);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = narrow(cip, cop) ? half_block_fwd<16> : half_block_fwd<kMaxTiles>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((HW + kRows - 1) / kRows, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
