// K11: the backward (VJP) of the trainable fused SPADE half-block, on K3's
// core (synthesis_core.cuh).
//
// Replaces threedhumangan_tpu/ops/synthesis_train.py::_bwd_kernel (Pallas,
// TPU).  Per pixel it recomputes K10's chain (csrc/synthesis_train.cu, whose
// header states the math and the rounding points) and runs its VJP:
//
//   dt = g W^T, ds = dt (s >= 0 ? 1 : 0.2f), dgam = ds u, du = ds gam,
//   dnhat = du a, dh = bf(dnhat r); spatial: dactv = (bf(dgam) g_w^T +
//   bf(ds) bt_w^T)(z0 > 0), dsty = bf(bf(dactv) sh_w^T).
//
// A CTA owns 64 pixels of one image.  It writes dh (and dsty), the bf16
// operands of the weight-gradient products (t and g; st and dactv; actv and
// [dgam | ds]), which csrc/wgrad.cu reduces over rows, and per-warp column
// sums (dc, sum dgam, sum ds, da, db and the SPADE hidden bias grad): one
// row of `part` per warp of a warpgroup, each sum over that warp's 16 rows
// in a fixed shuffle order.  The host sums the rows in a fixed order: no
// atomics on global memory, the same grads from run to run.
//
// What bounds it on an H100: at MAP3DBN's shapes (8 x 256 x 128 pixels,
// Ci = Co = Cs = 384, hidden 128) a spatial call does 2 x 3 = 6 products of
// the forward's size, 0.155 TFLOP with the weight-gradient products apart,
// 0.16 ms of bf16 tensor-core time; it reads h, style and g and writes dh,
// dsty and ~1.1 GB of product operands, ~0.4 ms at 3.35 TB/s.  The bytes
// bound it, so the products must not wait on the weights or on barriers.
//
// Design: every weight the body reads reaches it as one host-packed bf16
// stream of 16-row chunk images in wgmma's K-major B layout, in the order
// the products consume them (ops/synthesis_train.py::pack_bwd_stream):
// sh_w, the gamma/beta heads interleaved a column group at a time
// (gamma_beta_pass), W^T, [g_w; bt_w]^T, sh_w^T.  One producer lane copies
// the chunks with cp.async.bulk into K3's mbarrier ring (four stages where
// the shared memory holds them, else three; the 4 KB chunks of the SPADE
// hidden width three to a stage); three consumer warpgroups split each
// 64-row product by columns and issue one wgmma a k step over their whole
// column run, A from registers (ldmatrix from the row-major tiles): ptxas
// waits on every wgmma at this register budget, so fewer, wider ones win.
// Every epilogue runs on the accumulators in registers; its column sums
// reduce-scatter over the warp's rows.  The h and g tiles load with
// cp.async while the work before their first use runs.  The tiles stay in
// shared memory in bf16 and are rewritten in place by the product that
// consumes them: h -> dh and gamma -> dgam in the dt epilogue, which also
// turns its own A tile g into ds once every warpgroup has retired its wgmma
// on it (the product's consumer barrier).  The sign of s stays a bit per element
// (deriving it from t would misclassify an s whose 0.2 s rounds to -0).  At
// Ci = 432 (MAP3DBN512L's 420) the tiles and a three-stage ring take
// 230,448 of the 232,448 bytes a CTA may have.
#include <cuda_runtime.h>

#include "half_block.cuh"

namespace {

using namespace syn;

constexpr int kSlots = 4;  // rows of column sums a CTA writes: one per warp of a warpgroup

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
  const unsigned char* wstream;  // chunk images, pack_bwd_stream
  const bf16* g;         // (B, HW, co) output cotangent
  bf16* dh;              // (B, HW, ci)
  bf16* dsty;            // (B, HW, cs)
  bf16* xt;              // (rows, cip) t
  bf16* yg;              // (rows, cop) g, or null when g itself is that operand
  bf16* xst;             // (rows, csp) st
  bf16* xact;            // (rows, hidp) actv
  bf16* ygb;             // (rows, 2 cip) [dgam | ds]
  bf16* ydact;           // (rows, hidp) dactv
  float* part;           // (B * tiles, kSlots, n_part) per-warp column sums
  int B, HW, ci, cs, co, cip, csp, cop, hidp, spatial, add_fixed, stage_bytes;
};

// column sums: dc (cop), then 4 x cip (sum dgam, sum ds, da = sum du nhat,
// db = sum du), then the SPADE hidden bias grad (spatial).  The JAX kernel's
// sum dnhat and sum dnhat nhat are a db and a da (dnhat = du a): the host
// forms them.
__host__ __device__ inline int n_part(const Args& a) {
  return a.cop + 4 * a.cip + (a.spatial ? a.hidp : 0);
}

// The producer walks the stream as the consumers consume it.
template <typename P>
__device__ void produce(const Args& a, P& p) {
  if (a.spatial) {
    p.put(a.csp / kChunkRows, chunk_bytes(a.hidp), kHidSub);      // SPADE shared layer
    p.put(2 * a.hidp / kChunkRows, chunk_bytes(a.cip));           // gamma/beta heads, two passes
  }
  p.put(a.cop / kChunkRows, chunk_bytes(a.cip));                  // W^T
  if (a.spatial) {
    p.put(2 * a.cip / kChunkRows, chunk_bytes(a.hidp), kHidSub);  // [g_w; bt_w]^T
    p.put(a.hidp / kChunkRows, chunk_bytes(a.csp));               // sh_w^T
  }
}

// Column sums over this warp's 16 rows by reduce-scatter, in a fixed order.
// x[i] is this thread's sum over its two rows of value i; the 8 lanes that
// share lane % 4 (the same columns) halve the values between them at each
// step, so the lane returns the total of value 4 b2 + 2 b3 + b4 (b the
// bits of lane) in 7 shuffles, not 24.
__device__ __forceinline__ float warp_colsum8(const float (&x)[8], int lane) {
  const bool b2 = lane & 4, b3 = lane & 8, b4 = lane & 16;
  float y[4], z[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = (b2 ? x[i + 4] : x[i]) + __shfl_xor_sync(0xffffffffu, b2 ? x[i] : x[i + 4], 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    z[i] = (b3 ? y[i + 2] : y[i]) + __shfl_xor_sync(0xffffffffu, b3 ? y[i] : y[i + 2], 8);
  return (b4 ? z[1] : z[0]) + __shfl_xor_sync(0xffffffffu, b4 ? z[0] : z[1], 16);
}
// the same for two values: the lane returns the total of value b2
__device__ __forceinline__ float warp_colsum2(float x0, float x1, int lane) {
  const bool b2 = lane & 4;
  float y = (b2 ? x1 : x0) + __shfl_xor_sync(0xffffffffu, b2 ? x0 : x1, 4);
  y += __shfl_xor_sync(0xffffffffu, y, 8);
  return y + __shfl_xor_sync(0xffffffffu, y, 16);
}

// kS ring stages; kMT n8 tiles at most a warpgroup owns in a product
template <int kS, int kMT>
__global__ void __launch_bounds__(kThreads, 1) half_block_bwd(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bimg = blockIdx.y, p0 = blockIdx.x * kRows, nv = min(kRows, a.HW - p0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = bimg * gridDim.x + blockIdx.x;
  const size_t px0 = (size_t)bimg * a.HW + p0, grow0 = (size_t)tile * kRows;
  const int cip = a.cip, np = n_part(a), mw = (cip + 31) / 32;
  const int ldh = smem_ld(cip), ldb = smem_ld(cip + imax(imax(cip, a.cop), a.csp));
  const int lda = smem_ld(a.hidp);
  bf16* hbuf = reinterpret_cast<bf16*>(smem);  // h -> dh
  bf16* big = hbuf + kRows * ldh;               // columns [0, cip): gamma -> dgam
  bf16* right = big + cip;                      // [cip, ..): style -> st, then g -> ds
  bf16* act = big + kRows * ldb;                // actv -> dactv
  unsigned* mask = reinterpret_cast<unsigned*>(act + kRows * lda);  // s >= 0, a bit per element
  const size_t tiles_bytes =
      (reinterpret_cast<unsigned char*>(mask + kRows * mw) - smem + 127) & ~size_t(127);
  unsigned char* stages = smem + tiles_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kS * a.stage_bytes);
  uint64_t* empty = full + kS;

  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp >= kConsumerWarps) {  // the producer warpgroup: one lane streams the weights
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      ProducerT<kS> p{stages, full, empty, a.stage_bytes, a.wstream, 0};
      produce(a, p);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  RingT<kS> ring{stages, full, empty, a.stage_bytes, 0};

  // this thread's accumulator rows (+ 8) and column pair within an n8 tile;
  // its warp's row of column sums
  const int row0 = (warp & 3) * 16 + (lane >> 2), col0 = (lane & 3) * 2;
  float* prow = a.part + ((size_t)tile * kSlots + (warp & 3)) * np;
  const bf16* gr = a.gam + (size_t)bimg * cip;
  const bf16* br = a.bet + (size_t)bimg * cip;

  // ---- recompute K10's chain up to t (written to xt), keeping gamma and
  // the sign of s.  Each tile load overlaps the work before its first use:
  // h the SPADE shared layer, g the gamma/beta heads or the rank-1 pass.
  if (a.spatial) load_tile(right, ldb, a.style + px0 * a.cs, a.cs, a.csp, nv);
  load_tile(hbuf, ldh, a.h + px0 * a.ci, a.ci, cip, nv);
  for (int e = tid; e < kRows * mw; e += kConsumers) mask[e] = 0u;
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
        bf16* row = right + r * ldb;
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
    store_tile(a.xst + grow0 * a.csp, right, ldb, a.csp, kRows);
    // SPADE hidden: actv = relu(st sh_w + sh_b)
    product<6, 1, kHidSub, true>(ring, right, ldb, a.csp / kChunkRows, a.hidp / 8, false,
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
    // g into the tile (no warpgroup reads st any more), landing during the heads
    load_tile(right, ldb, a.g + px0 * a.co, a.co, a.cop, nv);
    store_tile(a.xact + grow0 * a.hidp, act, lda, a.hidp, kRows);
    // gamma and beta in two column passes; a unit is the n8 tile of gamma and
    // the same columns of beta: s, t and the sign of s in the epilogue
    const int h2 = cip / 2;
    for (int pass = 0; pass < 2; ++pass) {
      product<kMT, 2, 1, true>(ring, act, lda, a.hidp / kChunkRows, h2 / 8, false,
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
                                at2(big + r * ldb + c) = to2(g0, g1);
                                at2(a.xt + (grow0 + r) * cip + c) = to2(lrelu_bf(s0), lrelu_bf(s1));
                                // the quad's 8 sign bits of row r: one shared atomic
                                unsigned bits = (unsigned(s0 >= 0.f) << (c & 31)) |
                                                (unsigned(s1 >= 0.f) << ((c + 1) & 31));
                                bits |= __shfl_xor_sync(0xffffffffu, bits, 1);
                                bits |= __shfl_xor_sync(0xffffffffu, bits, 2);
                                if ((lane & 3) == 0) atomicOr(&mask[r * mw + (c >> 5)], bits);
                              }
                            });
    }
  } else {
    load_tile(right, ldb, a.g + px0 * a.co, a.co, a.cop, nv);
    const int h2 = cip / 2;
    for (int e = tid; e < kRows * h2; e += kConsumers) {
      const int r = e / h2, c = 2 * (e % h2);
      const float2 hv = f2(at2(hbuf + r * ldh + c));
      const float2 gm = f2(*reinterpret_cast<const bf2*>(gr + c));
      const float2 bt = f2(*reinterpret_cast<const bf2*>(br + c));
      const float2 mm = ld_f2(a.m + c), rr = ld_f2(a.r + c), aa = ld_f2(a.a + c), bb = ld_f2(a.b + c);
      const float s0 = modulate(affine_u(norm_hat(hv.x, mm.x, rr.x), aa.x, bb.x), gm.x, bt.x);
      const float s1 = modulate(affine_u(norm_hat(hv.y, mm.y, rr.y), aa.y, bb.y), gm.y, bt.y);
      at2(a.xt + (grow0 + r) * cip + c) = to2(lrelu_bf(s0), lrelu_bf(s1));
      const unsigned bits =
          (unsigned(s0 >= 0.f) << (c & 31)) | (unsigned(s1 >= 0.f) << ((c + 1) & 31));
      if (bits) atomicOr(&mask[r * mw + (c >> 5)], bits);
    }
  }

  // ---- the output cotangent, loaded above: dc, and the operand of
  // dW = t^T g when g itself is not
  cp_async_wait<0>();
  consumer_sync();
  if (a.yg) store_tile(a.yg + grow0 * a.cop, right, ldb, a.cop, kRows);
  for (int c = tid; c < a.cop; c += kConsumers) {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      float s = 0.f;
      for (int r = 16 * q; r < 16 * q + 16; ++r) s += __bfloat162float(right[r * ldb + c]);
      a.part[((size_t)tile * kSlots + q) * np + c] = s;
    }
  }

  // ---- dt = g W^T; its epilogue runs the element-wise backward in place
  // (after the consumers' barrier: ds overwrites g, the product's A)
  product<kMT, 1, 1, true>(ring, right, ldb, a.cop / kChunkRows, cip / 8, true,
                        [&](int t, const float* v) {
    const int c = t * 8 + col0;
    const float2 mm = ld_f2(a.m + c), rr = ld_f2(a.r + c), aa = ld_f2(a.a + c), bb = ld_f2(a.b + c);
    const float2 gm1 = a.spatial ? make_float2(0.f, 0.f) : f2(*reinterpret_cast<const bf2*>(gr + c));
    float s[8] = {};  // [sum dgam, sum ds, da, db] x [column c, c + 1]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const unsigned w = mask[r * mw + (c >> 5)] >> (c & 31);  // c is even: c + 1 is in the word
      const float2 hv = f2(at2(hbuf + r * ldh + c));
      const float2 gm = a.spatial ? f2(at2(big + r * ldb + c)) : gm1;
      float dh[2], dgam[2], ds[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float hj = j ? hv.y : hv.x, mj = j ? mm.y : mm.x, rj = j ? rr.y : rr.x;
        const float aj = j ? aa.y : aa.x, bj = j ? bb.y : bb.x, gj = j ? gm.y : gm.x;
        ds[j] = v[2 * h + j] * (((w >> j) & 1u) ? 1.f : 0.2f);
        const float nhat = norm_hat(hj, mj, rj);
        const float u = affine_u(nhat, aj, bj);
        dgam[j] = ds[j] * u;
        const float du = ds[j] * gj;
        s[j] += dgam[j];
        s[2 + j] += ds[j];
        s[4 + j] += du * nhat;
        s[6 + j] += du;
        dh[j] = du * aj * rj;
      }
      at2(hbuf + r * ldh + c) = to2(dh[0], dh[1]);
      if (a.spatial) {
        at2(big + r * ldb + c) = to2(dgam[0], dgam[1]);
        at2(right + r * ldb + c) = to2(ds[0], ds[1]);
      }
    }
    const int i = ((lane >> 2) & 1) * 4 + ((lane >> 3) & 1) * 2 + (lane >> 4);  // the value it holds
    prow[a.cop + (i >> 1) * cip + c + (i & 1)] = warp_colsum8(s, lane);
  });
  consumer_sync();
  store_tile(a.dh + px0 * a.ci, hbuf, ldh, a.ci, nv);
  if (!a.spatial) return;

  // ---- SPADE MLP backward: dactv = ([dgam | ds] [g_w; bt_w]^T)(z0 > 0),
  // in place of actv, and its column sums (the hidden bias grad)
  store_tile(a.ygb + grow0 * 2 * cip, big, ldb, 2 * cip, kRows);
  product<6, 1, kHidSub, true>(ring, big, ldb, 2 * cip / kChunkRows, a.hidp / 8, false,
                [&](int t, const float* v) {
                  const int c = t * 8 + col0;
                  float s0 = 0.f, s1 = 0.f;
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    bf16* p = act + (row0 + 8 * h) * lda + c;
                    const float2 x = f2(at2(p));  // actv = bf(relu z0): > 0 iff z0 > 0
                    const float d0 = x.x > 0.f ? v[2 * h] : 0.f, d1 = x.y > 0.f ? v[2 * h + 1] : 0.f;
                    s0 += d0;
                    s1 += d1;
                    at2(p) = to2(d0, d1);
                  }
                  const float cs = warp_colsum2(s0, s1, lane);
                  if (lane < 8) prow[a.cop + 4 * cip + c + (lane >> 2)] = cs;
                });
  consumer_sync();
  store_tile(a.ydact + grow0 * a.hidp, act, lda, a.hidp, kRows);
  // dsty = bf(dactv sh_w^T), into the tile ([dgam | ds] is no longer read)
  product<kMT, 1, 1, true>(ring, act, lda, a.hidp / kChunkRows, a.csp / 8, false,
                        [&](int t, const float* v) {
                          const int c = t * 8 + col0;
#pragma unroll
                          for (int h = 0; h < 2; ++h)
                            at2(big + (row0 + 8 * h) * ldb + c) = to2(v[2 * h], v[2 * h + 1]);
                        });
  consumer_sync();
  store_tile(a.dsty + px0 * a.cs, big, ldb, a.cs, nv);
}

size_t bwd_smem(const Args& a, int stages) {
  const size_t tiles = sizeof(bf16) * kRows *
                           (smem_ld(a.cip) + smem_ld(a.cip + imax(imax(a.cip, a.cop), a.csp)) +
                            smem_ld(a.hidp)) +
                       sizeof(unsigned) * kRows * ((a.cip + 31) / 32);
  return ((tiles + 127) & ~size_t(127)) + (size_t)stages * a.stage_bytes + 2 * stages * sizeof(uint64_t);
}

}  // namespace

extern "C" int thgt_half_block_bwd(const bf16* h, const bf16* style, const bf16* fixed, const bf16* gam,
                                   const bf16* bet, const float* m, const float* r, const float* sa,
                                   const float* sb, const float* sh_b, const float* g_b,
                                   const float* bt_b, const void* wstream, const bf16* g, bf16* dh,
                                   bf16* dsty, bf16* xt, bf16* yg, bf16* xst, bf16* xact, bf16* ygb,
                                   bf16* ydact, float* part, int B, int HW, int ci, int cs, int co,
                                   int cip, int csp, int cop, int hidp, int spatial, int add_fixed,
                                   long long stream_bytes, cudaStream_t stream) {
  Args a{h, style, fixed, gam, bet, m, r, sa, sb, sh_b, g_b, bt_b,
         static_cast<const unsigned char*>(wstream), g, dh, dsty, xt, yg, xst, xact, ygb, ydact, part,
         B, HW, ci, cs, co, cip, csp, cop, hidp, spatial, add_fixed, 0};
  // widths: every product's n8 tiles fit a warpgroup's kMaxTiles (the SPADE
  // hidden ones the 6 of their instantiation), and ds overwrites g in one pass
  if (cip % 16 || cop % 16 || csp % 16 || hidp % 16 || ci > cip || co > cop || cs > csp || B < 1 ||
      HW < 1 || cip < 16 || cop < 16 || cip > 8 * kMaxTiles * kColGroups ||
      (spatial && (cs < 1 || hidp < 16 || hidp > 8 * 6 * kColGroups || csp > 8 * kMaxTiles * kColGroups ||
                   (add_fixed && !fixed))) ||
      (reinterpret_cast<size_t>(wstream) & 15))
    return (int)cudaErrorInvalidValue;
  // the stream must hold exactly what the producer walks
  const long long expect =
      2LL * cop * cip + (spatial ? 2LL * (2LL * csp * hidp + 2LL * 2 * hidp * cip) : 0LL);
  if (expect != stream_bytes) return (int)cudaErrorInvalidValue;
  a.stage_bytes = spatial ? imax(chunk_bytes(imax(cip, csp)), kHidSub * chunk_bytes(hidp))
                          : chunk_bytes(cip);
  // widths up to 384 (MAP3DBN's) take 16 tiles a warpgroup and, where the
  // shared memory holds it, a fourth ring stage; wider ones 18 and three
  const int narrow_cap = 8 * 16 * kColGroups;
  const bool narrow = cip <= narrow_cap && (!spatial || csp <= narrow_cap) &&
                      bwd_smem(a, kStages + 1) <= kMaxSmem;
  auto kernel = narrow ? half_block_bwd<kStages + 1, 16> : half_block_bwd<kStages, kMaxTiles>;
  const size_t smem = bwd_smem(a, narrow ? kStages + 1 : kStages);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((HW + kRows - 1) / kRows, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
