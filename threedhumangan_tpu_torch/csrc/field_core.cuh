// The unfolded FiLM-SIREN on K3's core (synthesis_core.cuh): one kernel
// template, field_kernel<kMode, kExact>, for the field render K4
// (raymarch_unfolded.cu), the geo-fused render K5 (raymarch_geo.cu) and the
// field backward K8/K9 (raymarch_bwd.cu).  Each .cu instantiates the modes
// its C entries launch; the mode and the sine are chosen once a launch,
// never per element, and no wgmma sits in a runtime branch.
//
// The math, threedhumangan_tpu/ops/raymarch.py::_field_slab_parts, with
// bf16 operands, bf16 activations after each layer and float32 sums:
//   x   = [sin(30 (p W_coord + b_coord)) | sin(30 (g W_geo + b_geo))]
//   x   = sin(f_i (x W_i + b_i) + p_i)                  i = 0 .. NB-1
//   sig = x W_sigma + b_sigma (+ the noise column, float32)
//   xc  = sin(f_last (x W_cx + dirs W_cd + b_color) + p_last)
//   rgb = sigmoid(xc W_rgb + b_rgb), feat = xc W_feat + b_feat
// with the field's own weights, shared by the batch, and each image's
// freq (* 15 + 30) and phase applied in the epilogues.
//
//   kStats  (K8): sigma and sum_c g_out[ray, c] * field[c] per sample.
//   kBwd    (K9): the recompute, then the backprop through the heads,
//       colour layer, trunk and first layers.  It writes, per layer, the
//       bf16 operands of the weight-gradient products (layer input X and
//       output gradient dY) and per-warp column sums (bias grads, and the
//       freq/phase grads of its image).
//   kRender (K4): the forward and K2's front-to-back composite (delta 1e9
//       on the last step, the residual transmittance to the last sample
//       and/or a white background, the depth), from float32 packed rows.
//   kGeo    (K5): kRender whose 31 geo columns the kernel computes from the
//       raw points: the 1-NN over the posed vertices, the winner's 19-float
//       row, joint distances, canonical coordinates.
//
// A CTA owns 64 sample rows of one image (kRender, kGeo: 64 / S whole rays);
// grid.x runs over the image's row tiles.  The weights arrive as ONE
// pre-packed bf16 stream for every image (ops/raymarch_bwd.py::
// pack_field_bwd_stream): the forward half in K2's product order (freq and
// omega not folded: FiLM and omega apply in the epilogues) with w_sigma as
// column H of the colour product, then, for K9 alone, the backward half
// (W_head^T, W_color_x^T, the trunk's transposes last block first, W_net0^T
// in column products).  A producer lane copies the chunks with
// cp.async.bulk (an L2 evict_last hint: K9's saved values stream past) into
// a four-stage mbarrier ring; three consumer warpgroups multiply with
// wgmma, A from registers, each a run of columns over all 64 rows, and
// release a stage as soon as their own wgmma retire (k_loop's kEager:
// ptxas serializes the wgmma).  K9's forward takes of the head only its
// first two column groups (the rgb columns), copying 512 bytes of each head
// chunk.  Activations stay in shared memory in bf16: the first layer's 64 x
// n0p output (later K9's head output gradient dyh), and a 64 x hp tile that
// first holds the inputs; the trunk and the backprop ping-pong between
// them.  Every epilogue runs on the accumulators in registers: bias, FiLM
// with the image's f/p (two roundings, no FMA), the sine (a template
// argument), bf16 pairs.  Sigma is column H of the colour product (+
// b_sigma + the noise); the colour layer adds dirs W_cd in float32 after
// the product.
//
// The heads: K8's applies the sigmoid and g_out and sums each row over its
// columns, the quad's lanes and then the warpgroups in a fixed order
// through shared memory.  K4's and K5's are K2's composite (raymarch.cu):
// the compositing weights one thread a ray between the colour and the head
// products, then the head epilogue applies the sigmoid and the row's
// weight and sums each ray's rows by shuffles over a warp's row groups,
// then across the warps holding the ray in fixed order through the colour
// layer's input tile, free by then; two calls are bit-equal.  K9's
// epilogues also write the pre-activations U, V and VC as float32 pairs in
// the accumulators' own order (frag: each warp 256 contiguous bytes), read
// back by the backward epilogues; its bf16 operand tiles leave shared
// memory as bulk copies, one a row (finish_tile), so the copy engine writes
// whole lines while the warps go on.  K9's backward epilogues apply sin'
// (or cos under exact_sin) and reduce the column sums over a warp's 16 rows
// by shuffles in a fixed order, one row of `part` per warp of a warpgroup.
// dsigma enters the last trunk layer's gradient as bf(dsigma) * w_sigma in
// float32.
//
// K5's prologue runs with all 512 threads before the register split: the
// producer lane first fills the ring's stages, then 8 threads a row scan the
// posed vertices staged as float4 in the activation tiles (idle until the
// first layer), each every 8th vertex in ascending order with a strict-less
// compare; the 8 minima merge by shuffles, lower index first on equal
// distances.  The distance is nn_scan.cuh's elementwise form (as K1 and
// K6), so the argmin is bit-identical to the plain version's.  The row's
// first thread then writes its bf16 input row (the coordinates times
// input_scaler and the 31 geo columns, geo_slab's formulas on the float32
// points) into the input tile.  Widths are zero-padded on the host.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "nn_scan.cuh"
#include "siren_math.cuh"
#include "synthesis_core.cuh"

namespace {

using namespace syn;

enum Mode : int { kStats, kBwd, kRender, kGeo };  // K8, K9, K4, K5

// registers a thread: per SM sub-partition one producer warp and three
// consumer warps, 32 x (40 + 3 x 152) <= 16,384
constexpr int kProducerRegs = 40, kConsumerRegs = 152;
constexpr int kRingStages = 4;
constexpr int kUnits = kMaxTiles * kColGroups;  // n8 tiles of one product: N <= 432
constexpr size_t kMaxSmem = 232448;            // the shared memory a CTA may have
constexpr int kSlots = 4;                      // rows of column sums a K9 CTA writes, one a warp
constexpr int kRgbUnits = 2;                   // n8 tiles of the head K9 recomputes (rgb)
constexpr int kFloats = 12 * kRows;            // dirs (3), noise, coef, dsigma, rgb (3), head (3)
constexpr int kGeoCols = 31;                   // K5's geo columns
constexpr int kMaxJoints = 32;
constexpr int kScanLanes = kThreads / kRows;   // K5: threads scanning one row's vertices
static_assert(kScanLanes == 8, "the 1-NN merge shuffles over 8 lanes");

template <bool kExact>
__device__ __forceinline__ float act_sin(float x) {
  if constexpr (kExact) {
    return sinf(x);
  } else {
    return thgt::fast_sin(x);
  }
}
template <bool kExact>
__device__ __forceinline__ float act_sin_grad(float x) {
  if constexpr (kExact) {
    return cosf(x);
  } else {
    return thgt::fast_sin_grad(x);
  }
}
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// x, hidden from the optimizer: each epilogue passes its n8 tile's index
// through this, so the compiler forms the tile's addresses after the K loop
// instead of holding one register per tile of the unrolled epilogue across
// the K loop (and, in a layer loop, across the loop), which spills at 128
// registers
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

struct Args {
  const bf16* packed;            // (B, P, n_cols) K8, K9: samples of this launch's images
  const float* go;               // (B, P / S, width) output cotangent of each ray
  const float* coef;             // (B, P) K9: compositing coefficient of d(field)
  const float* dsig;             // (B, P) K9: d(sigma)
  const unsigned char* wstream;  // pack_field_bwd_stream (K4, K5, K8: its forward half)
  const float* b_first;          // (n0p)
  const float* b_net;            // (NB, hp)
  const float* freq;             // (B, NB, nc) freq * 15 + 30
  const float* phase;            // (B, NB, nc)
  const float* w_color_d;        // (3, nc) bf16 values
  const float* w_sigma;          // (hp) bf16 values
  const float* b_color;          // (nc)
  const float* b_sigma;          // (1)
  const float* b_head;           // (headp)
  float* sigma;                  // (B, P) K8
  float* gdot;                   // (B, P) K8
  // K9, rows = B * P of this launch: the weight-gradient operands
  bf16* x0;    // (rows, k0p)   packed inputs (first-layer X)
  bf16* xs0;   // (rows, n0p)   trunk-0 X
  bf16* xsk;   // (NB-1, rows, hp) trunk-i X
  bf16* xcol;  // (rows, hp+16) [x_last | dirs | 0] colour/sigma X
  bf16* xc;    // (rows, hp)    head X
  bf16* du;    // (rows, n0p)   first-layer dY
  bf16* dv;    // (NB, rows, hp) trunk dY
  bf16* dcol;  // (rows, hp+16) [dvc | dsigma | 0]
  bf16* dyh;   // (rows, headp) [d rgb pre-act | d features]
  float* U;    // (rows, n0p)   first-layer pre-activations, each tile in frag order
  float* V;    // (NB, rows, hp) trunk x W + b, frag order
  float* VC;   // (rows, hp)    colour x W + b, frag order
  float* part; // (rows / 64, kSlots, n_ws) per-warp column sums
  float* hsum; // (rows / 64, headp + 1) per-CTA sums: the head's bias grads, b_sigma's
  int B, P, S, n_cols, n_in, H, k0p, n0p, hp, nc, headp, n_blocks, width, n_first, stage_bytes;
  // K4, K5: the render
  const float* raw;    // (B, P, n_cols) K4: packed rows [coords | geo | dirs | noise]; K5: [x y z | dirs | noise]
  const float* z;      // (B, P / S) depth samples of each ray
  float* out;          // (B, P / S, width)
  float* depth;        // (B, P / S)
  const float* verts;  // (B, V, 3) K5: posed vertices
  const float* vfeat;  // (B, V, 19) K5: [blended inverse-FK 16 | T-pose 3]
  const float* skel;   // (B, J, 3) K5: joints
  int* idx_out;        // (B, P) K5: nearest vertex, or null
  int white_back, last_back, n_verts, n_joints, legacy;
  float scaler;        // K5: input_scaler
};

__host__ __device__ constexpr int chunk_bytes(int n) { return kChunkRows * n * (int)sizeof(bf16); }
__host__ __device__ constexpr int imax(int x, int y) { return x > y ? x : y; }
// n8 tiles of column product j of the first layer (n0p / 8 split evenly)
__host__ __device__ constexpr int first_units(int tiles, int n, int j) {
  return tiles / n + (j < tiles % n);
}
// columns of K9's per-warp sums: du, then 3 x hp for each trunk layer and
// the colour layer (sum dv, sum dpre v, sum dpre)
__host__ __device__ inline int n_ws(const Args& a) { return a.n0p + 3 * a.hp * (a.n_blocks + 1); }

// The producer's copies: n chunks of which it copies the first `bytes`
// each (all of a chunk, or its first column groups), the source advancing
// `stride` a chunk; marked to stay in L2 (evict_last), where K9's gigabytes
// of saved values and operands pass through on their way to device memory.
// With kRange only the chunks numbered [first, last) of the walk are copied
// (K5 copies the ring's first stages before its prologue, the rest after).
template <bool kRange>
__device__ void put(ProducerT<kRingStages>& p, int n, uint32_t bytes, uint32_t stride, uint64_t keep,
                    uint32_t first, uint32_t last) {
  for (int c = 0; c < n; ++c, ++p.it, p.src += stride) {
    if constexpr (kRange) {
      if (p.it >= last) return;  // the walker is dropped after its range
      if (p.it < first) continue;
    }
    const int st = p.it % kRingStages;
    mbar_wait(&p.empty[st], ((p.it / kRingStages) & 1) ^ 1);
    mbar_expect_tx(&p.full[st], bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, "
        "[%3], %4;\n" ::"r"(smem_u32(p.stages + st * p.stage_bytes)),
        "l"(p.src), "r"(bytes), "r"(smem_u32(&p.full[st])), "l"(keep)
        : "memory");
  }
}

// The producer walks the stream as the consumers consume it: the first
// layer's column products (k0p/16 chunks each), w_net0 (n0p/16), the NB-1
// trunk layers (hp/16 each), the colour layer with the sigma column (hp/16
// of nc columns), the head (hp/16 of headp; K9: its rgb columns); K9 then
// W_head^T (headp/16 of hp), W_color_x^T and the NB-1 trunk transposes
// (hp/16 of hp each) and W_net0^T's column products (hp/16 each).  K5
// copies the chunks [first, last) of the walk.
template <int kMode>
__device__ void produce(const Args& a, ProducerT<kRingStages>& p, uint32_t first = 0, uint32_t last = 0) {
  uint64_t keep;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(keep));
  const int kh = a.hp / kChunkRows;
  auto all = [&](int n, int cols) {
    put<kMode == kGeo>(p, n, chunk_bytes(cols), chunk_bytes(cols), keep, first, last);
  };
  for (int j = 0; j < a.n_first; ++j) all(a.k0p / kChunkRows, 8 * first_units(a.n0p / 8, a.n_first, j));
  all(a.n0p / kChunkRows, a.hp);
  for (int i = 1; i < a.n_blocks; ++i) all(kh, a.hp);
  all(kh, a.nc);
  if constexpr (kMode != kBwd) {
    all(kh, a.headp);
  } else {
    put<false>(p, kh, kRgbUnits * 256, chunk_bytes(a.headp), keep, first, last);
    all(a.headp / kChunkRows, a.hp);
    for (int i = 0; i < a.n_blocks; ++i) all(kh, a.hp);
    for (int j = 0; j < a.n_first; ++j) all(kh, 8 * first_units(a.n0p / 8, a.n_first, j));
  }
}

// Column sums over this warp's 16 rows by reduce-scatter, in a fixed order
// (K11's): x[i] is this thread's sum over its two rows of value i; the 8
// lanes that share lane % 4 (the same columns) halve the values between
// them at each step, so the lane returns the total of value 4 b2 + 2 b3 +
// b4 (b the bits of lane).
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

// K9's bf16 operand tiles leave shared memory by bulk copies, one a row,
// issued by the lanes of warp 0 (two rows a lane, one bulk group a lane):
// the copy engine writes whole lines while the warps go on.  finish_tile
// ends an epilogue that wrote the tile: every writer fences its shared
// stores for the copy engine, warp 0 waits until its earlier copies have
// read their tiles (the next epilogue may overwrite one of them), the
// consumers meet, and warp 0 issues the tile's rows (n columns, a multiple
// of 8) to g (row stride ldg).
__device__ __forceinline__ void finish_tile(bf16* g, int ldg, const bf16* s, int lds, int n) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const bool w0 = threadIdx.x < 32;
  if (w0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  consumer_sync();
  if (w0) {
    for (int r = threadIdx.x; r < kRows; r += 32)
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(g + (size_t)r * ldg),
                   "r"(smem_u32(s + r * lds)), "r"(n * (int)sizeof(bf16))
                   : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// K9's float32 pre-activations U, V and VC are private to the kernel, so
// they are kept in the accumulators' own order: in a layer's 64 x N block
// of a tile, the pair a thread holds for n8 tile t and row half h lies at
// float frag(t, h) = (2 t + h) 256 + 2 (32 (warp % 4) + lane), whichever
// warpgroup holds it, so every warp writes and reads 256 contiguous bytes.
// The pairs are written once and read once: kept out of L2's way.
__device__ __forceinline__ void st_stream(float* p, float x, float y) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(x, y));
}
__device__ __forceinline__ float2 ld_stream(const float* p) {
  return __ldcs(reinterpret_cast<const float2*>(p));
}

// K5's prologue, every thread of the CTA (see the note at the top): the
// 1-NN of the tile's 64 raw points over the image's posed vertices, staged
// `chunk` at a time in sv; then each row's bf16 input (row stride ldi), its
// bf16-rounded directions and its float32 noise.  The joints (xyz, |s|^2)
// sit in `joints` (4 kMaxJoints floats).
__device__ __forceinline__ void geo_prologue(const Args& a, size_t g0, float4* sv, int chunk, bf16* rows,
                                             int ldi, float* dirs, float* noise, float* joints) {
  const int tid = threadIdx.x, r = tid / kScanLanes, sub = tid % kScanLanes;
  const int b = blockIdx.y;
  const float* pr = a.raw + (g0 + r) * a.n_cols;
  const float px = pr[0], py = pr[1], pz = pr[2];
  float* ssq = joints + 3 * kMaxJoints;
  for (int j = tid; j < a.n_joints; j += kThreads) {
    const float* q = a.skel + ((size_t)b * a.n_joints + j) * 3;
    joints[3 * j] = q[0];
    joints[3 * j + 1] = q[1];
    joints[3 * j + 2] = q[2];
    ssq[j] = (q[0] * q[0] + q[1] * q[1]) + q[2] * q[2];
  }
  const float* vb = a.verts + (size_t)b * a.n_verts * 3;
  float bd = __int_as_float(0x7f800000);  // +inf
  int bi = 0;
  for (int v0 = 0; v0 < a.n_verts; v0 += chunk) {
    const int n = min(chunk, a.n_verts - v0);
    thgt::nn_stage(vb, v0, n, sv);
    for (int i = sub; i < n; i += kScanLanes) {
      const float d = thgt::nn_dist(px, py, pz, sv[i]);
      if (d < bd) {
        bd = d;
        bi = v0 + i;
      }
    }
  }
#pragma unroll
  for (int o = kScanLanes / 2; o; o >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, bd, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (thgt::nn_better(od, oi, bd, bi)) {
      bd = od;
      bi = oi;
    }
  }
  __syncthreads();  // every thread is done with the vertices: the rows overwrite them
  if (sub == 0) {
    // [coords * scaler | 31 geo columns | 0] as bf16, directions, noise
    const float* gf = a.vfeat + ((size_t)b * a.n_verts + bi) * 19;
    bf16* row = rows + r * ldi;
    row[0] = __float2bfloat16(px * a.scaler);
    row[1] = __float2bfloat16(py * a.scaler);
    row[2] = __float2bfloat16(pz * a.scaler);
    const int jd0 = 3 + (a.legacy ? 0 : 3);              // joint distances
    const int cano0 = 3 + (a.legacy ? a.n_joints : 0);  // canonical coords
    const float psq = (px * px + py * py) + pz * pz;
    for (int j = 0; j < a.n_joints; ++j) {
      const float cross = px * joints[3 * j] + py * joints[3 * j + 1] + pz * joints[3 * j + 2];
      const float jd = sqrtf(fmaxf(psq - 2.f * cross + ssq[j], 0.f) + 1e-12f) / 2.4f;
      row[jd0 + j] = __float2bfloat16(jd);
    }
    const float c0 = gf[0] * px + gf[1] * py + gf[2] * pz + gf[3];
    const float c1 = gf[4] * px + gf[5] * py + gf[6] * pz + gf[7];
    const float c2 = gf[8] * px + gf[9] * py + gf[10] * pz + gf[11];
    row[cano0] = __float2bfloat16(c0 / 2.0f);
    row[cano0 + 1] = __float2bfloat16((c1 + 0.2f) / 2.0f);
    row[cano0 + 2] = __float2bfloat16(c2 / 1.3f);
    const int t0 = 3 + 3 + a.n_joints;  // T-pose coords, then the nearest distance
    row[t0] = __float2bfloat16(gf[16]);
    row[t0 + 1] = __float2bfloat16(gf[17]);
    row[t0 + 2] = __float2bfloat16(gf[18] / 0.2f);
    row[t0 + 3] = __float2bfloat16(sqrtf(bd) / 1.3f);
    for (int c = 3 + kGeoCols; c < a.k0p; ++c) row[c] = __float2bfloat16(0.f);
    for (int k = 0; k < 3; ++k) dirs[3 * r + k] = bf(pr[3 + k]);
    noise[r] = a.n_cols > 6 ? pr[6] : 0.f;
    if (a.idx_out) a.idx_out[g0 + r] = bi;
  }
  __syncthreads();
}

template <int kMode, bool kExact>
__global__ void __launch_bounds__(kThreads, 1) field_kernel(Args a) {
  constexpr bool kBack = kMode == kBwd, kComposite = kMode == kRender || kMode == kGeo;
  extern __shared__ __align__(128) unsigned char smem[];
  const int hp = a.hp, nc = a.nc, NB = a.n_blocks;
  const int b = blockIdx.y, prow = blockIdx.x * kRows;  // the tile's first row in its image
  const int tile = b * gridDim.x + blockIdx.x;
  const size_t g0 = (size_t)tile * kRows;              // its first row in this launch
  const size_t rows = (size_t)a.B * a.P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldi = smem_ld(a.k0p), ld0 = smem_ld(a.n0p), ldh = smem_ld(hp), ldy = smem_ld(a.headp);

  unsigned char* stages = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kRingStages * a.stage_bytes);
  uint64_t* empty = full + kRingStages;
  bf16* x0 = reinterpret_cast<bf16*>(empty + kRingStages);  // first layer out; a trunk tile; dyh
  bf16* t1 = x0 + kRows * imax(ld0, ldy);                     // the input tile; a trunk tile
  float* dirs = reinterpret_cast<float*>(t1 + kRows * imax(ldh, ldi));
  float* noise = dirs + 3 * kRows;
  float* coef = noise + kRows;
  float* dsig = coef + kRows;
  float* rgb = dsig + kRows;     // 3 kRows
  float* hpart = rgb + 3 * kRows;  // kColGroups x kRows: K8's head sums of each warpgroup
  // K4, K5: sigma and the compositing weights of each row, the residual of each ray
  float* sig = coef;
  float* wrow = dsig;
  float* resid = rgb;

  if (tid == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if constexpr (kMode == kGeo) {
    if (warp == kConsumerWarps && lane == 0) {  // the ring's first stages
      ProducerT<kRingStages> p{stages, full, empty, a.stage_bytes, a.wstream, 0};
      produce<kMode>(a, p, 0, kRingStages);
    }
    const int chunk = (int)((reinterpret_cast<unsigned char*>(dirs) - reinterpret_cast<unsigned char*>(x0)) /
                            sizeof(float4));
    geo_prologue(a, g0, reinterpret_cast<float4*>(x0), chunk, t1, ldi, dirs, noise, hpart);
  }
  if (warp >= kConsumerWarps) {  // the producer warpgroup: one lane streams the weights
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      ProducerT<kRingStages> p{stages, full, empty, a.stage_bytes, a.wstream, 0};
      if constexpr (kMode == kGeo) {
        produce<kMode>(a, p, kRingStages, ~0u);
      } else {
        produce<kMode>(a, p);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  RingT<kRingStages> ring{stages, full, empty, a.stage_bytes, 0};

  // the tile's samples (bf16, zero columns n_in..k0p), directions and noise;
  // K9: the compositing coefficients and dsigma.  K4 rounds its float32
  // rows here and keeps the noise in float32; K5's prologue staged them.
  const int cp = hp + 16;  // columns of K9's colour operands
  if constexpr (kMode == kRender) {
    const float* pk = a.raw + g0 * a.n_cols;
    for (int e = tid; e < kRows * a.k0p; e += kConsumers) {
      const int r = e / a.k0p, c = e % a.k0p;
      t1[r * ldi + c] = __float2bfloat16(c < a.n_in ? pk[(size_t)r * a.n_cols + c] : 0.f);
    }
    for (int e = tid; e < kRows * 3; e += kConsumers)
      dirs[e] = bf(pk[(size_t)(e / 3) * a.n_cols + a.n_in + e % 3]);
    if (tid < kRows) noise[tid] = a.n_cols > a.n_in + 3 ? pk[(size_t)tid * a.n_cols + a.n_in + 3] : 0.f;
    consumer_sync();
  } else if constexpr (kMode != kGeo) {
    const bf16* pk = a.packed + g0 * a.n_cols;
    for (int e = tid; e < kRows * a.k0p; e += kConsumers) {
      const int r = e / a.k0p, c = e % a.k0p;
      t1[r * ldi + c] = c < a.n_in ? pk[(size_t)r * a.n_cols + c] : __float2bfloat16(0.f);
    }
    for (int e = tid; e < kRows * 3; e += kConsumers)
      dirs[e] = __bfloat162float(pk[(size_t)(e / 3) * a.n_cols + a.n_in + e % 3]);
    if (tid < kRows) {
      const bool with_noise = a.n_cols > a.n_in + 3;
      noise[tid] = with_noise ? __bfloat162float(pk[(size_t)tid * a.n_cols + a.n_in + 3]) : 0.f;
      if (kBack) {
        coef[tid] = a.coef[g0 + tid];
        dsig[tid] = a.dsig[g0 + tid];
      }
    }
    if constexpr (!kBack) {
      consumer_sync();
    } else {
      finish_tile(a.x0 + g0 * a.k0p, a.k0p, t1, ldi, a.k0p);
      // the 16 columns past hp of the colour operands: [dirs | 0] and [dsigma | 0]
      for (int e = tid; e < kRows * 16; e += kConsumers) {
        const int r = e >> 4, c = e & 15;
        a.xcol[(g0 + r) * cp + hp + c] = __float2bfloat16(c < 3 ? dirs[r * 3 + c] : 0.f);
        a.dcol[(g0 + r) * cp + hp + c] = __float2bfloat16(c == 0 ? dsig[r] : 0.f);
      }
      if (warp == 0) {  // b_sigma grad: the tile's sum of dsigma
        float s = dsig[lane] + dsig[lane + 32];
#pragma unroll
        for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) a.hsum[(size_t)tile * (a.headp + 1) + a.headp] = s;
      }
    }
  }

  // this thread's accumulator rows (+ 8) and column pair within an n8 tile
  const int row0 = (warp & 3) * 16 + (lane >> 2), col0 = (lane & 3) * 2;
  const int frag0 = 2 * (32 * (warp & 3) + lane);  // frag(t, h) - (2 t + h) 256

  // ---- forward
  // first layers (block-diagonal coords | geo), sin(30 (x W + b)), in column
  // products of <= 432 columns
  for (int j = 0, u0 = 0; j < a.n_first; ++j) {
    const int n = first_units(a.n0p / 8, a.n_first, j);
    float* U = a.U + g0 * a.n0p;
    product<kMaxTiles, 1, 1, true, true>(ring, t1, ldi, a.k0p / kChunkRows, n, false,
                                         [&](int t_, const float* v) {
      const int t = opaque(t_);
      const int c = (u0 + t) * 8 + col0;
      const float2 bi = ld_f2(a.b_first + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        const float u = v[2 * h] + bi.x, w = v[2 * h + 1] + bi.y;
        const bf2 x = __floats2bfloat162_rn(act_sin<kExact>(30.f * u), act_sin<kExact>(30.f * w));
        at2(x0 + r * ld0 + c) = x;
        if constexpr (kBack) st_stream(U + (2 * (u0 + t) + h) * 256 + frag0, u, w);
      }
    });
    u0 += n;
  }
  if constexpr (kBack) {
    finish_tile(a.xs0 + g0 * a.n0p, a.n0p, x0, ld0, a.n0p);
  } else {
    consumer_sync();
  }
  // trunk: layer 0 (n0p -> hp) from x0 into t1, then NB-1 (hp -> hp) layers
  // ping-ponging; a layer's output is also the next product's operand X
  bf16* cur = x0;
  bf16* dst = t1;
  int ldc = ld0;
  for (int i = 0; i < NB; ++i) {
    const int fo = (b * NB + i) * nc;  // the FiLM slice's offset in freq and phase
    float* Vi = a.V + ((size_t)i * rows + g0) * hp;
    const bool last = i + 1 == NB;
    bf16* xo = last ? a.xcol + g0 * cp : a.xsk + ((size_t)i * rows + g0) * hp;
    const int ldx = last ? cp : hp;
    product<kMaxTiles, 1, 1, true, true>(ring, cur, ldc, (i ? hp : a.n0p) / kChunkRows, hp / 8, false,
                                         [&](int t_, const float* v) {
      const int t = opaque(t_);
      const int c = t * 8 + col0;
      const float2 bb = ld_f2(a.b_net + i * hp + c), ff = ld_f2(a.freq + fo + c), pp = ld_f2(a.phase + fo + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        const float p = v[2 * h] + bb.x, q = v[2 * h + 1] + bb.y;
        const bf2 x = __floats2bfloat162_rn(act_sin<kExact>(thgt::film(ff.x, p, pp.x)),
                                            act_sin<kExact>(thgt::film(ff.y, q, pp.y)));
        at2(dst + r * ldh + c) = x;
        if constexpr (kBack) st_stream(Vi + (2 * t + h) * 256 + frag0, p, q);
      }
    });
    if constexpr (kBack) {
      finish_tile(xo, ldx, dst, ldh, hp);
    } else {
      consumer_sync();
    }
    bf16* tmp = cur;
    cur = dst;
    dst = tmp;
    ldc = ldh;
  }

  // colour FiLM layer: x_last W_x + dirs W_d + b with the last trunk slice's
  // f/p; column H of the same product is sigma (w_sigma in the stream), +
  // b_sigma + the noise
  const float* fl = a.freq + (size_t)(b * NB + NB - 1) * nc;
  const float* pl = a.phase + (size_t)(b * NB + NB - 1) * nc;
  {
    const float bsig = a.b_sigma[0];
    product<kMaxTiles, 1, 1, true, true>(ring, cur, ldh, hp / kChunkRows, nc / 8, false,
                                         [&](int t_, const float* v) {
      const int t = opaque(t_);
      const int c = t * 8 + col0;
      const float2 w0 = ld_f2(a.w_color_d + c), w1 = ld_f2(a.w_color_d + nc + c),
                   w2 = ld_f2(a.w_color_d + 2 * nc + c);
      const float2 bc = ld_f2(a.b_color + c), ff = ld_f2(fl + c), pp = ld_f2(pl + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        const float* d = dirs + r * 3;
        const float p = v[2 * h] + (d[0] * w0.x + d[1] * w1.x + d[2] * w2.x) + bc.x;
        const float q = v[2 * h + 1] + (d[0] * w0.y + d[1] * w1.y + d[2] * w2.y) + bc.y;
        float x = act_sin<kExact>(thgt::film(ff.x, p, pp.x));
        float y = act_sin<kExact>(thgt::film(ff.y, q, pp.y));
        if (c == a.H) {
          if constexpr (kMode == kStats) a.sigma[g0 + r] = v[2 * h] + bsig + noise[r];
          if constexpr (kComposite) sig[r] = v[2 * h] + bsig + noise[r];
          x = 0.f;
        } else if (c + 1 == a.H) {
          if constexpr (kMode == kStats) a.sigma[g0 + r] = v[2 * h + 1] + bsig + noise[r];
          if constexpr (kComposite) sig[r] = v[2 * h + 1] + bsig + noise[r];
          y = 0.f;
        }
        if (c < hp) {
          const bf2 xy = __floats2bfloat162_rn(x, y);
          at2(dst + r * ldh + c) = xy;
          if constexpr (kBack) st_stream(a.VC + g0 * hp + (2 * t + h) * 256 + frag0, p, q);
        }
      }
    });
    if constexpr (kBack) {
      finish_tile(a.xc + g0 * hp, hp, dst, ldh, hp);
    } else {
      consumer_sync();
    }
  }
  const bf16* xc = dst;
  const int rays = a.P / a.S;
  const float* go = a.go + (size_t)b * rays * a.width;

  if constexpr (kMode == kStats) {
    // heads: field[c] = sigmoid (c < 3) or identity; each row's sum of
    // g_out * field over the thread's columns, the quad's lanes, then the
    // warpgroups in a fixed order
    const float* g_lo = go + (size_t)((prow + row0) / a.S) * a.width;
    const float* g_hi = go + (size_t)((prow + row0 + 8) / a.S) * a.width;
    float s_lo = 0.f, s_hi = 0.f;
    product<kMaxTiles, 1, 1, true, true>(ring, xc, ldh, hp / kChunkRows, a.headp / 8, false,
                                         [&](int t_, const float* v) {
      const int t = opaque(t_);
      const int c = t * 8 + col0;
      const float2 bh = ld_f2(a.b_head + c);
      float f[4] = {v[0] + bh.x, v[1] + bh.y, v[2] + bh.x, v[3] + bh.y};
      if (c < 3) {
        f[0] = sigmoid(f[0]);
        f[2] = sigmoid(f[2]);
      }
      if (c + 1 < 3) {
        f[1] = sigmoid(f[1]);
        f[3] = sigmoid(f[3]);
      }
      if (c < a.width) {
        s_lo += g_lo[c] * f[0];
        s_hi += g_hi[c] * f[2];
      }
      if (c + 1 < a.width) {
        s_lo += g_lo[c + 1] * f[1];
        s_hi += g_hi[c + 1] * f[3];
      }
    });
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s_lo += __shfl_xor_sync(0xffffffffu, s_lo, o);
      s_hi += __shfl_xor_sync(0xffffffffu, s_hi, o);
    }
    if ((lane & 3) == 0) {
      hpart[(warp >> 2) * kRows + row0] = s_lo;
      hpart[(warp >> 2) * kRows + row0 + 8] = s_hi;
    }
    consumer_sync();
    if (tid < kRows) a.gdot[g0 + tid] = hpart[tid] + hpart[kRows + tid] + hpart[2 * kRows + tid];
    return;
  } else if constexpr (kComposite) {
    // front-to-back compositing weights, one thread per ray (K2's)
    const int S = a.S, rpc = kRows / S, ray0 = prow / S;
    if (tid < rpc) {
      const float* zr = a.z + ((size_t)b * rays + ray0 + tid) * S;
      float T = 1.f, w_sum = 0.f, dep = 0.f;
      for (int s = 0; s < S; ++s) {
        const float zs = zr[s];
        const float delta = s + 1 < S ? zr[s + 1] - zs : 1e9f;
        const float alpha = 1.f - expf(-delta * fmaxf(sig[tid * S + s], 0.f));
        const float w = alpha * T;
        wrow[tid * S + s] = w;
        dep += w * zs;
        w_sum += w;
        T *= (1.f - alpha) + 1e-12f;
      }
      const float res = 1.f - w_sum;
      if (a.last_back) wrow[tid * S + S - 1] += res;
      a.depth[(size_t)b * rays + ray0 + tid] = dep + res * zr[S - 1];
      resid[tid] = a.white_back ? res : 0.f;
    }
    consumer_sync();
    // heads + composite: sigmoid RGB, times the row's weight, summed over a
    // warp's rows of one ray by shuffles (lane bits 2-4 and the +8 row when a
    // ray spans the warp's 16 rows); one slot of partial sums per (warp, ray)
    // in the colour layer's input tile, which is free now
    float* part = reinterpret_cast<float*>(cur);
    const int rrows = S < 8 ? S : 8;  // rows of one ray among a warp's row groups
    const int slot_rows = S < 16 ? S : 16;
    const int hd = a.headp;
    product<kMaxTiles, 1, 1, true, true>(ring, xc, ldh, hp / kChunkRows, hd / 8, false,
                                         [&](int t_, const float* v) {
      const int t = opaque(t_);
      const int c = t * 8 + col0;
      const float2 bh = ld_f2(a.b_head + c);
      float y[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float w = wrow[row0 + 8 * h];
        float p = v[2 * h] + bh.x, q = v[2 * h + 1] + bh.y;
        if (c < 3) p = sigmoid(p);
        if (c + 1 < 3) q = sigmoid(q);
        y[h][0] = w * p;
        y[h][1] = w * q;
      }
      if (S >= 16) {
        // a warp's 16 rows are one ray: the two columns' sums split over the
        // lane pairs of the first level, so each level is one shuffle
        const bool hi = lane & 4;
        const float s0 = y[0][0] + y[1][0], s1 = y[0][1] + y[1][1];
        float s = (hi ? s1 : s0) + __shfl_xor_sync(0xffffffffu, hi ? s0 : s1, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 8) part[(row0 / 16) * hd + c + hi] = s;
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float s = y[h][j];
            for (int o = 4; o < 4 * rrows; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            y[h][j] = s;
          }
          if (((lane >> 2) & (rrows - 1)) == 0) {
            float* slot = part + ((row0 + 8 * h) / slot_rows) * hd + c;
            slot[0] = y[h][0];
            slot[1] = y[h][1];
          }
        }
      }
    });
    consumer_sync();
    const int per = S > 16 ? S / 16 : 1;  // slots of one ray
    float* out = a.out + ((size_t)b * rays + ray0) * a.width;
    for (int e = tid; e < rpc * a.width; e += kConsumers) {
      const int ray = e / a.width, c = e % a.width;
      float s = 0.f;
      for (int k = 0; k < per; ++k) s += part[(ray * per + k) * hd + c];
      out[e] = s + resid[ray];
    }
    return;
  } else {
    // ---- K9: the backprop
    float* prow_sums = a.part + ((size_t)tile * kSlots + (warp & 3)) * n_ws(a);
    const int vi = ((lane >> 2) & 1) * 4 + ((lane >> 3) & 1) * 2 + (lane >> 4);  // warp_colsum8's value
    // rgb = sigmoid of the head's first columns
    product<kMaxTiles, 1, 1, true, true>(ring, xc, ldh, hp / kChunkRows, kRgbUnits, false,
                                         [&](int t_, const float* v) {
      const int t = opaque(t_);
      const int c = t * 8 + col0;
      const float2 bh = ld_f2(a.b_head + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        if (c < 3) rgb[r * 3 + c] = sigmoid(v[2 * h] + bh.x);
        if (c + 1 < 3) rgb[r * 3 + c + 1] = sigmoid(v[2 * h + 1] + bh.y);
      }
    });
    if (warp == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // x0's copies
    consumer_sync();
    // the head's output gradient [d rgb pre-activation | d features] into x0
    // (the A of dyh W_head^T), and its f32 column sums (the head's bias grads)
    bf16* dyh = x0;
    for (int c = tid; c < a.headp; c += kConsumers) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) {
        float g = 0.f;
        if (c < a.width) {
          g = __fmul_rn(coef[r], go[(size_t)((prow + r) / a.S) * a.width + c]);
          if (c < 3) g = __fmul_rn(__fmul_rn(g, rgb[r * 3 + c]), 1.f - rgb[r * 3 + c]);
        }
        dyh[r * ldy + c] = __float2bfloat16(g);
        s += g;
      }
      a.hsum[(size_t)tile * (a.headp + 1) + c] = s;
    }
    finish_tile(a.dyh + g0 * a.headp, a.headp, dyh, ldy, a.headp);

    // colour layer: dxc = dyh W_head^T -> dprec -> dvc, into t1 (x_last or
    // xc, both dead); then the trunk, last block first, each epilogue
    //   dpre = dx sin'(f v + p), dv = dpre f; sums dv, dpre v, dpre
    // whose first product also takes bf(dsigma) w_sigma
    bf16* src = dyh;
    int lds = ldy;
    dst = t1;
    for (int i = NB; i >= 0; --i) {
      const bool color = i == NB, top = i == NB - 1;
      const int li = color ? NB - 1 : i;  // the FiLM slice
      const int fo = (b * NB + li) * nc;  // the FiLM slice's offset in freq and phase
      const float* Vi = color ? a.VC + g0 * hp : a.V + ((size_t)i * rows + g0) * hp;
      bf16* yo = color ? a.dcol + g0 * cp : a.dv + ((size_t)i * rows + g0) * hp;
      const int ldo = color ? cp : hp;
      float* sums = prow_sums + (color ? a.n0p + 3 * hp * NB : a.n0p + 3 * hp * i);
      product<kMaxTiles, 1, 1, true, true>(ring, src, lds, (color ? a.headp : hp) / kChunkRows, hp / 8,
                                           false, [&](int t_, const float* v) {
        const int t = opaque(t_);
        const int c = t * 8 + col0;
        const float2 ff = ld_f2(a.freq + fo + c), pp = ld_f2(a.phase + fo + c);
        const float2 ws = top ? ld_f2(a.w_sigma + c) : make_float2(0.f, 0.f);
        float s[8] = {};  // [sum dv, sum dpre v, sum dpre, 0] x [column c, c + 1]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h;
          const float2 vv = ld_stream(Vi + (2 * t + h) * 256 + frag0);
          float dx = v[2 * h], dy = v[2 * h + 1];
          if (top) {
            const float ds = bf(dsig[r]);
            dx += ds * ws.x;
            dy += ds * ws.y;
          }
          const float px = dx * act_sin_grad<kExact>(thgt::film(ff.x, vv.x, pp.x));
          const float py = dy * act_sin_grad<kExact>(thgt::film(ff.y, vv.y, pp.y));
          const float ex = __fmul_rn(px, ff.x), ey = __fmul_rn(py, ff.y);
          s[0] += ex;
          s[1] += ey;
          s[2] += __fmul_rn(px, vv.x);
          s[3] += __fmul_rn(py, vv.y);
          s[4] += px;
          s[5] += py;
          const bf2 o = __floats2bfloat162_rn(ex, ey);
          at2(dst + r * ldh + c) = o;
        }
        const float cs = warp_colsum8(s, lane);
        if (vi < 6) sums[(vi >> 1) * hp + c + (vi & 1)] = cs;
      });
      finish_tile(yo, ldo, dst, ldh, hp);
      bf16* tmp = src;
      src = dst;
      dst = tmp;
      lds = ldh;
    }
    // first layers: dx = dv_0 W_net0^T -> du = dx sin'(30 u) 30, in column
    // products.  With an even NB, dv_0 lies in t1 and du goes through the
    // free 64 x n0p tile (its copies there have been read: the last
    // finish_tile waited); with an odd NB, straight from the registers.
    const bool stage = src == t1;
    const float* U = a.U + g0 * a.n0p;
    bf16* du = a.du + g0 * a.n0p;
    for (int j = 0, u0 = 0; j < a.n_first; ++j) {
      const int n = first_units(a.n0p / 8, a.n_first, j);
      product<kMaxTiles, 1, 1, true, true>(ring, src, ldh, hp / kChunkRows, n, false,
                                           [&](int t_, const float* v) {
        const int t = opaque(t_);
        const int c = (u0 + t) * 8 + col0;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + 8 * h;
          const float2 u = ld_stream(U + (2 * (u0 + t) + h) * 256 + frag0);
          const float d0 = __fmul_rn(v[2 * h] * act_sin_grad<kExact>(30.f * u.x), 30.f);
          const float d1 = __fmul_rn(v[2 * h + 1] * act_sin_grad<kExact>(30.f * u.y), 30.f);
          s0 += d0;
          s1 += d1;
          const bf2 o = __floats2bfloat162_rn(d0, d1);
          if (stage) {
            at2(x0 + r * ld0 + c) = o;
          } else {
            __stcs(reinterpret_cast<unsigned*>(du + r * a.n0p + c), reinterpret_cast<const unsigned&>(o));
          }
        }
        const float cs = warp_colsum2(s0, s1, lane);
        if (lane < 8) prow_sums[c + (lane >> 2)] = cs;
      });
      u0 += n;
    }
    if (stage) finish_tile(du, a.n0p, x0, ld0, a.n0p);
    if (warp == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // the last tile's copies
  }
}

// the column products of the first layer, and the bytes of a ring stage:
// the widest chunk of the stream
int first_products(int n0p) { return (n0p / 8 + kUnits - 1) / kUnits; }
int stage_bytes(int n0p, int hp, int nc, int headp) {
  const int n_first = first_products(n0p);
  int widest = imax(imax(hp, nc), headp);
  for (int j = 0; j < n_first; ++j) widest = imax(widest, 8 * first_units(n0p / 8, n_first, j));
  return chunk_bytes(widest);
}

// the ring, its mbarriers, the 64 x max(n0p, headp) tile, the 64 x
// max(hp, k0p) tile and the per-row floats: every mode's layout
size_t field_smem(int k0p, int n0p, int hp, int headp, int stage) {
  return (size_t)kRingStages * stage + 2 * kRingStages * sizeof(uint64_t) +
         sizeof(bf16) * kRows * (smem_ld(imax(n0p, headp)) + smem_ld(imax(hp, k0p))) +
         sizeof(float) * kFloats;
}

// shapes: P a multiple of 64 and of S; every product within 54 n8 tiles
// (the first layer and W_net0^T in up to 4 column products), sigma in the
// colour product's column H; the stream exactly what the producer walks.
// K4, K5: S a power of two in [4, 64] (whole rays a CTA), the head's
// partial sums within the smaller activation tile; K5: 24 joints, 31 geo
// columns from raw rows of 6 or 7 floats.
template <int kMode>
int launch(Args a, const void* wstream, long long stream_bytes, int exact_sin, cudaStream_t stream) {
  const bool pow2 = a.S >= 4 && a.S <= kRows && (a.S & (a.S - 1)) == 0;
  const size_t slots = (size_t)(kRows / (pow2 && a.S < 16 ? a.S : 16)) * a.headp * sizeof(float);
  const bool bad_in = kMode == kGeo ? (a.n_cols != 6 && a.n_cols != 7) || a.n_in != 3 + kGeoCols ||
                                         a.n_joints + 7 != kGeoCols || a.n_joints > kMaxJoints || a.n_verts < 1
                                   : a.n_cols != a.n_in + 3 && a.n_cols != a.n_in + 4;
  const bool bad_render = (kMode == kRender || kMode == kGeo) &&
                          (!pow2 || slots > sizeof(bf16) * kRows * smem_ld(imax(a.hp, a.k0p)));
  if (a.S < 1 || a.P < kRows || a.P % kRows || a.P % a.S || a.B < 1 || a.n_blocks < 1 || a.k0p % 16 ||
      a.n0p % 16 || a.hp % 16 || a.headp % 16 || a.nc % 8 || a.n_in < 1 || a.n_in > a.k0p || bad_in ||
      bad_render || a.H < 1 || 2 * a.H > a.n0p || a.H > a.hp || a.H >= a.nc || a.nc > a.hp + 8 ||
      a.hp > 8 * kUnits || a.nc > 8 * kUnits || a.headp > 8 * kUnits || a.n0p < a.hp ||
      a.n0p > 4 * 8 * kUnits || a.width < 4 || a.width > a.headp || (reinterpret_cast<size_t>(wstream) & 15))
    return (int)cudaErrorInvalidValue;
  const long long fwd = 2LL * ((long long)a.k0p * a.n0p + (long long)a.n0p * a.hp +
                               (a.n_blocks - 1LL) * a.hp * a.hp + (long long)a.hp * a.nc +
                               (long long)a.hp * a.headp);
  const long long bwd = 2LL * ((long long)a.headp * a.hp + (long long)a.n_blocks * a.hp * a.hp +
                               (long long)a.hp * a.n0p);
  if (stream_bytes != (kMode == kBwd ? fwd + bwd : fwd)) return (int)cudaErrorInvalidValue;
  a.wstream = static_cast<const unsigned char*>(wstream);
  a.n_first = first_products(a.n0p);
  a.stage_bytes = stage_bytes(a.n0p, a.hp, a.nc, a.headp);
  const size_t smem = field_smem(a.k0p, a.n0p, a.hp, a.headp, a.stage_bytes);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = exact_sin ? field_kernel<kMode, true> : field_kernel<kMode, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.P / kRows, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The C entries' common tail: the weight tables beside the stream, the
// widths, the sine.
inline void set_field(Args& a, const float* b_first, const float* b_net, const float* freq, const float* phase,
                      const float* w_color_d, const float* w_sigma, const float* b_color, const float* b_sigma,
                      const float* b_head, int B, int P, int S, int n_cols, int n_in, int H, int k0p, int n0p,
                      int hp, int nc, int headp, int n_blocks, int width) {
  a.b_first = b_first, a.b_net = b_net, a.freq = freq, a.phase = phase, a.w_color_d = w_color_d;
  a.w_sigma = w_sigma, a.b_color = b_color, a.b_sigma = b_sigma, a.b_head = b_head;
  a.B = B, a.P = P, a.S = S, a.n_cols = n_cols, a.n_in = n_in, a.H = H, a.k0p = k0p, a.n0p = n0p;
  a.hp = hp, a.nc = nc, a.headp = headp, a.n_blocks = n_blocks, a.width = width;
}

}  // namespace
