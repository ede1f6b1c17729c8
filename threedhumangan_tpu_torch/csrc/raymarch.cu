// K2: folded FiLM-SIREN field render with front-to-back alpha compositing.
//
// Replaces threedhumangan_tpu/ops/raymarch.py::_raymarch_kernel_folded
// (Pallas, TPU).  Per sample: sin(in @ W_first + b) with the omega-scaled
// block-diagonal first layer, the trunk (per-image freq-folded weights, sin),
// sigma, the colour layer with the per-ray view-direction term hoisted,
// sigmoid-RGB + feature head; per ray: alpha-compositing over the steps in
// order (T *= 1 - alpha + 1e-12, delta 1e9 on the last step), residual
// transmittance to the last sample (last_back) and/or white (white_back),
// and the depth.  A packed width of n_in + 4 carries the training-time nerf
// noise, added to sigma before the relu clamp.
//
// What bounds it on an H100: ~2.5 MFLOP of matrix products per sample at
// width 420 (3.0 TFLOP per batch of 8 x 147,456 samples, 3.0 ms at the bf16
// peak) plus ~2,100 sines per sample; the inputs (37 bf16 a sample) and
// outputs (424 floats a ray) are small.  At 64 rows a CTA the weights come
// next: every tile streams its image's 2.68 MB of tables from L2, ~49 GB a
// batch, an estimated 7-10 ms at the L2 read rate.
//
// Design (synthesis_core.cuh, K3's core): a CTA owns 64 sample rows = whole
// rays (64 / S of them), so the composite never leaves it; grid.x runs over
// an image's ray tiles, so the CTAs in flight share one image's stream in
// L2.  The weights arrive as one pre-packed bf16 stream per image of 16-row
// chunk images in wgmma's B layout (ops/raymarch.py::pack_field_stream): a
// producer lane keeps chunks in flight with cp.async.bulk into a four-stage
// mbarrier ring while three consumer warpgroups multiply with wgmma, A from
// registers, each warpgroup a run of columns over all 64 rows.  The stream
// is bound by the bytes in flight, not by L2's rate, and ptxas serializes
// the wgmma here (C7512), so a warp releases each stage as soon as its own
// wgmma have retired (k_loop's kEager), not one chunk later.  Activations
// stay in shared memory in bf16: the first layer's 64 x n0p output, then the
// trunk ping-pongs between that buffer and a 64 x hp tile (which first held
// the input samples).  Every epilogue runs on the accumulators in registers:
// bias + sine in f32, stored as bf16 pairs (the JAX rounding points); the
// colour layer adds each row's hoisted dirs @ W_color_d + b_color; sigma is
// one extra column of the colour product's B (w_sigma, in column H), taken
// raw there with b_sigma and the noise.  Compositing weights are one thread
// per ray; the head epilogue applies the sigmoid and the row's weight and
// sums each ray's rows by shuffles over a warp's row groups, then across the
// warps holding the ray in fixed order through shared memory, so two calls
// are bit-equal.  Widths are zero-padded on the host (zero weights and
// biases keep padded channels at 0).  pipe2 (a TPU VPU/MXU overlap
// schedule) has no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

#include "synthesis_core.cuh"
#include "siren_math.cuh"  // thgt::fast_sin (the JAX package's sine)

namespace {

using namespace syn;

// the activation's sine: sinf (exact_sin) or the JAX package's fast_sin,
// chosen once per launch, so each epilogue is one straight-line sequence
template <bool kExact>
__device__ __forceinline__ float act_sin(float x) {
  if constexpr (kExact) {
    return sinf(x);
  } else {
    return thgt::fast_sin(x);
  }
}

// registers a thread: per SM sub-partition one producer warp and three
// consumer warps, 32 x (40 + 3 x 152) <= 16,384
constexpr int kProducerRegs = 40, kConsumerRegs = 152;
constexpr int kRingStages = 4;
constexpr int kUnits = kMaxTiles * kColGroups;  // n8 tiles of one product: N <= 432
constexpr size_t kMaxSmem = 232448;            // the shared memory a CTA may have
constexpr int kFloats = 7 * kRows;             // sigma, weights, noise, dirs (3), resid

struct Args {
  const bf16* packed;            // (B, R*S, n_cols) ray-major samples
  const float* z;                // (B, R, S)
  const unsigned char* wstream;  // (B, img_bytes): chunk images, pack_field_stream
  const float* b_first;          // (n0p), omega folded
  const float* b_net;            // (B, NB, hp)
  const float* w_color_d;        // (B, 3, nc), bf16-rounded values
  const float* b_color;          // (B, nc)
  const float* b_sigma;          // (1)
  const float* b_head;           // (headp)
  float* out;                    // (B, R, out_width)
  float* depth;                  // (B, R)
  long long img_bytes;
  int B, R, S, n_cols, n_in, H, k0p, n0p, hp, nc, headp, n_blocks, out_width;
  int white_back, last_back, exact_sin, n_first, stage_bytes;
};

__host__ __device__ constexpr int chunk_bytes(int n) { return kChunkRows * n * (int)sizeof(bf16); }
__host__ __device__ constexpr int imax(int x, int y) { return x > y ? x : y; }
// n8 tiles of column product j of the first layer (n0p / 8 split evenly)
__host__ __device__ constexpr int first_units(int tiles, int n, int j) {
  return tiles / n + (j < tiles % n);
}

// The producer walks one image's stream as the consumers consume it: the
// first layer's column products (k0p/16 chunks each), w_net0 (n0p/16),
// the NB-1 trunk layers (hp/16 each), the colour layer with the sigma
// column (hp/16 of nc columns) and the head (hp/16 of headp).
__device__ void produce(const Args& a, ProducerT<kRingStages>& p) {
  for (int j = 0; j < a.n_first; ++j)
    p.put(a.k0p / kChunkRows, chunk_bytes(8 * first_units(a.n0p / 8, a.n_first, j)));
  p.put(a.n0p / kChunkRows, chunk_bytes(a.hp));
  for (int i = 1; i < a.n_blocks; ++i) p.put(a.hp / kChunkRows, chunk_bytes(a.hp));
  p.put(a.hp / kChunkRows, chunk_bytes(a.nc));
  p.put(a.hp / kChunkRows, chunk_bytes(a.headp));
}

template <bool kExact>
__global__ void __launch_bounds__(kThreads, 1) raymarch_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, hp = a.hp, rpc = kRows / S;
  const int b = blockIdx.y, ray0 = blockIdx.x * rpc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldi = smem_ld(a.k0p), ld0 = smem_ld(a.n0p), ldh = smem_ld(hp);

  unsigned char* stages = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kRingStages * a.stage_bytes);
  uint64_t* empty = full + kRingStages;
  bf16* x0 = reinterpret_cast<bf16*>(empty + kRingStages);  // first layer out; a trunk tile
  bf16* t1 = x0 + kRows * ld0;                                // the input tile; a trunk tile
  float* sig = reinterpret_cast<float*>(t1 + kRows * imax(ldh, ldi));
  float* wrow = sig + kRows;   // compositing weights
  float* noise = wrow + kRows;
  float* dirs = noise + kRows;
  float* resid = dirs + 3 * kRows;

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
      ProducerT<kRingStages> p{stages, full, empty, a.stage_bytes, a.wstream + b * a.img_bytes, 0};
      produce(a, p);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  RingT<kRingStages> ring{stages, full, empty, a.stage_bytes, 0};

  // the tile's samples (bf16, zero columns n_in..k0p), noise and the
  // per-ray view directions
  const bf16* pk = a.packed + ((size_t)b * a.R + ray0) * S * a.n_cols;
  for (int e = tid; e < kRows * a.k0p; e += kConsumers) {
    const int r = e / a.k0p, c = e % a.k0p;
    t1[r * ldi + c] = c < a.n_in ? pk[(size_t)r * a.n_cols + c] : __float2bfloat16(0.f);
  }
  const bool with_noise = a.n_cols > a.n_in + 3;
  if (tid < kRows)
    noise[tid] = with_noise ? __bfloat162float(pk[(size_t)tid * a.n_cols + a.n_in + 3]) : 0.f;
  if (tid < rpc * 3)
    dirs[tid] = __bfloat162float(pk[(size_t)(tid / 3) * S * a.n_cols + a.n_in + tid % 3]);
  consumer_sync();

  // this thread's accumulator rows (+ 8) and column pair within an n8 tile
  const int row0 = (warp & 3) * 16 + (lane >> 2), col0 = (lane & 3) * 2;
  auto sine_store = [&](bf16* dst, int ld, int c, const float* v, float2 bi) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      at2(dst + (row0 + 8 * h) * ld + c) = __floats2bfloat162_rn(act_sin<kExact>(v[2 * h] + bi.x),
                                                                  act_sin<kExact>(v[2 * h + 1] + bi.y));
  };

  // first layer (block-diagonal coords | geo), omega folded into W and b,
  // in column products of <= 432 columns
  for (int j = 0, u0 = 0; j < a.n_first; ++j) {
    const int n = first_units(a.n0p / 8, a.n_first, j);
    product<kMaxTiles, 1, 1, true, true>(ring, t1, ldi, a.k0p / kChunkRows, n, false,
                                         [&](int t, const float* v) {
                                           const int c = (u0 + t) * 8 + col0;
                                           sine_store(x0, ld0, c, v, ld_f2(a.b_first + c));
                                         });
    u0 += n;
  }
  consumer_sync();
  // trunk layer 0 (2H -> H) into t1, then NB-1 (H -> H) layers, ping-ponging
  const float* bn = a.b_net + (size_t)b * a.n_blocks * hp;
  product<kMaxTiles, 1, 1, true, true>(ring, x0, ld0, a.n0p / kChunkRows, hp / 8, false,
                                       [&](int t, const float* v) {
                                         const int c = t * 8 + col0;
                                         sine_store(t1, ldh, c, v, ld_f2(bn + c));
                                       });
  consumer_sync();
  bf16* cur = t1;
  bf16* oth = x0;
  for (int i = 1; i < a.n_blocks; ++i) {
    const float* bi = bn + (size_t)i * hp;
    bf16* dst = oth;
    product<kMaxTiles, 1, 1, true, true>(ring, cur, ldh, hp / kChunkRows, hp / 8, false,
                                         [&](int t, const float* v) {
                                           const int c = t * 8 + col0;
                                           sine_store(dst, ldh, c, v, ld_f2(bi + c));
                                         });
    consumer_sync();
    oth = cur;
    cur = dst;
  }

  // colour FiLM layer with the hoisted per-ray term; column H of the same
  // product is sigma (w_sigma in the stream), + b_sigma + the noise
  {
    const int nc = a.nc, H = a.H;
    const float* wd = a.w_color_d + (size_t)b * 3 * nc;
    const float* bc = a.b_color + (size_t)b * nc;
    const float bsig = a.b_sigma[0];
    bf16* dst = oth;
    product<kMaxTiles, 1, 1, true, true>(
        ring, cur, ldh, hp / kChunkRows, nc / 8, false, [&](int t, const float* v) {
          const int c = t * 8 + col0;
          const float2 w0 = ld_f2(wd + c), w1 = ld_f2(wd + nc + c), w2 = ld_f2(wd + 2 * nc + c);
          const float2 bb = ld_f2(bc + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row0 + 8 * h;
            const float* d = dirs + (r / S) * 3;
            const float dx = d[0] * w0.x + d[1] * w1.x + d[2] * w2.x + bb.x;
            const float dy = d[0] * w0.y + d[1] * w1.y + d[2] * w2.y + bb.y;
            float x = act_sin<kExact>(v[2 * h] + dx), y = act_sin<kExact>(v[2 * h + 1] + dy);
            if (c == H) {
              sig[r] = v[2 * h] + bsig + noise[r];
              x = 0.f;
            } else if (c + 1 == H) {
              sig[r] = v[2 * h + 1] + bsig + noise[r];
              y = 0.f;
            }
            if (c < hp) at2(dst + r * ldh + c) = __floats2bfloat162_rn(x, y);
          }
        });
  }
  consumer_sync();
  // front-to-back compositing weights, one thread per ray
  if (tid < rpc) {
    const float* zr = a.z + ((size_t)b * a.R + ray0 + tid) * S;
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
    a.depth[(size_t)b * a.R + ray0 + tid] = dep + res * zr[S - 1];
    resid[tid] = a.white_back ? res : 0.f;
  }
  consumer_sync();

  // heads + composite: sigmoid RGB, times the row's weight, summed over a
  // warp's rows of one ray by shuffles (lane bits 2-4 and the +8 row when a
  // ray spans the warp's 16 rows); one slot of partial sums per (warp, ray)
  // in the colour layer's input tile, which is free now
  float* part = reinterpret_cast<float*>(cur);
  const int rows = S < 8 ? S : 8;  // rows of one ray among a warp's row groups
  const int slot_rows = S < 16 ? S : 16;
  const int hd = a.headp;
  product<kMaxTiles, 1, 1, true, true>(ring, oth, ldh, hp / kChunkRows, hd / 8, false,
                                       [&](int t, const float* v) {
    const int c = t * 8 + col0;
    const float2 bh = ld_f2(a.b_head + c);
    float y[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float w = wrow[row0 + 8 * h];
      float p = v[2 * h] + bh.x, q = v[2 * h + 1] + bh.y;
      if (c < 3) p = 1.f / (1.f + expf(-p));
      if (c + 1 < 3) q = 1.f / (1.f + expf(-q));
      y[h][0] = w * p;
      y[h][1] = w * q;
    }
    if (S >= 16) {
      // a warp's 16 rows are one ray: the two columns' sums split over the
      // lane pairs of the first level, so each level is one shuffle
      const bool hi = lane & 4;
      const float x0 = y[0][0] + y[1][0], x1 = y[0][1] + y[1][1];
      float s = (hi ? x1 : x0) + __shfl_xor_sync(0xffffffffu, hi ? x0 : x1, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 8) part[(row0 / 16) * hd + c + hi] = s;
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float s = y[h][j];
          for (int o = 4; o < 4 * rows; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          y[h][j] = s;
        }
        if (((lane >> 2) & (rows - 1)) == 0) {
          float* slot = part + ((row0 + 8 * h) / slot_rows) * hd + c;
          slot[0] = y[h][0];
          slot[1] = y[h][1];
        }
      }
    }
  });
  consumer_sync();
  const int per = S > 16 ? S / 16 : 1;  // slots of one ray
  float* out = a.out + ((size_t)b * a.R + ray0) * a.out_width;
  for (int e = tid; e < rpc * a.out_width; e += kConsumers) {
    const int ray = e / a.out_width, c = e % a.out_width;
    float s = 0.f;
    for (int k = 0; k < per; ++k) s += part[(ray * per + k) * hd + c];
    out[e] = s + resid[ray];
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

// the ring, its mbarriers, the first layer's 64 x n0p output, the 64 x hp
// trunk tile (which first holds the 64 x k0p inputs) and the float tables
size_t field_smem(int k0p, int n0p, int hp, int stage) {
  return (size_t)kRingStages * stage + 2 * kRingStages * sizeof(uint64_t) +
         sizeof(bf16) * kRows * (smem_ld(n0p) + imax(smem_ld(hp), smem_ld(k0p))) +
         sizeof(float) * kFloats;
}

}  // namespace

extern "C" int thgt_raymarch(const bf16* packed, const float* z, const void* wstream,
                             const float* b_first, const float* b_net, const float* w_color_d,
                             const float* b_color, const float* b_sigma, const float* b_head,
                             float* out, float* depth, int B, int R, int S, int n_cols, int n_in,
                             int H, int k0p, int n0p, int hp, int nc, int headp, int n_blocks,
                             int out_width, int white_back, int last_back, int exact_sin,
                             long long stream_bytes, cudaStream_t stream) {
  // shapes: S a power of two in [4, 64] (whole rays a CTA, the head's row
  // reductions), every product within 54 n8 tiles (the first layer in up to
  // 4 column products), sigma in the colour product's column H, the head's
  // partial sums within a trunk tile
  const bool pow2 = S >= 4 && S <= kRows && (S & (S - 1)) == 0;
  if (!pow2 || B < 1 || R < 1 || R % (kRows / S) || n_blocks < 1 || k0p % 16 || n0p % 16 ||
      hp % 16 || nc % 8 || headp % 8 || n_in < 1 || n_in > k0p ||
      (n_cols != n_in + 3 && n_cols != n_in + 4) || H < 1 || 2 * H > n0p || H > hp || H >= nc ||
      nc > hp + 8 || hp > 8 * kUnits || nc > 8 * kUnits || headp > 8 * kUnits || out_width < 1 ||
      out_width > headp || n0p > 4 * 8 * kUnits ||
      (size_t)(kRows / (S < 16 ? S : 16)) * headp * sizeof(float) > sizeof(bf16) * kRows * smem_ld(hp) ||
      (reinterpret_cast<size_t>(wstream) & 15))
    return (int)cudaErrorInvalidValue;
  // the stream must hold exactly what the producer walks, for every image
  const long long img = 2LL * (k0p * (long long)n0p + (long long)n0p * hp + (n_blocks - 1LL) * hp * hp +
                               (long long)hp * nc + (long long)hp * headp);
  if (img * B != stream_bytes) return (int)cudaErrorInvalidValue;
  const int stage = stage_bytes(n0p, hp, nc, headp);
  Args a{packed, z, static_cast<const unsigned char*>(wstream), b_first, b_net, w_color_d, b_color,
         b_sigma, b_head, out, depth, img, B, R, S, n_cols, n_in, H, k0p, n0p, hp, nc, headp,
         n_blocks, out_width, white_back, last_back, exact_sin, first_products(n0p), stage};
  const size_t smem = field_smem(k0p, n0p, hp, stage);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = exact_sin ? raymarch_kernel<true> : raymarch_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(R / (kRows / S), B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The shared memory thgt_raymarch gives a CTA at these padded widths, in
// bytes (it refuses more than 232,448); ring[0] its ring's stages, ring[1]
// the bytes of a stage.
extern "C" int thgt_raymarch_smem(int k0p, int n0p, int hp, int nc, int headp, int* ring) {
  ring[0] = kRingStages;
  ring[1] = stage_bytes(n0p, hp, nc, headp);
  return (int)field_smem(k0p, n0p, hp, ring[1]);
}
