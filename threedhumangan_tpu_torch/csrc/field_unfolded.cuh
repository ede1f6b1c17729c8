// The unfolded FiLM-SIREN field render shared by K4 (raymarch_unfolded.cu)
// and K5 (raymarch_geo.cu): one CTA renders 64 samples = 64 / S whole rays
// of one image, from first layer to composite, with nothing per sample
// leaving the CTA.
//
// The math is threedhumangan_tpu/ops/raymarch.py::_field_slab_parts then
// ::_march, with bf16 product operands and float32 sums:
//   x   = [sin(30 (p W_coord + b_coord)) | sin(30 (g W_geo + b_geo))]
//   x   = sin(f_i (x W_i + b_i) + p_i)                  i = 0 .. NB-1
//   sig = x W_sigma + b_sigma (+ the noise column, float32)
//   xc  = sin(f_last (x W_cx + dirs W_cd + b_color) + p_last)
//   rgb = sigmoid(xc W_rgb + b_rgb), feat = xc W_feat + b_feat
// and the front-to-back composite of K2 (delta 1e9 on the last step, the
// residual transmittance to the last sample and/or a white background).
// The weights are the field's own, shared by the whole batch; freq (*15+30)
// and phase enter per image in the epilogues (film(): multiply and add
// rounded apart, the JAX order).  K2 instead folds them into per-image
// weight tables.  The layout and products are K8's forward recompute
// (raymarch_bwd.cu) with K2's per-CTA composite (raymarch.cu), over the
// tile_mma.cuh weight ring.
//
// Shared memory, bytes, at hidden 420 (hp 432, n0p 848, k0p 48):
//   input tile 64 x 56 bf16              7,168
//   activations 64 x 856 + 64 x 440 bf16 165,888 (ping-pong)
//   per-warp 16 x 16 float staging       16,384
//   per-row sigma, weight, residual,
//   direction (3) and noise floats        1,792
//   weight ring 2 x 16 x 440 bf16        28,160
//   total                               219,392 of the 232,448 a CTA may have
#pragma once

#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace thgt {

struct UnfoldedField {     // ops/raymarch.py::kernel_tables, widths padded to 16
  const bf16* w_first;     // (k0p, n0p) block-diagonal [coord | geo], omega not folded
  const float* b_first;    // (n0p)
  const bf16* w_net0;      // (n0p, hp)
  const bf16* w_net_stk;   // (max(NB-1,1), hp, hp)
  const float* b_net;      // (NB, hp)
  const float* freq;       // (B, NB, hp) freq * 15 + 30
  const float* phase;      // (B, NB, hp)
  const bf16* w_color_x;   // (hp, hp) rows 3: of w_color
  const float* w_color_d;  // (3, hp) rows :3 of w_color, bf16-rounded values
  const float* b_color;    // (hp)
  const float* w_sigma;    // (hp) bf16-rounded values
  const float* b_sigma;    // (1)
  const bf16* w_head;      // (hp, headp) [rgb 3 | features F | 0]
  const float* b_head;     // (headp)
  const float* z;          // (B, R, S)
  float* out;              // (B, R, out_width)
  float* depth;            // (B, R)
  int B, R, S, k0p, n0p, hp, n_blocks, out_width, headp, white_back, last_back, exact_sin;
};

struct UnfoldedSmem {
  bf16* in_buf;      // (kRows, smem_ld(k0p)) first-layer input, bf16
  bf16* buf_a;       // (kRows, smem_ld(n0p)) activations
  bf16* buf_b;       // (kRows, smem_ld(hp))  activations
  float* scratch;    // kWarps x 256 floats, each warp's accumulator staging
  float* sigma;      // kRows
  float* wrow;       // kRows compositing weights
  float* resid;      // kRows / S residual added to every channel (white_back)
  float* dirs;       // 3 kRows view directions (bf16-rounded values)
  float* noise;      // kRows nerf noise (0 without the column)
  bf16* ring;        // kWeightRing (tile_mma.cuh)
};

inline size_t unfolded_smem_bytes(int k0p, int n0p, int hp) {
  return sizeof(bf16) * kRows * (smem_ld(k0p) + smem_ld(n0p) + smem_ld(hp)) +
         sizeof(float) * (kWarps * 256 + 7 * kRows) + sizeof(bf16) * kWeightRing;
}

__device__ __forceinline__ UnfoldedSmem unfolded_smem(unsigned char* smem, int k0p, int n0p, int hp) {
  UnfoldedSmem s;
  s.in_buf = reinterpret_cast<bf16*>(smem);
  s.buf_a = s.in_buf + kRows * smem_ld(k0p);
  s.buf_b = s.buf_a + kRows * smem_ld(n0p);
  s.scratch = reinterpret_cast<float*>(s.buf_b + kRows * smem_ld(hp));
  s.sigma = s.scratch + kWarps * 256;
  s.wrow = s.sigma + kRows;
  s.resid = s.wrow + kRows;
  s.dirs = s.resid + kRows;
  s.noise = s.dirs + 3 * kRows;
  s.ring = reinterpret_cast<bf16*>(s.noise + kRows);
  return s;
}

// Host-side check of the dimensions the body assumes; 0 or a CUDA error code.
inline int unfolded_check(const UnfoldedField& a) {
  if (a.S <= 0 || kRows % a.S || a.R % (kRows / a.S) || a.k0p % 16 || a.n0p % 16 || a.hp % 16 ||
      a.headp % 16 || a.n0p < a.hp || a.n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The SIREN and the composite of rays [ray0, ray0 + kRows / S) of image b.
// Call after the CTA has filled s.in_buf ([coords | geo] in bf16, zero to
// k0p), s.dirs and s.noise for its kRows rows and synchronised.  Every
// thread of the CTA must call it.
__device__ __forceinline__ void unfolded_field_body(const UnfoldedField& a, const UnfoldedSmem& s, int b,
                                                    int ray0) {
  const int S = a.S, hp = a.hp, NB = a.n_blocks, ex = a.exact_sin, rpc = kRows / S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldi = smem_ld(a.k0p), lda = smem_ld(a.n0p), ldb = smem_ld(hp);
  float* scratch = s.scratch + warp * 256;
  const float* fb = a.freq + (size_t)b * NB * hp;
  const float* pb = a.phase + (size_t)b * NB * hp;
  const float* fl = fb + (size_t)(NB - 1) * hp;
  const float* pl = pb + (size_t)(NB - 1) * hp;

  // first layers, block-diagonal [coord | geo]: sin(30 (x W + b))
  layer(s.in_buf, ldi, a.w_first, a.n0p, a.k0p, a.n0p, s.ring, scratch, [&](int r, int c, float v) {
    s.buf_a[r * lda + c] = __float2bfloat16(act_sin(30.f * (v + a.b_first[c]), ex));
  });
  __syncthreads();
  // trunk block 0 (2H -> H), then NB-1 blocks (H -> H), ping-ponging buffers
  layer(s.buf_a, lda, a.w_net0, hp, a.n0p, hp, s.ring, scratch, [&](int r, int c, float v) {
    s.buf_b[r * ldb + c] = __float2bfloat16(act_sin(film(fb[c], v + a.b_net[c], pb[c]), ex));
  });
  __syncthreads();
  bf16* cur = s.buf_b;
  bf16* other = s.buf_a;
  for (int i = 1; i < NB; ++i) {
    const float* bi = a.b_net + (size_t)i * hp;
    const float* fi = fb + (size_t)i * hp;
    const float* pi = pb + (size_t)i * hp;
    bf16* dst = other;
    layer(cur, ldb, a.w_net_stk + (size_t)(i - 1) * hp * hp, hp, hp, hp, s.ring, scratch,
          [&](int r, int c, float v) {
      dst[r * ldb + c] = __float2bfloat16(act_sin(film(fi[c], v + bi[c], pi[c]), ex));
    });
    __syncthreads();
    other = cur;
    cur = dst;
  }

  // sigma head (+ noise): kRows / kWarps rows per warp, lanes split the channels
  for (int r = warp * (kRows / kWarps); r < (warp + 1) * (kRows / kWarps); ++r) {
    float acc = 0.f;
    for (int c = lane; c < hp; c += 32) acc += __bfloat162float(cur[r * ldb + c]) * a.w_sigma[c];
#pragma unroll
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) s.sigma[r] = (acc + a.b_sigma[0]) + s.noise[r];
  }
  __syncthreads();
  // front-to-back compositing weights, one thread per ray
  if (tid < rpc) {
    const float* zr = a.z + ((size_t)b * a.R + ray0 + tid) * S;
    float T = 1.f, w_sum = 0.f, dep = 0.f;
    for (int st = 0; st < S; ++st) {
      const float zs = zr[st];
      const float delta = st + 1 < S ? zr[st + 1] - zs : 1e9f;
      const float alpha = 1.f - expf(-delta * fmaxf(s.sigma[tid * S + st], 0.f));
      const float w = alpha * T;
      s.wrow[tid * S + st] = w;
      dep += w * zs;
      w_sum += w;
      T *= (1.f - alpha) + 1e-12f;
    }
    const float res = 1.f - w_sum;
    if (a.last_back) s.wrow[tid * S + S - 1] += res;
    a.depth[(size_t)b * a.R + ray0 + tid] = dep + res * zr[S - 1];
    s.resid[tid] = a.white_back ? res : 0.f;
  }
  // colour layer: x_last W_x + dirs W_d + b, FiLM with the last trunk block's freq/phase
  {
    bf16* dst = other;
    layer(cur, ldb, a.w_color_x, hp, hp, hp, s.ring, scratch, [&](int r, int c, float v) {
      const float* d = s.dirs + 3 * r;
      const float dd = d[0] * a.w_color_d[c] + d[1] * a.w_color_d[hp + c] + d[2] * a.w_color_d[2 * hp + c];
      dst[r * ldb + c] = __float2bfloat16(act_sin(film(fl[c], v + dd + a.b_color[c], pl[c]), ex));
    });
  }
  __syncthreads();
  // heads + composite: each warp's column tiles, reduced over each ray's rows
  const bf16* xc = other;
  gemm_staged(xc, ldb, a.w_head, a.headp, hp, a.headp, s.ring, [&](int n0, FragC(&acc)[kRowTiles]) {
    const int c = n0 + (lane & 15);
    const float bias = a.b_head[c];
    float part = 0.f;
#pragma unroll
    for (int m = 0; m < kRowTiles; ++m) {
      stage(scratch, acc[m]);
      if (lane < 16) {
        for (int rr = 0; rr < 16; ++rr) {
          const int row = m * 16 + rr;
          float v = scratch[rr * 16 + lane] + bias;
          if (c < 3) v = 1.f / (1.f + expf(-v));
          part += s.wrow[row] * v;
          if ((row + 1) % S == 0) {
            const int ray = row / S;
            if (c < a.out_width) a.out[((size_t)b * a.R + ray0 + ray) * a.out_width + c] = part + s.resid[ray];
            part = 0.f;
          }
        }
      }
      __syncwarp();
    }
  });
}

}  // namespace thgt
