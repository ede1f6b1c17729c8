// K8 + K9: backward of the field render (K2).
//
// Replaces threedhumangan_tpu/ops/raymarch_bwd.py::_stats_kernel (K8) and
// ::_bwd_step_kernel (K9) (Pallas, TPU).  Both recompute the UNFOLDED
// FiLM-SIREN per sample (first layers sin(30 (x W + b)), trunk
// sin(f (x W + b) + p), colour layer over [dirs, x] with the last trunk
// slice's f/p, sigmoid-RGB and feature heads), with bf16 operands and
// float32 sums, as the JAX kernels do.
//
//   field_kernel<false> (K8): sigma (+ the noise column) and
//       sum_c g_out[ray, c] * field[c] per sample.
//   field_kernel<true>  (K9): the recompute, then the backprop through the
//       heads, colour layer, trunk and first layers.  It writes, per layer,
//       the bf16 operands of the weight-gradient products (layer input X
//       and output gradient dY) and per-CTA column sums (bias grads, and
//       the freq/phase grads of its image).
//   The weight gradients dW = sum over samples of X^T dY are reduced by
//       csrc/wgrad.cu (shared with K11): every chunk of rows writes its own
//       partial, and the host sums the partials in a fixed order.  No
//       atomics: the grads are the same from run to run.
//
// What bounds it on an H100: at hidden 384 the recompute is ~2 MFLOP of
// matrix products per sample and the backprop as much again (~2.2 TFLOP for
// 8 x 65,536 samples), the weight-gradient products ~1.1 TFLOP; the saved
// pre-activations (f32) and the bf16 product operands are ~5 KB + ~6 KB a
// sample through device memory.  As in K2, operand traffic through shared
// memory, not the tensor cores, sets the time of the per-sample kernels.
//
// Design: a CTA owns 64 samples of one image (tile_mma.cuh: bf16 wmma, the
// weights streamed through a shared-memory ring).  The per-sample
// pre-activations that the backward needs (first-layer u, trunk v, colour
// vc) do not fit in shared memory beside the activation tiles, so the
// forward writes them to device memory and the backward reads them back.
// The backward's transposed products use W^T prepared on the host.  Column
// sums are reduced per lane, then across the two lanes of a column, into a
// shared per-CTA accumulator that one warp owns per column tile, so every
// sum has a fixed order.
#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace {

using namespace thgt;

struct Tables {            // see ops/raymarch_bwd.py::_kernel_tables
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
};

struct Dims {
  int B, P, S, n_cols, n_in, k0p, n0p, hp, n_blocks, width, headp, exact_sin;
};

struct Saved {             // K9's per-sample buffers, rows = B * P of this launch
  const bf16 *wT_head, *wT_color_x, *wT_net_stk, *wT_net0;  // transposed weights
  bf16* x0;    // (rows, k0p)   packed inputs (first-layer X)
  bf16* xs0;   // (rows, n0p)   trunk-0 X
  bf16* xsk;   // (NB-1, rows, hp) trunk-i X
  bf16* xcol;  // (rows, hp+16) [x_last | dirs | 0] colour/sigma X
  bf16* xc;    // (rows, hp)    head X
  bf16* du;    // (rows, n0p)   first-layer dY
  bf16* dv;    // (NB, rows, hp) trunk dY
  bf16* dcol;  // (rows, hp+16) [dvc | dsigma | 0]
  bf16* dyh;   // (rows, headp) [d rgb pre-act | d features]
  float* U;    // (rows, n0p)   first-layer pre-activations
  float* V;    // (NB, rows, hp) trunk x W + b
  float* VC;   // (rows, hp)    colour x W + b
  float* part; // (rows / 64, n_part) per-CTA column sums
};

// 64 rows x ncols (a multiple of 8) bf16: shared (row stride lds) -> global (row stride ldg)
__device__ __forceinline__ void copy_tile(bf16* g, int ldg, const bf16* s, int lds, int ncols) {
  const int vecs = ncols / 8;
  for (int e = threadIdx.x; e < kRows * vecs; e += kThreads) {
    const int r = e / vecs, v = e % vecs;
    *reinterpret_cast<uint4*>(g + (size_t)r * ldg + v * 8) =
        *reinterpret_cast<const uint4*>(s + r * lds + v * 8);
  }
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
// floats of the per-CTA column-sum accumulator
__host__ __device__ constexpr int col_acc(int n0p, int hp, int headp) {
  return imax(imax(n0p, 3 * hp), headp);
}

// kBwd = false: K8 (stats); true: K9 (recompute + backprop)
template <bool kBwd>
__global__ void __launch_bounds__(kThreads, 1)
    field_kernel(const bf16* packed, const float* go, const float* coef, const float* dsig, Tables t,
                 Saved sv, float* sigma_out, float* gdot_out, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int hp = d.hp, n0p = d.n0p, NB = d.n_blocks, S = d.S, ex = d.exact_sin;
  const int b = blockIdx.y, row0 = blockIdx.x * kRows;  // first row of the tile in its image
  const int tile = b * (d.P / kRows) + blockIdx.x;
  const size_t g0 = (size_t)b * d.P + row0;             // first row in this launch
  const size_t rows = (size_t)d.B * d.P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldi = smem_ld(d.k0p), la = smem_ld(max(n0p, d.headp)), lb = smem_ld(hp);
  const int cw = col_acc(n0p, hp, d.headp);
  const int n_part = n0p + 3 * hp * (NB + 1) + d.headp + 1;

  bf16* in_buf = reinterpret_cast<bf16*>(smem);
  bf16* buf_a = in_buf + kRows * ldi;
  bf16* buf_b = buf_a + kRows * la;
  float* scratch_all = reinterpret_cast<float*>(buf_b + kRows * lb);
  float* scratch = scratch_all + warp * 256;
  float* rowv = scratch_all + kWarps * 256;
  float* coef_s = rowv;                 // kRows
  float* dsig_s = coef_s + kRows;       // kRows
  float* rgb_s = dsig_s + kRows;        // 3 kRows
  float* dirs = rgb_s + 3 * kRows;      // 3 kRows
  float* sig_s = dirs + 3 * kRows;      // kRows
  float* gpart = sig_s + kRows;         // kWarps x kRows
  float* colacc = gpart + kWarps * kRows;  // cw
  bf16* ring = reinterpret_cast<bf16*>(colacc + cw);

  const float* fb = t.freq + (size_t)b * NB * hp;
  const float* pb = t.phase + (size_t)b * NB * hp;
  const float* fl = fb + (size_t)(NB - 1) * hp;
  const float* pl = pb + (size_t)(NB - 1) * hp;

  // stage the tile's samples (bf16), directions and per-row values
  const bf16* pk = packed + g0 * d.n_cols;
  for (int e = tid; e < kRows * d.k0p; e += kThreads) {
    const int r = e / d.k0p, c = e % d.k0p;
    in_buf[r * ldi + c] = c < d.n_in ? pk[(size_t)r * d.n_cols + c] : __float2bfloat16(0.f);
  }
  for (int e = tid; e < kRows * 3; e += kThreads)
    dirs[e] = __bfloat162float(pk[(size_t)(e / 3) * d.n_cols + d.n_in + e % 3]);
  for (int e = tid; e < cw; e += kThreads) colacc[e] = 0.f;
  for (int e = tid; e < kWarps * kRows; e += kThreads) gpart[e] = 0.f;
  if (kBwd) {
    for (int e = tid; e < kRows; e += kThreads) {
      coef_s[e] = coef[g0 + e];
      dsig_s[e] = dsig[g0 + e];
    }
  }
  __syncthreads();
  if (kBwd) {
    copy_tile(sv.x0 + g0 * d.k0p, d.k0p, in_buf, ldi, d.k0p);
    if (warp == 0) {  // b_sigma grad: the tile's sum of dsigma
      float s = dsig_s[lane] + dsig_s[lane + 32];
#pragma unroll
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sv.part[(size_t)tile * n_part + n_part - 1] = s;
    }
  }

  // ---- forward recompute
  layer(in_buf, ldi, t.w_first, n0p, d.k0p, n0p, ring, scratch, [&](int r, int c, float v) {
    const float u = v + t.b_first[c];
    if (kBwd) sv.U[(g0 + r) * n0p + c] = u;
    buf_a[r * la + c] = __float2bfloat16(act_sin(30.f * u, ex));
  });
  __syncthreads();
  if (kBwd) copy_tile(sv.xs0 + g0 * n0p, n0p, buf_a, la, n0p);
  layer(buf_a, la, t.w_net0, hp, n0p, hp, ring, scratch, [&](int r, int c, float v) {
    v += t.b_net[c];
    if (kBwd) sv.V[(g0 + r) * hp + c] = v;
    buf_b[r * lb + c] = __float2bfloat16(act_sin(film(fb[c], v, pb[c]), ex));
  });
  __syncthreads();
  bf16* cur = buf_b;
  bf16* other = buf_a;
  for (int i = 1; i < NB; ++i) {
    if (kBwd) copy_tile(sv.xsk + ((size_t)(i - 1) * rows + g0) * hp, hp, cur, lb, hp);
    const float* bi = t.b_net + (size_t)i * hp;
    const float* fi = fb + (size_t)i * hp;
    const float* pi = pb + (size_t)i * hp;
    bf16* dst = other;
    layer(cur, lb, t.w_net_stk + (size_t)(i - 1) * hp * hp, hp, hp, hp, ring, scratch,
          [&](int r, int c, float v) {
      v += bi[c];
      if (kBwd) sv.V[((size_t)i * rows + g0 + r) * hp + c] = v;
      dst[r * lb + c] = __float2bfloat16(act_sin(film(fi[c], v, pi[c]), ex));
    });
    __syncthreads();
    other = cur;
    cur = dst;
  }
  // cur = x_last
  if (kBwd) {
    const int cp = hp + 16;
    copy_tile(sv.xcol + g0 * cp, cp, cur, lb, hp);
    for (int e = tid; e < kRows * 16; e += kThreads) {
      const int r = e / 16, c = e % 16;
      sv.xcol[(g0 + r) * cp + hp + c] = c < 3 ? __float2bfloat16(dirs[r * 3 + c]) : __float2bfloat16(0.f);
    }
  } else {  // sigma head (+ noise), one warp per kRows / kWarps rows
    for (int r = warp * (kRows / kWarps); r < (warp + 1) * (kRows / kWarps); ++r) {
      float s = 0.f;
      for (int c = lane; c < hp; c += 32) s += __bfloat162float(cur[r * lb + c]) * t.w_sigma[c];
#pragma unroll
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        float noise = 0.f;
        if (d.n_cols > d.n_in + 3) noise = __bfloat162float(pk[(size_t)r * d.n_cols + d.n_in + 3]);
        sig_s[r] = s + t.b_sigma[0] + noise;
      }
    }
  }
  // colour FiLM layer: x_last W_x + dirs W_d + b
  {
    bf16* dst = other;
    layer(cur, lb, t.w_color_x, hp, hp, hp, ring, scratch, [&](int r, int c, float v) {
      const float dd = dirs[r * 3] * t.w_color_d[c] + dirs[r * 3 + 1] * t.w_color_d[hp + c] +
                       dirs[r * 3 + 2] * t.w_color_d[2 * hp + c];
      const float vc = v + dd + t.b_color[c];
      if (kBwd) sv.VC[(g0 + r) * hp + c] = vc;
      dst[r * lb + c] = __float2bfloat16(act_sin(film(fl[c], vc, pl[c]), ex));
    });
    __syncthreads();
  }
  const bf16* xc = other;

  if (!kBwd) {
    // heads: field[c] = sigmoid (c < 3) or identity; per-row sum of g_out * field
    gemm_staged(xc, lb, t.w_head, d.headp, hp, d.headp, ring, [&](int n0, FragC(&acc)[kRowTiles]) {
#pragma unroll
      for (int m = 0; m < kRowTiles; ++m) {
        stage(scratch, acc[m]);
        if (lane < 16) {
          const int r = m * 16 + lane;
          const int ray = (row0 + r) / S;
          const float* gr = go + ((size_t)b * (d.P / S) + ray) * d.width;
          float s = 0.f;
          for (int cc = 0; cc < 16; ++cc) {
            const int c = n0 + cc;
            if (c < d.width) {
              float v = scratch[lane * 16 + cc] + t.b_head[c];
              if (c < 3) v = 1.f / (1.f + expf(-v));
              s += gr[c] * v;
            }
          }
          gpart[warp * kRows + r] += s;
        }
        __syncwarp();
      }
    });
    __syncthreads();
    if (tid < kRows) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += gpart[w * kRows + tid];
      gdot_out[g0 + tid] = s;
      sigma_out[g0 + tid] = sig_s[tid];
    }
    return;
  }

  // ---- K9 backward
  copy_tile(sv.xc + g0 * hp, hp, xc, lb, hp);
  // rgb = sigmoid of the first head columns
  layer(xc, lb, t.w_head, d.headp, hp, 16, ring, scratch, [&](int r, int c, float v) {
    if (c < 3) rgb_s[r * 3 + c] = 1.f / (1.f + expf(-(v + t.b_head[c])));
  });
  __syncthreads();
  // head output gradient [d rgb pre-activation | d features] -> buf_a
  bf16* dyh = buf_a;
  for (int e = tid; e < kRows * d.headp; e += kThreads) {
    const int r = e / d.headp, c = e % d.headp;
    float g = 0.f;
    if (c < d.width) {
      const int ray = (row0 + r) / S;
      g = coef_s[r] * go[((size_t)b * (d.P / S) + ray) * d.width + c];
      if (c < 3) g = g * rgb_s[r * 3 + c] * (1.f - rgb_s[r * 3 + c]);
    }
    dyh[r * la + c] = __float2bfloat16(g);
  }
  __syncthreads();
  const int off_c = n0p + 3 * hp * NB, off_h = off_c + 3 * hp;
  for (int c = tid; c < d.headp; c += kThreads) {  // b_rgb / b_feat: sum of the f32 values
    float s = 0.f;
    if (c < d.width) {
      for (int r = 0; r < kRows; ++r) {
        const int ray = (row0 + r) / S;
        float g = coef_s[r] * go[((size_t)b * (d.P / S) + ray) * d.width + c];
        if (c < 3) g = g * rgb_s[r * 3 + c] * (1.f - rgb_s[r * 3 + c]);
        s += g;
      }
    }
    sv.part[(size_t)tile * n_part + off_h + c] = s;
  }
  copy_tile(sv.dyh + g0 * d.headp, d.headp, dyh, la, d.headp);

  auto flush = [&](int off, int n) {
    __syncthreads();
    for (int c = tid; c < n; c += kThreads) {
      sv.part[(size_t)tile * n_part + off + c] = colacc[c];
      colacc[c] = 0.f;
    }
    __syncthreads();
  };

  // colour layer: dxc = dyh W_head^T -> dprec -> dvc.  buf_b holds x_last or
  // xc, both already copied out.
  bf16* dvc = buf_b;
  layer_colsum<3>(dyh, la, sv.wT_head, hp, d.headp, hp, ring, scratch, colacc, hp,
                  [&](int r, int c, float v, float* s) {
    const float vc = sv.VC[(g0 + r) * hp + c];
    const float dpre = v * act_sin_grad(film(fl[c], vc, pl[c]), ex);
    const float dv = dpre * fl[c];
    s[0] += dv;
    s[1] += dpre * vc;
    s[2] += dpre;
    dvc[r * lb + c] = __float2bfloat16(dv);
  });
  flush(off_c, 3 * hp);
  {
    const int cp = hp + 16;
    copy_tile(sv.dcol + g0 * cp, cp, dvc, lb, hp);
    for (int e = tid; e < kRows * 16; e += kThreads) {
      const int r = e / 16, c = e % 16;
      sv.dcol[(g0 + r) * cp + hp + c] = c == 0 ? __float2bfloat16(dsig_s[r]) : __float2bfloat16(0.f);
    }
  }

  // trunk, last block first; the first product also takes dsigma W_sigma^T
  bf16* src = dvc;
  bf16* dst = buf_a;
  for (int i = NB - 1; i >= 0; --i) {
    const bf16* wT = i == NB - 1 ? sv.wT_color_x : sv.wT_net_stk + (size_t)i * hp * hp;
    const float* fi = fb + (size_t)i * hp;
    const float* pi = pb + (size_t)i * hp;
    const float* Vi = sv.V + (size_t)i * rows * hp;
    const bool top = i == NB - 1;
    layer_colsum<3>(src, lb, wT, hp, hp, hp, ring, scratch, colacc, hp,
                    [&](int r, int c, float v, float* s) {
      float dx = v;
      if (top) dx += __bfloat162float(__float2bfloat16(dsig_s[r])) * t.w_sigma[c];
      const float vv = Vi[(g0 + r) * hp + c];
      const float dpre = dx * act_sin_grad(film(fi[c], vv, pi[c]), ex);
      const float dv = dpre * fi[c];
      s[0] += dv;
      s[1] += dpre * vv;
      s[2] += dpre;
      dst[r * lb + c] = __float2bfloat16(dv);
    });
    flush(n0p + 3 * hp * i, 3 * hp);
    copy_tile(sv.dv + ((size_t)i * rows + g0) * hp, hp, dst, lb, hp);
    bf16* tmp = src;
    src = dst;
    dst = tmp;
  }
  // first layers: dx = dv_0 W_net0^T -> du = dx sin'(30 u) 30
  layer_colsum<1>(src, lb, sv.wT_net0, n0p, hp, n0p, ring, scratch, colacc, n0p,
                  [&](int r, int c, float v, float* s) {
    const float u = sv.U[(g0 + r) * n0p + c];
    const float du = v * act_sin_grad(30.f * u, ex) * 30.f;
    s[0] += du;
    sv.du[(g0 + r) * n0p + c] = __float2bfloat16(du);
  });
  flush(0, n0p);
}

size_t field_smem(int k0p, int n0p, int hp, int headp) {
  return sizeof(bf16) * kRows * (smem_ld(k0p) + smem_ld(imax(n0p, headp)) + smem_ld(hp)) +
         sizeof(float) * (kWarps * 256 + 9 * kRows + kWarps * kRows + col_acc(n0p, hp, headp)) +
         sizeof(bf16) * kWeightRing;
}

int check_dims(const Dims& d) {
  if (d.S <= 0 || d.P % d.S || d.P % kRows || d.k0p % 16 || d.n0p % 16 || d.hp % 16 || d.headp % 16 ||
      d.n0p < d.hp || d.n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool kBwd>
int launch(const bf16* packed, const float* go, const float* coef, const float* dsig, const Tables& t,
           const Saved& sv, float* sigma, float* gdot, const Dims& d, cudaStream_t stream) {
  if (int err = check_dims(d)) return err;
  const size_t smem = field_smem(d.k0p, d.n0p, d.hp, d.headp);
  cudaError_t err = cudaFuncSetAttribute(field_kernel<kBwd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(d.P / kRows, d.B);
  field_kernel<kBwd><<<grid, kThreads, smem, stream>>>(packed, go, coef, dsig, t, sv, sigma, gdot, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int thgt_field_stats(const bf16* packed, const float* go, const bf16* w_first,
                                const float* b_first, const bf16* w_net0, const bf16* w_net_stk,
                                const float* b_net, const float* freq, const float* phase,
                                const bf16* w_color_x, const float* w_color_d, const float* b_color,
                                const float* w_sigma, const float* b_sigma, const bf16* w_head,
                                const float* b_head, float* sigma, float* gdot, int B, int P, int S,
                                int n_cols, int n_in, int k0p, int n0p, int hp, int n_blocks, int width,
                                int headp, int exact_sin, cudaStream_t stream) {
  Tables t{w_first, b_first, w_net0, w_net_stk, b_net, freq, phase, w_color_x, w_color_d, b_color,
           w_sigma, b_sigma, w_head, b_head};
  Dims d{B, P, S, n_cols, n_in, k0p, n0p, hp, n_blocks, width, headp, exact_sin};
  Saved sv{};
  return launch<false>(packed, go, nullptr, nullptr, t, sv, sigma, gdot, d, stream);
}

extern "C" int thgt_field_bwd(const bf16* packed, const float* go, const float* coef, const float* dsig,
                              const bf16* w_first, const float* b_first, const bf16* w_net0,
                              const bf16* w_net_stk, const float* b_net, const float* freq,
                              const float* phase, const bf16* w_color_x, const float* w_color_d,
                              const float* b_color, const float* w_sigma, const float* b_sigma,
                              const bf16* w_head, const float* b_head, const bf16* wT_head,
                              const bf16* wT_color_x, const bf16* wT_net_stk, const bf16* wT_net0,
                              bf16* x0, bf16* xs0, bf16* xsk, bf16* xcol, bf16* xc, bf16* du, bf16* dv,
                              bf16* dcol, bf16* dyh, float* U, float* V, float* VC, float* part, int B,
                              int P, int S, int n_cols, int n_in, int k0p, int n0p, int hp, int n_blocks,
                              int width, int headp, int exact_sin, cudaStream_t stream) {
  Tables t{w_first, b_first, w_net0, w_net_stk, b_net, freq, phase, w_color_x, w_color_d, b_color,
           w_sigma, b_sigma, w_head, b_head};
  Dims d{B, P, S, n_cols, n_in, k0p, n0p, hp, n_blocks, width, headp, exact_sin};
  Saved sv{wT_head, wT_color_x, wT_net_stk, wT_net0, x0, xs0, xsk, xcol, xc, du, dv, dcol, dyh,
           U, V, VC, part};
  return launch<true>(packed, go, coef, dsig, t, sv, nullptr, nullptr, d, stream);
}
