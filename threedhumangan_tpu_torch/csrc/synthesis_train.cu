// K10: the trainable fused SPADE half-block (train-mode synthesis), forward.
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
// backward (K11) is csrc/synthesis_train_bwd.cu.  half_block_fwd: one CTA
// per 64 pixels of one image; writes out.
//
// What bounds it on an H100: at MAP3DBN's shapes (8 x 256 x 128 pixels,
// Ci = Co = Cs = 384, hidden 128) the products are 590 kFLOP a pixel for a
// spatial half-block (155 GFLOP) and 295 kFLOP for a rank-1 one; the
// device-memory streams (h, style, out: ~0.6 GB bf16) take 0.18 ms at
// 3.35 TB/s against 0.16 ms of bf16 tensor-core time, so the chain is near
// the machine balance.  At this CTA shape, as in K3 before its redesign,
// operand traffic through shared memory and the per-element epilogues set
// the time, not the tensor cores.
//
// Design (tile_mma.cuh: 16 warps, bf16 wmma with f32 accumulation): the
// 384 x 384 conv weight (288 KB bf16) exceeds a CTA's 227 KB of shared
// memory, so every weight streams through the cp.async ring 16 rows at a
// time.  The activations of a tile stay in shared memory in bf16;
// gamma/beta are formed 16 columns at a time from the SPADE hidden tile and
// applied in that epilogue.
#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace {

using namespace thgt;

struct Args {
  const bf16* h;        // (B, HW, ci)
  const bf16* style;    // (B, HW, cs)
  const bf16* fixed;    // (B, cs)
  const bf16* gam;      // (B, cip) rank-1 rows
  const bf16* bet;      // (B, cip)
  const float* m;       // (cip) batch mean
  const float* r;       // (cip) rsqrt(var + eps)
  const float* a;       // (cip) BN scale
  const float* b;       // (cip) BN bias
  const bf16* sh_w;     // (csp, hidp)
  const float* sh_b;    // (hidp)
  const bf16* g_w;      // (hidp, cip)
  const float* g_b;     // (cip)
  const bf16* bt_w;     // (hidp, cip)
  const float* bt_b;    // (cip)
  const bf16* w;        // W (cip, cop)
  const float* c;       // (cop)
  bf16* out;            // (B, HW, co)
  int B, HW, ci, cs, co, cip, csp, cop, hidp, spatial, add_fixed;
};

__device__ __forceinline__ float norm_hat(float h, float m, float r) {
  return __fmul_rn(__fsub_rn(h, m), r);
}
__device__ __forceinline__ float affine_u(float nhat, float a, float b) {
  return bf(__fadd_rn(__fmul_rn(nhat, a), b));
}
__device__ __forceinline__ float modulate(float u, float gam, float bet) {
  return bf(bf(u * gam) + bet);
}
__device__ __forceinline__ float f(bf16 x) { return __bfloat162float(x); }

// 64 rows x ncp columns into shared memory (row stride lds) from a row-major
// global matrix of nc columns; rows >= nv and columns >= nc read as 0
__device__ __forceinline__ void load_tile(bf16* s, int lds, const bf16* g, int nc, int ncp, int nv) {
  if ((nc & 7) == 0) {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const int vecs = ncp / 8;
    for (int e = threadIdx.x; e < kRows * vecs; e += kThreads) {
      const int r = e / vecs, c = (e % vecs) * 8;
      *reinterpret_cast<uint4*>(s + r * lds + c) =
          (r < nv && c < nc) ? *reinterpret_cast<const uint4*>(g + (size_t)r * nc + c) : zero;
    }
  } else {
    for (int e = threadIdx.x; e < kRows * ncp; e += kThreads) {
      const int r = e / ncp, c = e % ncp;
      s[r * lds + c] = (r < nv && c < nc) ? g[(size_t)r * nc + c] : __float2bfloat16(0.f);
    }
  }
}

// rows [0, nv) x columns [0, nc) of a shared tile to a row-major global matrix of nc columns
__device__ __forceinline__ void store_tile(bf16* g, const bf16* s, int lds, int nc, int nv) {
  if ((nc & 7) == 0) {
    const int vecs = nc / 8;
    for (int e = threadIdx.x; e < nv * vecs; e += kThreads) {
      const int r = e / vecs, c = (e % vecs) * 8;
      *reinterpret_cast<uint4*>(g + (size_t)r * nc + c) = *reinterpret_cast<const uint4*>(s + r * lds + c);
    }
  } else {
    for (int e = threadIdx.x; e < nv * nc; e += kThreads) {
      const int r = e / nc, c = e % nc;
      g[(size_t)r * nc + c] = s[r * lds + c];
    }
  }
}

// st = bf(style + fixed) in place, columns < cs
__device__ __forceinline__ void add_fixed_row(bf16* st, int lds, const bf16* fixed, int cs) {
  for (int e = threadIdx.x; e < kRows * cs; e += kThreads) {
    const int r = e / cs, c = e % cs;
    st[r * lds + c] = __float2bfloat16(f(st[r * lds + c]) + f(fixed[c]));
  }
}

// u of element (row, c) of the tile from the staged h
__device__ __forceinline__ float u_of(const Args& a, float h, int c) {
  return affine_u(norm_hat(h, a.m[c], a.r[c]), a.a[c], a.b[c]);
}

// Spatial modulation, 16 columns a warp at a time: gamma/beta from the SPADE
// hidden tile (two products sharing it), then emit(row, col, u, gamma, s)
// with u recomputed from the staged h.
template <typename Emit>
__device__ __forceinline__ void spatial_modulation(const Args& a, const bf16* hbuf, int ldh,
                                                   const bf16* act, int lda, float* scratch, Emit emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n0 = warp * 16; n0 < a.cip; n0 += kWarps * 16) {
    FragC accg[kRowTiles], accb[kRowTiles];
    warp_gemm2<kRowTiles>(act, lda, a.g_w, a.bt_w, a.cip, n0, a.hidp, accg, accb);
    const int c = n0 + (lane & 15);
#pragma unroll
    for (int m = 0; m < kRowTiles; ++m) {
      float gamma[8];  // this lane's elements e = lane + 32 i
      stage(scratch, accg[m]);
#pragma unroll
      for (int i = 0; i < 8; ++i) gamma[i] = bf(bf(scratch[lane + 32 * i] + a.g_b[c]) + 1.f);
      __syncwarp();
      stage(scratch, accb[m]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = m * 16 + ((lane + 32 * i) >> 4);
        const float beta = bf(scratch[lane + 32 * i] + a.bt_b[c]);
        const float u = u_of(a, f(hbuf[row * ldh + c]), c);
        emit(row, c, gamma[i], modulate(u, gamma[i], beta));
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) half_block_fwd(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bimg = blockIdx.y, p0 = blockIdx.x * kRows, nv = min(kRows, a.HW - p0);
  const int warp = threadIdx.x >> 5;
  const int ld = smem_ld(max(max(a.cip, a.cop), a.csp)), lda = smem_ld(a.hidp);
  bf16* hbuf = reinterpret_cast<bf16*>(smem);  // h, then the output tile
  bf16* tbuf = hbuf + kRows * ld;               // style, then t
  bf16* act = tbuf + kRows * ld;                // SPADE hidden
  float* scratch = reinterpret_cast<float*>(act + kRows * lda) + warp * 256;
  bf16* ring = reinterpret_cast<bf16*>(reinterpret_cast<float*>(act + kRows * lda) + kWarps * 256);
  const size_t px0 = (size_t)bimg * a.HW + p0;

  load_tile(hbuf, ld, a.h + px0 * a.ci, a.ci, a.cip, nv);
  if (a.spatial) load_tile(tbuf, ld, a.style + px0 * a.cs, a.cs, a.csp, nv);
  __syncthreads();
  if (a.spatial) {
    if (a.add_fixed) {
      add_fixed_row(tbuf, ld, a.fixed + (size_t)bimg * a.cs, a.cs);
      __syncthreads();
    }
    layer(tbuf, ld, a.sh_w, a.hidp, a.csp, a.hidp, ring, scratch,
          [&](int r, int c, float v) { act[r * lda + c] = __float2bfloat16(fmaxf(v + a.sh_b[c], 0.f)); });
    __syncthreads();
    spatial_modulation(a, hbuf, ld, act, lda, scratch, [&](int r, int c, float, float s) {
      tbuf[r * ld + c] = __float2bfloat16(lrelu_bf(s));
    });
  } else {
    const bf16* gr = a.gam + (size_t)bimg * a.cip;
    const bf16* br = a.bet + (size_t)bimg * a.cip;
    for (int e = threadIdx.x; e < kRows * a.cip; e += kThreads) {
      const int r = e / a.cip, c = e % a.cip;
      const float s = modulate(u_of(a, f(hbuf[r * ld + c]), c), f(gr[c]), f(br[c]));
      tbuf[r * ld + c] = __float2bfloat16(lrelu_bf(s));
    }
  }
  __syncthreads();
  layer(tbuf, ld, a.w, a.cop, a.cip, a.cop, ring, scratch,
        [&](int r, int c, float v) { hbuf[r * ld + c] = __float2bfloat16(v + a.c[c]); });
  __syncthreads();
  store_tile(a.out + px0 * a.co, hbuf, ld, a.co, nv);
}

__host__ __device__ constexpr int imax(int x, int y) { return x > y ? x : y; }

size_t fwd_smem(const Args& a) {
  return sizeof(bf16) * kRows * (2 * smem_ld(imax(imax(a.cip, a.cop), a.csp)) + smem_ld(a.hidp)) +
         sizeof(float) * kWarps * 256 + sizeof(bf16) * kWeightRing;
}

int check_args(const Args& a) {
  if (a.cip % 16 || a.cop % 16 || a.csp % 16 || a.hidp % 16 || a.ci > a.cip || a.co > a.cop ||
      a.cs > a.csp || a.B < 1 || a.HW < 1 || a.cip < 16 || a.cop < 16 ||
      (a.spatial && (a.cs < 1 || a.hidp < 16)))
    return (int)cudaErrorInvalidValue;
  return 0;
}

int launch(const Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = half_block_fwd;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.HW + kRows - 1) / kRows, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int thgt_half_block_fwd(const bf16* h, const bf16* style, const bf16* fixed, const bf16* gam,
                                   const bf16* bet, const float* m, const float* r, const float* sa,
                                   const float* sb, const bf16* sh_w, const float* sh_b, const bf16* g_w,
                                   const float* g_b, const bf16* bt_w, const float* bt_b, const bf16* w,
                                   const float* c, bf16* out, int B, int HW, int ci, int cs, int co,
                                   int cip, int csp, int cop, int hidp, int spatial, int add_fixed,
                                   cudaStream_t stream) {
  Args a{h, style, fixed, gam, bet, m, r, sa, sb, sh_w, sh_b, g_w, g_b, bt_w, bt_b, w, c, out,
         B, HW, ci, cs, co, cip, csp, cop, hidp, spatial, add_fixed};
  if (int err = check_args(a)) return err;
  return launch(a, fwd_smem(a), stream);
}
