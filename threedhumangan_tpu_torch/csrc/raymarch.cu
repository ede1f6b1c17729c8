// K2: folded FiLM-SIREN field render with front-to-back alpha compositing.
//
// Replaces threedhumangan_tpu/ops/raymarch.py::_raymarch_kernel_folded
// (Pallas, TPU).  Per sample: sin(in @ W_first + b) with the omega-scaled
// block-diagonal first layer, the trunk (per-image freq-folded weights, sin),
// sigma head, colour layer with the per-ray view-direction term hoisted,
// sigmoid-RGB + feature head; per ray: alpha-compositing over the steps in
// order (T *= 1 - alpha + 1e-12, delta 1e9 on the last step), residual
// transmittance to the last sample (last_back) and/or white (white_back),
// and the depth.  A packed width of n_in + 4 carries the training-time nerf
// noise, added to sigma before the relu clamp.
//
// What bounds it on an H100: ~2.5 MFLOP of matrix products per sample at
// width 420 (3.0 TFLOP per batch of 8 x 147,456 samples) plus ~2,900 sines
// per sample; the inputs (37 bf16 a sample) and outputs (424 floats a ray)
// are small.  Tensor-core work, but at this CTA shape the operand traffic
// bounds it, not the products: every 64-sample tile re-reads its image's
// 2.7 MB of tables from L2 through shared memory, and every warp reloads its
// A fragments from shared memory for each 16-deep step.  One 16-warp CTA
// fits an SM.
//
// Design: a CTA owns 64 sample rows = whole rays (64 / S of them) so the
// composite never leaves it.  Activations stay in shared memory in bf16
// (a 64 x 848 and a 64 x 432 buffer, ping-ponged); each layer's weights
// pass through a double-buffered shared-memory ring 16 rows at a time
// (cp.async, tile_mma.cuh), every B fragment feeding the CTA's four 16-row
// tiles; the epilogue applies bias and sin in float32 and writes bf16 back.
// The head epilogue reduces each ray's rows with its compositing weights
// straight into the output, so per-sample
// fields never exist outside the CTA.  Widths are zero-padded to multiples
// of 16 on the host (zero weights and biases keep padded channels at 0).
// pipe2 (a TPU VPU/MXU overlap schedule) has no counterpart here.
#include <cuda_runtime.h>

#include "tile_mma.cuh"

namespace {

using namespace thgt;

struct Args {
  const bf16* packed;      // (B, R*S, n_cols) ray-major samples
  const float* z;          // (B, R, S)
  const bf16* w_first;     // (k0p, n0p), omega folded
  const float* b_first;    // (n0p)
  const bf16* w_net0;      // (B, n0p, hp)
  const bf16* w_net_stk;   // (B, max(NB-1,1), hp, hp)
  const float* b_net;      // (B, NB, hp)
  const bf16* w_color_x;   // (B, hp, hp)
  const float* w_color_d;  // (B, 3, hp), bf16-rounded values
  const float* b_color;    // (B, hp)
  const float* w_sigma;    // (hp), bf16-rounded values
  const float* b_sigma;    // (1)
  const bf16* w_head;      // (hp, head_np): [rgb 3 | features F | 0]
  const float* b_head;     // (head_np)
  float* out;              // (B, R, out_width)
  float* depth;            // (B, R)
  int B, R, S, n_cols, n_in, k0p, n0p, hp, n_blocks, out_width, head_np;
  int white_back, last_back, exact_sin;
};

// the JAX package's degree-9 range-reduced sine
__device__ __forceinline__ float fast_sin(float x) {
  const float k = rintf(x * 0.15915494309189535f);
  const float y = x - k * 6.283185307179586f;
  const float y2 = y * y;
  return y * (0.999979407588f +
              y2 * (-0.166624416001f +
                    y2 * (0.00830899784978f + y2 * (-0.000192651914745f + y2 * 2.14797007513e-06f))));
}

__device__ __forceinline__ float act_sin(float x, int exact) { return exact ? sinf(x) : fast_sin(x); }

__global__ void __launch_bounds__(kThreads, 1) raymarch_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = a.S, hp = a.hp, rpc = kRows / S;
  const int b = blockIdx.y, ray0 = blockIdx.x * rpc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ldi = smem_ld(a.k0p), lda = smem_ld(a.n0p), ldb = smem_ld(hp);

  bf16* in_buf = reinterpret_cast<bf16*>(smem);
  bf16* buf_a = in_buf + kRows * ldi;
  bf16* buf_b = buf_a + kRows * lda;
  float* scratch_all = reinterpret_cast<float*>(buf_b + kRows * ldb);
  float* scratch = scratch_all + warp * 256;
  float* sigma = scratch_all + kWarps * 256;
  float* wrow = sigma + kRows;
  float* resid = wrow + kRows;
  float* dirs = resid + kRows;
  float* dpart = dirs + 3 * kRows;
  bf16* ring = reinterpret_cast<bf16*>(dpart + rpc * hp);  // weight chunks (tile_mma.cuh)

  // stage the tile's samples (bf16) and the per-ray view directions
  const size_t row0 = ((size_t)b * a.R + ray0) * S;
  for (int e = tid; e < kRows * a.k0p; e += kThreads) {
    const int r = e / a.k0p, c = e % a.k0p;
    in_buf[r * ldi + c] = c < a.n_in ? a.packed[(row0 + r) * a.n_cols + c] : __float2bfloat16(0.f);
  }
  for (int e = tid; e < rpc * 3; e += kThreads)
    dirs[e] = __bfloat162float(a.packed[(row0 + (e / 3) * S) * a.n_cols + a.n_in + e % 3]);
  __syncthreads();
  // hoisted colour-layer term of each ray: dirs @ W_color_d + b_color
  const float* wd = a.w_color_d + (size_t)b * 3 * hp;
  for (int e = tid; e < rpc * hp; e += kThreads) {
    const int r = e / hp, c = e % hp;
    const float v = dirs[r * 3] * wd[c] + dirs[r * 3 + 1] * wd[hp + c] + dirs[r * 3 + 2] * wd[2 * hp + c];
    dpart[e] = v + a.b_color[(size_t)b * hp + c];
  }

  // first layer (block-diagonal coords | geo), omega folded into W and b
  layer(in_buf, ldi, a.w_first, a.n0p, a.k0p, a.n0p, ring, scratch, [&](int r, int c, float v) {
    buf_a[r * lda + c] = __float2bfloat16(act_sin(v + a.b_first[c], a.exact_sin));
  });
  __syncthreads();
  // trunk layer 0 (2H -> H), then NB-1 (H -> H) layers, ping-ponging buffers
  const float* bn = a.b_net + (size_t)b * a.n_blocks * hp;
  layer(buf_a, lda, a.w_net0 + (size_t)b * a.n0p * hp, hp, a.n0p, hp, ring, scratch,
        [&](int r, int c, float v) { buf_b[r * ldb + c] = __float2bfloat16(act_sin(v + bn[c], a.exact_sin)); });
  __syncthreads();
  bf16* cur = buf_b;
  bf16* other = buf_a;
  const int n_stk = max(a.n_blocks - 1, 1);
  for (int i = 0; i + 1 < a.n_blocks; ++i) {
    const float* bi = bn + (size_t)(i + 1) * hp;
    bf16* dst = other;
    layer(cur, ldb, a.w_net_stk + ((size_t)b * n_stk + i) * hp * hp, hp, hp, hp, ring, scratch,
          [&](int r, int c, float v) { dst[r * ldb + c] = __float2bfloat16(act_sin(v + bi[c], a.exact_sin)); });
    __syncthreads();
    other = cur;
    cur = dst;
  }

  // sigma head: kRows / kWarps rows per warp, lanes split the channels
  for (int r = warp * (kRows / kWarps); r < (warp + 1) * (kRows / kWarps); ++r) {
    float s = 0.f;
    for (int c = lane; c < hp; c += 32) s += __bfloat162float(cur[r * ldb + c]) * a.w_sigma[c];
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      float noise = 0.f;
      if (a.n_cols > a.n_in + 3) noise = __bfloat162float(a.packed[(row0 + r) * a.n_cols + a.n_in + 3]);
      sigma[r] = s + a.b_sigma[0] + noise;
    }
  }
  __syncthreads();
  // front-to-back compositing weights, one thread per ray
  if (tid < rpc) {
    const float* zr = a.z + ((size_t)b * a.R + ray0 + tid) * S;
    float T = 1.f, w_sum = 0.f, dep = 0.f;
    for (int s = 0; s < S; ++s) {
      const float zs = zr[s];
      const float delta = s + 1 < S ? zr[s + 1] - zs : 1e9f;
      const float alpha = 1.f - expf(-delta * fmaxf(sigma[tid * S + s], 0.f));
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
  // colour FiLM layer with the hoisted per-ray term
  {
    bf16* dst = other;
    layer(cur, ldb, a.w_color_x + (size_t)b * hp * hp, hp, hp, hp, ring, scratch,
          [&](int r, int c, float v) {
      dst[r * ldb + c] = __float2bfloat16(act_sin(v + dpart[(r / S) * hp + c], a.exact_sin));
    });
  }
  __syncthreads();
  // heads + composite: each warp's column tiles, reduced over each ray's rows
  const bf16* xc = other;
  gemm_staged(xc, ldb, a.w_head, a.head_np, hp, a.head_np, ring,
              [&](int n0, FragC(&acc)[kRowTiles]) {
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
          part += wrow[row] * v;
          if ((row + 1) % S == 0) {
            const int ray = row / S;
            if (c < a.out_width)
              a.out[((size_t)b * a.R + ray0 + ray) * a.out_width + c] = part + resid[ray];
            part = 0.f;
          }
        }
      }
      __syncwarp();
    }
  });
}

}  // namespace

extern "C" int thgt_raymarch(const bf16* packed, const float* z, const bf16* w_first,
                             const float* b_first, const bf16* w_net0, const bf16* w_net_stk,
                             const float* b_net, const bf16* w_color_x, const float* w_color_d,
                             const float* b_color, const float* w_sigma, const float* b_sigma,
                             const bf16* w_head, const float* b_head, float* out, float* depth,
                             int B, int R, int S, int n_cols, int n_in, int k0p, int n0p, int hp,
                             int n_blocks, int out_width, int head_np, int white_back,
                             int last_back, int exact_sin, cudaStream_t stream) {
  if (S <= 0 || kRows % S || R % (kRows / S) || k0p % 16 || n0p % 16 || hp % 16 || head_np % 16 ||
      n0p < hp)
    return (int)cudaErrorInvalidValue;
  const int rpc = kRows / S;
  Args a{packed, z, w_first, b_first, w_net0, w_net_stk, b_net, w_color_x, w_color_d, b_color,
         w_sigma, b_sigma, w_head, b_head, out, depth, B, R, S, n_cols, n_in, k0p, n0p, hp,
         n_blocks, out_width, head_np, white_back, last_back, exact_sin};
  const size_t smem = sizeof(bf16) * kRows * (smem_ld(k0p) + smem_ld(n0p) + smem_ld(hp)) +
                      sizeof(float) * (kWarps * 256 + 3 * kRows + 3 * kRows + (size_t)rpc * hp) +
                      sizeof(bf16) * kWeightRing;
  cudaError_t err =
      cudaFuncSetAttribute(raymarch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(R / rpc, B);
  raymarch_kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
