// K4: unfolded FiLM-SIREN field render with front-to-back compositing.
//
// Replaces threedhumangan_tpu/ops/raymarch.py::_raymarch_kernel (Pallas,
// TPU): the JAX generator's field kernel under pallas_fold_film=False or
// pallas_march_loop=True, for any field with fewer than 2 trunk blocks, and
// the forward of the G step's render under those flags (K8/K9 backward).
// Its step_pack and march_loop options schedule the TPU's MXU and VMEM; the
// math is the same, and here they select this one kernel.
//
// What bounds it on an H100: as K2, ~2.5 MFLOP of bf16 products a sample
// at width 420 (3.0 TFLOP per batch of 8 x 147,456 samples) plus ~2,900
// sines a sample, with small inputs (38 floats) and outputs (424 floats a
// ray); unlike K2 every activation element also takes a FiLM multiply and
// add and reads its image's freq/phase.  Operand traffic through shared
// memory, not the tensor cores, sets its time at this CTA shape.
//
// Design: field_unfolded.cuh (the layout, products and composite, shared
// with K5).  This file stages the CTA's 64 rows of the float32 packed
// inputs: the 34 coordinate and geo columns rounded to bf16 (the product
// operands the JAX kernel forms), the 3 directions as bf16-rounded floats,
// and the noise column in float32, as the JAX kernel adds it to sigma.
#include <cuda_runtime.h>

#include "field_unfolded.cuh"

namespace {

using namespace thgt;

__global__ void __launch_bounds__(kThreads, 1)
    raymarch_unfolded_kernel(UnfoldedField a, const float* __restrict__ packed, int n_cols, int n_in) {
  extern __shared__ __align__(128) unsigned char smem[];
  const UnfoldedSmem s = unfolded_smem(smem, a.k0p, a.n0p, a.hp);
  const int rpc = kRows / a.S;
  const int b = blockIdx.y, ray0 = blockIdx.x * rpc;
  const int ldi = smem_ld(a.k0p);
  const float* pk = packed + ((size_t)b * a.R + ray0) * a.S * n_cols;
  for (int e = threadIdx.x; e < kRows * a.k0p; e += kThreads) {
    const int r = e / a.k0p, c = e % a.k0p;
    s.in_buf[r * ldi + c] = __float2bfloat16(c < n_in ? pk[(size_t)r * n_cols + c] : 0.f);
  }
  for (int e = threadIdx.x; e < kRows * 3; e += kThreads)
    s.dirs[e] = bf(pk[(size_t)(e / 3) * n_cols + n_in + e % 3]);
  for (int r = threadIdx.x; r < kRows; r += kThreads)
    s.noise[r] = n_cols > n_in + 3 ? pk[(size_t)r * n_cols + n_in + 3] : 0.f;
  __syncthreads();
  unfolded_field_body(a, s, b, ray0);
}

}  // namespace

extern "C" int thgt_raymarch_unfolded(const float* packed, const float* z, const bf16* w_first,
                                      const float* b_first, const bf16* w_net0, const bf16* w_net_stk,
                                      const float* b_net, const float* freq, const float* phase,
                                      const bf16* w_color_x, const float* w_color_d,
                                      const float* b_color, const float* w_sigma,
                                      const float* b_sigma, const bf16* w_head, const float* b_head,
                                      float* out, float* depth, int B, int R, int S, int n_cols,
                                      int n_in, int k0p, int n0p, int hp, int n_blocks,
                                      int out_width, int headp, int white_back, int last_back,
                                      int exact_sin, cudaStream_t stream) {
  UnfoldedField a{w_first, b_first, w_net0, w_net_stk, b_net, freq, phase, w_color_x, w_color_d,
                  b_color, w_sigma, b_sigma, w_head, b_head, z, out, depth, B, R, S, k0p, n0p, hp,
                  n_blocks, out_width, headp, white_back, last_back, exact_sin};
  if (int err = unfolded_check(a)) return err;
  if (n_in > k0p || n_cols < n_in + 3 || n_cols > n_in + 4) return (int)cudaErrorInvalidValue;
  const size_t smem = unfolded_smem_bytes(k0p, n0p, hp);
  cudaError_t err = cudaFuncSetAttribute(raymarch_unfolded_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(R / (kRows / S), B);
  raymarch_unfolded_kernel<<<grid, kThreads, smem, stream>>>(a, packed, n_cols, n_in);
  return (int)cudaGetLastError();
}
