// K8 + K9: backward of the field render (K2), on K3's core
// (synthesis_core.cuh).
//
// Replaces threedhumangan_tpu/ops/raymarch_bwd.py::_stats_kernel (K8) and
// ::_bwd_step_kernel (K9) (Pallas, TPU).  Both recompute the UNFOLDED
// FiLM-SIREN per sample (first layers sin(30 (x W + b)), trunk
// sin(f (x W + b) + p), colour layer over [dirs, x] with the last trunk
// slice's f/p, sigmoid-RGB and feature heads), with bf16 operands, bf16
// activations after each layer and float32 sums, as the JAX kernels do.
//
//   K8: sigma (+ the noise column) and sum_c g_out[ray, c] * field[c]
//       per sample.
//   K9: the recompute, then the backprop through the heads, colour layer,
//       trunk and first layers.  It writes, per layer, the bf16 operands of
//       the weight-gradient products (layer input X and output gradient dY)
//       and per-warp column sums (bias grads, and the freq/phase grads of
//       its image).
//   The weight gradients dW = sum over samples of X^T dY are reduced by
//       csrc/wgrad.cu (shared with K11): every chunk of rows writes its own
//       partial, and the host sums the partials in a fixed order.  No
//       atomics: the grads are the same from run to run.
//
// What bounds it on an H100: at hidden 384 the recompute is ~2 MFLOP of
// matrix products per sample and the backprop as much again (~2.2 TFLOP for
// 8 x 65,536 samples, 2.2 ms at the bf16 peak), the weight-gradient products
// ~1.1 TFLOP; K9's saved pre-activations (f32, written and read back) and
// bf16 product operands are ~11 KB + ~12 KB a sample through device memory
// (~5 ms a call at 3.35 TB/s).  Every 64-row CTA streams the weights from
// L2: the forward half (2.2 MB at hidden 384) for K8, both halves (4.2 MB)
// for K9.
//
// Design: field_core.cuh's field_kernel<kStats> (K8) and <kBwd> (K9), the
// unfolded SIREN on K3's core that K4 and K5 share; this file holds their
// C entries.
#include "field_core.cuh"

extern "C" int thgt_field_stats(const bf16* packed, const float* go, const void* wstream,
                                const float* b_first, const float* b_net, const float* freq,
                                const float* phase, const float* w_color_d, const float* w_sigma,
                                const float* b_color, const float* b_sigma, const float* b_head,
                                float* sigma, float* gdot, int B, int P, int S, int n_cols, int n_in,
                                int H, int k0p, int n0p, int hp, int nc, int headp, int n_blocks,
                                int width, int exact_sin, long long stream_bytes, cudaStream_t stream) {
  Args a{};
  a.packed = packed, a.go = go, a.sigma = sigma, a.gdot = gdot;
  set_field(a, b_first, b_net, freq, phase, w_color_d, w_sigma, b_color, b_sigma, b_head, B, P, S, n_cols, n_in,
            H, k0p, n0p, hp, nc, headp, n_blocks, width);
  return launch<kStats>(a, wstream, stream_bytes, exact_sin, stream);
}

extern "C" int thgt_field_bwd(const bf16* packed, const float* go, const float* coef, const float* dsig,
                              const void* wstream, const float* b_first, const float* b_net,
                              const float* freq, const float* phase, const float* w_color_d,
                              const float* w_sigma, const float* b_color, const float* b_sigma,
                              const float* b_head, bf16* x0, bf16* xs0, bf16* xsk, bf16* xcol, bf16* xc,
                              bf16* du, bf16* dv, bf16* dcol, bf16* dyh, float* U, float* V, float* VC,
                              float* part, float* hsum, int B, int P, int S, int n_cols, int n_in, int H,
                              int k0p, int n0p, int hp, int nc, int headp, int n_blocks, int width,
                              int exact_sin, long long stream_bytes, cudaStream_t stream) {
  Args a{packed, go, coef, dsig, nullptr, b_first, b_net, freq, phase, w_color_d, w_sigma, b_color,
         b_sigma, b_head, nullptr, nullptr, x0, xs0, xsk, xcol, xc, du, dv, dcol, dyh, U, V, VC, part, hsum,
         B, P, S, n_cols, n_in, H, k0p, n0p, hp, nc, headp, n_blocks, width, 0, 0};
  const void* bufs[] = {x0, xs0, xsk, xcol, xc, du, dv, dcol, dyh, U, V, VC, part, hsum};
  for (const void* p : bufs)
    if (reinterpret_cast<size_t>(p) & 15) return (int)cudaErrorInvalidValue;
  return launch<kBwd>(a, wstream, stream_bytes, exact_sin, stream);
}

// The shared memory thgt_field_stats and thgt_field_bwd (and K4's and K5's
// entries: every mode of field_core.cuh has one layout) give a CTA at these
// padded widths, in bytes (they refuse more than 232,448); ring[0] the
// ring's stages, ring[1] the bytes of a stage.
extern "C" int thgt_field_bwd_smem(int k0p, int n0p, int hp, int nc, int headp, int* ring) {
  ring[0] = kRingStages;
  ring[1] = stage_bytes(n0p, hp, nc, headp);
  return (int)field_smem(k0p, n0p, hp, headp, ring[1]);
}
