// K4: unfolded FiLM-SIREN field render with front-to-back compositing, on
// K3's core (synthesis_core.cuh).
//
// Replaces threedhumangan_tpu/ops/raymarch.py::_raymarch_kernel (Pallas,
// TPU): the JAX generator's field kernel under pallas_fold_film=False or
// pallas_march_loop=True, for any field with fewer than 2 trunk blocks, and
// the forward of the G step's render under those flags (K8/K9 backward).
// Its step_pack and march_loop options schedule the TPU's MXU and VMEM; the
// math is the same, and here they select this one kernel.
//
// What bounds it on an H100: as K2, ~2.5 MFLOP of bf16 products a sample
// at width 420 (3.0 TFLOP per batch of 8 x 147,456 samples, 3.0 ms at the
// bf16 peak) plus ~2,900 sines a sample, with small inputs (38 floats) and
// outputs (424 floats a ray); unlike K2 every activation element also takes
// a FiLM multiply and add with its image's freq/phase.  Every 64-row CTA
// streams the forward weights (3.0 MB at width 420, the same for every
// image) from L2.
//
// Design: field_core.cuh's field_kernel<kRender>, K8's forward (the
// unfolded products from one stream for every image, FiLM and omega in the
// register epilogues, sigma as column H of the colour product) with K2's
// per-CTA composite.  It rounds the CTA's 64 float32 packed rows itself:
// the 34 coordinate and geo columns to bf16 (the product operands the JAX
// kernel forms), the directions to bf16 values, and keeps the noise column
// in float32, as the JAX kernel adds it to sigma.
#include "field_core.cuh"

extern "C" int thgt_raymarch_unfolded(const float* packed, const float* z, const void* wstream,
                                      const float* b_first, const float* b_net, const float* freq,
                                      const float* phase, const float* w_color_d, const float* w_sigma,
                                      const float* b_color, const float* b_sigma, const float* b_head,
                                      float* out, float* depth, int B, int P, int S, int n_cols, int n_in,
                                      int H, int k0p, int n0p, int hp, int nc, int headp, int n_blocks,
                                      int width, int exact_sin, int white_back, int last_back,
                                      long long stream_bytes, cudaStream_t stream) {
  Args a{};
  a.raw = packed, a.z = z, a.out = out, a.depth = depth, a.white_back = white_back, a.last_back = last_back;
  set_field(a, b_first, b_net, freq, phase, w_color_d, w_sigma, b_color, b_sigma, b_head, B, P, S, n_cols, n_in,
            H, k0p, n0p, hp, nc, headp, n_blocks, width);
  return launch<kRender>(a, wstream, stream_bytes, exact_sin, stream);
}
