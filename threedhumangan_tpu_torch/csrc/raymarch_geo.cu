// K5: the unfolded field render (K4) with the 31 geo columns computed in the
// kernel from the raw sample points, on K3's core (synthesis_core.cuh): the
// 1-NN over the posed SMPL vertices, the winner's [blended inverse-FK 4x4
// (16); T-pose xyz (3)] row, joint distances, canonicalisation
// (ops/raymarch.py::geo_slab).
//
// Replaces threedhumangan_tpu/ops/raymarch.py::_raymarch_geo_kernel
// (Pallas, TPU), which the JAX generator runs under pallas_fuse_geo=True on
// inference and on the D step's fakes (never on the grad path).
//
// What bounds it on an H100: K4's field work (~3.0 TFLOP of bf16 products
// per batch of 8 x 147,456 samples at width 420) plus K1's scan, 8.1e9
// distance evaluations of ~9 FP32 instructions (1.1 ms at the f32 peak);
// inputs (7 floats a sample, the vertex tables) and outputs are small.
//
// Design: field_core.cuh's field_kernel<kGeo>: K4's kernel with a prologue
// that every thread of the CTA runs before the register split.  The
// producer lane first copies the ring's first stages, so the weights are in
// shared memory when the products start; then 8 threads a row scan the
// vertices (nn_scan.cuh's elementwise distance, lowest index first on ties)
// staged in the activation tiles, idle until the first layer, and write
// each row's geo columns into the input tile as bf16, the operands the JAX
// kernel forms.  The raw points are read in float32 (the scan and the joint
// distances must not see bf16 coordinates) and scaled by input_scaler here.
#include "field_core.cuh"

extern "C" int thgt_raymarch_geo(const float* packed, const float* z, const float* verts, const float* vfeat,
                                 const float* skel, int* idx_out, const void* wstream, const float* b_first,
                                 const float* b_net, const float* freq, const float* phase,
                                 const float* w_color_d, const float* w_sigma, const float* b_color,
                                 const float* b_sigma, const float* b_head, float* out, float* depth, int B,
                                 int P, int S, int n_cols, int n_in, int H, int k0p, int n0p, int hp, int nc,
                                 int headp, int n_blocks, int width, int exact_sin, int white_back,
                                 int last_back, int V, int J, int legacy, float scaler, long long stream_bytes,
                                 cudaStream_t stream) {
  Args a{};
  a.raw = packed, a.z = z, a.out = out, a.depth = depth, a.white_back = white_back, a.last_back = last_back;
  a.verts = verts, a.vfeat = vfeat, a.skel = skel, a.idx_out = idx_out, a.n_verts = V, a.n_joints = J;
  a.legacy = legacy, a.scaler = scaler;
  set_field(a, b_first, b_net, freq, phase, w_color_d, w_sigma, b_color, b_sigma, b_head, B, P, S, n_cols, n_in,
            H, k0p, n0p, hp, nc, headp, n_blocks, width);
  return launch<kGeo>(a, wstream, stream_bytes, exact_sin, stream);
}
