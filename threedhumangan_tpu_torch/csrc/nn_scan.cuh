// The 1-NN distance, tie rule and vertex staging of K5's scan (field_core.cuh),
// whose distance and tie rule K1's and K6's pruned search (nn_prune.cuh) use too.
//
// The squared distance is formed elementwise, ((px-vx)^2 + (py-vy)^2) +
// (pz-vz)^2, with __fsub_rn/__fmul_rn/__fadd_rn: every op rounded once and
// none contracted to an FMA, in the order of the plain PyTorch versions'
// elementwise ops (ops/geo.py::nearest_vertex).  So the distances, and with
// the lowest index winning exact ties the argmin, are bit-identical to the
// plain versions'.  (The TPU kernels expand |p|^2 - 2 p.v + |v|^2 for the
// MXU; a K=3 product is no tensor-core shape here.)
#pragma once

#include <cuda_runtime.h>

namespace thgt {

__device__ __forceinline__ float nn_dist(float px, float py, float pz, float4 v) {
  const float dx = __fsub_rn(px, v.x), dy = __fsub_rn(py, v.y), dz = __fsub_rn(pz, v.z);
  float d = __fmul_rn(dx, dx);
  d = __fadd_rn(d, __fmul_rn(dy, dy));
  return __fadd_rn(d, __fmul_rn(dz, dz));
}

// (d, i) beats (best, best_i): a smaller distance, or an equal one at a lower index
__device__ __forceinline__ bool nn_better(float d, int i, float best, int best_i) {
  return d < best || (d == best && i < best_i);
}

// Stage vertices [v0, v0 + n) of one image (vb: (V, 3) float32) into shared
// memory as float4.  Every thread of the CTA must call it; it synchronises
// before (the previous chunk may still be read) and after.
__device__ __forceinline__ void nn_stage(const float* vb, int v0, int n, float4* sv) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* v = vb + (size_t)(v0 + i) * 3;
    sv[i] = make_float4(v[0], v[1], v[2], 0.f);
  }
  __syncthreads();
}

}  // namespace thgt
