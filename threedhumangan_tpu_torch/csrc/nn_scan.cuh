// The 1-NN scan shared by K1 (geo.cu), K6 (knn.cu) and K5 (field_core.cuh).
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

// One thread per point: scan all V vertices of the image in chunks of
// `chunk` staged in `sv`, keeping the running (best, best_i) with a
// strict-less compare, so the lowest index wins exact ties.  Every thread
// of the CTA must call it (threads without a point pass any coordinates).
__device__ __forceinline__ void nn_scan_cta(const float* vb, int V, float4* sv, int chunk, float px,
                                            float py, float pz, float& best, int& best_i) {
  best = __int_as_float(0x7f800000);  // +inf
  best_i = 0;
  for (int v0 = 0; v0 < V; v0 += chunk) {
    const int n = min(chunk, V - v0);
    nn_stage(vb, v0, n, sv);
    for (int i = 0; i < n; ++i) {
      const float d = nn_dist(px, py, pz, sv[i]);
      if (d < best) {
        best = d;
        best_i = v0 + i;
      }
    }
  }
}

}  // namespace thgt
