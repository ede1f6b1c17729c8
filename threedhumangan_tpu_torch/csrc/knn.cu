// K6: 1-NN of every field point among the posed SMPL vertices — the squared
// distance and the index, lowest index on exact ties.
//
// Replaces threedhumangan_tpu/ops/knn.py::_nn_kernel (Pallas, TPU), which
// the JAX generator runs for the geo features when the fused geo kernel (K1)
// is off (``pallas_geo=False``, ``pallas_knn=True``).
//
// What bounds it on an H100: points x vertices distance evaluations
// (147,456 x 6,890 per image at the 512L shape, 8.1e9 per batch of 8), ~9
// FP32 instructions each — bound by the FP32 instruction rate, as K1's
// scan; the output (8 bytes a point) is a minor byte stream.
//
// Design: K1's scan without the features (nn_scan.cuh): one thread per
// point, 256 points per CTA, the image's vertices staged through shared
// memory in chunks of 2,048 (every thread reads the same vertex: a
// broadcast), the distance formed in the plain version's elementwise op
// order so that the argmin is bit-identical to it.  The TPU kernel's padded
// vertex tiles and its clamp of the expanded form's negative rounding have
// no counterpart: V is scanned exactly and the elementwise distance is >= 0.
#include <cuda_runtime.h>

#include "nn_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // vertices staged per pass: 2048 x 16 B = 32 KB

__global__ void __launch_bounds__(kThreads) nn_kernel(const float* __restrict__ pts,
                                                      const float* __restrict__ verts,
                                                      float* __restrict__ dist,
                                                      int* __restrict__ idx, int P, int V) {
  __shared__ float4 sv[kChunk];
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = p < P;
  const float* pb = pts + ((size_t)b * P + (valid ? p : 0)) * 3;
  float best;
  int best_i;
  thgt::nn_scan_cta(verts + (size_t)b * V * 3, V, sv, kChunk, pb[0], pb[1], pb[2], best, best_i);
  if (!valid) return;
  dist[(size_t)b * P + p] = best;
  idx[(size_t)b * P + p] = best_i;
}

}  // namespace

extern "C" int thgt_nn(const float* pts, const float* verts, float* dist, int* idx, int B, int P,
                       int V, cudaStream_t stream) {
  if (B <= 0 || P <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((P + kThreads - 1) / kThreads, B);
  nn_kernel<<<grid, kThreads, 0, stream>>>(pts, verts, dist, idx, P, V);
  return (int)cudaGetLastError();
}
