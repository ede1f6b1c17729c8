// K1: fused geo features — 1-NN over the posed SMPL vertices, gather of the
// nearest vertex's [blended inverse-FK 4x4 (16); T-pose xyz (3)] row, and the
// 31-d conditioning (24 joint distances, canonicalised coords, T-pose coords,
// nearest distance).
//
// Replaces threedhumangan_tpu/ops/geo.py::_geo_kernel (Pallas, TPU).
//
// What bounds it on an H100: the 1-NN scan is points x vertices distance
// evaluations (147,456 x 6,844 per image at the 512L shape, 8.1e9 per
// batch of 8), each ~9 FP32 instructions — FP32 issue-bound; the output
// (31 floats a point) is a minor byte stream.  A K=4 distance product is no
// tensor-core shape, so the TPU's MXU formulation does not carry over.
//
// Design: one thread per point, 256 points per CTA.  The CTA stages the
// image's vertex table into shared memory in chunks (every thread then reads
// the same vertex: a broadcast, no bank conflicts) and each thread scans it
// with a strict-less compare, which keeps the lowest index on exact ties
// (nn_scan.cuh, shared with K5 and K6: the distance is formed in the plain
// PyTorch version's elementwise op order, so the argmin is bit-identical to
// it).  The winner's 19-float feature row is one indexed global load (the
// TPU's one-hot gather matmul has no place here); joint distances read a
// shared-memory skeleton.
#include <cuda_runtime.h>

#include "nn_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;  // vertices staged per pass: 2048 x 16 B = 32 KB
constexpr int kMaxJoints = 32;
constexpr int kVfeat = 19;
constexpr int kGeo = 31;

__global__ void __launch_bounds__(kThreads) geo_kernel(
    const float* __restrict__ pts, const float* __restrict__ verts,
    const float* __restrict__ vfeat, const float* __restrict__ skel,
    float* __restrict__ out, int* __restrict__ idx_out, int P, int V, int J, int legacy) {
  __shared__ float4 sv[kChunk];
  __shared__ float sskel[kMaxJoints * 3];
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = p < P;
  const float* pb = pts + ((size_t)b * P + (valid ? p : 0)) * 3;
  const float px = pb[0], py = pb[1], pz = pb[2];
  for (int j = threadIdx.x; j < J * 3; j += kThreads) sskel[j] = skel[(size_t)b * J * 3 + j];

  float best;
  int best_i;
  thgt::nn_scan_cta(verts + (size_t)b * V * 3, V, sv, kChunk, px, py, pz, best, best_i);
  if (!valid) return;

  const float* g = vfeat + ((size_t)b * V + best_i) * kVfeat;
  float gf[kVfeat];
#pragma unroll
  for (int k = 0; k < kVfeat; ++k) gf[k] = g[k];
  float* o = out + ((size_t)b * P + p) * kGeo;
  const int jd0 = legacy ? 0 : 3;    // joint distances
  const int cano0 = legacy ? J : 0;  // canonical coords
  for (int j = 0; j < J; ++j) {
    const float dx = px - sskel[3 * j], dy = py - sskel[3 * j + 1], dz = pz - sskel[3 * j + 2];
    o[jd0 + j] = sqrtf(dx * dx + dy * dy + dz * dz + 1e-12f) / 2.4f;
  }
  const float c0 = gf[0] * px + gf[1] * py + gf[2] * pz + gf[3];
  const float c1 = gf[4] * px + gf[5] * py + gf[6] * pz + gf[7];
  const float c2 = gf[8] * px + gf[9] * py + gf[10] * pz + gf[11];
  o[cano0 + 0] = c0 / 2.0f;
  o[cano0 + 1] = (c1 + 0.2f) / 2.0f;
  o[cano0 + 2] = c2 / 1.3f;
  const int t0 = 3 + J;
  o[t0 + 0] = gf[16];
  o[t0 + 1] = gf[17];
  o[t0 + 2] = gf[18] / 0.2f;
  o[t0 + 3] = sqrtf(best) / 1.3f;
  idx_out[(size_t)b * P + p] = best_i;
}

}  // namespace

extern "C" int thgt_geo(const float* pts, const float* verts, const float* vfeat,
                        const float* skel, float* out, int* idx, int B, int P, int V, int J,
                        int legacy, cudaStream_t stream) {
  if (J > kMaxJoints || J + 7 != kGeo) return (int)cudaErrorInvalidValue;
  dim3 grid((P + kThreads - 1) / kThreads, B);
  geo_kernel<<<grid, kThreads, 0, stream>>>(pts, verts, vfeat, skel, out, idx, P, V, J, legacy);
  return (int)cudaGetLastError();
}
