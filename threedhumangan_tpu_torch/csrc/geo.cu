// K1: fused geo features — 1-NN over the posed SMPL vertices, gather of the
// nearest vertex's [blended inverse-FK 4x4 (16); T-pose xyz (3)] row, and the
// 31-d conditioning (24 joint distances, canonicalised coords, T-pose coords,
// nearest distance).
//
// Replaces threedhumangan_tpu/ops/geo.py::_geo_kernel (Pallas, TPU).
//
// What bounds it on an H100: the FP32 instructions of the distances the
// search must evaluate (~9 a (point, vertex) pair; a brute-force scan is
// 147,456 x 6,844 pairs per image at the 512L shape), or the output stream
// (31 floats a point) when the search scans few pairs.  A K=4 distance
// product is no tensor-core shape, so the TPU's MXU formulation does not
// carry over.
//
// Design: the pruned warp search of nn_prune.cuh on the clusters that
// nn_clusters.cu builds for each image (the wrapper launches both): a warp a
// tile of 32 points that lie close together (a step pair over a 4 x 4 patch
// of rays when the caller passes the ray layout), 16 warps a CTA, the
// image's cluster table staged into shared memory by one bulk copy while
// the warps form their clusters' lower bounds; only the clusters whose
// bound does not exceed the warp's largest current best are scanned, and
// the argmin is the plain version's bit for bit.  The winner's 19-float
// feature row is one indexed global load (the TPU's one-hot gather matmul
// has no place here); joint distances read a shared-memory skeleton.
#include <cuda_runtime.h>

#include "nn_prune.cuh"

namespace {

constexpr int kMaxJoints = 32;
constexpr int kVfeat = 19;
constexpr int kGeo = 31;

template <bool kCount>
__global__ void __launch_bounds__(nnp::kThreads, 2) geo_kernel(
    const float* __restrict__ pts, const float4* __restrict__ table,
    const float4* __restrict__ boxes, const float* __restrict__ vfeat,
    const float* __restrict__ skel, float* __restrict__ out, int* __restrict__ idx_out,
    unsigned long long* __restrict__ pairs_out, int P, int V, int n_clusters, int J, int legacy,
    nnp::Tiles tiles) {
  extern __shared__ float4 sv[];
  __shared__ float sskel[kMaxJoints * 3];
  __shared__ uint64_t bar;
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < J * 3; j += nnp::kThreads) sskel[j] = skel[(size_t)b * J * 3 + j];
  int p;
  float px, py, pz, best;
  int best_i;
  if (!nnp::tile_search<kCount>(pts, table, boxes, pairs_out, P, V, n_clusters, tiles, sv, &bar,
                                p, px, py, pz, best, best_i))
    return;

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

// table / boxes: ops/geo.py::vertex_clusters of the vertices; pairs: null,
// or a counter that receives the (point, vertex) pairs scanned; row_len > 0
// passes the points' ray layout (row_len rays a row, steps points a ray).
extern "C" int thgt_geo(const float* pts, const float* table, const float* boxes,
                        const float* vfeat, const float* skel, float* out, int* idx,
                        unsigned long long* pairs, int B, int P, int V, int n_clusters, int J,
                        int legacy, int row_len, int steps, cudaStream_t stream) {
  if (J > kMaxJoints || J + 7 != kGeo) return (int)cudaErrorInvalidValue;
  if (int err = nnp::check_args(B, P, V, n_clusters, row_len, steps)) return err;
  const nnp::Tiles tiles = nnp::make_tiles(P, row_len, steps);
  const auto go = [&](auto kernel) {
    return nnp::launch(kernel, tiles, B, n_clusters, stream, pts,
                       reinterpret_cast<const float4*>(table),
                       reinterpret_cast<const float4*>(boxes), vfeat, skel, out, idx, pairs, P,
                       V, n_clusters, J, legacy, tiles);
  };
  return pairs ? go(geo_kernel<true>) : go(geo_kernel<false>);
}
