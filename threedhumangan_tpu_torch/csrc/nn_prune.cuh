// The pruned 1-NN search of K1 (geo.cu) and K6 (knn.cu): an exact
// warp-tiled scan that skips vertex clusters by a conservative lower bound.
//
// Inputs: the image's vertex clusters as nn_clusters.cu builds them (the
// plain version is ops/geo.py::vertex_clusters_plain): a table of kCluster
// float4 (x, y, z, original index as int bits) a cluster, clusters in Morton
// order, each cluster's members in ascending original index and padded with
// NaN vertices that never win; and each cluster's box as two float4 (min,
// max).
//
// A warp takes one tile of 32 points (tile_point: one step pair over a 4 x 4
// patch of rays when the caller passes the points' ray layout, else 32
// consecutive points; tests/test_torch_nn_prune.py mirrors the map).  Each
// lane forms the squared lower bound between the warp's point box and the
// boxes of its clusters (lane + 32 j) with nn_dist's rounded ops in its
// order, from per-axis gaps no larger than any pair's rounded |dx|: every
// correctly rounded op is monotone, so the bound is <= the distance
// nn_dist computes for every (point, member) pair and needs no further
// margin.  The warp then visits the clusters in ascending order of that
// bound (a warp min over keys of the bound's upper 24 bits and the
// cluster's number: the key's bound is truncated toward zero, so it stays
// a lower bound) and stops at the first whose bound exceeds the largest
// current best of its valid lanes.  No vertex of a cluster left out can
// then win or tie.  A visited cluster is scanned in ascending index with a
// strict-less compare from +inf, and merged into the lane's best with
// nn_better on original indices, so the visiting order cannot change the
// argmin: the result is nearest_vertex's, bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "nn_scan.cuh"
#include "synthesis_core.cuh"

namespace nnp {

constexpr int kCluster = 32;                          // vertices a cluster, one a lane in the build
constexpr int kMaxVerts = 8192;                       // the table in shared memory: <= 128 KB
constexpr int kMaxClusters = kMaxVerts / kCluster;    // 256: a cluster's number fits 8 bits
constexpr int kKeysPerLane = kMaxClusters / 32;
constexpr int kWarps = 16;                            // tiles a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kPatchCols = 4, kPatchRows = 4, kPatchSteps = 2;  // a tile: 4 x 4 rays x 2 steps
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kInfBits = 0x7f800000u;

// The tiles of one image's P points.  row_len > 0: the points are rays x
// steps, rays row-major with row_len rays a row and `steps` points a ray.
struct Tiles {
  int P, row_len, steps, rays, step_pairs, patch_cols, count;
};

inline Tiles make_tiles(int P, int row_len, int steps) {
  Tiles t{P, row_len, steps, 0, 0, 0, (P + 31) / 32};
  if (row_len > 0) {
    t.rays = P / steps;
    const int rows = (t.rays + row_len - 1) / row_len;
    t.step_pairs = (steps + kPatchSteps - 1) / kPatchSteps;
    t.patch_cols = (row_len + kPatchCols - 1) / kPatchCols;
    t.count = t.step_pairs * t.patch_cols * ((rows + kPatchRows - 1) / kPatchRows);
  }
  return t;
}

// The point of `lane` in tile `tile`, or -1 (a ragged patch or the end).
// The step pair runs fastest, so a CTA's tiles cover a patch's rays whole.
__device__ __forceinline__ int tile_point(const Tiles& t, int tile, int lane) {
  if (t.row_len <= 0) {
    const int p = tile * 32 + lane;
    return p < t.P ? p : -1;
  }
  const int patch = tile / t.step_pairs;
  const int s = (tile % t.step_pairs) * kPatchSteps + (lane >> 4);
  const int c = (patch % t.patch_cols) * kPatchCols + (lane & 3);
  const int r = (patch / t.patch_cols) * kPatchRows + ((lane >> 2) & 3);
  const int ray = r * t.row_len + c;
  return (c < t.row_len && s < t.steps && ray < t.rays) ? ray * t.steps + s : -1;
}

// Thread 0 starts the copy of the image's table (n_clusters x kCluster
// float4) into `sv` on `bar`; the CTA must __syncthreads() after it before
// any thread waits on `bar` (the barrier's init).
__device__ __forceinline__ void stage_table(const float4* table, int n_clusters, float4* sv,
                                            uint64_t* bar) {
  if (threadIdx.x == 0) {
    const uint32_t bytes = (uint32_t)n_clusters * kCluster * sizeof(float4);
    syn::mbar_init(bar, 1);
    syn::mbar_fence_init();
    syn::mbar_expect_tx(bar, bytes);
    syn::bulk_copy(sv, table + (size_t)blockIdx.y * n_clusters * kCluster, bytes, bar);
  }
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// The per-axis gap between [lo, hi] and the box [mn, mx], rounded as
// nn_dist rounds a difference: no larger than |p - v| for p, v inside.
__device__ __forceinline__ float gap(float lo, float hi, float mn, float mx) {
  return fmaxf(fmaxf(__fsub_rn(mn, hi), __fsub_rn(lo, mx)), 0.f);
}

// The 1-NN of the lane's point (px, py, pz) among the image's V vertices,
// whose n_clusters clusters are staged in `sv` (ready when `bar` completes)
// with their boxes in `boxes` (this image's, global).  Every lane of the
// warp calls it; `valid` lanes own a point.  Returns the squared distance
// and original index in best / best_i (index 0 if no distance is below
// +inf, as argmin's first index).  kCount adds the (point, vertex) pairs
// scanned to `pairs`.
template <bool kCount>
__device__ __forceinline__ void warp_search(const float4* sv, uint64_t* bar, const float4* boxes,
                                            int n_clusters, int V, bool valid, float px, float py,
                                            float pz, float& best, int& best_i,
                                            unsigned long long& pairs) {
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(kInfBits);
  const float lx = warp_min(valid ? px : inf), hx = warp_max(valid ? px : -inf);
  const float ly = warp_min(valid ? py : inf), hy = warp_max(valid ? py : -inf);
  const float lz = warp_min(valid ? pz : inf), hz = warp_max(valid ? pz : -inf);
  uint32_t key[kKeysPerLane];
#pragma unroll
  for (int j = 0; j < kKeysPerLane; ++j) {
    const int c = lane + 32 * j;
    key[j] = 0xffffffffu;
    if (c < n_clusters) {
      const float4 mn = __ldg(boxes + 2 * c), mx = __ldg(boxes + 2 * c + 1);
      const float gx = gap(lx, hx, mn.x, mx.x), gy = gap(ly, hy, mn.y, mx.y),
                  gz = gap(lz, hz, mn.z, mx.z);
      const float lb = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), __fmul_rn(gz, gz));
      key[j] = (__float_as_uint(lb) & ~0xffu) | (uint32_t)c;
    }
  }
  const uint32_t n_valid = __popc(__ballot_sync(kFull, valid));
  syn::mbar_wait(bar, 0);
  best = inf;
  best_i = 0x7fffffff;
  uint32_t worst = kInfBits;  // the valid lanes' largest best, as bits (bests are >= 0)
  for (;;) {
    uint32_t m = key[0];
#pragma unroll
    for (int j = 1; j < kKeysPerLane; ++j) m = min(m, key[j]);
    const uint32_t k = __reduce_min_sync(kFull, m);
    if ((k & ~0xffu) > worst) break;  // also when every cluster was taken (k = ~0)
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) key[j] = key[j] == k ? 0xffffffffu : key[j];
    const int c = (int)(k & 0xffu);
    const float4* cv = sv + c * kCluster;
    float cb = inf;
    int ci = 0x7fffffff;
#pragma unroll 8
    for (int i = 0; i < kCluster; ++i) {
      const float4 v = cv[i];
      const float d = thgt::nn_dist(px, py, pz, v);
      if (d < cb) {
        cb = d;
        ci = __float_as_int(v.w);
      }
    }
    if (thgt::nn_better(cb, ci, best, best_i)) {
      best = cb;
      best_i = ci;
    }
    worst = __reduce_max_sync(kFull, valid ? __float_as_uint(best) : 0u);
    if (kCount) pairs += (unsigned long long)n_valid * min(kCluster, V - c * kCluster);
  }
  if (best_i == 0x7fffffff) best_i = 0;
}

// The search of K1's and K6's kernels up to their epilogues: thread 0
// stages the image's table, the CTA syncs (so shared memory the caller
// filled before the call is ready too), each warp takes its tile and
// searches it, and lane 0 adds the warp's scanned pairs to `pairs_out`
// (kCount only).  Returns false for a lane without a point, which then has
// nothing to write; a warp without any point waits for the bulk copy first,
// which must land before the CTA ends.
template <bool kCount>
__device__ __forceinline__ bool tile_search(const float* pts, const float4* table,
                                            const float4* boxes, unsigned long long* pairs_out,
                                            int P, int V, int n_clusters, const Tiles& tiles,
                                            float4* sv, uint64_t* bar, int& p, float& px,
                                            float& py, float& pz, float& best, int& best_i) {
  const int b = blockIdx.y;
  stage_table(table, n_clusters, sv, bar);
  __syncthreads();
  const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
  p = tile < tiles.count ? tile_point(tiles, tile, threadIdx.x & 31) : -1;
  const bool valid = p >= 0;
  if (!__any_sync(kFull, valid)) {
    syn::mbar_wait(bar, 0);
    return false;
  }
  const float* pb = pts + ((size_t)b * P + (valid ? p : 0)) * 3;
  px = pb[0];
  py = pb[1];
  pz = pb[2];
  unsigned long long pairs = 0;
  warp_search<kCount>(sv, bar, boxes + (size_t)b * n_clusters * 2, n_clusters, V, valid, px, py,
                      pz, best, best_i, pairs);
  if (kCount && (threadIdx.x & 31) == 0 && pairs) atomicAdd(pairs_out, pairs);
  return valid;
}

// Launches a K1 or K6 kernel over the tiles of B images: kWarps tiles a
// CTA, the image's table in dynamic shared memory.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), const Tiles& tiles, int B, int n_clusters,
           cudaStream_t stream, Args... args) {
  const size_t smem = (size_t)n_clusters * kCluster * sizeof(float4);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tiles.count + kWarps - 1) / kWarps, B);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Argument checks shared by the C entries; 0 when the launch may go ahead.
inline int check_args(int B, int P, int V, int n_clusters, int row_len, int steps) {
  if (B <= 0 || P <= 0 || V <= 0 || V > kMaxVerts) return (int)cudaErrorInvalidValue;
  if (n_clusters != (V + kCluster - 1) / kCluster) return (int)cudaErrorInvalidValue;
  if (row_len > 0 && (steps <= 0 || P % steps != 0)) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace nnp
