// The vertex clusters that K1 (geo.cu) and K6 (knn.cu) search
// (nn_prune.cuh): per image, the posed vertices in Morton order cut into
// clusters of 32, each cluster's members in ascending original index and
// padded with NaN vertices, and each cluster's box.  The plain version is
// ops/geo.py::vertex_clusters_plain; the two agree bit for bit.
//
// What bounds it on an H100: nothing of the card: a few hundred KB a batch
// and one CTA an image (8 of 132 SMs), so its time is the latency of the
// sort's 91 barrier-separated passes over 8,192 keys.  It runs once per K1
// or K6 call and its time counts in theirs.  It is a kernel, not PyTorch
// glue, because its plain version's PyTorch ops take about 14 times as long
// on the card (chip_smoke.py times both; PERF.md section 6).
//
// Design: one 1024-thread CTA an image, the image's vertices copied into
// shared memory first.  The image's box gives each vertex a 6-bit cell a
// coordinate ((v - lo) * (63 / extent), truncated, each op rounded once as
// the plain version's), the cells' bits interleave into an 18-bit Morton
// code, and a bitonic sort in shared memory orders the 32-bit keys (code <<
// 13 | index), which are distinct, so the order is the plain argsort's.
// (A finer code, 30 bits in 64-bit keys, scanned the same pairs and was
// slower on an H100.)  Then a warp a cluster sorts its 32 members by index (a
// warp bitonic sort by shuffles), writes them as float4 (x, y, z, index bits)
// and reduces their box.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nn_prune.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kCells = 64;      // cells a coordinate: an 18-bit Morton code
constexpr int kIndexBits = 13;  // the key's low bits: the index, < kMaxVerts
static_assert(nnp::kMaxVerts <= 1 << kIndexBits, "the index must fit the key");

// the 6 low bits of x spread to every third bit
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  x &= 0x3fu;
  x = (x | (x << 8)) & 0x0000f00fu;
  x = (x | (x << 4)) & 0x000c30c3u;
  return (x | (x << 2)) & 0x00249249u;
}

__global__ void __launch_bounds__(kThreads) cluster_kernel(const float* __restrict__ verts,
                                                           float4* __restrict__ table,
                                                           float4* __restrict__ boxes, int V,
                                                           int n_clusters, int n_keys) {
  extern __shared__ uint32_t keys[];  // n_keys, then the vertices (V x 3 floats)
  __shared__ float red[32][6];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* vb = reinterpret_cast<float*>(keys + n_keys);
  const float inf = __int_as_float(nnp::kInfBits);
  for (int i = tid; i < V * 3; i += kThreads) vb[i] = verts[(size_t)b * V * 3 + i];
  __syncthreads();

  // the image's box
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  for (int i = tid; i < V; i += kThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], vb[3 * i + a]);
      hi[a] = fmaxf(hi[a], vb[3 * i + a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = nnp::warp_min(lo[a]);
    hi[a] = nnp::warp_max(hi[a]);
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) red[warp][a] = lo[a], red[warp][3 + a] = hi[a];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = nnp::warp_min(red[lane][a]);
    hi[a] = nnp::warp_max(red[lane][3 + a]);
  }

  // keys: the Morton code of the vertex's cell, then its index
  float scale[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) scale[a] = __fdiv_rn(kCells - 1.f, fmaxf(__fsub_rn(hi[a], lo[a]), 1e-30f));
  for (int i = tid; i < n_keys; i += kThreads) {
    uint32_t key = ~0u;
    if (i < V) {
      uint32_t code = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float q = __fmul_rn(__fsub_rn(vb[3 * i + a], lo[a]), scale[a]);
        code |= spread(min(__float2int_rz(q), kCells - 1)) << a;
      }
      key = (code << kIndexBits) | (uint32_t)i;
    }
    keys[i] = key;
  }
  __syncthreads();

  // bitonic sort, ascending: a thread a pair (i, i + j)
  for (int k = 2; k <= n_keys; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < n_keys / 2; q += kThreads) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const uint32_t x = keys[i], y = keys[i + j];
        if ((x > y) == ((i & k) == 0)) {
          keys[i] = y;
          keys[i + j] = x;
        }
      }
      __syncthreads();
    }
  }

  // a warp a cluster: members by index, the table row, the box
  for (int c = warp; c < n_clusters; c += kThreads / 32) {
    const int r = c * nnp::kCluster + lane;
    int m = r < V ? (int)(keys[r] & ((1u << kIndexBits) - 1)) : 0x7fffffff;
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const int o = __shfl_xor_sync(nnp::kFull, m, j);
        m = (((lane & j) == 0) == ((lane & k) == 0)) ? min(m, o) : max(m, o);
      }
    }
    const bool real = m != 0x7fffffff;
    const float nan = __int_as_float(0x7fc00000);
    const float x = real ? vb[3 * m] : nan, y = real ? vb[3 * m + 1] : nan,
                z = real ? vb[3 * m + 2] : nan;
    table[((size_t)b * n_clusters * nnp::kCluster) + r] = make_float4(x, y, z, __int_as_float(m));
    const float mnx = nnp::warp_min(real ? x : inf), mny = nnp::warp_min(real ? y : inf),
                mnz = nnp::warp_min(real ? z : inf);
    const float mxx = nnp::warp_max(real ? x : -inf), mxy = nnp::warp_max(real ? y : -inf),
                mxz = nnp::warp_max(real ? z : -inf);
    if (lane == 0) {
      float4* box = boxes + ((size_t)b * n_clusters + c) * 2;
      box[0] = make_float4(mnx, mny, mnz, 0.f);
      box[1] = make_float4(mxx, mxy, mxz, 0.f);
    }
  }
}

}  // namespace

// verts (B, V, 3) -> table (B, n_clusters * 32, 4) and boxes (B, n_clusters,
// 8), float32; n_clusters = ceil(V / 32).
extern "C" int thgt_nn_clusters(const float* verts, float* table, float* boxes, int B, int V,
                                int n_clusters, cudaStream_t stream) {
  if (B <= 0 || V <= 0 || V > nnp::kMaxVerts) return (int)cudaErrorInvalidValue;
  if (n_clusters != (V + nnp::kCluster - 1) / nnp::kCluster) return (int)cudaErrorInvalidValue;
  int n_keys = 1;
  while (n_keys < V) n_keys <<= 1;
  const size_t smem = (size_t)(n_keys + V * 3) * 4;
  cudaError_t err =
      cudaFuncSetAttribute(cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cluster_kernel<<<B, kThreads, smem, stream>>>(verts, reinterpret_cast<float4*>(table),
                                                reinterpret_cast<float4*>(boxes), V, n_clusters,
                                                n_keys);
  return (int)cudaGetLastError();
}
