// K6: 1-NN of every field point among the posed SMPL vertices — the squared
// distance and the index, lowest index on exact ties.
//
// Replaces threedhumangan_tpu/ops/knn.py::_nn_kernel (Pallas, TPU), which
// the JAX generator runs for the geo features when the fused geo kernel (K1)
// is off (``pallas_geo=False``, ``pallas_knn=True``).
//
// What bounds it on an H100: the FP32 instructions of the distances the
// search must evaluate (~9 a (point, vertex) pair; a brute-force scan is
// 147,456 x 6,890 pairs per image at the 512L shape), as K1's search; the
// output (8 bytes a point) is a minor byte stream.
//
// Design: K1's search without the features (nn_prune.cuh on the clusters of
// nn_clusters.cu): a warp a tile of 32 points that lie close together, the
// image's cluster table staged into shared memory by one bulk copy, only the
// clusters whose lower bound does not exceed the warp's largest current
// best scanned, the distance formed in the plain version's elementwise op
// order so that the argmin is bit-identical to it.  The TPU kernel's padded
// vertex tiles and its clamp of the expanded form's negative rounding have
// no counterpart: the elementwise distance is >= 0.
#include <cuda_runtime.h>

#include "nn_prune.cuh"

namespace {

template <bool kCount>
__global__ void __launch_bounds__(nnp::kThreads, 2) nn_kernel(
    const float* __restrict__ pts, const float4* __restrict__ table,
    const float4* __restrict__ boxes, float* __restrict__ dist, int* __restrict__ idx,
    unsigned long long* __restrict__ pairs_out, int P, int V, int n_clusters, nnp::Tiles tiles) {
  extern __shared__ float4 sv[];
  __shared__ uint64_t bar;
  int p;
  float px, py, pz, best;
  int best_i;
  if (!nnp::tile_search<kCount>(pts, table, boxes, pairs_out, P, V, n_clusters, tiles, sv, &bar,
                                p, px, py, pz, best, best_i))
    return;
  dist[(size_t)blockIdx.y * P + p] = best;
  idx[(size_t)blockIdx.y * P + p] = best_i;
}

}  // namespace

// As thgt_geo (geo.cu): table / boxes from ops/geo.py::vertex_clusters,
// pairs null or a counter, row_len > 0 the points' ray layout.
extern "C" int thgt_nn(const float* pts, const float* table, const float* boxes, float* dist,
                       int* idx, unsigned long long* pairs, int B, int P, int V, int n_clusters,
                       int row_len, int steps, cudaStream_t stream) {
  if (int err = nnp::check_args(B, P, V, n_clusters, row_len, steps)) return err;
  const nnp::Tiles tiles = nnp::make_tiles(P, row_len, steps);
  const auto go = [&](auto kernel) {
    return nnp::launch(kernel, tiles, B, n_clusters, stream, pts,
                       reinterpret_cast<const float4*>(table),
                       reinterpret_cast<const float4*>(boxes), dist, idx, pairs, P, V,
                       n_clusters, tiles);
  };
  return pairs ? go(nn_kernel<true>) : go(nn_kernel<false>);
}
