// K5: the unfolded field render (K4) with the 31 geo columns computed in the
// kernel from the raw sample points: 1-NN over the posed SMPL vertices,
// the winner's [blended inverse-FK 4x4 (16); T-pose xyz (3)] row, joint
// distances, canonicalisation (ops/raymarch.py::geo_slab).
//
// Replaces threedhumangan_tpu/ops/raymarch.py::_raymarch_geo_kernel
// (Pallas, TPU), which the JAX generator runs under pallas_fuse_geo=True on
// inference and on the D step's fakes (never on the grad path).
//
// What bounds it on an H100: K4's field work (~3.0 TFLOP of bf16 products
// per batch of 8 x 147,456 samples at width 420) plus K1's scan, 8.1e9
// distance evaluations of ~9 FP32 instructions; inputs (7 floats a sample,
// the vertex tables) and outputs are small.
//
// Design: each CTA first computes the geo columns of its 64 rows, then runs
// K4's body (field_unfolded.cuh) on them.
//   - The 1-NN: 8 threads a row, each scanning every 8th vertex of the
//     chunks staged in shared memory, in ascending order with a strict-less
//     compare; the 8 partial minima merge by shuffles within the 8 lanes,
//     lower index first on equal distances.  The distance is nn_scan.cuh's
//     elementwise form (as K1 and K6), so the argmin is bit-identical to the
//     plain version's, lowest index on exact ties.
//   - The winner's 19-float row is one indexed global load per row (the
//     TPU's one-hot gather product has no place here).
//   - Joint distances in geo_slab's expanded form,
//     sqrt(max(|p|^2 - 2 p.s + |s|^2, 0) + 1e-12) / 2.4.
//   - Shared memory: K4's layout (219,392 bytes at hidden 420, see
//     field_unfolded.cuh) and nothing more.  The vertex chunks are staged
//     into the activation buffers (165,888 bytes: 10,368 vertices a chunk,
//     so 6,890 in one), which sit idle until the first layer; the joints go
//     into the accumulator staging area, idle as well.  The geo columns go
//     straight into the first-layer input tile as bf16, the operands the JAX
//     kernel forms: no 64 x 31 float scratch is needed.
//   - The raw points are read in float32 (the scan and the joint distances
//     must not see bf16 coordinates) and scaled by input_scaler here.
#include <cuda_runtime.h>

#include "field_unfolded.cuh"
#include "nn_scan.cuh"

namespace {

using namespace thgt;

constexpr int kVfeat = 19;
constexpr int kGeo = 31;
constexpr int kMaxJoints = 32;
constexpr int kPerRow = kThreads / kRows;  // threads scanning one row's vertices
static_assert(kPerRow == 8, "the 1-NN merge shuffles over 8 lanes");

struct GeoArgs {
  const float* packed;  // (B, R*S, 6 or 7) raw [x y z | dirs | noise]
  const float* verts;   // (B, V, 3) posed vertices
  const float* vfeat;   // (B, V, 19) [blended inverse-FK 16 | T-pose 3]
  const float* skel;    // (B, J, 3)
  int* idx_out;         // (B, R*S) nearest vertex, or null
  int n_cols, V, J, legacy;
  float scaler;
};

__global__ void __launch_bounds__(kThreads, 1) raymarch_geo_kernel(UnfoldedField a, GeoArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  const UnfoldedSmem s = unfolded_smem(smem, a.k0p, a.n0p, a.hp);
  const int rpc = kRows / a.S;
  const int b = blockIdx.y, ray0 = blockIdx.x * rpc;
  const int tid = threadIdx.x, r = tid / kPerRow, sub = tid % kPerRow;
  const size_t row0 = ((size_t)b * a.R + ray0) * a.S;
  const float* pr = g.packed + (row0 + r) * g.n_cols;
  const float px = pr[0], py = pr[1], pz = pr[2];

  // joints (xyz, |s|^2) into the accumulator staging area, idle until the first layer
  float* sk = s.scratch;
  float* ssq = sk + 3 * kMaxJoints;
  for (int j = tid; j < g.J; j += kThreads) {
    const float* q = g.skel + ((size_t)b * g.J + j) * 3;
    sk[3 * j] = q[0];
    sk[3 * j + 1] = q[1];
    sk[3 * j + 2] = q[2];
    ssq[j] = (q[0] * q[0] + q[1] * q[1]) + q[2] * q[2];
  }

  // 1-NN: vertex chunks staged into the idle activation buffers
  float4* sv = reinterpret_cast<float4*>(s.buf_a);
  const int chunk = (int)((reinterpret_cast<unsigned char*>(s.scratch) -
                           reinterpret_cast<unsigned char*>(s.buf_a)) / sizeof(float4));
  const float* vb = g.verts + (size_t)b * g.V * 3;
  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = 0;
  for (int v0 = 0; v0 < g.V; v0 += chunk) {
    const int n = min(chunk, g.V - v0);
    nn_stage(vb, v0, n, sv);
    for (int i = sub; i < n; i += kPerRow) {
      const float d = nn_dist(px, py, pz, sv[i]);
      if (d < best) {
        best = d;
        best_i = v0 + i;
      }
    }
  }
#pragma unroll
  for (int o = kPerRow / 2; o; o >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (nn_better(od, oi, best, best_i)) {
      best = od;
      best_i = oi;
    }
  }

  // one thread a row: [coords * scaler | 31 geo columns | 0] as bf16, directions, noise
  if (sub == 0) {
    const float* gf = g.vfeat + ((size_t)b * g.V + best_i) * kVfeat;
    bf16* row = s.in_buf + r * smem_ld(a.k0p);
    row[0] = __float2bfloat16(px * g.scaler);
    row[1] = __float2bfloat16(py * g.scaler);
    row[2] = __float2bfloat16(pz * g.scaler);
    const int jd0 = 3 + (g.legacy ? 0 : 3);    // joint distances
    const int cano0 = 3 + (g.legacy ? g.J : 0);  // canonical coords
    const float psq = (px * px + py * py) + pz * pz;
    for (int j = 0; j < g.J; ++j) {
      const float cross = px * sk[3 * j] + py * sk[3 * j + 1] + pz * sk[3 * j + 2];
      const float jd = sqrtf(fmaxf(psq - 2.f * cross + ssq[j], 0.f) + 1e-12f) / 2.4f;
      row[jd0 + j] = __float2bfloat16(jd);
    }
    const float c0 = gf[0] * px + gf[1] * py + gf[2] * pz + gf[3];
    const float c1 = gf[4] * px + gf[5] * py + gf[6] * pz + gf[7];
    const float c2 = gf[8] * px + gf[9] * py + gf[10] * pz + gf[11];
    row[cano0] = __float2bfloat16(c0 / 2.0f);
    row[cano0 + 1] = __float2bfloat16((c1 + 0.2f) / 2.0f);
    row[cano0 + 2] = __float2bfloat16(c2 / 1.3f);
    const int t0 = 3 + 3 + g.J;  // T-pose coords, then the nearest distance
    row[t0] = __float2bfloat16(gf[16]);
    row[t0 + 1] = __float2bfloat16(gf[17]);
    row[t0 + 2] = __float2bfloat16(gf[18] / 0.2f);
    row[t0 + 3] = __float2bfloat16(sqrtf(best) / 1.3f);
    for (int c = 3 + kGeo; c < a.k0p; ++c) row[c] = __float2bfloat16(0.f);
    for (int k = 0; k < 3; ++k) s.dirs[3 * r + k] = bf(pr[3 + k]);
    s.noise[r] = g.n_cols > 6 ? pr[6] : 0.f;
    if (g.idx_out) g.idx_out[row0 + r] = best_i;
  }
  __syncthreads();
  unfolded_field_body(a, s, b, ray0);
}

}  // namespace

extern "C" int thgt_raymarch_geo(const float* packed, const float* z, const float* verts,
                                 const float* vfeat, const float* skel, int* idx_out,
                                 const bf16* w_first, const float* b_first, const bf16* w_net0,
                                 const bf16* w_net_stk, const float* b_net, const float* freq,
                                 const float* phase, const bf16* w_color_x, const float* w_color_d,
                                 const float* b_color, const float* w_sigma, const float* b_sigma,
                                 const bf16* w_head, const float* b_head, float* out, float* depth,
                                 int B, int R, int S, int n_cols, int V, int J, int legacy,
                                 float scaler, int k0p, int n0p, int hp, int n_blocks,
                                 int out_width, int headp, int white_back, int last_back,
                                 int exact_sin, cudaStream_t stream) {
  UnfoldedField a{w_first, b_first, w_net0, w_net_stk, b_net, freq, phase, w_color_x, w_color_d,
                  b_color, w_sigma, b_sigma, w_head, b_head, z, out, depth, B, R, S, k0p, n0p, hp,
                  n_blocks, out_width, headp, white_back, last_back, exact_sin};
  if (int err = unfolded_check(a)) return err;
  if (J > kMaxJoints || J + 7 != kGeo || k0p < 3 + kGeo || (n_cols != 6 && n_cols != 7) || V <= 0)
    return (int)cudaErrorInvalidValue;
  GeoArgs g{packed, verts, vfeat, skel, idx_out, n_cols, V, J, legacy, scaler};
  const size_t smem = unfolded_smem_bytes(k0p, n0p, hp);
  cudaError_t err =
      cudaFuncSetAttribute(raymarch_geo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(R / (kRows / S), B);
  raymarch_geo_kernel<<<grid, kThreads, smem, stream>>>(a, g);
  return (int)cudaGetLastError();
}
