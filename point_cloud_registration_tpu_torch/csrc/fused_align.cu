// Fused correspondence + linearization + reduction, one Gauss-Newton
// iteration of VPlaneICP (kind "plane") or NDT (kind "ndt"), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel point_cloud_registration_tpu/ops/pallas/fused_align.py
// (_make_kernel with _linearize_and_reduce, kinds "plane" and "ndt"). It
// computes the same sums from another table layout: one row per voxel cell in
// linear-key order (see ops/knn.py),
//   plane: [mu_x, mu_y, mu_z, valid | n_x, n_y, n_z, 0]                (D, 8)
//   ndt:   [mu_x, mu_y, mu_z, valid | u00, u01, u02, u11 | u12, u22, 0, 0]
//                                                                     (D, 12)
// where U (upper triangular, U^T U = icov) whitens NDT's residual.
//
// Per scan point p (one thread per point, grid-stride loop):
//   q = R p + t, formed in registers (R and t are passed by value);
//   c = floor(q * inv_cell) - origin;
//   probe every cell of [c - r, c + r]^3, x fastest and z slowest, skipping
//   cells outside the grid and invalid cells; keep the nearest centroid by
//   d2 = sum (q - mu)^2 with a strict "<", so the first minimum in probe
//   order wins;
//   w = w_in * found * (sqrt(d2) < max_dist), times the Huber weight of the
//   residual's norm when enabled;
//   plane: a = [n, p x (R^T n)], r = n . (q - mu), one row of w [a|r|1];
//   ndt:   three whitened rows J~ = U [I | -R skew(p)], r~ = U (q - mu)
//          (gn_accumulate.cuh), the weight counted once;
//   accumulate the 29 unique terms: H upper triangle (21), g (6), e2, n.
// The TPU kernel probes a window of whole (4, 8, 4) blocks, a superset of
// these cells; every cell beyond [c - r, c + r] lies at least max_dist away
// and is gated out, so the gated correspondences are the same.
//
// Reduction: warp shuffles, then shared memory, one row of partials per
// block; the wrapper sums the rows. No atomics: for a fixed launch shape the
// sums, and so the iteration count of the GN loop, repeat from run to run.
//
// Bound: memory latency. At the bench size (100k scan points, radius 2) an
// iteration makes 100k x 125 probes, each one 16-byte load, about 0.2 GB,
// while the table (about 0.84M cells x 32 B = 27 MB for plane, x 48 B =
// 40 MB for ndt) stays in the 50 MB L2. The arithmetic is a few hundred
// FLOPs per point (about 3x that for ndt's three rows). Threads are
// independent, so many warps in flight hide the L2 latency; nothing is
// staged in shared memory.

#include "gn_accumulate.cuh"

namespace {

using pcr::kBlock;
using pcr::kStats;
using pcr::Pose;

// A squared distance at or above FOUND_MAX**2 (ops/knn.py) means no valid
// cell was found; it also rejects the +inf initial value.
constexpr float kFoundMax2 = 1e28f;
enum Kind { kPlane = 0, kNdt = 1 };

__device__ __forceinline__ int cell_of(float v, float inv_cell, int origin) {
  return pcr::clamped_cell(floorf(v * inv_cell), origin);
}

template <int kKind>
__global__ void __launch_bounds__(kBlock) fused_stats_kernel(
    const float4* __restrict__ table, int nx, int ny, int nz, int ox, int oy,
    int oz, float inv_cell, int radius, const float* __restrict__ src,
    const float* __restrict__ w, int n, Pose T, float max_dist, int use_huber,
    float huber_delta, float* __restrict__ partials) {
  // float4s per table row: 2 for plane (8 floats), 3 for ndt (12 floats)
  constexpr int kRow = kKind == kPlane ? 2 : 3;
  float acc[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kBlock + threadIdx.x; i < n;
       i += gridDim.x * kBlock) {
    const float px = src[3 * i], py = src[3 * i + 1], pz = src[3 * i + 2];
    // q = R p + t in the JAX package's order: ((x R0 + y R1) + z R2) + t.
    const float qx = px * T.r00 + py * T.r01 + pz * T.r02 + T.t0;
    const float qy = px * T.r10 + py * T.r11 + pz * T.r12 + T.t1;
    const float qz = px * T.r20 + py * T.r21 + pz * T.r22 + T.t2;
    const int cx = cell_of(qx, inv_cell, ox);
    const int cy = cell_of(qy, inv_cell, oy);
    const int cz = cell_of(qz, inv_cell, oz);

    float best;
    const int best_key = pcr::nearest_valid_cell<kRow>(
        table, nx, ny, nz, cx, cy, cz, radius, qx, qy, qz, best);
    if (!(best < kFoundMax2) || !(sqrtf(best) < max_dist)) continue;
    float wq = w[i];
    const float4 mu = __ldg(&table[kRow * best_key]);
    const float4 f1 = __ldg(&table[kRow * best_key + 1]);
    if constexpr (kKind == kPlane) {
      pcr::accumulate_plane(acc, wq, T, px, py, pz, f1.x, f1.y, f1.z, qx - mu.x,
                            qy - mu.y, qz - mu.z, use_huber, huber_delta);
    } else {
      const float4 f2 = __ldg(&table[kRow * best_key + 2]);
      const float u[6] = {f1.x, f1.y, f1.z, f1.w, f2.x, f2.y};
      pcr::accumulate_whitened(acc, wq, u, T, px, py, pz, qx - mu.x, qy - mu.y,
                               qz - mu.z, use_huber, huber_delta);
    }
  }
  pcr::block_reduce_store(acc, partials);
}

template <int kKind>
int launch(const float* table, int nx, int ny, int nz, int ox, int oy, int oz,
           float inv_cell, int radius, const float* src, const float* w, int n,
           float r00, float r01, float r02, float r10, float r11, float r12,
           float r20, float r21, float r22, float t0, float t1, float t2,
           float max_dist, int use_huber, float huber_delta, float* partials,
           int n_blocks, void* stream) {
  const Pose T{r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2};
  fused_stats_kernel<kKind><<<n_blocks, kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), nx, ny, nz, ox, oy, oz, inv_cell,
      radius, src, w, n, T, max_dist, use_huber, huber_delta, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes the partials as (n_blocks, 29).
int pcr_fused_block_size() { return kBlock; }

// Each launches its kernel on `stream` and returns cudaGetLastError().
int pcr_fused_plane_stats(const float* table, int nx, int ny, int nz, int ox,
                          int oy, int oz, float inv_cell, int radius,
                          const float* src, const float* w, int n, float r00,
                          float r01, float r02, float r10, float r11, float r12,
                          float r20, float r21, float r22, float t0, float t1,
                          float t2, float max_dist, int use_huber,
                          float huber_delta, float* partials, int n_blocks,
                          void* stream) {
  return launch<kPlane>(table, nx, ny, nz, ox, oy, oz, inv_cell, radius, src, w,
                        n, r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1,
                        t2, max_dist, use_huber, huber_delta, partials,
                        n_blocks, stream);
}

int pcr_fused_ndt_stats(const float* table, int nx, int ny, int nz, int ox,
                        int oy, int oz, float inv_cell, int radius,
                        const float* src, const float* w, int n, float r00,
                        float r01, float r02, float r10, float r11, float r12,
                        float r20, float r21, float r22, float t0, float t1,
                        float t2, float max_dist, int use_huber,
                        float huber_delta, float* partials, int n_blocks,
                        void* stream) {
  return launch<kNdt>(table, nx, ny, nz, ox, oy, oz, inv_cell, radius, src, w,
                      n, r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1,
                      t2, max_dist, use_huber, huber_delta, partials, n_blocks,
                      stream);
}

}  // extern "C"
