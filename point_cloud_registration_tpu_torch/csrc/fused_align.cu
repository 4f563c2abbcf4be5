// Fused correspondence + linearization + reduction, one Gauss-Newton
// iteration of VPlaneICP (kind "plane") or NDT (kind "ndt"), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel point_cloud_registration_tpu/ops/pallas/fused_align.py
// (fused_stats_call -> _make_kernel with _linearize_and_reduce, kinds "plane"
// and "ndt"). It computes the same sums from another layout of the map
// (ops/knn.py CellIndex):
//   occ (W, 2) int32: per word of 32 cells in linear-key order
//     (key = x + nx * (y + ny * z)), the validity bits and the rank, the
//     number of valid cells before the word;
//   centers (V + 1, 4): [mu_x, mu_y, mu_z, 1] of the valid cells in key
//     order, then a sentinel row;
//   feats, the same rows: plane [n_x, n_y, n_z, 0]                  (V + 1, 4)
//                         ndt   [u00, u01, u02, u11 | u12, u22, 0, 0] (V + 1, 8)
//   where U (upper triangular, U^T U = icov) whitens NDT's residual.
//
// Per scan point p (one thread per point, grid-stride loop; a point of weight
// 0 adds nothing and is skipped):
//   q = R p + t, formed in registers (R and t read from the problem's row of
//   the poses array on the device);
//   c = floor(q * inv_cell) - origin;
//   the nearest valid centroid in the cells [c - r, c + r]^3 clipped to the
//   grid, by d2 = sum (q - mu)^2 with a strict "<" in probe order (x fastest,
//   z slowest), so the first minimum wins;
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
// What bounds it. The function needs, once each, the scan's points of
// nonzero weight, the centroid of every valid cell that the windows touch,
// the features of every cell that wins for an inlier and the bitmap words the
// windows cover (2.7 MB for plane, 3.2 MB for ndt at the bench size: 100k
// points, r = 2), and one distance per valid cell of a window (17.4 of a window's
// 97.6 cells in the grid, on average): about a microsecond of the card's
// rates. The kernel it replaced loaded a 16-byte row for every cell of the
// window, 84 % of them empty, each lane from lines of its own; those sectors
// set its time (0.083-0.093 ms on an H100). Here the search walks the
// window's rows of the bitmap: per (y, z) row its 2r + 1 bits come from one
// 8-byte load of [bits, rank] (two where the row crosses a word), and only the
// valid cells' centroids are loaded, the consecutive rows from rank +
// __popc(bits below). Invalid cells never won, so the probe order and the
// first minimum are those of the dense probe; d2 is formed by the same
// expression, so the winners are its bit for bit. The 0.2 MB bitmap stays in
// L1; the centroids (0.5 MB) are what comes from L2, so they are kept apart
// from the features, 16 bytes each, and the neighbouring valid cells of a row
// share 32-byte sectors (rows of centroid and features together, 32 or 48
// bytes, took 0.042 and 0.040 ms; apart, 0.038). What is left (0.034 ms on
// an H100 at 700 W, by scripts/fused_stats_ablation.py) is the loads' latency
// and their spread: an eighth of the scan takes 0.015 ms, and the same scan
// ordered by cell, so that the lanes of a warp share lines and trip counts,
// 0.023-0.024 ms. The kernel reads the scan in the caller's order:
// sorting it in each align cost 0.067 ms of device time, more than the
// launches saved.
//
// One launch takes B >= 1 problems, each a scan of n points with its own
// pose, against one map, the counterpart of the TPU kernel's per_tile mode,
// where each tile of the concatenated scans carries its problem's rotation
// (fused_align.py:550-660); a single problem is B = 1. The grid is
// (n_blocks, B): blockIdx.y is the problem, whose blocks read its rows of the
// (B, n, 3) scan and (B, n) weights and its pose from a (B, 12) device array,
// and write its rows of the (B, n_blocks, 29) partials. A problem's blocks
// split its scan as a launch of that problem alone does, so its partials do
// not depend on B. A resident Gauss-Newton loop (core/gn.py) passes its done
// flags: the blocks of a finished problem exit before they write anything.
//
// Reduction: warp shuffles, then shared memory, one row of partials per
// block; the wrapper sums the rows. No atomics: for a fixed launch shape the
// sums, and so the iteration count of the GN loop, repeat from run to run.
// The rows summed by the grid's last block, behind a counter, cost 0.004 ms
// in the kernel, as much as the wrapper's sum, and its host saving did not
// show in an align's wall time (scripts/fused_stats_ablation.py builds it).

#include "gn_accumulate.cuh"

namespace {

using pcr::kBlock;
using pcr::kStats;
using pcr::Pose;

// Resident blocks per SM the registers are budgeted for: 65,536 / (256 * 3)
// = 85 registers a thread; ptxas takes 71 and spills nothing. At 4 per SM (64
// registers) the kernel took 0.036-0.038 ms against 0.034 on the bench scan;
// at 6 (40 registers, spilling) 0.039-0.041.
constexpr int kMinBlocks = 3;
// A squared distance at or above FOUND_MAX**2 (ops/knn.py) means no valid
// cell was found; it also rejects the +inf initial value.
constexpr float kFoundMax2 = 1e28f;
enum Kind { kPlane = 0, kNdt = 1 };

__device__ __forceinline__ int cell_of(float v, float inv_cell, int origin) {
  return pcr::clamped_cell(floorf(v * inv_cell), origin);
}

// Nearest valid centroid in the cells [c - r, c + r]^3 of the grid (nx, ny,
// nz), by the occupancy words `occ` ([bits, rank] per 32 cells) and the
// valid cells' centers ([mu_x, mu_y, mu_z, 1]).
// Rows of the window run y, then z; inside a row the valid cells run in
// ascending x: the dense probe's order, with the empty cells left out. The
// valid cells of a row's stretch of a word are consecutive rows, the first at
// rank + __popc(bits below the stretch). Returns the winner's row (-1 when
// the window holds no valid cell) and its squared distance in best_d2 (+inf
// if none).
__device__ __forceinline__ int nearest_valid_row(
    const int2* __restrict__ occ, const float4* __restrict__ centers, int nx,
    int ny, int nz, int cx, int cy, int cz, int radius, float qx, float qy,
    float qz, float& best_d2) {
  float best = __int_as_float(0x7f800000);  // +inf
  int best_row = -1;
  const int x0 = max(cx - radius, 0), x1 = min(cx + radius, nx - 1);
  const int y0 = max(cy - radius, 0), y1 = min(cy + radius, ny - 1);
  const int z0 = max(cz - radius, 0), z1 = min(cz + radius, nz - 1);
  if (x0 <= x1) {
    for (int z = z0; z <= z1; ++z) {
      for (int y = y0; y <= y1; ++y) {
        const int first = nx * (y + ny * z) + x0, last = first + (x1 - x0);
        // the row's cells [first, last], one word at a time
        for (int k = first; k <= last; k = (k | 31) + 1) {
          const int2 wr = __ldg(&occ[k >> 5]);
          const unsigned bits = static_cast<unsigned>(wr.x);
          const int lo = k & 31, hi = min(last - (k & ~31), 31);
          const unsigned m = (bits >> lo << lo) & (0xffffffffu >> (31 - hi));
          const int idx = wr.y + __popc(bits & ((1u << lo) - 1u));
          for (int j = idx, end = idx + __popc(m); j < end; ++j) {
            const float4 c = __ldg(&centers[j]);
            const float dx = qx - c.x, dy = qy - c.y, dz = qz - c.z;
            const float d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < best) {
              best = d2;
              best_row = j;
            }
          }
        }
      }
    }
  }
  best_d2 = best;
  return best_row;
}

template <int kKind>
__global__ void __launch_bounds__(kBlock, kMinBlocks) fused_stats_kernel(
    const int2* __restrict__ occ, const float4* __restrict__ centers,
    const float4* __restrict__ feats, int nx, int ny, int nz, int ox, int oy,
    int oz, float inv_cell, int radius, const float* __restrict__ src,
    const float* __restrict__ w, int n, const float* __restrict__ poses,
    const int* __restrict__ done, float max_dist, int use_huber, float huber_delta,
    float* __restrict__ partials) {
  // problem blockIdx.y: its scan, weights and pose
  const size_t b = blockIdx.y;
  // a problem whose resident loop is done: its blocks write nothing
  if (done != nullptr && done[b]) return;
  src += 3 * n * b;
  w += n * b;
  const Pose T = pcr::load_pose(poses + 12 * b);
  float acc[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kBlock + threadIdx.x; i < n;
       i += gridDim.x * kBlock) {
    const float wq = w[i];
    if (wq == 0.f) continue;
    const float px = src[3 * i], py = src[3 * i + 1], pz = src[3 * i + 2];
    // q = R p + t in the JAX package's order: ((x R0 + y R1) + z R2) + t.
    const float qx = px * T.r00 + py * T.r01 + pz * T.r02 + T.t0;
    const float qy = px * T.r10 + py * T.r11 + pz * T.r12 + T.t1;
    const float qz = px * T.r20 + py * T.r21 + pz * T.r22 + T.t2;
    const int cx = cell_of(qx, inv_cell, ox);
    const int cy = cell_of(qy, inv_cell, oy);
    const int cz = cell_of(qz, inv_cell, oz);

    float best;
    const int row = nearest_valid_row(occ, centers, nx, ny, nz, cx, cy, cz,
                                      radius, qx, qy, qz, best);
    if (!(best < kFoundMax2) || !(sqrtf(best) < max_dist)) continue;
    const float4 mu = __ldg(&centers[row]);
    if constexpr (kKind == kPlane) {
      const float4 f1 = __ldg(&feats[row]);
      pcr::accumulate_plane(acc, wq, T, px, py, pz, f1.x, f1.y, f1.z, qx - mu.x,
                            qy - mu.y, qz - mu.z, use_huber, huber_delta);
    } else {
      const float4 f1 = __ldg(&feats[2 * row]);
      const float4 f2 = __ldg(&feats[2 * row + 1]);
      const float u[6] = {f1.x, f1.y, f1.z, f1.w, f2.x, f2.y};
      pcr::accumulate_whitened(acc, wq, u, T, px, py, pz, qx - mu.x, qy - mu.y,
                               qz - mu.z, use_huber, huber_delta);
    }
  }
  pcr::block_reduce_store(acc, partials);
}

// One launch of B problems.
template <int kKind>
int launch(const int* occ, const float* centers, const float* feats, int nx,
           int ny, int nz, int ox, int oy, int oz, float inv_cell, int radius,
           const float* src, const float* w, int n, int B, const float* poses,
           const int* done, float max_dist, int use_huber, float huber_delta,
           float* partials, int n_blocks, void* stream) {
  fused_stats_kernel<kKind>
      <<<dim3(n_blocks, B), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          reinterpret_cast<const int2*>(occ),
          reinterpret_cast<const float4*>(centers),
          reinterpret_cast<const float4*>(feats), nx, ny, nz, ox, oy, oz,
          inv_cell, radius, src, w, n, poses, done, max_dist, use_huber,
          huber_delta, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes the partials as (B, n_blocks, 29).
int pcr_fused_block_size() { return kBlock; }

// Each launches its kernel on `stream` and returns cudaGetLastError().
// occ (W, 2) i32, centers (V + 1, 4) and feats (V + 1, 4 or 8) f32 of the
// map's cell index; src (B, n, 3), w (B, n), poses (B, 12) f32 on the device
// ([R row-major | t] per problem, 1 <= B <= 65,535); done (B,) i32 on the
// device, or null: the blocks of a problem whose flag is set exit at once and
// write none of its partials (a resident Gauss-Newton loop's finished
// problems); partials (B, n_blocks, 29) f32, one row of sums per block, the
// rows of problem b from b * n_blocks on.
int pcr_fused_plane_stats(const int* occ, const float* centers,
                          const float* feats, int nx, int ny, int nz, int ox,
                          int oy, int oz, float inv_cell, int radius,
                          const float* src, const float* w, int n, int B,
                          const float* poses, const int* done, float max_dist,
                          int use_huber, float huber_delta, float* partials,
                          int n_blocks, void* stream) {
  return launch<kPlane>(occ, centers, feats, nx, ny, nz, ox, oy, oz, inv_cell,
                        radius, src, w, n, B, poses, done, max_dist, use_huber,
                        huber_delta, partials, n_blocks, stream);
}

int pcr_fused_ndt_stats(const int* occ, const float* centers,
                        const float* feats, int nx, int ny, int nz, int ox,
                        int oy, int oz, float inv_cell, int radius,
                        const float* src, const float* w, int n, int B,
                        const float* poses, const int* done, float max_dist,
                        int use_huber, float huber_delta, float* partials,
                        int n_blocks, void* stream) {
  return launch<kNdt>(occ, centers, feats, nx, ny, nz, ox, oy, oz, inv_cell,
                      radius, src, w, n, B, poses, done, max_dist, use_huber,
                      huber_delta, partials, n_blocks, stream);
}

}  // extern "C"
