// The per-point work of the fused voxel stats (VPlaneICP's kind "plane",
// NDT's kind "ndt"), shared by the stats kernel (fused_align.cu, one launch
// per Gauss-Newton iteration) and the loop kernel (gn_loop.cu, every
// iteration of an align in one launch). fused_align.cu's note describes the
// map's layout, the search and what bounds it.
//
// fused_block_stats adds to a thread's acc[29] its points of block id
// `block` of a launch of `n_blocks` blocks of kBlock threads: points
// block * kBlock + threadIdx.x, then every n_blocks * kBlock further on. For
// each point p of nonzero weight:
//   q = R p + t, in the JAX package's order ((x R0 + y R1) + z R2) + t;
//   c = floor(q * inv_cell) - origin (cell_of);
//   the nearest valid centroid in the cells [c - r, c + r]^3 of the grid
//   (nearest_valid_row), the first minimum of d2 in the dense probe's order;
//   the gate: found and sqrt(d2) < max_dist;
//   plane: one row of w [a|r|1] (accumulate_plane); ndt: three whitened rows
//   (accumulate_whitened), the weight counted once.
// The same block id of the same launch shape covers the same points in the
// same order per thread, so its block row is the same bits in either kernel.

#pragma once

#include "gn_accumulate.cuh"

namespace pcr {

// A squared distance at or above FOUND_MAX**2 (ops/knn.py) means no valid
// cell was found; it also rejects the +inf initial value.
constexpr float kFoundMax2 = 1e28f;
enum FusedKind { kPlane = 0, kNdt = 1 };

// The map as the fused kernels read it: the cell index (occupancy words
// [bits, rank] per 32 cells, the valid cells' centers [mu, 1] and features,
// 4 or 8 floats a row) of a grid of nx * ny * nz cells from cell
// (ox, oy, oz), and the window radius in cells.
struct FusedMap {
  const int2* occ;
  const float4* centers;
  const float4* feats;
  int nx, ny, nz, ox, oy, oz;
  float inv_cell;
  int radius;
};

__device__ __forceinline__ int cell_of(float v, float inv_cell, int origin) {
  return clamped_cell(floorf(v * inv_cell), origin);
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

// Adds block id `block`'s share of the scan src (n, 3) with weights w (n,)
// at pose T into this thread's acc (see above).
template <int kKind>
__device__ __forceinline__ void fused_block_stats(
    const FusedMap& m, const float* __restrict__ src, const float* __restrict__ w,
    int n, const Pose& T, int block, int n_blocks, float max_dist, int use_huber,
    float huber_delta, float (&acc)[kStats]) {
  for (int i = block * kBlock + threadIdx.x; i < n; i += n_blocks * kBlock) {
    const float wq = w[i];
    if (wq == 0.f) continue;
    const float px = src[3 * i], py = src[3 * i + 1], pz = src[3 * i + 2];
    // q = R p + t in the JAX package's order: ((x R0 + y R1) + z R2) + t.
    const float qx = px * T.r00 + py * T.r01 + pz * T.r02 + T.t0;
    const float qy = px * T.r10 + py * T.r11 + pz * T.r12 + T.t1;
    const float qz = px * T.r20 + py * T.r21 + pz * T.r22 + T.t2;
    const int cx = cell_of(qx, m.inv_cell, m.ox);
    const int cy = cell_of(qy, m.inv_cell, m.oy);
    const int cz = cell_of(qz, m.inv_cell, m.oz);

    float best;
    const int row = nearest_valid_row(m.occ, m.centers, m.nx, m.ny, m.nz, cx, cy, cz,
                                      m.radius, qx, qy, qz, best);
    if (!(best < kFoundMax2) || !(sqrtf(best) < max_dist)) continue;
    const float4 mu = __ldg(&m.centers[row]);
    if constexpr (kKind == kPlane) {
      const float4 f1 = __ldg(&m.feats[row]);
      accumulate_plane(acc, wq, T, px, py, pz, f1.x, f1.y, f1.z, qx - mu.x, qy - mu.y,
                       qz - mu.z, use_huber, huber_delta);
    } else {
      const float4 f1 = __ldg(&m.feats[2 * row]);
      const float4 f2 = __ldg(&m.feats[2 * row + 1]);
      const float u[6] = {f1.x, f1.y, f1.z, f1.w, f2.x, f2.y};
      accumulate_whitened(acc, wq, u, T, px, py, pz, qx - mu.x, qy - mu.y, qz - mu.z,
                          use_huber, huber_delta);
    }
  }
}

}  // namespace pcr
