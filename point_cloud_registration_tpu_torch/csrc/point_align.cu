// Raw-point correspondence + linearization + reduction, one Gauss-Newton
// iteration of ICP (kind "point") or PlaneICP (kind "plane_pt") on the packed
// point grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel point_cloud_registration_tpu/ops/pallas/
// point_align.py (_make_point_kernel, launched by point_stats_call, kinds
// "point" and "plane_pt") together with the fallback its caller runs for the
// queries the kernel leaves unresolved (models/_point_fused.py,
// models/_point_corr.py match_points). One pass per query does all of
// match_points' work, so no query is left unresolved:
//
//   q = R p + t, formed in registers (R and t are passed by value);
//   tier 1 (ops/pointgrid.py nearest_point_packed): the fine cell
//     f = floor(q / cell_fine) - origin_fine (a true division, as in
//     hashgrid.cell_coords), the first block lo = floor((f - 1) / 2), and the
//     2x2x2 blocks from lo in the order dbx outer, dbz inner; in each block
//     the kept points in packed order; strict "<". The match is resolved iff
//     sqrt(d2) < cell_fine;
//   otherwise the nearest valid centroid of the proxy voxel map (one voxel
//   per block, 2 * cell_fine) within ceil(max_dist / (2 * cell_fine)) proxy
//   cells, x fastest and z slowest (query_nearest_voxel on the proxy);
//   w = w_in * found * (dist < max_dist), times the Huber weight of |r|;
//   point: r = q - target and J = [I | -R skew(p)] (the m = 3 linearization
//     of gn_accumulate.cuh with U = I);
//   plane_pt: r = n . (q - target) and J = [n, p x (R^T n)] (the m = 1 plane
//     linearization of gn_accumulate.cuh), where n is the matched point's
//     normal, which rides in its packed slot (x y z nx ny nz), or, for a
//     query that took the proxy voxel, that voxel's normal;
//   accumulated into the 29 terms.
// The TPU kernel's "plane_pt" searches a wider window of whole fused blocks;
// every point within cell_fine of the query lies in both windows, so a
// resolved query has the same winner.
//
// The Morton layout, tile key lists and VMEM tile tables of the TPU kernel
// exist for its memory system and have no counterpart: a thread reads its
// blocks straight from the packed rows.
//
// Tables (see ops/pointgrid.py): pts (R+1, cap * width) f32, the kept points
// of each occupied block in packed order, width 3 for point and 6 for
// plane_pt; row_count (R+1,) i32; block_row (NB,) i32, the row of each block
// key or -1; proxy (NB, 8) f32 rows [mu_x, mu_y, mu_z, valid, n_x, n_y, n_z, 0]
// in block-key order (the normal is read by plane_pt only).
//
// Bound: memory latency. Tier 1 reads at most 8 rows of cap points of
// 12 bytes per query (3 KB at cap 32, at most 0.3 GB per iteration at 100k
// queries; plane_pt reads the same 12 bytes at a stride of 24, and the
// winner's normal once). The packed rows of the bench map (0.2M x 384 B =
// 77 MB, 154 MB for plane_pt) exceed the 50 MB L2, but neighbouring queries
// share rows. Only unresolved
// queries probe the proxy window (125 16-byte loads).

#include "gn_accumulate.cuh"

namespace {

using pcr::kBlock;
using pcr::kStats;
using pcr::Pose;

// A true division, as in hashgrid.cell_coords (not fused_align.cu's multiply).
__device__ __forceinline__ int cell_div(float v, float cell, int origin) {
  return pcr::clamped_cell(floorf(v / cell), origin);
}

__device__ __forceinline__ int floor_div2(int v) { return (v - (v < 0)) / 2; }

enum Kind { kPoint = 0, kPlanePt = 1 };

template <int kKind>
__global__ void __launch_bounds__(kBlock) point_stats_kernel(
    const float* __restrict__ pts, const int* __restrict__ row_count,
    const int* __restrict__ block_row, int cap, int nbx, int nby, int nbz,
    int ofx, int ofy, int ofz, float cell_fine, const float4* __restrict__ proxy,
    int pox, int poy, int poz, float proxy_cell, int proxy_radius,
    const float* __restrict__ src, const float* __restrict__ w, int n, Pose T,
    float max_dist, int use_huber, float huber_delta,
    float* __restrict__ partials) {
  constexpr int kWidth = kKind == kPoint ? 3 : 6;  // floats per packed slot
  const float kInf = __int_as_float(0x7f800000);
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

    // Tier 1: nearest kept point of the 2x2x2 blocks around the fine cell.
    const int bx0 = floor_div2(cell_div(qx, cell_fine, ofx) - 1);
    const int by0 = floor_div2(cell_div(qy, cell_fine, ofy) - 1);
    const int bz0 = floor_div2(cell_div(qz, cell_fine, ofz) - 1);
    float best = kInf;
    long long best_off = -1;  // offset of the winner's x in pts
    for (int dbx = 0; dbx < 2; ++dbx) {
      const int bx = bx0 + dbx;
      if (bx < 0 || bx >= nbx) continue;
      for (int dby = 0; dby < 2; ++dby) {
        const int by = by0 + dby;
        if (by < 0 || by >= nby) continue;
        for (int dbz = 0; dbz < 2; ++dbz) {
          const int bz = bz0 + dbz;
          if (bz < 0 || bz >= nbz) continue;
          const int row = __ldg(&block_row[bx + nbx * (by + nby * bz)]);
          if (row < 0) continue;
          const int cnt = __ldg(&row_count[row]);
          const long long base = static_cast<long long>(row) * cap * kWidth;
          for (int s = 0; s < cnt; ++s) {
            const float* c = pts + base + kWidth * s;
            const float dx = qx - __ldg(c), dy = qy - __ldg(c + 1),
                        dz = qz - __ldg(c + 2);
            const float d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < best) {
              best = d2;
              best_off = base + kWidth * s;
            }
          }
        }
      }
    }

    float dist = sqrtf(best), tx, ty, tz, nx = 0.f, ny = 0.f, nz = 0.f;
    if (dist < cell_fine) {
      tx = __ldg(&pts[best_off]);
      ty = __ldg(&pts[best_off + 1]);
      tz = __ldg(&pts[best_off + 2]);
      if constexpr (kKind == kPlanePt) {
        nx = __ldg(&pts[best_off + 3]);
        ny = __ldg(&pts[best_off + 4]);
        nz = __ldg(&pts[best_off + 5]);
      }
    } else {
      // Unresolved: nearest valid proxy-voxel centroid in the window.
      float best_p;
      const int key = pcr::nearest_valid_cell<2>(
          proxy, nbx, nby, nbz, cell_div(qx, proxy_cell, pox),
          cell_div(qy, proxy_cell, poy), cell_div(qz, proxy_cell, poz),
          proxy_radius, qx, qy, qz, best_p);
      if (!(best_p < kInf)) continue;  // no valid voxel in the window
      const float4 mu = __ldg(&proxy[2 * key]);
      dist = sqrtf(best_p);
      tx = mu.x;
      ty = mu.y;
      tz = mu.z;
      if constexpr (kKind == kPlanePt) {
        const float4 nrm = __ldg(&proxy[2 * key + 1]);
        nx = nrm.x;
        ny = nrm.y;
        nz = nrm.z;
      }
    }
    if (!(dist < max_dist)) continue;
    if constexpr (kKind == kPlanePt) {
      pcr::accumulate_plane(acc, w[i], T, px, py, pz, nx, ny, nz, qx - tx,
                            qy - ty, qz - tz, use_huber, huber_delta);
    } else {
      const float u[6] = {1.f, 0.f, 0.f, 1.f, 0.f, 1.f};
      pcr::accumulate_whitened(acc, w[i], u, T, px, py, pz, qx - tx, qy - ty,
                               qz - tz, use_huber, huber_delta);
    }
  }
  pcr::block_reduce_store(acc, partials);
}

template <int kKind>
int launch(const float* pts, const int* row_count, const int* block_row, int cap,
           int nbx, int nby, int nbz, int ofx, int ofy, int ofz, float cell_fine,
           const float* proxy, int pox, int poy, int poz, float proxy_cell,
           int proxy_radius, const float* src, const float* w, int n, float r00,
           float r01, float r02, float r10, float r11, float r12, float r20,
           float r21, float r22, float t0, float t1, float t2, float max_dist,
           int use_huber, float huber_delta, float* partials, int n_blocks,
           void* stream) {
  const Pose T{r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2};
  point_stats_kernel<kKind><<<n_blocks, kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      pts, row_count, block_row, cap, nbx, nby, nbz, ofx, ofy, ofz, cell_fine,
      reinterpret_cast<const float4*>(proxy), pox, poy, poz, proxy_cell,
      proxy_radius, src, w, n, T, max_dist, use_huber, huber_delta, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes the partials as (n_blocks, 29).
int pcr_point_block_size() { return kBlock; }

// Each launches its kernel on `stream` and returns cudaGetLastError().
int pcr_point_stats(const float* pts, const int* row_count, const int* block_row,
                    int cap, int nbx, int nby, int nbz, int ofx, int ofy,
                    int ofz, float cell_fine, const float* proxy, int pox,
                    int poy, int poz, float proxy_cell, int proxy_radius,
                    const float* src, const float* w, int n, float r00,
                    float r01, float r02, float r10, float r11, float r12,
                    float r20, float r21, float r22, float t0, float t1,
                    float t2, float max_dist, int use_huber, float huber_delta,
                    float* partials, int n_blocks, void* stream) {
  return launch<kPoint>(pts, row_count, block_row, cap, nbx, nby, nbz, ofx, ofy,
                        ofz, cell_fine, proxy, pox, poy, poz, proxy_cell,
                        proxy_radius, src, w, n, r00, r01, r02, r10, r11, r12,
                        r20, r21, r22, t0, t1, t2, max_dist, use_huber,
                        huber_delta, partials, n_blocks, stream);
}

int pcr_plane_point_stats(const float* pts, const int* row_count,
                          const int* block_row, int cap, int nbx, int nby,
                          int nbz, int ofx, int ofy, int ofz, float cell_fine,
                          const float* proxy, int pox, int poy, int poz,
                          float proxy_cell, int proxy_radius, const float* src,
                          const float* w, int n, float r00, float r01,
                          float r02, float r10, float r11, float r12, float r20,
                          float r21, float r22, float t0, float t1, float t2,
                          float max_dist, int use_huber, float huber_delta,
                          float* partials, int n_blocks, void* stream) {
  return launch<kPlanePt>(pts, row_count, block_row, cap, nbx, nby, nbz, ofx,
                          ofy, ofz, cell_fine, proxy, pox, poy, poz, proxy_cell,
                          proxy_radius, src, w, n, r00, r01, r02, r10, r11, r12,
                          r20, r21, r22, t0, t1, t2, max_dist, use_huber,
                          huber_delta, partials, n_blocks, stream);
}

}  // extern "C"
