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
//   q = R p + t, formed in registers (R and t read from the problem's row
//     of the poses array on the device);
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
// exist for its memory system and have no counterpart: the lanes read their
// blocks straight from the packed rows.
//
// Tables (see ops/pointgrid.py): pts (R+1, cap * width) f32, the kept points
// of each occupied block in packed order, width 3 for point and 6 for
// plane_pt; row_count (R+1,) i32; block_row (NB,) i32, the row of each block
// key or -1; proxy (NB, 8) f32 rows [mu_x, mu_y, mu_z, valid, n_x, n_y, n_z, 0]
// in block-key order (the normal is read by plane_pt only).
//
// Bound: bytes. The function needs the scan and its weights, block_row,
// row_count, the kept points of the rows in the queries' windows (at most
// the map's points once, 12 or 24 bytes each) and the proxy rows of the
// queries that reach the proxy: under ten microseconds at 100k queries and
// a 1.2M-point map. What a kernel really pays is the serial work of a query:
// one thread per query walks its eight blocks one after the other, each a
// chain of dependent loads (block_row -> row_count -> points) read by 4-byte
// loads, every lane of a warp from a row of its own. The design spreads a
// query over lanes and widens the loads:
//
//   * A group of kGroup = 8 lanes serves its 8 queries in turn, one round per
//     query. In a round lane b takes block b of the query's window
//     (b = 4 dbx + 2 dby + dbz, the probe order), so the eight blocks are
//     looked up at once. (Looking the blocks of all eight rounds up ahead of
//     the first row, with or without prefetches of the rows, costs eight
//     registers and was measured to gain nothing: the loads' latency is not
//     what the rounds wait for.)
//   * A lane reads the kept prefix of its row with 16-byte loads, four
//     points (width 3) or two points with their normals (width 6) per three
//     loads, where rows start at multiples of 16 bytes; else word by word, in
//     the same kernel. It keeps its first minimum (strict "<" in slot order).
//   * The eight lanes merge by three xor-shuffles on (d2, lane): the smaller
//     d2 wins and, at equal d2, the lower lane, which is the first minimum in
//     probe order. The four groups of a warp go through the rounds in step, so
//     every shuffle names the whole warp. An unresolved query's proxy probes are split over the
//     eight lanes, probe p to lane p mod 8, and merged by (d2, probe index)
//     the same way.
//   * The winner's address goes to the lane that owns the query. After the
//     eight rounds every lane loads its own target and accumulates its own
//     query: the 29-term update runs with full lanes.
//   * Blocks of 128 threads, six resident per SM: the 100k queries of the
//     bench scan are one wave of 24 warps per SM. A query of weight 0 takes
//     no round, so the padding behind a scan costs nothing.
// No atomics; the order of the sums depends on the launch shape only.
// The per-query work is point_stats.cuh's, shared with the loop kernel
// (point_loop.cu), which runs an align's every iteration in one launch.
//
// One launch takes B >= 1 problems, each a scan of n points with its own
// pose, against one target, the counterpart of the TPU kernel's per_tile mode
// (point_align.py:594-660); a single problem is B = 1. The grid is
// (n_blocks, B): blockIdx.y is the problem, whose blocks read its rows of the
// (B, n, 3) scan and (B, n) weights and its pose from a (B, 12) device array
// and write its rows of the (B, n_blocks, 29) partials. A group's eight
// queries all lie in one problem: the whole blocks stride over that problem's
// n queries, and a lane past its end is dead, so no tail reads the next
// problem's points. A problem's partials do not depend on B; a problem whose
// done flag is set writes none.

#include "point_stats.cuh"

namespace {

using pcr::kStats;
using pcr::Pose;
using namespace pcr::packed;

template <int kKind>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) point_stats_kernel(
    Tables tb, const float* __restrict__ src, const float* __restrict__ w, int n,
    const float* __restrict__ poses, const int* __restrict__ done,
    float max_dist, int use_huber,
    float huber_delta, float* __restrict__ partials) {
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
  point_block_stats<kKind>(tb, src, w, n, T, LaunchBlock{}, max_dist, use_huber, huber_delta,
                           acc);
  pcr::block_reduce_store<kThreads / 32>(acc, partials);
}

// One launch of B problems.
template <int kKind>
int launch(const float* pts, const int* row_count, const int* block_row, int cap,
           int nbx, int nby, int nbz, int ofx, int ofy, int ofz, float cell_fine,
           const float* proxy, int pox, int poy, int poz, float proxy_cell,
           int proxy_radius, const float* src, const float* w, int n, int B,
           const float* poses, const int* done, float max_dist, int use_huber,
           float huber_delta, float* partials, int n_blocks, void* stream) {
  const Tables tb = make_tables<kKind>(pts, row_count, block_row, cap, nbx, nby, nbz, ofx, ofy,
                                       ofz, cell_fine, proxy, pox, poy, poz, proxy_cell,
                                       proxy_radius);
  point_stats_kernel<kKind>
      <<<dim3(n_blocks, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          tb, src, w, n, poses, done, max_dist, use_huber, huber_delta, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes the partials as (B, n_blocks, 29).
int pcr_point_block_size() { return kThreads; }

// Each launches its kernel on `stream` and returns cudaGetLastError().
// src (B, n, 3), w (B, n), poses (B, 12) f32 on the device ([R row-major | t]
// per problem, 1 <= B <= 65,535); done (B,) i32 on the device, or null: the
// blocks of a problem whose flag is set exit at once and write none of its
// partials (a resident Gauss-Newton loop's finished problems); partials
// (B, n_blocks, 29), the rows of problem b from b * n_blocks on.
int pcr_point_stats(const float* pts, const int* row_count, const int* block_row,
                    int cap, int nbx, int nby, int nbz, int ofx, int ofy,
                    int ofz, float cell_fine, const float* proxy, int pox,
                    int poy, int poz, float proxy_cell, int proxy_radius,
                    const float* src, const float* w, int n, int B,
                    const float* poses, const int* done, float max_dist,
                    int use_huber, float huber_delta, float* partials,
                    int n_blocks, void* stream) {
  return launch<kPoint>(pts, row_count, block_row, cap, nbx, nby, nbz, ofx, ofy,
                        ofz, cell_fine, proxy, pox, poy, poz, proxy_cell,
                        proxy_radius, src, w, n, B, poses, done, max_dist,
                        use_huber, huber_delta, partials, n_blocks, stream);
}

int pcr_plane_point_stats(const float* pts, const int* row_count,
                          const int* block_row, int cap, int nbx, int nby,
                          int nbz, int ofx, int ofy, int ofz, float cell_fine,
                          const float* proxy, int pox, int poy, int poz,
                          float proxy_cell, int proxy_radius, const float* src,
                          const float* w, int n, int B, const float* poses,
                          const int* done, float max_dist, int use_huber,
                          float huber_delta, float* partials, int n_blocks,
                          void* stream) {
  return launch<kPlanePt>(pts, row_count, block_row, cap, nbx, nby, nbz, ofx,
                          ofy, ofz, cell_fine, proxy, pox, poy, poz, proxy_cell,
                          proxy_radius, src, w, n, B, poses, done, max_dist,
                          use_huber, huber_delta, partials, n_blocks, stream);
}

}  // extern "C"
