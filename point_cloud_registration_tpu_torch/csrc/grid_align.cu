// Hashed-grid correspondence + linearization + reduction, one Gauss-Newton
// iteration of ICP (kind "point") or PlaneICP (kind "plane_pt") on a small
// target's CSR buckets (the "grid" method), and of VPlaneICP (kind "plane")
// or NDT (kind "ndt") on a hashed voxel map, for Hopper (sm_90a).
//
// Counterpart of XLA code of the JAX package, with no Pallas kernel behind
// it: ops/knn.py::nearest_point (:410, a lax.scan over the window's offsets,
// a fori_loop over `cap` bucket entries) or ::nearest_voxel (:78, a lax.scan
// over the offsets with hashgrid.lookup_slots' binary search), chained with
// ops/reduce.py's point_stats / plane_stats / ndt_stats (:41, :85, :113) as
// models/icp.py::icp_stats, plane_icp.py::plane_icp_stats,
// voxelized_plane_icp.py::vplane_stats and ndt.py::ndt_solver_stats chain
// them. For each query, what the plain query computes:
//
//   q = R p + t, ((x r0 + y r1) + z r2) + t as core/se3.py::transform_points;
//   the query's cell floor(q / cell_size), a true division, clamped to
//     +-1e9 before the integer conversion (ops/hashgrid.py::query_cells);
//   the cells of hashgrid.search_offsets' window inside the grid's box
//     (linear key rx + nx (ry + ny rz), coords_to_key), each occupied one's
//     slot (lookup_slots);
//   grid kinds: the slot's first min(count, cap) points of the bucket, in
//     bucket order; hashed kinds: the slot's centroid where it is valid;
//   d2 = ((dx dx + dy dy) + dz dz), the first minimum in probe order (the
//     offsets' order, then the bucket position) by a strict "<" from +inf (a
//     NaN distance never wins), as knn._sq_dist and the plain query;
//   w = w_in where sqrt(d2) < max_dist and a candidate was found (the square
//     root first, as the plain gate), times Huber's weight when enabled;
//   point:    r = q - x, J = [I | -R skew(p)] (gn_accumulate.cuh's m = 3
//             linearization with U = I);
//   plane_pt: r = n . (q - x), J = [n, p x (R^T n)] with the matched point's
//             normal; plane the same with the voxel's normal (m = 1);
//   ndt:      the Mahalanobis (icov) form of reduce.ndt_stats: with
//             S = icov and K = -R skew(p), w [I|K]^T S [I|K], w [I|K]^T S d
//             and w d^T S d, Huber by sqrt(d^T S d);
//   accumulated into the 29 terms [H upper triangle (21) | g (6) | e2 | n].
// The transform, the division and the distances are rounded one operation at
// a time (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn), in the plain path's
// order: nvcc would otherwise contract products into FMAs. So the winner of
// every query is the plain query's, bit for bit. The linearization and the
// sums are the other stats kernels' and round as they do.
//
// What bounds it. Not bytes nor operations (the target, its keys and the
// scan sit in L2; the distances are a few MFLOP) but the latency of the
// dependent reads of the window: dense entry, then bucket start and count,
// then the bucket's points, per cell; or, without a dense table, a binary
// search over the sorted keys per cell. The design spreads and shortens
// those chains:
//
//   * Query i is the caller's point i, in the scan's own order. A scan
//     ordered by cell takes a fifth off the kernel alone on a grid target and
//     two fifths on a hashed map (the queries of a block then share their
//     windows in L1), but a sort once an align costs the host more than the
//     card saves, and the aligns are host-bound: their walls were no shorter
//     with it (scripts/grid_stats_ablation.py --walls compares them).
//   * A group of kGridLanes (32) or kHashedLanes (2) lanes takes one query. On
//     a grid with a dense key table lane l probes the offsets k = l, l + L,
//     ... (one table read each); without one (a hashed map, or a grid target
//     over the dense budget) it takes the window's rows r = l, l + L, ...:
//     the cells of a row (fixed dy and dz) have consecutive keys, so one
//     lower-bound search finds the row's first occupied cell and a forward
//     walk over the sorted keys the rest, 25 searches instead of 125 at
//     radius 2. Each search starts in the block's sampled index in shared
//     memory (every 2^s-th key, at most kSampleMax) and ends in the 2^s keys
//     it leaves. A hit's probe rank comes from the window's rank table (rows
//     and ranks are built on the host from the offsets, once per bind). The
//     10k queries of a small target's scan fill 320k lanes, a warp each;
//     the 100k of a hashed map's need few lanes each, and more cost more
//     than they hide.
//   * A lane keeps its first minimum on (d2, probe rank, bucket position),
//     which is order-free, so lanes may visit cells in any order; the group
//     merges by xor shuffles on the same key. The result is the plain first
//     minimum exactly.
//   * A grid target's bucket points come from a bucket-ordered float4 copy
//     [x, y, z, point index bits] (hashgrid.bucket_rows, built with the
//     target): one 16-byte load per candidate, no read of perm.
//   * The lanes take the linearization in turn (one lane a query, the group's
//     round number picks it), so the next query's searches overlap it.
//   * Registers and occupancy: the pose lives in shared memory, so that no
//     kind spills within its budget. The grid kinds' scattered loads want
//     warps in flight: three blocks of 256 an SM (kGridMinBlocks, at most 85
//     registers) and a warp a query take 40 % less time than two blocks and
//     8 lanes; the hashed kinds keep two (kHashedMinBlocks), three cost them
//     a few per cent.
// Blocks of kThreads threads stride over the scan by groups; each block
// writes one row of the (n_blocks, 29) partials, which the wrapper sums. No
// atomics: for a fixed launch shape the sums repeat bit for bit.
//
// The per-query work is grid_stats.cuh's, shared with the loop kernel
// (grid_loop.cu), which runs an align's every iteration in one launch.
//
// When the caller passes match_idx and match_d2 (the checks do, the align
// passes null), every query, weighted or not, writes its winner (a point
// index or a slot, -1 for none) and its squared distance (+inf for none) at
// its caller's position.
//
// One problem per launch (a batched align on a grid target or a hashed map
// raises, as in the JAX package): the pose is a (1, 12) row on the device,
// [R row-major | t], and done a (1,) flag on the device, or null. A launch
// whose flag is set (a resident Gauss-Newton loop's finished problem) writes
// zeros and reads nothing else.

#include "grid_stats.cuh"

namespace {

using pcr::kStats;
using pcr::Pose;
using namespace pcr::hashgrid;

template <int kKind>
__global__ void __launch_bounds__(kThreads, min_blocks_of(kKind)) grid_stats_kernel(
    Index ix, Table tb, const float* __restrict__ src, const float* __restrict__ w,
    int n, const float* __restrict__ pose,
    const int* __restrict__ done, float max_dist, int use_huber, float huber_delta,
    float* __restrict__ partials, int* __restrict__ match_idx, float* __restrict__ match_d2) {
  __shared__ int sample[kSampleMax];
  if (done != nullptr && __ldg(done) != 0) {  // the align is done: zeros
    if (threadIdx.x < kStats) partials[blockIdx.x * kStats + threadIdx.x] = 0.f;
    return;
  }
  // The pose, in shared memory: read where it is used, it holds no registers
  // through the search. Without a dense table, the block's sampled index of
  // the sorted keys.
  __shared__ Pose pose_s;
  if (threadIdx.x == 0) pose_s = pcr::load_pose(pose);
  const Sample sm = load_sample(ix, sample);
  __syncthreads();

  float acc[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = 0.f;
  grid_block_stats<kKind>(ix, tb, src, w, n, pose_s, blockIdx.x, gridDim.x, sample, sm,
                          max_dist, use_huber, huber_delta, match_idx, match_d2, acc);
  pcr::block_reduce_store<kThreads / 32>(acc, partials);
}

template <int kKind>
int launch(const float* pts, const float* feats, const unsigned char* valid,
           const float* bucket_rows, const int* starts, const int* counts, int cap,
           const int* keys, int n_cells, const int* dense, int ox, int oy, int oz, int nx,
           int ny, int nz, float cell, const int* offsets, int n_offsets, const int* rows,
           int n_rows, const int* ranks, int row_width, const float* src, const float* w, int n,
           const float* pose, const int* done, float max_dist, int use_huber,
           float huber_delta, float* partials, int n_blocks, int* match_idx, float* match_d2,
           void* stream) {
  const Index ix = make_index(keys, n_cells, dense, ox, oy, oz, nx, ny, nz, cell, offsets,
                              n_offsets, rows, n_rows, ranks, row_width);
  const Table tb = make_table(pts, feats, valid, bucket_rows, starts, counts, cap);
  grid_stats_kernel<kKind><<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ix, tb, src, w, n, pose, done, max_dist, use_huber, huber_delta, partials, match_idx,
      match_d2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Queries one block serves at a time (kThreads / lanes per query) for kind
// 0 point, 1 plane_pt, 2 plane, 3 ndt; the wrapper sizes the partials as
// (n_blocks, 29).
int pcr_grid_queries_per_block(int kind) { return kThreads / lanes_of(kind); }

// Each launches its kind's kernel on `stream` and returns cudaGetLastError().
// One signature for the four kinds. pts (N, 3) target points (grid kinds) or
// (C, 3) voxel centroids (hashed kinds), f32; feats (N, 3) normals
// (plane_pt), (C, 3) normals (plane), (C, 6) packed icov (ndt) or null
// (point); valid (C,) bool (hashed kinds; else null); bucket_rows (N, 4)
// f32 (16-byte aligned), starts and counts (C,) i32 and cap (grid kinds;
// else null and 0); keys (C,) i32 sorted, n_cells, dense (D,) i32 or null,
// the origin cell and dims of the grid's box and its cell size; offsets
// (K, 3) i32 (read with a dense table); rows (R, 4) i32 (16-byte aligned)
// and ranks (R, row_width) i32 (read without one); src (n, 3), w (n,),
// pose (1, 12) f32 and done (1,) i32 or null on the device; partials
// (n_blocks, 29) f32; match_idx (n,) i32 and match_d2 (n,) f32, or null.
#define PCR_GRID_ENTRY(name, kind)                                                            \
  int name(const float* pts, const float* feats, const unsigned char* valid,                 \
           const float* bucket_rows, const int* starts, const int* counts, int cap,          \
           const int* keys, int n_cells, const int* dense, int ox, int oy, int oz,           \
           int nx, int ny, int nz, float cell, const int* offsets, int n_offsets,            \
           const int* rows, int n_rows, const int* ranks, int row_width, const float* src,   \
           const float* w, int n, const float* pose, const int* done, float max_dist,        \
           int use_huber, float huber_delta, float* partials, int n_blocks, int* match_idx,  \
           float* match_d2, void* stream) {                                                  \
    return launch<kind>(pts, feats, valid, bucket_rows, starts, counts, cap, keys,           \
                        n_cells, dense, ox, oy, oz, nx, ny, nz, cell, offsets, n_offsets,    \
                        rows, n_rows, ranks, row_width, src, w, n, pose, done, max_dist,     \
                        use_huber, huber_delta, partials, n_blocks, match_idx, match_d2,     \
                        stream);                                                             \
  }

PCR_GRID_ENTRY(pcr_grid_point_stats, kPoint)
PCR_GRID_ENTRY(pcr_grid_plane_point_stats, kPlanePt)
PCR_GRID_ENTRY(pcr_hashed_plane_stats, kPlane)
PCR_GRID_ENTRY(pcr_hashed_ndt_stats, kNdt)

#undef PCR_GRID_ENTRY

}  // extern "C"
