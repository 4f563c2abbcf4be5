// The whole Gauss-Newton loop of one align over the grid stats, in one
// launch, for Hopper (sm_90a): ICP (kind "point") and PlaneICP ("plane_pt")
// on a small target's CSR buckets (the "grid" method), VPlaneICP ("plane")
// and NDT ("ndt") on a hashed voxel map.
//
// Counterpart of the JAX package's compiled loop: gauss_newton's
// jax.lax.while_loop (point_cloud_registration_tpu/core/gn.py:124-192) around
// icp_align's and plane_icp_align's stats (models/icp.py:60-67,
// plane_icp.py:91-92: ops/knn.py:410 nearest_point) and vplane_align's and
// ndt_align's (voxelized_plane_icp.py:83-84, ndt.py:82-83: ops/knn.py:78
// nearest_voxel through voxelize.py:596), XLA code with no Pallas kernel.
// The loop kernel is gn_loop.cuh's, over the grid stats body (grid_stats.cuh,
// the stats kernel's of grid_align.cu: the same queries per lane in the same
// order, the same block reduction, so the rows are the two-launch path's bit
// for bit). gn_loop.cuh describes the loop, its phases and what bounds it;
// grid_align.cu the stats' work.
//
// The kernel keeps the stats kernel's launch shape and register budget
// (CTAs of 256 threads; three an SM for the grid kinds, a warp a query; two
// for the hashed kinds, two lanes a query); its grid is at most the stats
// launch's n_blocks = min(ceil(n / queries per block), 1024). Each CTA
// loads the block's sampled key index into shared memory once (a map
// without a dense key table), before the first iteration, since the keys
// do not change within an align. The debug outputs of the stats kernel
// (match_idx, match_d2) are null here.

#include "gn_loop.cuh"
#include "grid_stats.cuh"

namespace {

using pcr::kStats;
using namespace pcr::hashgrid;

// The grid stats of kind kKind as gn_loop.cuh's stats body.
template <int kKind>
struct GridStats {
  static constexpr int kThreads = pcr::hashgrid::kThreads;
  static constexpr int kMinBlocks = min_blocks_of(kKind);
  struct Shared {
    int sample[kSampleMax];
  };
  Index ix;
  Table tb;
  const float* src;
  const float* w;
  int n;
  float max_dist;
  int use_huber;
  float huber_delta;

  __device__ __forceinline__ Sample setup(Shared& sh) const { return load_sample(ix, sh.sample); }

  __device__ __forceinline__ float row(Shared& sh, const Sample& sm, const float* pose, int v,
                                       int n_blocks, float* out) const {
    // the pose stays in shared memory, where the stats kernel keeps it too
    const pcr::Pose& T = *reinterpret_cast<const pcr::Pose*>(pose);
    float acc[kStats];
#pragma unroll
    for (int k = 0; k < kStats; ++k) acc[k] = 0.f;
    grid_block_stats<kKind>(ix, tb, src, w, n, T, v, n_blocks, sh.sample, sm, max_dist,
                            use_huber, huber_delta, nullptr, nullptr, acc);
    return pcr::block_reduce_row<kThreads / 32>(acc, out);
  }
};

static_assert(sizeof(pcr::Pose) == 12 * sizeof(float), "a pose is its 12 floats");

template <int kKind>
int launch(const Index& ix, const Table& tb, const float* src, const float* w, int n,
           float max_dist, int use_huber, float huber_delta, const pcr::LoopState& st, int grid,
           void* stream) {
  return pcr::launch_loop(GridStats<kKind>{ix, tb, src, w, n, max_dist, use_huber, huber_delta},
                          st, grid, stream);
}

}  // namespace

extern "C" {

// The stats launch's queries per block (its virtual blocks' size) for kind
// 0 point, 1 plane_pt, 2 plane, 3 ndt.
int pcr_grid_loop_queries_per_block(int kind) { return kThreads / lanes_of(kind); }

// CTAs of the kernel of `kind` that fit on one SM at once, into *out;
// returns the CUDA error.
int pcr_grid_loop_blocks_per_sm(int kind, int* out) {
  switch (kind) {
    case kPoint:
      return pcr::loop_blocks_per_sm<GridStats<kPoint>>(out);
    case kPlanePt:
      return pcr::loop_blocks_per_sm<GridStats<kPlanePt>>(out);
    case kPlane:
      return pcr::loop_blocks_per_sm<GridStats<kPlane>>(out);
    default:
      return pcr::loop_blocks_per_sm<GridStats<kNdt>>(out);
  }
}

// The CUDA runtime's text for an error code.
const char* pcr_grid_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each runs the whole loop of one problem as one cooperative launch of
// `grid` CTAs on `stream` and returns the launch's CUDA error. The table,
// the index and the window, src (n, 3) and w (n,) as for the four entries
// of grid_align.cu; then gn_loop.cuh's state arguments
// (PCR_LOOP_STATE_PARAMS).
#define PCR_GRID_LOOP_ENTRY(name, kind)                                                      \
  int name(const float* pts, const float* feats, const unsigned char* valid,                \
           const float* bucket_rows, const int* starts, const int* counts, int cap,         \
           const int* keys, int n_cells, const int* dense, int ox, int oy, int oz, int nx,  \
           int ny, int nz, float cell, const int* offsets, int n_offsets, const int* rows,  \
           int n_rows, const int* ranks, int row_width, const float* src, const float* w,   \
           int n, float max_dist, int use_huber, float huber_delta, PCR_LOOP_STATE_PARAMS) { \
    return launch<kind>(make_index(keys, n_cells, dense, ox, oy, oz, nx, ny, nz, cell,      \
                                   offsets, n_offsets, rows, n_rows, ranks, row_width),     \
                        make_table(pts, feats, valid, bucket_rows, starts, counts, cap),    \
                        src, w, n, max_dist, use_huber, huber_delta, PCR_LOOP_STATE, grid,  \
                        stream);                                                            \
  }

PCR_GRID_LOOP_ENTRY(pcr_grid_loop_point, kPoint)
PCR_GRID_LOOP_ENTRY(pcr_grid_loop_plane_pt, kPlanePt)
PCR_GRID_LOOP_ENTRY(pcr_grid_loop_plane, kPlane)
PCR_GRID_LOOP_ENTRY(pcr_grid_loop_ndt, kNdt)

#undef PCR_GRID_LOOP_ENTRY

}  // extern "C"
