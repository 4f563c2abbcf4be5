// The whole Gauss-Newton loop of one ICP (kind "point") or PlaneICP (kind
// "plane_pt") align on the packed point grid, in one launch, for Hopper
// (sm_90a).
//
// Counterpart of the JAX package's compiled loop: gauss_newton's
// jax.lax.while_loop (point_cloud_registration_tpu/core/gn.py:124-192) around
// the packed-grid stats of models/_point_fused.py:98-169 (the loop at :169
// around point_stats_call at :139), whose per-iteration kernel is the TPU
// kernel ops/pallas/point_align.py::point_stats_call (kinds "point" and
// "plane_pt"). The loop kernel is gn_loop.cuh's, over the packed-grid stats
// body (point_stats.cuh, the stats kernel's of point_align.cu: the same
// queries per thread in the same order, the same block reduction, so the rows
// are the two-launch path's bit for bit). gn_loop.cuh describes the loop, its
// phases and what bounds it; point_align.cu the stats' work (about 18 MB of
// kept points and tables an iteration at the bench size for "point").
//
// The kernel keeps the stats kernel's launch shape and register budget:
// CTAs of 128 threads, six an SM (792 resident on an H100 against the 832
// virtual blocks of the bench scan, 100k points padded to 106,496; the last
// 50 hold padding only); its grid is at most the stats launch's n_blocks =
// min(ceil(n / 128), 1024).
//
// The batched entries (pcr_point_loop_batched_*) run the loop of B scans
// against one target in one launch: gn_loop.cuh's batched kernel over the
// same body, the counterpart of the JAX package's batched_gauss_newton
// (models/_fused.py:288-355) around the batched packed-point stats
// (models/_point_fused.py::fused_point_align_batched, :171-189). Its grid is
// at most B * n_blocks.

#include "gn_loop.cuh"
#include "point_stats.cuh"

namespace {

using pcr::kStats;
using namespace pcr::packed;

// The packed-grid stats of kind kKind as gn_loop.cuh's stats body.
template <int kKind>
struct PointStats {
  static constexpr int kThreads = pcr::packed::kThreads;
  static constexpr int kMinBlocks = kBlocksPerSm;
  using Shared = pcr::NoShared;
  Tables tb;
  const float* src;
  const float* w;
  int n;
  float max_dist;
  int use_huber;
  float huber_delta;

  __device__ __forceinline__ pcr::NoCta setup(Shared&) const { return {}; }

  __device__ __forceinline__ float row(Shared&, const pcr::NoCta&, const float* pose, int v,
                                       int n_blocks, float* out) const {
    const pcr::Pose T{pose[0], pose[1], pose[2], pose[3],  pose[4],  pose[5],
                      pose[6], pose[7], pose[8], pose[9], pose[10], pose[11]};
    float acc[kStats];
#pragma unroll
    for (int k = 0; k < kStats; ++k) acc[k] = 0.f;
    point_block_stats<kKind>(tb, src, w, n, T, VirtualBlock{v, n_blocks}, max_dist, use_huber,
                             huber_delta, acc);
    return pcr::block_reduce_row<kThreads / 32>(acc, out);
  }
};

}  // namespace

extern "C" {

// Threads per CTA: the stats launch's queries per block.
int pcr_point_loop_block_size() { return kThreads; }

// CTAs of the kernel of `kind` (0 point, 1 plane_pt) that fit on one SM at
// once, into *out; returns the CUDA error.
int pcr_point_loop_blocks_per_sm(int kind, int* out) {
  return kind == kPoint ? pcr::loop_blocks_per_sm<PointStats<kPoint>>(out)
                        : pcr::loop_blocks_per_sm<PointStats<kPlanePt>>(out);
}

// The same for the batched kernel of `kind`.
int pcr_point_loop_batched_blocks_per_sm(int kind, int* out) {
  return kind == kPoint ? pcr::loop_batched_blocks_per_sm<PointStats<kPoint>>(out)
                        : pcr::loop_batched_blocks_per_sm<PointStats<kPlanePt>>(out);
}

// The CUDA runtime's text for an error code.
const char* pcr_point_loop_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The CUDA runtime's text for an error code.
const char* pcr_point_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each runs the whole loop of one problem as one cooperative launch of
// `grid` CTAs on `stream` and returns the launch's CUDA error. The packed
// grid, its proxy map and src (n, 3), w (n,) as for pcr_point_stats at
// B = 1; then gn_loop.cuh's state arguments (PCR_LOOP_STATE_PARAMS).
#define PCR_POINT_LOOP_ENTRY(name, kind)                                                   \
  int name(const float* pts, const int* row_count, const int* block_row, int cap, int nbx, \
           int nby, int nbz, int ofx, int ofy, int ofz, float cell_fine, const float* proxy, \
           int pox, int poy, int poz, float proxy_cell, int proxy_radius, const float* src,  \
           const float* w, int n, float max_dist, int use_huber, float huber_delta,          \
           PCR_LOOP_STATE_PARAMS) {                                                          \
    const Tables tb = make_tables<kind>(pts, row_count, block_row, cap, nbx, nby, nbz, ofx,  \
                                        ofy, ofz, cell_fine, proxy, pox, poy, poz,           \
                                        proxy_cell, proxy_radius);                           \
    return pcr::launch_loop(                                                                 \
        PointStats<kind>{tb, src, w, n, max_dist, use_huber, huber_delta}, PCR_LOOP_STATE,   \
        grid, stream);                                                                       \
  }

PCR_POINT_LOOP_ENTRY(pcr_point_loop_point, kPoint)
PCR_POINT_LOOP_ENTRY(pcr_point_loop_plane_pt, kPlanePt)

#undef PCR_POINT_LOOP_ENTRY

// Each runs the loop of B problems as one cooperative launch of `grid` CTAs
// (at most the co-resident count of the batched kernel) on `stream` and
// returns the launch's CUDA error. As the single entries, with src (B, n, 3)
// and w (B, n); the state arguments name the B problems' words (GNState of
// B problems), partials and rows_out B * n_blocks * 29 floats.
#define PCR_POINT_LOOP_BATCHED_ENTRY(name, kind)                                           \
  int name(const float* pts, const int* row_count, const int* block_row, int cap, int nbx, \
           int nby, int nbz, int ofx, int ofy, int ofz, float cell_fine, const float* proxy, \
           int pox, int poy, int poz, float proxy_cell, int proxy_radius, const float* src,  \
           const float* w, int n, int B, float max_dist, int use_huber, float huber_delta,   \
           PCR_LOOP_STATE_PARAMS) {                                                          \
    const Tables tb = make_tables<kind>(pts, row_count, block_row, cap, nbx, nby, nbz, ofx,  \
                                        ofy, ofz, cell_fine, proxy, pox, poy, poz,           \
                                        proxy_cell, proxy_radius);                           \
    return pcr::launch_loop_batched(                                                         \
        PointStats<kind>{tb, src, w, n, max_dist, use_huber, huber_delta}, PCR_LOOP_STATE,   \
        B, grid, stream);                                                                    \
  }

PCR_POINT_LOOP_BATCHED_ENTRY(pcr_point_loop_batched_point, kPoint)
PCR_POINT_LOOP_BATCHED_ENTRY(pcr_point_loop_batched_plane_pt, kPlanePt)

#undef PCR_POINT_LOOP_BATCHED_ENTRY

}  // extern "C"
