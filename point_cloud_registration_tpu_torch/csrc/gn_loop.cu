// The whole Gauss-Newton loop of one VPlaneICP (kind "plane") or NDT (kind
// "ndt") align on a dense voxel map, in one launch, for Hopper (sm_90a).
//
// Counterpart of the JAX package's compiled loop: gauss_newton's
// jax.lax.while_loop (point_cloud_registration_tpu/core/gn.py:124-192) around
// the fused stats of models/_fused.py:92-165, whose per-iteration kernel is
// the TPU kernel ops/pallas/fused_align.py::fused_stats_call (kinds "plane"
// and "ndt"). The loop kernel is gn_loop.cuh's, over the fused stats body
// (fused_stats.cuh, the stats kernel's of fused_align.cu: the same points
// per thread in the same order, the same block reduction, so the rows are
// the two-launch path's bit for bit). gn_loop.cuh describes the loop, its
// phases and what bounds it; the stats' work is about 2.7 MB and a
// microsecond of the card's rates an iteration (fused_align.cu).
//
// The kernel keeps the stats kernel's register budget (three CTAs of 256
// an SM); its grid is at most the stats launch's n_blocks =
// min(ceil(n / 256), 1024).

#include "fused_stats.cuh"
#include "gn_loop.cuh"

namespace {

using pcr::kBlock;
using pcr::kStats;

// The fused stats of kind kKind as gn_loop.cuh's stats body.
template <int kKind>
struct FusedStats {
  static constexpr int kThreads = kBlock;
  static constexpr int kMinBlocks = 3;  // the stats kernel's register budget (fused_align.cu)
  using Shared = pcr::NoShared;
  pcr::FusedMap map;
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
    for (int q = 0; q < kStats; ++q) acc[q] = 0.f;
    pcr::fused_block_stats<kKind>(map, src, w, n, T, v, n_blocks, max_dist, use_huber,
                                  huber_delta, acc);
    return pcr::block_reduce_row(acc, out);
  }
};

// One cooperative launch of the kernel of `kind`: its CUDA error.
int launch(int kind, const int* occ, const float* centers, const float* feats, int nx,
           int ny, int nz, int ox, int oy, int oz, float inv_cell, int radius,
           const float* src, const float* w, int n, int n_blocks, float max_dist,
           int use_huber, float huber_delta, float* poses, int* it, int* done, int* failed,
           int* converged, float* final_e2, float* e2_hist, float* dxn_hist, int* inl_hist,
           float* partials, float* rows_out, int max_iter, float tol, int grid,
           void* stream) {
  const pcr::FusedMap map{reinterpret_cast<const int2*>(occ),
                          reinterpret_cast<const float4*>(centers),
                          reinterpret_cast<const float4*>(feats),
                          nx, ny, nz, ox, oy, oz, inv_cell, radius};
  const pcr::LoopState st{poses,   it,       done,     failed,   converged, final_e2, e2_hist,
                          dxn_hist, inl_hist, partials, rows_out, n_blocks,  max_iter, tol};
  if (kind == pcr::kPlane)
    return pcr::launch_loop(
        FusedStats<pcr::kPlane>{map, src, w, n, max_dist, use_huber, huber_delta}, st, grid,
        stream);
  return pcr::launch_loop(FusedStats<pcr::kNdt>{map, src, w, n, max_dist, use_huber, huber_delta},
                          st, grid, stream);
}

}  // namespace

extern "C" {

// Threads per CTA.
int pcr_gn_loop_block_size() { return kBlock; }

// CTAs of the kernel of `kind` (0 plane, 1 ndt) that fit on one SM at
// once, into *out; returns the CUDA error.
int pcr_gn_loop_blocks_per_sm(int kind, int* out) {
  return kind == pcr::kPlane ? pcr::loop_blocks_per_sm<FusedStats<pcr::kPlane>>(out)
                             : pcr::loop_blocks_per_sm<FusedStats<pcr::kNdt>>(out);
}

// The CUDA runtime's text for an error code.
const char* pcr_gn_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each runs the whole loop of one problem as one cooperative launch of
// `grid` CTAs (at most the co-resident count) on `stream` and returns the
// launch's CUDA error. The map's cell index and src (n, 3), w (n,) as for
// pcr_fused_*_stats at B = 1; n_blocks the stats launch's block count (the
// virtual block ids); the state words of core/gn.py's GNState at B = 1
// (poses 12 floats, it, done, failed, converged, final_e2, the three
// histories of max_iter entries), read at the start and left as the loop
// ends; partials 2 * n_blocks * 29 floats of scratch; rows_out n_blocks * 29
// floats that receive the first iteration's block rows, or null.
int pcr_gn_loop_plane(const int* occ, const float* centers, const float* feats, int nx,
                      int ny, int nz, int ox, int oy, int oz, float inv_cell, int radius,
                      const float* src, const float* w, int n, int n_blocks, float max_dist,
                      int use_huber, float huber_delta, float* poses, int* it, int* done,
                      int* failed, int* converged, float* final_e2, float* e2_hist,
                      float* dxn_hist, int* inl_hist, float* partials, float* rows_out,
                      int max_iter, float tol, int grid, void* stream) {
  return launch(pcr::kPlane, occ, centers, feats, nx, ny, nz, ox, oy, oz, inv_cell, radius,
                src, w, n, n_blocks, max_dist, use_huber, huber_delta, poses, it, done,
                failed, converged, final_e2, e2_hist, dxn_hist, inl_hist, partials, rows_out,
                max_iter, tol, grid, stream);
}

int pcr_gn_loop_ndt(const int* occ, const float* centers, const float* feats, int nx,
                    int ny, int nz, int ox, int oy, int oz, float inv_cell, int radius,
                    const float* src, const float* w, int n, int n_blocks, float max_dist,
                    int use_huber, float huber_delta, float* poses, int* it, int* done,
                    int* failed, int* converged, float* final_e2, float* e2_hist,
                    float* dxn_hist, int* inl_hist, float* partials, float* rows_out,
                    int max_iter, float tol, int grid, void* stream) {
  return launch(pcr::kNdt, occ, centers, feats, nx, ny, nz, ox, oy, oz, inv_cell, radius,
                src, w, n, n_blocks, max_dist, use_huber, huber_delta, poses, it, done,
                failed, converged, final_e2, e2_hist, dxn_hist, inl_hist, partials, rows_out,
                max_iter, tol, grid, stream);
}

}  // extern "C"
