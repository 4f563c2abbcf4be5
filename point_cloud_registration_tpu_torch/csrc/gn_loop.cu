// The whole Gauss-Newton loop of one VPlaneICP (kind "plane") or NDT (kind
// "ndt") align on a dense voxel map, in one launch, for Hopper (sm_90a).
//
// Counterpart of the JAX package's compiled loop: gauss_newton's
// jax.lax.while_loop (point_cloud_registration_tpu/core/gn.py:124-192) around
// the fused stats of models/_fused.py:92-165, whose per-iteration kernel is
// the TPU kernel ops/pallas/fused_align.py::fused_stats_call (kinds "plane"
// and "ndt"). An align there is one dispatch on the device; here it is one
// cooperative launch, where the two-launch loop (core/gn.py::
// gauss_newton_device: the stats kernel of fused_align.cu, a sum of its
// block rows, gn_step.cu) launches three kernels an iteration from the host
// and reads the state once per chunk of iterations.
//
// The kernel is persistent: its grid is the CTAs that fit on the card at
// once (at most the stats launch's n_blocks = min(ceil(n / 256), 1024)), and
// each CTA loops over the virtual block ids v = blockIdx.x, + gridDim.x, ...
// below n_blocks. Every iteration, while the state's done flag is clear:
//   A. each CTA takes the pose from shared memory and, for each of its
//      virtual block ids, computes that id's row of 29 sums with the stats
//      kernel's code (fused_stats.cuh, the same points per thread in the same
//      order, the same block reduction), so the rows are the two-launch
//      path's bit for bit; it writes them to the partials (a debug copy of
//      the first iteration's rows goes to rows_out when that is not null);
//   grid sync (cooperative_groups::this_grid().sync());
//   B. the n_blocks rows summed in double precision in one fixed order
//      (sum_rows: 8 lanes a column, lane j sums rows j, j + 8, ... in turn,
//      then the lanes in a fixed tree), which depends on n_blocks only, not
//      on the grid, so aligns repeat bit for bit on any card; then
//      gn_step.cuh's update:
//      the solve, |dx|, the test, T boxplus dx unless the step breaks the
//      loop, the histories, it, the flags, final_e2 and done once
//      it >= max_iter, into the GNState words (core/gn.py) that
//      gn_step.cu writes.
// Phase B runs in CTA 0, which sums the rows and updates the state in
// device memory, behind a second grid sync, after which every CTA reads the
// pose and done. The alternative, kRedundant = true, has every CTA sum the
// rows and update its own copy of the pose and counters in shared memory,
// the same bits everywhere, CTA 0 alone writing the state: one grid sync an
// iteration, the partials alternating between two buffers so that a CTA's
// next rows never overwrite rows a slower CTA still sums. The two took the
// same time on an H100 (0.1781 / 0.1783 ms for VPlaneICP's 4 iterations,
// 0.1382 / 0.1392 for NDT's 3; scripts/gn_loop_ablation.py builds the
// other), so the simpler one is built.
// The loop exits on the iteration JAX's cond does: the breaking step leaves
// T as it is, a non-finite dx sets failed. Rows, pose and flags written in
// this launch are read with ld.global.cg (L2), never through the
// non-coherent read-only path.
//
// What bounds it: the stats' work (fused_align.cu: about 2.7 MB and a
// microsecond of the card's rates an iteration) and 260 bytes of state; the
// grid syncs and phase B's serial solve are latency, a few microseconds an
// iteration, in place of the host's launches (tens of microseconds each).

#include <cooperative_groups.h>

#include "fused_stats.cuh"
#include "gn_step.cuh"

namespace {

namespace cg = cooperative_groups;
using pcr::kBlock;
using pcr::kStats;

// The stats kernel's register budget (fused_align.cu): three CTAs an SM.
constexpr int kMinBlocks = 3;
// Phase B in every CTA (see above) instead of in CTA 0.
constexpr bool kRedundant = false;
// Lanes per column of the fixed-order row sum.
constexpr int kSumLanes = 8;

// The n_rows rows of 29 sums at `rows` summed in the fixed order above, in
// double precision, into out[29] (shared), each rounded once to float;
// lanes is shared scratch of kSumLanes * 29 doubles. The two-launch loop
// sums its rows in double as well (ops/kernels/fused_align.py), so the two
// loops' sums are the same floats unless a sum lies within the doubles'
// rounding of a float's rounding boundary.
__device__ __forceinline__ void sum_rows(const float* rows, int n_rows, double* lanes,
                                         float* out) {
  const int t = threadIdx.x;
  if (t < kSumLanes * kStats) {
    const int j = t / kStats, c = t - j * kStats;
    double s = 0.0;
#pragma unroll 4
    for (int r = j; r < n_rows; r += kSumLanes)
      s += static_cast<double>(__ldcg(rows + static_cast<size_t>(r) * kStats + c));
    lanes[j * kStats + c] = s;
  }
  __syncthreads();
  if (t < kStats) {
    const double* l = lanes + t;
    const double low = (l[0] + l[kStats]) + (l[2 * kStats] + l[3 * kStats]);
    const double high = (l[4 * kStats] + l[5 * kStats]) + (l[6 * kStats] + l[7 * kStats]);
    out[t] = static_cast<float>(low + high);
  }
  __syncthreads();
}

static_assert(kSumLanes == 8, "sum_rows's tree adds 8 lanes");

template <int kKind>
__global__ void __launch_bounds__(kBlock, kMinBlocks) gn_loop_kernel(
    const int2* __restrict__ occ, const float4* __restrict__ centers,
    const float4* __restrict__ feats, int nx, int ny, int nz, int ox, int oy, int oz,
    float inv_cell, int radius, const float* __restrict__ src, const float* __restrict__ w,
    int n, int n_blocks, float max_dist, int use_huber, float huber_delta, float* poses,
    int* it, int* done, int* failed, int* converged, float* final_e2, float* e2_hist,
    float* dxn_hist, int* inl_hist, float* partials, float* rows_out, int max_iter,
    float tol) {
  cg::grid_group grid = cg::this_grid();
  const pcr::FusedMap map{occ, centers, feats, nx, ny, nz, ox, oy, oz, inv_cell, radius};
  __shared__ float pose_s[12];
  __shared__ float sums_s[kStats];
  __shared__ double lanes_s[kSumLanes * kStats];
  __shared__ pcr::GNCounters c_s;
  const int t = threadIdx.x;
  if (t < 12) pose_s[t] = __ldcg(poses + t);
  if (t == 0)
    c_s = pcr::GNCounters{__ldcg(it), __ldcg(done), __ldcg(failed), __ldcg(converged),
                          __ldcg(final_e2)};
  __syncthreads();
  for (int k = 0; !c_s.done; ++k) {
    // A. this CTA's rows at the current pose
    const pcr::Pose T{pose_s[0], pose_s[1], pose_s[2],  pose_s[3],  pose_s[4],  pose_s[5],
                      pose_s[6], pose_s[7], pose_s[8],  pose_s[9],  pose_s[10], pose_s[11]};
    float* part =
        partials + (kRedundant ? (k & 1) : 0) * static_cast<size_t>(n_blocks) * kStats;
    for (int v = blockIdx.x; v < n_blocks; v += gridDim.x) {
      float acc[kStats];
#pragma unroll
      for (int q = 0; q < kStats; ++q) acc[q] = 0.f;
      pcr::fused_block_stats<kKind>(map, src, w, n, T, v, n_blocks, max_dist, use_huber,
                                    huber_delta, acc);
      const float s = pcr::block_reduce_row(acc, part + static_cast<size_t>(v) * kStats);
      if (rows_out != nullptr && k == 0 && t < kStats)
        rows_out[static_cast<size_t>(v) * kStats + t] = s;
      __syncthreads();  // the block reduction's shared sums are reused
    }
    grid.sync();
    // B. the sum, the update; CTA 0 writes the state
    if (kRedundant || blockIdx.x == 0) {
      sum_rows(part, n_blocks, lanes_s, sums_s);
      if (t == 0) {
        pcr::gn_update(sums_s, pose_s, &c_s.it, &c_s.done, &c_s.failed, &c_s.converged,
                       &c_s.final_e2, nullptr, max_iter, tol,
                       [&](int at, float e2, float dx_norm, int inliers) {
                         if (blockIdx.x == 0) {
                           e2_hist[at] = e2;
                           dxn_hist[at] = dx_norm;
                           inl_hist[at] = inliers;
                         }
                       });
        if (blockIdx.x == 0) {
          for (int q = 0; q < 12; ++q) poses[q] = pose_s[q];
          *it = c_s.it;
          *failed = c_s.failed;
          *converged = c_s.converged;
          *final_e2 = c_s.final_e2;
          *done = c_s.done;
        }
      }
    }
    if (!kRedundant) {
      grid.sync();
      if (blockIdx.x != 0) {
        if (t < 12) pose_s[t] = __ldcg(poses + t);
        if (t == 0) c_s.done = __ldcg(done);
      }
    }
    __syncthreads();
  }
}

const void* kernel_of(int kind) {
  return kind == pcr::kPlane ? reinterpret_cast<const void*>(gn_loop_kernel<pcr::kPlane>)
                             : reinterpret_cast<const void*>(gn_loop_kernel<pcr::kNdt>);
}

// One cooperative launch of the kernel of `kind`: its CUDA error.
int launch(int kind, const int* occ, const float* centers, const float* feats, int nx,
           int ny, int nz, int ox, int oy, int oz, float inv_cell, int radius,
           const float* src, const float* w, int n, int n_blocks, float max_dist,
           int use_huber, float huber_delta, float* poses, int* it, int* done, int* failed,
           int* converged, float* final_e2, float* e2_hist, float* dxn_hist, int* inl_hist,
           float* partials, float* rows_out, int max_iter, float tol, int grid,
           void* stream) {
  void* args[] = {&occ,        &centers,  &feats,   &nx,        &ny,        &nz,
                  &ox,         &oy,       &oz,      &inv_cell,  &radius,    &src,
                  &w,          &n,        &n_blocks, &max_dist, &use_huber, &huber_delta,
                  &poses,      &it,       &done,    &failed,    &converged, &final_e2,
                  &e2_hist,    &dxn_hist, &inl_hist, &partials, &rows_out,  &max_iter,
                  &tol};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(kernel_of(kind), dim3(grid), dim3(kBlock), args, 0,
                                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Threads per CTA.
int pcr_gn_loop_block_size() { return kBlock; }

// CTAs of the kernel of `kind` (0 plane, 1 ndt) that fit on one SM at
// once, into *out; returns the CUDA error.
int pcr_gn_loop_blocks_per_sm(int kind, int* out) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel_of(kind), kBlock, 0));
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
