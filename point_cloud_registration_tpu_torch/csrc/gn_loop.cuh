// The whole Gauss-Newton loop of one problem in one cooperative launch, for
// Hopper (sm_90a), over any stats body: the loop kernel of gn_loop.cu (the
// fused voxel stats: VPlaneICP and NDT on a dense map), point_loop.cu (the
// packed-grid stats: ICP and PlaneICP) and grid_loop.cu (the grid stats: ICP
// and PlaneICP on a small target, VPlaneICP and NDT on a hashed map). Below
// it, the loop of B problems in one launch (gn_loop_batched_kernel, built in
// gn_loop.cu and point_loop.cu for the batched streams).
//
// Counterpart of the JAX package's compiled loop: gauss_newton's
// jax.lax.while_loop (point_cloud_registration_tpu/core/gn.py:124-192)
// around a solver's stats. An align there is one dispatch on the device;
// here it is one cooperative launch, where the two-launch loop (core/gn.py::
// gauss_newton_device: the stats kernel, a sum of its block rows, gn_step.cu)
// launches three kernels an iteration from the host and reads the state once
// per chunk of iterations.
//
// The kernel is persistent: its grid is the CTAs that fit on the card at
// once (at most the stats launch's n_blocks), and each CTA loops over the
// virtual block ids v = blockIdx.x, + gridDim.x, ... below n_blocks. Before
// the first iteration each CTA runs the stats' setup (what does not change
// across iterations, such as a sampled key index in shared memory). Every
// iteration, while the state's done flag is clear:
//   A. each CTA takes the pose from shared memory and, for each of its
//      virtual block ids, computes that id's row of 29 sums with the stats
//      kernel's own body (the same points per thread in the same order, the
//      same block reduction), so the rows are the two-launch path's bit for
//      bit; it writes them to the partials (a debug copy of the first
//      iteration's rows goes to rows_out when that is not null);
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
// this launch are read with ld.global.cg (L2) or from shared memory, never
// through the non-coherent read-only path; a stats body reads the pose
// only from the shared copy it is handed.
//
// A stats body is a type Stats with
//   kThreads, kMinBlocks: the stats kernel's block and its CTAs an SM (the
//     loop keeps its register budget);
//   Shared: what its CTA keeps in shared memory across the loop;
//   Cta setup(Shared&) const: the per-CTA setup, returning what it keeps in
//     registers (every thread of the CTA calls it; the loop syncs after it);
//   float row(Shared&, const Cta&, const float* pose, int v, int n_blocks,
//     float* out) const: the row of virtual block v of n_blocks at the pose
//     (12 floats in shared memory) into out[29]; thread k < 29 returns sum
//     k. Every thread of the CTA calls it;
//   and, for the batched kernel, the members src, w (the scan and weights)
//     and n (points a problem), which batch_problem moves to a problem's rows.
//
// What bounds it: the stats' work (each kernel's note) and 260 bytes of
// state; the grid syncs and phase B's serial solve are latency, a few
// microseconds an iteration, in place of the host's launches (tens of
// microseconds each).

#pragma once

#include <cooperative_groups.h>

#include "gn_accumulate.cuh"
#include "gn_step.cuh"

namespace pcr {

// Phase B in every CTA (see above) instead of in CTA 0.
constexpr bool kRedundant = false;
// Lanes per column of the fixed-order row sum.
constexpr int kSumLanes = 8;

// The loop's state on the device (core/gn.py's GNState at B = 1), its
// scratch and its settings: the kernel's arguments after the stats body.
struct LoopState {
  float* poses;
  int* it;
  int* done;
  int* failed;
  int* converged;
  float* final_e2;
  float* e2_hist;
  float* dxn_hist;
  int* inl_hist;
  float* partials;  // 2 * n_blocks * 29 floats
  float* rows_out;  // n_blocks * 29 floats, or null
  int n_blocks;
  int max_iter;
  float tol;
};

// The n_rows rows of 29 sums at `rows` summed in the fixed order above, in
// double precision, into out[29] (shared), each rounded once to float;
// lanes is shared scratch of kSumLanes * 29 doubles. The two-launch loop
// sums its rows in double as well (ops/kernels/fused_align.py::
// bound_launch), so the two loops' sums are the same floats unless a sum
// lies within the doubles' rounding of a float's rounding boundary.
template <int kThreads>
__device__ __forceinline__ void sum_rows(const float* rows, int n_rows, double* lanes,
                                         float* out) {
  const int t = threadIdx.x;
  // lane j of column c: thread j * 29 + c, in passes of kThreads threads
#pragma unroll 1
  for (int pass = 0; pass < (kSumLanes * kStats + kThreads - 1) / kThreads; ++pass) {
    const int jc = pass * kThreads + t;
    if (jc < kSumLanes * kStats) {
      const int j = jc / kStats, c = jc - j * kStats;
      double s = 0.0;
#pragma unroll 4
      for (int r = j; r < n_rows; r += kSumLanes)
        s += static_cast<double>(__ldcg(rows + static_cast<size_t>(r) * kStats + c));
      lanes[j * kStats + c] = s;
    }
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

// The state's words come as scalar arguments (LoopState's fields), as
// scalars are read from the constant bank where they are used: a struct
// argument's fields were hoisted into registers and cost the fused kinds a
// register and a spill, and 6 % of their time on an H100.
template <class Stats>
__global__ void __launch_bounds__(Stats::kThreads, Stats::kMinBlocks) gn_loop_kernel(
    const Stats stats, float* poses, int* it, int* done, int* failed, int* converged,
    float* final_e2, float* e2_hist, float* dxn_hist, int* inl_hist, float* partials,
    float* rows_out, int n_blocks, int max_iter, float tol) {
  static_assert(Stats::kThreads >= 32, "a CTA holds the pose and the 29 sums");
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ float pose_s[12];
  __shared__ float sums_s[kStats];
  __shared__ double lanes_s[kSumLanes * kStats];
  __shared__ GNCounters c_s;
  __shared__ typename Stats::Shared stats_s;
  const int t = threadIdx.x;
  const auto cta = stats.setup(stats_s);
  if (t < 12) pose_s[t] = __ldcg(poses + t);
  if (t == 0)
    c_s = GNCounters{__ldcg(it), __ldcg(done), __ldcg(failed), __ldcg(converged),
                     __ldcg(final_e2)};
  __syncthreads();
  for (int k = 0; !c_s.done; ++k) {
    // A. this CTA's rows at the current pose
    float* part =
        partials + (kRedundant ? (k & 1) : 0) * static_cast<size_t>(n_blocks) * kStats;
    for (int v = blockIdx.x; v < n_blocks; v += gridDim.x) {
      const float s =
          stats.row(stats_s, cta, pose_s, v, n_blocks, part + static_cast<size_t>(v) * kStats);
      if (rows_out != nullptr && k == 0 && t < kStats)
        rows_out[static_cast<size_t>(v) * kStats + t] = s;
      __syncthreads();  // the block reduction's shared sums are reused
    }
    grid.sync();
    // B. the sum, the update; CTA 0 writes the state
    if (kRedundant || blockIdx.x == 0) {
      sum_rows<Stats::kThreads>(part, n_blocks, lanes_s, sums_s);
      if (t == 0) {
        gn_update(sums_s, pose_s, &c_s.it, &c_s.done, &c_s.failed, &c_s.converged,
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

// The loop of B problems in one cooperative launch (counterpart of the JAX
// package's batched_gauss_newton while_loop, models/_fused.py:288-355, around
// the batched stats): the same kernel over the B problems' scans, each a
// problem's rows of a (B, n, 3) scan and (B, n) weights, with its own pose
// and state words (GNState's B rows). The virtual block ids are
// (problem b, block v), id = b * n_blocks + v, problem-major, and a CTA takes
// the ids blockIdx.x, + gridDim.x, ... below B * n_blocks. Every iteration,
// while any problem is not done:
//   A. for each of its ids whose problem is not done, the row of block v of
//      problem b with the stats body of that problem (batch_problem: the body
//      with its scan and weights moved to problem b's rows), at b's pose,
//      loaded into shared memory when the CTA's ids move to a new problem;
//      the row goes to row id of the (B, n_blocks, 29) partials (and of
//      rows_out at the first iteration), the batched stats kernel's row
//      blockIdx.y * n_blocks + blockIdx.x, the same bits;
//   grid sync;
//   B. each problem that is not done, in CTA b mod gridDim.x: its n_blocks
//      rows summed by sum_rows (the fixed order of one problem's loop, which
//      depends on n_blocks only), then gn_update on its state words;
//   grid sync, then every CTA reads the done flags.
// A done problem's ids are skipped and its words are never written again,
// as the JAX loop's active mask and gn_step.cu leave it. Per problem the
// rows, the sums and the update are those of the single-problem loop
// kernel over that problem's scan, so the problem's state is that align's,
// bit for bit. The ids are ints: B * n_blocks stays below 2^31 (the
// wrapper checks), and B has no other bound (the batched stats kernel's is
// 65,535, the grid's y dimension). The loop over ids keeps more state live
// than the single-problem loop: under the stats' register budget the
// batched kernels spill 56-224 bytes where the single-problem ones spill
// 0-56 (ptxas, sm_90a).

// The stats body of problem b of a batch: a copy of `stats` whose scan and
// weights are problem b's rows of the (B, n, 3) scan and (B, n) weights.
template <class Stats>
__device__ __forceinline__ Stats batch_problem(const Stats& stats, int b) {
  Stats s = stats;
  s.src += static_cast<size_t>(b) * 3 * s.n;
  s.w += static_cast<size_t>(b) * s.n;
  return s;
}

template <class Stats>
__global__ void __launch_bounds__(Stats::kThreads, Stats::kMinBlocks) gn_loop_batched_kernel(
    const Stats stats, float* poses, int* it, int* done, int* failed, int* converged,
    float* final_e2, float* e2_hist, float* dxn_hist, int* inl_hist, float* partials,
    float* rows_out, int n_blocks, int B, int max_iter, float tol) {
  static_assert(Stats::kThreads >= 32, "a CTA holds the pose and the 29 sums");
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ float pose_s[12];
  __shared__ float sums_s[kStats];
  __shared__ double lanes_s[kSumLanes * kStats];
  __shared__ int live_s;
  __shared__ typename Stats::Shared stats_s;
  const int t = threadIdx.x;
  const auto cta = stats.setup(stats_s);
  const int total = B * n_blocks;
  int live = 0;
  for (int b = t; b < B; b += Stats::kThreads) live |= !__ldcg(done + b);
  live = __syncthreads_or(live);
  for (int k = 0; live; ++k) {
    // A. this CTA's rows, each at its problem's current pose
    int loaded = -1;
    for (int id = blockIdx.x; id < total; id += gridDim.x) {
      const int b = id / n_blocks, v = id - b * n_blocks;
      if (b != loaded) {
        __syncthreads();  // every thread is past the previous problem's pose
        if (t < 12) pose_s[t] = __ldcg(poses + 12 * static_cast<size_t>(b) + t);
        if (t == 0) live_s = !__ldcg(done + b);
        __syncthreads();
        loaded = b;
      }
      if (!live_s) continue;
      const float s = batch_problem(stats, b).row(stats_s, cta, pose_s, v, n_blocks,
                                                  partials + static_cast<size_t>(id) * kStats);
      if (rows_out != nullptr && k == 0 && t < kStats)
        rows_out[static_cast<size_t>(id) * kStats + t] = s;
      __syncthreads();  // the block reduction's shared sums are reused
    }
    grid.sync();
    // B. each live problem of this CTA: the sum, the update
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      if (__ldcg(done + b)) continue;  // read by every thread before thread 0 writes it
      if (t < 12) pose_s[t] = __ldcg(poses + 12 * static_cast<size_t>(b) + t);
      sum_rows<Stats::kThreads>(partials + static_cast<size_t>(b) * n_blocks * kStats, n_blocks,
                                lanes_s, sums_s);
      if (t == 0) {
        GNCounters c{__ldcg(it + b), 0, __ldcg(failed + b), __ldcg(converged + b),
                     __ldcg(final_e2 + b)};
        const size_t row = static_cast<size_t>(b) * max_iter;
        gn_update(sums_s, pose_s, &c.it, &c.done, &c.failed, &c.converged, &c.final_e2,
                  nullptr, max_iter, tol, [&](int at, float e2, float dx_norm, int inliers) {
                    e2_hist[row + at] = e2;
                    dxn_hist[row + at] = dx_norm;
                    inl_hist[row + at] = inliers;
                  });
        for (int q = 0; q < 12; ++q) poses[12 * static_cast<size_t>(b) + q] = pose_s[q];
        it[b] = c.it;
        failed[b] = c.failed;
        converged[b] = c.converged;
        final_e2[b] = c.final_e2;
        done[b] = c.done;
      }
      __syncthreads();  // pose_s and sums_s are reused
    }
    grid.sync();
    live = 0;
    for (int b = t; b < B; b += Stats::kThreads) live |= !__ldcg(done + b);
    live = __syncthreads_or(live);
  }
}

// A stats body with nothing to keep across the loop.
struct NoShared {};
struct NoCta {};

// The CTAs of the loop kernel over `Stats` that fit on one SM at once, into
// *out; returns the CUDA error.
template <class Stats>
int loop_blocks_per_sm(int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, gn_loop_kernel<Stats>, Stats::kThreads, 0));
}

// One cooperative launch of the loop kernel over `stats` with `grid` CTAs
// (at most the co-resident count: more are refused) on `stream`: its CUDA
// error.
template <class Stats>
int launch_loop(Stats stats, LoopState st, int grid, void* stream) {
  void* args[] = {&stats,       &st.poses,    &st.it,       &st.done,     &st.failed,
                  &st.converged, &st.final_e2, &st.e2_hist,  &st.dxn_hist, &st.inl_hist,
                  &st.partials, &st.rows_out, &st.n_blocks, &st.max_iter, &st.tol};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gn_loop_kernel<Stats>), dim3(grid), dim3(Stats::kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  // read (and so clear) the last error either way: a refused launch must not
  // surface later at another launch
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The CTAs of the batched loop kernel over `Stats` that fit on one SM at
// once, into *out; returns the CUDA error.
template <class Stats>
int loop_batched_blocks_per_sm(int* out) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, gn_loop_batched_kernel<Stats>, Stats::kThreads, 0));
}

// One cooperative launch of the batched loop kernel over `stats` (the body
// of problem 0: its scan and weights are the batch's first rows) for B
// problems with `grid` CTAs on `stream`: its CUDA error. st names the B
// problems' state words; its partials and rows_out hold B * n_blocks rows.
template <class Stats>
int launch_loop_batched(Stats stats, LoopState st, int B, int grid, void* stream) {
  void* args[] = {&stats,       &st.poses,    &st.it,       &st.done,     &st.failed,
                  &st.converged, &st.final_e2, &st.e2_hist,  &st.dxn_hist, &st.inl_hist,
                  &st.partials, &st.rows_out, &st.n_blocks, &B,           &st.max_iter,
                  &st.tol};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gn_loop_batched_kernel<Stats>), dim3(grid),
      dim3(Stats::kThreads), args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace pcr

// The trailing arguments of the C entries of point_loop.cu and
// grid_loop.cu: the state words of core/gn.py's GNState at B = 1 (poses 12
// floats, it, done, failed, converged, final_e2, the three histories of
// max_iter entries), read at the start and left as the loop ends; partials
// 2 * n_blocks * 29 floats of scratch; rows_out n_blocks * 29 floats that
// receive the first iteration's block rows, or null; n_blocks the stats
// launch's block count (the virtual block ids); the settings, the grid
// (at most the co-resident CTAs) and the stream.
#define PCR_LOOP_STATE_PARAMS                                                            \
  float *poses, int *it, int *done, int *failed, int *converged, float *final_e2,        \
      float *e2_hist, float *dxn_hist, int *inl_hist, float *partials, float *rows_out, \
      int n_blocks, int max_iter, float tol, int grid, void *stream
#define PCR_LOOP_STATE                                                                   \
  pcr::LoopState {                                                                       \
    poses, it, done, failed, converged, final_e2, e2_hist, dxn_hist, inl_hist, partials, \
        rows_out, n_blocks, max_iter, tol                                                \
  }
