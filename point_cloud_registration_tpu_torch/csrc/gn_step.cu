// One Gauss-Newton update of B problems on the card, for Hopper (sm_90a): the
// body of the Gauss-Newton while_loop after the stats kernels.
//
// Counterpart of the XLA code of point_cloud_registration_tpu/core/gn.py
// (solve_6x6 :78, the loop body :124-192) and of the batched loop of
// models/_fused.py::batched_gauss_newton (:288-355); there is no Pallas
// kernel behind it. One thread per problem b reads the problem's 29 packed
// stats ([H upper triangle, row-major (21) | g (6) | e2 | n_inliers]) and its
// state, and does what one body of the loop does:
//   1. dx = -H^-1 g by the Jacobi-scaled unrolled Cholesky of solve_6x6, in
//      its operation order;
//   2. |dx| as the sequential sum of squares, then sqrt;
//   3. bad = !isfinite(|dx|), converged_now = |dx| < tol;
//   4. on the breaking step (converged_now or bad) the pose stays;
//   5. otherwise T <- T boxplus dx (core/se3.py::plus, expSO3 with its
//      theta^2 <= 1e-5 branch);
//   6. e2, |dx| and n_inliers into the histories at clip(it, 0, max_iter - 1),
//      it += 1, the flags, final_e2, and done once it >= max_iter.
// A problem that is done is left as it is: its call is a no-op, so a launch
// enqueued past the end of an align changes nothing.
//
// The state lives on the card between launches: poses (B, 12) [R row-major |
// t] (the layout the stats kernels read), it, done, failed, converged (B,)
// int32, final_e2 (B,) and the (B, max_iter) histories of e2, |dx| (float32)
// and n_inliers (int32).
//
// Rounding. Every operation is an _rn intrinsic, one rounding each, so nvcc's
// default FMA contraction cannot fuse a product into the next sum: the solve,
// the norm and the update are the host's float32 solve_6x6_batched,
// step_norm and se3.plus bit for bit (sin and cos in double, rounded once,
// as the host takes them; the two libraries' double results round to the
// same float unless they straddle a rounding boundary).
//
// What bounds it: 116 bytes of stats and about 0.5 kB of state a problem, and
// a few hundred flops: nanoseconds of the card's rates. A launch costs more
// than the work.

#include "gn_step.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads) gn_step_kernel(
    const float* __restrict__ stats, float* __restrict__ poses,
    int* __restrict__ it, int* __restrict__ done, int* __restrict__ failed,
    int* __restrict__ converged, float* __restrict__ final_e2,
    float* __restrict__ e2_hist, float* __restrict__ dxn_hist,
    int* __restrict__ inl_hist, float* __restrict__ dx_out, int B, int max_iter,
    float tol) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B || done[b]) return;
  const size_t row = static_cast<size_t>(b) * max_iter;
  pcr::gn_update(stats + static_cast<size_t>(pcr::kStats) * b, poses + 12 * b, it + b, done + b,
                 failed + b, converged + b, final_e2 + b,
                 dx_out != nullptr ? dx_out + 6 * b : nullptr, max_iter, tol,
                 [&](int at, float e2, float dx_norm, int inliers) {
                   e2_hist[row + at] = e2;
                   dxn_hist[row + at] = dx_norm;
                   inl_hist[row + at] = inliers;
                 });
}

}  // namespace

extern "C" {

// Launches one update of the B problems on `stream`; returns
// cudaGetLastError(). stats (B, 29) f32; the state as above, all on the
// card; dx_out (B, 6) f32 receives each live problem's step, or is null.
int pcr_gn_step(const float* stats, float* poses, int* it, int* done,
                int* failed, int* converged, float* final_e2, float* e2_hist,
                float* dxn_hist, int* inl_hist, float* dx_out, int B,
                int max_iter, float tol, void* stream) {
  gn_step_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      stats, poses, it, done, failed, converged, final_e2, e2_hist, dxn_hist,
      inl_hist, dx_out, B, max_iter, tol);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
