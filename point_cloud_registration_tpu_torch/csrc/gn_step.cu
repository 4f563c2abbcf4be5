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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kStats = 29;

// Index of H[i][j], i <= j, in the packed upper triangle (row-major).
__host__ __device__ constexpr int triu(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);
}

// H dx = -g, Jacobi scaling then the unrolled Cholesky of solve_6x6_batched
// (core/gn.py), every operation rounded once. A singular H gives NaNs.
__device__ __forceinline__ void solve_6x6(const float* __restrict__ st,
                                          float (&x)[6]) {
  float s[6], b[6], L[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float d = st[triu(i, i)];
    // np.maximum(d, 1e-30): NaN propagates
    const float m = isnan(d) ? d : fmaxf(d, 1e-30f);
    s[i] = __fdiv_rn(1.f, __fsqrt_rn(m));
    b[i] = -__fmul_rn(st[21 + i], s[i]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      // Hs[i][j] = (H[i][j] * s[i]) * s[j], H symmetric
      float acc = __fmul_rn(__fmul_rn(st[triu(j, i)], s[i]), s[j]);
#pragma unroll
      for (int k = 0; k < j; ++k) acc = __fsub_rn(acc, __fmul_rn(L[i][k], L[j][k]));
      L[i][j] = i == j ? __fsqrt_rn(acc) : __fdiv_rn(acc, L[j][j]);
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = __fsub_rn(acc, __fmul_rn(L[i][k], y[k]));
    y[i] = __fdiv_rn(acc, L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) acc = __fsub_rn(acc, __fmul_rn(L[k][i], x[k]));
    x[i] = __fdiv_rn(acc, L[i][i]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = __fmul_rn(x[i], s[i]);
}

// T <- T @ [[expSO3(dx[3:]), dx[:3]], [0, 0, 0, 1]] on the pose row
// p = [R row-major | t], the operations of core/se3.py::plus in its order:
// theta^2 = (wx wx + wy wy) + wz wz; I + W when theta^2 <= 1e-5, else
// (I + k1 W) + k2 (W W) with k1 = sin(theta) / theta, k2 = (1 - cos(theta)) /
// theta^2, sin and cos in double rounded to float; each entry of W W and of
// T @ M summed over k in turn (T's last column times M's last row included).
// Every operation rounds once, so the host's plus gives the same bits.
__device__ __forceinline__ void plus(float* __restrict__ p, const float (&dx)[6]) {
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float theta2 = __fadd_rn(__fadd_rn(__fmul_rn(wx, wx), __fmul_rn(wy, wy)),
                                 __fmul_rn(wz, wz));
  const float W[3][3] = {{0.f, -wz, wy}, {wz, 0.f, -wx}, {-wy, wx, 0.f}};
  const bool near_zero = theta2 <= 1e-5f;
  float k1 = 0.f, k2 = 0.f;
  if (!near_zero) {
    const float theta = __fsqrt_rn(theta2);
    const float s = __double2float_rn(sin(static_cast<double>(theta)));
    const float c = __double2float_rn(cos(static_cast<double>(theta)));
    k1 = __fdiv_rn(s, theta);
    k2 = __fdiv_rn(__fsub_rn(1.f, c), theta2);
  }
  float E[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      if (near_zero) {
        E[i][j] = __fadd_rn(eye, W[i][j]);
      } else {
        const float ww = __fadd_rn(__fadd_rn(__fmul_rn(W[i][0], W[0][j]),
                                             __fmul_rn(W[i][1], W[1][j])),
                                   __fmul_rn(W[i][2], W[2][j]));
        E[i][j] = __fadd_rn(__fadd_rn(eye, __fmul_rn(k1, W[i][j])), __fmul_rn(k2, ww));
      }
    }
  float out[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r0 = p[3 * i], r1 = p[3 * i + 1], r2 = p[3 * i + 2], t = p[9 + i];
#pragma unroll
    for (int j = 0; j < 3; ++j)  // M's last row is [0, 0, 0, 1]
      out[3 * i + j] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(r0, E[0][j]), __fmul_rn(r1, E[1][j])),
                    __fmul_rn(r2, E[2][j])),
          __fmul_rn(t, 0.f));
    out[9 + i] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(r0, dx[0]), __fmul_rn(r1, dx[1])), __fmul_rn(r2, dx[2])),
        t);
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) p[k] = out[k];
}

__global__ void __launch_bounds__(kThreads) gn_step_kernel(
    const float* __restrict__ stats, float* __restrict__ poses,
    int* __restrict__ it, int* __restrict__ done, int* __restrict__ failed,
    int* __restrict__ converged, float* __restrict__ final_e2,
    float* __restrict__ e2_hist, float* __restrict__ dxn_hist,
    int* __restrict__ inl_hist, float* __restrict__ dx_out, int B, int max_iter,
    float tol) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B || done[b]) return;
  const float* st = stats + static_cast<size_t>(kStats) * b;
  float dx[6];
  solve_6x6(st, dx);
  if (dx_out != nullptr)
    for (int k = 0; k < 6; ++k) dx_out[6 * b + k] = dx[k];
  float sq = __fmul_rn(dx[0], dx[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) sq = __fadd_rn(sq, __fmul_rn(dx[k], dx[k]));
  const float dx_norm = __fsqrt_rn(sq);
  const bool bad = !isfinite(dx_norm);
  const bool converged_now = dx_norm < tol;
  const bool done_now = converged_now || bad;
  if (!done_now) plus(poses + 12 * b, dx);
  const int i = it[b];
  const size_t at = static_cast<size_t>(b) * max_iter + min(max(i, 0), max_iter - 1);
  const float e2 = st[27];
  e2_hist[at] = e2;
  dxn_hist[at] = dx_norm;
  inl_hist[at] = __float2int_rz(st[28]);
  it[b] = i + 1;
  failed[b] |= static_cast<int>(bad);
  converged[b] |= static_cast<int>(converged_now);
  final_e2[b] = e2;
  done[b] = static_cast<int>(done_now || i + 1 >= max_iter);
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
