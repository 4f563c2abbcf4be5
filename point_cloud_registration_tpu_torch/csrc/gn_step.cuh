// The body of one Gauss-Newton iteration of one problem on the card, after
// its stats: shared by the update kernel (gn_step.cu, one launch per
// iteration of B problems) and the loop kernel (gn_loop.cu, the whole loop
// of one problem in one launch). gn_step.cu's note gives the operations and
// their rounding.

#pragma once

#include "gn_accumulate.cuh"

namespace pcr {

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

// The counters and flags of one problem: iterations run, done, failed,
// converged (0 or 1) and the last e2 (the loop kernel's copy in shared
// memory).
struct GNCounters {
  int it, done, failed, converged;
  float final_e2;
};

// One iteration of a problem that is not done, from its 29 packed stats
// `st`: dx = -H^-1 g (solve_6x6), |dx|, the test, T <- T boxplus dx on the
// pose row `pose` unless the step breaks the loop; then
// record(at, e2, |dx|, inliers) with at = clip(it, 0, max_iter - 1) (the
// caller writes the histories), and the counters and flags behind `it`,
// `done`, `failed`, `converged` and `final_e2`. dx_out, when not null,
// receives dx.
template <class Record>
__device__ __forceinline__ void gn_update(const float* st, float* pose, int* it, int* done,
                                          int* failed, int* converged, float* final_e2,
                                          float* dx_out, int max_iter, float tol,
                                          Record record) {
  float dx[6];
  solve_6x6(st, dx);
  if (dx_out != nullptr)
    for (int k = 0; k < 6; ++k) dx_out[k] = dx[k];
  float sq = __fmul_rn(dx[0], dx[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) sq = __fadd_rn(sq, __fmul_rn(dx[k], dx[k]));
  const float dx_norm = __fsqrt_rn(sq);
  const bool bad = !isfinite(dx_norm);
  const bool converged_now = dx_norm < tol;
  const bool done_now = converged_now || bad;
  if (!done_now) plus(pose, dx);
  const int i = *it;
  const float e2 = st[27];
  record(min(max(i, 0), max_iter - 1), e2, dx_norm, __float2int_rz(st[28]));
  *it = i + 1;
  *failed |= static_cast<int>(bad);
  *converged |= static_cast<int>(converged_now);
  *final_e2 = e2;
  *done = static_cast<int>(done_now || i + 1 >= max_iter);
}

}  // namespace pcr
