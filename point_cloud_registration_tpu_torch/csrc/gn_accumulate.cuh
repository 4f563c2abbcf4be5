// Shared pieces of the Gauss-Newton stats kernels (fused_align.cu,
// point_align.cu): the launch shape, the cell rule's clamp, the 29-term
// accumulator of sum w [J|r|1]^T [J|r|1], the one-row ("m = 1") plane
// linearization of VPlaneICP and PlaneICP, the three-row ("m = 3")
// linearization of NDT and point-to-point ICP, and the block reduction.
//
// Accumulator layout: [H upper triangle, row-major (21) | g (6) | e2 | n].

#pragma once

#include <cuda_runtime.h>

namespace pcr {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kStats = 29;

// Rotation and translation of one problem at one iteration (load_pose).
struct Pose {
  float r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2;
};

// The pose of one problem of a launch: its row of the (B, 12) device array
// [R row-major | t]. Every thread of the problem's blocks reads the same
// 48 bytes.
__device__ __forceinline__ Pose load_pose(const float* __restrict__ row) {
  return Pose{__ldg(row),     __ldg(row + 1), __ldg(row + 2),  __ldg(row + 3),
              __ldg(row + 4), __ldg(row + 5), __ldg(row + 6),  __ldg(row + 7),
              __ldg(row + 8), __ldg(row + 9), __ldg(row + 10), __ldg(row + 11)};
}

// Integer cell coordinate of the float cell index f, relative to origin. f is
// clamped before the float -> int conversion, so a query far outside the map
// (or NaN) lands outside the grid instead of overflowing the conversion.
__device__ __forceinline__ int clamped_cell(float f, int origin) {
  return static_cast<int>(fminf(fmaxf(f, -1e9f), 1e9f)) - origin;
}

// Adds w a a^T (upper triangle), w a r and w r^2 for one residual row
// a = J (6 entries) with residual r. The weight itself is counted by the
// caller, once per point.
__device__ __forceinline__ void accumulate_row(float* acc, float w,
                                               const float (&a)[6], float r) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float wa = w * a[i];
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += wa * a[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += w * a[i] * r;
  acc[27] += w * r * r;
}

// The m = 1 plane linearization of _linearize_and_reduce (ops/pallas/
// fused_align.py:283-306): r = n . d with d = q - target and
// a = [n, p x (R^T n)]. Huber, when enabled, weighs by |r|. The weight is
// counted once in acc[28].
__device__ __forceinline__ void accumulate_plane(
    float* acc, float w, const Pose& T, float px, float py, float pz, float nx,
    float ny, float nz, float dx, float dy, float dz, int use_huber,
    float huber_delta) {
  const float rs = nx * dx + ny * dy + nz * dz;
  if (use_huber) {
    const float ar = fabsf(rs);
    if (ar > huber_delta) w *= huber_delta / ar;
  }
  // R^T n, then p x (R^T n)
  const float tnx = T.r00 * nx + T.r10 * ny + T.r20 * nz;
  const float tny = T.r01 * nx + T.r11 * ny + T.r21 * nz;
  const float tnz = T.r02 * nx + T.r12 * ny + T.r22 * nz;
  const float a[6] = {nx, ny, nz, py * tnz - pz * tny, pz * tnx - px * tnz,
                      px * tny - py * tnx};
  accumulate_row(acc, w, a, rs);
  acc[28] += w;
}

// The m = 3 linearization of _linearize_and_reduce (ops/pallas/
// fused_align.py:308-357): J = [I | K] with K = -R skew(p), whitened by the
// upper-triangular U ([u00, u01, u02, u11, u12, u22], U^T U = icov; U = I for
// point-to-point ICP): rows J~ = U J and r~ = U d with d = q - mu. Huber, when
// enabled, weighs by |r~|. The weight is counted once in acc[28].
__device__ __forceinline__ void accumulate_whitened(
    float* acc, float w, const float (&u)[6], const Pose& T, float px,
    float py, float pz, float dx, float dy, float dz, int use_huber,
    float huber_delta) {
  const float k[3][3] = {
      {T.r02 * py - T.r01 * pz, T.r00 * pz - T.r02 * px, T.r01 * px - T.r00 * py},
      {T.r12 * py - T.r11 * pz, T.r10 * pz - T.r12 * px, T.r11 * px - T.r10 * py},
      {T.r22 * py - T.r21 * pz, T.r20 * pz - T.r22 * px, T.r21 * px - T.r20 * py}};
  const float U[3][3] = {{u[0], u[1], u[2]}, {0.f, u[3], u[4]}, {0.f, 0.f, u[5]}};
  float res[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) res[m] = U[m][0] * dx + U[m][1] * dy + U[m][2] * dz;
  if (use_huber) {
    const float rn = sqrtf(fmaxf(res[0] * res[0] + res[1] * res[1] + res[2] * res[2], 0.f));
    if (rn > huber_delta) w *= huber_delta / rn;
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    float a[6];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[j] = U[m][j];
      a[3 + j] = U[m][0] * k[0][j] + U[m][1] * k[1][j] + U[m][2] * k[2][j];
    }
    accumulate_row(acc, w, a, res[m]);
  }
  acc[28] += w;
}

// Sums the per-thread accumulators of a block of kBlockWarps warps (warp
// shuffles, then shared memory) into `row` (29 floats); thread k < 29 also
// returns sum k (the others 0). No atomics: the sums repeat bit for bit from
// run to run. A block that reduces again must pass a __syncthreads() first:
// the warps' sums share one buffer.
template <int kBlockWarps = kWarps>
__device__ __forceinline__ float block_reduce_row(const float* acc, float* row) {
  __shared__ float warp_sums[kBlockWarps][kStats];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kStats; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < kStats) {
#pragma unroll
    for (int wi = 0; wi < kBlockWarps; ++wi) s += warp_sums[wi][threadIdx.x];
    row[threadIdx.x] = s;
  }
  return s;
}

// block_reduce_row into row blockIdx.y * gridDim.x + blockIdx.x of
// `partials` (B, n_blocks, 29): a launch runs problem blockIdx.y on its row
// of gridDim.x blocks, so for a fixed launch shape the rows repeat bit for
// bit from run to run.
template <int kBlockWarps = kWarps>
__device__ __forceinline__ void block_reduce_store(const float* acc,
                                                   float* __restrict__ partials) {
  const size_t row = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  block_reduce_row<kBlockWarps>(acc, partials + row * kStats);
}

}  // namespace pcr
