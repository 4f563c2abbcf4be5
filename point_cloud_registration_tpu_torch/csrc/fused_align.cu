// Fused correspondence + point-to-plane linearization + reduction, one
// Gauss-Newton iteration of VPlaneICP, for Hopper (sm_90a).
//
// Replaces the TPU kernel point_cloud_registration_tpu/ops/pallas/fused_align.py
// (_make_kernel with _linearize_and_reduce, kind "plane"). It computes the same
// sums from another table layout: one row per voxel cell in linear-key order,
// [mu_x, mu_y, mu_z, valid, n_x, n_y, n_z, 0] (see ops/knn.py).
//
// Per scan point p (one thread per point, grid-stride loop):
//   q = R p + t, formed in registers (R and t are passed by value);
//   c = floor(q * inv_cell) - origin;
//   probe every cell of [c - r, c + r]^3, x fastest and z slowest, skipping
//   cells outside the grid and invalid cells; keep the nearest centroid by
//   d2 = sum (q - mu)^2 with a strict "<", so the first minimum in probe
//   order wins;
//   w = w_in * found * (sqrt(d2) < max_dist), times the Huber weight of |r|
//   when enabled;
//   a = [n, p x (R^T n), r] with r = n . (q - mu), and accumulate the 29
//   unique terms of w [a|1]^T [a|1]: H upper triangle (21), g (6), e2, n.
// The TPU kernel probes a window of whole (4, 8, 4) blocks, a superset of
// these cells; every cell beyond [c - r, c + r] lies at least max_dist away
// and is gated out, so the gated correspondences are the same.
//
// Reduction: warp shuffles, then shared memory, one row of partials per
// block; the wrapper sums the rows. No atomics: for a fixed launch shape the
// sums, and so the iteration count of the GN loop, repeat from run to run.
//
// Bound: memory latency. At the bench size (100k scan points, radius 2) an
// iteration makes 100k x 125 probes, each one 16-byte load, about 0.2 GB,
// while the table (about 0.84M cells x 32 B = 27 MB) stays in the 50 MB L2.
// The arithmetic is a few hundred FLOPs per point. Threads are independent,
// so many warps in flight hide the L2 latency; nothing is staged in shared
// memory.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kStats = 29;
// A squared distance at or above FOUND_MAX**2 (ops/knn.py) means no valid
// cell was found; it also rejects the +inf initial value.
constexpr float kFoundMax2 = 1e28f;
// Cell coordinates are clamped before the float -> int conversion, so a
// query far outside the map (or NaN) lands outside the grid instead of
// overflowing the conversion.
constexpr float kCellClamp = 1e9f;

__device__ __forceinline__ int cell_of(float v, float inv_cell, int origin) {
  float f = fminf(fmaxf(floorf(v * inv_cell), -kCellClamp), kCellClamp);
  return static_cast<int>(f) - origin;
}

__global__ void __launch_bounds__(kBlock) fused_plane_stats_kernel(
    const float4* __restrict__ table, int nx, int ny, int nz, int ox, int oy,
    int oz, float inv_cell, int radius, const float* __restrict__ src,
    const float* __restrict__ w, int n, float r00, float r01, float r02,
    float r10, float r11, float r12, float r20, float r21, float r22, float t0,
    float t1, float t2, float max_dist, int use_huber, float huber_delta,
    float* __restrict__ partials) {
  float acc[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kBlock + threadIdx.x; i < n;
       i += gridDim.x * kBlock) {
    const float px = src[3 * i], py = src[3 * i + 1], pz = src[3 * i + 2];
    // q = R p + t in the JAX package's order: ((x R0 + y R1) + z R2) + t.
    const float qx = px * r00 + py * r01 + pz * r02 + t0;
    const float qy = px * r10 + py * r11 + pz * r12 + t1;
    const float qz = px * r20 + py * r21 + pz * r22 + t2;
    const int cx = cell_of(qx, inv_cell, ox);
    const int cy = cell_of(qy, inv_cell, oy);
    const int cz = cell_of(qz, inv_cell, oz);

    float best = __int_as_float(0x7f800000);  // +inf
    int best_key = -1;
    const int x0 = max(cx - radius, 0), x1 = min(cx + radius, nx - 1);
    const int y0 = max(cy - radius, 0), y1 = min(cy + radius, ny - 1);
    const int z0 = max(cz - radius, 0), z1 = min(cz + radius, nz - 1);
    for (int z = z0; z <= z1; ++z) {
      for (int y = y0; y <= y1; ++y) {
        const int row = nx * (y + ny * z);
        for (int x = x0; x <= x1; ++x) {
          const float4 c = __ldg(&table[2 * (row + x)]);
          if (c.w > 0.f) {
            const float dx = qx - c.x, dy = qy - c.y, dz = qz - c.z;
            const float d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < best) {
              best = d2;
              best_key = row + x;
            }
          }
        }
      }
    }
    if (!(best < kFoundMax2) || !(sqrtf(best) < max_dist)) continue;
    float wq = w[i];
    const float4 mu = __ldg(&table[2 * best_key]);
    const float4 nv = __ldg(&table[2 * best_key + 1]);
    const float rs = nv.x * (qx - mu.x) + nv.y * (qy - mu.y) + nv.z * (qz - mu.z);
    if (use_huber) {
      const float ar = fabsf(rs);
      if (ar > huber_delta) wq *= huber_delta / ar;
    }
    // R^T n, then p x (R^T n)
    const float tnx = r00 * nv.x + r10 * nv.y + r20 * nv.z;
    const float tny = r01 * nv.x + r11 * nv.y + r21 * nv.z;
    const float tnz = r02 * nv.x + r12 * nv.y + r22 * nv.z;
    const float a[7] = {nv.x, nv.y, nv.z, py * tnz - pz * tny,
                        pz * tnx - px * tnz, px * tny - py * tnx, rs};
    int k = 0;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const float wa = wq * a[r];
#pragma unroll
      for (int c = r; c < 6; ++c) acc[k++] += wa * a[c];
    }
#pragma unroll
    for (int r = 0; r < 6; ++r) acc[21 + r] += wq * a[r] * rs;
    acc[27] += wq * rs * rs;
    acc[28] += wq;
  }

  __shared__ float warp_sums[kWarps][kStats];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kStats; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kStats) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += warp_sums[wi][threadIdx.x];
    partials[blockIdx.x * kStats + threadIdx.x] = s;
  }
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes the partials as (n_blocks, 29).
int pcr_fused_plane_block_size() { return kBlock; }

// Launches the kernel on `stream` and returns cudaGetLastError().
int pcr_fused_plane_stats(const float* table, int nx, int ny, int nz, int ox,
                          int oy, int oz, float inv_cell, int radius,
                          const float* src, const float* w, int n, float r00,
                          float r01, float r02, float r10, float r11, float r12,
                          float r20, float r21, float r22, float t0, float t1,
                          float t2, float max_dist, int use_huber,
                          float huber_delta, float* partials, int n_blocks,
                          void* stream) {
  fused_plane_stats_kernel<<<n_blocks, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), nx, ny, nz, ox, oy, oz, inv_cell,
      radius, src, w, n, r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1,
      t2, max_dist, use_huber, huber_delta, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
