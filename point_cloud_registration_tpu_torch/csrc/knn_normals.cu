// k-NN moments for PCA normals on the packed point grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel point_cloud_registration_tpu/ops/pallas/
// knn_normals.py (_make_knn_kernel, launched by knn_moments_call). Per query
// point q it computes the same ten values:
//
//   candidates: every kept point of every packed block inside the query's
//     box of fused blocks (a fused block is 2x2x1 packed blocks = 4x4x2 fine
//     cells). The fine cell is c = floor(q * (1 / cell)) - origin_fine, a
//     multiply by the float32 reciprocal as in point_align.py _fused_block
//     (the packed build bins by a true division); the box starts at
//     floor((c - r) / (4, 4, 2)) and spans (2 r + f - 1) / f + 1 fused blocks
//     per axis: 4x4x3 packed blocks at r = 2, 6x6x5 at r = 4, clipped to the
//     grid. It covers the fine window [c - r, c + r], hence the closed ball
//     of r * cell around q;
//   rk2: the k-th smallest squared distance over the candidates (the k-th
//     order statistic, equal distances counted one by one); done = at least
//     k candidates;
//   the query-centred moments over the candidates with d2 <= rk2, ties
//     included (all candidates when not done): count, mean = sum d / count,
//     cov = sum d d^T / count - mean mean^T, stored as c00 c11 c22 c01 c02 c12
//     (the algebra of ops/normals.py normals_from_neighbors; query-centred,
//     so float32-stable far from the origin);
//   unresolved = !done && w > 0;
//   exact = done && rk2 < (r * cell)^2 && no truncated block in the box: the
//     k nearest of the kept points are then provably the k nearest of all.
// The TPU kernel's third reason to leave a query unresolved, a probe key
// absent from its tile's key list, cannot arise: a thread reads block_row
// itself. Its k rounds of next-minimum ascent compute the same order
// statistic; here a sorted buffer of the kMax smallest distances lives in
// registers (an unrolled compare-and-swap chain, no dynamic indexing), and a
// second walk of the box accumulates the moments.
//
// The squared distance is rounded product by product and sum by sum (no
// fused multiply-add), in the plain PyTorch version's order, so that rk2,
// the selection and the flags equal that version's bit for bit and the two
// walks agree with each other. No atomics: a thread writes its own ten
// outputs, so runs repeat bit for bit.
//
// Output: out (10, n) f32, planar: rows c00 c11 c22 c01 c02 c12 count rk2
// unresolved exact.
//
// What limits it: memory latency and the issue rate, not bandwidth. A query
// walks 48 (r = 2) or 180 (r = 4) packed rows of up to cap x 12 bytes twice,
// from its own addresses; neighbouring queries share rows only when the
// caller orders them in space. The function itself needs each candidate's
// distance once and the moments of the selected points, and every input and
// output moved once (queries, packed rows, 40 B out per query: a few hundred
// megabytes at 1.2M queries); that traffic, not the arithmetic, is the least
// time the card could take. The second walk is this kernel's choice.

#include "gn_accumulate.cuh"

namespace {

constexpr int kBlock = 128;
// A squared distance at or above FOUND_MAX**2 (ops/knn.py) is no candidate.
constexpr float kFoundMax2 = 1e28f;
constexpr float kMissD2 = 1e30f;  // rk2 of a query with fewer than k candidates
constexpr int kOut = 10;

// floor(a / b) for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return q - ((a % b) < 0);
}

struct Grid {
  const float* pts;
  const int* row_count;
  const int* block_row;
  const unsigned char* row_over;
  int cap, width, nbx, nby, nbz;
};

// Calls f(dx, dy, dz, d2) for every kept point of the packed blocks
// [x0, x1) x [y0, y1) x [z0, z1), x fastest, slots in packed order. Returns
// whether any of those blocks was truncated at the cap.
template <class F>
__device__ __forceinline__ bool walk_box(const Grid& g, int x0, int x1, int y0,
                                         int y1, int z0, int z1, float qx,
                                         float qy, float qz, F&& f) {
  bool over = false;
  for (int z = z0; z < z1; ++z) {
    for (int y = y0; y < y1; ++y) {
      const int key0 = g.nbx * (y + g.nby * z);
      for (int x = x0; x < x1; ++x) {
        const int row = __ldg(&g.block_row[key0 + x]);
        if (row < 0) continue;
        over |= __ldg(&g.row_over[row]) != 0;
        const int cnt = __ldg(&g.row_count[row]);
        const float* p = g.pts + static_cast<long long>(row) * g.cap * g.width;
        for (int s = 0; s < cnt; ++s, p += g.width) {
          const float dx = qx - __ldg(p), dy = qy - __ldg(p + 1),
                      dz = qz - __ldg(p + 2);
          const float d2 = __fadd_rn(
              __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          f(dx, dy, dz, d2);
        }
      }
    }
  }
  return over;
}

template <int kMax>
__global__ void __launch_bounds__(kBlock) knn_moments_kernel(
    Grid g, int ofx, int ofy, int ofz, float inv_cell, float exact_d2,
    int radius, int k, const float* __restrict__ q, const float* __restrict__ w,
    int n, float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float kInf = __int_as_float(0x7f800000);
  const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];

  // The box of packed blocks: fused blocks from lo, `spans` of them per axis.
  const int cx = pcr::clamped_cell(floorf(qx * inv_cell), ofx);
  const int cy = pcr::clamped_cell(floorf(qy * inv_cell), ofy);
  const int cz = pcr::clamped_cell(floorf(qz * inv_cell), ofz);
  const int span_xy = (2 * radius + 3) / 4 + 1, span_z = (2 * radius + 1) / 2 + 1;
  const int gx = floor_div(cx - radius, 4), gy = floor_div(cy - radius, 4);
  const int gz = floor_div(cz - radius, 2);
  const int x0 = max(2 * gx, 0), x1 = min(2 * (gx + span_xy), g.nbx);
  const int y0 = max(2 * gy, 0), y1 = min(2 * (gy + span_xy), g.nby);
  const int z0 = max(gz, 0), z1 = min(gz + span_z, g.nbz);

  // First walk: the kMax smallest squared distances, ascending.
  float buf[kMax];
#pragma unroll
  for (int j = 0; j < kMax; ++j) buf[j] = kInf;
  int n_cand = 0;
  const bool over = walk_box(
      g, x0, x1, y0, y1, z0, z1, qx, qy, qz,
      [&](float, float, float, float d2) {
        if (!(d2 < kFoundMax2)) return;
        ++n_cand;
        if (d2 < buf[kMax - 1]) {
          float v = d2;
#pragma unroll
          for (int j = 0; j < kMax; ++j) {
            const float b = buf[j];
            if (v < b) {
              buf[j] = v;
              v = b;
            }
          }
        }
      });
  const bool done = n_cand >= k;
  float rk = kMissD2;
  if (done) {
#pragma unroll
    for (int j = 0; j < kMax; ++j)
      if (j == k - 1) rk = buf[j];
  }

  // Second walk: moments over the selected candidates.
  float cnt = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
  float c00 = 0.f, c11 = 0.f, c22 = 0.f, c01 = 0.f, c02 = 0.f, c12 = 0.f;
  walk_box(g, x0, x1, y0, y1, z0, z1, qx, qy, qz,
           [&](float dx, float dy, float dz, float d2) {
             if (!(d2 < kFoundMax2) || !(d2 <= rk)) return;
             cnt += 1.f;
             sx += dx;
             sy += dy;
             sz += dz;
             c00 += dx * dx;
             c11 += dy * dy;
             c22 += dz * dz;
             c01 += dx * dy;
             c02 += dx * dz;
             c12 += dy * dz;
           });
  const float denom = fmaxf(cnt, 1.f);
  sx /= denom;
  sy /= denom;
  sz /= denom;
  const float vals[kOut] = {
      c00 / denom - sx * sx, c11 / denom - sy * sy, c22 / denom - sz * sz,
      c01 / denom - sx * sy, c02 / denom - sx * sz, c12 / denom - sy * sz,
      cnt,                   rk,
      (!done && w[i] > 0.f) ? 1.f : 0.f,
      (done && rk < exact_d2 && !over) ? 1.f : 0.f};
#pragma unroll
  for (int j = 0; j < kOut; ++j) out[static_cast<size_t>(j) * n + i] = vals[j];
}

}  // namespace

extern "C" {

// The largest k the library was compiled for.
int pcr_knn_max_k() { return 32; }

// pts (R+1, cap * width) f32, row_count (R+1,) i32, block_row (NB,) i32,
// row_over (R+1,) u8; q (n, 3), w (n,) f32 -> out (10, n) f32. Launches the
// kernel on `stream` and returns cudaGetLastError(), or -1 for a k outside
// [1, pcr_knn_max_k()].
int pcr_knn_moments(const float* pts, const int* row_count, const int* block_row,
                    const unsigned char* row_over, int cap, int width, int nbx,
                    int nby, int nbz, int ofx, int ofy, int ofz, float inv_cell,
                    float exact_d2, int radius, int k, const float* q,
                    const float* w, int n, float* out, void* stream) {
  if (k < 1 || k > 32) return -1;
  const Grid g{pts, row_count, block_row, row_over, cap, width, nbx, nby, nbz};
  const int blocks = (n + kBlock - 1) / kBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 16) {
    knn_moments_kernel<16><<<blocks, kBlock, 0, st>>>(
        g, ofx, ofy, ofz, inv_cell, exact_d2, radius, k, q, w, n, out);
  } else {
    knn_moments_kernel<32><<<blocks, kBlock, 0, st>>>(
        g, ofx, ofy, ofz, inv_cell, exact_d2, radius, k, q, w, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
