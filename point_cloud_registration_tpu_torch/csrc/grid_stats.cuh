// The per-query work of the grid stats (ICP's kind "point" and PlaneICP's
// "plane_pt" on a small target's CSR buckets, VPlaneICP's "plane" and NDT's
// "ndt" on a hashed voxel map), shared by the stats kernel (grid_align.cu,
// one launch per Gauss-Newton iteration) and the loop kernel (grid_loop.cu,
// every iteration of an align in one launch). grid_align.cu's note
// describes what each query computes, the rounding, the lanes and what
// bounds it.
//
// load_sample fills a CTA's sampled index of the sorted keys (without a
// dense key table), which does not change across iterations; the loop
// kernel loads it once. grid_block_stats adds to a thread's acc[29] the
// queries of block id `block` of a launch of `n_blocks` blocks of kThreads
// threads: group g of the block (kThreads / L groups of L lanes) takes
// queries block * groups + g, then every n_blocks * groups further on, and
// its lanes take the linearization in turn from round 0. The same block id
// of the same launch shape covers the same queries in the same order per
// lane, so its block row is the same bits in either kernel. The transform
// and the distances are rounded by the _rn intrinsics here, so that both
// kernels' winners are the plain query's.

#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>

#include "gn_accumulate.cuh"

namespace pcr {
namespace hashgrid {


constexpr int kThreads = 256;        // threads per block
constexpr int kGridLanes = 32;       // lanes per query, grid kinds: a warp
constexpr int kHashedLanes = 2;      // lanes per query, hashed kinds
constexpr int kGridMinBlocks = 3;    // blocks an SM must hold, grid kinds: <= 85 registers
constexpr int kHashedMinBlocks = 2;  // hashed kinds: <= 128 registers
constexpr int kSampleMax = 512;      // keys of a block's sampled index (2 KB)
enum Kind { kPoint = 0, kPlanePt = 1, kPlane = 2, kNdt = 3 };

__host__ __device__ constexpr int lanes_of(int kind) {
  return kind == kPoint || kind == kPlanePt ? kGridLanes : kHashedLanes;
}

__host__ __device__ constexpr int min_blocks_of(int kind) {
  return kind == kPoint || kind == kPlanePt ? kGridMinBlocks : kHashedMinBlocks;
}

// The hashed grid and the search window.
struct Index {
  const int* keys;   // (C,) sorted linear keys, padded
  int n_cells;       // occupied cells: the first n_cells keys
  const int* dense;  // (D,) key -> slot, -1 if empty; null over the budget
  long long ox, oy, oz;
  int nx, ny, nz;  // each below 2^29 (the wrapper checks)
  float cell;
  const int* offsets;  // (K, 3), hashgrid.search_offsets' order (dense table)
  int n_offsets;
  const int4* rows;    // (R,) [dy, dz, dx_lo, dx_hi] of the window's rows (search)
  int n_rows;
  const int* ranks;    // (R, row_width): probe rank of (dx_lo + i, dy, dz)
  int row_width;
};

// What a kind reads at a slot: a grid target's points in CSR buckets, or a
// hashed map's centroids behind the valid flags. feats: the points' or
// voxels' normals (N or C, 3), NDT's packed icov [xx, yy, zz, xy, xz, yz]
// (C, 6), or null (point).
struct Table {
  const float* pts;
  const float* feats;
  const unsigned char* valid;
  const float4* bucket_rows;  // (N,) [x, y, z, point index bits] in bucket order
  const int* starts;
  const int* counts;
  int cap;
};

// The index and the table as the kernels read them, on the host, from the
// C entries' arguments (grid_align.cu's note on its entries).
inline Index make_index(const int* keys, int n_cells, const int* dense, int ox, int oy, int oz,
                        int nx, int ny, int nz, float cell, const int* offsets, int n_offsets,
                        const int* rows, int n_rows, const int* ranks, int row_width) {
  return Index{keys, n_cells, dense, ox, oy, oz, nx, ny, nz, cell, offsets, n_offsets,
               reinterpret_cast<const int4*>(rows), n_rows, ranks, row_width};
}

inline Table make_table(const float* pts, const float* feats, const unsigned char* valid,
                        const float* bucket_rows, const int* starts, const int* counts,
                        int cap) {
  return Table{pts, feats, valid, reinterpret_cast<const float4*>(bucket_rows), starts, counts,
               cap};
}

// A candidate's probe order: on a grid target (probe rank << 32 | bucket
// position), on a hashed map (one candidate a slot) the probe rank.
template <int kKind>
using Order = std::conditional_t<kKind == kPoint || kKind == kPlanePt, long long, int>;

// A lane's or a group's first minimum: its squared distance, its probe order
// (the type's largest value for none) and its winner.
template <typename O>
struct Best {
  float d2;
  O order;
  int idx;
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

template <typename O>
__device__ __forceinline__ Best<O> none() {
  if constexpr (sizeof(O) == 8) {
    return Best<O>{inf(), LLONG_MAX, -1};
  } else {
    return Best<O>{inf(), INT_MAX, -1};
  }
}

// Keeps the candidate if it comes first on (d2, order); a candidate at +inf
// or NaN never wins, as under the plain query's strict "<" from +inf.
template <typename O>
__device__ __forceinline__ void consider(Best<O>& b, float d2, O order, int idx) {
  if (d2 < b.d2 || (d2 == b.d2 && d2 < inf() && order < b.order)) b = Best<O>{d2, order, idx};
}

// The first minimum of the group's kL lanes (those of `mask`); every lane
// gets it. (d2, order) names a candidate uniquely, so the pairwise minimum
// is the same on both lanes of a pair.
template <int kL, typename O>
__device__ __forceinline__ void group_merge(Best<O>& b, unsigned mask) {
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(mask, b.d2, off, kL);
    const O oo = __shfl_xor_sync(mask, b.order, off, kL);
    const int oi = __shfl_xor_sync(mask, b.idx, off, kL);
    if (od < b.d2 || (od == b.d2 && oo < b.order)) b = Best<O>{od, oo, oi};
  }
}

__device__ __forceinline__ long long cell_of(float v, float cell) {
  const float f = floorf(__fdiv_rn(v, cell));
  return static_cast<long long>(fminf(fmaxf(f, -1e9f), 1e9f));
}

// The query's cell in the box's coordinates (cell - origin), clamped to
// +-2^30. The box's dims are below 2^29 and the offsets below 2^20 (the
// wrapper checks), so with a window's offset added a clamped cell lies
// outside the box exactly when the true one does, and no sum overflows.
__device__ __forceinline__ int box_cell(float v, float cell, long long origin) {
  const long long c = cell_of(v, cell) - origin;
  return static_cast<int>(min(max(c, -(1LL << 30)), 1LL << 30));
}

// Linear key of a cell in the box's coordinates, -1 outside the box.
__device__ __forceinline__ int cell_key(const Index& ix, int rx, int ry, int rz) {
  if (rx < 0 || rx >= ix.nx || ry < 0 || ry >= ix.ny || rz < 0 || rz >= ix.nz) return -1;
  return rx + ix.nx * (ry + ix.ny * rz);
}

// The sampled index's stride: the least s with ceil(n_cells / 2^s) <= kSampleMax.
__device__ __forceinline__ int sample_shift(int n_cells) {
  int s = 0;
  while (((static_cast<long long>(n_cells) + (1LL << s) - 1) >> s) > kSampleMax) ++s;
  return s;
}

// First position in keys[0, n_cells) whose key is >= key (n_cells if none):
// a binary search over the block's samples (sample[i] = keys[i << shift]),
// then over the at most 2^shift - 1 keys between two samples.
__device__ __forceinline__ int lower_bound(const Index& ix, const int* sample, int n_sample,
                                           int shift, int key) {
  int lo = 0, hi = n_sample;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sample[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  // keys[(lo - 1) << shift] < key <= keys[lo << shift], where they exist
  int a = lo == 0 ? 0 : static_cast<int>((static_cast<long long>(lo - 1) << shift) + 1);
  int b = static_cast<int>(min(static_cast<long long>(lo) << shift,
                               static_cast<long long>(ix.n_cells)));
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (__ldg(&ix.keys[mid]) < key) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a;
}

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float x, float y,
                                         float z) {
  const float dx = __fsub_rn(qx, x), dy = __fsub_rn(qy, y), dz = __fsub_rn(qz, z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The icov (Mahalanobis) form of reduce.ndt_stats for one point: S from the
// packed [xx, yy, zz, xy, xz, yz], K = -R skew(p) (the rows of
// accumulate_whitened), d = q - mu. Huber, when enabled, weighs by
// sqrt(max(d^T S d, 0)). The weight is counted once in acc[28].
__device__ __forceinline__ void accumulate_icov(float* acc, float w, const float* __restrict__ s6,
                                                const Pose& T, float px, float py, float pz,
                                                float dx, float dy, float dz, int use_huber,
                                                float huber_delta) {
  const float a = __ldg(s6), b = __ldg(s6 + 1), c = __ldg(s6 + 2), xy = __ldg(s6 + 3),
              xz = __ldg(s6 + 4), yz = __ldg(s6 + 5);
  const float S[3][3] = {{a, xy, xz}, {xy, b, yz}, {xz, yz, c}};
  const float K[3][3] = {
      {T.r02 * py - T.r01 * pz, T.r00 * pz - T.r02 * px, T.r01 * px - T.r00 * py},
      {T.r12 * py - T.r11 * pz, T.r10 * pz - T.r12 * px, T.r11 * px - T.r10 * py},
      {T.r22 * py - T.r21 * pz, T.r20 * pz - T.r22 * px, T.r21 * px - T.r20 * py}};
  const float d[3] = {dx, dy, dz};
  float Sd[3], SK[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Sd[i] = S[i][0] * d[0] + S[i][1] * d[1] + S[i][2] * d[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) SK[i][j] = S[i][0] * K[0][j] + S[i][1] * K[1][j] + S[i][2] * K[2][j];
  }
  const float e = d[0] * Sd[0] + d[1] * Sd[1] + d[2] * Sd[2];
  if (use_huber) {
    const float mah = sqrtf(fmaxf(e, 0.f));
    if (mah > huber_delta) w *= huber_delta / mah;
  }
  // H = [[S, S K], [K^T S, K^T S K]], g = [S d ; K^T S d], each entry added
  // to its sum as it is formed (upper triangle, row-major)
  int k = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = i; j < 3; ++j) acc[k++] += w * S[i][j];
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[k++] += w * SK[i][j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j)
      acc[k++] += w * (K[0][i] * SK[0][j] + K[1][i] * SK[1][j] + K[2][i] * SK[2][j]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    acc[21 + i] += w * Sd[i];
    acc[24 + i] += w * (K[0][i] * Sd[0] + K[1][i] * Sd[1] + K[2][i] * Sd[2]);
  }
  acc[27] += w * e;
  acc[28] += w;
}

// The candidates of an occupied slot, probed at rank `rank`: a bucket's
// first min(count, cap) points in bucket order, or a valid slot's centroid.
template <int kKind>
__device__ __forceinline__ void visit(const Table& tb, Best<Order<kKind>>& b, float qx,
                                      float qy, float qz, int slot, int rank) {
  if constexpr (kKind == kPoint || kKind == kPlanePt) {
    const long long order = static_cast<long long>(rank) << 32;
    const int start = __ldg(&tb.starts[slot]);
    const int cnt = min(__ldg(&tb.counts[slot]), tb.cap);
    for (int j = 0; j < cnt; ++j) {
      const float4 c = __ldg(&tb.bucket_rows[start + j]);
      consider(b, sq_dist(qx, qy, qz, c.x, c.y, c.z), order | j, __float_as_int(c.w));
    }
  } else if (__ldg(&tb.valid[slot])) {
    const float* c = tb.pts + 3 * static_cast<size_t>(slot);
    consider(b, sq_dist(qx, qy, qz, __ldg(c), __ldg(c + 1), __ldg(c + 2)), rank, slot);
  }
}

// A CTA's sampled index of the sorted keys: sample[s] = keys[s << shift] for
// s < n_sample (none with a dense key table).
struct Sample {
  int shift, n_sample;
};

// Fills `sample` (shared, kSampleMax keys) with the CTA's sampled index and
// returns its stride and size. Every thread of the CTA calls it; the caller
// syncs the CTA before the samples are read.
__device__ __forceinline__ Sample load_sample(const Index& ix, int* sample) {
  const bool search = ix.dense == nullptr;
  const int shift = search ? sample_shift(ix.n_cells) : 0;
  const int n_sample =
      search ? static_cast<int>((static_cast<long long>(ix.n_cells) + (1LL << shift) - 1) >> shift)
             : 0;
  for (int s = threadIdx.x; s < n_sample; s += kThreads)
    sample[s] = __ldg(&ix.keys[static_cast<long long>(s) << shift]);
  return Sample{shift, n_sample};
}

// Adds block id `block`'s share of the scan src (n, 3) with weights w (n,)
// at pose T into this thread's acc (see above); with match_idx and
// match_d2, every query of the block id also writes its winner and squared
// distance there. T may lie in shared memory.
template <int kKind>
__device__ __forceinline__ void grid_block_stats(
    const Index& ix, const Table& tb, const float* __restrict__ src,
    const float* __restrict__ w, int n, const Pose& T, int block, int n_blocks,
    const int* sample, const Sample& sm, float max_dist, int use_huber, float huber_delta,
    int* __restrict__ match_idx, float* __restrict__ match_d2, float (&acc)[kStats]) {
  constexpr int kL = lanes_of(kKind);
  constexpr int kGroups = kThreads / kL;
  static_assert(kL >= 1 && kL <= 32 && (kL & (kL - 1)) == 0, "lanes: a power of two <= 32");
  const bool search = ix.dense == nullptr;
  const int lane = threadIdx.x & (kL - 1);
  const unsigned mask =
      kL == 32 ? 0xffffffffu : ((1u << (kL & 31)) - 1u) << ((threadIdx.x & 31) & ~(kL - 1));

  // A group's loop and every branch out of it are the same for its kL lanes.
  int round = 0;
  for (int i = block * kGroups + static_cast<int>(threadIdx.x) / kL; i < n;
       i += n_blocks * kGroups, ++round) {
    const float wi = __ldg(&w[i]);
    if (wi == 0.f && match_idx == nullptr) continue;  // adds nothing
    const float* p = src + 3 * static_cast<size_t>(i);
    const float px = __ldg(p), py = __ldg(p + 1), pz = __ldg(p + 2);
    const float qx = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(px, T.r00), __fmul_rn(py, T.r01)), __fmul_rn(pz, T.r02)),
        T.t0);
    const float qy = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(px, T.r10), __fmul_rn(py, T.r11)), __fmul_rn(pz, T.r12)),
        T.t1);
    const float qz = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(px, T.r20), __fmul_rn(py, T.r21)), __fmul_rn(pz, T.r22)),
        T.t2);
    const int cx = box_cell(qx, ix.cell, ix.ox), cy = box_cell(qy, ix.cell, ix.oy),
              cz = box_cell(qz, ix.cell, ix.oz);

    Best<Order<kKind>> b = none<Order<kKind>>();  // idx: a point index or a slot
    if (!search) {  // lane l: offsets l, l + kL, ... through the dense table
      for (int k = lane; k < ix.n_offsets; k += kL) {
        const int* o = ix.offsets + 3 * k;
        const int key = cell_key(ix, cx + __ldg(o), cy + __ldg(o + 1), cz + __ldg(o + 2));
        if (key < 0) continue;
        const int slot = __ldg(&ix.dense[key]);
        if (slot >= 0) visit<kKind>(tb, b, qx, qy, qz, slot, k);
      }
    } else {  // lane l: rows l, l + kL, ...: one search each, then a walk
      for (int r = lane; r < ix.n_rows; r += kL) {
        const int4 row = __ldg(&ix.rows[r]);
        const int ry = cy + row.x, rz = cz + row.y;
        if (ry < 0 || ry >= ix.ny || rz < 0 || rz >= ix.nz) continue;
        const int first = cx + row.z;  // the row's first cell, unclipped
        const int x0 = max(first, 0), x1 = min(cx + row.w, ix.nx - 1);
        if (x0 > x1) continue;  // the row lies outside the box
        const int base = ix.nx * (ry + ix.ny * rz);
        const int last = base + x1;
        const int* rank_row = ix.ranks + static_cast<size_t>(r) * ix.row_width;
        for (int pos = lower_bound(ix, sample, sm.n_sample, sm.shift, base + x0);
             pos < ix.n_cells; ++pos) {
          const int key = __ldg(&ix.keys[pos]);
          if (key > last) break;
          visit<kKind>(tb, b, qx, qy, qz, pos, __ldg(&rank_row[key - base - first]));
        }
      }
    }
    group_merge<kL>(b, mask);
    if (lane != (round & (kL - 1))) continue;  // one lane a query, in turn
    if (match_idx != nullptr) {
      match_idx[i] = b.idx;
      match_d2[i] = b.d2;
    }
    if (wi == 0.f || b.idx < 0 || !(__fsqrt_rn(b.d2) < max_dist)) continue;

    const float* x = tb.pts + 3 * static_cast<size_t>(b.idx);
    const float dx = qx - __ldg(x), dy = qy - __ldg(x + 1), dz = qz - __ldg(x + 2);
    if constexpr (kKind == kPoint) {
      const float u[6] = {1.f, 0.f, 0.f, 1.f, 0.f, 1.f};
      accumulate_whitened(acc, wi, u, T, px, py, pz, dx, dy, dz, use_huber, huber_delta);
    } else if constexpr (kKind == kNdt) {
      accumulate_icov(acc, wi, tb.feats + 6 * static_cast<size_t>(b.idx), T, px, py, pz, dx,
                      dy, dz, use_huber, huber_delta);
    } else {
      const float* nrm = tb.feats + 3 * static_cast<size_t>(b.idx);
      accumulate_plane(acc, wi, T, px, py, pz, __ldg(nrm), __ldg(nrm + 1), __ldg(nrm + 2), dx,
                       dy, dz, use_huber, huber_delta);
    }
  }
}

}  // namespace hashgrid
}  // namespace pcr
