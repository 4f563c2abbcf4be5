// The per-query work of the packed-grid stats (ICP's kind "point",
// PlaneICP's kind "plane_pt"), shared by the stats kernel (point_align.cu,
// one launch per Gauss-Newton iteration) and the loop kernel (point_loop.cu,
// every iteration of an align in one launch). point_align.cu's note
// describes the tables, the correspondence, the lanes' rounds and what
// bounds it.
//
// point_block_stats adds to a thread's acc[29] the queries of block id
// `block` of a launch of `n_blocks` blocks of kThreads threads (both from
// its Block argument): queries base + threadIdx.x for base = block *
// kThreads, then every n_blocks * kThreads further on, whole blocks at a
// time, so that the lanes of a group stay together. The same block id of
// the same launch shape covers the same queries in the same order per
// thread, so its block row is the same bits in either kernel. The whole
// block must call it: the groups go through their rounds in step, with
// shuffles across the warp.

#pragma once

#include <climits>
#include <cstdint>

#include "gn_accumulate.cuh"

namespace pcr {
namespace packed {

constexpr int kThreads = 128;  // threads per block
constexpr int kBlocksPerSm = 6;
constexpr int kGroup = 8;  // lanes per query: one per block of the 2x2x2 window

// A true division, as in hashgrid.cell_coords (not fused_align.cu's multiply).
__device__ __forceinline__ int cell_div(float v, float cell, int origin) {
  return clamped_cell(floorf(v / cell), origin);
}

__device__ __forceinline__ int floor_div2(int v) { return (v - (v < 0)) / 2; }

enum Kind { kPoint = 0, kPlanePt = 1 };

// The packed grid and its proxy map.
struct Tables {
  const float* pts;
  const int* row_count;
  const int* block_row;
  int cap, nbx, nby, nbz, ofx, ofy, ofz;
  float cell_fine;
  const float4* proxy;
  int pox, poy, poz;
  float proxy_cell;
  int proxy_radius;
  bool aligned;  // rows start at multiples of 16 bytes
};

// The tables of kind kKind (slots of 3 or 6 floats) as the kernels read
// them, on the host: pts (R+1, cap * width), row_count (R+1,), block_row
// (NB,) and proxy (NB, 8) on the device, the block grid's dims and fine
// origin, the proxy map's origin, cell and window radius.
template <int kKind>
inline Tables make_tables(const float* pts, const int* row_count, const int* block_row,
                          int cap, int nbx, int nby, int nbz, int ofx, int ofy, int ofz,
                          float cell_fine, const float* proxy, int pox, int poy, int poz,
                          float proxy_cell, int proxy_radius) {
  constexpr int kWidth = kKind == kPoint ? 3 : 6;
  const bool aligned = (static_cast<long long>(cap) * kWidth * 4) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(pts) % 16 == 0;
  return Tables{pts, row_count, block_row, cap, nbx, nby, nbz, ofx, ofy, ofz,
                cell_fine, reinterpret_cast<const float4*>(proxy), pox, poy, poz,
                proxy_cell, proxy_radius, aligned};
}

constexpr unsigned kFull = 0xffffffffu;

// Minimum of (d2, order) over the kGroup lanes of each group of the warp: the
// smaller d2 and, at equal d2, the lower order. Every lane gets its group's
// winner. The whole warp must call it.
__device__ __forceinline__ void group_min(float& d2, int& order) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, d2, off, kGroup);
    const int oo = __shfl_xor_sync(kFull, order, off, kGroup);
    if (od < d2 || (od == d2 && oo < order)) {
      d2 = od;
      order = oo;
    }
  }
}

// First minimum of the squared distance from (qx, qy, qz) over the first
// `cnt` slots of the packed row at `row`: its d2 (+inf if cnt is 0) and slot.
template <int kWidth>
__device__ __forceinline__ void scan_row(const float* __restrict__ row, int cnt,
                                         bool aligned, float qx, float qy,
                                         float qz, float& best, int& best_s) {
  best = __int_as_float(0x7f800000);
  best_s = 0;
  auto consider = [&](float x, float y, float z, int s) {
    const float dx = qx - x, dy = qy - y, dz = qz - z;
    const float d2 = dx * dx + dy * dy + dz * dz;
    if (s < cnt && d2 < best) {
      best = d2;
      best_s = s;
    }
  };
  if (aligned) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    if constexpr (kWidth == 3) {
      for (int s = 0; s < cnt; s += 4, r4 += 3) {
        const float4 a = __ldg(r4), b = __ldg(r4 + 1), c = __ldg(r4 + 2);
        consider(a.x, a.y, a.z, s);
        consider(a.w, b.x, b.y, s + 1);
        consider(b.z, b.w, c.x, s + 2);
        consider(c.y, c.z, c.w, s + 3);
      }
    } else {
      static_assert(kWidth == 6, "slots are xyz or xyz + normal");
      for (int s = 0; s < cnt; s += 2, r4 += 3) {
        const float4 a = __ldg(r4), b = __ldg(r4 + 1), c = __ldg(r4 + 2);
        consider(a.x, a.y, a.z, s);
        consider(b.z, b.w, c.x, s + 1);
      }
    }
  } else {
    for (int s = 0; s < cnt; ++s) {
      const float* c = row + kWidth * s;
      consider(__ldg(c), __ldg(c + 1), __ldg(c + 2), s);
    }
  }
}

// The proxy table's nearest_valid_cell (ops/knn.py), by the kGroup lanes of a
// group together: the probes of the clipped window, x fastest and z slowest,
// go to the lanes in turn, and the lanes merge by (d2, probe index), which
// keeps the first minimum in probe order. Every lane returns the winner's key (-1
// when the window holds no valid cell) and its squared distance in best_d2.
// The whole warp must call it; a group that is not `active` probes nothing.
__device__ __forceinline__ int group_nearest_proxy(bool active, int gl,
                                                   const Tables& tb, float qx,
                                                   float qy, float qz,
                                                   float& best_d2) {
  const int cx = cell_div(qx, tb.proxy_cell, tb.pox);
  const int cy = cell_div(qy, tb.proxy_cell, tb.poy);
  const int cz = cell_div(qz, tb.proxy_cell, tb.poz);
  const int r = tb.proxy_radius;
  const int x0 = max(cx - r, 0), y0 = max(cy - r, 0), z0 = max(cz - r, 0);
  const int wx = max(min(cx + r, tb.nbx - 1) - x0 + 1, 0);
  const int wy = max(min(cy + r, tb.nby - 1) - y0 + 1, 0);
  const int wz = max(min(cz + r, tb.nbz - 1) - z0 + 1, 0);
  const int total = active ? wx * wy * wz : 0;
  float best = __int_as_float(0x7f800000);
  int best_p = INT_MAX;
  for (int p = gl; p < total; p += kGroup) {
    const int t = p / wx;
    const int key = x0 + p % wx + tb.nbx * (y0 + t % wy + tb.nby * (z0 + t / wy));
    const float4 c = __ldg(&tb.proxy[2 * key]);
    if (c.w > 0.f) {
      const float dx = qx - c.x, dy = qy - c.y, dz = qz - c.z;
      const float d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < best) {
        best = d2;
        best_p = p;
      }
    }
  }
  group_min(best, best_p);
  best_d2 = best;
  if (best_p == INT_MAX) return -1;
  const int t = best_p / wx;
  return x0 + best_p % wx + tb.nbx * (y0 + t % wy + tb.nby * (z0 + t / wy));
}

// Where a block's queries lie: block id block() of a launch of blocks()
// blocks. The stats kernel's are its own grid's (LaunchBlock), read from
// the special registers where they are used, as the kernel read them before
// it shared this body: held in registers through the rounds instead, they
// moved its spills and cost it 1 % of its time on an H100. The loop
// kernel's is a virtual block (VirtualBlock).
struct LaunchBlock {
  __device__ __forceinline__ int block() const { return blockIdx.x; }
  __device__ __forceinline__ int blocks() const { return gridDim.x; }
};

struct VirtualBlock {
  int v, n;
  __device__ __forceinline__ int block() const { return v; }
  __device__ __forceinline__ int blocks() const { return n; }
};

// Adds the share of the scan src (n, 3) with weights w (n,) of block `at`
// at pose T into this thread's acc (see above).
template <int kKind, class Block>
__device__ __forceinline__ void point_block_stats(
    const Tables& tb, const float* __restrict__ src, const float* __restrict__ w, int n,
    const Pose& T, Block at, float max_dist, int use_huber, float huber_delta,
    float (&acc)[kStats]) {
  constexpr int kWidth = kKind == kPoint ? 3 : 6;  // floats per packed slot
  const float kInf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31;
  const int gl = lane & (kGroup - 1);  // lane of its group = block of the window
  const int dbx = gl >> 2, dby = (gl >> 1) & 1, dbz = gl & 1;
  const long long row_floats = static_cast<long long>(tb.cap) * kWidth;

  // Whole blocks stride over the scan, so the lanes of a group stay together;
  // a lane behind the scan's end has weight 0 and serves the others' queries.
  for (int base = at.block() * kThreads; base < n; base += at.blocks() * kThreads) {
    const int i = base + threadIdx.x;
    const bool live = i < n;
    const float wi = live ? w[i] : 0.f;
    const float px = live ? src[3 * i] : 0.f, py = live ? src[3 * i + 1] : 0.f,
                pz = live ? src[3 * i + 2] : 0.f;
    // q = R p + t in the JAX package's order: ((x R0 + y R1) + z R2) + t.
    const float qx = px * T.r00 + py * T.r01 + pz * T.r02 + T.t0;
    const float qy = px * T.r10 + py * T.r11 + pz * T.r12 + T.t1;
    const float qz = px * T.r20 + py * T.r21 + pz * T.r22 + T.t2;
    // Tier 1 probes the 2x2x2 blocks from this one on.
    const int bx0 = floor_div2(cell_div(qx, tb.cell_fine, tb.ofx) - 1);
    const int by0 = floor_div2(cell_div(qy, tb.cell_fine, tb.ofy) - 1);
    const int bz0 = floor_div2(cell_div(qz, tb.cell_fine, tb.ofz) - 1);

    float my_d2 = kInf;
    long long my_off = -1;  // offset of the matched point's x in pts, or
    int my_key = -1;        // the key of the matched proxy voxel
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      // A query of weight 0 (the scan's padding) adds nothing: its group idles
      // through the round, and a round that no group needs is left out.
      const bool weighted = __shfl_sync(kFull, wi != 0.f, k, kGroup);
      if (!__any_sync(kFull, weighted)) continue;
      const float ax = __shfl_sync(kFull, qx, k, kGroup);
      const float ay = __shfl_sync(kFull, qy, k, kGroup);
      const float az = __shfl_sync(kFull, qz, k, kGroup);
      // This lane's block of the window: its packed row and kept points.
      const int bx = __shfl_sync(kFull, bx0, k, kGroup) + dbx;
      const int by = __shfl_sync(kFull, by0, k, kGroup) + dby;
      const int bz = __shfl_sync(kFull, bz0, k, kGroup) + dbz;
      const bool inside = weighted && bx >= 0 && bx < tb.nbx && by >= 0 &&
                          by < tb.nby && bz >= 0 && bz < tb.nbz;
      const int row =
          inside ? __ldg(&tb.block_row[bx + tb.nbx * (by + tb.nby * bz)]) : -1;
      const int cnt = row >= 0 ? min(__ldg(&tb.row_count[row]), tb.cap) : 0;
      float best;
      int slot;
      scan_row<kWidth>(tb.pts + max(row, 0) * row_floats, cnt, tb.aligned, ax, ay, az,
                       best, slot);
      int winner = gl;
      group_min(best, winner);
      const int win_row = __shfl_sync(kFull, row, winner, kGroup);
      const int win_slot = __shfl_sync(kFull, slot, winner, kGroup);
      const bool resolved = sqrtf(best) < tb.cell_fine;
      const long long off = resolved ? win_row * row_floats + kWidth * win_slot : -1;
      int key = -1;
      // Unresolved: nearest valid proxy-voxel centroid in the window. The warp
      // enters together, the groups that have no such query probe nothing.
      const bool to_proxy = weighted && !resolved;
      if (__any_sync(kFull, to_proxy)) {
        float best_p;
        const int key_p = group_nearest_proxy(to_proxy, gl, tb, ax, ay, az, best_p);
        if (to_proxy) {
          key = key_p;
          best = best_p;
        }
      }
      if (gl == k) {
        my_d2 = best;
        my_off = off;
        my_key = key;
      }
    }

    float tx, ty, tz, nx = 0.f, ny = 0.f, nz = 0.f;
    if (my_off >= 0) {
      tx = __ldg(&tb.pts[my_off]);
      ty = __ldg(&tb.pts[my_off + 1]);
      tz = __ldg(&tb.pts[my_off + 2]);
      if constexpr (kKind == kPlanePt) {
        nx = __ldg(&tb.pts[my_off + 3]);
        ny = __ldg(&tb.pts[my_off + 4]);
        nz = __ldg(&tb.pts[my_off + 5]);
      }
    } else if (my_key >= 0) {
      const float4 mu = __ldg(&tb.proxy[2 * my_key]);
      tx = mu.x;
      ty = mu.y;
      tz = mu.z;
      if constexpr (kKind == kPlanePt) {
        const float4 nrm = __ldg(&tb.proxy[2 * my_key + 1]);
        nx = nrm.x;
        ny = nrm.y;
        nz = nrm.z;
      }
    } else {
      continue;  // no kept point within cell_fine, no valid voxel in the window
    }
    if (!(sqrtf(my_d2) < max_dist)) continue;
    if constexpr (kKind == kPlanePt) {
      accumulate_plane(acc, wi, T, px, py, pz, nx, ny, nz, qx - tx, qy - ty, qz - tz,
                       use_huber, huber_delta);
    } else {
      const float u[6] = {1.f, 0.f, 0.f, 1.f, 0.f, 1.f};
      accumulate_whitened(acc, wi, u, T, px, py, pz, qx - tx, qy - ty, qz - tz, use_huber,
                          huber_delta);
    }
  }
}

}  // namespace packed
}  // namespace pcr
