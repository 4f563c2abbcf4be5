// Hashed-grid correspondence + linearization + reduction, one Gauss-Newton
// iteration of ICP (kind "point") or PlaneICP (kind "plane_pt") on a small
// target's CSR buckets (the "grid" method), and of VPlaneICP (kind "plane")
// or NDT (kind "ndt") on a hashed voxel map, for Hopper (sm_90a).
//
// Counterpart of XLA code of the JAX package, with no Pallas kernel behind
// it: ops/knn.py::nearest_point (:410, a lax.scan over the window's offsets,
// a fori_loop over `cap` bucket entries) or ::nearest_voxel (:78, a lax.scan
// over the offsets with hashgrid.lookup_slots' binary search), chained with
// ops/reduce.py's point_stats / plane_stats / ndt_stats (:41, :85, :113) as
// models/icp.py::icp_stats, plane_icp.py::plane_icp_stats,
// voxelized_plane_icp.py::vplane_stats and ndt.py::ndt_solver_stats chain
// them. One thread per query does all of it:
//
//   q = R p + t, ((x r0 + y r1) + z r2) + t as core/se3.py::transform_points;
//   the query's cell floor(q / cell_size), a true division, clamped to
//     +-1e9 before the integer conversion (ops/hashgrid.py::query_cells);
//   for each offset of hashgrid.search_offsets, in its order: the cell's
//     linear key in the grid's box (int64, -1 outside; coords_to_key), its
//     slot by the dense key table (one read) or, without one, by a
//     lower-bound binary search over the n_cells sorted keys, a hit only
//     when the key is equal (lookup_slots);
//   grid kinds: the slot's first min(count, cap) points of the bucket, in
//     bucket order; hashed kinds: the slot's centroid where it is valid;
//   d2 = ((dx dx + dy dy) + dz dz), the first minimum in probe order by a
//     strict "<" from +inf (a NaN distance never wins), as knn._sq_dist and
//     the plain query's first minimum;
//   w = w_in where sqrt(d2) < max_dist and a candidate was found (the square
//     root first, as the plain gate), times Huber's weight when enabled;
//   point:    r = q - x, J = [I | -R skew(p)] (gn_accumulate.cuh's m = 3
//             linearization with U = I);
//   plane_pt: r = n . (q - x), J = [n, p x (R^T n)] with the matched point's
//             normal; plane the same with the voxel's normal (m = 1);
//   ndt:      the Mahalanobis (icov) form of reduce.ndt_stats: with
//             S = icov and K = -R skew(p), w [I|K]^T S [I|K], w [I|K]^T S d
//             and w d^T S d, Huber by sqrt(d^T S d);
//   accumulated into the 29 terms [H upper triangle (21) | g (6) | e2 | n].
// The transform, the division and the distances are rounded one operation at
// a time (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn), in the plain path's
// order: nvcc would otherwise contract products into FMAs. So the winner of
// every query is the plain query's, bit for bit. The linearization and the
// sums are the other stats kernels' and round as they do.
//
// When the caller passes match_idx and match_d2 (the checks do, the align
// passes null), every query, weighted or not, writes its winner (a point
// index or a slot, -1 for none) and its squared distance (+inf for none).
//
// What bounds it. ICP's grid path (a 40k-point target, 10k queries, 125
// offsets, cap 64): each query walks its 125 cells one after the other, a
// chain of dependent reads (dense table -> start and count -> perm -> point)
// per cell, the target (0.5 MB) staying in L2: latency, not bytes. The
// hashed map (2.4M points, 100k queries): 125 binary searches of about 17
// dependent reads each per query. Both are far from the card's byte and
// operation rates. The design is the simple one: one query per thread, the
// offsets read through the read-only cache, blocks of 64 threads so that even
// 10k queries spread over every SM. Staging a window's buckets in shared
// memory and grouping the queries by cell is later work.
//
// One problem per launch (a batched align on a grid target or a hashed map
// raises, as in the JAX package): the pose is a (1, 12) row on the device,
// [R row-major | t], and done a (1,) flag on the device, or null. A launch
// whose flag is set (a resident Gauss-Newton loop's finished problem) writes
// zeros and reads nothing else. Each block writes one row of the
// (n_blocks, 29) partials; the wrapper sums them. No atomics: for a fixed
// launch shape the sums repeat bit for bit.

#include <cstdint>

#include "gn_accumulate.cuh"

namespace {

using pcr::kStats;
using pcr::Pose;

constexpr int kThreads = 64;
enum Kind { kPoint = 0, kPlanePt = 1, kPlane = 2, kNdt = 3 };

// The hashed grid (ops/hashgrid.py Grid) and the search window.
struct Index {
  const int* keys;   // (C,) sorted linear keys, padded
  int n_cells;       // occupied cells: the first n_cells keys
  const int* dense;  // (D,) key -> slot, -1 if empty; null over the budget
  long long ox, oy, oz;
  long long nx, ny, nz;
  float cell;
  const int* offsets;  // (K, 3), hashgrid.search_offsets' order
  int n_offsets;
};

// What a kind reads at a slot: a grid target's points in CSR buckets, or a
// hashed map's centroids behind the valid flags. feats: the points' or
// voxels' normals (N or C, 3), NDT's packed icov [xx, yy, zz, xy, xz, yz]
// (C, 6), or null (point).
struct Table {
  const float* pts;
  const float* feats;
  const unsigned char* valid;
  const int* perm;
  const int* starts;
  const int* counts;
  int cap;
};

__device__ __forceinline__ long long cell_of(float v, float cell) {
  const float f = floorf(__fdiv_rn(v, cell));
  return static_cast<long long>(fminf(fmaxf(f, -1e9f), 1e9f));
}

// Linear key of an absolute cell in the grid's box, -1 outside.
__device__ __forceinline__ int cell_key(const Index& ix, long long cx, long long cy,
                                        long long cz) {
  const long long rx = cx - ix.ox, ry = cy - ix.oy, rz = cz - ix.oz;
  if (rx < 0 || rx >= ix.nx || ry < 0 || ry >= ix.ny || rz < 0 || rz >= ix.nz) return -1;
  return static_cast<int>(rx + ix.nx * (ry + ix.ny * rz));
}

// Slot of a key, -1 for an empty cell or a key of -1.
__device__ __forceinline__ int lookup_slot(const Index& ix, int key) {
  if (key < 0) return -1;
  if (ix.dense != nullptr) return __ldg(&ix.dense[key]);
  int lo = 0, hi = ix.n_cells;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(&ix.keys[mid]) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < ix.n_cells && __ldg(&ix.keys[lo]) == key ? lo : -1;
}

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         const float* __restrict__ c) {
  const float dx = __fsub_rn(qx, __ldg(c)), dy = __fsub_rn(qy, __ldg(c + 1)),
              dz = __fsub_rn(qz, __ldg(c + 2));
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
  // H = [[S, S K], [K^T S, K^T S K]], g = [S d ; K^T S d]
  float H[6][6], g[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[i] = Sd[i];
    g[3 + i] = K[0][i] * Sd[0] + K[1][i] * Sd[1] + K[2][i] * Sd[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      H[i][j] = S[i][j];
      H[i][3 + j] = SK[i][j];
      H[3 + i][3 + j] = K[0][i] * SK[0][j] + K[1][i] * SK[1][j] + K[2][i] * SK[2][j];
    }
  }
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += w * H[i][j];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += w * g[i];
  acc[27] += w * e;
  acc[28] += w;
}

template <int kKind>
__global__ void __launch_bounds__(kThreads) grid_stats_kernel(
    Index ix, Table tb, const float* __restrict__ src, const float* __restrict__ w, int n,
    const float* __restrict__ pose, const int* __restrict__ done, float max_dist,
    int use_huber, float huber_delta, float* __restrict__ partials,
    int* __restrict__ match_idx, float* __restrict__ match_d2) {
  constexpr bool kBuckets = kKind == kPoint || kKind == kPlanePt;
  if (done != nullptr && __ldg(done) != 0) {  // the align is done: zeros
    if (threadIdx.x < kStats) partials[blockIdx.x * kStats + threadIdx.x] = 0.f;
    return;
  }
  const Pose T = pcr::load_pose(pose);
  const float kInf = __int_as_float(0x7f800000);
  float acc[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const float wi = w[i];
    if (wi == 0.f && match_idx == nullptr) continue;  // adds nothing
    const float px = src[3 * i], py = src[3 * i + 1], pz = src[3 * i + 2];
    const float qx = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(px, T.r00), __fmul_rn(py, T.r01)), __fmul_rn(pz, T.r02)),
        T.t0);
    const float qy = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(px, T.r10), __fmul_rn(py, T.r11)), __fmul_rn(pz, T.r12)),
        T.t1);
    const float qz = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(px, T.r20), __fmul_rn(py, T.r21)), __fmul_rn(pz, T.r22)),
        T.t2);
    const long long cx = cell_of(qx, ix.cell), cy = cell_of(qy, ix.cell),
                    cz = cell_of(qz, ix.cell);

    float best = kInf;
    int best_idx = -1;  // a point index (grid kinds) or a slot (hashed kinds)
    for (int k = 0; k < ix.n_offsets; ++k) {
      const int* o = ix.offsets + 3 * k;
      const int slot =
          lookup_slot(ix, cell_key(ix, cx + __ldg(o), cy + __ldg(o + 1), cz + __ldg(o + 2)));
      if (slot < 0) continue;
      if constexpr (kBuckets) {
        const int start = __ldg(&tb.starts[slot]);
        const int cnt = min(__ldg(&tb.counts[slot]), tb.cap);
        for (int j = 0; j < cnt; ++j) {
          const int p = __ldg(&tb.perm[start + j]);
          const float d2 = sq_dist(qx, qy, qz, tb.pts + 3 * static_cast<size_t>(p));
          if (d2 < best) {
            best = d2;
            best_idx = p;
          }
        }
      } else {
        if (!__ldg(&tb.valid[slot])) continue;
        const float d2 = sq_dist(qx, qy, qz, tb.pts + 3 * static_cast<size_t>(slot));
        if (d2 < best) {
          best = d2;
          best_idx = slot;
        }
      }
    }
    if (match_idx != nullptr) {
      match_idx[i] = best_idx;
      match_d2[i] = best;
    }
    if (wi == 0.f || best_idx < 0 || !(__fsqrt_rn(best) < max_dist)) continue;

    const float* x = tb.pts + 3 * static_cast<size_t>(best_idx);
    const float dx = qx - __ldg(x), dy = qy - __ldg(x + 1), dz = qz - __ldg(x + 2);
    if constexpr (kKind == kPoint) {
      const float u[6] = {1.f, 0.f, 0.f, 1.f, 0.f, 1.f};
      pcr::accumulate_whitened(acc, wi, u, T, px, py, pz, dx, dy, dz, use_huber, huber_delta);
    } else if constexpr (kKind == kNdt) {
      accumulate_icov(acc, wi, tb.feats + 6 * static_cast<size_t>(best_idx), T, px, py, pz, dx,
                      dy, dz, use_huber, huber_delta);
    } else {
      const float* nrm = tb.feats + 3 * static_cast<size_t>(best_idx);
      pcr::accumulate_plane(acc, wi, T, px, py, pz, __ldg(nrm), __ldg(nrm + 1), __ldg(nrm + 2),
                            dx, dy, dz, use_huber, huber_delta);
    }
  }
  pcr::block_reduce_store<kThreads / 32>(acc, partials);
}

template <int kKind>
int launch(const float* pts, const float* feats, const unsigned char* valid, const int* perm,
           const int* starts, const int* counts, int cap, const int* keys, int n_cells,
           const int* dense, int ox, int oy, int oz, int nx, int ny, int nz, float cell,
           const int* offsets, int n_offsets, const float* src, const float* w, int n,
           const float* pose, const int* done, float max_dist, int use_huber,
           float huber_delta, float* partials, int n_blocks, int* match_idx, float* match_d2,
           void* stream) {
  const Index ix{keys, n_cells, dense, ox, oy, oz, nx, ny, nz, cell, offsets, n_offsets};
  const Table tb{pts, feats, valid, perm, starts, counts, cap};
  grid_stats_kernel<kKind><<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ix, tb, src, w, n, pose, done, max_dist, use_huber, huber_delta, partials, match_idx,
      match_d2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes the partials as (n_blocks, 29).
int pcr_grid_block_size() { return kThreads; }

// Each launches its kind's kernel on `stream` and returns cudaGetLastError().
// One signature for the four kinds. pts (N, 3) target points (grid kinds) or
// (C, 3) voxel centroids (hashed kinds), f32; feats (N, 3) normals
// (plane_pt), (C, 3) normals (plane), (C, 6) packed icov (ndt) or null
// (point); valid (C,) bool (hashed kinds; else null); perm (N,), starts and
// counts (C,) i32 and cap (grid kinds; else null and 0); keys (C,) i32
// sorted, n_cells, dense (D,) i32 or null, the origin cell and dims of the
// grid's box and its cell size; offsets (K, 3) i32; src (n, 3), w (n,), pose
// (1, 12) f32 and done (1,) i32 or null on the device; partials
// (n_blocks, 29) f32; match_idx (n,) i32 and match_d2 (n,) f32, or null.
#define PCR_GRID_ENTRY(name, kind)                                                            \
  int name(const float* pts, const float* feats, const unsigned char* valid,                 \
           const int* perm, const int* starts, const int* counts, int cap, const int* keys,  \
           int n_cells, const int* dense, int ox, int oy, int oz, int nx, int ny, int nz,    \
           float cell, const int* offsets, int n_offsets, const float* src, const float* w,  \
           int n, const float* pose, const int* done, float max_dist, int use_huber,         \
           float huber_delta, float* partials, int n_blocks, int* match_idx,                 \
           float* match_d2, void* stream) {                                                  \
    return launch<kind>(pts, feats, valid, perm, starts, counts, cap, keys, n_cells, dense,  \
                        ox, oy, oz, nx, ny, nz, cell, offsets, n_offsets, src, w, n, pose,   \
                        done, max_dist, use_huber, huber_delta, partials, n_blocks,          \
                        match_idx, match_d2, stream);                                        \
  }

PCR_GRID_ENTRY(pcr_grid_point_stats, kPoint)
PCR_GRID_ENTRY(pcr_grid_plane_point_stats, kPlanePt)
PCR_GRID_ENTRY(pcr_hashed_plane_stats, kPlane)
PCR_GRID_ENTRY(pcr_hashed_ndt_stats, kNdt)

#undef PCR_GRID_ENTRY

}  // extern "C"
