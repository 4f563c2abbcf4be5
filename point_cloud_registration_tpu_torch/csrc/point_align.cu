// Raw-point correspondence + linearization + reduction, one Gauss-Newton
// iteration of ICP (kind "point") or PlaneICP (kind "plane_pt") on the packed
// point grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel point_cloud_registration_tpu/ops/pallas/
// point_align.py (_make_point_kernel, launched by point_stats_call, kinds
// "point" and "plane_pt") together with the fallback its caller runs for the
// queries the kernel leaves unresolved (models/_point_fused.py,
// models/_point_corr.py match_points). One pass per query does all of
// match_points' work, so no query is left unresolved:
//
//   q = R p + t, formed in registers (R and t are passed by value, or read
//     from the poses array by a batched launch);
//   tier 1 (ops/pointgrid.py nearest_point_packed): the fine cell
//     f = floor(q / cell_fine) - origin_fine (a true division, as in
//     hashgrid.cell_coords), the first block lo = floor((f - 1) / 2), and the
//     2x2x2 blocks from lo in the order dbx outer, dbz inner; in each block
//     the kept points in packed order; strict "<". The match is resolved iff
//     sqrt(d2) < cell_fine;
//   otherwise the nearest valid centroid of the proxy voxel map (one voxel
//   per block, 2 * cell_fine) within ceil(max_dist / (2 * cell_fine)) proxy
//   cells, x fastest and z slowest (query_nearest_voxel on the proxy);
//   w = w_in * found * (dist < max_dist), times the Huber weight of |r|;
//   point: r = q - target and J = [I | -R skew(p)] (the m = 3 linearization
//     of gn_accumulate.cuh with U = I);
//   plane_pt: r = n . (q - target) and J = [n, p x (R^T n)] (the m = 1 plane
//     linearization of gn_accumulate.cuh), where n is the matched point's
//     normal, which rides in its packed slot (x y z nx ny nz), or, for a
//     query that took the proxy voxel, that voxel's normal;
//   accumulated into the 29 terms.
// The TPU kernel's "plane_pt" searches a wider window of whole fused blocks;
// every point within cell_fine of the query lies in both windows, so a
// resolved query has the same winner.
//
// The Morton layout, tile key lists and VMEM tile tables of the TPU kernel
// exist for its memory system and have no counterpart: the lanes read their
// blocks straight from the packed rows.
//
// Tables (see ops/pointgrid.py): pts (R+1, cap * width) f32, the kept points
// of each occupied block in packed order, width 3 for point and 6 for
// plane_pt; row_count (R+1,) i32; block_row (NB,) i32, the row of each block
// key or -1; proxy (NB, 8) f32 rows [mu_x, mu_y, mu_z, valid, n_x, n_y, n_z, 0]
// in block-key order (the normal is read by plane_pt only).
//
// Bound: bytes. The function needs the scan and its weights, block_row,
// row_count, the kept points of the rows in the queries' windows (at most
// the map's points once, 12 or 24 bytes each) and the proxy rows of the
// queries that reach the proxy: under ten microseconds at 100k queries and
// a 1.2M-point map. What a kernel really pays is the serial work of a query:
// one thread per query walks its eight blocks one after the other, each a
// chain of dependent loads (block_row -> row_count -> points) read by 4-byte
// loads, every lane of a warp from a row of its own. The design spreads a
// query over lanes and widens the loads:
//
//   * A group of kGroup = 8 lanes serves its 8 queries in turn, one round per
//     query. In a round lane b takes block b of the query's window
//     (b = 4 dbx + 2 dby + dbz, the probe order), so the eight blocks are
//     looked up at once. (Looking the blocks of all eight rounds up ahead of
//     the first row, with or without prefetches of the rows, costs eight
//     registers and was measured to gain nothing: the loads' latency is not
//     what the rounds wait for.)
//   * A lane reads the kept prefix of its row with 16-byte loads, four
//     points (width 3) or two points with their normals (width 6) per three
//     loads, where rows start at multiples of 16 bytes; else word by word, in
//     the same kernel. It keeps its first minimum (strict "<" in slot order).
//   * The eight lanes merge by three xor-shuffles on (d2, lane): the smaller
//     d2 wins and, at equal d2, the lower lane, which is the first minimum in
//     probe order. The four groups of a warp go through the rounds in step, so
//     every shuffle names the whole warp. An unresolved query's proxy probes are split over the
//     eight lanes, probe p to lane p mod 8, and merged by (d2, probe index)
//     the same way.
//   * The winner's address goes to the lane that owns the query. After the
//     eight rounds every lane loads its own target and accumulates its own
//     query: the 29-term update runs with full lanes.
//   * Blocks of 128 threads, six resident per SM: the 100k queries of the
//     bench scan are one wave of 24 warps per SM. A query of weight 0 takes
//     no round, so the padding behind a scan costs nothing.
// No atomics; the order of the sums depends on the launch shape only.
//
// Batched entries (pcr_*_stats_batched): B problems, each a scan of n points
// with its own pose, against one target in one launch, the counterpart of the
// TPU kernel's per_tile mode (point_align.py:594-660). The grid is
// (n_blocks, B): blockIdx.y is the problem, whose blocks read its rows of the
// (B, n, 3) scan and (B, n) weights and its pose from a (B, 12) device array
// and write its rows of the (B, n_blocks, 29) partials. A group's eight
// queries all lie in one problem: the whole blocks stride over that problem's
// n queries, and a lane past its end is dead, so no tail reads the next
// problem's points. A problem's partials are those of its single launch.

#include <climits>
#include <cstdint>

#include "gn_accumulate.cuh"

namespace {

using pcr::kStats;
using pcr::Pose;

constexpr int kThreads = 128;  // threads per block
constexpr int kBlocksPerSm = 6;
constexpr int kGroup = 8;  // lanes per query: one per block of the 2x2x2 window
// A true division, as in hashgrid.cell_coords (not fused_align.cu's multiply).
__device__ __forceinline__ int cell_div(float v, float cell, int origin) {
  return pcr::clamped_cell(floorf(v / cell), origin);
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

template <int kKind, bool kBatched>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) point_stats_kernel(
    Tables tb, const float* __restrict__ src, const float* __restrict__ w, int n,
    Pose T, const float* __restrict__ poses, float max_dist, int use_huber,
    float huber_delta, float* __restrict__ partials) {
  if constexpr (kBatched) {  // problem blockIdx.y: its scan, weights and pose
    const size_t b = blockIdx.y;
    src += 3 * n * b;
    w += n * b;
    T = pcr::load_pose(poses + 12 * b);
  }
  constexpr int kWidth = kKind == kPoint ? 3 : 6;  // floats per packed slot
  const float kInf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31;
  const int gl = lane & (kGroup - 1);  // lane of its group = block of the window
  const int dbx = gl >> 2, dby = (gl >> 1) & 1, dbz = gl & 1;
  const long long row_floats = static_cast<long long>(tb.cap) * kWidth;
  float acc[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = 0.f;

  // Whole blocks stride over the scan, so the lanes of a group stay together;
  // a lane behind the scan's end has weight 0 and serves the others' queries.
  for (int base = blockIdx.x * kThreads; base < n; base += gridDim.x * kThreads) {
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
      pcr::accumulate_plane(acc, wi, T, px, py, pz, nx, ny, nz, qx - tx,
                            qy - ty, qz - tz, use_huber, huber_delta);
    } else {
      const float u[6] = {1.f, 0.f, 0.f, 1.f, 0.f, 1.f};
      pcr::accumulate_whitened(acc, wi, u, T, px, py, pz, qx - tx, qy - ty,
                               qz - tz, use_huber, huber_delta);
    }
  }
  pcr::block_reduce_store<kThreads / 32>(acc, partials);
}

// One launch of B problems (B = 1 and poses null for the single entries, whose
// pose T comes by value).
template <int kKind, bool kBatched>
int launch(const float* pts, const int* row_count, const int* block_row, int cap,
           int nbx, int nby, int nbz, int ofx, int ofy, int ofz, float cell_fine,
           const float* proxy, int pox, int poy, int poz, float proxy_cell,
           int proxy_radius, const float* src, const float* w, int n, int B,
           Pose T, const float* poses, float max_dist, int use_huber,
           float huber_delta, float* partials, int n_blocks, void* stream) {
  constexpr int kWidth = kKind == kPoint ? 3 : 6;
  const bool aligned = (static_cast<long long>(cap) * kWidth * 4) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(pts) % 16 == 0;
  const Tables tb{pts, row_count, block_row, cap, nbx, nby, nbz, ofx, ofy, ofz,
                  cell_fine, reinterpret_cast<const float4*>(proxy), pox, poy, poz,
                  proxy_cell, proxy_radius, aligned};
  point_stats_kernel<kKind, kBatched>
      <<<dim3(n_blocks, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          tb, src, w, n, T, poses, max_dist, use_huber, huber_delta, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Threads per block; the wrapper sizes the partials as (n_blocks, 29).
int pcr_point_block_size() { return kThreads; }

// Each launches its kernel on `stream` and returns cudaGetLastError().
int pcr_point_stats(const float* pts, const int* row_count, const int* block_row,
                    int cap, int nbx, int nby, int nbz, int ofx, int ofy,
                    int ofz, float cell_fine, const float* proxy, int pox,
                    int poy, int poz, float proxy_cell, int proxy_radius,
                    const float* src, const float* w, int n, float r00,
                    float r01, float r02, float r10, float r11, float r12,
                    float r20, float r21, float r22, float t0, float t1,
                    float t2, float max_dist, int use_huber, float huber_delta,
                    float* partials, int n_blocks, void* stream) {
  const Pose T{r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2};
  return launch<kPoint, false>(pts, row_count, block_row, cap, nbx, nby, nbz,
                               ofx, ofy, ofz, cell_fine, proxy, pox, poy, poz,
                               proxy_cell, proxy_radius, src, w, n, 1, T,
                               nullptr, max_dist, use_huber, huber_delta,
                               partials, n_blocks, stream);
}

int pcr_plane_point_stats(const float* pts, const int* row_count,
                          const int* block_row, int cap, int nbx, int nby,
                          int nbz, int ofx, int ofy, int ofz, float cell_fine,
                          const float* proxy, int pox, int poy, int poz,
                          float proxy_cell, int proxy_radius, const float* src,
                          const float* w, int n, float r00, float r01,
                          float r02, float r10, float r11, float r12, float r20,
                          float r21, float r22, float t0, float t1, float t2,
                          float max_dist, int use_huber, float huber_delta,
                          float* partials, int n_blocks, void* stream) {
  const Pose T{r00, r01, r02, r10, r11, r12, r20, r21, r22, t0, t1, t2};
  return launch<kPlanePt, false>(pts, row_count, block_row, cap, nbx, nby, nbz,
                                 ofx, ofy, ofz, cell_fine, proxy, pox, poy,
                                 poz, proxy_cell, proxy_radius, src, w, n, 1,
                                 T, nullptr, max_dist, use_huber, huber_delta,
                                 partials, n_blocks, stream);
}

// The batched entries: src (B, n, 3), w (B, n), poses (B, 12) f32 on the
// device ([R row-major | t] per problem, 1 <= B <= 65,535); partials
// (B, n_blocks, 29), the rows of problem b from b * n_blocks on.
int pcr_point_stats_batched(const float* pts, const int* row_count,
                            const int* block_row, int cap, int nbx, int nby,
                            int nbz, int ofx, int ofy, int ofz, float cell_fine,
                            const float* proxy, int pox, int poy, int poz,
                            float proxy_cell, int proxy_radius,
                            const float* src, const float* w, int n, int B,
                            const float* poses, float max_dist, int use_huber,
                            float huber_delta, float* partials, int n_blocks,
                            void* stream) {
  return launch<kPoint, true>(pts, row_count, block_row, cap, nbx, nby, nbz,
                              ofx, ofy, ofz, cell_fine, proxy, pox, poy, poz,
                              proxy_cell, proxy_radius, src, w, n, B, Pose{},
                              poses, max_dist, use_huber, huber_delta,
                              partials, n_blocks, stream);
}

int pcr_plane_point_stats_batched(const float* pts, const int* row_count,
                                  const int* block_row, int cap, int nbx,
                                  int nby, int nbz, int ofx, int ofy, int ofz,
                                  float cell_fine, const float* proxy, int pox,
                                  int poy, int poz, float proxy_cell,
                                  int proxy_radius, const float* src,
                                  const float* w, int n, int B,
                                  const float* poses, float max_dist,
                                  int use_huber, float huber_delta,
                                  float* partials, int n_blocks, void* stream) {
  return launch<kPlanePt, true>(pts, row_count, block_row, cap, nbx, nby, nbz,
                                ofx, ofy, ofz, cell_fine, proxy, pox, poy, poz,
                                proxy_cell, proxy_radius, src, w, n, B, Pose{},
                                poses, max_dist, use_huber, huber_delta,
                                partials, n_blocks, stream);
}

}  // extern "C"
