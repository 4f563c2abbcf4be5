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
// absent from its tile's key list, cannot arise: the box's blocks are looked
// up in block_row itself. Its k rounds of next-minimum ascent compute the
// same order statistic; here a sorted buffer of the smallest distances lives
// in registers (16 or 32 of them), and a last walk over the same candidates
// accumulates the moments. A k above 32 selects in rounds of 32: each further
// walk counts the candidates at or below the 32nd smallest distance of the
// round before and keeps the 32 smallest above it, until the k-th is among
// them; k = 40 takes two walks before the moments, k = 15 one.
//
// What bounds it on this card: the function needs every input and output
// moved once (queries, the kept points of the packed rows, 40 B out per
// query) and one distance per candidate, some tens of megabytes and a few
// gigaflops at 1.2M queries: operations, well under a tenth of a
// millisecond. What a kernel really pays is the instruction rate of the
// per-candidate work (a distance, a compare, the insertion into
// the sorted buffer, twice over the box) and, if every query fetches its own
// candidates, the latency of uncoalesced loads. The design removes the
// second and shares the first:
//
//   * The box depends only on the fused block of c - r, so all queries with
//     that fused block have the same candidates. The wrapper sorts the
//     queries by box (ops/kernels/knn_normals.py box_groups_cuda: the small
//     kernels below around one torch.sort) into work items of one box and
//     at most 32 queries, and leaves their number on the card. The kernel is
//     launched for as many warps as fit on the card at once; each warp takes
//     the next item from a counter until none is left, so no host read of
//     the number of items stands between the grouping and the launch. Its
//     lanes are the item's queries (a short item repeats its last query in
//     the spare lanes, which then do what a live lane does and write
//     nothing). (A warp that instead takes the next 32 sorted positions and
//     finds the items that start there, with no list of the items, ran the
//     kernel 1.8x as long: its bisections for the items' starts sit in the
//     walk's way, and it held more registers.)
//   * The lanes look the box's blocks up together, one block per lane
//     (block_row -> row_count, row_over), and list the occupied rows with
//     their slots in the warp's stage in shared memory, in box order (x
//     fastest, z slowest). Each listed row's prefix of row_count points is
//     copied with coalesced 16-byte cp.async by eight lanes per row, four
//     rows at a time; a row starts at a multiple of four points in the
//     stage, so every copy is 16-byte aligned, and the up to three slots
//     behind its last point are filled with +inf, which is no candidate.
//     Where the rows are not 16-byte aligned (a cap that is no multiple of
//     four, a slot wider than xyz) the same kernel copies word by word.
//   * When the next row no longer fits, the stage is consumed and refilled:
//     a box of any size streams through a stage of fixed size (kStagePoints,
//     or one row if the cap is larger; a block then holds fewer warps).
//   * Consuming: every lane reads the same staged point at the same time (a
//     shared-memory broadcast, three 16-byte reads per four points) and
//     computes its own distance. Lanes are neighbouring queries, so they
//     tend to insert at the same candidates.
//   * A box is walked from its middle, where its queries lie, so that the
//     bar for an insertion falls early and the far blocks insert little.
//   * The second walk re-reads the stage when the whole box fitted in it,
//     and streams the box again (coalesced, mostly from L1/L2) when not.
//
// The squared distance is rounded product by product and sum by sum (no
// fused multiply-add), in the plain PyTorch version's order, so that rk2,
// the selection and the flags equal that version's bit for bit and the two
// walks agree with each other. A query's candidate order is fixed by its box
// and the stage size, never by the launch or by the other queries of its
// item, and there are no atomics: runs repeat bit for bit, and a query's
// outputs do not depend on the order of the queries.
//
// Output: out (10, n) f32, planar, in the caller's query order: rows c00 c11
// c22 c01 c02 c12 count rk2 unresolved exact. With a list of point indices
// (ops/normals.py's wide tier: the queries are points[qidx[i]], weight 1) a
// query that has k candidates writes its rows c00 .. c12 and exact into the
// column of its point of an out of the whole cloud, and one that has not
// writes nothing, the index_put of the plain version.

#include <cstdint>

#include "compact.cuh"
#include "gn_accumulate.cuh"

namespace {

constexpr int kItem = 32;     // queries of a work item at most: one per lane
constexpr int kWarps = 4;     // work items of a block: one per warp
constexpr int kStagePoints = 512;  // points a warp's stage holds, unless a row is longer
constexpr int kMinStage = 16;  // stage sizes are multiples of this many points
constexpr int kMaxShared = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;
// A squared distance at or above FOUND_MAX**2 (ops/knn.py) is no candidate.
constexpr float kFoundMax2 = 1e28f;
constexpr float kMissD2 = 1e30f;  // rk2 of a query with fewer than k candidates
constexpr int kOut = 10;

// floor(a / b) for b > 0.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return q - ((a % b) < 0);
}

__host__ __device__ __forceinline__ int pad4(int v) { return (v + 3) & ~3; }

// Where queries are binned: the fine-cell origin, the float32 reciprocal of
// the cell size, the search radius in fine cells and the block-grid dims.
struct Binning {
  int ofx, ofy, ofz;
  float inv_cell;
  int radius, nbx, nby, nbz;
};

// Fused blocks of a box per axis: x and y, z.
__host__ __device__ __forceinline__ int span_xy(int radius) { return (2 * radius + 3) / 4 + 1; }
__host__ __device__ __forceinline__ int span_z(int radius) { return (2 * radius + 1) / 2 + 1; }

// The fused block at which the candidate box of the query (qx, qy, qz) starts.
__device__ __forceinline__ void box_start(const Binning& bn, float qx, float qy,
                                          float qz, int& gx, int& gy, int& gz) {
  gx = floor_div(pcr::clamped_cell(floorf(qx * bn.inv_cell), bn.ofx) - bn.radius, 4);
  gy = floor_div(pcr::clamped_cell(floorf(qy * bn.inv_cell), bn.ofy) - bn.radius, 4);
  gz = floor_div(pcr::clamped_cell(floorf(qz * bn.inv_cell), bn.ofz) - bn.radius, 2);
}

// The number of box keys (as _box_key_space of ops/kernels/knn_normals.py):
// a key lies in [0, n_keys), so n_keys itself sorts after every query.
__host__ __device__ __forceinline__ long long n_box_keys(const Binning& bn) {
  const long long sx = span_xy(bn.radius), sz = span_z(bn.radius);
  const long long lx = (bn.nbx + 1) / 2, ly = (bn.nby + 1) / 2, lz = bn.nbz;
  return (lx + sx + 1) * (ly + sx + 1) * (lz + sz + 1);
}

// How many of the n query positions hold a query: all n, or the number the
// card holds at `count` if it is fewer.
__device__ __forceinline__ int live_queries(const int* count, int n) {
  return count == nullptr ? n : min(*count, n);
}

// Grouping, first kernel: the box key of every query, as box_groups of
// ops/kernels/knn_normals.py defines it: the box start clamped per axis to
// [-span, fused blocks of the grid] and shifted to start at 0, x fastest.
// Query i is q[i], or q[qidx[i]] with a list of indices; a position at or
// beyond the live count gets the key n_keys, which sorts last.
template <class Key>
__global__ void __launch_bounds__(256) box_key_kernel(Binning bn,
                                                      const float* __restrict__ q,
                                                      const long long* __restrict__ qidx,
                                                      int n, const int* __restrict__ count,
                                                      Key* __restrict__ key) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  if (i >= live_queries(count, n)) {
    key[i] = static_cast<Key>(n_box_keys(bn));
    return;
  }
  int gx, gy, gz;
  const float* qi = q + 3 * (qidx != nullptr ? qidx[i] : static_cast<long long>(i));
  box_start(bn, qi[0], qi[1], qi[2], gx, gy, gz);
  const int sx = span_xy(bn.radius), sz = span_z(bn.radius);
  const int lx = (bn.nbx + 1) / 2, ly = (bn.nby + 1) / 2, lz = bn.nbz;
  const Key kx = min(max(gx, -sx), lx) + sx, ky = min(max(gy, -sx), ly) + sx;
  const Key kz = min(max(gz, -sz), lz) + sz;
  key[i] = kx + (lx + sx + 1) * (ky + (ly + sx + 1) * kz);
}

// Grouping, second kernel: over the sorted keys of the live queries, flags
// the positions at which a work item starts: those whose rank inside their
// run of equal keys is a multiple of `item` (the run's first position by
// bisection). It marks them for pcr::compact::scatter_kernel, which lists
// them (the third kernel).
template <class Key>
__global__ void __launch_bounds__(pcr::compact::kThreads) item_mark_kernel(
    const Key* __restrict__ skey, int n, const int* __restrict__ count, int item,
    unsigned char* __restrict__ flag, int* __restrict__ tile_counts) {
  const int live = live_queries(count, n);
  const long long p0 = static_cast<long long>(blockIdx.x) * pcr::compact::kTile +
                       threadIdx.x * pcr::compact::kPer;
  unsigned char f[pcr::compact::kPer];
#pragma unroll
  for (int j = 0; j < pcr::compact::kPer; ++j) {
    const int p = static_cast<int>(p0) + j;
    f[j] = 0;
    if (p0 + j >= live) continue;
    const Key mine = skey[p];
    int lo = p;  // the first position of the run, in [lo, hi]
    if (p > 0 && skey[p - 1] == mine) {
      lo = 0;
      int hi = p - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (skey[mid] < mine) lo = mid + 1; else hi = mid;
      }
    }
    f[j] = (p - lo) % item == 0;
  }
  pcr::compact::mark_tile(f, p0, n, flag, tile_counts);
}

struct Grid {
  const float* pts;
  const int* row_count;
  const int* block_row;
  const unsigned char* row_over;
  int cap, width, nbx, nby;
  bool aligned;  // rows are xyz only and start at multiples of 16 bytes
};

// Packed blocks [x0, x1) x [y0, y1) x [z0, z1).
struct Box {
  int x0, x1, y0, y1, z0, z1;
};

// One warp's shared memory: the staged candidates and the list of the rows
// that fill the stage next.
struct Stage {
  float* pts;  // 3 * size floats: xyz of the staged points, rows padded to four
  int* row;    // size / 4 entries each: a listed packed row,
  int* cnt;    //   its kept points,
  int* dst;    //   its first slot in pts
  int size;    // points the stage holds, a multiple of kMinStage
};

// Bytes of shared memory per warp for a stage of `size` points.
__host__ __device__ constexpr int stage_bytes(int size) { return 15 * size; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies the `n_rows` listed rows into the stage: eight lanes per row, four
// rows at a time. Whole 16-byte pieces of a row's kept prefix go by cp.async;
// the words behind them, up to the row's padded end, by plain loads, +inf
// behind the last kept point.
__device__ __forceinline__ void fill_stage(const Grid& g, const Stage& st,
                                           int n_rows, int lane) {
  const float kInf = __int_as_float(0x7f800000);
  const int t = lane & 7;
  for (int e = lane >> 3; e < n_rows; e += 4) {
    const int cnt = st.cnt[e];
    const float* src = g.pts + static_cast<size_t>(st.row[e]) * g.cap * g.width;
    float* dst = st.pts + 3 * st.dst[e];
    const int words = 3 * cnt, padded = 3 * pad4(cnt);
    const int n16 = g.aligned ? words >> 2 : 0;
    for (int c = t; c < n16; c += 8) cp_async16(dst + 4 * c, src + 4 * c);
    for (int v = 4 * n16 + t; v < padded; v += 8)
      dst[v] = v < words ? __ldg(src + (v / 3) * g.width + v % 3) : kInf;
  }
  cp_async_wait_all();
}

// Calls f(px, py, pz) for each of the m staged points at p (m a multiple of
// four), every lane on the same point.
template <class F>
__device__ __forceinline__ void for_each_staged(const float* p, int m, F&& f) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  for (int s = 0; s < m; s += 4, p4 += 3) {
    const float4 a = p4[0], b = p4[1], c = p4[2];
    f(a.x, a.y, a.z);
    f(a.w, b.x, b.y);
    f(b.z, b.w, c.x);
    f(c.y, c.z, c.w);
  }
}

// Streams the kept points of the box through the stage, in box order, and
// calls consume(points, m) on each filling. Every lane of the warp must call
// it with the same box. Box order: blocks with x fastest and z slowest, from
// `first_block` on and around, each block's points in packed order. With
// `resident` > 0 the stage already holds the whole box in that many slots and
// is consumed as it is. Returns whether a block of
// the box was truncated at the cap; `fillings` counts the calls of consume
// and `last` is the m of the last one, whose points stay in the stage.
template <class Consume>
__device__ __forceinline__ bool stream_box(const Grid& g, const Box& b,
                                           const Stage& st, int lane,
                                           int resident, int& fillings,
                                           int& last, Consume&& consume) {
  const int nx = max(b.x1 - b.x0, 0), ny = max(b.y1 - b.y0, 0);
  const int nz = max(b.z1 - b.z0, 0), n_blocks = nx * ny * nz;
  // The queries lie in the middle of their box. The walk starts a quarter of
  // the rows into the middle layer and wraps around, so that near points come
  // early and the bar for an insertion falls fast.
  const int first_block = nx * (ny / 4 + ny * (nz / 2));
  bool over = false;
  fillings = 0;
  last = 0;
  int next = resident > 0 ? n_blocks : 0;  // first block of the next batch of 32
  unsigned pending = 0;  // lanes whose row of the current batch is not listed yet
  int row = -1, cnt = 0;
  int upto = 0;    // padded points of the batch's rows up to this lane's
  int listed = 0;  // padded points of the batch's rows listed so far
  int n_rows = 0, used = resident;  // rows listed for the next filling, their slots
  for (;;) {
    if (pending == 0 && next < n_blocks) {
      // the next batch: one block per lane
      const int blk = next + lane;
      next += 32;
      row = -1;
      cnt = 0;
      if (blk < n_blocks) {
        const int at = blk + first_block < n_blocks ? blk + first_block
                                                    : blk + first_block - n_blocks;
        const int x = b.x0 + at % nx, y = b.y0 + (at / nx) % ny;
        const int z = b.z0 + at / (nx * ny);
        row = __ldg(&g.block_row[x + g.nbx * (y + g.nby * z)]);
        if (row >= 0) {
          cnt = min(__ldg(&g.row_count[row]), g.cap);
          over |= __ldg(&g.row_over[row]) != 0;
        }
      }
      upto = pad4(cnt);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, upto, d);
        if (lane >= d) upto += v;
      }
      listed = 0;
      pending = __ballot_sync(kFull, cnt > 0);
      if (pending == 0) continue;
    }
    if (pending != 0) {
      // list the batch's rows that still fit in the stage, in lane order
      const bool fits =
          ((pending >> lane) & 1u) && used + (upto - listed) <= st.size;
      const unsigned f = __ballot_sync(kFull, fits);
      if (f != 0) {
        if (fits) {
          const int e = n_rows + __popc(f & ((1u << lane) - 1u));
          st.row[e] = row;
          st.cnt[e] = cnt;
          st.dst[e] = used + (upto - listed) - pad4(cnt);
        }
        const int end = __shfl_sync(kFull, upto, 31 - __clz(f));
        n_rows += __popc(f);
        used += end - listed;
        listed = end;
        pending &= ~f;
        continue;
      }
    } else if (used == 0) {
      break;  // no block left, nothing listed
    }
    // the stage is full, or the box is at its end: fill, consume, start anew
    __syncwarp();
    fill_stage(g, st, n_rows, lane);
    __syncwarp();
    consume(st.pts, used);
    __syncwarp();
    ++fillings;
    last = used;
    n_rows = 0;
    used = 0;
  }
  return __any_sync(kFull, over);
}

// The squared distance of a difference, rounded product by product and sum
// by sum (no fused multiply-add), in the plain PyTorch version's order.
__device__ __forceinline__ float dist2_rn(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The moments' arithmetic, each step spelt out: a product added to a sum in
// one fused multiply-add, and a second moment about the mean, s / count -
// a * b, as the quotient less the product in one fused multiply-add. These
// are the forms nvcc chose for `acc += a * b` and `s / count - a * b` in the
// kernel's first builds; left to the compiler, a change elsewhere in the
// kernel changed its choice, and the covariances moved by a rounding.
__device__ __forceinline__ float mac(float acc, float a, float b) { return __fmaf_rn(a, b, acc); }
__device__ __forceinline__ float central(float s, float denom, float a, float b) {
  return __fmaf_rn(-a, b, __fdiv_rn(s, denom));
}

// Inserts v into the ascending buffer of kMax, dropping its largest entry.
template <int kMax>
__device__ __forceinline__ void insert_sorted(float (&buf)[kMax], float v) {
#pragma unroll
  for (int j = 0; j < kMax; ++j) {
    const float lo = fminf(buf[j], v);
    v = fmaxf(buf[j], v);
    buf[j] = lo;
  }
}

template <int kMax, bool kRounds>
__global__ void __launch_bounds__(32 * kWarps, 4) knn_moments_kernel(
    Grid g, Binning bn, float exact_d2, int k, const float* __restrict__ q,
    const long long* __restrict__ qidx, const float* __restrict__ w, int n,
    const int* __restrict__ count, const long long* __restrict__ order,
    const long long* __restrict__ starts, int* __restrict__ ctl, int stage_size,
    float* __restrict__ out, int out_n) {
  extern __shared__ float4 shared[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float kInf = __int_as_float(0x7f800000);

  Stage st;
  st.pts = reinterpret_cast<float*>(shared) +
           static_cast<size_t>(warp) * (stage_bytes(stage_size) / 4);
  st.row = reinterpret_cast<int*>(st.pts + 3 * stage_size);
  st.cnt = st.row + stage_size / 4;
  st.dst = st.cnt + stage_size / 4;
  st.size = stage_size;

  // ctl: the number of work items, the counter that hands them out and the
  // count of warps that found none left; the last such warp sets both
  // counters back to 0, so the next launch on the same grouping starts anew
  const int n_items = ctl[0], live = live_queries(count, n);
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(ctl + 1, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= n_items) {
      if (lane == 0) {
        __threadfence();
        if (atomicAdd(ctl + 2, 1) == static_cast<int>(gridDim.x * (blockDim.x >> 5)) - 1) {
          ctl[1] = 0;
          ctl[2] = 0;
        }
      }
      return;  // the whole warp: warps share no barrier
    }
    {
      // The item's queries, one per lane; spare lanes repeat the last one.
      const long long first = starts[item];
      const int m = static_cast<int>((item + 1 < n_items ? starts[item + 1] : live) - first);
      const long long i = order[first + min(lane, m - 1)];
      const long long pi = qidx != nullptr ? qidx[i] : i;  // the query's point
      const float qx = q[3 * pi], qy = q[3 * pi + 1], qz = q[3 * pi + 2];

      // The box of packed blocks: span fused blocks per axis from the box start.
      // It is the same for every query of the item; lane 0's is taken.
      int gx, gy, gz;
      box_start(bn, qx, qy, qz, gx, gy, gz);
      gx = __shfl_sync(kFull, gx, 0);
      gy = __shfl_sync(kFull, gy, 0);
      gz = __shfl_sync(kFull, gz, 0);
      const Box box{max(2 * gx, 0), min(2 * (gx + span_xy(bn.radius)), bn.nbx),
                    max(2 * gy, 0), min(2 * (gy + span_xy(bn.radius)), bn.nby),
                    max(gz, 0),     min(gz + span_z(bn.radius), bn.nbz)};

      // First walk: the k smallest squared distances, ascending, at the end of
      // a sorted buffer of kMax whose first kMax - k entries stay -inf. Its last
      // entry is the k-th smallest so far and the bar for an insertion; it starts
      // at kFoundMax2, so whatever gets in is a candidate, and it has come below
      // kFoundMax2 exactly when there were k candidates.
      float buf[kMax];
#pragma unroll
      for (int j = 0; j < kMax; ++j) buf[j] = j < kMax - k ? -kInf : kFoundMax2;
      int fillings, staged;
      const bool over = stream_box(
          g, box, st, lane, 0, fillings, staged, [&](const float* p, int m_staged) {
            for_each_staged(p, m_staged, [&](float px, float py, float pz) {
              const float d2 = dist2_rn(qx - px, qy - py, qz - pz);
              if (d2 < buf[kMax - 1]) insert_sorted<kMax>(buf, d2);
            });
          });
      bool done = buf[kMax - 1] < kFoundMax2;
      float rk = done ? buf[kMax - 1] : kMissD2;
      if constexpr (kRounds) {
        // k > kMax: the buffer holds the kMax smallest; select in rounds. `lo` is
        // the largest distance of the last round's buffer, `need` the rank of the
        // k-th smallest among the candidates above it. The walks take the whole
        // warp, so a lane that has its rk walks on with the others.
        int need = k;
        float lo = -kInf;
        bool open = true;
        for (;;) {
          if (open) {
            if (need <= kMax) {
              float v = buf[0];
#pragma unroll
              for (int j = 1; j < kMax; ++j) v = j == need - 1 ? buf[j] : v;
              done = v < kFoundMax2;
              rk = done ? v : kMissD2;
              open = false;
            } else if (!(buf[kMax - 1] < kFoundMax2)) {
              // fewer than k candidates; the first walk's done and rk, which
              // count only kMax of them, do not stand
              done = false;
              rk = kMissD2;
              open = false;
            } else {
              lo = buf[kMax - 1];
            }
          }
          if (!__any_sync(kFull, open)) break;
#pragma unroll
          for (int j = 0; j < kMax; ++j) buf[j] = kFoundMax2;
          int at_or_below = 0;
          int f2, s2;
          stream_box(g, box, st, lane, fillings == 1 ? staged : 0, f2, s2,
                     [&](const float* p, int m_staged) {
                       for_each_staged(p, m_staged, [&](float px, float py, float pz) {
                         const float d2 = dist2_rn(qx - px, qy - py, qz - pz);
                         if (d2 <= lo) {
                           ++at_or_below;
                         } else if (d2 < buf[kMax - 1]) {
                           insert_sorted<kMax>(buf, d2);
                         }
                       });
                     });
          if (open) {
            need = k - at_or_below;
            if (need <= 0) {  // ties at lo reach the k-th
              done = true;
              rk = lo;
              open = false;
            }
          }
        }
      }
      // selected: d2 <= take; without k candidates, all of them: d2 < kFoundMax2
      const float take = done ? rk : __int_as_float(__float_as_int(kFoundMax2) - 1);

      // Last walk: moments over the selected candidates, from the stage where
      // it still holds the whole box.
      float cnt = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
      float c00 = 0.f, c11 = 0.f, c22 = 0.f, c01 = 0.f, c02 = 0.f, c12 = 0.f;
      if (fillings > 0) {
        int f2, s2;
        stream_box(g, box, st, lane, fillings == 1 ? staged : 0, f2, s2,
                   [&](const float* p, int m_staged) {
                     for_each_staged(p, m_staged, [&](float px, float py, float pz) {
                       const float dx = qx - px, dy = qy - py, dz = qz - pz;
                       const float d2 = dist2_rn(dx, dy, dz);
                       if (!(d2 <= take)) return;
                       cnt += 1.f;
                       sx += dx;
                       sy += dy;
                       sz += dz;
                       c00 = mac(c00, dx, dx);
                       c11 = mac(c11, dy, dy);
                       c22 = mac(c22, dz, dz);
                       c01 = mac(c01, dx, dy);
                       c02 = mac(c02, dx, dz);
                       c12 = mac(c12, dy, dz);
                     });
                   });
      }
      if (lane < m) {
        const float denom = fmaxf(cnt, 1.f);
        sx = __fdiv_rn(sx, denom);
        sy = __fdiv_rn(sy, denom);
        sz = __fdiv_rn(sz, denom);
        const float wi = w != nullptr ? w[i] : 1.f;
        const float vals[kOut] = {
            central(c00, denom, sx, sx), central(c11, denom, sy, sy), central(c22, denom, sz, sz),
            central(c01, denom, sx, sy), central(c02, denom, sx, sz), central(c12, denom, sy, sz),
            cnt,                   rk,
            (!done && wi > 0.f) ? 1.f : 0.f,
            (done && rk < exact_d2 && !over) ? 1.f : 0.f};
        if (qidx == nullptr) {
#pragma unroll
          for (int j = 0; j < kOut; ++j) out[static_cast<size_t>(j) * out_n + i] = vals[j];
        } else if (done) {
#pragma unroll
          for (int j = 0; j < 6; ++j) out[static_cast<size_t>(j) * out_n + pi] = vals[j];
          out[static_cast<size_t>(9) * out_n + pi] = vals[9];
        }
      }
    }
  }
}

// The dynamic shared memory limit is a property of the kernel on the current
// device, so it is set on every launch and not remembered. The grid holds
// as many blocks as fit on the card at once, and no more than the items of
// n queries could fill.
template <int kMax, bool kRounds>
int launch(const Grid& g, const Binning& bn, float exact_d2, int k, const float* q,
           const long long* qidx, const float* w, int n, const int* count,
           const long long* order, const long long* starts, int* ctl, int stage_size,
           int warps, float* out, int out_n, cudaStream_t st) {
  const int bytes = warps * stage_bytes(stage_size);
  auto kernel = knn_moments_kernel<kMax, kRounds>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fill = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  const long long need = (static_cast<long long>(n) + warps - 1) / warps;
  const int blocks = static_cast<int>(need < fill ? need : fill);
  kernel<<<blocks, 32 * warps, bytes, st>>>(g, bn, exact_d2, k, q, qidx, w, n, count, order,
                                            starts, ctl, stage_size, out, out_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The most neighbours one walk selects; a larger k selects in rounds.
int pcr_knn_round_k() { return 32; }

// The most queries a work item may hold.
int pcr_knn_item_size() { return kItem; }

// pts (R+1, cap * width) f32, row_count (R+1,) i32, block_row (NB,) i32,
// row_over (R+1,) u8. Queries: n positions, query i at q[i] (q (n, 3)) or,
// with qidx (n,) i64, at q[qidx[i]]; only the first min(*count, n) live when
// `count` (i32 on the card) is given. w (n,) f32, or null for weights of 1.
// The queries are grouped into work items of one candidate box each (the
// three grouping entries below): item j holds the queries order[starts[j] ..
// starts[j + 1]), the last item up to the live count (order, starts (n,)
// i64), at most pcr_knn_item_size() of them; ctl (3,) i32 holds the number
// of items and two counters at 0. Output: out (10, out_n) f32, column i
// (without qidx: out_n = n) or, with qidx, the rows c00 .. c12 and exact of
// column qidx[i] where the query has k candidates. Any k >= 1; above
// pcr_knn_round_k() the selection takes rounds. A warp's stage holds
// kStagePoints points, or one row where the cap is larger (rounded up to a
// multiple of 16); kWarps warps share a block, fewer where their stages would
// not fit its shared memory. Launches the kernel on `stream` and returns
// cudaGetLastError(), or -1 for a k below 1, -3 when a stage of one row of
// this cap does not fit a block's shared memory (a cap above about 15,000).
int pcr_knn_moments(const float* pts, const int* row_count, const int* block_row,
                    const unsigned char* row_over, int cap, int width, int nbx,
                    int nby, int nbz, int ofx, int ofy, int ofz, float inv_cell,
                    float exact_d2, int radius, int k, const float* q,
                    const long long* qidx, const float* w, int n, const int* count,
                    const long long* order, const long long* starts, int* ctl,
                    float* out, int out_n, void* stream) {
  if (k < 1) return -1;
  const long long want = kStagePoints > cap ? kStagePoints : cap;
  const long long stage = (want + kMinStage - 1) / kMinStage * kMinStage;
  const long long fit = kMaxShared / (stage * stage_bytes(1));
  if (fit < 1) return -3;
  const int warps = fit < kWarps ? static_cast<int>(fit) : kWarps;
  const bool aligned =
      width == 3 && cap % 4 == 0 && reinterpret_cast<uintptr_t>(pts) % 16 == 0;
  const Grid g{pts, row_count, block_row, row_over, cap, width, nbx, nby, aligned};
  const Binning bn{ofx, ofy, ofz, inv_cell, radius, nbx, nby, nbz};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (k <= 16)
    return launch<16, false>(g, bn, exact_d2, k, q, qidx, w, n, count, order, starts, ctl,
                             static_cast<int>(stage), warps, out, out_n, st);
  if (k <= 32)
    return launch<32, false>(g, bn, exact_d2, k, q, qidx, w, n, count, order, starts, ctl,
                             static_cast<int>(stage), warps, out, out_n, st);
  return launch<32, true>(g, bn, exact_d2, k, q, qidx, w, n, count, order, starts, ctl,
                          static_cast<int>(stage), warps, out, out_n, st);
}

// Grouping, first step: the queries (q, qidx, n, count as for
// pcr_knn_moments) -> key (n,), int64 if `wide` else int32: the box key of
// each live query, the number of keys at the other positions (see
// box_key_kernel). Returns cudaGetLastError().
int pcr_knn_box_keys(const float* q, const long long* qidx, int n, const int* count, int nbx,
                     int nby, int nbz, int ofx, int ofy, int ofz, float inv_cell, int radius,
                     int wide, void* key, void* stream) {
  if (n == 0) return 0;
  const Binning bn{ofx, ofy, ofz, inv_cell, radius, nbx, nby, nbz};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + 255) / 256;
  if (wide)
    box_key_kernel<<<blocks, 256, 0, st>>>(bn, q, qidx, n, count, static_cast<long long*>(key));
  else
    box_key_kernel<<<blocks, 256, 0, st>>>(bn, q, qidx, n, count, static_cast<int*>(key));
  return static_cast<int>(cudaGetLastError());
}

// Grouping, second step: the sorted keys skey (n,), int64 if `wide` else
// int32, of which the first min(*count, n) are live (all n without `count`)
// -> flag (n,) u8, 1 where a work item of at most `item` queries starts (see
// item_mark_kernel), and tile_counts (2 * ceil(n / pcr_knn_tile_size()),)
// i32. Returns cudaGetLastError().
int pcr_knn_item_flags(const void* skey, int wide, int n, const int* count, int item,
                       unsigned char* flag, int* tile_counts, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = pcr::compact::tiles(n);
  if (wide)
    item_mark_kernel<<<blocks, pcr::compact::kThreads, 0, st>>>(
        static_cast<const long long*>(skey), n, count, item, flag, tile_counts);
  else
    item_mark_kernel<<<blocks, pcr::compact::kThreads, 0, st>>>(
        static_cast<const int*>(skey), n, count, item, flag, tile_counts);
  return static_cast<int>(cudaGetLastError());
}

// Grouping, third step: the flags and tile counts of pcr_knn_item_flags ->
// starts (n,) i64, the positions at which the items start in increasing
// order (the rest of the array is not written), and ctl (3,) i32: the number
// of items and two counters at 0, as pcr_knn_moments reads them. Returns
// cudaGetLastError().
int pcr_knn_item_starts(const unsigned char* flag, int n, const int* tile_counts,
                        long long* starts, int* ctl, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  pcr::compact::scatter_kernel<<<pcr::compact::tiles(n), pcr::compact::kThreads, 0, st>>>(
      flag, n, tile_counts, starts, n, nullptr, 0, ctl, nullptr, ctl + 1, 2);
  return static_cast<int>(cudaGetLastError());
}

// Positions a compaction tile holds: the tile counts of n positions take
// 2 * ceil(n / pcr_knn_tile_size()) ints.
int pcr_knn_tile_size() { return pcr::compact::kTile; }

}  // extern "C"
