// The steps of ops/normals.py estimate_normals around the k-NN moments
// kernel (knn_normals.cu), for Hopper (sm_90a), so that estimate_normals
// makes no host read after the cell size:
//
//   sample:   the radius sampler's median k-th-NN distance (sample_knn_radius);
//   tails:    the lists of the wide tier's queries and of the fallback's
//             points, compacted on the card (torch.nonzero(...)[:cap]);
//   eig:      each point's normal from its covariance (smallest_eigvec_sym3);
//   fallback: the points whose box held fewer than k candidates: their k
//             nearest in the fine-cell window of radius 2 * BASE_RADIUS, the
//             query-centred moments and the normal (_knn_window_pass and
//             normals_from_neighbors).
//
// Each computes what its plain PyTorch version computes on the card, bit for
// bit: the operations are rounded one by one, in that version's order, as
// the notes at each say (the fallback's sums from k = 64 keep their order
// below 64, and agree to rounding). Each takes every shape its plain version
// takes. ops/kernels/normals_chain.py launches them; the plain versions are
// beside the wrappers there.

#include <cstdint>

#include "compact.cuh"
#include "eigh3.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// select: the key of a given rank among the 32-bit keys that a block offers,
// by a radix select of four passes of eight bits. A float that is not
// negative orders as its bits do, +inf and NaN last, as torch.sort and
// torch.topk order it.
struct SelectShared {
  unsigned hist[256];
  unsigned digit, before;
};

// for_each(add) calls add(key) for each key this thread offers, the same
// keys at each call. Returns the key of rank `need` (1-based, at most the
// number of keys) in ascending order; `need` becomes its rank among the keys
// equal to it. Every thread of the block calls it; blockDim.x >= 32.
template <class ForEach>
__device__ unsigned block_select(ForEach&& for_each, int& need, SelectShared& sh) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) sh.hist[i] = 0;
    __syncthreads();
    for_each([&](unsigned key) {
      if ((key & mask) == prefix) atomicAdd(&sh.hist[(key >> shift) & 255u], 1u);
    });
    __syncthreads();
    if (threadIdx.x < 32) {  // the bin where the count passes need: lane a scans bins 8a ..
      unsigned bins[8], local = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        bins[b] = sh.hist[8 * lane + b];
        local += bins[b];
      }
      unsigned incl = local;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      const unsigned excl = incl - local;
      if (excl < static_cast<unsigned>(need) && static_cast<unsigned>(need) <= incl) {
        unsigned acc = excl;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (acc + bins[b] >= static_cast<unsigned>(need)) {
            sh.digit = 8 * lane + b;
            sh.before = acc;
            break;
          }
          acc += bins[b];
        }
      }
    }
    __syncthreads();
    prefix |= sh.digit << shift;
    mask |= 0xffu << shift;
    need -= static_cast<int>(sh.before);
    __syncthreads();
  }
  return prefix;
}

// ---------------------------------------------------------------------------
// sample: for each sampled query, the k-th smallest squared distance over the
// reference set (its square root, the k-th distance), and the median of those.
//
// The plain version (ops/kernels/normals_chain.py sampled_knn_reference)
// forms d2 with torch.sum(diff * diff, dim=-1). On the card ATen reduces
// those three contiguous floats with two lanes (the power of two below 3):
// lane 0 adds the first and the third, lane 1 holds the second, and a
// shuffle adds the two, so d2 = (dx^2 + dz^2) + dy^2, each step rounded.
// Only the k-th value is kept, so how equal distances are ordered does not
// matter.
//
// Two ways to the k-th distances, chosen by shape (ops/kernels/normals_chain.py
// sample_plan):
//   tiles (k <= kSampleMaxK, scratch of at most kSamplePartMax floats, at
//     most 65,535 groups of 256 queries): a block stages a tile of
//     kSampleTile references in shared memory (each gathered once per group
//     of 256 queries), each thread, one query, keeps the tile's k smallest
//     distances to it in registers, and a warp a query merges the tiles'
//     lists;
//   select (any k): a block a query, block_select over all the references.
// What bounds it: at the benchmark's shapes 256 queries x 131,072 references
// are 33.5M distances, under 0.3 GFLOP, and the references (gathered by
// index, 2.6 MB with their indices) need reading once: some microseconds.
// The select way reads the references four times a query.
// The median: block_select of the ranks (m - 1) / 2 and m / 2 of the k-th
// distances, then (a + b) * 0.5 in float32, as the plain version takes it.
constexpr int kSampleThreads = 256;  // queries of a block
constexpr int kSampleTile = 1024;    // references of a block
constexpr int kSampleMaxK = 32;      // the tiles' register lists
constexpr long long kSamplePartMax = 1LL << 25;  // the tiles' scratch, floats

__device__ __forceinline__ float torch_sum3_sq(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)), __fmul_rn(dy, dy));
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

// buf[k - 1] without a dynamic index into registers.
template <int kMax>
__device__ __forceinline__ float entry(const float (&buf)[kMax], int k) {
  float v = buf[0];
#pragma unroll
  for (int j = 1; j < kMax; ++j) v = j == k - 1 ? buf[j] : v;
  return v;
}

// The k smallest of the values offered, ascending at the front of buf
// (+inf padded), equal values counted one by one as torch.topk counts them.
template <int kMax>
struct Smallest {
  float buf[kMax];
  float bar;  // buf[k - 1]: a value must come below it to get in
  int k;
  __device__ __forceinline__ explicit Smallest(int k_) : k(k_) {
    const float kInf = __int_as_float(0x7f800000);
#pragma unroll
    for (int t = 0; t < kMax; ++t) buf[t] = kInf;
    bar = kInf;
  }
  __device__ __forceinline__ void offer(float v) {
    if (v < bar) {
      insert_sorted<kMax>(buf, v);
      bar = entry<kMax>(buf, k);
    }
  }
};

// tiles, 1. Block (x, y): tile x of the references, queries 256 y ..; each
// thread's query keeps the tile's k smallest squared distances and writes
// them, ascending, to part[(query * gridDim.x + x) * k ..].
template <int kMax>
__global__ void __launch_bounds__(kSampleThreads) sample_tile_kernel(
    const float* __restrict__ pts, const long long* __restrict__ sel, int m,
    const long long* __restrict__ ref, int n_ref, int k, float* __restrict__ part) {
  __shared__ float tile[3 * kSampleTile];
  const float kInf = __int_as_float(0x7f800000);
  const int first = blockIdx.x * kSampleTile;
  for (int i = threadIdx.x; i < kSampleTile; i += kSampleThreads) {
    const int r = first + i;
    float x = kInf, y = kInf, z = kInf;  // no reference: a distance of +inf, never kept
    if (r < n_ref) {
      const long long ri = ref != nullptr ? ref[r] : r;
      x = pts[3 * ri];
      y = pts[3 * ri + 1];
      z = pts[3 * ri + 2];
    }
    tile[3 * i] = x;
    tile[3 * i + 1] = y;
    tile[3 * i + 2] = z;
  }
  __syncthreads();
  const int q = blockIdx.y * kSampleThreads + threadIdx.x;
  if (q >= m) return;
  const long long s = sel[q];
  const float qx = pts[3 * s], qy = pts[3 * s + 1], qz = pts[3 * s + 2];
  Smallest<kMax> best(k);
  const int n = min(kSampleTile, n_ref - first);
  for (int i = 0; i < n; ++i)
    best.offer(torch_sum3_sq(qx - tile[3 * i], qy - tile[3 * i + 1], qz - tile[3 * i + 2]));
  float* out = part + (static_cast<long long>(q) * gridDim.x + blockIdx.x) * k;
#pragma unroll
  for (int t = 0; t < kMax; ++t)
    if (t < k) out[t] = best.buf[t];
}

// tiles, 2. A warp a query: its k-th distance, the k-th smallest over its
// tiles' lists (each lane keeps the k smallest of its tiles' lists, then k
// rounds of the warp's smallest head), sqrt as torch.sqrt.
constexpr int kMergeThreads = 256;

template <int kMax>
__global__ void __launch_bounds__(kMergeThreads) sample_merge_kernel(
    const float* __restrict__ part, int m, int tiles, int k, float* __restrict__ kth) {
  const int lane = threadIdx.x & 31;
  const int q = (blockIdx.x * kMergeThreads + threadIdx.x) >> 5;
  if (q >= m) return;  // whole warps leave together
  const float kInf = __int_as_float(0x7f800000);
  const float* lists = part + static_cast<long long>(q) * tiles * k;
  Smallest<kMax> best(k);
  for (int t = lane; t < tiles; t += 32)
    for (int i = 0; i < k; ++i) {
      const float v = lists[static_cast<long long>(t) * k + i];
      if (!(v < best.bar)) break;  // the list is ascending
      best.offer(v);
    }
  float v = kInf;
  for (int round = 0; round < k; ++round) {
    unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(best.buf[0])) << 32) | lane;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, key, d);
      key = o < key ? o : key;
    }
    v = __uint_as_float(static_cast<unsigned>(key >> 32));
    if (static_cast<int>(key & 0xffffffffu) == lane) {
#pragma unroll
      for (int t = 0; t + 1 < kMax; ++t) best.buf[t] = best.buf[t + 1];
      best.buf[kMax - 1] = kInf;
    }
  }
  if (lane == 0) kth[q] = __fsqrt_rn(v);  // torch.sqrt
}

// select: block q, query q; the k-th smallest squared distance over all the
// references (+inf when there are fewer than k), sqrt as torch.sqrt.
constexpr int kSelectThreads = 256;

__global__ void __launch_bounds__(kSelectThreads) sample_select_kernel(
    const float* __restrict__ pts, const long long* __restrict__ sel,
    const long long* __restrict__ ref, int n_ref, int k, float* __restrict__ kth) {
  __shared__ SelectShared sh;
  const int q = blockIdx.x;
  if (k > n_ref) {
    if (threadIdx.x == 0) kth[q] = __int_as_float(0x7f800000);
    return;
  }
  const long long s = sel[q];
  const float qx = pts[3 * s], qy = pts[3 * s + 1], qz = pts[3 * s + 2];
  int need = k;
  const unsigned key = block_select(
      [&](auto&& add) {
        for (int r = threadIdx.x; r < n_ref; r += kSelectThreads) {
          const long long ri = ref != nullptr ? ref[r] : r;
          add(__float_as_uint(
              torch_sum3_sq(qx - pts[3 * ri], qy - pts[3 * ri + 1], qz - pts[3 * ri + 2])));
        }
      },
      need, sh);
  if (threadIdx.x == 0) kth[q] = __fsqrt_rn(__uint_as_float(key));
}

// The median of the m k-th distances, one block.
constexpr int kMedianThreads = 1024;

__global__ void __launch_bounds__(kMedianThreads) median_kernel(const float* __restrict__ kth,
                                                                int m, float* __restrict__ out) {
  __shared__ SelectShared sh;
  float mid[2];
  for (int h = 0; h < 2; ++h) {
    int need = (h == 0 ? (m - 1) / 2 : m / 2) + 1;
    mid[h] = __uint_as_float(block_select(
        [&](auto&& add) {
          for (int i = threadIdx.x; i < m; i += kMedianThreads) add(__float_as_uint(kth[i]));
        },
        need, sh));
  }
  if (threadIdx.x == 0) out[0] = __fmul_rn(__fadd_rn(mid[0], mid[1]), 0.5f);
}

// ---------------------------------------------------------------------------
// tails: over the base tier's out (10, n) (ops/kernels/knn_normals.py), bit
// 0 marks the wide tier's queries, ~exact & ~unresolved & (rk2 < cert), and
// bit 1 the fallback's points, unresolved; pcr::compact::scatter_kernel lists them.
__global__ void __launch_bounds__(pcr::compact::kThreads) tails_mark_kernel(
    const float* __restrict__ out, int n, float cert, int want_tail,
    unsigned char* __restrict__ flags, int* __restrict__ tile_counts) {
  const long long p0 = static_cast<long long>(blockIdx.x) * pcr::compact::kTile +
                       threadIdx.x * pcr::compact::kPer;
  unsigned char f[pcr::compact::kPer];
#pragma unroll
  for (int j = 0; j < pcr::compact::kPer; ++j) {
    const long long p = p0 + j;
    f[j] = 0;
    if (p >= n) continue;
    const float rk2 = out[7LL * n + p];
    const bool unres = out[8LL * n + p] > 0.f, exact = out[9LL * n + p] > 0.f;
    if (want_tail && !exact && !unres && rk2 < cert) f[j] |= 1;
    if (unres) f[j] |= 2;
  }
  pcr::compact::mark_tile(f, p0, n, flags, tile_counts);
}

// ---------------------------------------------------------------------------
// eig: normals (n, 3) from the rows c00 .. c12 of a planar cov (6, stride).
__global__ void __launch_bounds__(256) eig_kernel(const float* __restrict__ cov,
                                                  long long stride, int n,
                                                  float* __restrict__ normals) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) s[j] = cov[j * stride + i];
  float nx, ny, nz;
  pcr::eigh3::smallest_eigvec(s, nx, ny, nz);
  normals[3LL * i] = nx;
  normals[3LL * i + 1] = ny;
  normals[3LL * i + 2] = nz;
}

// ---------------------------------------------------------------------------
// fallback: one block per listed point.
//
// Candidates, in the order of ops/pointgrid.py _knn_window_pass: the packed
// blocks of the window, span = radius + 1 per axis from floor((c - radius) /
// 2), c = floor(q / cell) by true division, clamped to +-1e9, less the
// origin; blocks in meshgrid order (x slowest, z fastest), each block's cap
// slots in packed order; a block outside the grid or empty is the sentinel
// row. d2 = (dx^2 + dy^2) + dz^2 with diff = q - candidate (x ** 2 is x * x
// in ATen). torch.topk's k smallest are found by block_select of the k-th
// d2 (each thread of the block over a run of consecutive candidates), then
// every smaller candidate and the first of the equal ones up to k, sorted by
// (d2, position). Among candidates of equal d2 the order of torch.topk is
// unspecified: a point whose k-th distance is tied may take another
// candidate or order, and chip_smoke.py counts such points. With fewer than
// k candidates (k > span^3 * cap, where torch.topk refuses) every candidate
// is taken and the other slots are absent. A block keeps its k selected
// candidates in `scratch` (5 k words of its own), so any k takes this kernel.
//
// Moments as normals_from_neighbors forms them on the card: the slots with a
// finite d2 are present, c = point - q; count = present; mean = c.sum(1) /
// count, where ATen's reduction of the (N, k, 3) tensor over k gives each
// output one thread with four accumulators (neighbour j into accumulator
// j % 4, in order from 0) summed ((a0 + a1) + a2) + a3; m2 = (x * y).sum(1) /
// count, where the (N, k) product is reduced over its contiguous last axis by
// bw = min(the power of two at or below k, 32) lanes, lane x adding
// neighbours x, x + bw, x + 2 bw, .. into accumulators 0, 1, 2, 3, 0, ..
// (below k = 64 two at most, and two zeros), summed ((a0 + a1) + a2) + a3,
// and a shuffle tree adding lane x + bw / 2 to lane x, then x + bw / 4, ...
// (the sums of chip_smoke.py's probe of ATen on the card); cov = m2 - mean
// mean^T, each step rounded. An absent slot adds a zero, which changes no
// sum. Below k = 64 these are ATen's schedules whatever the number of
// points, and the normals are the plain version's bits. From k = 64 ATen
// picks its lanes by the number of points (more than 32 below 16 points),
// and from k = 128 loads four neighbours at a time (and splits the mean
// across warps from k = 256); the kernel keeps the order above, and
// chip_smoke.py holds its normals to the plain version's within a tolerance.
//
// What bounds it: a few hundred points of ~12,000 candidates each (125 rows
// of up to 96 slots), five walks: tens of microseconds at the card's load
// rate; it runs only for points the base tier left unresolved, and does
// nothing when there are none.
constexpr int kFallbackThreads = 256;
constexpr int kFallbackBlocks = 264;

struct Window {
  const float* pts;
  const int* block_row;
  int cap, width, nbx, nby, nbz, sentinel;
  long long ofx, ofy, ofz;
  float cell;
  int radius;
};

__device__ __forceinline__ long long floor_div2(long long a) {
  return a >= 0 ? a / 2 : -((1 - a) / 2);
}

__device__ __forceinline__ long long window_cell(float v, float cell, long long origin) {
  return static_cast<long long>(fminf(fmaxf(floorf(__fdiv_rn(v, cell)), -1e9f), 1e9f)) - origin;
}

// The first slot of the packed row of block t of the window that starts at
// block lo.
__device__ __forceinline__ const float* window_row(const Window& wd, const long long (&lo)[3],
                                                   int t, int span) {
  const long long bx = lo[0] + t / (span * span), by = lo[1] + (t / span) % span,
                  bz = lo[2] + t % span;
  int row = wd.sentinel;
  if (bx >= 0 && by >= 0 && bz >= 0 && bx < wd.nbx && by < wd.nby && bz < wd.nbz) {
    const int r = __ldg(&wd.block_row[bx + wd.nbx * (by + wd.nby * bz)]);
    row = r >= 0 ? r : wd.sentinel;
  }
  return wd.pts + static_cast<size_t>(row) * wd.cap * wd.width;
}

__global__ void __launch_bounds__(kFallbackThreads) fallback_kernel(
    Window wd, const float* __restrict__ points, const long long* __restrict__ un,
    const int* __restrict__ count, int cap_q, int k, int* __restrict__ scratch,
    float* __restrict__ normals) {
  __shared__ SelectShared sh;
  __shared__ int warp_eq[kFallbackThreads / 32];
  __shared__ int n_less, n_present;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this block's k selected candidates: keys, positions, centred coordinates
  unsigned* sel_key = reinterpret_cast<unsigned*>(scratch) + 5LL * k * blockIdx.x;
  int* sel_pos = reinterpret_cast<int*>(sel_key + k);
  float* sc = reinterpret_cast<float*>(sel_pos + k);  // (k, 3) in (d2, position) order
  const int live = min(*count, cap_q);
  const int span = wd.radius + 1, n_cand = span * span * span * wd.cap;
  const int take = min(k, n_cand);
  const int run = (n_cand + kFallbackThreads - 1) / kFallbackThreads;
  const int c0 = min(tid * run, n_cand), c1 = min(c0 + run, n_cand);  // this thread's candidates
  int bw = 1;
  while (2 * bw <= k && bw < 32) bw *= 2;

  for (int j = blockIdx.x; j < live; j += gridDim.x) {
    const long long pi = un[j];
    const float q[3] = {points[3 * pi], points[3 * pi + 1], points[3 * pi + 2]};
    const long long lo[3] = {floor_div2(window_cell(q[0], wd.cell, wd.ofx) - wd.radius),
                             floor_div2(window_cell(q[1], wd.cell, wd.ofy) - wd.radius),
                             floor_div2(window_cell(q[2], wd.cell, wd.ofz) - wd.radius)};
    // calls f(position, d2 bits) for this thread's run of candidates
    auto walk = [&](auto&& f) {
      if (c0 >= c1) return;
      int t = c0 / wd.cap, slot = c0 - t * wd.cap;
      const float* row = window_row(wd, lo, t, span);
      for (int c = c0; c < c1; ++c) {
        const float* p = row + static_cast<size_t>(slot) * wd.width;
        const float dx = q[0] - p[0], dy = q[1] - p[1], dz = q[2] - p[2];
        f(c, __float_as_uint(
                 __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz))));
        if (++slot == wd.cap && c + 1 < c1) {
          slot = 0;
          row = window_row(wd, lo, ++t, span);
        }
      }
    };

    // the take-th smallest key, and how many of the keys equal to it to keep
    int need = take;
    const unsigned kth = block_select(
        [&](auto&& add) { walk([&](int, unsigned key) { add(key); }); }, need, sh);

    // every candidate below it (slots in any order: sorted below), then the
    // first `need` equal to it in position order; absent slots to k
    if (tid == 0) {
      n_less = 0;
      n_present = 0;
    }
    __syncthreads();
    int my_eq = 0;
    walk([&](int pos, unsigned key) {
      if (key < kth) {
        const int e = atomicAdd(&n_less, 1);
        sel_key[e] = key;
        sel_pos[e] = pos;
      } else if (key == kth) {
        ++my_eq;
      }
    });
    int incl = my_eq;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_eq[warp] = incl;
    __syncthreads();
    int r = incl - my_eq;
    for (int w = 0; w < warp; ++w) r += warp_eq[w];
    if (my_eq > 0 && r < need) {
      walk([&](int pos, unsigned key) {
        if (key == kth) {
          if (r < need) {
            sel_key[take - need + r] = key;
            sel_pos[take - need + r] = pos;
          }
          ++r;
        }
      });
    }
    for (int e = take + tid; e < k; e += kFallbackThreads) {
      sel_key[e] = 0xffffffffu;  // absent: after every candidate
      sel_pos[e] = e;
    }
    __syncthreads();

    // sorted by (d2, position): each slot's rank, and its centred point there
    for (int e = tid; e < k; e += kFallbackThreads) {
      const unsigned mk = sel_key[e];
      const int mp = sel_pos[e];
      int rank = 0;
      for (int f = 0; f < k; ++f) {
        const unsigned fk = sel_key[f];
        rank += (fk < mk) || (fk == mk && sel_pos[f] < mp);
      }
      float c[3] = {0.f, 0.f, 0.f};
      if (mk < 0x7f800000u) {  // a finite d2: the point is present
        const int t = mp / wd.cap, slot = mp - t * wd.cap;
        const float* p = window_row(wd, lo, t, span) + static_cast<size_t>(slot) * wd.width;
#pragma unroll
        for (int a = 0; a < 3; ++a) c[a] = __fsub_rn(p[a], q[a]);
        atomicAdd(&n_present, 1);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) sc[3 * rank + a] = c[a];
    }
    __syncthreads();

    if (warp == 0) {
      const float denom = fmaxf(static_cast<float>(n_present), 1.0f);
      // mean: lane a < 3 sums component a over four accumulators
      float mean_a = 0.f;
      if (lane < 3) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int e = 0; e < k; ++e) acc[e & 3] = __fadd_rn(acc[e & 3], sc[3 * e + lane]);
        mean_a = __fdiv_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]), denom);
      }
      const float mean[3] = {__shfl_sync(kFull, mean_a, 0), __shfl_sync(kFull, mean_a, 1),
                             __shfl_sync(kFull, mean_a, 2)};
      // m2 of the pairs xx yy zz xy xz yz over bw lanes and a shuffle tree
      constexpr int kA[6] = {0, 1, 2, 0, 0, 1}, kB[6] = {0, 1, 2, 1, 2, 2};
      float cov[6];
#pragma unroll
      for (int pr = 0; pr < 6; ++pr) {
        float t = 0.f;
        if (lane < bw) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int e = lane, i = 0; e < k; e += bw, ++i)
            acc[i & 3] = __fadd_rn(acc[i & 3], __fmul_rn(sc[3 * e + kA[pr]], sc[3 * e + kB[pr]]));
          t = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
        }
        for (int off = bw / 2; off > 0; off >>= 1)
          t = __fadd_rn(t, __shfl_down_sync(kFull, t, off));
        cov[pr] = __fsub_rn(__fdiv_rn(t, denom), __fmul_rn(mean[kA[pr]], mean[kB[pr]]));
      }
      if (lane == 0) {
        float nx, ny, nz;
        pcr::eigh3::smallest_eigvec(cov, nx, ny, nz);
        normals[3 * pi] = nx;
        normals[3 * pi + 1] = ny;
        normals[3 * pi + 2] = nz;
      }
    }
    __syncthreads();  // the shared arrays and the scratch serve the next point
  }
}

}  // namespace

extern "C" {

// The shapes of the launches: the sampler's tile of references, its largest
// k and scratch (floats) on the tiles' way, the compaction's tile, the
// fallback's blocks.
int pcr_normals_sample_tile() { return kSampleTile; }
int pcr_normals_sample_max_k() { return kSampleMaxK; }
long long pcr_normals_sample_part_max() { return kSamplePartMax; }
int pcr_normals_tile_size() { return pcr::compact::kTile; }
int pcr_normals_fallback_blocks() { return kFallbackBlocks; }

// pts (n, 3) f32; sel (m,) i64 the sampled queries; ref (n_ref,) i64 the
// reference subsample, or null for the first n_ref points themselves ->
// median (1,) f32, the median of the queries' k-th nearest distances; kth
// (m,) f32 is scratch, and so is part (m * ceil(n_ref /
// pcr_normals_sample_tile()) * k,) f32 on the tiles' way, or null for the
// select way. Three kernels on the tiles' way, two on the select way, on
// `stream`; returns cudaGetLastError(), or -1 for a k or m below 1, no
// reference, or a part for a k above pcr_normals_sample_max_k() or more
// than 65,535 groups of 256 queries.
int pcr_normals_sample(const float* pts, const long long* sel, int m, const long long* ref,
                       int n_ref, int k, float* part, float* kth, float* median, void* stream) {
  if (k < 1 || m < 1 || n_ref < 1) return -1;
  if (part != nullptr && (k > kSampleMaxK || (m + kSampleThreads - 1) / kSampleThreads > 65535))
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (part != nullptr) {
    const int tiles = (n_ref + kSampleTile - 1) / kSampleTile;
    const dim3 grid(tiles, (m + kSampleThreads - 1) / kSampleThreads);
    const int merge_blocks = (m + kMergeThreads / 32 - 1) / (kMergeThreads / 32);
    if (k <= 8) {
      sample_tile_kernel<8><<<grid, kSampleThreads, 0, st>>>(pts, sel, m, ref, n_ref, k, part);
      sample_merge_kernel<8><<<merge_blocks, kMergeThreads, 0, st>>>(part, m, tiles, k, kth);
    } else {
      sample_tile_kernel<32><<<grid, kSampleThreads, 0, st>>>(pts, sel, m, ref, n_ref, k, part);
      sample_merge_kernel<32><<<merge_blocks, kMergeThreads, 0, st>>>(part, m, tiles, k, kth);
    }
  } else {
    sample_select_kernel<<<m, kSelectThreads, 0, st>>>(pts, sel, ref, n_ref, k, kth);
  }
  median_kernel<<<1, kMedianThreads, 0, st>>>(kth, m, median);
  return static_cast<int>(cudaGetLastError());
}

// The base tier's out (10, n) f32 -> tail (cap_t,) and un (cap_q,) i64, the
// first cap_t points of the wide tier's queries (none unless want_tail) and
// the first cap_q unresolved points in index order, and totals (2,) i32 the
// whole count of each. flags (n,) u8 and tile_counts (2 * ceil(n /
// pcr_normals_tile_size()),) i32 are scratch. Two kernels; returns
// cudaGetLastError().
int pcr_normals_tails(const float* out, int n, float cert, int want_tail, long long cap_t,
                      long long cap_q, unsigned char* flags, int* tile_counts, long long* tail,
                      long long* un, int* totals, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = pcr::compact::tiles(n);
  tails_mark_kernel<<<tiles, pcr::compact::kThreads, 0, st>>>(out, n, cert, want_tail, flags,
                                                               tile_counts);
  pcr::compact::scatter_kernel<<<tiles, pcr::compact::kThreads, 0, st>>>(
      flags, n, tile_counts, tail, cap_t, un, cap_q, totals, totals + 1, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

// cov (6 rows of `stride` f32: c00 c11 c22 c01 c02 c12) -> normals (n, 3)
// f32. Returns cudaGetLastError().
int pcr_normals_eig(const float* cov, long long stride, int n, float* normals, void* stream) {
  if (n == 0) return 0;
  eig_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(cov, stride, n,
                                                                             normals);
  return static_cast<int>(cudaGetLastError());
}

// The packed grid (pts (R+1, cap * width) f32, block_row (NB,) i32, its
// dims, fine-cell origin and cell size; `sentinel` = R, the row of no
// point), the cloud points (n, 3) f32 and the list un (cap_q,) i64 of which
// the first min(*count, cap_q) are live (count i32 on the card) -> the
// normal of each listed point into normals (n, 3) f32. scratch holds 5 * k
// i32 for each of min(cap_q, pcr_normals_fallback_blocks()) blocks. One
// launch; returns cudaGetLastError(), or -1 for a k below 1.
int pcr_normals_fallback(const float* pts, const int* block_row, int cap, int width, int nbx,
                         int nby, int nbz, int sentinel, long long ofx, long long ofy,
                         long long ofz, float cell, int radius, const float* points,
                         const long long* un, const int* count, int cap_q, int k, int* scratch,
                         float* normals, void* stream) {
  if (k < 1) return -1;
  if (cap_q == 0) return 0;
  const Window wd{pts, block_row, cap, width, nbx, nby, nbz, sentinel, ofx, ofy, ofz,
                  cell, radius};
  const int blocks = cap_q < kFallbackBlocks ? cap_q : kFallbackBlocks;
  fallback_kernel<<<blocks, kFallbackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      wd, points, un, count, cap_q, k, scratch, normals);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
