// Stream compaction on the card without a host read: the positions p of an
// array whose flag sets bit b, in increasing order, into list b (b = 0, 1),
// with the length of each list left on the card. Two kernels:
//
//   1. a marking kernel of the caller's (its flags are its own business)
//      stores one byte of flags per position and ends with mark_tile(): per
//      tile of kTile positions, the count of each list;
//   2. scatter_kernel: each tile adds up the counts of the tiles before it,
//      scans its own flags and writes its positions, at most `cap` of each
//      list (the first `cap` in position order, as torch.nonzero(...)[:cap]);
//      the last tile writes each list's whole count.
//
// A tile is a block of kThreads threads, each with kPer consecutive
// positions, so the scan in thread order is the scan in position order. The
// second kernel reads n / kTile counts per tile: at 1.2M positions, 586 tiles
// and some 170,000 reads in all. knn_normals.cu lists the k-NN kernel's work
// items so, normals_chain.cu the tails of estimate_normals.

#pragma once

namespace pcr {
namespace compact {

constexpr int kThreads = 256;
constexpr int kPer = 8;
constexpr int kTile = kThreads * kPer;
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr int tiles(long long n) {
  return static_cast<int>((n + kTile - 1) / kTile);
}

// The sum of v over the block, in every thread. `red` holds kThreads / 32
// entries; the block must not use it meanwhile.
__device__ __forceinline__ int2 block_sum(int2 v, int2* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v.x += __shfl_xor_sync(kAll, v.x, d);
    v.y += __shfl_xor_sync(kAll, v.y, d);
  }
  __syncthreads();  // red may still be read by an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int2 s = make_int2(0, 0);
#pragma unroll
  for (int j = 0; j < kThreads / 32; ++j) {
    s.x += red[j].x;
    s.y += red[j].y;
  }
  return s;
}

// The end of a marking kernel: this thread's flags f of positions
// p0 .. p0 + kPer - 1 (0 at and beyond n) go to flags[], and thread 0 writes
// the tile's count of each list to tile_counts[2 * tile + b].
__device__ __forceinline__ void mark_tile(const unsigned char (&f)[kPer], long long p0,
                                          long long n, unsigned char* __restrict__ flags,
                                          int* __restrict__ tile_counts) {
  __shared__ int2 red[kThreads / 32];
  int2 c = make_int2(0, 0);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (p0 + i < n) flags[p0 + i] = f[i];
    c.x += f[i] & 1;
    c.y += (f[i] >> 1) & 1;
  }
  c = block_sum(c, red);
  if (threadIdx.x == 0) {
    tile_counts[2 * blockIdx.x] = c.x;
    tile_counts[2 * blockIdx.x + 1] = c.y;
  }
}

// One block per tile (tiles(n) blocks of kThreads). list1 may be null (cap
// 0); so may total1. total0 / total1 get the whole counts. `zero`, if not
// null, points at `n_zero` ints that block 0 sets to 0 (counters of the
// launch that reads the lists).
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const unsigned char* __restrict__ flags, long long n, const int* __restrict__ tile_counts,
    long long* __restrict__ list0, long long cap0, long long* __restrict__ list1,
    long long cap1, int* __restrict__ total0, int* __restrict__ total1, int* __restrict__ zero,
    int n_zero) {
  __shared__ int2 red[kThreads / 32];
  __shared__ int2 warp_incl[kThreads / 32];
  const int tile = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (zero != nullptr && tile == 0 && threadIdx.x < n_zero) zero[threadIdx.x] = 0;

  // where this tile's entries start: the counts of the tiles before it
  int2 off = make_int2(0, 0);
  for (int t = threadIdx.x; t < tile; t += kThreads) {
    off.x += tile_counts[2 * t];
    off.y += tile_counts[2 * t + 1];
  }
  off = block_sum(off, red);

  // this thread's flags and its exclusive rank in the tile
  const long long p0 = static_cast<long long>(tile) * kTile + threadIdx.x * kPer;
  unsigned char f[kPer];
  int2 c = make_int2(0, 0);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    f[i] = p0 + i < n ? flags[p0 + i] : 0;
    c.x += f[i] & 1;
    c.y += (f[i] >> 1) & 1;
  }
  int2 incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(kAll, incl.x, d), y = __shfl_up_sync(kAll, incl.y, d);
    if (lane >= d) {
      incl.x += x;
      incl.y += y;
    }
  }
  if (lane == 31) warp_incl[warp] = incl;
  __syncthreads();
  long long r0 = off.x + incl.x - c.x, r1 = off.y + incl.y - c.y;
  for (int j = 0; j < warp; ++j) {
    r0 += warp_incl[j].x;
    r1 += warp_incl[j].y;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if (f[i] & 1) {
      if (r0 < cap0) list0[r0] = p0 + i;
      ++r0;
    }
    if (f[i] & 2) {
      if (r1 < cap1) list1[r1] = p0 + i;
      ++r1;
    }
  }
  if (tile == gridDim.x - 1 && threadIdx.x == kThreads - 1) {
    *total0 = static_cast<int>(r0);
    if (total1 != nullptr) *total1 = static_cast<int>(r1);
  }
}

}  // namespace compact
}  // namespace pcr
