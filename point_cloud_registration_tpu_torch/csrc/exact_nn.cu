// Exact brute-force 1-NN for Hopper (sm_90a): for every query the nearest of
// all reference points, the validation oracle of the grid engines.
//
// Replaces the TPU kernel point_cloud_registration_tpu/ops/pallas/exact_nn.py
// (_kernel, launched by exact_nn_pallas). It computes the same function:
// d2 = (qx - rx)^2 + (qy - ry)^2 + (qz - rz)^2 as a sum of squares (never the
// GEMM expansion), the minimum over all references, the first index on ties;
// sqrt at the end. Every pair is evaluated. The three products and two sums
// are rounded one by one (no fused multiply-add), so the distances equal the
// plain PyTorch version's bit for bit.
//
// Bound: operations. Nq x Nr distance evaluations against 12 (Nq + Nr) bytes
// read: at 4,096 queries and 1.2M references 4.9 G pairs against 14 MB (4 us
// of memory time). A pair is 8 separately rounded operations, and an unfused
// instruction does one where the card's fp32 peak counts a fused multiply-add
// as two: at half that peak the contract allows 1.17 ms. What a kernel pays
// on top is every instruction per pair that is not one of the eight: reads of
// the reference from shared memory, and the work of carrying the index. The
// design keeps both well under one instruction per pair:
//
//   * kQ queries per thread, in registers. A group of kGroup reference points
//     is 3 * kGroup consecutive floats of the tile, read with 16-byte loads at
//     an address all lanes share (a broadcast) and used for kQ * kGroup pairs:
//     3 / (4 kQ) shared-memory loads per pair.
//   * The minimum first, the index after, as the TPU kernel does (min, then
//     one compare per tile): per pair only best = min(best, d2) of the group
//     is formed (a tree of kGroup - 1 minimums); per group and query one
//     compare keeps the first group that reached the running minimum (strict
//     "<": an equal later group does not replace it). The index inside the
//     group is found once, after the segment: the group's kGroup distances are
//     formed again with the same roundings, hence the same bits, and the first
//     that equals the minimum is the answer. Nothing in the loop depends on
//     the data, so no warp diverges.
//   * Tiles of kTile points arrive by bulk asynchronous copies
//     (cp.async.bulk, completion counted in bytes on an mbarrier), issued by
//     one thread, kStages - 1 tiles ahead of the one being consumed. The bulk
//     copy was taken over cp.async groups because a tile is one contiguous
//     run: one instruction moves it and no thread spends registers or issue
//     slots on it. Its rules are met as follows: segments start at multiples
//     of four points (48 bytes) of a 16-byte aligned reference; of a ragged
//     last tile the whole groups of four points go by the bulk copy, and the
//     issuing thread writes the up to three points behind them, and +inf up
//     to the next multiple of kGroup (+inf gives d2 = +inf or NaN, which never
//     is a new minimum), before it arrives on the barrier.
//   * The reference is cut into segments across the grid's second dimension
//     so that query blocks x segments fill every SM with kBlocksPerSm
//     resident blocks, all in one wave. A second small kernel takes the
//     minimum over the segments in segment order (strict "<" again, so the
//     first index still wins).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // threads per block
constexpr int kQ = 4;        // queries per thread
constexpr int kQueries = kBlock * kQ;  // queries per block
constexpr int kGroup = 8;    // reference points per index group
constexpr int kTile = 1024;  // reference points per shared-memory tile
constexpr int kStages = 3;   // tiles in shared memory
constexpr int kBlocksPerSm = 4;
constexpr int kMergeBlock = 128;

static_assert(kTile % kGroup == 0 && kGroup % 4 == 0, "tiles hold whole groups");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// d2 of one pair, each operation rounded by itself, in the plain version's order.
__device__ __forceinline__ float dist2(float qx, float qy, float qz, float rx,
                                       float ry, float rz) {
  const float dx = __fsub_rn(qx, rx), dy = __fsub_rn(qy, ry), dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Thread 0 only: starts the copy of the `m` reference points at `src` into
// `tile`, padded with +inf to a multiple of kGroup, and arrives on `bar`.
__device__ __forceinline__ void issue_tile(float* tile, const float* src, int m,
                                           unsigned long long* bar) {
  const int whole = m & ~3;  // points that go by the bulk copy
  const int padded = (m + kGroup - 1) / kGroup * kGroup;
  for (int v = 3 * whole; v < 3 * padded; ++v)
    tile[v] = v < 3 * m ? __ldg(src + v) : __int_as_float(0x7f800000);
  mbar_arrive_expect_tx(bar, 12u * whole);
  if (whole > 0) bulk_copy(tile, src, 12u * whole, bar);
}

__global__ void __launch_bounds__(kBlock, kBlocksPerSm) exact_nn_kernel(
    const float* __restrict__ q, int nq, const float* __restrict__ ref, int nr,
    int seg_len, float* __restrict__ part_d2, int* __restrict__ part_idx) {
  __shared__ __align__(128) float tiles[kStages][3 * kTile];
  __shared__ __align__(8) unsigned long long full[kStages];
  const float kInf = __int_as_float(0x7f800000);

  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int group[kQ];  // first reference index of the first group that reached best
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = blockIdx.x * kQueries + k * kBlock + threadIdx.x;
    const bool live = i < nq;
    qx[k] = live ? q[3 * i] : 0.f;
    qy[k] = live ? q[3 * i + 1] : 0.f;
    qz[k] = live ? q[3 * i + 2] : 0.f;
    best[k] = kInf;
    group[k] = -1;
  }
  const int r0 = min(blockIdx.y * seg_len, nr);
  const int r1 = min(r0 + seg_len, nr);
  const int n_tiles = (r1 - r0 + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 0; t < min(kStages, n_tiles); ++t) {
      const int base = r0 + t * kTile;
      issue_tile(tiles[t], ref + 3 * static_cast<size_t>(base), min(kTile, r1 - base),
                 &full[t]);
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int base = r0 + t * kTile;
    const int m = min(kTile, r1 - base);
    mbar_wait(&full[s], (t / kStages) & 1);
    const float4* p4 = reinterpret_cast<const float4*>(tiles[s]);
    const int n_groups = (m + kGroup - 1) / kGroup;
#pragma unroll 1
    for (int g = 0; g < n_groups; ++g, p4 += 3 * kGroup / 4) {
      float r[3 * kGroup];
#pragma unroll
      for (int v = 0; v < 3 * kGroup / 4; ++v) {
        const float4 a = p4[v];
        r[4 * v] = a.x;
        r[4 * v + 1] = a.y;
        r[4 * v + 2] = a.z;
        r[4 * v + 3] = a.w;
      }
      const int first = base + g * kGroup;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        float d[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          d[j] = dist2(qx[k], qy[k], qz[k], r[3 * j], r[3 * j + 1], r[3 * j + 2]);
#pragma unroll
        for (int w = kGroup / 2; w > 0; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j) d[j] = fminf(d[j], d[j + w]);
        if (d[0] < best[k]) {
          best[k] = d[0];
          group[k] = first;
        }
      }
    }
    __syncthreads();  // every thread has read stage s
    if (threadIdx.x == 0 && t + kStages < n_tiles) {
      const int next = r0 + (t + kStages) * kTile;
      issue_tile(tiles[s], ref + 3 * static_cast<size_t>(next), min(kTile, r1 - next),
                 &full[s]);
    }
  }

  // The index inside the winning group: the first point whose distance, formed
  // again by the same operations, is the minimum.
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = blockIdx.x * kQueries + k * kBlock + threadIdx.x;
    if (i >= nq) continue;
    int idx = -1;
    if (group[k] >= 0) {
      const int end = min(group[k] + kGroup, r1);
      for (int j = end - 1; j >= group[k]; --j) {
        const float* p = ref + 3 * static_cast<size_t>(j);
        if (dist2(qx[k], qy[k], qz[k], __ldg(p), __ldg(p + 1), __ldg(p + 2)) == best[k])
          idx = j;
      }
    }
    part_d2[static_cast<size_t>(blockIdx.y) * nq + i] = best[k];
    part_idx[static_cast<size_t>(blockIdx.y) * nq + i] = idx;
  }
}

__global__ void __launch_bounds__(kMergeBlock) exact_nn_merge_kernel(
    const float* __restrict__ part_d2, const int* __restrict__ part_idx, int nq,
    int segments, float* __restrict__ dist, int* __restrict__ idx) {
  const int i = blockIdx.x * kMergeBlock + threadIdx.x;
  if (i >= nq) return;
  float best = __int_as_float(0x7f800000);
  int best_idx = -1;
  for (int s = 0; s < segments; ++s) {
    const float d2 = part_d2[static_cast<size_t>(s) * nq + i];
    if (d2 < best) {
      best = d2;
      best_idx = part_idx[static_cast<size_t>(s) * nq + i];
    }
  }
  dist[i] = sqrtf(best);
  idx[i] = best_idx;
}

int query_blocks(int nq) { return (nq + kQueries - 1) / kQueries; }

// References per segment: segments start at multiples of four points, so that
// every bulk copy starts at a multiple of 16 bytes.
int segment_length(int nr, int segments) {
  return ((nr + segments - 1) / segments + 3) & ~3;
}

}  // namespace

extern "C" {

// The number of reference segments for nq queries and nr references on the
// current device: as many as fill every SM with kBlocksPerSm blocks in one
// wave, at least one tile each. The wrapper sizes the scratch by it. Returns
// minus the CUDA error if the device cannot be asked.
int pcr_exact_nn_segments(int nq, int nr) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int by_card = sms * kBlocksPerSm / query_blocks(nq);
  const int by_tiles = (nr + kTile - 1) / kTile;
  return max(1, min(by_card, by_tiles));
}

// The references each of `segments` segments holds (the last one fewer).
int pcr_exact_nn_segment_length(int nr, int segments) {
  return segment_length(nr, segments);
}

// q (nq, 3), ref (nr, 3) f32, ref 16-byte aligned -> dist (nq,) f32, idx (nq,)
// i32. part_d2 and part_idx are (segments, nq) scratch. Launches both kernels
// on `stream` and returns cudaGetLastError(), or -1 for an unaligned ref.
int pcr_exact_nn(const float* q, int nq, const float* ref, int nr, int segments,
                 float* part_d2, int* part_idx, float* dist, int* idx,
                 void* stream) {
  if (reinterpret_cast<uintptr_t>(ref) % 16 != 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int seg_len = segment_length(nr, segments);
  exact_nn_kernel<<<dim3(query_blocks(nq), segments), kBlock, 0, st>>>(
      q, nq, ref, nr, seg_len, part_d2, part_idx);
  exact_nn_merge_kernel<<<(nq + kMergeBlock - 1) / kMergeBlock, kMergeBlock, 0, st>>>(
      part_d2, part_idx, nq, segments, dist, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
