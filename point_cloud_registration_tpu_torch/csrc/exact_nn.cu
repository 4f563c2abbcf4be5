// Exact brute-force 1-NN for Hopper (sm_90a): for every query the nearest of
// all reference points, the validation oracle of the grid engines.
//
// Replaces the TPU kernel point_cloud_registration_tpu/ops/pallas/exact_nn.py
// (_kernel, launched by exact_nn_pallas). It computes the same function:
// d2 = (qx - rx)^2 + (qy - ry)^2 + (qz - rz)^2 as a sum of squares (never the
// GEMM expansion), the minimum over all references with a strict "<" in index
// order, so the first index wins ties; sqrt at the end. The three products
// and two sums are rounded one by one (no fused multiply-add), so the
// distances equal the plain PyTorch version's bit for bit.
//
// One thread per query keeps its running (best d2, best index) in registers.
// References stream through shared memory in tiles of kTile points, loaded
// by the whole block with coalesced reads and then read by every thread at
// the same address (a broadcast). With few queries the grid's second
// dimension splits the references into segments, so that the card is filled;
// a second small kernel takes the minimum over the segments in segment order
// (strict "<" again, so the first index still wins).
//
// Bound: operations. Nq x Nr distance evaluations of 8 flops each against
// 12 (Nq + Nr) bytes read: at 4,096 queries and 1.2M references 39 GFLOP,
// 0.6 ms at the fp32 peak, against 14 MB, 4 us of memory time.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;  // queries per block
constexpr int kTile = 1024;  // reference points per shared-memory tile

__global__ void __launch_bounds__(kBlock) exact_nn_kernel(
    const float* __restrict__ q, int nq, const float* __restrict__ ref, int nr,
    int seg_len, float* __restrict__ part_d2, int* __restrict__ part_idx) {
  __shared__ float tile[3 * kTile];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < nq;
  const float qx = live ? q[3 * i] : 0.f;
  const float qy = live ? q[3 * i + 1] : 0.f;
  const float qz = live ? q[3 * i + 2] : 0.f;
  const int r0 = blockIdx.y * seg_len;
  const int r1 = min(r0 + seg_len, nr);
  float best = __int_as_float(0x7f800000);  // +inf
  int best_idx = -1;
  for (int base = r0; base < r1; base += kTile) {
    const int m = min(kTile, r1 - base);
    __syncthreads();
    for (int j = threadIdx.x; j < 3 * m; j += kBlock)
      tile[j] = ref[3 * static_cast<size_t>(base) + j];
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float dx = qx - tile[3 * j], dy = qy - tile[3 * j + 1],
                  dz = qz - tile[3 * j + 2];
      const float d2 = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 < best) {
        best = d2;
        best_idx = base + j;
      }
    }
  }
  if (live) {
    part_d2[static_cast<size_t>(blockIdx.y) * nq + i] = best;
    part_idx[static_cast<size_t>(blockIdx.y) * nq + i] = best_idx;
  }
}

__global__ void __launch_bounds__(kBlock) exact_nn_merge_kernel(
    const float* __restrict__ part_d2, const int* __restrict__ part_idx, int nq,
    int segments, float* __restrict__ dist, int* __restrict__ idx) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
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

}  // namespace

extern "C" {

// Queries per block: the wrapper picks the number of reference segments from it.
int pcr_exact_nn_block_size() { return kBlock; }

// q (nq, 3), ref (nr, 3) f32 -> dist (nq,) f32, idx (nq,) i32. part_d2 and
// part_idx are (segments, nq) scratch. Launches both kernels on `stream` and
// returns cudaGetLastError().
int pcr_exact_nn(const float* q, int nq, const float* ref, int nr, int segments,
                 float* part_d2, int* part_idx, float* dist, int* idx,
                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_blocks = (nq + kBlock - 1) / kBlock;
  const int seg_len = (nr + segments - 1) / segments;
  exact_nn_kernel<<<dim3(q_blocks, segments), kBlock, 0, st>>>(
      q, nq, ref, nr, seg_len, part_d2, part_idx);
  exact_nn_merge_kernel<<<q_blocks, kBlock, 0, st>>>(part_d2, part_idx, nq,
                                                     segments, dist, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
