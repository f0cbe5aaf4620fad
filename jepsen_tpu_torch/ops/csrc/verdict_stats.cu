// Verdict statistics over a shard of checked histories, by hand for Hopper
// (sm_90a).
//
// Replaces jepsen_tpu/parallel/mesh.py:verdict_stats, the three jnp.sum
// reductions (an all-reduce over the history axis under a mesh) that the JAX
// package runs on the TPU.  Per shard it counts, over B rows of the checker's
// bool outputs ok and overflow:
//   valid   = ok & ~overflow
//   invalid = ~ok & ~overflow
//   unknown = overflow
// into an int64 [3] tensor on the shard's device; the caller adds the
// shards' counts on the mesh's first device (the all-reduce).
//
// What bounds it on this card: device memory, 2B bytes read once and 24
// written, so at the batch sizes the engine dispatches (at most 16384 rows
// per chip) one launch and its few microseconds of latency are the whole
// cost.  The design keeps it to one launch besides the zeroing memset: a
// grid-stride loop in which each warp turns 32 rows into three ballots and
// three popcounts, one shared-memory atomic per warp and count, and one
// global atomic per block and count.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__global__ void verdict_stats_kernel(const uint8_t* __restrict__ ok,
                                     const uint8_t* __restrict__ overflow,
                                     int64_t B,
                                     unsigned long long* __restrict__ counts) {
  __shared__ unsigned long long block_counts[3];
  if (threadIdx.x < 3) block_counts[threadIdx.x] = 0ull;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  unsigned long long valid = 0ull, invalid = 0ull, unknown = 0ull;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // base is uniform across the block, so every lane of a warp takes part in
  // every ballot; rows past B vote false
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x; base < B;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool live = i < B;
    const bool o = live && ok[i] != 0;
    const bool u = live && overflow[i] != 0;
    const unsigned bv = __ballot_sync(0xFFFFFFFFu, o && !u);
    const unsigned bi = __ballot_sync(0xFFFFFFFFu, live && !o && !u);
    const unsigned bu = __ballot_sync(0xFFFFFFFFu, u);
    if (lane == 0) {
      valid += __popc(bv);
      invalid += __popc(bi);
      unknown += __popc(bu);
    }
  }
  if (lane == 0) {
    atomicAdd(&block_counts[0], valid);
    atomicAdd(&block_counts[1], invalid);
    atomicAdd(&block_counts[2], unknown);
  }
  __syncthreads();
  if (threadIdx.x < 3 && block_counts[threadIdx.x] != 0ull) {
    atomicAdd(&counts[threadIdx.x], block_counts[threadIdx.x]);
  }
}

}  // namespace

// Count the valid, invalid and unknown rows of ok/overflow ([B] uint8, i.e.
// torch.bool, contiguous) into counts ([3] int64, overwritten) on `stream`;
// returns the CUDA error of the memset or of the launch (0 on success).
extern "C" int verdict_stats_launch(const void* ok, const void* overflow,
                                    long long B, void* counts, void* stream) {
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, 3 * sizeof(int64_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  long long blocks = (B + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  verdict_stats_kernel<<<static_cast<int>(blocks), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(ok), static_cast<const uint8_t*>(overflow),
      static_cast<int64_t>(B), static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
