// Verdict statistics over a shard of checked histories, by hand for Hopper
// (sm_90a).
//
// Replaces jepsen_tpu/parallel/mesh.py:verdict_stats, the three jnp.sum
// reductions (an all-reduce over the history axis under a mesh) that the JAX
// package runs on the TPU.  Per shard it counts, over B rows of the checker's
// bool outputs ok and overflow (a nonzero byte is true):
//   valid   = ok & ~overflow
//   invalid = ~ok & ~overflow
//   unknown = overflow
// into an int64 [3] tensor on the shard's device; the caller adds the
// shards' counts on the mesh's first device (the all-reduce).
//
// What bounds it on this card: device memory, 2B bytes read once and 24
// written, so at the batch sizes the engine dispatches (at most 16384 rows
// per chip, 10 ns of bytes) the launch itself is the cost.  The design is
// one launch and nothing else on the stream: no memset, the counts written
// with plain stores.  Each of a block's 256 threads loads up to 8 words of
// 16 bytes of ok and of overflow at once, counts the true bytes of a 32-bit
// word as __popc(__vcmpne4(w, 0) & 0x01010101), and the block reduces by
// __reduce_add_sync and one step in shared memory (one barrier); invalid
// is B - valid - unknown.  Up to kSingleMaxRows rows one block does it
// all (scripts/stats_ab.py --switch times both sides: one block was faster
// to 32768 rows, a grid from 65536).  Past that a grid of blocks writes
// per-block partials, and the last block to finish (an atomic ticket after
// __threadfence) sums them, writes the counts and resets the ticket; the
// ticket and the partials are module globals, so each device has its own,
// zeroed once when the module loads.  Grid launches on one device must
// therefore be ordered on one stream, as the wrapper's are.  Rows whose
// two arrays start at different offsets mod 16 (a slice such as ok[1:])
// are counted byte by byte in the same kernel; otherwise the bytes before
// the first 16-byte boundary and after the last are counted one a thread.

#include <cstdint>
#include <cuda_runtime.h>

// the single-block/grid switch in rows; a build may define it to time one
// side against the other at the same shape
#ifndef VERDICT_STATS_SINGLE_MAX_ROWS
#define VERDICT_STATS_SINGLE_MAX_ROWS 32768
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // 16-byte words a thread loads at once
constexpr int kMaxBlocks = kThreads;  // the last block sums one a thread
constexpr long long kSingleMaxRows = VERDICT_STATS_SINGLE_MAX_ROWS;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ unsigned int g_ticket;
__device__ unsigned long long g_partials[kMaxBlocks][2];

// valid and unknown rows among the four bytes of o and v
__device__ __forceinline__ void count_word(uint32_t o, uint32_t v,
                                           uint32_t& valid,
                                           uint32_t& unknown) {
  const uint32_t on = __vcmpne4(o, 0u) & 0x01010101u;
  const uint32_t vn = __vcmpne4(v, 0u) & 0x01010101u;
  valid += __popc(on & ~vn);
  unknown += __popc(vn);
}

// the block's sums of two per-thread counts, in thread 0: warp sums of the
// 32-bit counts (a thread counts at most B / threads rows), added in 64
// bits; one barrier, so `scratch` is not reused
__device__ __forceinline__ void block_sums(
    uint32_t x, uint32_t y, unsigned long long (&scratch)[2][kWarps],
    unsigned long long& sx, unsigned long long& sy) {
  const uint32_t wx = __reduce_add_sync(kFull, x);
  const uint32_t wy = __reduce_add_sync(kFull, y);
  if ((threadIdx.x & 31) == 0) {
    scratch[0][threadIdx.x >> 5] = wx;
    scratch[1][threadIdx.x >> 5] = wy;
  }
  __syncthreads();
  sx = sy = 0ull;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sx += scratch[0][w];
      sy += scratch[1][w];
    }
  }
}

// the same for 64-bit values (the grid's partials, one a thread), by
// shuffles; `scratch` is another buffer than block_sums'
__device__ __forceinline__ void block_sums64(
    unsigned long long x, unsigned long long y,
    unsigned long long (&scratch)[2][kWarps], unsigned long long& sx,
    unsigned long long& sy) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    x += __shfl_down_sync(kFull, x, d);
    y += __shfl_down_sync(kFull, y, d);
  }
  if ((threadIdx.x & 31) == 0) {
    scratch[0][threadIdx.x >> 5] = x;
    scratch[1][threadIdx.x >> 5] = y;
  }
  __syncthreads();
  sx = sy = 0ull;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sx += scratch[0][w];
      sy += scratch[1][w];
    }
  }
}

__global__ void __launch_bounds__(kThreads) verdict_stats_kernel(
    const uint8_t* __restrict__ ok, const uint8_t* __restrict__ overflow,
    long long B, long long* __restrict__ counts) {
  __shared__ unsigned long long scratch[2][kWarps], scratch64[2][kWarps];
  __shared__ bool last;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint32_t valid = 0u, unknown = 0u;
  const uintptr_t po = reinterpret_cast<uintptr_t>(ok);
  const uintptr_t pv = reinterpret_cast<uintptr_t>(overflow);
  if (((po ^ pv) & 15u) == 0u) {
    long long head = static_cast<long long>((16u - (po & 15u)) & 15u);
    if (head > B) head = B;
    const long long words = (B - head) >> 4;
    const uint4* ow = reinterpret_cast<const uint4*>(ok + head);
    const uint4* vw = reinterpret_cast<const uint4*>(overflow + head);
    // kUnroll words a thread in flight before any is counted
    for (long long i = tid; i < words; i += kUnroll * stride) {
      uint4 o[kUnroll], v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long k = i + u * stride;
        o[u] = k < words ? ow[k] : make_uint4(0u, 0u, 0u, 0u);
        v[u] = k < words ? vw[k] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        count_word(o[u].x, v[u].x, valid, unknown);
        count_word(o[u].y, v[u].y, valid, unknown);
        count_word(o[u].z, v[u].z, valid, unknown);
        count_word(o[u].w, v[u].w, valid, unknown);
      }
    }
    // the < 16 bytes before the body (threads 0-15) and after it (16-31)
    const long long tail = head + (words << 4);
    long long i = -1;
    if (tid < 16 && tid < head) i = tid;
    if (tid >= 16 && tid < 32 && tail + tid - 16 < B) i = tail + tid - 16;
    if (i >= 0) count_word(ok[i], overflow[i], valid, unknown);
  } else {
    for (long long i = tid; i < B; i += stride) {
      count_word(ok[i], overflow[i], valid, unknown);
    }
  }

  unsigned long long bv, bu;
  block_sums(valid, unknown, scratch, bv, bu);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) {
      counts[0] = static_cast<long long>(bv);
      counts[1] = B - static_cast<long long>(bv + bu);
      counts[2] = static_cast<long long>(bu);
    }
    return;
  }
  if (threadIdx.x == 0) {
    g_partials[blockIdx.x][0] = bv;
    g_partials[blockIdx.x][1] = bu;
    __threadfence();  // the partials are visible before the ticket moves
    last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every block's partials are written
  const bool mine = threadIdx.x < gridDim.x;
  unsigned long long tv, tu;
  block_sums64(mine ? __ldcg(&g_partials[threadIdx.x][0]) : 0ull,
               mine ? __ldcg(&g_partials[threadIdx.x][1]) : 0ull, scratch64,
               tv, tu);
  if (threadIdx.x == 0) {
    counts[0] = static_cast<long long>(tv);
    counts[1] = B - static_cast<long long>(tv + tu);
    counts[2] = static_cast<long long>(tu);
    g_ticket = 0u;  // ready for the next launch on this stream
  }
}

// the launch floor: a kernel that does nothing, at K9's block size
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

}  // namespace

// Count the valid, invalid and unknown rows of ok/overflow ([B] uint8, i.e.
// torch.bool, contiguous, any alignment) into counts ([3] int64, written
// whole) on `stream`; returns the CUDA error of the launch (0 on success).
// B = 0 writes zeros.
extern "C" int verdict_stats_launch(const void* ok, const void* overflow,
                                    long long B, void* counts, void* stream) {
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = 1;
  if (B > kSingleMaxRows) {
    blocks = (B / 16 + kThreads - 1) / kThreads;
    if (blocks < 1) blocks = 1;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  }
  verdict_stats_kernel<<<static_cast<int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ok), static_cast<const uint8_t*>(overflow),
      B, static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel on `stream`: the floor that timing compares
// a launch-bound kernel with.
extern "C" int verdict_stats_empty_launch(void* stream) {
  empty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
