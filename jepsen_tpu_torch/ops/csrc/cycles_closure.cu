// Bit-packed boolean closure for the Elle screens on Hopper.
//
// Replaces, in the JAX package:
//   - jepsen_tpu/ops/cycles.py:251 _bool_closure, jitted as :362
//     _closure_fn / :376 _cyclic_fn (has-cycle: any diagonal of the
//     closure), and :884 _reach_fn (the closure itself)  -> K6,
//     cycles_has_cycle_launch;
//   - jepsen_tpu/ops/cycles.py:400 _screen_fn_variant, its packed
//     lowering (:426-495): per filter mask the SCC membership of the
//     filtered graph, per (want, rest) query the nonadjacent walks of the
//     2n x 2n lifted graph  -> K7, cycles_screen_launch;
//   - jepsen_tpu/ops/cycles.py:181 _pack_words / :204 _unpack_words  ->
//     K8, fused: the prologue packs relation bytes into uint32 word rows
//     (lane j at word j / 32, bit j % 32) with warp ballots, and the
//     epilogue reads bits out of the closed rows.
//
// Design.  One thread block closes one plane (a graph under one filter
// mask, or one lifted graph) kept in shared memory as rows of W words:
// n = 512 is 32 KB, the lifted 1024-row plane 128 KB (past the default
// 48 KB, so the launch raises the block's dynamic shared-memory limit).
// A round is r <- r | r.r in the boolean semiring: row i gains row k for
// every set bit k of row i.  Each round reads only the previous round's
// rows (Jacobi), as the reference squares the whole stack at once, so
// the per-plane count of rounds until a fixpoint is the reference's.
// Two copies of a 128 KB plane do not fit, so a group of W lanes owns a
// row (lane w holds word w: conflict-free shared loads for W = 32) and
// keeps its rows' new words in registers until a block barrier; the
// barrier's OR tells whether the round changed the plane.  A plane stops
// at its fixpoint in both modes (later rounds are the identity); its
// first unchanged round goes into a per-family atomicMax, and a last
// launch writes the dispatch-wide count the reference reports: the
// ladder length in "fixed" mode, min(ladder, max over planes) in
// "earlyexit", summed over the filter and lifted families.
//
// Bound.  Integer operations: one OR per set bit per live word per
// round that changes a plane (the plain version's work= count), against
// 32-bit issue on the CUDA cores; the relation bytes are read once per
// plane.  Rows of dense closures hold hundreds of set bits, so the
// kernel is bound by operations, not bytes.  No tensor cores: a
// thresholded bf16 product would square the same planes, but this
// slice keeps the one bit-packed arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_PLANE = 1024;
constexpr int MAX_F = 8;
constexpr int MAX_Q = 4;
constexpr unsigned FULL = 0xffffffffu;

// A screen's filter profile, passed by value as a kernel argument.
struct Profile {
  int F, Q;
  unsigned char masks[MAX_F];
  unsigned char want[MAX_Q];
  unsigned char rest[MAX_Q];
};

// Rows a lane group keeps in registers: rows * W / 1024 with the block at
// its widest (W = 32: 32 rows; W = 16: 8; W = 8: 2; else 1).
template <int W>
struct Rows {
  static constexpr int PER_GROUP = W * W / 32 > 1 ? W * W / 32 : 1;
};

int closure_rounds(int n) {
  int m = n < 2 ? 2 : n, r = 0;
  while ((1 << r) < m) ++r;
  return r < 1 ? 1 : r;
}

int block_threads(int rows, int W) {
  int t = rows * W;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

// K8 prologue: row i, word u of a plane over an n x n byte matrix:
// bit l = (rel[i][32u + l] & mask) != 0 for lanes inside n.  One warp
// per word, so each warp reads 32 consecutive bytes.
__device__ void load_filter(uint32_t* P, const uint8_t* rel, int n, int W,
                            unsigned mask) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int idx = threadIdx.x >> 5; idx < n * W; idx += nw) {
    const int i = idx / W, j = (idx - i * W) * 32 + lane;
    const bool bit = j < n && (rel[(size_t)i * n + j] & mask);
    const unsigned word = __ballot_sync(FULL, bit);
    if (lane == 0) P[idx] = word;
  }
}

// The lifted plane [[rest, want], [rest, 0]] over (vertex, last edge was
// want), 2n rows of W2 = 2n / 32 words; n is a multiple of 32, so each
// word lies wholly in one half.
__device__ void load_lifted(uint32_t* P, const uint8_t* rel, int n, int W2,
                            unsigned want, unsigned rest) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int idx = threadIdx.x >> 5; idx < 2 * n * W2; idx += nw) {
    const int r = idx / W2, col = (idx - r * W2) * 32 + lane;
    const uint8_t* src = rel + (size_t)(r < n ? r : r - n) * n;
    bool bit;
    if (col < n) bit = src[col] & rest;
    else bit = r < n && (src[col - n] & want);
    const unsigned word = __ballot_sync(FULL, bit);
    if (lane == 0) P[idx] = word;
  }
}

// K6: close a plane of `rows` rows x W words in place; returns (the same
// in every thread) the first round that changed nothing, or R if every
// round changed it.
template <int W>
__device__ int close_plane(uint32_t* P, int rows, int R) {
  constexpr int PER = Rows<W>::PER_GROUP;
  const int groups = blockDim.x / W;
  const int g = threadIdx.x / W, w = threadIdx.x % W;
  for (int round = 1; round <= R; ++round) {
    uint32_t fresh[PER];
    bool changed = false;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = g + r * groups;
      const uint32_t x = i < rows ? P[i * W + w] : 0u;
      uint32_t acc = x;
#pragma unroll 1
      for (int u = 0; u < W; ++u) {
        uint32_t word = __shfl_sync(FULL, x, u, W);
        while (word) {
          const int k = u * 32 + __ffs(word) - 1;
          word &= word - 1;
          acc |= P[k * W + w];
        }
      }
      fresh[r] = acc;
      changed |= acc != x;
    }
    __syncthreads();  // every read of this round is done
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = g + r * groups;
      if (i < rows) P[i * W + w] = fresh[r];
    }
    if (!__syncthreads_or(changed)) return round;
  }
  return R;
}

__device__ bool bit_of(const uint32_t* P, int W, int row, int col) {
  return (P[row * W + (col >> 5)] >> (col & 31)) & 1u;
}

template <int W>
__global__ void __launch_bounds__(1024)
has_cycle_kernel(const uint8_t* adj, uint8_t* flags, uint8_t* closure,
                 int n, int R, int* round_max) {
  extern __shared__ uint32_t P[];
  const uint8_t* a = adj + (size_t)blockIdx.x * n * n;
  load_filter(P, a, n, W, 0xffu);
  __syncthreads();
  const int first = close_plane<W>(P, n, R);
  bool diag = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) diag |= bit_of(P, W, i, i);
  diag = __syncthreads_or(diag);
  if (threadIdx.x == 0) {
    flags[blockIdx.x] = diag;
    atomicMax(round_max, first);
  }
  if (closure != nullptr) {
    uint8_t* out = closure + (size_t)blockIdx.x * n * n;
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
      out[idx] = bit_of(P, W, idx / n, idx % n);
  }
}

// members[b, f, v] = c[v, v] of the closure of rel[b] & masks[f]: the
// closure is transitive, so "some j with c[v, j] and c[j, v]" is exactly
// its diagonal.
template <int W>
__global__ void __launch_bounds__(1024)
screen_filter_kernel(const uint8_t* rel, uint8_t* members, Profile prof,
                     int n, int R, int* round_max) {
  extern __shared__ uint32_t P[];
  const int b = blockIdx.x / prof.F, f = blockIdx.x % prof.F;
  load_filter(P, rel + (size_t)b * n * n, n, W, prof.masks[f]);
  __syncthreads();
  const int first = close_plane<W>(P, n, R);
  uint8_t* out = members + (size_t)blockIdx.x * n;
  for (int v = threadIdx.x; v < n; v += blockDim.x) out[v] = bit_of(P, W, v, v);
  if (threadIdx.x == 0) atomicMax(round_max, first);
}

// walks[b, q, v] = exists j: (rel[b][v][j] & want) and c[n + j, v], from
// the lifted closure's (state 1 -> state 0) quadrant; a warp per vertex.
template <int W2>
__global__ void __launch_bounds__(1024)
screen_lifted_kernel(const uint8_t* rel, uint8_t* walks, Profile prof, int n,
                     int R2, int* round_max) {
  extern __shared__ uint32_t P[];
  const int b = blockIdx.x / prof.Q, q = blockIdx.x % prof.Q;
  const uint8_t* a = rel + (size_t)b * n * n;
  const unsigned want = prof.want[q];
  load_lifted(P, a, n, W2, want, prof.rest[q]);
  __syncthreads();
  const int first = close_plane<W2>(P, 2 * n, R2);
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  uint8_t* out = walks + (size_t)blockIdx.x * n;
  for (int v = threadIdx.x >> 5; v < n; v += nw) {
    bool hit = false;
    for (int j = lane; j < n; j += 32)
      hit |= (a[(size_t)v * n + j] & want) && bit_of(P, W2, n + j, v);
    hit = __any_sync(FULL, hit);
    if (lane == 0) out[v] = hit;
  }
  if (threadIdx.x == 0) atomicMax(round_max, first);
}

// rounds[b]: each family's ladder length ("fixed") or its dispatch-wide
// first unchanged round, clamped to the ladder ("earlyexit"), summed.
__global__ void rounds_kernel(int32_t* rounds, int B, const int* round_max,
                              int R0, int R1, int early) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int total = 0;
  if (R0 > 0) total += early ? min(R0, max(1, round_max[0])) : R0;
  if (R1 > 0) total += early ? min(R1, max(1, round_max[1])) : R1;
  rounds[b] = total;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int W>
cudaError_t launch_has_cycle(const uint8_t* adj, uint8_t* flags,
                             uint8_t* closure, int B, int n, int R,
                             int* round_max, cudaStream_t s) {
  const size_t smem = (size_t)n * W * sizeof(uint32_t);
  cudaError_t err = allow_smem(has_cycle_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  has_cycle_kernel<W><<<B, block_threads(n, W), smem, s>>>(
      adj, flags, closure, n, R, round_max);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_filter(const uint8_t* rel, uint8_t* members,
                          const Profile& prof, int B, int n, int R,
                          int* round_max, cudaStream_t s) {
  const size_t smem = (size_t)n * W * sizeof(uint32_t);
  cudaError_t err = allow_smem(screen_filter_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  screen_filter_kernel<W><<<B * prof.F, block_threads(n, W), smem, s>>>(
      rel, members, prof, n, R, round_max);
  return cudaGetLastError();
}

template <int W2>
cudaError_t launch_lifted(const uint8_t* rel, uint8_t* walks,
                          const Profile& prof, int B, int n, int R2,
                          int* round_max, cudaStream_t s) {
  const size_t smem = (size_t)2 * n * W2 * sizeof(uint32_t);
  cudaError_t err = allow_smem(screen_lifted_kernel<W2>, smem);
  if (err != cudaSuccess) return err;
  screen_lifted_kernel<W2><<<B * prof.Q, block_threads(2 * n, W2), smem,
                             s>>>(rel, walks, prof, n, R2, round_max);
  return cudaGetLastError();
}

bool power_of_two_in(int n, int lo, int hi) {
  return n >= lo && n <= hi && (n & (n - 1)) == 0;
}

// The W template for a plane of `rows` rows (a power of two <= 1024).
#define DISPATCH_W(rows, CALL)                 \
  switch ((rows) <= 32 ? 1 : (rows) / 32) {    \
    case 1: err = CALL(1); break;              \
    case 2: err = CALL(2); break;              \
    case 4: err = CALL(4); break;              \
    case 8: err = CALL(8); break;              \
    case 16: err = CALL(16); break;            \
    case 32: err = CALL(32); break;            \
    default: err = cudaErrorInvalidValue;      \
  }

}  // namespace

extern "C" {

// adj [B, n, n] uint8 (0/1 or relation bytes; any nonzero is an edge),
// n a power of two in [16, 1024]; flags [B] bool, rounds [B] int32,
// closure [B, n, n] bool or null; scratch: 2 int32 of device memory.
// Returns the first CUDA error, 0 if none.
int cycles_has_cycle_launch(const uint8_t* adj, uint8_t* flags,
                            int32_t* rounds, uint8_t* closure,
                            int32_t* scratch, int B, int n, int early,
                            void* stream) {
  if (B <= 0) return 0;
  if (!power_of_two_in(n, 16, MAX_PLANE)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  const int R = closure_rounds(n);
#define HAS_CYCLE(Wt) \
  launch_has_cycle<Wt>(adj, flags, closure, B, n, R, scratch, s)
  DISPATCH_W(n, HAS_CYCLE)
#undef HAS_CYCLE
  if (err != cudaSuccess) return err;
  rounds_kernel<<<(B + 255) / 256, 256, 0, s>>>(rounds, B, scratch, R, 0,
                                                 early);
  return cudaGetLastError();
}

// rel [B, n, n] uint8 relation bits, n a power of two in [32, 512];
// masks[F] (F <= 8), wants[Q] and rests[Q] (Q <= 4) in host memory;
// members [B, F, n] bool, walks [B, Q, n] bool, rounds [B] int32;
// scratch: 2 int32 of device memory.  Returns the first CUDA error.
int cycles_screen_launch(const uint8_t* rel, uint8_t* members,
                         uint8_t* walks, int32_t* rounds, int32_t* scratch,
                         int B, int n, int F, const uint8_t* masks, int Q,
                         const uint8_t* wants, const uint8_t* rests,
                         int early, void* stream) {
  if (B <= 0) return 0;
  if (!power_of_two_in(n, 32, MAX_PLANE / 2) || F < 0 || F > MAX_F ||
      Q < 0 || Q > MAX_Q)
    return cudaErrorInvalidValue;
  Profile prof = {};
  prof.F = F;
  prof.Q = Q;
  for (int f = 0; f < F; ++f) prof.masks[f] = masks[f];
  for (int q = 0; q < Q; ++q) {
    prof.want[q] = wants[q];
    prof.rest[q] = rests[q];
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  const int R = F ? closure_rounds(n) : 0;
  const int R2 = Q ? closure_rounds(2 * n) : 0;
  if (F) {
#define FILTER(Wt) launch_filter<Wt>(rel, members, prof, B, n, R, scratch, s)
    DISPATCH_W(n, FILTER)
#undef FILTER
    if (err != cudaSuccess) return err;
  }
  if (Q) {
#define LIFTED(Wt) \
  launch_lifted<Wt>(rel, walks, prof, B, n, R2, scratch + 1, s)
    DISPATCH_W(2 * n, LIFTED)
#undef LIFTED
    if (err != cudaSuccess) return err;
  }
  rounds_kernel<<<(B + 255) / 256, 256, 0, s>>>(rounds, B, scratch, R, R2,
                                                 early);
  return cudaGetLastError();
}

}  // extern "C"
