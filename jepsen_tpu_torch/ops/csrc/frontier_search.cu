// Generic frontier search for linearizability, by hand for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/wgl.py:build_batched (K4) with the branchless step
// functions of jepsen_tpu/ops/step_kernels.py (K3) and the exact dedup and
// compaction of wgl.py:_compact_allpairs/_rank_gather (K5): the jitted
// vmap-of-scan the JAX package runs on the TPU for every shape outside the
// dense automaton's envelope.  Same function, same outputs: per history, ok
// (no completion emptied the frontier), failed_at (the event that emptied
// it, else -1) and overflow (some closure found more than F distinct
// configs, or was cut at max_closure while still growing).
//
// A config is (int32 state, W = ceil(C/32) linset words).  One thread block
// owns one history for the whole scan.  Per non-padding event:
//   1. closure pass, repeated while the last pass grew the frontier, nothing
//      overflowed and fewer than max_closure passes ran:
//      a. expand: lanes 0..n-1 are the n frontier configs, lane
//         n + f*C + c is config f after linearizing candidate lane c (valid
//         iff the lane is open, f has not linearized its slot and the step
//         accepts).  The reference keeps holes in its F-lane frontier and
//         numbers new lanes F + f*C + c; a compacted frontier keeps the
//         same relative lane order, which is all the outputs depend on;
//      b. dedup: an open-addressing table keyed by the whole config.  A
//         lane claims an empty slot with atomicCAS, or atomicMin's its lane
//         into the slot of an equal config; a lane survives iff its slot
//         ends holding its own lane — the lowest lane of its class,
//         whatever the thread timing;
//      c. compact: survivors in lane order into the next frontier (block
//         prefix sum), the first F kept; overflow iff more than F; grew iff
//         a lane >= n survived.
//   2. completion of slot es: keep the configs holding its bit, clear the
//      bit (another prefix sum); none left fails the row at this event.
// Every loop decision is block-uniform (shared totals, __syncthreads_or).
//
// What bounds it on this card: integer work and latency, not device memory.
// A history's inputs are 4 + 6C bytes per event, read once; the search then
// runs a chain of dependent passes per event, each touching F*(C+1) lanes of
// a per-row workspace in global memory (candidate states and words, their
// table slots, the dedup table, two frontier buffers), laid out by
// frontier_search_workspace_bytes and allocated by the wrapper.  The design
// keeps it simple and right first: many independent blocks (one per
// history, up to 256 threads) hide one block's barriers behind the others'
// work; the workspace stays in L2 for the frontier sizes of the base pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 127;  // cand_slot is int8
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

// op codes (jepsen_tpu_torch/ops/step_kernels.py)
constexpr int F_READ = 0;
constexpr int F_WRITE = 1;
constexpr int F_CAS = 2;
constexpr int F_READ_ANY = 3;
constexpr int F_ACQUIRE = 4;
constexpr int F_RELEASE = 5;
constexpr int F_ENQUEUE = 6;
constexpr int F_DEQUEUE = 7;
constexpr int F_RACQUIRE = 8;
constexpr int F_RRELEASE = 9;

// step ids (step_kernels.STEP_IDS)
constexpr int kStepRegister = 0;
constexpr int kStepCasRegister = 1;
constexpr int kStepMutex = 2;
constexpr int kStepReentrantMutex = 3;
constexpr int kStepMultiRegister = 4;
constexpr int kStepUnorderedQueue = 5;

struct Layout {
  int W, K, T;
  long long elems;
};

__host__ __device__ inline int table_size(int K) {
  int t = 1;
  while (t < 2 * K) t <<= 1;
  return t;
}

__host__ __device__ inline Layout layout(int F, int C) {
  Layout l;
  l.W = (C + 31) / 32;
  l.K = F * (C + 1);
  l.T = table_size(l.K);
  l.elems = static_cast<long long>(l.K) * (2 + l.W) + l.T +
            2LL * F * (1 + l.W);
  return l;
}

// The six branchless steps, with XLA's integer semantics: a (int16) is
// sign-extended; the reentrant mutex's 2a-1 and 2a wrap in int16; shifts
// by an amount outside [0, 31] give 0.
template <int STEP>
__device__ __forceinline__ bool step(int32_t s, int f, int a, int b,
                                     int32_t* out) {
  if (STEP == kStepRegister) {
    const bool is_write = f == F_WRITE;
    *out = is_write ? a : s;
    return is_write || f == F_READ_ANY || (f == F_READ && s == a);
  } else if (STEP == kStepCasRegister) {
    const bool is_write = f == F_WRITE;
    const bool cas_ok = f == F_CAS && s == a;
    *out = is_write ? a : (cas_ok ? b : s);
    return is_write || f == F_READ_ANY || (f == F_READ && s == a) || cas_ok;
  } else if (STEP == kStepMutex) {
    const bool acq = f == F_ACQUIRE;
    const bool rel = f == F_RELEASE;
    *out = acq ? 1 : (rel ? 0 : s);
    return (acq && s == 0) || (rel && s == 1);
  } else if (STEP == kStepReentrantMutex) {
    const bool acq = f == F_RACQUIRE;
    const bool rel = f == F_RRELEASE;
    const int once = static_cast<int16_t>(2 * a - 1);
    const int twice = static_cast<int16_t>(2 * a);
    const bool acq_fresh = acq && s == 0;
    const bool acq_re = acq && s == once;
    const bool rel_two = rel && s == twice;
    const bool rel_one = rel && s == once;
    *out = acq_fresh ? once
                     : (acq_re ? twice : (rel_two ? once : (rel_one ? 0 : s)));
    return acq_fresh || acq_re || rel_two || rel_one;
  } else if (STEP == kStepMultiRegister) {
    const int sh = (b & 3) * 8;
    const uint32_t mask = 0xFFu << sh;
    const int cur = (s >> sh) & 0xFF;
    const bool is_write = f == F_WRITE;
    const uint32_t written = (static_cast<uint32_t>(s) & ~mask) |
                             ((static_cast<uint32_t>(a) & 0xFFu) << sh);
    *out = is_write ? static_cast<int32_t>(written) : s;
    return is_write || f == F_READ_ANY || (f == F_READ && cur == a);
  } else {  // kStepUnorderedQueue
    const int sh = a - 1;
    const int32_t bit =
        (sh >= 0 && sh < 32) ? static_cast<int32_t>(1u << sh) : 0;
    const bool present = (s & bit) != 0;
    const bool enq = f == F_ENQUEUE;
    const bool deq = f == F_DEQUEUE;
    *out = enq ? (s | bit) : (deq ? (s & ~bit) : s);
    return (enq && !present) || (deq && present);
  }
}

__device__ __forceinline__ uint32_t hash_config(int32_t s, const uint32_t* w,
                                                int W) {
  uint32_t h = static_cast<uint32_t>(s) * 0x9E3779B9u;
  h ^= h >> 16;
  for (int i = 0; i < W; ++i) {
    h += w[i] * 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
  }
  return h;
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total gets the block's sum.  Every thread must call it; the caller puts
// a barrier between its reads of the result and the next call.
__device__ int block_exclusive_scan(int v, int* total, int* s_warp,
                                    int* s_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < nwarps) s_warp[lane] = w;
    if (lane == nwarps - 1) *s_total = w;
  }
  __syncthreads();
  *total = *s_total;
  return (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
}

template <int STEP>
__global__ void __launch_bounds__(kMaxThreads) frontier_search_kernel(
    const int32_t* __restrict__ init_state, const int32_t* __restrict__ ev_slot,
    const int8_t* __restrict__ cand_slot, const int8_t* __restrict__ cand_f,
    const int16_t* __restrict__ cand_a, const int16_t* __restrict__ cand_b,
    uint8_t* __restrict__ ok, int32_t* __restrict__ failed_at,
    uint8_t* __restrict__ overflow, uint8_t* __restrict__ workspace,
    long long ws_stride, int E, int C, int F, int max_closure) {
  __shared__ int s_slot[kMaxC];
  __shared__ int s_f[kMaxC];
  __shared__ int s_a[kMaxC];
  __shared__ int s_b[kMaxC];
  __shared__ int s_warp[kMaxWarps];
  __shared__ int s_total;

  const Layout l = layout(F, C);
  const int W = l.W;
  const int T = l.T;
  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;

  int32_t* cand_state = reinterpret_cast<int32_t*>(workspace + row * ws_stride);
  uint32_t* cand_words = reinterpret_cast<uint32_t*>(cand_state + l.K);
  int32_t* lane_slot = reinterpret_cast<int32_t*>(cand_words + l.K * W);
  int32_t* table = lane_slot + l.K;
  int32_t* const fstate0 = table + T;
  int32_t* const fstate1 = fstate0 + F;
  uint32_t* const fwords0 = reinterpret_cast<uint32_t*>(fstate1 + F);
  uint32_t* const fwords1 = fwords0 + F * W;

  // one config: the initial state, empty linset
  int cur = 0;
  int n = 1;
  if (t == 0) fstate0[0] = init_state[row];
  for (int w = t; w < W; w += nt) fwords0[w] = 0u;
  __syncthreads();

  const long long ev_base = static_cast<long long>(row) * E;
  bool done = false;
  int failed = -1;
  bool ovf_any = false;
  for (int e = 0; e < E && !done; ++e) {
    const int es = ev_slot[ev_base + e];  // block-uniform
    if (es < 0) continue;                 // padding: the carry is kept

    const long long lane_base = (ev_base + e) * C;
    for (int c = t; c < C; c += nt) {
      s_slot[c] = cand_slot[lane_base + c];
      s_f[c] = cand_f[lane_base + c];
      s_a[c] = cand_a[lane_base + c];
      s_b[c] = cand_b[lane_base + c];
    }
    __syncthreads();

    // ---- closure ----
    bool changed = true;
    bool ovf = false;
    int it = 0;
    while (changed && !ovf && it < max_closure) {
      const int Kp = n * (C + 1);
      const int Ti = table_size(Kp);  // load factor <= 1/2 for this pass
      const uint32_t tmask = static_cast<uint32_t>(Ti - 1);
      const int32_t* st0 = cur ? fstate1 : fstate0;
      const uint32_t* ws0 = cur ? fwords1 : fwords0;
      int32_t* st1 = cur ? fstate0 : fstate1;
      uint32_t* ws1 = cur ? fwords0 : fwords1;
      for (int i = t; i < Ti; i += nt) table[i] = -1;
      for (int L = t; L < Kp; L += nt) {
        uint32_t* out_w = cand_words + static_cast<long long>(L) * W;
        if (L < n) {
          cand_state[L] = st0[L];
          for (int w = 0; w < W; ++w) out_w[w] = ws0[L * W + w];
          lane_slot[L] = 0;
        } else {
          const int q = L - n;
          const int f = q / C;
          const int c = q - f * C;
          const int slot = s_slot[c];
          const bool active = slot >= 0;
          const int wix = active ? slot >> 5 : 0;
          const uint32_t bit = active ? 1u << (slot & 31) : 0u;
          const uint32_t* in_w = ws0 + f * W;
          const bool already = (in_w[wix] & bit) != 0u;
          int32_t s2;
          const bool accepted = step<STEP>(st0[f], s_f[c], s_a[c], s_b[c], &s2);
          cand_state[L] = s2;
          for (int w = 0; w < W; ++w) out_w[w] = in_w[w] | (w == wix ? bit : 0u);
          lane_slot[L] = (active && !already && accepted) ? 0 : -1;
        }
      }
      __syncthreads();

      // dedup: the lowest lane of each class of equal configs owns its slot
      for (int L = t; L < Kp; L += nt) {
        if (lane_slot[L] < 0) continue;
        const int32_t s = cand_state[L];
        const uint32_t* wl = cand_words + static_cast<long long>(L) * W;
        uint32_t h = hash_config(s, wl, W) & tmask;
        while (true) {
          const int prev = atomicCAS(&table[h], -1, L);
          if (prev == -1) break;
          bool same = cand_state[prev] == s;
          const uint32_t* wp = cand_words + static_cast<long long>(prev) * W;
          for (int w = 0; w < W && same; ++w) same = wp[w] == wl[w];
          if (same) {
            atomicMin(&table[h], L);
            break;
          }
          h = (h + 1) & tmask;
        }
        lane_slot[L] = static_cast<int32_t>(h);
      }
      __syncthreads();

      // compact survivors in lane order: each thread a contiguous range
      const int per = (Kp + nt - 1) / nt;
      const int lo = min(t * per, Kp);
      const int hi = min(lo + per, Kp);
      int cnt = 0;
      int grew = 0;
      for (int L = lo; L < hi; ++L) {
        const int sl = lane_slot[L];
        if (sl >= 0 && table[sl] == L) {
          ++cnt;
          grew |= L >= n;
        }
      }
      int total;
      int p = block_exclusive_scan(cnt, &total, s_warp, &s_total);
      for (int L = lo; L < hi && p < F; ++L) {
        const int sl = lane_slot[L];
        if (sl >= 0 && table[sl] == L) {
          st1[p] = cand_state[L];
          for (int w = 0; w < W; ++w)
            ws1[p * W + w] = cand_words[static_cast<long long>(L) * W + w];
          ++p;
        }
      }
      changed = __syncthreads_or(grew) != 0;
      cur ^= 1;
      n = min(total, F);
      ovf = total > F;
      ++it;
    }
    // stopping at the cap while still growing is a truncated closure
    ovf_any |= ovf || (changed && it >= max_closure);

    // ---- completion of slot es: keep configs that linearized it ----
    {
      const int wix = es >> 5;
      const uint32_t bit = 1u << (es & 31);
      const int per = (n + nt - 1) / nt;
      const int lo = min(t * per, n);
      const int hi = min(lo + per, n);
      const int32_t* st0 = cur ? fstate1 : fstate0;
      const uint32_t* ws0 = cur ? fwords1 : fwords0;
      int32_t* st1 = cur ? fstate0 : fstate1;
      uint32_t* ws1 = cur ? fwords0 : fwords1;
      int cnt = 0;
      for (int j = lo; j < hi; ++j) cnt += (ws0[j * W + wix] & bit) != 0u;
      int total;
      int p = block_exclusive_scan(cnt, &total, s_warp, &s_total);
      for (int j = lo; j < hi; ++j) {
        if ((ws0[j * W + wix] & bit) == 0u) continue;
        st1[p] = st0[j];
        for (int w = 0; w < W; ++w)
          ws1[p * W + w] = ws0[j * W + w] & (w == wix ? ~bit : ~0u);
        ++p;
      }
      __syncthreads();
      cur ^= 1;
      n = total;
      if (n == 0) {
        done = true;
        failed = e;
      }
    }
  }

  if (t == 0) {
    ok[row] = done ? 0 : 1;
    failed_at[row] = failed;
    overflow[row] = ovf_any ? 1 : 0;
  }
}

template <int STEP>
cudaError_t launch(int B, int threads, cudaStream_t stream,
                   const void* init_state, const void* ev_slot,
                   const void* cand_slot, const void* cand_f,
                   const void* cand_a, const void* cand_b, void* ok,
                   void* failed_at, void* overflow, void* workspace,
                   long long ws_stride, int E, int C, int F,
                   int max_closure) {
  frontier_search_kernel<STEP><<<B, threads, 0, stream>>>(
      static_cast<const int32_t*>(init_state),
      static_cast<const int32_t*>(ev_slot),
      static_cast<const int8_t*>(cand_slot),
      static_cast<const int8_t*>(cand_f),
      static_cast<const int16_t*>(cand_a),
      static_cast<const int16_t*>(cand_b), static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(failed_at), static_cast<uint8_t*>(overflow),
      static_cast<uint8_t*>(workspace), ws_stride, E, C, F, max_closure);
  return cudaGetLastError();
}

}  // namespace

// Per-row workspace bytes at capacity F over C slots (the layout above,
// rounded up to 16 bytes); the wrapper allocates B times this.
extern "C" long long frontier_search_workspace_bytes(int F, int C) {
  const Layout l = layout(F, C);
  return (4 * l.elems + 15) / 16 * 16;
}

// Launch over B histories on `stream`; returns cudaGetLastError() after the
// launch (0 on success).  Shapes: init_state [B] int32, ev_slot [B, E] int32,
// cand_slot/cand_f [B, E, C] int8, cand_a/cand_b [B, E, C] int16, all
// contiguous, slot ids in [-1, C); ok/overflow [B] uint8 (torch.bool),
// failed_at [B] int32; workspace B * frontier_search_workspace_bytes(F, C)
// bytes, 16-byte aligned.  step is one of the kStep* ids.
extern "C" int frontier_search_launch(
    const void* init_state, const void* ev_slot, const void* cand_slot,
    const void* cand_f, const void* cand_a, const void* cand_b, void* ok,
    void* failed_at, void* overflow, void* workspace, int B, int E, int C,
    int F, int max_closure, int step_id, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || E < 0 || C < 1 || C > kMaxC || F < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ws_stride = frontier_search_workspace_bytes(F, C);
  const long long K = static_cast<long long>(F) * (C + 1);
  if (K > (1LL << 28)) return static_cast<int>(cudaErrorInvalidValue);
  int threads = static_cast<int>(((K + 31) / 32) * 32);
  if (threads > kMaxThreads) threads = kMaxThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (step_id) {
#define JT_LAUNCH(ID)                                                        \
  case ID:                                                                   \
    err = launch<ID>(B, threads, s, init_state, ev_slot, cand_slot, cand_f,  \
                     cand_a, cand_b, ok, failed_at, overflow, workspace,     \
                     ws_stride, E, C, F, max_closure);                       \
    break;
    JT_LAUNCH(kStepRegister)
    JT_LAUNCH(kStepCasRegister)
    JT_LAUNCH(kStepMutex)
    JT_LAUNCH(kStepReentrantMutex)
    JT_LAUNCH(kStepMultiRegister)
    JT_LAUNCH(kStepUnorderedQueue)
#undef JT_LAUNCH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
