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
// A config is (int32 state, W = ceil(C/32) linset words).  Per non-padding
// event the reference runs closure passes while the last pass grew the
// frontier, nothing overflowed and fewer than max_closure passes ran
// (stopping at the cap while still growing is a truncated closure, which
// counts as overflow): each pass lays out the frontier's configs as lanes
// 0..n-1 and config f after linearizing candidate lane c as a later lane,
// in (f, c) order (valid iff the lane is open, f has not linearized its
// slot and the step accepts), keeps the lowest lane of every class of equal
// configs, and compacts the survivors in lane order back to F (more than F
// is overflow; a surviving candidate lane is growth).  Then the completion
// of slot es keeps the configs holding its bit, with the bit cleared; none
// left fails the row at this event.
//
// Semi-naive order, exact.  The frontier's configs are distinct and come
// first, so they always survive, in order, and a pass only appends.  While
// no pass has overflowed, every valid child of a config that an earlier
// pass expanded is already in the frontier, at a lower lane, so it never
// survives; and an overflowing pass ends the closure.  So expanding only
// the configs the last pass appended (the event's starting configs on its
// first pass), deduping each candidate against everything already in the
// frontier, gives the same survivors in the same order and the same number
// of passes.  tests/test_torch_frontier.py pins it on the plain version
// (work["stale_survivors"] == 0: no survivor ever has a parent an earlier
// pass expanded).
//
// What bounds it on this card.  Not device memory: a history's inputs are
// 4 + 6C bytes per event, read once.  Not operations either: the slice
// (40-value cas-register, C 8, F 128) averages ~12 configs a frontier and
// ~16 valid candidates a pass.  Each event is a chain of dependent steps
// (expand, probe, dedup, append, complete), and the kernel ends when its
// slowest history does: on the slice one history in a thousand does ~5x
// the median's closure work, and after the others finish it runs alone on
// its SM, so the kernel time is that history's chain of steps times their
// latency (scripts/frontier_diag.py times each step with clock64 laps).
// The parent kernel gave each history a block sized for F*(C+1) lanes, ran
// 5+ block barriers per pass, re-expanded the whole frontier every pass and
// kept its workspace in global memory (L2 round trips and L2 atomics, the
// table cleared every pass).
//
// Warp design (frontier_design(F, C) == "warp": C <= kWarpMaxC and
// F*(1+W) + T <= kWarpMaxWords).  One warp owns one history for the whole
// scan; a block holds kWarpsPerBlock warps and no block barrier is ever
// run.  In the warp's own slice of shared memory: the frontier as an
// append-only list of F configs; an open-addressing table of T >= 4F slots
// (load <= 1/4: at load 1/2 the slice ran slower) whose entries hold the event's epoch, a 10-bit tag of the config's hash
// and its frontier index, so a probe that meets another config's entry
// costs one load, and the table is cleared by a new epoch, not by stores;
// the event's open candidate lanes, packed; and a ring of staged
// candidates.  A pass builds its (parent, open lane) pairs 64 at a time,
// two a lane, and stages the valid ones, in order, in the ring (the build
// needs no table, so most of its work is off the chain); each 32 staged
// candidates are then deduped at once: probe the table,
// __match_any_sync on the whole config keeps the lowest lane of equal
// fresh candidates, and the survivors are appended in lane order by
// ballot and __popc and entered in the table (atomicCAS on shared memory)
// before the next 32; the (F+1)-th survivor ends the pass as overflow.
// The completion is a stable in-place filter by ballot that also enters
// each kept config in the next event's table, so the next event's first
// pass needs no separate insert.  The next non-padding event (found by a
// ballot over a window of 32 ev_slot entries) has its candidate lanes
// loaded into registers while the current event closes.  Two histories a
// warp (16 lanes each), a 64-candidate dedup by claims in the table
// (atomicMin on the batch order, no __match_any_sync) and 4-slot buckets
// read with one 128-bit load were all slower on the slice (PERF.md).
//
// Block design (every other shape: the sufficient rung past F 1024, large
// explicit capacities, C > 64).  One block per history, up to 256 threads,
// the parent kernel made semi-naive: each pass lays out the frontier as
// lanes 0..n-1 and only the last pass's configs' candidates after them; the
// workspace (candidate lanes, the per-pass dedup table, two frontier
// buffers) lives in global memory, laid out by frontier_search_workspace_
// bytes (0 for warp-design shapes) and allocated by the wrapper.
//
// The switch is a build-time constant, FRONTIER_WARP_MAX_WORDS (0 sends
// every shape to the block design); wgl.frontier_design mirrors it and a
// CPU test pins the two.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef FRONTIER_WARP_MAX_WORDS
#define FRONTIER_WARP_MAX_WORDS 8192
#endif

namespace {

constexpr int kMaxC = 127;  // cand_slot is int8
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;

// warp design
constexpr int kWarpMaxWords = FRONTIER_WARP_MAX_WORDS;
constexpr int kWarpMaxC = 64;  // W <= 2
constexpr int kWarpsPerBlock = 4;
constexpr int kPrefetch = (kWarpMaxC + 31) / 32;  // candidate lanes a lane loads
constexpr int kRing = 128;  // staged candidates: < 32 left + 64 built
constexpr unsigned kFull = 0xFFFFFFFFu;
// a table entry: epoch:10 | hash tag:10 | frontier index:12
constexpr int kIdxBits = 12;
constexpr int kTagBits = 10;
constexpr uint32_t kEpochs = 1u << (32 - kTagBits - kIdxBits);
static_assert(kWarpMaxWords / 6 < (1 << kIdxBits),
              "frontier indices must fit the table entry");

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

// The warp design's dedup table: a power of two >= 4F and >= 8 slots
// (load <= 1/4).
__host__ __device__ inline int warp_table_size(int F) {
  return table_size(F < 2 ? 4 : 2 * F);
}

// Per-row workspace bytes of the block design (the layout above, rounded
// up to 16 bytes).
inline long long block_workspace_bytes(int F, int C) {
  return (4 * layout(F, C).elems + 15) / 16 * 16;
}

// Shared-memory words of one history in the warp design: F configs of
// 1 + W words, the dedup table, the event's C candidate lanes (2 words),
// the ring of staged candidates (2 + W words).
__host__ __device__ inline int warp_words(int F, int C) {
  const int W = (C + 31) / 32;
  return F * (1 + W) + warp_table_size(F) + 2 * C + kRing * (2 + W);
}

inline bool use_warp_design(int F, int C) {
  const long long W = (C + 31) / 32;
  return C <= kWarpMaxC && F <= kWarpMaxWords &&
         F * (1 + W) + warp_table_size(F) <= kWarpMaxWords;
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

// ---------------------------------------------------------------------------
// warp design
// ---------------------------------------------------------------------------

// A table entry: the event's epoch, a tag of the config's hash (its top
// bits; the slot comes from the low bits) and the config's frontier index.
__device__ __forceinline__ uint32_t table_entry(uint32_t epoch, uint32_t h,
                                               int idx) {
  return (epoch << (kTagBits + kIdxBits)) | ((h >> (32 - kTagBits)) << kIdxBits) |
         static_cast<uint32_t>(idx);
}

// One warp per history; see the note at the top.
template <int STEP, int W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) frontier_warp_kernel(
    const int32_t* __restrict__ init_state, const int32_t* __restrict__ ev_slot,
    const int8_t* __restrict__ cand_slot, const int8_t* __restrict__ cand_f,
    const int16_t* __restrict__ cand_a, const int16_t* __restrict__ cand_b,
    uint8_t* __restrict__ ok, int32_t* __restrict__ failed_at,
    uint8_t* __restrict__ overflow, int B, int E, int C, int F,
    int max_closure) {
  extern __shared__ uint32_t smem[];
  constexpr int kStage = 2 + W;  // a staged candidate: hash, state, words

  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  const int T = warp_table_size(F);
  const uint32_t tmask = static_cast<uint32_t>(T - 1);

  uint32_t* const slice = smem + static_cast<long long>(warp) * warp_words(F, C);
  int32_t* const fs = reinterpret_cast<int32_t*>(slice);  // [F] states
  uint32_t* const fw = slice + F;                         // [F][W] words
  uint32_t* const table = fw + F * W;                     // [T] entries
  uint32_t* const cnd = table + T;                        // [C][2] lanes
  uint32_t* const ring = cnd + 2 * C;                     // [kRing][kStage]

  // Enter a config known to be absent, and distinct from every other
  // config entered at the same time, in the table of `ep`.
  auto insert = [&](uint32_t h, int idx, uint32_t ep) {
    const uint32_t mine = table_entry(ep, h, idx);
    uint32_t pos = h & tmask;
    while (true) {
      const uint32_t cur = *reinterpret_cast<volatile uint32_t*>(&table[pos]);
      if ((cur >> (kTagBits + kIdxBits)) != ep) {
        if (atomicCAS(&table[pos], cur, mine) == cur) return;
        continue;  // taken meanwhile: look at the slot again
      }
      pos = (pos + 1u) & tmask;
    }
  };

  bool active = row < B;  // has events left to check
  const long long ev_base = static_cast<long long>(active ? row : 0) * E;
  for (int i = lane; i < T; i += 32) table[i] = 0u;
  __syncwarp();
  // one config: the initial state, empty linset, in the table of epoch 1
  uint32_t epoch = 1;
  int n = 1;
  if (active && lane == 0) {
    uint32_t w0[W];
    for (int w = 0; w < W; ++w) fw[w] = w0[w] = 0u;
    fs[0] = init_state[row];
    insert(hash_config(fs[0], w0, W), 0, epoch);
  }
  bool done = false;
  int failed = -1;
  bool ovf_any = false;

  // The next non-padding event (nx_e, E if none) and its slot nx_es, found
  // in a window of 32 ev_slot entries, lane l holding entry win_base + l.
  int win_base = -32;
  int win_val = -1;
  unsigned win_mask = 0u;
  int nx_e = E;
  int nx_es = -1;
  auto find_next = [&](int from) {
    unsigned bits;
    while (true) {
      const int k = from - win_base;  // <= 32; < 0 after a window move
      bits = k < 32 ? win_mask & (kFull << (k > 0 ? k : 0)) : 0u;
      if (bits != 0u || win_base + 32 >= E) break;
      win_base += 32;
      const int e = win_base + lane;
      win_val = e < E ? ev_slot[ev_base + e] : -1;
      win_mask = __ballot_sync(kFull, win_val >= 0);
    }
    const int src = bits ? __ffs(bits) - 1 : 0;
    nx_es = __shfl_sync(kFull, win_val, src);
    nx_e = bits ? win_base + src : E;
  };

  // The candidate lanes of event e, packed (slot | f << 8, a | b << 16),
  // lane l holding lanes l and l + 32: loads left in flight.
  uint32_t pf0[kPrefetch], pf1[kPrefetch];
  auto prefetch = [&](int e) {
    const long long lb = (ev_base + (e < E ? e : 0)) * C;
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int c = lane + i * 32;
      pf0[i] = 0xFFu;  // slot -1: not open
      pf1[i] = 0u;
      if (e < E && c < C) {
        pf0[i] = static_cast<uint8_t>(cand_slot[lb + c]) |
                 (static_cast<uint32_t>(static_cast<uint8_t>(cand_f[lb + c]))
                  << 8);
        pf1[i] = static_cast<uint16_t>(cand_a[lb + c]) |
                 (static_cast<uint32_t>(static_cast<uint16_t>(cand_b[lb + c]))
                  << 16);
      }
    }
  };

  // Candidate (p, k): frontier config p after linearizing open lane k.
  auto make = [&](int p, int k, int32_t* s2, uint32_t* cw) -> bool {
    const uint32_t c0 = cnd[2 * k];
    const uint32_t c1 = cnd[2 * k + 1];
    const int slot = static_cast<int>(c0 & 0xFFu);
    const uint32_t bit = 1u << (slot & 31);
    bool already = false;
    for (int w = 0; w < W; ++w) {
      cw[w] = fw[p * W + w];
      if (w == (slot >> 5)) {
        already = (cw[w] & bit) != 0u;
        cw[w] |= bit;
      }
    }
    return step<STEP>(fs[p], static_cast<int8_t>(c0 >> 8),
                      static_cast<int16_t>(c1 & 0xFFFFu),
                      static_cast<int16_t>(c1 >> 16), s2) &&
           !already;
  };

  if (active) {
    find_next(0);
    prefetch(nx_e);
  }
  while (active && nx_e < E) {
    const int e = nx_e;
    const int es = nx_es;

    // ---- this event's open candidate lanes into shared memory ----
    int nc = 0;
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const bool open = (pf0[i] & 0x80u) == 0u;  // slot >= 0
      const unsigned m = __ballot_sync(kFull, open);
      if (open) {
        const int r = nc + __popc(m & below);
        cnd[2 * r] = pf0[i];
        cnd[2 * r + 1] = pf1[i];
      }
      nc += __popc(m);
    }
    // ...and the next event's inputs start loading
    find_next(e + 1);
    prefetch(nx_e);
    __syncwarp();

    // ---- closure, semi-naive: each pass expands [lo, hi) ----
    // Candidates are built 64 (parent, open lane) pairs at a time; the
    // valid ones are staged in order in the ring, and each 32 of them are
    // deduped against the table and among themselves, then appended.
    int lo = 0, hi = n, it = 0;
    bool changed = true, ovf = false;
    int d0 = 0, m0 = 0, dp = 0, dk = 0;  // pair q = (q / nc, q % nc) stepping
    if (nc > 0) {
      d0 = lane / nc;
      m0 = lane - d0 * nc;
      dp = 32 / nc;
      dk = 32 - dp * nc;
    }
    auto advance = [&](int* p, int* k) {
      *k += dk;
      *p += dp;
      if (*k >= nc) {
        *k -= nc;
        ++*p;
      }
    };
    int head = 0, staged = 0;  // the ring's first staged candidate, count
    auto dedup = [&](int m) {
      const uint32_t* st = ring + ((head + lane) & (kRing - 1)) * kStage;
      const bool valid = lane < m;
      const uint32_t h = valid ? st[0] : 0u;
      const int32_t s2 = valid ? static_cast<int32_t>(st[1]) : 0;
      uint32_t cw[W];
      for (int w = 0; w < W; ++w) cw[w] = valid ? st[2 + w] : 0u;
      // already in the frontier?  (a tag mismatch costs one load)
      bool fresh = valid;
      if (valid) {
        const uint32_t key = table_entry(epoch, h, 0) >> kIdxBits;
        uint32_t pos = h & tmask;
        while (true) {
          const uint32_t ent = table[pos];
          if ((ent >> kIdxBits) == key) {
            const int j = static_cast<int>(ent & ((1u << kIdxBits) - 1u));
            bool same = fs[j] == s2;
            for (int w = 0; w < W; ++w) same = same && fw[j * W + w] == cw[w];
            if (same) {
              fresh = false;
              break;
            }
          } else if ((ent >> (kTagBits + kIdxBits)) != epoch) {
            break;
          }
          pos = (pos + 1u) & tmask;
        }
      }
      // the lowest lane of equal fresh candidates survives
      const unsigned fresh_raw = __ballot_sync(kFull, fresh);
      unsigned eq = 0u;
      if (__popc(fresh_raw) > 1) {
        eq = __match_any_sync(
            kFull, fresh ? (static_cast<unsigned long long>(
                                static_cast<uint32_t>(s2)) << 32) | cw[0]
                         : ~0ull);
        if (W == 2) eq &= __match_any_sync(kFull, cw[W - 1]);
      }
      const bool surv = fresh && (eq & fresh_raw & below) == 0u;
      const unsigned sb = __ballot_sync(kFull, surv);
      const int r = n + __popc(sb & below);
      const int tot = __popc(sb);
      if (surv && r < F) {
        fs[r] = s2;
        for (int w = 0; w < W; ++w) fw[r * W + w] = cw[w];
        insert(h, r, epoch);
      }
      if (n + tot > F) ovf = true;  // the (F+1)-th survivor ends the pass
      n = n + tot < F ? n + tot : F;
      head += m;
      staged -= m;
      __syncwarp();
    };
    while (changed && !ovf && it < max_closure) {
      const int start = n;
      const int npairs = (hi - lo) * nc;
      int p = lo + d0, k = m0;
      for (int q0 = 0; q0 < npairs && !ovf; q0 += 64) {
        int pb = p, kb = k;
        advance(&pb, &kb);
        int32_t sa = 0, sb2 = 0;
        uint32_t wa[W], wb[W];
        const bool va = q0 + lane < npairs && make(p, k, &sa, wa);
        const bool vb = q0 + 32 + lane < npairs && make(pb, kb, &sb2, wb);
        const unsigned ba = __ballot_sync(kFull, va);
        const unsigned bb = __ballot_sync(kFull, vb);
        if (va) {
          uint32_t* d = ring + ((head + staged + __popc(ba & below)) &
                                (kRing - 1)) * kStage;
          d[0] = hash_config(sa, wa, W);
          d[1] = static_cast<uint32_t>(sa);
          for (int w = 0; w < W; ++w) d[2 + w] = wa[w];
        }
        if (vb) {
          uint32_t* d = ring + ((head + staged + __popc(ba) +
                                 __popc(bb & below)) & (kRing - 1)) * kStage;
          d[0] = hash_config(sb2, wb, W);
          d[1] = static_cast<uint32_t>(sb2);
          for (int w = 0; w < W; ++w) d[2 + w] = wb[w];
        }
        staged += __popc(ba) + __popc(bb);
        __syncwarp();
        while (staged >= 32 && !ovf) dedup(32);
        p = pb;
        k = kb;
        advance(&p, &k);
      }
      if (staged > 0 && !ovf) dedup(staged);
      head = staged = 0;
      changed = ovf || n > start;
      lo = hi;
      hi = n;
      ++it;
    }
    // stopping at the cap while still growing is a truncated closure
    ovf_any |= ovf || (changed && it >= max_closure);

    // ---- completion of slot es: a stable in-place filter, each kept
    // config entered in the next event's table ----
    uint32_t next = epoch + 1;
    if (next == kEpochs) {  // every 1023 events: clear once
      for (int i = lane; i < T; i += 32) table[i] = 0u;
      next = 1;
      __syncwarp();
    }
    const int wix = es >> 5;
    const uint32_t ebit = 1u << (es & 31);
    int kept = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      int32_t s = 0;
      uint32_t w[W];
      bool has = false;
      if (j < n) {
        s = fs[j];
        for (int k = 0; k < W; ++k) {
          w[k] = fw[j * W + k];
          if (k == wix) {
            has = (w[k] & ebit) != 0u;
            w[k] &= ~ebit;
          }
        }
      }
      const unsigned m = __ballot_sync(kFull, has);
      __syncwarp();  // every read of the chunk before any write
      if (has) {
        const int r = kept + __popc(m & below);
        fs[r] = s;
        for (int k = 0; k < W; ++k) fw[r * W + k] = w[k];
        insert(hash_config(s, w, W), r, next);
      }
      kept += __popc(m);
    }
    epoch = next;
    n = kept;
    if (n == 0) {
      done = true;
      failed = e;
      active = false;
    }
    __syncwarp();
  }

  if (row < B && lane == 0) {
    ok[row] = done ? 0 : 1;
    failed_at[row] = failed;
    overflow[row] = ovf_any ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// block design
// ---------------------------------------------------------------------------

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

    // ---- closure: lanes 0..n-1 the frontier, then the candidates of the
    // configs [lo, hi) the last pass appended (all of them on the first) ----
    bool changed = true;
    bool ovf = false;
    int it = 0;
    int lo = 0, hi = n;
    while (changed && !ovf && it < max_closure) {
      const int Kp = n + (hi - lo) * C;
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
          const int fq = q / C;
          const int c = q - fq * C;
          const int f = lo + fq;
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
      const int lo_l = min(t * per, Kp);
      const int hi_l = min(lo_l + per, Kp);
      int cnt = 0;
      int grew = 0;
      for (int L = lo_l; L < hi_l; ++L) {
        const int sl = lane_slot[L];
        if (sl >= 0 && table[sl] == L) {
          ++cnt;
          grew |= L >= n;
        }
      }
      int total;
      int p = block_exclusive_scan(cnt, &total, s_warp, &s_total);
      for (int L = lo_l; L < hi_l && p < F; ++L) {
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
      // the frontier survives first, in order: the rest was appended
      lo = n;
      n = min(total, F);
      hi = n;
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
      const int lo_l = min(t * per, n);
      const int hi_l = min(lo_l + per, n);
      const int32_t* st0 = cur ? fstate1 : fstate0;
      const uint32_t* ws0 = cur ? fwords1 : fwords0;
      int32_t* st1 = cur ? fstate0 : fstate1;
      uint32_t* ws1 = cur ? fwords0 : fwords1;
      int cnt = 0;
      for (int j = lo_l; j < hi_l; ++j) cnt += (ws0[j * W + wix] & bit) != 0u;
      int total;
      int p = block_exclusive_scan(cnt, &total, s_warp, &s_total);
      for (int j = lo_l; j < hi_l; ++j) {
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

struct Args {
  const int32_t* init_state;
  const int32_t* ev_slot;
  const int8_t* cand_slot;
  const int8_t* cand_f;
  const int16_t* cand_a;
  const int16_t* cand_b;
  uint8_t* ok;
  int32_t* failed_at;
  uint8_t* overflow;
  uint8_t* workspace;
  int B, E, C, F, max_closure;
};

template <int STEP, int W>
cudaError_t launch_warp_w(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * kWarpsPerBlock *
                      static_cast<size_t>(warp_words(a.F, a.C));
  auto kernel = frontier_warp_kernel<STEP, W>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (a.B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      a.init_state, a.ev_slot, a.cand_slot, a.cand_f, a.cand_a, a.cand_b,
      a.ok, a.failed_at, a.overflow, a.B, a.E, a.C, a.F, a.max_closure);
  return cudaGetLastError();
}

template <int STEP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (use_warp_design(a.F, a.C)) {
    return a.C <= 32 ? launch_warp_w<STEP, 1>(a, stream)
                     : launch_warp_w<STEP, 2>(a, stream);
  }
  const long long K = static_cast<long long>(a.F) * (a.C + 1);
  int threads = static_cast<int>(((K + 31) / 32) * 32);
  if (threads > kMaxThreads) threads = kMaxThreads;
  frontier_search_kernel<STEP><<<a.B, threads, 0, stream>>>(
      a.init_state, a.ev_slot, a.cand_slot, a.cand_f, a.cand_a, a.cand_b,
      a.ok, a.failed_at, a.overflow, a.workspace,
      block_workspace_bytes(a.F, a.C), a.E, a.C, a.F, a.max_closure);
  return cudaGetLastError();
}

}  // namespace

// Per-row workspace bytes at capacity F over C slots (0 for a warp-design
// shape, which keeps everything in shared memory); the wrapper allocates B
// times this.
extern "C" long long frontier_search_workspace_bytes(int F, int C) {
  return use_warp_design(F, C) ? 0 : block_workspace_bytes(F, C);
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
  const long long K = static_cast<long long>(F) * (C + 1);
  if (K > (1LL << 28)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const int32_t*>(init_state),
               static_cast<const int32_t*>(ev_slot),
               static_cast<const int8_t*>(cand_slot),
               static_cast<const int8_t*>(cand_f),
               static_cast<const int16_t*>(cand_a),
               static_cast<const int16_t*>(cand_b),
               static_cast<uint8_t*>(ok),
               static_cast<int32_t*>(failed_at),
               static_cast<uint8_t*>(overflow),
               static_cast<uint8_t*>(workspace),
               B, E, C, F, max_closure};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (step_id) {
#define JT_LAUNCH(ID)          \
  case ID:                     \
    err = launch<ID>(a, s);    \
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
