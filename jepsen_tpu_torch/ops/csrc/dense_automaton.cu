// Dense subset automata for linearizability, by hand for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/dense.py:build_dense, the jitted vmap-of-scan that
// the JAX package runs on the TPU, in all four of its transition families,
// and, in a kernel of its own at the end of this file,
// dense.py:build_dense_queue (the unordered queue, K2):
//   kFamilyRegister  register / cas-register / read-any, mutex acquire and
//                    release as cas(0 -> 1) / cas(1 -> 0), owner-mutex ops
//                    as the cas codes its encoder emits      (dense.py:534-546)
//   kFamilyReentrant reentrant mutex over {0, 2c-1, 2c}        (dense.py:516-533)
//   kFamilyPermits   semaphore permits, table-driven from the inverse of
//                    dense.py:permits_tables' acq/rel maps   (dense.py:506-515)
//   kFamilyMulti     multi-register, composite S = Vr^K states, digit k of s
//                    is register k's value id              (dense.py:471-493)
// Same function, same outputs: per history, ok (no completion ever emptied
// the automaton), failed_at (index of the event that emptied it, else -1)
// and overflow (always 0 -- the dense automaton cannot overflow).
//
// State: D[s][k], S states x W = max(1, 2^C / 32) packed uint32 words; bit
// i of word k says "some order of the open ops in subset 32k + i takes the
// model to state s".  Per non-padding event:
//   1. regroup the C candidate lanes by slot (their codes summed, as the
//      reference sums them) into each open slot's move, a partial function
//      of the source state;
//   2. closure: for each slot j and each state s that j moves to s',
//      D[s'][k | bit j] |= D[s][k] over the subsets k without j, until a
//      pass changes nothing;
//   3. completion of slot e: D'[s][k] = D[s][k | bit e] over the subsets k
//      without e (a masked shift for e < 5, a word move for e >= 5); an
//      all-zero D' fails the history at this event.
//
// Why the closure may run in any order.  Step 2 computes the least D that
// holds the event's start and is closed under the slots' moves (the moves
// are monotone ORs).  The reference gets it by Jacobi passes, each reading
// the pass's start, capped at C + 2; a pass adds the configs one more
// linearized op away, no config holds more than C open ops, so at most C
// passes change D and the cap never binds (tests/test_torch_dense.py pins
// it on the plain version).  Any order of the same monotone updates that
// ends on a pass changing nothing reaches that same least fixpoint, and
// does so in no more passes than Jacobi's; so both designs below update D
// in place, slot after slot (Gauss-Seidel), keep the C + 2 cap, and give
// byte-equal ok/failed_at.
//
// What bounds it on this card.  Not device memory: a history's inputs are
// 4 + 6C bytes per event, read once.  The work is a serial chain over a
// history's events of 32-bit integer operations on on-chip state, so the
// limit is instruction issue and the chain's latency.  A block per
// history that probes every (word, slot) pair each pass and re-reads every
// candidate lane per (slot, target) item spends ~1000 instructions per
// warp per event on probes that find no source; the two designs below
// touch only the moves an event has:
//
// Warp design (register family, S*W <= kWarpMaxSW).  A warp checks 32/G
// histories at once, G = min(W, 32) lanes each; lane k of a history holds
// subset-word column k (and k + 32, k + 64, k + 96 when W > 32) for every
// state, in the warp's own slice of shared memory that only that lane
// touches.  A register-family slot has one target row: write (every state
// -> a, fed by the running OR of the column over states, kept up to date as
// words change), cas (a -> b), read (a -> a) and read-any (every state onto
// itself), so a pass costs each lane a few branch-free instructions per
// open slot: load the source word, apply the slot's subset map (in-word
// mask and shift for j < 5, __shfl_xor_sync from lane k ^ 2^(j-5) while
// that lane is in the group, the lane's own other word beyond), OR into
// the target word.  A pass is followed by another only if it changed a row
// that an earlier slot reads, so no pass merely confirms the fixpoint.
// There is no block barrier: the pass vote is __any_sync, the completion's
// emptiness a __ballot_sync over the group, and a history whose closure
// settled runs no-op passes until its warp's has.  The regroup is
// lane-parallel (lane l holds candidate lane l and sums by __shfl_sync,
// then broadcasts each slot's move) and the next event's slot ids and
// candidate lanes are loaded into registers while this one runs.  What
// bounds it: each pass is a chain of dependent shared-memory loads,
// shuffles and stores per slot, over ~2.4 passes an event at the flagship;
// on the card, a pass that loads every slot's source before any store
// (more independent work, Jacobi order) ran slower, as did more words a
// lane (more histories a warp, fewer warps an SM).
//
// Block design (every other family, and register shapes past the switch).
// One block per history, D (at most 128 x 128 words, 64 KB) in shared
// memory, updated in place (half the parent's footprint, so twice the
// blocks fit an SM).  Per event, warp 0 regroups the lanes by shuffles and
// every thread lists, per target row, its live (slot, source) pairs as
// 16-bit entries: one source state (each permit, reentrant and register
// cas/read move is one-to-one), "every state" (a register write) or "the
// Vr states differing in register r" (a multi-register write), built from
// the permit tables staged in shared memory once per block.  A pass visits
// only live entries; one __syncthreads_or vote per pass and one for the
// completion, plus two per event for the regroup and the lists.
//
// What bounds it: the block-wide barriers and the passes over every
// (target, word) item, serial over the events.
//
// The switch: the register family takes the warp design while S*W <=
// kWarpMaxSW words, which covers every register-family shape the planner
// gives (V <= 32, C <= 12: S*W <= 4096).  scripts/dense_ab.py --switch
// times both designs on the flagship (S*W = 64), owner-mutex at C = 12
// (1536) and the C = 12, V = 32 edge (4096): the warp design won at all
// three, so no register shape the planner gives runs the block design;
// the block side is reached through the wrapper at S > 32, C = 12 (a
// chip_smoke.py edge row).  Padding events are skipped
// and a history stops at its first failed event: both exact, because the
// reference keeps D on a padding event and never changes failed_at once a
// history is done.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 12;
constexpr int kMaxS = 128;
constexpr int kMaxRegisters = 4;  // step_kernels.MR_REGISTERS
constexpr int kValueBits = 8;     // step_kernels.MR_VALUE_BITS
constexpr unsigned kFull = 0xFFFFFFFFu;

constexpr int kFamilyRegister = 0;
constexpr int kFamilyReentrant = 1;
constexpr int kFamilyPermits = 2;
constexpr int kFamilyMulti = 3;

// op codes (jepsen_tpu_torch/ops/step_kernels.py)
constexpr int F_WRITE = 1;
constexpr int F_CAS = 2;
constexpr int F_READ_ANY = 3;
constexpr int F_ACQUIRE = 4;
constexpr int F_RELEASE = 5;
constexpr int F_ENQUEUE = 6;
constexpr int F_DEQUEUE = 7;
constexpr int F_RACQUIRE = 8;
constexpr int F_PACQUIRE = 10;

// the warp/block switch of the register family (S * W words); a build may
// define it to time one design against the other at the same shape
#ifndef DENSE_WARP_MAX_SW
#define DENSE_WARP_MAX_SW 4096
#endif
constexpr int kWarpMaxSW = DENSE_WARP_MAX_SW;
constexpr int kWarpsPerBlock = 4;   // warp design: warps per block
constexpr int kBlockThreads = 256;  // block design: most threads per block

// per-launch constants of the transition families
struct Params {
  int S;           // states
  int mr_vr;       // multi-register: per-register domain
  int mr_k;        // multi-register: registers
  int mr_pow[kMaxRegisters];  // Vr^k
  const int32_t* pm_acq;      // permits: [n_clients + 1][S] source state
  const int32_t* pm_rel;      // acquiring / releasing moves to s, -1: none
  int pm_clients;
};

// bits of a 32-subset word whose subset index has bit j clear (j < 5)
__device__ __forceinline__ uint32_t lo_mask(int j) {
  switch (j) {
    case 0: return 0x55555555u;
    case 1: return 0x33333333u;
    case 2: return 0x0F0F0F0Fu;
    case 3: return 0x00FF00FFu;
    default: return 0x0000FFFFu;
  }
}

// the initial state id: a multi-register init packs one byte per register;
// the id is placed as the reference's dynamic_update_index_in_dim places
// it (a negative id counts from the end, then it is clamped into [0, S))
template <int Family>
__device__ __forceinline__ int initial_state(int s0, const Params& p) {
  if (Family == kFamilyMulti) {
    int id = 0;
#pragma unroll
    for (int k = 0; k < kMaxRegisters; ++k) {
      if (k < p.mr_k) {
        id += ((s0 >> (kValueBits * k)) & ((1 << kValueBits) - 1)) *
              p.mr_pow[k];
      }
    }
    s0 = id;
  }
  if (s0 < 0) s0 += p.S;
  return s0 < 0 ? 0 : (s0 >= p.S ? p.S - 1 : s0);
}

// candidate lane packing: (slot, f) and (a, b) in one int each
__device__ __forceinline__ int pack_slot_f(int slot, int f) {
  return (slot & 0xFF) | (f << 8);
}
__device__ __forceinline__ int pack_ab(int a, int b) {
  return (a & 0xFFFF) | (b << 16);
}
__device__ __forceinline__ int lane_slot(int q) {
  return static_cast<int8_t>(q & 0xFF);
}
__device__ __forceinline__ int lane_a(int q) {
  return static_cast<int16_t>(q & 0xFFFF);
}

// ---------------------------------------------------------------------------
// The warp design (register family).
//
// A register-family slot's move, one word per (history, slot): kind in bits
// 0-1, source state in bits 2-9, target state in bits 10-17.
constexpr uint32_t kMoveNone = 0;
constexpr uint32_t kMoveOne = 1;   // source -> target
constexpr uint32_t kMoveAll = 2;   // every state -> target (a write)
constexpr uint32_t kMoveSelf = 3;  // every state onto itself (a read-any)

__device__ __forceinline__ uint32_t pack_move(uint32_t kind, int src, int tgt) {
  return kind | static_cast<uint32_t>(src) << 2 |
         static_cast<uint32_t>(tgt) << 10;
}

// the move of one slot from its summed codes (the reference's nested
// selects: codes the family never emits act as a read)
__device__ __forceinline__ uint32_t register_move(bool active, int f, int a,
                                                  int b, int S) {
  if (!active) return kMoveNone;
  const bool acq = f == F_ACQUIRE;
  const bool rel = f == F_RELEASE;
  const int a_eff = acq ? 0 : (rel ? 1 : a);
  const int b_eff = acq ? 1 : (rel ? 0 : b);
  const bool a_in = a_eff >= 0 && a_eff < S;
  if (f == F_WRITE) return a_in ? pack_move(kMoveAll, 0, a_eff) : kMoveNone;
  if (f == F_READ_ANY) return kMoveSelf;
  if (f == F_CAS || acq || rel) {
    return a_in && b_eff >= 0 && b_eff < S ? pack_move(kMoveOne, a_eff, b_eff)
                                           : kMoveNone;
  }
  return a_in ? pack_move(kMoveOne, a_eff, a_eff) : kMoveNone;
}

// a history of the warp designs takes at most 2^kLogMaxGroup lanes: the
// whole warp (dense.queue_design mirrors the queue automaton's shapes)
constexpr int kLogMaxGroup = 5;

template <int LOG_W>
struct WarpShape {
  static constexpr int W = 1 << LOG_W;
  static constexpr int LOG_G = LOG_W < kLogMaxGroup ? LOG_W : kLogMaxGroup;
  static constexpr int G = 1 << LOG_G;  // lanes per history
  static constexpr int M = W / G;       // words per lane
  static constexpr int H = 32 / G;      // histories per warp
  // the most slots this word count takes (C <= 5 share W = 1)
  static constexpr int MAX_C = LOG_W == 0 ? 5 : LOG_W + 5;
  // at least as many lanes as slots: lane l regroups candidate lane l
  static constexpr bool LANE_REGROUP = G >= MAX_C;
  static constexpr int LANES_HELD = LANE_REGROUP ? 1 : MAX_C;
};

// one event of one history as a lane holds it
template <int LOG_W>
struct Event {
  int es;
  int sf[WarpShape<LOG_W>::LANES_HELD];  // pack_slot_f of candidate lanes
  int ab[WarpShape<LOG_W>::LANES_HELD];  // pack_ab
};

template <int LOG_W>
__device__ __forceinline__ Event<LOG_W> load_event(
    const int32_t* __restrict__ ev_slot, const int8_t* __restrict__ cand_slot,
    const int8_t* __restrict__ cand_f, const int16_t* __restrict__ cand_a,
    const int16_t* __restrict__ cand_b, bool live_row, int64_t ev_base,
    int e, int C, int gl) {
  using Sh = WarpShape<LOG_W>;
  Event<LOG_W> ev;
  ev.es = live_row ? ev_slot[ev_base + e] : -1;
  const int64_t base = (ev_base + e) * C;
#pragma unroll
  for (int r = 0; r < Sh::LANES_HELD; ++r) {
    const int l = Sh::LANE_REGROUP ? gl : r;
    ev.sf[r] = pack_slot_f(-1, 0);
    ev.ab[r] = 0;
    if (live_row && l < C) {
      ev.sf[r] = pack_slot_f(cand_slot[base + l], cand_f[base + l]);
      ev.ab[r] = pack_ab(cand_a[base + l], cand_b[base + l]);
    }
  }
  return ev;
}

// every slot's move for this lane's history (none when it is inactive)
template <int LOG_W>
__device__ __forceinline__ void regroup(const Event<LOG_W>& ev, bool active,
                                        int C, int S, int lane, int gl,
                                        uint32_t (&mv)[kMaxC]) {
  using Sh = WarpShape<LOG_W>;
  if constexpr (Sh::LANE_REGROUP) {
    // lane gl sums the candidate lanes holding slot gl, then every lane of
    // the group reads each slot's move from the lane that built it
    const int gbase = lane & ~(Sh::G - 1);
    int act = 0, fs = 0, as = 0, bs = 0;
    for (int l = 0; l < C; ++l) {
      const int sf = __shfl_sync(kFull, ev.sf[0], gbase + l);
      const int ab = __shfl_sync(kFull, ev.ab[0], gbase + l);
      if (lane_slot(sf) == gl) {
        act = 1;
        fs += sf >> 8;
        as += lane_a(ab);
        bs += ab >> 16;
      }
    }
    const uint32_t mine =
        active && gl < C ? register_move(act, fs, as, bs, S) : kMoveNone;
#pragma unroll
    for (int j = 0; j < Sh::MAX_C; ++j) {
      mv[j] = kMoveNone;
      if (j < C) mv[j] = __shfl_sync(kFull, mine, gbase + j);
    }
  } else {
    // fewer lanes than slots (C <= 7): each lane regroups its history
#pragma unroll
    for (int j = 0; j < Sh::MAX_C; ++j) {
      mv[j] = kMoveNone;
      if (j < C && active) {
        int act = 0, fs = 0, as = 0, bs = 0;
#pragma unroll
        for (int l = 0; l < Sh::MAX_C; ++l) {
          if (l < C && lane_slot(ev.sf[l]) == j) {
            act = 1;
            fs += ev.sf[l] >> 8;
            as += lane_a(ev.ab[l]);
            bs += ev.ab[l] >> 16;
          }
        }
        mv[j] = register_move(act, fs, as, bs, S);
      }
    }
  }
}

// t := slot J's subset map applied to x, word by word: the image of
// subset k is k | bit J, so word k of the image takes word k of x masked
// and shifted (J < 5), or word k ^ 2^(J-5) when k holds bit J-5 (J >= 5):
// from the group's lane gl ^ 2^(J-5), or from this lane's own word m ^ .
template <int LOG_W, int J>
__device__ __forceinline__ void slot_image(
    const uint32_t (&x)[WarpShape<LOG_W>::M],
    uint32_t (&t)[WarpShape<LOG_W>::M], int gl) {
  using Sh = WarpShape<LOG_W>;
#pragma unroll
  for (int m = 0; m < Sh::M; ++m) {
    if constexpr (J < 5) {
      t[m] = (x[m] & lo_mask(J)) << (1 << J);
    } else if constexpr (J - 5 < Sh::LOG_G) {
      constexpr int wb = 1 << (J - 5);
      const uint32_t y = __shfl_xor_sync(kFull, x[m], wb);
      t[m] = (gl & wb) ? y : 0u;
    } else {
      constexpr int wm = 1 << (J - 5 - Sh::LOG_G);
      if constexpr (wm < Sh::M) {
        t[m] = (m & wm) ? x[m ^ wm] : 0u;
      } else {
        t[m] = 0u;
      }
    }
  }
}

// D[row][.] |= t, keeping the column OR up to date; whether a word grew.
// Branch-free: a t of zero rewrites the row unchanged (only this lane
// touches its column).
template <int M>
__device__ __forceinline__ bool or_into(uint32_t* row, const uint32_t (&t)[M],
                                        uint32_t (&col)[M]) {
  uint32_t grew = 0u;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const uint32_t old = row[m * 32];
    row[m * 32] = old | t[m];
    col[m] |= t[m];
    grew |= t[m] & ~old;
  }
  return grew != 0u;
}

// the rows slot move `mv` reads, as a mask over row ids mod 32 (so a
// row past 31 may stand for another: the test below can only err towards
// one more pass)
__device__ __forceinline__ uint32_t rows_read(uint32_t mv) {
  const uint32_t kind = mv & 3u;
  if (kind == kMoveOne) return 1u << ((mv >> 2) & 31u);
  return kind == kMoveNone ? 0u : 0xFFFFFFFFu;
}

// one closure pass over slots J .. MAX_C - 1, in place.  `live` and `self`
// are warp-uniform slot masks: some history of the warp moves on slot j /
// reads-any on slot j; before[j] holds the rows that slots < j read.  A
// pass needs a successor only if it changed a row that an earlier slot
// reads (`again`): every other change was already seen by the slots that
// read it, and a slot's own change never feeds itself (its image holds
// only subsets with its bit, its sources only subsets without).  Dl is
// this lane's column of the warp's D: D[s][m-th word] at Dl[(s*M + m)*32].
template <int LOG_W, int J>
__device__ __forceinline__ void warp_pass(uint32_t* Dl,
                                          const uint32_t (&mv)[kMaxC],
                                          const uint32_t (&before)[kMaxC],
                                          uint32_t (&col)[WarpShape<LOG_W>::M],
                                          uint32_t live, uint32_t self, int S,
                                          int gl, bool& again) {
  if constexpr (J < WarpShape<LOG_W>::MAX_C) {
    constexpr int M = WarpShape<LOG_W>::M;
    if (live >> J & 1) {
      const uint32_t mvj = mv[J];
      const uint32_t kind = mvj & 3u;
      if (self >> J & 1) {  // read-any: every state onto itself
        const bool mine = kind == kMoveSelf;
        for (int s = 0; s < S; ++s) {
          uint32_t x[M], t[M];
#pragma unroll
          for (int m = 0; m < M; ++m) x[m] = mine ? Dl[(s * M + m) * 32] : 0u;
          slot_image<LOG_W, J>(x, t, gl);
          const bool grew = or_into<M>(Dl + s * M * 32, t, col);
          again |= grew && (before[J] >> (s & 31) & 1);
        }
      }
      const int src = (mvj >> 2) & 0xFF;
      const int tgt = (mvj >> 10) & 0xFF;
      uint32_t x[M], t[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        x[m] = kind == kMoveOne ? Dl[(src * M + m) * 32]
                                : (kind == kMoveAll ? col[m] : 0u);
      }
      slot_image<LOG_W, J>(x, t, gl);
      // no move (or a read-any, done above): t = 0 and row tgt = 0 is
      // rewritten unchanged
      const bool grew = or_into<M>(Dl + tgt * M * 32, t, col);
      again |= grew && (before[J] >> (tgt & 31) & 1);
    }
    warp_pass<LOG_W, J + 1>(Dl, mv, before, col, live, self, S, gl, again);
  }
}

// completion of slot es, in place, for an active history (the others keep
// D): word k of the new D is (y >> sh) & lm, y this lane's word (es < 5),
// the word of lane gl | wb (from the group, es >= 5 while 2^(es-5) < G) or
// this lane's word m | wm (beyond); returns whether this lane's words of
// the new D are nonzero, and recomputes the column OR
template <int LOG_W>
__device__ __forceinline__ bool warp_complete(
    uint32_t* Dl, uint32_t (&col)[WarpShape<LOG_W>::M], bool active, int es,
    int C, int S, int lane, int gl) {
  using Sh = WarpShape<LOG_W>;
  constexpr int M = Sh::M;
  int sh = 0;
  uint32_t lm = 0xFFFFFFFFu;
  int from = lane;
  int wm = 0;  // a word of this lane (M > 1 only)
  if (active) {
    if (es >= C) {
      lm = 0u;  // no such slot: nothing linearized it
    } else if (es < 5) {
      sh = 1 << es;
      lm = lo_mask(es);
    } else if ((1 << (es - 5)) < Sh::G) {
      const int wb = 1 << (es - 5);
      from = lane ^ wb;
      lm = (gl & wb) ? 0u : 0xFFFFFFFFu;
    } else {
      wm = (1 << (es - 5)) / Sh::G;
    }
  }
  const bool shfl = __any_sync(kFull, from != lane);
  uint32_t ncol[M];
#pragma unroll
  for (int m = 0; m < M; ++m) ncol[m] = 0u;
  for (int s = 0; s < S; ++s) {
    uint32_t* row = Dl + s * M * 32;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const uint32_t v = row[m * 32];
      uint32_t y = v;
      if (shfl) y = __shfl_sync(kFull, v, from);
      if constexpr (M > 1) {
        if (wm) y = (m & wm) ? 0u : row[(m | wm) * 32];
      }
      const uint32_t nv = (y >> sh) & lm;
      row[m * 32] = nv;
      ncol[m] |= nv;
    }
  }
  bool nonzero = false;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    col[m] = ncol[m];
    nonzero |= ncol[m] != 0u;
  }
  return nonzero;
}

template <int LOG_W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) register_warp_kernel(
    const int32_t* __restrict__ init_state, const int32_t* __restrict__ ev_slot,
    const int8_t* __restrict__ cand_slot, const int8_t* __restrict__ cand_f,
    const int16_t* __restrict__ cand_a, const int16_t* __restrict__ cand_b,
    uint8_t* __restrict__ ok, int32_t* __restrict__ failed_at,
    uint8_t* __restrict__ overflow, int B, int E, int C, Params p) {
  using Sh = WarpShape<LOG_W>;
  constexpr int M = Sh::M;
  extern __shared__ uint32_t smem[];
  const int S = p.S;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane & (Sh::G - 1);
  const int row = (blockIdx.x * kWarpsPerBlock + warp) * Sh::H +
                  (lane >> Sh::LOG_G);
  const bool live_row = row < B;
  const int64_t ev_base = static_cast<int64_t>(live_row ? row : 0) * E;
  uint32_t* Dl = smem + warp * S * M * 32 + lane;

  // one config: the initial state, empty linset (word 0, bit 0)
  const int s0 =
      initial_state<kFamilyRegister>(live_row ? init_state[row] : 0, p);
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      Dl[(s * M + m) * 32] = (s == s0 && m == 0 && gl == 0) ? 1u : 0u;
    }
  }
  uint32_t col[M];
#pragma unroll
  for (int m = 0; m < M; ++m) col[m] = (m == 0 && gl == 0) ? 1u : 0u;

  bool done = !live_row;
  int failed = -1;
  Event<LOG_W> next = load_event<LOG_W>(ev_slot, cand_slot, cand_f, cand_a,
                                        cand_b, live_row && E > 0, ev_base,
                                        0, C, gl);
  for (int e = 0; e < E; ++e) {
    const Event<LOG_W> cur = next;
    if (e + 1 < E) {  // the next event's loads run under this one's work
      next = load_event<LOG_W>(ev_slot, cand_slot, cand_f, cand_a, cand_b,
                               live_row, ev_base, e + 1, C, gl);
    }
    const bool active = !done && cur.es >= 0;
    if (!__any_sync(kFull, active)) continue;

    uint32_t mv[kMaxC], before[kMaxC];
    regroup<LOG_W>(cur, active, C, S, lane, gl, mv);
    uint32_t mine_live = 0u, mine_self = 0u, read = 0u;
#pragma unroll
    for (int j = 0; j < Sh::MAX_C; ++j) {
      mine_live |= static_cast<uint32_t>((mv[j] & 3u) != kMoveNone) << j;
      mine_self |= static_cast<uint32_t>((mv[j] & 3u) == kMoveSelf) << j;
      before[j] = read;
      read |= rows_read(mv[j]);
    }
    const uint32_t live = __reduce_or_sync(kFull, mine_live);
    const uint32_t self = __reduce_or_sync(kFull, mine_self);

    // Gauss-Seidel passes, capped at C + 2 as the reference caps its
    // Jacobi passes (neither cap binds)
    for (int pass = 0; pass < C + 2; ++pass) {
      bool again = false;
      warp_pass<LOG_W, 0>(Dl, mv, before, col, live, self, S, gl, again);
      if (!__any_sync(kFull, again)) break;
    }

    const bool nonzero =
        warp_complete<LOG_W>(Dl, col, active, cur.es, C, S, lane, gl);
    const uint32_t votes = __ballot_sync(kFull, nonzero);
    const uint32_t group =
        Sh::G == 32 ? kFull
                    : ((1u << Sh::G) - 1u) << (lane & ~(Sh::G - 1));
    if (active && !(votes & group)) {
      done = true;
      failed = e;
    }
    if (__all_sync(kFull, done)) break;
  }

  if (live_row && gl == 0) {
    ok[row] = done ? 0 : 1;
    failed_at[row] = failed;
    overflow[row] = 0;
  }
}

// ---------------------------------------------------------------------------
// The block design (every family).
//
// A target row's live source, one 16-bit entry: state in bits 0-6 (the
// source, or a multi-register write's base state with the written digit
// 0), slot in bits 7-10, kind in bits 11-12, written register in 13-14.
constexpr int kSrcOne = 0;    // one source state
constexpr int kSrcAll = 1;    // every state (a register write)
constexpr int kSrcDigit = 2;  // base + v * Vr^r, v < Vr (a multi-register write)

__device__ __forceinline__ uint16_t pack_entry(int kind, int j, int s,
                                               int reg) {
  return static_cast<uint16_t>(s | j << 7 | kind << 11 | reg << 13);
}

// the live source of target sp under a slot with summed codes (f, a, b):
// the source (or base) state with *kind / *reg set, or -1.  In every family
// the move is a partial function of the source and its preimage of sp has a
// closed form; codes the family never emits fall into its catch-all branch
// exactly as the reference's nested selects do.
template <int Family>
__device__ __forceinline__ int target_source(int f, int a, int b, int sp,
                                             const Params& p, const int8_t* pm,
                                             const int* pw, int* kind,
                                             int* reg) {
  const int S = p.S;
  *kind = kSrcOne;
  *reg = 0;
  int s = -1;
  if (Family == kFamilyReentrant) {
    // acquire 0 -> 2a-1 -> 2a, release 2a -> 2a-1 -> 0
    const int once = 2 * a - 1;
    const int twice = 2 * a;
    if (f == F_RACQUIRE) {
      if (sp == once) s = 0;
      if (sp == twice) s = once;
    } else {
      if (sp == once) s = twice;
      if (sp == 0) s = once;
    }
  } else if (Family == kFamilyPermits) {
    // the staged inverse of dense.py:permits_tables (each client's acquire
    // and release maps are one-to-one)
    const int c = a < 0 ? 0 : (a > p.pm_clients ? p.pm_clients : a);
    const int table = f == F_PACQUIRE ? 0 : p.pm_clients + 1;
    s = pm[(table + c) * S + sp];
  } else if (Family == kFamilyMulti) {
    const int r = b < 0 ? 0 : (b >= p.mr_k ? p.mr_k - 1 : b);
    const int d = (sp / pw[r]) % p.mr_vr;
    if (f == F_WRITE) {  // every value of register r, if sp holds a there
      if (d != a) return -1;
      *kind = kSrcDigit;
      *reg = r;
      return sp - d * pw[r];
    }
    if (f == F_READ_ANY || d == a) s = sp;  // read-any, or a read of a
  } else {
    const bool acq = f == F_ACQUIRE;
    const bool rel = f == F_RELEASE;
    const int a_eff = acq ? 0 : (rel ? 1 : a);
    const int b_eff = acq ? 1 : (rel ? 0 : b);
    if (f == F_WRITE) {  // every state moves to a
      if (sp != a_eff) return -1;
      *kind = kSrcAll;
      return 0;
    }
    if (f == F_READ_ANY) {
      s = sp;
    } else if (f == F_CAS || acq || rel) {
      if (sp == b_eff) s = a_eff;
    } else if (sp == a_eff) {  // read (and any code the family never emits)
      s = a_eff;
    }
  }
  return s >= 0 && s < S ? s : -1;
}

template <int Family>
__global__ void __launch_bounds__(kBlockThreads) dense_block_kernel(
    const int32_t* __restrict__ init_state, const int32_t* __restrict__ ev_slot,
    const int8_t* __restrict__ cand_slot, const int8_t* __restrict__ cand_f,
    const int16_t* __restrict__ cand_a, const int16_t* __restrict__ cand_b,
    uint8_t* __restrict__ ok, int32_t* __restrict__ failed_at,
    uint8_t* __restrict__ overflow, int E, int C, Params p) {
  extern __shared__ uint32_t smem[];
  const int S = p.S;
  const int log_w = C > 5 ? C - 5 : 0;
  const int W = 1 << log_w;
  const int SW = S * W;
  uint32_t* D = smem;                                  // [S][W], in place
  int* cnt = reinterpret_cast<int*>(D + SW);           // [S] live entries
  int* slot = cnt + S;                                 // [4][kMaxC]
  int* pw = slot + 4 * kMaxC;                          // [kMaxRegisters]
  uint16_t* list = reinterpret_cast<uint16_t*>(pw + kMaxRegisters);  // [S][C]
  int8_t* pm = reinterpret_cast<int8_t*>(list + S * C);  // [2][N + 1][S]

  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t ev_base = static_cast<int64_t>(row) * E;

  if (Family == kFamilyPermits) {
    const int n = (p.pm_clients + 1) * S;
    for (int i = t; i < 2 * n; i += nt) {
      pm[i] = static_cast<int8_t>(i < n ? p.pm_acq[i] : p.pm_rel[i - n]);
    }
  }
  if (Family == kFamilyMulti && t == 0) {
#pragma unroll
    for (int k = 0; k < kMaxRegisters; ++k) pw[k] = p.mr_pow[k];
  }
  const int s0 = initial_state<Family>(init_state[row], p);
  for (int w = t; w < SW; w += nt) D[w] = (w == s0 * W) ? 1u : 0u;
  __syncthreads();

  bool done = false;
  int failed = -1;
  for (int e = 0; e < E; ++e) {
    const int es = ev_slot[ev_base + e];  // block-uniform
    if (es < 0) continue;                 // padding: D, done, failed_at kept

    // 1. warp 0 regroups the candidate lanes by slot (summed, as the
    // reference sums them); every thread clears the entry counts
    for (int i = t; i < S; i += nt) cnt[i] = 0;
    if (t < 32) {
      int sf = pack_slot_f(-1, 0), ab = 0;
      if (t < C) {
        const int64_t o = (ev_base + e) * C + t;
        sf = pack_slot_f(cand_slot[o], cand_f[o]);
        ab = pack_ab(cand_a[o], cand_b[o]);
      }
      int act = 0, fs = 0, as = 0, bs = 0;
      for (int l = 0; l < C; ++l) {
        const int sfl = __shfl_sync(kFull, sf, l);
        const int abl = __shfl_sync(kFull, ab, l);
        if (lane_slot(sfl) == t) {
          act = 1;
          fs += sfl >> 8;
          as += lane_a(abl);
          bs += abl >> 16;
        }
      }
      if (t < C) {
        slot[t] = act;
        slot[kMaxC + t] = fs;
        slot[2 * kMaxC + t] = as;
        slot[3 * kMaxC + t] = bs;
      }
    }
    __syncthreads();

    // 2. per target row, its live (slot, source) entries; item i is
    // (target i / 16, slot i % 16)
    for (int i = t; i < S * 16; i += nt) {
      const int j = i & 15;
      const int sp = i >> 4;
      if (j >= C || !slot[j]) continue;
      int kind, reg;
      const int s = target_source<Family>(slot[kMaxC + j], slot[2 * kMaxC + j],
                                          slot[3 * kMaxC + j], sp, p, pm, pw,
                                          &kind, &reg);
      if (s < 0) continue;
      const int q = atomicAdd(&cnt[sp], 1);
      list[sp * C + q] = pack_entry(kind, j, s, reg);
    }
    __syncthreads();

    // 3. closure to fixpoint, in place, capped at C + 2 passes
    for (int pass = 0; pass < C + 2; ++pass) {
      int changed = 0;
      for (int w = t; w < SW; w += nt) {
        const int sp = w >> log_w;
        const int n = cnt[sp];
        if (n == 0) continue;
        const int k = w & (W - 1);
        uint32_t add = 0u;
        for (int q = 0; q < n; ++q) {
          const uint32_t en = list[sp * C + q];
          const int j = (en >> 7) & 15;
          int kk = k;
          uint32_t um = 0xFFFFFFFFu;
          int shl = 0;
          if (j < 5) {
            um = lo_mask(j);
            shl = 1 << j;
          } else {
            const int wb = 1 << (j - 5);
            if (!(k & wb)) continue;  // the image holds only subsets with j
            kk = k ^ wb;
          }
          const int s = en & 127;
          const int kind = (en >> 11) & 3;
          uint32_t x = 0u;
          if (kind == kSrcOne) {
            x = D[s * W + kk];
          } else if (kind == kSrcAll) {
            for (int v = 0; v < S; ++v) x |= D[v * W + kk];
          } else {
            const int step = pw[(en >> 13) & 3] * W;
            for (int v = 0; v < p.mr_vr; ++v) x |= D[s * W + kk + v * step];
          }
          add |= (x & um) << shl;
        }
        const uint32_t d = D[w];
        D[w] = d | add;  // this thread's word: a store of d is harmless
        changed |= (add & ~d) != 0u;
      }
      if (!__syncthreads_or(changed)) break;
    }

    // 4. completion of slot es, in place: keep configs that linearized it,
    // drop its bit
    int nonzero = 0;
    if (es < 5) {
      const int sh = 1 << es;
      const uint32_t lm = lo_mask(es);
      for (int w = t; w < SW; w += nt) {
        const uint32_t v = (D[w] >> sh) & lm;
        D[w] = v;
        nonzero |= v != 0u;
      }
    } else if (es < C) {
      const int wb = 1 << (es - 5);
      for (int w = t; w < SW; w += nt) {
        if (w & wb) continue;  // a word whose subsets hold es: emptied below
        const uint32_t v = D[w | wb];
        D[w] = v;
        D[w | wb] = 0u;
        nonzero |= v != 0u;
      }
    }
    if (!__syncthreads_or(nonzero)) {
      done = true;
      failed = e;
      break;
    }
  }

  if (t == 0) {
    ok[row] = done ? 0 : 1;
    failed_at[row] = failed;
    overflow[row] = 0;
  }
}

template <int LOG_W>
int launch_warp(const void* init_state, const void* ev_slot,
                const void* cand_slot, const void* cand_f, const void* cand_a,
                const void* cand_b, void* ok, void* failed_at, void* overflow,
                int B, int E, int C, const Params& p, cudaStream_t stream) {
  using Sh = WarpShape<LOG_W>;
  const int rows_per_block = kWarpsPerBlock * Sh::H;
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  const size_t shmem = static_cast<size_t>(kWarpsPerBlock) * p.S * Sh::M *
                       32 * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      register_warp_kernel<LOG_W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  register_warp_kernel<LOG_W><<<blocks, kWarpsPerBlock * 32, shmem, stream>>>(
      static_cast<const int32_t*>(init_state),
      static_cast<const int32_t*>(ev_slot),
      static_cast<const int8_t*>(cand_slot),
      static_cast<const int8_t*>(cand_f), static_cast<const int16_t*>(cand_a),
      static_cast<const int16_t*>(cand_b), static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(failed_at), static_cast<uint8_t*>(overflow), B, E,
      C, p);
  return static_cast<int>(cudaGetLastError());
}

int launch_register_warp(const void* init_state, const void* ev_slot,
                         const void* cand_slot, const void* cand_f,
                         const void* cand_a, const void* cand_b, void* ok,
                         void* failed_at, void* overflow, int B, int E, int C,
                         const Params& p, cudaStream_t stream) {
#define DENSE_WARP_CASE(L)                                                    \
  case L:                                                                     \
    return launch_warp<L>(init_state, ev_slot, cand_slot, cand_f, cand_a,     \
                          cand_b, ok, failed_at, overflow, B, E, C, p, stream);
  switch (C > 5 ? C - 5 : 0) {
    DENSE_WARP_CASE(0)
    DENSE_WARP_CASE(1)
    DENSE_WARP_CASE(2)
    DENSE_WARP_CASE(3)
    DENSE_WARP_CASE(4)
    DENSE_WARP_CASE(5)
    DENSE_WARP_CASE(6)
    default:
      return launch_warp<7>(init_state, ev_slot, cand_slot, cand_f, cand_a,
                            cand_b, ok, failed_at, overflow, B, E, C, p,
                            stream);
  }
#undef DENSE_WARP_CASE
}

template <int Family>
int launch_block(const void* init_state, const void* ev_slot,
                 const void* cand_slot, const void* cand_f, const void* cand_a,
                 const void* cand_b, void* ok, void* failed_at, void* overflow,
                 int B, int E, int C, const Params& p, cudaStream_t stream) {
  const int W = C > 5 ? 1 << (C - 5) : 1;
  const int SW = p.S * W;
  int threads = ((SW + 31) / 32) * 32;
  if (threads > kBlockThreads) threads = kBlockThreads;
  const size_t list_bytes = (static_cast<size_t>(p.S) * C * 2 + 3) / 4 * 4;
  size_t shmem = (static_cast<size_t>(SW) + p.S + 4 * kMaxC + kMaxRegisters) *
                     sizeof(uint32_t) + list_bytes;
  if (Family == kFamilyPermits) {
    shmem += 2 * static_cast<size_t>(p.pm_clients + 1) * p.S;
  }
  cudaError_t err = cudaFuncSetAttribute(
      dense_block_kernel<Family>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_block_kernel<Family><<<B, threads, shmem, stream>>>(
      static_cast<const int32_t*>(init_state),
      static_cast<const int32_t*>(ev_slot),
      static_cast<const int8_t*>(cand_slot),
      static_cast<const int8_t*>(cand_f), static_cast<const int16_t*>(cand_a),
      static_cast<const int16_t*>(cand_b), static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(failed_at), static_cast<uint8_t*>(overflow), E, C,
      p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The unordered-queue automaton (K2), replacing dense.py:build_dense_queue.
//
// Unique-value enqueues and dequeues commute, so a config's contents are a
// function of its linset: D is one packed bitset over the 2^C subsets (the
// register kernel with its value axis removed), W <= 128 words, plus two
// value bitsets carried across events for the promoted prefix: enq_c (bit
// v-1: value v enqueued by a completed op, or in the initial contents, from
// init_state) and deq_c (dequeued by a completed op).  A slot's move is
// legal from a source subset depending on which OTHER slots the subset
// holds, so per event each slot j gets a mask valid_j[k] over the source
// words k instead of a transition.  With P_j the open enqueues of j's value
// and Q_j the other open dequeues of j's value (slots matched by their
// summed value ids, as the reference matches them):
//   enqueue:       valid_j[k] = ~0;
//   dequeue of v:  0 if v was dequeued by the prefix (deq_c), else
//                  (v in enq_c ? ~0 : OR_{o in P_j} has(o, k))
//                  & ~OR_{o in Q_j} has(o, k),
// has(o, k) being the bits of word k whose subsets hold slot o: a constant
// in-word pattern for o < 5, all or none of the word by bit o - 5 of k for
// o >= 5.  So three words describe a dequeue slot's masks for an event:
// w0 (its mask of the words that hold no slot >= 5 of P_j or Q_j), w1 (of
// those that hold one of P_j's and none of Q_j's) and the two 7-bit sets
// of P_j's and Q_j's slots >= 5 (a word that holds one of Q_j's is 0).
// The closure ORs (D[k'] & valid_j[k']) into D[k' | bit j], completion
// drops the completing slot's bit, exactly as in the register kernel, and
// then the completing op's value bit joins enq_c or deq_c.  A value id
// outside 1..32 has no bit (the reference's out-of-range shift gives 0).
//
// Why one sweep over the enqueue slots and one over the dequeue slots
// reach the closure's fixpoint.  An enqueue is legal from every subset,
// and a dequeue's legality depends only on the enqueues in the subset
// (one of P_j, unless its value is in enq_c) and on the dequeues of its
// value (none of Q_j).  Take any config the reference's passes reach: a
// start subset plus enqueues E' and dequeues A', added in some legal
// order.  No two of A' share a value (the second would have been
// illegal), so adding E' first and then A' in slot order is legal at
// every step: each dequeue then sees every enqueue it saw before and no
// other dequeue of its value.  In-place sweeps over the enqueue slots in
// slot order, then the dequeue slots in slot order, add exactly such
// configs, so they end on the reference's least fixpoint, with no pass
// that only confirms it and no vote (tests/test_torch_queue.py holds a
// plain twin of this arithmetic against the JAX kernel and checks that
// one more pass never changes D; the reference's C + 2 cap never binds).
//
// The design is the register family's warp design without its state axis:
// a warp checks 32/G histories, G = min(W, 32) lanes each (a lane a history
// at C <= 5); lane k of a history holds subset word k (and k + 32, k + 64,
// k + 96 at C 11 and 12) in registers beside its history's enq_c and
// deq_c.  There is no block barrier; a warp's 768 bytes of shared memory
// hold the table of low_has and the regroup's two transposes.  Per event
// the regroup is lane-parallel while G >= C: lane l holds candidate lane
// l and ORs its bit into its slot's word of the scratch, so lane j learns
// which candidate lanes hold slot j and sums their codes by __shfl_sync
// (one shuffle, unless a slot id repeats); it finds P_j and Q_j with one
// __match_any_sync on the summed value id and two ballots, and writes
// dequeue slot j's three words to the scratch, where every lane of the
// group reads them.  Below that (C <= 7) each lane regroups its history
// from all C candidate lanes in registers.  A sweep applies a slot's image
// by mask and shift, __shfl_xor_sync, or a word of the lane's own;
// completion is branch-free and its emptiness a __ballot_sync over the
// group.  The next event's slot id and candidate lanes are loaded into
// registers while this one runs, and a warp stops after its histories'
// last non-padding event.  What bounds it: integer issue (8 warps a
// scheduler at the flagship hide the loads' latency) along each history's
// serial chain of events (~40 live ones at the flagship, C 8: 4 histories
// a warp, the 16384-row batch in one wave; scripts/queue_diag.py counts
// the cycles of each phase).  Padding events are skipped and a history
// stops at its first failed event, both exact as above.

// one event of one history as a lane holds it; a candidate lane packs its
// slot id (bits 0-7), op code (8-15) and value id (16-31)
template <int LOG_W>
struct QueueEvent {
  int es;
  uint32_t sfa[WarpShape<LOG_W>::LANES_HELD];
};

template <int LOG_W>
__device__ __forceinline__ QueueEvent<LOG_W> load_queue_event(
    const int32_t* __restrict__ ev_slot, const int8_t* __restrict__ cand_slot,
    const int8_t* __restrict__ cand_f, const int16_t* __restrict__ cand_a,
    bool live_row, int64_t ev_base, int e, int C, int gl) {
  using Sh = WarpShape<LOG_W>;
  QueueEvent<LOG_W> ev;
  ev.es = live_row ? ev_slot[ev_base + e] : -1;
  const int64_t base = (ev_base + e) * C;
#pragma unroll
  for (int r = 0; r < Sh::LANES_HELD; ++r) {
    const int l = Sh::LANE_REGROUP ? gl : r;
    ev.sfa[r] = 0xFFu;  // slot -1: no slot
    if (live_row && l < C) {
      ev.sfa[r] = static_cast<uint8_t>(cand_slot[base + l]) |
                  static_cast<uint32_t>(static_cast<uint8_t>(cand_f[base + l]))
                      << 8 |
                  static_cast<uint32_t>(static_cast<uint16_t>(cand_a[base + l]))
                      << 16;
    }
  }
  return ev;
}

__device__ __forceinline__ int sfa_slot(uint32_t q) {
  return static_cast<int8_t>(q & 0xFFu);
}
__device__ __forceinline__ int sfa_f(uint32_t q) {
  return static_cast<int8_t>(q >> 8 & 0xFFu);
}
__device__ __forceinline__ int sfa_a(uint32_t q) {
  return static_cast<int16_t>(q >> 16);
}

// a slot's kind from its summed codes: 0 (no lane, or another code), 1 an
// enqueue, 2 a dequeue; and its value bit
__device__ __forceinline__ int queue_kind(bool on, int f) {
  return !on ? 0 : (f == F_ENQUEUE ? 1 : (f == F_DEQUEUE ? 2 : 0));
}
__device__ __forceinline__ uint32_t value_bit(bool on, int a) {
  const uint32_t sh = static_cast<uint32_t>(a - 1);  // value ids are 1-based
  return on && sh < 32u ? 1u << sh : 0u;
}

// OR of has(o, .) over the slots o < 5 of the set x (x < 32; the kernel
// reads it from a table of the 32 values)
__device__ __forceinline__ uint32_t low_has(uint32_t x) {
  uint32_t r = 0u;
#pragma unroll
  for (int o = 0; o < 5; ++o) r |= (x >> o & 1u) ? ~lo_mask(o) : 0u;
  return r;
}

// a dequeue slot's three mask words from its value bit and slot sets P, Q
// (zero for any other slot: enqueues move in a sweep of their own); `low`
// is the table of low_has
__device__ __forceinline__ void slot_words(int kind, uint32_t vbit,
                                           uint32_t P, uint32_t Q,
                                           uint32_t enq_c, uint32_t deq_c,
                                           const uint32_t* low, uint32_t& w0,
                                           uint32_t& w1, uint32_t& hi) {
  w0 = w1 = hi = 0u;
  if (kind == 2 && !(deq_c & vbit)) {
    const uint32_t notq = ~low[Q & 31u];
    const bool enq_done = (enq_c & vbit) != 0u;
    const uint32_t p_hi = enq_done ? 0u : P >> 5;
    w0 = enq_done ? notq : low[P & 31u] & notq;
    w1 = enq_done || p_hi ? notq : 0u;
    hi = p_hi | (Q >> 5) << 8;
  }
}

// slot mask of word k from the slot's three words
__device__ __forceinline__ uint32_t slot_mask(uint32_t w0, uint32_t w1,
                                              uint32_t hi, int k) {
  const uint32_t kk = static_cast<uint32_t>(k);
  if ((hi >> 8) & kk) return 0u;
  return (hi & 0xFFu & kk) ? w1 : w0;
}

// the completing op's effect on the prefix, packed: kind in bits 0-1, bit 2
// set when its value has a bit, the bit's index in bits 3-7
__device__ __forceinline__ uint32_t pack_completion(int kind, uint32_t vbit,
                                                    int a) {
  return static_cast<uint32_t>(kind) | (vbit ? 4u : 0u) |
         (static_cast<uint32_t>(a - 1) & 31u) << 3;
}

// an event's slots as a lane of a history holds them: each dequeue slot's
// three mask words (zero for the other slots), the history's sets of
// enqueue slots and of dequeue slots with a nonzero mask, the warp's
// union of the latter, and the packed completion of the event's slot
template <int MC>
struct QueueSlots {
  uint32_t w0[MC], w1[MC], hi[MC];
  uint32_t enq, deq, live_deq, comp;
};

// a warp's shared scratch: the table of low_has, and the two transposes of
// the lane-parallel regroup (per slot lane, the candidate lanes holding it;
// per slot lane, its three words and packed completion)
struct QueueScratch {
  const uint32_t* low;
  uint32_t* holders;
  uint4* words;
};

template <int LOG_W>
__device__ __forceinline__ void queue_regroup(
    const QueueEvent<LOG_W>& ev, bool active, int C, uint32_t enq_c,
    uint32_t deq_c, int lane, int gl, const QueueScratch& sc,
    QueueSlots<WarpShape<LOG_W>::MAX_C>& sl) {
  using Sh = WarpShape<LOG_W>;
  constexpr int MC = Sh::MAX_C;
  const int es = ev.es >= 0 && ev.es < C ? ev.es : 0;
  if constexpr (Sh::LANE_REGROUP) {
    // lane j of a group learns which of the group's candidate lanes hold
    // slot j (each ORs its bit into slot j's word of the scratch), sums
    // their codes (a shuffle a holder: one, unless a slot id repeats),
    // matches the group's slots by value id, and every lane reads each
    // live dequeue slot's words from the scratch
    const int gbase = lane & ~(Sh::G - 1);
    const uint32_t gmask = Sh::G == 32 ? kFull : (1u << Sh::G) - 1u;
    const int my_slot = sfa_slot(ev.sfa[0]);
    sc.holders[lane] = 0u;
    __syncwarp();
    if (my_slot >= 0 && my_slot < Sh::G) {
      atomicOr(&sc.holders[gbase + my_slot], 1u << lane);
    }
    __syncwarp();
    uint32_t holders = sc.holders[lane] >> gbase & gmask;
    const int act = holders != 0u;
    int fs = 0, as = 0;
    while (__any_sync(kFull, holders != 0u)) {
      const int src = holders ? __ffs(holders) - 1 : 0;
      const uint32_t q = __shfl_sync(kFull, ev.sfa[0], gbase + src);
      if (holders) {
        fs += sfa_f(q);
        as += sfa_a(q);
        holders &= holders - 1u;
      }
    }
    const bool on = active && act && gl < C;
    const int kind = queue_kind(on, fs);
    const uint32_t vbit = value_bit(on, as);
    // |as| < 2^19, so its low 20 bits identify it; the group's base lane
    // keeps groups apart
    const uint32_t same = __match_any_sync(
        kFull, (static_cast<uint32_t>(as) & 0xFFFFFu) |
                   static_cast<uint32_t>(gbase) << 20);
    const uint32_t enqs = __ballot_sync(kFull, kind == 1);
    const uint32_t deqs = __ballot_sync(kFull, kind == 2) & ~(1u << lane);
    uint32_t m0, m1, mh;
    slot_words(kind, vbit, (same & enqs) >> gbase & gmask,
               (same & deqs) >> gbase & gmask, enq_c, deq_c, sc.low, m0, m1,
               mh);
    sl.enq = enqs >> gbase & gmask;
    sl.deq = __ballot_sync(kFull, (m0 | m1) != 0u) >> gbase & gmask;
    sl.live_deq = __reduce_or_sync(kFull, sl.deq);
    sc.words[lane] = make_uint4(m0, m1, mh, pack_completion(kind, vbit, as));
    __syncwarp();
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      sl.w0[j] = sl.w1[j] = sl.hi[j] = 0u;
      if (sl.live_deq >> j & 1u) {
        const uint4 w = sc.words[gbase + j];
        sl.w0[j] = w.x;
        sl.w1[j] = w.y;
        sl.hi[j] = w.z;
      }
    }
    sl.comp = sc.words[gbase + es].w;
    __syncwarp();  // read before the next event writes
  } else {
    // fewer lanes than slots (C <= 7): each lane regroups its history
    int kind[MC], as[MC];
    uint32_t vbit[MC];
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      int act = 0, fs = 0, a = 0;
#pragma unroll
      for (int l = 0; l < MC; ++l) {
        if (l < C && sfa_slot(ev.sfa[l]) == j) {
          act = 1;
          fs += sfa_f(ev.sfa[l]);
          a += sfa_a(ev.sfa[l]);
        }
      }
      const bool on = active && act && j < C;
      kind[j] = queue_kind(on, fs);
      as[j] = a;
      vbit[j] = value_bit(on, a);
    }
    sl.enq = sl.deq = sl.comp = 0u;
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      uint32_t P = 0u, Q = 0u;
#pragma unroll
      for (int o = 0; o < MC; ++o) {
        const bool same = as[o] == as[j];
        P |= static_cast<uint32_t>(same && kind[o] == 1) << o;
        Q |= static_cast<uint32_t>(same && kind[o] == 2 && o != j) << o;
      }
      slot_words(kind[j], vbit[j], P, Q, enq_c, deq_c, sc.low, sl.w0[j],
                 sl.w1[j], sl.hi[j]);
      sl.enq |= static_cast<uint32_t>(kind[j] == 1) << j;
      sl.deq |= static_cast<uint32_t>((sl.w0[j] | sl.w1[j]) != 0u) << j;
      if (j == es) sl.comp = pack_completion(kind[j], vbit[j], as[j]);
    }
    sl.live_deq = __reduce_or_sync(kFull, sl.deq);
  }
}

// one Gauss-Seidel sweep over slots J .. MAX_C - 1, in place on this lane's
// words D: the enqueue slots of `enq` (ENQ) or the dequeue slots by their
// masks; `live` is the warp's union of the slots the sweep moves
template <int LOG_W, int J, bool ENQ>
__device__ __forceinline__ void queue_sweep(
    uint32_t (&D)[WarpShape<LOG_W>::M],
    const uint32_t (&valid)[WarpShape<LOG_W>::MAX_C][WarpShape<LOG_W>::M],
    uint32_t enq, uint32_t live, int gl) {
  using Sh = WarpShape<LOG_W>;
  if constexpr (J < Sh::MAX_C) {
    constexpr int M = Sh::M;
    if (live >> J & 1u) {
      uint32_t x[M], t[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        x[m] = ENQ ? ((enq >> J & 1u) ? D[m] : 0u) : D[m] & valid[J][m];
      }
      slot_image<LOG_W, J>(x, t, gl);
#pragma unroll
      for (int m = 0; m < M; ++m) D[m] |= t[m];
    }
    queue_sweep<LOG_W, J + 1, ENQ>(D, valid, enq, live, gl);
  }
}

// completion of slot es on this lane's words, for an active history (the
// others keep D), as warp_complete does it but without branches: word k of
// the new D is word k shifted down by 2^es and masked (es < 5), or word
// k | 2^(es-5) where k lacks that bit (from lane gl ^ 2^(es-5) while that
// is in the group, else this lane's word m | 2^(es-5) / G), none when
// es >= C.  `low` is the table of low_has (lo_mask(j) = ~low[1 << j]).
// Returns whether this lane's words of the new D are nonzero.
template <int LOG_W>
__device__ __forceinline__ bool queue_complete(
    uint32_t (&D)[WarpShape<LOG_W>::M], bool active, int es, int C,
    int lane, int gl, const uint32_t* low) {
  using Sh = WarpShape<LOG_W>;
  constexpr int M = Sh::M;
  const bool in = active && es < C;  // es >= 0 when active
  const bool in_word = in && es < 5;
  const int b = in && !in_word ? 1 << (es - 5) : 0;  // es - 5 < 7
  const int sh = in_word ? 1 << es : 0;
  const uint32_t lm =
      !active ? 0xFFFFFFFFu
              : (!in ? 0u
                     : (in_word ? ~low[1u << es & 31u]
                                : (b < Sh::G && (gl & b) ? 0u : 0xFFFFFFFFu)));
  const int from = b < Sh::G ? lane ^ b : lane;
  const int wm = b < Sh::G ? 0 : b / Sh::G;  // a word of this lane (M > 1)
  uint32_t nd[M];
  bool nonzero = false;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    uint32_t y = __shfl_sync(kFull, D[m], from);
#pragma unroll
    for (int w = 1; w < M; w <<= 1) {
      if (wm == w) y = (m & w) ? 0u : D[m | w];
    }
    nd[m] = (y >> sh) & lm;
    nonzero |= nd[m] != 0u;
  }
#pragma unroll
  for (int m = 0; m < M; ++m) D[m] = nd[m];
  return nonzero;
}

template <int LOG_W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32) dense_queue_kernel(
    const int32_t* __restrict__ init_state, const int32_t* __restrict__ ev_slot,
    const int8_t* __restrict__ cand_slot, const int8_t* __restrict__ cand_f,
    const int16_t* __restrict__ cand_a, uint8_t* __restrict__ ok,
    int32_t* __restrict__ failed_at, uint8_t* __restrict__ overflow, int B,
    int E, int C) {
  using Sh = WarpShape<LOG_W>;
  constexpr int M = Sh::M;
  constexpr int MC = Sh::MAX_C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = lane & (Sh::G - 1);
  const int row = (blockIdx.x * kWarpsPerBlock + warp) * Sh::H +
                  (lane >> Sh::LOG_G);
  const bool live_row = row < B;
  const int64_t ev_base = static_cast<int64_t>(live_row ? row : 0) * E;
  const uint32_t group =
      Sh::G == 32 ? kFull : ((1u << Sh::G) - 1u) << (lane & ~(Sh::G - 1));

  // the warp's own scratch (QueueScratch)
  __shared__ uint32_t low_table[kWarpsPerBlock][32];
  __shared__ uint32_t holders[kWarpsPerBlock][32];
  __shared__ uint4 words[kWarpsPerBlock][32];
  const QueueScratch sc{low_table[warp], holders[warp], words[warp]};
  low_table[warp][lane] = low_has(lane);
  __syncwarp();

  uint32_t D[M];  // the empty linset: subset 0, bit 0 of word 0
#pragma unroll
  for (int m = 0; m < M; ++m) D[m] = (m == 0 && gl == 0) ? 1u : 0u;
  uint32_t enq_c = live_row ? static_cast<uint32_t>(init_state[row]) : 0u;
  uint32_t deq_c = 0u;
  bool done = !live_row;
  int failed = -1;
  // the warp's last non-padding event: past it every history keeps D (at
  // one lane a history, a lane's scan of its whole row cost more than the
  // padding events it saved)
  int last = E - 1;
  if constexpr (Sh::G > 1) {
    last = -1;
    if (live_row) {
      for (int e = gl; e < E; e += Sh::G) {
        if (ev_slot[ev_base + e] >= 0) last = e;
      }
    }
    last = __reduce_max_sync(kFull, last);
  }
  QueueEvent<LOG_W> next = load_queue_event<LOG_W>(
      ev_slot, cand_slot, cand_f, cand_a, live_row && last >= 0, ev_base, 0,
      C, gl);
  for (int e = 0; e <= last; ++e) {
    const QueueEvent<LOG_W> cur = next;
    if (e < last) {  // the next event's loads run under this one's work
      next = load_queue_event<LOG_W>(ev_slot, cand_slot, cand_f, cand_a,
                                     live_row, ev_base, e + 1, C, gl);
    }
    const bool active = !done && cur.es >= 0;
    if (!__any_sync(kFull, active)) continue;

    QueueSlots<MC> sl;
    queue_regroup<LOG_W>(cur, active, C, enq_c, deq_c, lane, gl, sc, sl);
    uint32_t valid[MC][M];
#pragma unroll
    for (int j = 0; j < MC; ++j) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        valid[j][m] = sl.live_deq >> j & 1u
                          ? slot_mask(sl.w0[j], sl.w1[j], sl.hi[j],
                                      gl + m * Sh::G)
                          : 0u;
      }
    }

    // the closure: every enqueue slot, then every dequeue slot, one
    // sweep each (the fixpoint, as argued above)
    queue_sweep<LOG_W, 0, true>(D, valid, sl.enq,
                                __reduce_or_sync(kFull, sl.enq), gl);
    queue_sweep<LOG_W, 0, false>(D, valid, sl.enq, sl.live_deq, gl);

    const bool nonzero =
        queue_complete<LOG_W>(D, active, cur.es, C, lane, gl, sc.low);
    const uint32_t votes = __ballot_sync(kFull, nonzero);
    if (active && !(votes & group)) {
      done = true;
      failed = e;
    } else if (active && cur.es < C) {  // the completing op joins the prefix
      const uint32_t bit = sl.comp & 4u ? 1u << (sl.comp >> 3) : 0u;
      if ((sl.comp & 3u) == 1u) enq_c |= bit;
      if ((sl.comp & 3u) == 2u) deq_c |= bit;
    }
    if (__all_sync(kFull, done)) break;
  }

  if (live_row && gl == 0) {
    ok[row] = done ? 0 : 1;
    failed_at[row] = failed;
    overflow[row] = 0;
  }
}

template <int LOG_W>
int launch_queue(const void* init_state, const void* ev_slot,
                 const void* cand_slot, const void* cand_f, const void* cand_a,
                 void* ok, void* failed_at, void* overflow, int B, int E,
                 int C, cudaStream_t stream) {
  using Sh = WarpShape<LOG_W>;
  const int rows_per_block = kWarpsPerBlock * Sh::H;
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  dense_queue_kernel<LOG_W><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const int32_t*>(init_state),
      static_cast<const int32_t*>(ev_slot),
      static_cast<const int8_t*>(cand_slot),
      static_cast<const int8_t*>(cand_f), static_cast<const int16_t*>(cand_a),
      static_cast<uint8_t*>(ok), static_cast<int32_t*>(failed_at),
      static_cast<uint8_t*>(overflow), B, E, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch over B histories on `stream`; returns the CUDA error of the
// shared-memory attribute or of the launch (0 on success).  Shapes:
// init_state [B] int32, ev_slot [B, E] int32, cand_slot/cand_f [B, E, C]
// int8, cand_a/cand_b [B, E, C] int16, all contiguous; ok/overflow [B] uint8
// (torch.bool), failed_at [B] int32.  `family` is one of kFamily*; S is the
// state count (1..128).  Multi-register passes (mr_vr, mr_k) with
// mr_vr^mr_k == S; permits pass the int32 [pm_clients + 1, S] source tables
// of dense.py:permit_sources (the state acquiring / releasing client c moves
// to state t, or -1).  The register family runs the warp design while
// S * W <= kWarpMaxSW, every other shape the block design.
extern "C" int dense_automaton_launch(
    const void* init_state, const void* ev_slot, const void* cand_slot,
    const void* cand_f, const void* cand_a, const void* cand_b, void* ok,
    void* failed_at, void* overflow, int B, int E, int C, int S, int family,
    int mr_vr, int mr_k, const void* pm_acq, const void* pm_rel,
    int pm_clients, void* stream) {
  if (B == 0) return 0;
  if (B < 0 || E < 0 || C < 1 || C > kMaxC || S < 1 || S > kMaxS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.S = S;
  if (family == kFamilyMulti) {
    if (mr_vr < 1 || mr_k < 1 || mr_k > kMaxRegisters) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int pw = 1;
    for (int k = 0; k < mr_k; ++k) {
      p.mr_pow[k] = pw;
      pw *= mr_vr;
    }
    if (pw != S) return static_cast<int>(cudaErrorInvalidValue);
    p.mr_vr = mr_vr;
    p.mr_k = mr_k;
  } else if (family == kFamilyPermits) {
    if (pm_acq == nullptr || pm_rel == nullptr || pm_clients < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.pm_acq = static_cast<const int32_t*>(pm_acq);
    p.pm_rel = static_cast<const int32_t*>(pm_rel);
    p.pm_clients = pm_clients;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = C > 5 ? 1 << (C - 5) : 1;
  switch (family) {
    case kFamilyRegister:
      if (S * W <= kWarpMaxSW) {
        return launch_register_warp(init_state, ev_slot, cand_slot, cand_f,
                                    cand_a, cand_b, ok, failed_at, overflow,
                                    B, E, C, p, st);
      }
      return launch_block<kFamilyRegister>(
          init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b, ok,
          failed_at, overflow, B, E, C, p, st);
    case kFamilyReentrant:
      return launch_block<kFamilyReentrant>(
          init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b, ok,
          failed_at, overflow, B, E, C, p, st);
    case kFamilyPermits:
      return launch_block<kFamilyPermits>(
          init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b, ok,
          failed_at, overflow, B, E, C, p, st);
    case kFamilyMulti:
      return launch_block<kFamilyMulti>(
          init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b, ok,
          failed_at, overflow, B, E, C, p, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launch the unordered-queue automaton over B histories on `stream`; returns
// the CUDA error of the launch (0 on success).  Shapes as
// dense_automaton_launch takes them; init_state is the initial contents as a
// value bitset, cand_b is not read, 1 <= C <= 12.
extern "C" int dense_queue_launch(const void* init_state, const void* ev_slot,
                                  const void* cand_slot, const void* cand_f,
                                  const void* cand_a, const void* cand_b,
                                  void* ok, void* failed_at, void* overflow,
                                  int B, int E, int C, void* stream) {
  (void)cand_b;
  if (B == 0) return 0;
  if (B < 0 || E < 0 || C < 1 || C > kMaxC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DENSE_QUEUE_CASE(L)                                                   \
  case L:                                                                     \
    return launch_queue<L>(init_state, ev_slot, cand_slot, cand_f, cand_a,   \
                           ok, failed_at, overflow, B, E, C, st);
  switch (C > 5 ? C - 5 : 0) {
    DENSE_QUEUE_CASE(0)
    DENSE_QUEUE_CASE(1)
    DENSE_QUEUE_CASE(2)
    DENSE_QUEUE_CASE(3)
    DENSE_QUEUE_CASE(4)
    DENSE_QUEUE_CASE(5)
    DENSE_QUEUE_CASE(6)
    default:
      return launch_queue<7>(init_state, ev_slot, cand_slot, cand_f, cand_a,
                             ok, failed_at, overflow, B, E, C, st);
  }
#undef DENSE_QUEUE_CASE
}
