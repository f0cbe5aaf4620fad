// Dense subset automata for linearizability, by hand for Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/dense.py:build_dense, the jitted vmap-of-scan that
// the JAX package runs on the TPU, in all four of its transition families
// (one template instantiation each), and, in a kernel of its own at the end
// of this file, dense.py:build_dense_queue (the unordered queue, K2):
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
// and overflow (always 0 — the dense automaton cannot overflow).
//
// State: D[s][w], S states x W = max(1, 2^C / 32) packed uint32 words; bit k
// of the subset axis says "some order of the open ops in subset k takes the
// model to state s".  Per non-padding event:
//   1. regroup the C candidate lanes by slot and build, per (slot j,
//      target state s'), the mask of source states s that linearizing
//      slot j moves to s' (ceil(S/32) words; one while S <= 32);
//   2. closure: X_j[s'][k] = OR_{s in src[j][s']} D[s][uidx(j,k)], then
//      D |= OR_j (X_j & umask(j,k)) << ushl(j), as a Jacobi pass (every
//      pass reads the pre-pass D), until no word changes or C+2 passes;
//   3. completion of slot e: D'[s][k] = (D[s][didx(e,k)] >> dshr(e)) &
//      dmask(e,k); an all-zero D' fails the history at this event.
// Steps 2 and 3 are the same code for every family.  The subset-map tables
// (uidx, umask, ushl, didx, dmask, dshr) are the ones dense.py:_subset_maps
// builds, computed here from j and k.
//
// What bounds it on this card: not device memory — a history's inputs are
// 4 + 6C bytes per event (76 B at C = 12), read once.  The work is integer
// ops on shared memory plus four block barriers per event, serial over the
// E events of one history; that chain of dependent passes is the limit.
// The design answers it with many independent blocks: one block per history
// keeps D (at most 128 x 128 words, 64 KB, double buffered) and the source
// masks in shared memory for the whole scan, a block is as wide as D has
// words (up to 512 threads), so an SM holds several histories at once and
// hides one block's barriers behind the others' work.  Past 48 KB of shared
// memory (S * W large: the permit and multi-register automata at C = 12)
// the launch raises the kernel's dynamic shared-memory limit for its shape
// and returns the error if the card refuses it.  Padding events are skipped
// and a block stops at the first failed event: both are exact, because the
// reference keeps D on a padding event and never changes failed_at once a
// history is done.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 12;
constexpr int kMaxS = 128;
constexpr int kMaxThreads = 512;
constexpr int kMaxRegisters = 4;  // step_kernels.MR_REGISTERS
constexpr int kValueBits = 8;     // step_kernels.MR_VALUE_BITS

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

constexpr int kMaxW = 1 << (kMaxC - 5);  // packed subset words at C = 12

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

__device__ __forceinline__ void add_source(uint32_t* mask, int s, int S) {
  if (s >= 0 && s < S) mask[s >> 5] |= 1u << (s & 31);
}

// mask (MW words, owned by the calling thread) := the source states that
// linearizing an op (f, a, b) moves to state sp.  In every family the move
// is a partial function of the source, and its preimage of sp has a closed
// form (one source, or all of them for a register write, or the Vr states
// differing from sp in the written register).  Codes the family never
// emits fall into its catch-all branch exactly as the reference's nested
// selects do.
template <int Family, int MW>
__device__ __forceinline__ void source_mask(int f, int a, int b, int sp,
                                            const Params& p, uint32_t* mask) {
  const int S = p.S;
#pragma unroll
  for (int mw = 0; mw < MW; ++mw) mask[mw] = 0u;
  if (Family == kFamilyReentrant) {
    // acquire 0 -> 2a-1 -> 2a, release 2a -> 2a-1 -> 0
    const int once = 2 * a - 1;
    const int twice = 2 * a;
    if (f == F_RACQUIRE) {
      if (sp == once) add_source(mask, 0, S);
      if (sp == twice) add_source(mask, once, S);
    } else {
      if (sp == once) add_source(mask, twice, S);
      if (sp == 0) add_source(mask, once, S);
    }
  } else if (Family == kFamilyPermits) {
    // the source tables invert dense.py:permits_tables (each client's
    // acquire and release maps are one-to-one)
    const int c = a < 0 ? 0 : (a > p.pm_clients ? p.pm_clients : a);
    const int32_t* src = f == F_PACQUIRE ? p.pm_acq : p.pm_rel;
    add_source(mask, src[c * S + sp], S);
  } else if (Family == kFamilyMulti) {
    const int reg = b < 0 ? 0 : (b >= p.mr_k ? p.mr_k - 1 : b);
    const int pw = p.mr_pow[reg];
    const int d = (sp / pw) % p.mr_vr;
    if (f == F_WRITE) {  // every value of register reg, if sp holds a there
      if (d == a) {
        for (int x = 0; x < p.mr_vr; ++x) add_source(mask, sp + (x - d) * pw, S);
      }
    } else if (f == F_READ_ANY || d == a) {  // read-any, or a read of a
      add_source(mask, sp, S);
    }
  } else {
    const bool acq = f == F_ACQUIRE;
    const bool rel = f == F_RELEASE;
    const int a_eff = acq ? 0 : (rel ? 1 : a);
    const int b_eff = acq ? 1 : (rel ? 0 : b);
    if (f == F_WRITE) {  // every state moves to a
      if (sp == a_eff) {
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) {
          const int n = S - 32 * mw;
          mask[mw] = n >= 32 ? 0xFFFFFFFFu : (n > 0 ? (1u << n) - 1u : 0u);
        }
      }
    } else if (f == F_READ_ANY) {
      add_source(mask, sp, S);
    } else if (f == F_CAS || acq || rel) {
      if (sp == b_eff) add_source(mask, a_eff, S);
    } else if (sp == a_eff) {  // read (and any code the family never emits)
      add_source(mask, a_eff, S);
    }
  }
}

// MW: source-mask words per (slot, target), ceil(S / 32), a template
// parameter so the closure's innermost loop unrolls (one word, as in the
// register family, costs what a plain mask did)
template <int Family, int MW>
__global__ void dense_automaton_kernel(
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
  uint32_t* cur = smem;                // D, [S][W]
  uint32_t* nxt = smem + SW;           // the next D, [S][W]
  uint32_t* src = smem + 2 * SW;       // source masks, [C][S][MW]
  int32_t* lane = reinterpret_cast<int32_t*>(src + C * S * MW);  // [4][C]

  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t ev_base = static_cast<int64_t>(row) * E;

  // one config: the initial state (a multi-register init packs one byte
  // per register; the id is placed as the reference's
  // dynamic_update_index_in_dim places it: a negative id counts from the
  // end, then it is clamped into [0, S)), empty linset
  int s0 = init_state[row];
  if (Family == kFamilyMulti) {
    int id = 0;
    for (int k = 0; k < p.mr_k; ++k) {
      id += ((s0 >> (kValueBits * k)) & ((1 << kValueBits) - 1)) * p.mr_pow[k];
    }
    s0 = id;
  }
  if (s0 < 0) s0 += S;
  s0 = s0 < 0 ? 0 : (s0 >= S ? S - 1 : s0);
  for (int w = t; w < SW; w += nt) cur[w] = (w == s0 * W) ? 1u : 0u;
  __syncthreads();

  bool done = false;
  int failed = -1;
  for (int e = 0; e < E; ++e) {
    const int es = ev_slot[ev_base + e];  // block-uniform
    if (es < 0) continue;                 // padding: D, done, failed_at kept

    const int64_t lane_base = (ev_base + e) * C;
    if (t < C) {
      lane[t] = cand_slot[lane_base + t];
      lane[C + t] = cand_f[lane_base + t];
      lane[2 * C + t] = cand_a[lane_base + t];
      lane[3 * C + t] = cand_b[lane_base + t];
    }
    __syncthreads();

    // per (slot j, target sp): regroup the lanes holding slot j (summed,
    // as the reference sums them) and build the mask of source states
    for (int i = t; i < C * S; i += nt) {
      const int j = i / S;
      const int sp = i - j * S;
      bool active = false;
      int f = 0, a = 0, b = 0;
      for (int l = 0; l < C; ++l) {
        if (lane[l] == j) {
          active = true;
          f += lane[C + l];
          a += lane[2 * C + l];
          b += lane[3 * C + l];
        }
      }
      uint32_t* mask = src + i * MW;
      if (active) {
        source_mask<Family, MW>(f, a, b, sp, p, mask);
      } else {
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) mask[mw] = 0u;
      }
    }
    __syncthreads();

    // closure to fixpoint, Jacobi passes capped at C + 2
    for (int pass = 0; pass < C + 2; ++pass) {
      int changed = 0;
      for (int w = t; w < SW; w += nt) {
        const int sp = w >> log_w;
        const int k = w & (W - 1);
        uint32_t add = 0;
        for (int j = 0; j < C; ++j) {
          // most (slot, target) pairs have no source: skip them first
          const uint32_t* mask = src + (j * S + sp) * MW;
          uint32_t m[MW];
          uint32_t sources = 0u;
#pragma unroll
          for (int mw = 0; mw < MW; ++mw) {
            m[mw] = mask[mw];
            sources |= m[mw];
          }
          if (sources == 0u) continue;
          int kk = k;
          uint32_t um;
          int shl;
          if (j < 5) {
            um = lo_mask(j);
            shl = 1 << j;
          } else {
            const int wb = 1 << (j - 5);
            if (!(k & wb)) continue;  // the image holds only subsets with j
            kk = k ^ wb;
            um = 0xFFFFFFFFu;
            shl = 0;
          }
          uint32_t x = 0;
#pragma unroll
          for (int mw = 0; mw < MW; ++mw) {
            uint32_t mm = m[mw];
            while (mm) {
              const int v = mw * 32 + __ffs(mm) - 1;
              mm &= mm - 1;
              x |= cur[v * W + kk];
            }
          }
          add |= (x & um) << shl;
        }
        const uint32_t d = cur[w];
        const uint32_t dn = d | add;
        nxt[w] = dn;
        changed |= dn != d;
      }
      const int any = __syncthreads_or(changed);
      uint32_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (!any) break;
    }

    // completion of slot es: keep configs that linearized it, drop its bit
    int nonzero = 0;
    for (int w = t; w < SW; w += nt) {
      uint32_t df = 0;
      if (es < C) {
        if (es < 5) {
          df = (cur[w] >> (1 << es)) & lo_mask(es);
        } else {
          const int wb = 1 << (es - 5);
          const int k = w & (W - 1);
          df = (k & wb) ? 0u : cur[w | wb];
        }
      }
      nxt[w] = df;
      nonzero |= df != 0u;
    }
    const int any = __syncthreads_or(nonzero);
    if (!any) {
      done = true;
      failed = e;
      break;
    }
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (t == 0) {
    ok[row] = done ? 0 : 1;
    failed_at[row] = failed;
    overflow[row] = 0;
  }
}

template <int Family, int MW>
int launch(const void* init_state, const void* ev_slot, const void* cand_slot,
           const void* cand_f, const void* cand_a, const void* cand_b,
           void* ok, void* failed_at, void* overflow, int B, int E, int C,
           const Params& p, cudaStream_t stream) {
  const int W = C > 5 ? 1 << (C - 5) : 1;
  const int SW = p.S * W;
  int threads = ((SW + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t shmem =
      (2 * static_cast<size_t>(SW) + static_cast<size_t>(C) * p.S * MW) *
          sizeof(uint32_t) +
      4 * static_cast<size_t>(C) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      dense_automaton_kernel<Family, MW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_automaton_kernel<Family, MW><<<B, threads, shmem, stream>>>(
      static_cast<const int32_t*>(init_state),
      static_cast<const int32_t*>(ev_slot),
      static_cast<const int8_t*>(cand_slot),
      static_cast<const int8_t*>(cand_f),
      static_cast<const int16_t*>(cand_a),
      static_cast<const int16_t*>(cand_b), static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(failed_at), static_cast<uint8_t*>(overflow), E, C,
      p);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for the family and the mask width ceil(S / 32)
template <int Family>
int launch_family(const void* init_state, const void* ev_slot,
                  const void* cand_slot, const void* cand_f,
                  const void* cand_a, const void* cand_b, void* ok,
                  void* failed_at, void* overflow, int B, int E, int C,
                  const Params& p, cudaStream_t stream) {
  switch ((p.S + 31) / 32) {
    case 1:
      return launch<Family, 1>(init_state, ev_slot, cand_slot, cand_f,
                               cand_a, cand_b, ok, failed_at, overflow, B, E,
                               C, p, stream);
    case 2:
      return launch<Family, 2>(init_state, ev_slot, cand_slot, cand_f,
                               cand_a, cand_b, ok, failed_at, overflow, B, E,
                               C, p, stream);
    case 3:
      return launch<Family, 3>(init_state, ev_slot, cand_slot, cand_f,
                               cand_a, cand_b, ok, failed_at, overflow, B, E,
                               C, p, stream);
    default:
      return launch<Family, 4>(init_state, ev_slot, cand_slot, cand_f,
                               cand_a, cand_b, ok, failed_at, overflow, B, E,
                               C, p, stream);
  }
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
// holds, so per event each slot j gets a mask valid[j][k] over the source
// words k instead of a transition:
//   enqueue:  every subset;
//   dequeue of v: none if v was dequeued by the prefix (deq_c); else the
//     subsets where v is present -- all if its enqueue completed (enq_c),
//     else those holding the slot of an open enqueue of v -- minus those
//     holding the slot of another open dequeue of v.
// Slots are matched by their (summed) value ids, as the reference matches
// them.  The closure ORs (D[k'] & valid[j][k']) into D[k' | bit j] by
// Jacobi passes capped at C + 2, and completion drops the completing slot's
// bit, exactly as in the register kernel; then the completing op's value
// bit joins enq_c or deq_c.  A value id outside 1..32 has no bit (the
// reference's out-of-range shift gives 0).
//
// What bounds it on this card: the same serial chain of block barriers per
// event as the register family, over fewer words (no state axis): one block
// per history, at most 128 threads, the masks ([C][W], 6 KB at C = 12) and
// both D buffers in static shared memory.  Padding events are skipped and a
// block stops at its first failed event, both exact as above.

__device__ __forceinline__ uint32_t subset_has(int m, int k) {
  // the packed bits of word k whose subset holds slot m
  if (m < 5) return ~lo_mask(m);
  return ((k >> (m - 5)) & 1) ? 0xFFFFFFFFu : 0u;
}

__global__ void dense_queue_kernel(
    const int32_t* __restrict__ init_state, const int32_t* __restrict__ ev_slot,
    const int8_t* __restrict__ cand_slot, const int8_t* __restrict__ cand_f,
    const int16_t* __restrict__ cand_a, uint8_t* __restrict__ ok,
    int32_t* __restrict__ failed_at, uint8_t* __restrict__ overflow, int E,
    int C) {
  __shared__ uint32_t buf[2][kMaxW];
  __shared__ uint32_t valid[kMaxC * kMaxW];
  __shared__ int32_t lane[3 * kMaxC];
  __shared__ int32_t slot_kind[kMaxC];  // 0 inactive or other, 1 enq, 2 deq
  __shared__ int32_t slot_a[kMaxC];
  __shared__ uint32_t slot_vbit[kMaxC];

  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int log_w = C > 5 ? C - 5 : 0;
  const int W = 1 << log_w;
  const int64_t ev_base = static_cast<int64_t>(row) * E;
  uint32_t* cur = buf[0];
  uint32_t* nxt = buf[1];

  // every thread carries its own copy of the prefix bitsets: all of them
  // update them from the same shared values
  uint32_t enq_c = static_cast<uint32_t>(init_state[row]);
  uint32_t deq_c = 0u;
  for (int w = t; w < W; w += nt) cur[w] = w == 0 ? 1u : 0u;  // empty linset
  __syncthreads();

  bool done = false;
  int failed = -1;
  for (int e = 0; e < E; ++e) {
    const int es = ev_slot[ev_base + e];  // block-uniform
    if (es < 0) continue;                 // padding: D and the prefix kept

    const int64_t lane_base = (ev_base + e) * C;
    if (t < C) {
      lane[t] = cand_slot[lane_base + t];
      lane[C + t] = cand_f[lane_base + t];
      lane[2 * C + t] = cand_a[lane_base + t];
    }
    __syncthreads();

    // regroup the lanes by slot (summed, as the reference sums them)
    if (t < C) {
      bool active = false;
      int f = 0, a = 0;
      for (int l = 0; l < C; ++l) {
        if (lane[l] == t) {
          active = true;
          f += lane[C + l];
          a += lane[2 * C + l];
        }
      }
      const uint32_t shift = static_cast<uint32_t>(a - 1);
      slot_kind[t] = !active ? 0 : (f == F_ENQUEUE ? 1 : (f == F_DEQUEUE ? 2 : 0));
      slot_a[t] = a;
      slot_vbit[t] = active && shift < 32u ? 1u << shift : 0u;
    }
    __syncthreads();

    // each slot's mask of legal source words
    for (int i = t; i < C * W; i += nt) {
      const int j = i >> log_w;
      const int k = i & (W - 1);
      const int kind = slot_kind[j];
      uint32_t m = 0u;
      if (kind == 1) {
        m = 0xFFFFFFFFu;
      } else if (kind == 2 && !(deq_c & slot_vbit[j])) {
        const int a = slot_a[j];
        uint32_t present = (enq_c & slot_vbit[j]) ? 0xFFFFFFFFu : 0u;
        uint32_t forbid = 0u;
        for (int o = 0; o < C; ++o) {
          if (slot_a[o] != a) continue;
          if (slot_kind[o] == 1) present |= subset_has(o, k);
          if (slot_kind[o] == 2 && o != j) forbid |= subset_has(o, k);
        }
        m = present & ~forbid;
      }
      valid[i] = m;
    }
    __syncthreads();

    // closure to fixpoint, Jacobi passes capped at C + 2
    for (int pass = 0; pass < C + 2; ++pass) {
      int changed = 0;
      for (int k = t; k < W; k += nt) {
        uint32_t add = 0u;
        for (int j = 0; j < C; ++j) {
          if (j < 5) {
            add |= ((cur[k] & valid[j * W + k]) & lo_mask(j)) << (1 << j);
          } else {
            const int wb = 1 << (j - 5);
            if (k & wb) add |= cur[k ^ wb] & valid[j * W + (k ^ wb)];
          }
        }
        const uint32_t d = cur[k];
        const uint32_t dn = d | add;
        nxt[k] = dn;
        changed |= dn != d;
      }
      const int any = __syncthreads_or(changed);
      uint32_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
      if (!any) break;
    }

    // completion of slot es: keep configs that linearized it, drop its bit
    int nonzero = 0;
    for (int k = t; k < W; k += nt) {
      uint32_t df = 0u;
      if (es < C) {
        if (es < 5) {
          df = (cur[k] >> (1 << es)) & lo_mask(es);
        } else {
          const int wb = 1 << (es - 5);
          df = (k & wb) ? 0u : cur[k | wb];
        }
      }
      nxt[k] = df;
      nonzero |= df != 0u;
    }
    const int any = __syncthreads_or(nonzero);
    if (!any) {
      done = true;
      failed = e;
      break;
    }
    if (es < C) {  // the completing op joins the prefix
      if (slot_kind[es] == 1) enq_c |= slot_vbit[es];
      if (slot_kind[es] == 2) deq_c |= slot_vbit[es];
    }
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (t == 0) {
    ok[row] = done ? 0 : 1;
    failed_at[row] = failed;
    overflow[row] = 0;
  }
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
// to state t, or -1).
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
  switch (family) {
    case kFamilyRegister:
      return launch_family<kFamilyRegister>(
          init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b, ok,
          failed_at, overflow, B, E, C, p, st);
    case kFamilyReentrant:
      return launch_family<kFamilyReentrant>(
          init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b, ok,
          failed_at, overflow, B, E, C, p, st);
    case kFamilyPermits:
      return launch_family<kFamilyPermits>(
          init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b, ok,
          failed_at, overflow, B, E, C, p, st);
    case kFamilyMulti:
      return launch_family<kFamilyMulti>(
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
  const int W = C > 5 ? 1 << (C - 5) : 1;
  const int threads = ((W + 31) / 32) * 32;
  dense_queue_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(init_state),
      static_cast<const int32_t*>(ev_slot),
      static_cast<const int8_t*>(cand_slot),
      static_cast<const int8_t*>(cand_f), static_cast<const int16_t*>(cand_a),
      static_cast<uint8_t*>(ok), static_cast<int32_t*>(failed_at),
      static_cast<uint8_t*>(overflow), E, C);
  return static_cast<int>(cudaGetLastError());
}
