// Dense subset automaton for register-family linearizability, by hand for
// Hopper (sm_90a).
//
// Replaces jepsen_tpu/ops/dense.py:build_dense (register / cas-register /
// read-any transitions, with mutex acquire/release as cas), the jitted
// vmap-of-scan that the JAX package runs on the TPU.  Same function, same
// outputs: per history, ok (no completion ever emptied the automaton),
// failed_at (index of the event that emptied it, else -1) and overflow
// (always 0 — the dense automaton cannot overflow).
//
// State: D[v][w], V values x W = max(1, 2^C / 32) packed uint32 words; bit s
// of the subset axis says "some order of the open ops in subset s takes the
// register to value v".  Per non-padding event:
//   1. regroup the C candidate lanes by slot and build, per (slot j, target
//      value v'), the V-bit mask of source values v with T[j][v'][v];
//   2. closure: X_j[v'][k] = OR_{v in src[j][v']} D[v][uidx(j,k)], then
//      D |= OR_j (X_j & umask(j,k)) << ushl(j), as a Jacobi pass (every
//      pass reads the pre-pass D), until no word changes or C+2 passes;
//   3. completion of slot e: D'[v][k] = (D[v][didx(e,k)] >> dshr(e)) &
//      dmask(e,k); an all-zero D' fails the history at this event.
// The subset-map tables (uidx, umask, ushl, didx, dmask, dshr) are the ones
// dense.py:_subset_maps builds, computed here from j and k.
//
// What bounds it on this card: not device memory — a history's inputs are
// 4 + 6C bytes per event (52 B at C = 8), read once.  The work is integer
// ops on shared memory plus about four block barriers per event, serial
// over the E events of one history; that chain of dependent passes is the
// limit.  The design answers it with many small independent blocks: one
// block per history keeps D (at most 32 x 128 words, 16 KB, double
// buffered) in shared memory for the whole scan, a block is as wide as D
// has words (64 threads at the flagship V = 8, C = 8), so an SM holds many
// histories at once and hides one block's barriers behind the others'
// work.  Padding events are skipped and a block stops at the first failed
// event: both are exact, because the reference keeps D on a padding event
// and never changes failed_at once a history is done.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 12;
constexpr int kMaxV = 32;
constexpr int kMaxThreads = 256;

// op codes (jepsen_tpu_torch/ops/step_kernels.py)
constexpr int F_WRITE = 1;
constexpr int F_CAS = 2;
constexpr int F_READ_ANY = 3;
constexpr int F_ACQUIRE = 4;
constexpr int F_RELEASE = 5;

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

__global__ void dense_automaton_kernel(
    const int32_t* __restrict__ init_state, const int32_t* __restrict__ ev_slot,
    const int8_t* __restrict__ cand_slot, const int8_t* __restrict__ cand_f,
    const int16_t* __restrict__ cand_a, const int16_t* __restrict__ cand_b,
    uint8_t* __restrict__ ok, int32_t* __restrict__ failed_at,
    uint8_t* __restrict__ overflow, int E, int C, int V) {
  extern __shared__ uint32_t smem[];
  const int log_w = C > 5 ? C - 5 : 0;
  const int W = 1 << log_w;
  const int VW = V * W;
  uint32_t* cur = smem;                // D, [V][W]
  uint32_t* nxt = smem + VW;           // the next D, [V][W]
  uint32_t* src = smem + 2 * VW;       // source-value masks, [C][V]
  int32_t* lane = reinterpret_cast<int32_t*>(src + C * V);  // [4][C]

  const int row = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t ev_base = static_cast<int64_t>(row) * E;
  const uint32_t all_v = V >= 32 ? 0xFFFFFFFFu : ((1u << V) - 1u);

  // one config: the initial value (clamped into the domain, as the
  // reference's dynamic_update_index_in_dim clamps), empty linset
  int s0 = init_state[row];
  s0 = s0 < 0 ? 0 : (s0 >= V ? V - 1 : s0);
  for (int w = t; w < VW; w += nt) cur[w] = (w == s0 * W) ? 1u : 0u;
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

    // T[j][v'][v] as a V-bit mask over v, per (j, v')
    for (int i = t; i < C * V; i += nt) {
      const int j = i / V;
      const int vp = i - j * V;
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
      uint32_t m = 0;
      if (active) {
        const bool acq = f == F_ACQUIRE;
        const bool rel = f == F_RELEASE;
        const int a_eff = acq ? 0 : (rel ? 1 : a);
        const int b_eff = acq ? 1 : (rel ? 0 : b);
        const bool a_in = a_eff >= 0 && a_eff < V;
        if (f == F_WRITE) {
          m = vp == a_eff ? all_v : 0u;
        } else if (f == F_READ_ANY) {
          m = 1u << vp;
        } else if (f == F_CAS || acq || rel) {
          m = (vp == b_eff && a_in) ? (1u << a_eff) : 0u;
        } else {  // read (and any code the register family never emits)
          m = (vp == a_eff && a_in) ? (1u << a_eff) : 0u;
        }
      }
      src[i] = m;
    }
    __syncthreads();

    // closure to fixpoint, Jacobi passes capped at C + 2
    for (int pass = 0; pass < C + 2; ++pass) {
      int changed = 0;
      for (int w = t; w < VW; w += nt) {
        const int vp = w >> log_w;
        const int k = w & (W - 1);
        uint32_t add = 0;
        for (int j = 0; j < C; ++j) {
          uint32_t m = src[j * V + vp];
          if (m == 0u) continue;
          int kk = k;
          uint32_t um;
          int shl;
          if (j < 5) {
            um = lo_mask(j);
            shl = 1 << j;
          } else {
            const int wb = 1 << (j - 5);
            kk = k ^ wb;
            um = (k & wb) ? 0xFFFFFFFFu : 0u;
            shl = 0;
            if (um == 0u) continue;
          }
          uint32_t x = 0;
          while (m) {
            const int v = __ffs(m) - 1;
            m &= m - 1;
            x |= cur[v * W + kk];
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
    for (int w = t; w < VW; w += nt) {
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

}  // namespace

// Launch over B histories on `stream`; returns cudaGetLastError() after the
// launch (0 on success).  Shapes: init_state [B] int32, ev_slot [B, E] int32,
// cand_slot/cand_f [B, E, C] int8, cand_a/cand_b [B, E, C] int16, all
// contiguous; ok/overflow [B] uint8 (torch.bool), failed_at [B] int32.
extern "C" int dense_automaton_launch(
    const void* init_state, const void* ev_slot, const void* cand_slot,
    const void* cand_f, const void* cand_a, const void* cand_b, void* ok,
    void* failed_at, void* overflow, int B, int E, int C, int V,
    void* stream) {
  if (B == 0) return 0;
  if (B < 0 || E < 0 || C < 1 || C > kMaxC || V < 1 || V > kMaxV) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int W = C > 5 ? 1 << (C - 5) : 1;
  const int VW = V * W;
  int threads = ((VW + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t shmem =
      (2 * static_cast<size_t>(VW) + static_cast<size_t>(C) * V) *
          sizeof(uint32_t) +
      4 * static_cast<size_t>(C) * sizeof(int32_t);
  dense_automaton_kernel<<<B, threads, shmem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(init_state),
      static_cast<const int32_t*>(ev_slot),
      static_cast<const int8_t*>(cand_slot),
      static_cast<const int8_t*>(cand_f),
      static_cast<const int16_t*>(cand_a),
      static_cast<const int16_t*>(cand_b), static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(failed_at), static_cast<uint8_t*>(overflow), E, C,
      V);
  return static_cast<int>(cudaGetLastError());
}
