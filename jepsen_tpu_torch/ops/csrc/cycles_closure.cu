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
//     (lane j at word j / 32, bit j % 32), and the epilogue reads bits
//     out of the closed rows.
//
// The closure.  A round is r <- r | r.r in the boolean semiring: row i
// gains row k for every set bit k of row i.  Each round reads only the
// previous round's rows (Jacobi), as the reference squares the whole
// stack at once, so the per-plane count of rounds until a fixpoint is the
// reference's.  A plane stops at its first unchanged round in both modes
// (later rounds are the identity); in "earlyexit" that round goes into a
// per-family atomicMax and a last launch writes the dispatch-wide count
// the reference reports, min(ladder, max over planes), summed over the
// filter and lifted families.  In "fixed" mode the count is the ladder
// length, known before the launch: the kernel writes it, and there is no
// memset and no second launch.
//
// Three designs, by plane size.
//
// 1. Warp (has-cycle, n <= kHasCycleWarpMaxN = 32, the rw-register
//    version graphs at n = 16).  A lane holds one row in a register and
//    a warp floor(32 / n) planes.  A round ORs in, for every set bit k,
//    __shfl_sync(row, k): every lane reads the old rows, so the round is
//    exact Jacobi, with no shared memory and no barrier.  A ballot over a
//    plane's lanes gives its first unchanged round.  Bound: bytes (the
//    input is read once, 16 bytes a load) and, at the version graphs'
//    size, the launch itself; the design keeps one launch in "fixed"
//    mode and one atomicMax a block in "earlyexit".
//
// 2. Double (planes of up to kDoubleMaxN = 512 rows: every filter plane
//    of the screen, the screen's reduced queries below, has-cycle at
//    64 <= n <= 512).  Two copies of the plane in shared memory (64 KB at
//    n = 512: three blocks an SM); round t reads r_t from one and writes
//    r_{t+1} into the other, so there is one barrier a round and nothing
//    staged in registers.  Semi-naive: row i ORs in row k only for k in
//    r_t[i] & (D_t[i] | C_t), with D_t[i] = r_t[i] & ~r_{t-1}[i] (read
//    from the copy about to be overwritten, by the warp that owns row i,
//    before it writes) and C_t the n-bit mask of rows that changed in
//    round t - 1 (ballots during the writes); any other k was in
//    r_{t-1}[i] with an unchanged row, so it was OR-ed in already.  Round
//    1 takes every bit; a row with nothing to OR in is skipped (its two
//    copies are equal).  The round's rows are the full Jacobi round's,
//    so the per-plane round count, and "earlyexit", stay exact.  Warps
//    take rows from a shared counter, so a dense row no longer sets the
//    round's length for a whole lane group: a row gets two subgroups of
//    W lanes that split its set bits by parity (rows k and k + 1 start
//    2 W banks apart: the two loads of a step never share a bank), and a
//    warp takes 32 / (2 W) rows at once (one at n = 512, sixteen at
//    n = 32), so a small plane's round is not a chain of single rows.  A
//    row visits only the words of its iteration set that hold a bit (a
//    ballot), and the set-bit loop takes four bits an iteration, so four
//    independent loads are in flight.  Bound: operations (one OR a set
//    bit a word, the semi-naive count of
//    jepsen_tpu_torch.ops.cycles.semi_naive_closure); the final
//    unchanged round costs about as much as C_t is large.
//
// 3. Single (has-cycle at n = 1024, and the 2n lifted planes of the
//    "earlyexit" screen: 128 KB, no room for a second copy).  One copy;
//    a group of W lanes owns a row and keeps its new words in registers
//    until a block barrier (the parent's routine, close_plane).
//
// The reduced screen ("fixed" mode, CYCLES_REDUCED_LIFTED).  A walk
// query (want, rest) asks, for each vertex v, for a want edge v -> j and
// a path from (j, 1) back to (v, 0) in the lifted graph.  With
// Wn = rel & want, Rs = rel & rest and the n-vertex plane
// M = Rs | Wn.Rs (a path between state-0 vertices is a chain of "rest"
// and "want then rest" steps), walk[v] = exists k: (Wn.Rs)[v, k] and
// (k = v or M+[k, v]).  The kernel packs Wn into one copy and Rs into
// the other in one pass over the relation bytes, builds M in place of Wn
// (one OR of an Rs row per want bit), closes M with design 2, packs Rs
// again into the copy the closure left free and reads the walks out with
// one bit test per set bit of Wn.Rs, recomputed from the want bytes (a
// third 32 KB plane would cost a block an SM).  Every plane of a
// fixed-mode screen is then n x n: 32 KB at n = 512 instead of the lifted
// plane's 128 KB, and its closure does about a fifth of the lifted
// squaring's work.  In "earlyexit" the lifted family's count is the first
// unchanged round of the 2n plane, which M does not give, so that mode
// keeps the lifted planes on design 3.

#include <cuda_runtime.h>
#include <stdint.h>

// 1: "fixed" screens close each walk query as the n-vertex plane M;
// 0: as the 2n lifted plane (the A/B variant).
#ifndef CYCLES_REDUCED_LIFTED
#define CYCLES_REDUCED_LIFTED 1
#endif

namespace {

constexpr int MAX_PLANE = 1024;
constexpr int MAX_F = 8;
constexpr int MAX_Q = 4;
constexpr unsigned FULL = 0xffffffffu;
// has-cycle's designs by n: warp up to kHasCycleWarpMaxN, double up to
// kDoubleMaxN, single past it
constexpr int kHasCycleWarpMaxN = 32;
constexpr int kDoubleMaxN = 512;
constexpr int kWarpDesignThreads = 128;
constexpr int kDoubleMaxThreads = 512;

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

// Threads of a design-2 block over n rows: 4 to 16 warps.
int double_threads(int n) {
  return n < 128 ? 128 : (n > kDoubleMaxThreads ? kDoubleMaxThreads : n);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// K8 prologue (design 3, and relations not 16-byte aligned): row i, word
// u of a plane over an n x n byte matrix: bit l = (rel[i][32u + l] & mask)
// != 0.  One warp per word.
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

// 16 bytes from p: one 16-byte load where p allows it.
__device__ __forceinline__ uint4 load16(const uint8_t* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[q] = p[4 * q] | (uint32_t)p[4 * q + 1] << 8 |
           (uint32_t)p[4 * q + 2] << 16 | (uint32_t)p[4 * q + 3] << 24;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bit b set iff byte b of x is nonzero (b < 4).
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return (x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u);
}

// Bit b set iff byte b of v has a bit of mask (b < 16).
__device__ __forceinline__ uint32_t mask16(uint4 v, unsigned mask) {
  const uint32_t m4 = mask * 0x01010101u;
  return nonzero_bytes(v.x & m4) | nonzero_bytes(v.y & m4) << 4 |
         nonzero_bytes(v.z & m4) << 8 | nonzero_bytes(v.w & m4) << 12;
}

// K8 prologue (designs 2 and the reduced screen) for 16-byte aligned
// relations: the n x n plane of `mask` bits of a into P (and of `mask2`
// bits into P2, if not null), 16 bytes a lane and four loads in flight;
// neighbouring lanes hold the two halves of a word.  n >= 32, so chunks
// is a multiple of 64 and a warp's lanes run the same iterations.
// Unaligned relations take load_filter (pack_any).
__device__ void pack_plane(uint32_t* P, const uint8_t* a, int n,
                           unsigned mask, uint32_t* P2 = nullptr,
                           unsigned mask2 = 0) {
  const int chunks = n * n / 16, step = blockDim.x;
  const uint4* src = reinterpret_cast<const uint4*>(a);
  for (int c0 = threadIdx.x; c0 < chunks; c0 += 4 * step) {
    uint4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j * step < chunks) v[j] = src[c0 + j * step];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j * step;
      if (c >= chunks) break;
      const uint32_t m = mask16(v[j], mask);
      const uint32_t hi = __shfl_down_sync(FULL, m, 1);
      if (!(c & 1)) P[c >> 1] = m | hi << 16;
      if (P2 != nullptr) {
        const uint32_t m2 = mask16(v[j], mask2);
        const uint32_t hi2 = __shfl_down_sync(FULL, m2, 1);
        if (!(c & 1)) P2[c >> 1] = m2 | hi2 << 16;
      }
    }
  }
}

// The n x n plane of `mask` bits of a (W words a row), whatever a's
// alignment.
__device__ void pack_any(uint32_t* P, const uint8_t* a, int n, int W,
                         unsigned mask, bool aligned) {
  if (aligned) pack_plane(P, a, n, mask);
  else load_filter(P, a, n, W, mask);
}

// Word u of the `mask` bits of an n-byte row sits in lane 2u of the
// result (one 16-byte load a lane).
__device__ __forceinline__ uint32_t row_words(const uint8_t* row, int n,
                                              unsigned mask, bool aligned) {
  const int lane = threadIdx.x & 31;
  const uint32_t m = lane * 16 < n ? mask16(load16(row + 16 * lane, aligned),
                                            mask)
                                   : 0u;
  return m | __shfl_down_sync(FULL, m, 1) << 16;
}

// ---------------------------------------------------------------------------
// design 3: one copy, the Jacobi round staged in registers
// ---------------------------------------------------------------------------

// Close a plane of `rows` rows x W words in place; returns (the same in
// every thread) the first round that changed nothing, or R if every round
// changed it.
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

// ---------------------------------------------------------------------------
// design 2: two copies, semi-naive rounds, rows handed out by a counter
// ---------------------------------------------------------------------------

// Beside the two copies: three n-bit masks of changed rows and three row
// counters, rotated by round.  Round t reads set t % 3, builds set
// (t + 1) % 3 and clears set (t + 2) % 3, which no thread touches in
// round t (it was last read in round t - 1, before that round's barrier).
struct __align__(16) RoundState {
  uint32_t changed[3][kDoubleMaxN / 32];
  int next_row[3];
};

// The bits b = g mod G of a word (G = 32 / W subgroups of a warp that
// works on one row of Wn.Rs, in the reduced screen's product): subgroup
// g's share of the row's set bits.  Rows k = g mod G start at bank
// (k W) % 32 = g W, so the subgroups' loads never share a bank.
template <int W>
__device__ __forceinline__ uint32_t subgroup_bits(int g) {
  constexpr int G = 32 / W;
  return (uint32_t)(0xffffffffull / ((1ull << G) - 1)) << g;
}

// acc | word w of every row base + k of P for the set bits k of `bits`,
// four bits an iteration (a missing one repeats the first: same value).
template <int W>
__device__ __forceinline__ uint32_t or_rows(const uint32_t* P, uint32_t bits,
                                            int base, int w, uint32_t acc) {
  while (bits) {
    int k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      k[j] = bits ? base + __ffs(bits) - 1 : k[0];
      bits &= bits - 1;
    }
    acc |= (P[k[0] * W + w] | P[k[1] * W + w]) |
           (P[k[2] * W + w] | P[k[3] * W + w]);
  }
  return acc;
}

// OR of the subgroups' accumulators: every lane then holds word lane % W.
template <int W>
__device__ __forceinline__ uint32_t or_subgroups(uint32_t acc) {
#pragma unroll
  for (int off = W; off < 32; off <<= 1)
    acc |= __shfl_xor_sync(FULL, acc, off);
  return acc;
}

// Design 2's lanes.  A row takes L lanes: G = 8 subgroups of S = W / V
// lanes, each lane holding V = min(W, 4) consecutive words of the row
// (one 16-byte load at W >= 4).  Subgroup g takes the bits b = g + 8m
// (m < 4) of every word of the row's iteration set: it tests its four
// positions and loads the rows whose bit is set, so no lane extracts bit
// indices and a word costs the same few instructions however many bits
// it holds.  Rows k = g mod 8 start at bank (k W) % 32: the subgroups in
// one quarter-warp (the unit a 16-byte load is served in) never share a
// bank.  A warp takes H = 32 / L rows at once: one at W = 16, four at
// W <= 4, so a small plane's round is not a chain of single rows.
template <int W>
struct RowLanes {
  static constexpr int V = W < 4 ? W : 4;
  static constexpr int S = W / V;
  static constexpr int L = 8 * S;
  static constexpr int H = 32 / L;
};

// V consecutive words, loaded and stored with one vector access.
template <int V>
struct Words {
  uint32_t w[V];
};

template <int V>
__device__ __forceinline__ Words<V> load_words(const uint32_t* p) {
  Words<V> r;
  if constexpr (V == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    r.w[0] = q.x, r.w[1] = q.y, r.w[2] = q.z, r.w[3] = q.w;
  } else if constexpr (V == 2) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    r.w[0] = q.x, r.w[1] = q.y;
  } else {
    r.w[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_words(uint32_t* p, const Words<V>& r) {
  if constexpr (V == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  else
    *p = r.w[0];
}

// Close the plane in A (rows x W words, W <= 16, rows = 32 W) using B as
// the second copy; returns the first round that changed nothing (or R)
// and sets *out to the copy that holds the closure.  Whole warps only.
template <int W>
__device__ int close_plane2(uint32_t* A, uint32_t* B, RoundState& st,
                            int rows, int R, uint32_t** out) {
  constexpr int V = RowLanes<W>::V, S = RowLanes<W>::S;
  constexpr int L = RowLanes<W>::L, H = RowLanes<W>::H;
  const int lane = threadIdx.x & 31;
  const int lead = lane & ~(L - 1);  // the row group's first lane
  const int g = (lane - lead) / S;   // the lane's subgroup
  const int off = lane % S * V;      // its first word of a row
  const uint32_t group = (uint32_t)((1ull << L) - 1) << lead;
  const int cw = rows >> 5;
  for (int i = threadIdx.x; i < cw; i += blockDim.x) st.changed[2][i] = 0;
  if (threadIdx.x == 0) st.next_row[1] = 0;
  __syncthreads();
  uint32_t* cur = A;
  uint32_t* nxt = B;
  for (int t = 1; t <= R; ++t) {
    const uint32_t* cc = st.changed[t % 3];
    uint32_t* cn = st.changed[(t + 1) % 3];
    for (int i = threadIdx.x; i < cw; i += blockDim.x)
      st.changed[(t + 2) % 3][i] = 0;
    if (threadIdx.x == 0) st.next_row[(t + 1) % 3] = 0;
    // row 32 u + g + 8 m, the lane's words, is mine + (32 u + 8 m) W
    const uint32_t* mine = cur + g * W + off;
    bool changed = false;
    for (;;) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&st.next_row[t % 3], H);
      base = __shfl_sync(FULL, base, 0);
      if (base >= rows) break;
      const int i = base + lane / L;  // rows is a multiple of H
      const Words<V> x = load_words<V>(cur + i * W + off);
      Words<V> s = x;
      if (t > 1) {
        const Words<V> y = load_words<V>(nxt + i * W + off);
        const Words<V> c = load_words<V>(cc + off);
#pragma unroll
        for (int j = 0; j < V; ++j)
          s.w[j] = x.w[j] & ((x.w[j] & ~y.w[j]) | c.w[j]);
      }
      bool holds = false;
#pragma unroll
      for (int j = 0; j < V; ++j) holds |= s.w[j] != 0;
      // the chunks (V words, lane lead + c) that hold a bit in any of the
      // warp's rows: the loop below visits only those
      const uint32_t live = __ballot_sync(FULL, holds);
      uint32_t chunks = 0;
#pragma unroll
      for (int h = 0; h < H; ++h)
        chunks |= (live >> (h * L)) & ((1u << S) - 1);
      Words<V> acc = x;
      while (chunks) {
        const int c = __ffs(chunks) - 1;
        chunks &= chunks - 1;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const uint32_t bits = __shfl_sync(FULL, s.w[j], lead + c) >> g;
          if (!(bits & 0x01010101u)) continue;
          const uint32_t* q = mine + (c * V + j) * 32 * W;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            if (!((bits >> (8 * m)) & 1u)) continue;
            const Words<V> r = load_words<V>(q + 8 * m * W);
#pragma unroll
            for (int k = 0; k < V; ++k) acc.w[k] |= r.w[k];
          }
        }
      }
      // OR of the row's 8 subgroups
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int d = S; d < L; d <<= 1)
          acc.w[j] |= __shfl_xor_sync(FULL, acc.w[j], d);
      // an empty set (after round 1): r_{t+1}[i] = r_t[i] = r_{t-1}[i],
      // already in nxt
      const bool run = t == 1 || (live & group);
      if (run && g == 0) store_words<V>(nxt + i * W + off, acc);
      bool moved = false;
#pragma unroll
      for (int j = 0; j < V; ++j) moved |= acc.w[j] != x.w[j];
      if (__ballot_sync(FULL, moved) & group) {
        changed = true;
        if (lane == lead) atomicOr(&cn[i >> 5], 1u << (i & 31));
      }
    }
    const bool any = __syncthreads_or(changed);
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
    if (!any) {
      *out = cur;
      return t;
    }
  }
  *out = cur;
  return R;
}

// The OR of the rows of Rs over the set bits of a row held a word a lane
// (word u in lane S u, S = 1 or 2; every other lane holds 0): lane l
// returns word l % W.  The warp visits only the words that hold a bit.
template <int W, int S>
__device__ uint32_t or_rows_of(const uint32_t* Rs, uint32_t words) {
  const int lane = threadIdx.x & 31, w = lane % W;
  const uint32_t mine = subgroup_bits<W>(lane / W);
  uint32_t live = __ballot_sync(FULL, words != 0);
  uint32_t acc = 0;
  while (live) {
    const int src = __ffs(live) - 1;
    live &= live - 1;
    acc = or_rows<W>(Rs, __shfl_sync(FULL, words, src) & mine, src / S * 32,
                     w, acc);
  }
  return or_subgroups<W>(acc);
}

// walks[v] of one (want, rest) query over the n x n relation a, on the
// reduced plane M = Rs | Wn.Rs; both copies A and B are free on entry.
template <int W>
__device__ void reduced_query(uint32_t* A, uint32_t* B, RoundState& st,
                              const uint8_t* a, int n, unsigned want,
                              unsigned rest, int R, bool aligned,
                              uint8_t* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, w = lane % W;
  const uint32_t mine = subgroup_bits<W>(lane / W);
  // Wn into A, Rs into B; then M's rows in place of Wn's, each by the
  // warp that reads it
  if (aligned) {
    pack_plane(A, a, n, want, B, rest);
  } else {
    load_filter(A, a, n, W, want);
    load_filter(B, a, n, W, rest);
  }
  __syncthreads();
  for (int v = warp; v < n; v += nw) {
    const uint32_t hop = or_rows_of<W, 1>(B, lane < W ? A[v * W + w] : 0u);
    if (lane < W) A[v * W + w] = B[v * W + w] | hop;
  }
  __syncthreads();
  uint32_t* C;
  close_plane2<W>(A, B, st, n, R, &C);
  uint32_t* Rs = C == A ? B : A;
  pack_any(Rs, a, n, W, rest, aligned);
  __syncthreads();
  for (int v = warp; v < n; v += nw) {
    // (Wn.Rs)[v], recomputed from rel row v's want bytes
    const uint32_t wn = row_words(a + (size_t)v * n, n, want, aligned);
    uint32_t bits = or_rows_of<W, 2>(Rs, lane & 1 ? 0u : wn) & mine;
    bool hit = false;
    while (bits) {
      const int k = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      hit |= k == v || bit_of(C, W, k, v);
    }
    hit = __any_sync(FULL, hit);
    if (lane == 0) out[v] = hit;
  }
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// Design 1: has-cycle of N-vertex planes (N = 16 or 32), a row a lane.
template <int N>
__device__ __forceinline__ uint32_t load_row(const uint8_t* src,
                                             bool aligned) {
  uint32_t bits = 0;
#pragma unroll
  for (int h = 0; h < N / 16; ++h)
    bits |= mask16(load16(src + 16 * h, aligned), 0xffu) << (16 * h);
  return bits;
}

// jt: ptxas(regs<=31, spill<=0, smem<=16)
template <int N>
__global__ void __launch_bounds__(kWarpDesignThreads)
has_cycle_warp_kernel(const uint8_t* adj, uint8_t* flags, uint8_t* closure,
                      int32_t* rounds, int B, int R, int* round_max,
                      bool aligned) {
  constexpr int PW = 32 / N;  // planes a warp
  __shared__ int warp_max[kWarpDesignThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / N, r = lane % N;
  const long long p =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * PW + sub;
  const bool live = p < B;
  const uint32_t plane_lanes =
      N == 32 ? FULL : ((1u << N) - 1) << (sub * N);
  uint32_t row = live ? load_row<N>(adj + ((size_t)p * N + r) * N, aligned)
                      : 0u;
  int first = live ? R : 0;  // the first unchanged round, R if none
  bool open = live;
  for (int t = 1; t <= R && __any_sync(FULL, open); ++t) {
    const int m = __reduce_max_sync(FULL, open ? __popc(row) : 0u);
    uint32_t acc = row, bits = open ? row : 0u;
    for (int it = 0; it < m; ++it) {
      // no bit left: the lane's own row, which acc holds already
      const int k = bits ? __ffs(bits) - 1 : r;
      bits &= bits - 1;
      acc |= __shfl_sync(FULL, row, sub * N + k);
    }
    const unsigned moved = __ballot_sync(FULL, acc != row) & plane_lanes;
    if (open && !moved) {
      first = t;
      open = false;
    }
    row = acc;
  }
  const bool diag = __ballot_sync(FULL, (row >> r) & 1u) & plane_lanes;
  if (live && r == 0) {
    flags[p] = diag;
    if (round_max == nullptr) rounds[p] = R;
  }
  if (closure != nullptr && live) {
    uint8_t* out = closure + ((size_t)p * N + r) * N;
#pragma unroll
    for (int h = 0; h < N / 16; ++h) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t b4 = row >> (16 * h + 4 * q);
        w[q] = (b4 & 1u) | (b4 >> 1 & 1u) << 8 | (b4 >> 2 & 1u) << 16 |
               (b4 >> 3 & 1u) << 24;
      }
      if (aligned) {
        *reinterpret_cast<uint4*>(out + 16 * h) =
            make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        for (int j = 0; j < 16; ++j)
          out[16 * h + j] = (w[j >> 2] >> (8 * (j & 3))) & 1u;
      }
    }
  }
  if (round_max != nullptr) {
    const int wm = __reduce_max_sync(FULL, first);
    if (lane == 0) warp_max[warp] = wm;
    __syncthreads();
    if (threadIdx.x == 0) {
      int m = 0;
      for (int i = 0; i < (int)(blockDim.x >> 5); ++i)
        m = max(m, warp_max[i]);
      atomicMax(round_max, m);
    }
  }
}

// Flags, round count and the optional closure of a has-cycle block's
// closed plane C (designs 2 and 3).
__device__ void has_cycle_epilogue(const uint32_t* C, int W, int n, int R,
                                   int first, uint8_t* flags,
                                   uint8_t* closure, int32_t* rounds,
                                   int* round_max) {
  bool diag = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) diag |= bit_of(C, W, i, i);
  diag = __syncthreads_or(diag);
  if (threadIdx.x == 0) {
    flags[blockIdx.x] = diag;
    if (round_max != nullptr) atomicMax(round_max, first);
    else rounds[blockIdx.x] = R;
  }
  if (closure != nullptr) {
    uint8_t* out = closure + (size_t)blockIdx.x * n * n;
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
      out[idx] = bit_of(C, W, idx / n, idx % n);
  }
}

// Design 2: has-cycle at 64 <= n <= 512, a plane a block.
// jt: ptxas(regs<=40, spill<=0, smem<=208)
template <int W>
__global__ void __launch_bounds__(kDoubleMaxThreads, 3)
has_cycle_double_kernel(const uint8_t* adj, uint8_t* flags, uint8_t* closure,
                        int32_t* rounds, int n, int R, int* round_max,
                        bool aligned) {
  extern __shared__ uint32_t smem[];
  __shared__ RoundState st;
  pack_any(smem, adj + (size_t)blockIdx.x * n * n, n, W, 0xffu, aligned);
  __syncthreads();
  uint32_t* C;
  const int first = close_plane2<W>(smem, smem + n * W, st, n, R, &C);
  has_cycle_epilogue(C, W, n, R, first, flags, closure, rounds, round_max);
}

// Design 3: has-cycle at n = 1024, a plane a block.
// jt: ptxas(regs<=64, spill<=484, smem<=0)
template <int W>
__global__ void __launch_bounds__(1024)
has_cycle_kernel(const uint8_t* adj, uint8_t* flags, uint8_t* closure,
                 int32_t* rounds, int n, int R, int* round_max) {
  extern __shared__ uint32_t P[];
  load_filter(P, adj + (size_t)blockIdx.x * n * n, n, W, 0xffu);
  __syncthreads();
  const int first = close_plane<W>(P, n, R);
  has_cycle_epilogue(P, W, n, R, first, flags, closure, rounds, round_max);
}

// Design 2 over a screen's n-vertex planes: block (b, p) closes graph b's
// filter plane p < F, whose diagonal is members[b, p] (the closure is
// transitive, so "some j with c[v, j] and c[j, v]" is its diagonal), or
// its reduced walk query p - F.  In "fixed" mode (rounds non-null) block
// (b, 0) writes the ladder length `total`.
// The main path's n 512 instance, then every other one:
// jt: ptxas(W=16: regs<=40, spill<=312, smem<=208)
// jt: ptxas(regs<=40, spill<=360, smem<=208)
template <int W>
__global__ void __launch_bounds__(kDoubleMaxThreads, 3)
screen_kernel(const uint8_t* rel, uint8_t* members, uint8_t* walks,
              int32_t* rounds, Profile prof, int planes, int n, int R,
              int* round_max, int total, bool aligned) {
  extern __shared__ uint32_t smem[];
  __shared__ RoundState st;
  uint32_t* A = smem;
  uint32_t* B = smem + n * W;
  const int b = blockIdx.x / planes, p = blockIdx.x % planes;
  const uint8_t* a = rel + (size_t)b * n * n;
  if (p < prof.F) {
    pack_any(A, a, n, W, prof.masks[p], aligned);
    __syncthreads();
    uint32_t* C;
    const int first = close_plane2<W>(A, B, st, n, R, &C);
    uint8_t* out = members + ((size_t)b * prof.F + p) * n;
    for (int v = threadIdx.x; v < n; v += blockDim.x)
      out[v] = bit_of(C, W, v, v);
    if (round_max != nullptr && threadIdx.x == 0) atomicMax(round_max, first);
  } else {
    const int q = p - prof.F;
    reduced_query<W>(A, B, st, a, n, prof.want[q], prof.rest[q], R, aligned,
                     walks + ((size_t)b * prof.Q + q) * n);
  }
  if (rounds != nullptr && p == 0 && threadIdx.x == 0) rounds[b] = total;
}

// Design 3 over the lifted planes ("earlyexit", or CYCLES_REDUCED_LIFTED
// 0): walks[b, q, v] = exists j: (rel[b][v][j] & want) and c[n + j, v],
// from the lifted closure's (state 1 -> state 0) quadrant; a warp per
// vertex.
// jt: ptxas(regs<=64, spill<=400, smem<=0)
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
// jt: ptxas(regs<=12, spill<=0, smem<=0)
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

template <int N>
cudaError_t launch_has_cycle_warp(const uint8_t* adj, uint8_t* flags,
                                  uint8_t* closure, int32_t* rounds, int B,
                                  int R, int* round_max, cudaStream_t s) {
  constexpr int per_block = kWarpDesignThreads / 32 * (32 / N);
  const bool aligned =
      aligned16(adj) && (closure == nullptr || aligned16(closure));
  has_cycle_warp_kernel<N><<<(B + per_block - 1) / per_block,
                             kWarpDesignThreads, 0, s>>>(
      adj, flags, closure, rounds, B, R, round_max, aligned);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_has_cycle_double(const uint8_t* adj, uint8_t* flags,
                                    uint8_t* closure, int32_t* rounds, int B,
                                    int n, int R, int* round_max,
                                    cudaStream_t s) {
  const size_t smem = (size_t)2 * n * W * sizeof(uint32_t);
  cudaError_t err = allow_smem(has_cycle_double_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  has_cycle_double_kernel<W><<<B, double_threads(n), smem, s>>>(
      adj, flags, closure, rounds, n, R, round_max, aligned16(adj));
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_has_cycle(const uint8_t* adj, uint8_t* flags,
                             uint8_t* closure, int32_t* rounds, int B, int n,
                             int R, int* round_max, cudaStream_t s) {
  const size_t smem = (size_t)n * W * sizeof(uint32_t);
  cudaError_t err = allow_smem(has_cycle_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  has_cycle_kernel<W><<<B, block_threads(n, W), smem, s>>>(
      adj, flags, closure, rounds, n, R, round_max);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_screen(const uint8_t* rel, uint8_t* members,
                          uint8_t* walks, int32_t* rounds,
                          const Profile& prof, int B, int n, int planes,
                          int R, int* round_max, int total, cudaStream_t s) {
  const size_t smem = (size_t)2 * n * W * sizeof(uint32_t);
  cudaError_t err = allow_smem(screen_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  screen_kernel<W><<<B * planes, double_threads(n), smem, s>>>(
      rel, members, walks, rounds, prof, planes, n, R, round_max, total,
      aligned16(rel));
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

// The W template of a design-3 plane of `rows` rows (a power of two,
// 64 <= rows <= 1024).
#define DISPATCH_W(rows, CALL)                 \
  switch ((rows) / 32) {                       \
    case 2: err = CALL(2); break;              \
    case 4: err = CALL(4); break;              \
    case 8: err = CALL(8); break;              \
    case 16: err = CALL(16); break;            \
    case 32: err = CALL(32); break;            \
    default: err = cudaErrorInvalidValue;      \
  }

// The W template of a design-2 plane of `rows` rows (32 <= rows <= 512).
#define DISPATCH_DOUBLE(rows, CALL)            \
  switch ((rows) / 32) {                       \
    case 1: err = CALL(1); break;              \
    case 2: err = CALL(2); break;              \
    case 4: err = CALL(4); break;              \
    case 8: err = CALL(8); break;              \
    case 16: err = CALL(16); break;            \
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
  cudaError_t err = cudaSuccess;
  int* round_max = nullptr;
  if (early) {
    // the dispatch-wide maximum exists only once every block has ended:
    // a zeroed word, then a second launch
    err = cudaMemsetAsync(scratch, 0, sizeof(int32_t), s);
    if (err != cudaSuccess) return err;
    round_max = scratch;
  }
  const int R = closure_rounds(n);
  if (n <= kHasCycleWarpMaxN) {
    err = n == 16 ? launch_has_cycle_warp<16>(adj, flags, closure, rounds, B,
                                              R, round_max, s)
                  : launch_has_cycle_warp<32>(adj, flags, closure, rounds, B,
                                              R, round_max, s);
  } else if (n <= kDoubleMaxN) {
#define HAS_CYCLE2(Wt)                                                   \
  launch_has_cycle_double<Wt>(adj, flags, closure, rounds, B, n, R,      \
                              round_max, s)
    DISPATCH_DOUBLE(n, HAS_CYCLE2)
#undef HAS_CYCLE2
  } else {
    err = launch_has_cycle<32>(adj, flags, closure, rounds, B, n, R,
                               round_max, s);
  }
  if (err != cudaSuccess || !early) return err;
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
  const bool reduced = !early && CYCLES_REDUCED_LIFTED;
  const int R = F ? closure_rounds(n) : 0;
  const int R2 = Q ? closure_rounds(2 * n) : 0;
  const int planes = F + (reduced ? Q : 0);  // design-2 planes a graph
  const bool lifted = Q > 0 && !reduced;
  cudaError_t err = cudaSuccess;
  if (early || lifted) {
    err = cudaMemsetAsync(scratch, 0, 2 * sizeof(int32_t), s);
    if (err != cudaSuccess) return err;
  }
  if (planes) {
#define SCREEN(Wt)                                                        \
  launch_screen<Wt>(rel, members, walks, early ? nullptr : rounds, prof, \
                    B, n, planes, closure_rounds(n),                     \
                    early ? scratch : nullptr, R + R2, s)
    DISPATCH_DOUBLE(n, SCREEN)
#undef SCREEN
    if (err != cudaSuccess) return err;
  }
  if (lifted) {
#define LIFTED(Wt) \
  launch_lifted<Wt>(rel, walks, prof, B, n, R2, scratch + 1, s)
    DISPATCH_W(2 * n, LIFTED)
#undef LIFTED
    if (err != cudaSuccess) return err;
  }
  if (!early && planes) return cudaSuccess;
  rounds_kernel<<<(B + 255) / 256, 256, 0, s>>>(rounds, B, scratch, R, R2,
                                                 early);
  return cudaGetLastError();
}

}  // extern "C"
