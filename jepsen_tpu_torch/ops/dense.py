"""Dense subset-automaton linearizability checker — the port of
:mod:`jepsen_tpu.ops.dense` (``build_dense``: the register, cas-register,
mutex and owner-mutex transitions, and the reentrant-mutex,
acquired-permits and multi-register branches; ``build_dense_queue``: the
unordered queue).

For models whose state enumerates to a small integer domain there is a
representation with no frontier to overflow:

    D[s, k] = 1  iff some linearization order of the ops in subset ``k``
              (of the ≤C currently-open slots) takes the model from the
              promoted prefix to state ``s``.

``D`` is bit-packed along the subset axis into 32-bit words.  Per event
every open slot's transition is built from its op codes; in every family
it is a partial function of the source state (each source has at most
one target), so it is kept as ``tgt[j, s]`` (−1: no move):

- register family (register, cas-register; mutex ops are cas(0 → 1) and
  cas(1 → 0), owner-mutex ops arrive as cas codes): read keeps state a,
  write sends every state to a, cas moves a to b, read-any is the
  identity;
- reentrant mutex (K1r): over {0 free, 2c−1 once, 2c twice}, acquire
  0 → 2c−1 → 2c, release 2c → 2c−1 → 0 (a = client c);
- acquired permits (K1p): S = 1 + N + N(N+1)/2 multisets of ≤ 2 client
  ids, target = acq[c, s] or rel[c, s] from :func:`permits_tables`;
- multi-register (K1m): composite S = Vr^K states, one digit per
  register; write replaces digit b with a, read keeps s when digit b is
  a, read-any is the identity.

The closure linearizes every open slot in one pass — the subset map
``k → k | bit_j`` is a masked word shift for j < 5 and a word permutation
for j ≥ 5 — until fixpoint (≤ C + 2 passes); completion of slot e applies
``k → k \\ bit_e``.  An empty D at a completion fails the history at that
event.

The unordered queue (K2) has no value axis: unique-value enqueues and
dequeues commute, so a config's contents are a function of its linset and
D is one packed bitset over the subsets, plus two 32-bit value bitsets
carried across events for the promoted prefix (``enqC``: enqueued by a
completed op or initially, ``deqC``: dequeued by a completed op).  A
slot's legal source subsets depend on the other slots in the subset, so
it gets a per-word mask instead of a transition: an enqueue is legal
everywhere; a dequeue of v where v's enqueue completed or its open
enqueue's slot bit is set, and nowhere another open dequeue of v is in
the subset or v was dequeued by the prefix.  Closure and completion are
the register kernel's, over those masks (:func:`dense_queue_reference`).

Three forms of the one function live here:

- :func:`dense_check_reference`, the plain PyTorch version: batch-wide,
  a Python loop over events and closure passes on int64 tensors that
  carry the 32-bit words (``uint32`` has no shifts or comparisons in
  PyTorch on the CPU, and ``int32 >>`` is arithmetic).  The CPU tests
  hold it byte for byte against the JAX kernel.
- :data:`DENSE_KERNELS`, the wrappers of the hand-written CUDA kernels
  in ``csrc/dense_automaton.cu`` (the register family in a warp design,
  32/W histories per warp with no block barriers; the other families, and
  register shapes past :data:`WARP_MAX_SW`, one thread block per history
  with per-target lists of live sources; both update D in place; the
  queue automaton beside them, in the warp design without the state
  axis, :func:`queue_design`), one per family, each with its launch
  counter (:func:`design` says which design a shape runs).
- :class:`DenseChecker`, the module the engine calls: the kernel for CUDA
  tensors, the plain version for CPU tensors, nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .. import obs
from . import _build
from .step_kernels import (
    F_ACQUIRE, F_CAS, F_DEQUEUE, F_ENQUEUE, F_PACQUIRE, F_RACQUIRE,
    F_READ_ANY, F_RELEASE, F_WRITE, MR_REGISTERS, MR_VALUE_BITS)

#: specs whose state is exactly "current value id" (mutex: 0 = free,
#: 1 = held; owner-mutex: 0 = free, else the holder's client id, its ops
#: arrive as cas codes; reentrant-mutex: 0 = free, 2c-1/2c = client c
#: holding once/twice)
DENSE_SPECS = (
    "register", "cas-register", "mutex", "owner-mutex", "reentrant-mutex"
)

#: dense envelope: beyond these the generic frontier search (or, for the
#: lock family and dense-only specs, the oracle) takes over
MAX_C = 12   # 2^12 subsets = 128 packed words
MAX_V = 32

#: composite-state cap of the multi-register and permit automata (per
#: event cost grows with the states; past it the frontier search or the
#: oracle takes the batch)
MR_MAX_STATES = 128

#: the transition family of each dense spec: the CUDA kernel's template
#: parameter (``kFamily*`` in ``csrc/dense_automaton.cu``)
FAMILY_IDS = {
    "register": 0, "reentrant-mutex": 1, "acquired-permits": 2,
    "multi-register": 3,
}

#: the unordered queue's automaton (K2): no value axis, its own kernel
QUEUE = "unordered-queue"

#: the register family runs the CUDA kernel's warp design while S·W (states
#: × packed subset words) is at most this, every other shape its block
#: design (``kWarpMaxSW`` in ``csrc/dense_automaton.cu``)
WARP_MAX_SW = 4096

#: the most lanes of a warp one history of the warp designs takes
#: (``kLogMaxGroup`` in ``csrc/dense_automaton.cu``: 2^5)
MAX_GROUP_LANES = 32

#: word mask of the 32-bit lanes the int64 words carry
_U32 = 0xFFFFFFFF

Shape = Union[int, Tuple[int, int]]


def family(spec_name: str) -> str:
    """The transition family a dense spec runs: its own for reentrant
    mutex, permits, multi-register and the unordered queue,
    ``"register"`` for the rest."""
    if spec_name in FAMILY_IDS or spec_name == QUEUE:
        return spec_name
    return "register"


def mr_shape_probe(init_state, cand_a, cand_b) -> tuple:
    """(Vr, K) composite shape of an encoded multi-register batch:
    a = per-register value id, b = register index, init packs one
    byte-wide value id per register.  A raw max over the PACKED init
    would wildly overestimate the domain."""
    init = np.asarray(init_state)
    mask = (1 << MR_VALUE_BITS) - 1
    dig_max = [
        int(((init >> (MR_VALUE_BITS * k)) & mask).max())
        for k in range(MR_REGISTERS)
    ]
    kreg = max(
        int(np.asarray(cand_b).max()) + 1,
        max((k + 1 for k in range(MR_REGISTERS) if dig_max[k] > 0),
            default=1),
    )
    vr = 1 + max(int(np.asarray(cand_a).max()), max(dig_max))
    return vr, kreg


def permits_tables(N: int, P: int):
    """Host-side state enumeration + transition tables for the permit
    (semaphore) automaton: states are multisets of ≤ P client ids
    (1-based, N clients).  Returns (S, acq, rel) with acq/rel of shape
    [N+1, S] mapping (client, state) → state' (or -1 = invalid move:
    acquiring past P total permits, releasing a permit not held)."""
    states = [()]
    if P >= 1:
        states += [(c,) for c in range(1, N + 1)]
    if P >= 2:
        states += [
            (c, d) for c in range(1, N + 1) for d in range(c, N + 1)
        ]
    if P > 2:
        raise ValueError("permit tables support n_permits <= 2")
    index = {st: i for i, st in enumerate(states)}
    S = len(states)
    acq = np.full((N + 1, S), -1, np.int32)
    rel = np.full((N + 1, S), -1, np.int32)
    for i, st in enumerate(states):
        for c in range(1, N + 1):
            if len(st) < P:
                acq[c, i] = index[tuple(sorted(st + (c,)))]
            if c in st:
                out = list(st)
                out.remove(c)
                rel[c, i] = index[tuple(out)]
    return S, acq, rel


def permit_sources(tbl: np.ndarray) -> np.ndarray:
    """The inverse of one of :func:`permits_tables`' maps, as the CUDA
    kernel reads it: ``src[c, t]`` is the state that client c's move takes
    to state t, or -1.  Each client's acquire (add c) and release (remove
    one c) is one-to-one, so the inverse is a table too."""
    src = np.full_like(tbl, -1)
    c, s = np.nonzero(tbl >= 0)
    if len(np.unique(c * tbl.shape[1] + tbl[c, s])) != len(c):
        raise ValueError("a permit move is not one-to-one")
    src[c, tbl[c, s]] = s.astype(tbl.dtype)
    return src


def _permit_states(n_clients: int, p: int) -> int:
    return 1 + n_clients + (n_clients * (n_clients + 1) // 2 if p >= 2
                            else 0)


def design(fam: str, S: int, C: int) -> str:
    """Which design of the CUDA kernel a launch of family ``fam`` at ``S``
    states and ``C`` slots runs: ``"warp"`` (the register family while
    S·W ≤ :data:`WARP_MAX_SW`: one warp per 32/W histories, no block
    barriers) or ``"block"`` (one block per history)."""
    if fam == "register" and S * _n_words(C) <= WARP_MAX_SW:
        return "warp"
    return "block"


def queue_design(C: int) -> dict:
    """The shape of the queue automaton's launch at ``C`` slots (K2's
    warp design): ``lanes_per_history`` G = min(W, 32), so
    ``histories_per_warp`` 32 / G and ``words_per_lane`` W / G."""
    W = _n_words(C)
    G = min(W, MAX_GROUP_LANES)
    return {"lanes_per_history": G, "histories_per_warp": 32 // G,
            "words_per_lane": W // G}


def applicable(spec_name: str, C: int, V) -> bool:
    """``V`` is the value-domain size for the register family (rounded up
    to 4), or a pair: ``(Vr, K)`` (per-register domain, register count)
    for multi-register, ``(N, P)`` (clients, permits) for
    acquired-permits.  The unordered queue has its own dense automaton
    (K2), which the engine never routes to (the direct checker takes the
    queue first); :func:`make_dense_fn` builds it on request."""
    if spec_name == "unordered-queue":
        return C <= MAX_C
    if spec_name == "multi-register":
        if not isinstance(V, tuple):
            return False
        vr, k = V
        return C <= MAX_C and vr ** k <= MR_MAX_STATES
    if spec_name == "acquired-permits":
        if not isinstance(V, tuple):
            return False
        n_clients, p = V
        if p > 2:
            return False
        return C <= MAX_C and _permit_states(n_clients, p) <= MR_MAX_STATES
    return spec_name in DENSE_SPECS and C <= MAX_C and V <= MAX_V


def n_states(spec_name: str, V: Shape) -> int:
    """The automaton's state count S for a dense shape (1 for the queue:
    its contents are a function of the linset)."""
    fam = family(spec_name)
    if fam == QUEUE:
        return 1
    if fam == "multi-register":
        vr, k = V
        return int(vr) ** int(k)
    if fam == "acquired-permits":
        n_clients, p = V
        return _permit_states(int(n_clients), int(p))
    return int(V)


#: _LOMASK[j]: bits of a 32-subset word whose subset index has bit j clear
_LOMASK = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)


def _n_words(C: int) -> int:
    return max(1, (1 << C) // 32)


def _subset_maps(C: int):
    """Static per-slot tables for the packed-axis subset maps, as numpy
    (the same arrays :func:`jepsen_tpu.ops.dense._subset_maps` builds).

    union (``s → s | bit_j``, image restricted to s ∋ j):
        out[k] = (x[uidx[j,k]] & umask[j,k]) << ushl[j]
    drop (``s → s \\ bit_j``, image restricted to s ∌ j):
        out[k] = (x[didx[j,k]] >> dshr[j]) & dmask[j,k]

    For j < 5 the map moves bits inside a word (mask + shift); for j ≥ 5
    it permutes whole words (static gather + output mask).
    """
    W = _n_words(C)
    k = np.arange(W)
    uidx = np.zeros((C, W), np.int32)
    umask = np.zeros((C, W), np.uint32)
    ushl = np.zeros((C,), np.uint32)
    didx = np.zeros((C, W), np.int32)
    dmask = np.zeros((C, W), np.uint32)
    dshr = np.zeros((C,), np.uint32)
    for j in range(C):
        if j < 5:
            uidx[j] = k
            umask[j] = _LOMASK[j]
            ushl[j] = 1 << j
            didx[j] = k
            dmask[j] = _LOMASK[j]
            dshr[j] = 1 << j
        else:
            wb = 1 << (j - 5)
            uidx[j] = k ^ wb
            umask[j] = np.where((k & wb) != 0, 0xFFFFFFFF, 0)
            didx[j] = k | wb
            dmask[j] = np.where((k & wb) == 0, 0xFFFFFFFF, 0)
    return uidx, umask, ushl, didx, dmask, dshr


def _subset_has(C: int) -> np.ndarray:
    """has[j]: [W] uint32 mask of packed bits whose subset index has bit
    j SET — the "configs that linearized slot j" selector.  The register
    kernel folds it into ``didx``/``dshr``; the queue automaton builds
    its dequeue masks from it."""
    W = _n_words(C)
    k = np.arange(W)
    has = np.zeros((C, W), np.uint32)
    for j in range(C):
        if j < 5:
            has[j] = np.uint32(0xFFFFFFFF ^ _LOMASK[j])
        else:
            has[j] = np.where((k & (1 << (j - 5))) != 0, 0xFFFFFFFF, 0)
    return has


# Host word-packing, copied with the reference's tables; the main path
# does not pack words yet (the Elle slice's bit packing, K8, will).

#: boolean lanes carried per packed word
WORD_LANES = 32


def word_count(n: int) -> int:
    """uint32 words needed to carry ``n`` boolean lanes (≥ 1)."""
    return max(1, -(-n // WORD_LANES))


def pack_words_np(bits: np.ndarray) -> np.ndarray:
    """Host word-packing: ``(..., n) bool → (..., W) uint32`` with lane
    ``j`` stored at word ``j // 32``, bit position ``j % 32`` (little bit
    order, the layout ``np.packbits(bitorder="little")`` emits)."""
    bits = np.asarray(bits, bool)
    n = bits.shape[-1]
    W = word_count(n)
    pad = W * WORD_LANES - n
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), bool)], axis=-1
        )
    by = np.packbits(bits, axis=-1, bitorder="little").astype(np.uint32)
    by = by.reshape(bits.shape[:-1] + (W, 4))
    return (by[..., 0]
            | (by[..., 1] << np.uint32(8))
            | (by[..., 2] << np.uint32(16))
            | (by[..., 3] << np.uint32(24)))


def unpack_words_np(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_words_np`: ``(..., W) uint32 → (..., n)``
    bool — lanes past ``n`` are word-floor padding and are dropped."""
    words = np.asarray(words, np.uint32)
    shifts = np.arange(WORD_LANES, dtype=np.uint32)
    lanes = (words[..., None] >> shifts) & np.uint32(1)
    return lanes.reshape(words.shape[:-1] + (-1,))[..., :n].astype(bool)


Tables = Tuple[torch.Tensor, ...]


def subset_tables(C: int, device=None) -> Tables:
    """:func:`_subset_maps` as int64 tensors on ``device`` — the form the
    plain version indexes and shifts with."""
    return tuple(
        torch.as_tensor(t.astype(np.int64), device=device)
        for t in _subset_maps(C)
    )


def _targets(fam: str, f_s, a_s, b_s, active, S: int, params=None):
    """Per-slot transition as a partial function of the source state:
    ``tgt[b, j, s]`` is the state linearizing slot j moves state s to, or
    −1 (no move; also every target outside [0, S) and every inactive
    slot).  ``f_s``/``a_s``/``b_s`` [n, C] int64 are the slot-regrouped
    op codes.  ``params``: the permit tables ``(acq, rel)`` as int64
    tensors [N+1, S], or the multi-register ``(Vr, K)``."""
    s = torch.arange(S, device=f_s.device)[None, None, :]
    f, a, b = f_s[..., None], a_s[..., None], b_s[..., None]
    none = torch.full_like(s, -1)
    if fam == "reentrant-mutex":
        once, twice = 2 * a - 1, 2 * a
        acq = torch.where(s == 0, once, torch.where(s == once, twice, none))
        rel = torch.where(s == twice, once, torch.where(s == once, 0, none))
        tgt = torch.where(f == F_RACQUIRE, acq, rel)
    elif fam == "acquired-permits":
        acq_t, rel_t = params
        idx = a_s.clamp(0, acq_t.shape[0] - 1)
        tgt = torch.where(f == F_PACQUIRE, acq_t[idx], rel_t[idx])
    elif fam == "multi-register":
        vr, kreg = params
        pw = (vr ** b.clamp(0, kreg - 1))
        d = (s // pw) % vr
        written = torch.where((a >= 0) & (a < vr), s + (a - d) * pw, none)
        tgt = torch.where(f == F_WRITE, written,
                          torch.where(f == F_READ_ANY, s,
                                      torch.where(d == a, s, none)))
    else:
        is_acq = f == F_ACQUIRE
        is_rel = f == F_RELEASE
        a_eff = torch.where(is_acq, 0, torch.where(is_rel, 1, a))
        b_eff = torch.where(is_acq, 1, torch.where(is_rel, 0, b))
        cas_like = (f == F_CAS) | is_acq | is_rel
        tgt = torch.where(
            f == F_WRITE, a_eff,
            torch.where(f == F_READ_ANY, s,
                        torch.where(s == a_eff,
                                    torch.where(cas_like, b_eff, a_eff),
                                    none)))
    tgt = torch.where((tgt >= 0) & (tgt < S), tgt, -1)
    return torch.where(active[..., None], tgt, -1)


def _init_states(fam: str, init_state, S: int, params=None):
    """Initial state id per row, placed as the reference's
    ``dynamic_update_index_in_dim`` places it: a negative id counts from
    the end (id + S), then the id is clamped into [0, S).  A
    multi-register init packs one byte-wide value id per register and
    becomes the composite id Σ digit_k · Vr^k."""
    init = init_state.long()
    if fam == "multi-register":
        vr, kreg = params
        mask = (1 << MR_VALUE_BITS) - 1
        init = sum(((init >> (MR_VALUE_BITS * k)) & mask) * vr ** k
                   for k in range(kreg))
    return torch.where(init < 0, init + S, init).clamp(0, S - 1)


def dense_check_reference(
    init_state: torch.Tensor,
    ev_slot: torch.Tensor,
    cand_slot: torch.Tensor,
    cand_f: torch.Tensor,
    cand_a: torch.Tensor,
    cand_b: torch.Tensor,
    S: int,
    tables: Optional[Tables] = None,
    work: Optional[dict] = None,
    *,
    fam: str = "register",
    params=None,
):
    """The plain PyTorch version of the dense automaton, on any device:
    ``(ok [B] bool, failed_at [B] int32, overflow [B] bool)`` for the
    encoded batch (the :class:`~jepsen_tpu_torch.ops.encode.EncodedBatch`
    arrays as tensors), over ``S`` states of transition family ``fam``
    (:func:`family`; ``params`` as :func:`_targets` takes them).  Same
    Jacobi closure passes, same C + 2 cap and a per-row "changed" mask,
    so every row stops exactly where the reference's vmapped
    ``while_loop`` stops it; each event works on the rows still
    searching only.  ``tables`` are :func:`subset_tables` for ``C`` on
    the inputs' device (built when omitted).

    ``work``, when given, gains ``"int_ops"``: the 32-bit ALU operations
    the function needs for these inputs — the count ``chip_smoke.py``
    prices the kernel's bound with.  Per row still searching and per
    closure pass that changes its D: one OR per source state of each
    live (slot, target, word), then the word's AND, shift and OR into the
    pass's update (slot j < 5), or that OR alone (j ≥ 5: the mask and
    shift are the identity and half the words are zero); then D | update
    and the fixpoint compare per word.  Per completion: shift, AND and
    emptiness OR per word (slot < 5), or the emptiness OR per live word.
    Not counted: loads and stores, building the transitions, and the pass
    that only confirms the fixpoint.  It also gains ``"max_passes"``: the
    most closure passes that changed D on any row at any event (at most
    C: a pass adds the configs one more linearized op away, so the C + 2
    cap never binds, and the kernels may reach the same fixpoint in any
    order of updates)."""
    dev = ev_slot.device
    B, E = ev_slot.shape
    C = cand_slot.shape[2]
    W = _n_words(C)
    if tables is None:
        tables = subset_tables(C, dev)
    uidx, umask, ushl, didx, dmask, dshr = tables
    max_closure = C + 2
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    slots = torch.arange(C, device=dev)
    i32 = torch.int32
    # the words are the reference's uint32 words in int32 (the same bits;
    # a left shift drops what passes bit 31, and every right shift's
    # sign bits are masked off): half the bytes of int64.  Slot j's union
    # moves bits inside a word for j < 5 (mask, then shift by 2^j) and
    # whole words for j ≥ 5 (a gather whose masked-out words read the
    # all-zero word W, so the mask needs no pass of its own)
    lo = min(C, 5)
    umask_lo = umask[:lo].to(i32)[None, :, None, :]
    ushl_lo = ushl[:lo].to(i32)[None, :, None, None]
    gidx_hi = torch.where(umask[lo:] != 0, uidx[lo:], W)[None, :, None, :]
    didx32, dmask32, dshr32 = didx, dmask.to(i32), dshr.to(i32)
    # slot j's targets live in rows j·(S+1) .. j·(S+1)+S of the closure's
    # scratch; row S of each block takes the moves that go nowhere
    block = (slots * (S + 1))[None, :, None]

    D = torch.zeros((B, S, W), dtype=i32, device=dev)
    init = _init_states(fam, init_state, S, params)
    D[torch.arange(B, device=dev), init, 0] = 1
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    failed_at = torch.full((B,), -1, dtype=torch.int32, device=dev)
    # the operation count stays on the device: no sync per pass for it
    int_ops = torch.zeros((), dtype=torch.int64, device=dev)
    max_passes = 0
    if work is not None:  # live words per slot, and ops to fold one in
        low = slots < 5
        live_w = torch.where(low, W, W // 2)[None, :]
        fold_w = torch.where(low, 3 * W, W // 2)[None, :]

    for e in range(E):
        # only rows still searching do work: a padding event keeps D and
        # the verdict, and a finished row never changes again (the
        # reference parks it on an empty D)
        rows = ((ev_slot[:, e] >= 0) & ~done).nonzero().squeeze(1)
        n = rows.numel()
        if n == 0:
            continue
        es = ev_slot[rows, e].long()
        # regroup candidate lanes by SLOT id (at most one lane holds it)
        eq = cand_slot[rows, e].long()[:, None, :] == slots[None, :, None]
        active = eq.any(dim=2)
        f_s = torch.where(eq, cand_f[rows, e].long()[:, None, :], zero).sum(2)
        a_s = torch.where(eq, cand_a[rows, e].long()[:, None, :], zero).sum(2)
        b_s = torch.where(eq, cand_b[rows, e].long()[:, None, :], zero).sum(2)
        tgt = _targets(fam, f_s, a_s, b_s, active, S, params)
        moves = tgt >= 0
        dst = torch.where(moves, tgt, S) + block  # [n, C, S] scratch rows
        # the sources each (row, slot) moves to each target: the most is
        # the number of collision layers the moves need
        into = torch.zeros((n, C * (S + 1)), dtype=torch.int64, device=dev)
        into.scatter_add_(1, dst.flatten(1), moves.flatten(1).long())
        into = into.view(n, C, S + 1)[:, :, :S]
        Dc = D[rows]
        # one sync per event: the source states some slot moves, the
        # states some row holds (the first pass's sources) and the layers
        flags = torch.cat([moves.any(1).any(0), Dc.any(2).any(0),
                           into.amax()[None]]).tolist()
        sources = [v for v in range(S) if flags[v]]
        held, layers = flags[S:2 * S], flags[2 * S]
        rank = None  # built at the first pass that scatters in layers
        if work is not None:
            n_tgt = (into > 0).sum(2)
            per_pass = ((moves.sum(2) * live_w).sum(1)
                        + (n_tgt * fold_w).sum(1) + 2 * S * W)

        # --- closure: Jacobi passes to fixpoint, capped, per-row stop ---
        on = torch.ones((n,), dtype=torch.bool, device=dev)
        for n_pass in range(max_closure):
            # X[j, s'] = OR of D[s] over the held sources s that slot j
            # moves to s', in scatters that never write a scratch row twice:
            # one per collision layer (the sources of a (row, slot) that
            # share a target fall in different layers) where there are
            # fewer layers than held sources, else one per source
            X = torch.zeros((n, C * (S + 1), W + 1), dtype=i32, device=dev)
            live = [v for v in sources if held[v]]
            if len(live) <= layers:
                for v in live:
                    idx = dst[:, :, v, None].expand(n, C, W)
                    X.scatter_(1, idx, X.gather(1, idx) | Dc[:, v, None, :])
            else:
                if rank is None:
                    rank = _collision_rank(dst, moves)
                hv = torch.as_tensor(live, device=dev)
                H = len(live)
                d_h = dst.index_select(2, hv).flatten(1)
                r_h = rank.index_select(2, hv).flatten(1)
                t_h = (block + S).expand(n, C, H).flatten(1)
                src = Dc.index_select(1, hv)[:, None].expand(
                    n, C, H, W).reshape(n, C * H, W)
                for r in range(layers):
                    idx = torch.where(r_h == r, d_h, t_h)[:, :, None].expand(
                        n, C * H, W)
                    X.scatter_(1, idx, X.gather(1, idx) | src)
            Xv = X.view(n, C, S + 1, W + 1)[:, :, :S]
            U = (Xv[:, :lo, :, :W] & umask_lo) << ushl_lo
            add = U[:, 0]
            for j in range(1, lo):
                add |= U[:, j]
            if C > lo:
                U = torch.gather(Xv[:, lo:], 3,
                                 gidx_hi.expand(n, C - lo, S, W))
                for j in range(C - lo):
                    add |= U[:, j]
            Dn = Dc | add
            changed = (Dn != Dc).flatten(1).any(1) & on
            if work is not None:
                int_ops += (per_pass * changed).sum()
            Dc = torch.where(on[:, None, None], Dn, Dc)
            on = changed
            # one sync per pass: whether any row changed, and the states
            # the next pass's sources are held in
            flags = torch.cat([on.any()[None], Dc.any(2).any(0)]).tolist()
            if not flags[0]:
                break
            held = flags[1:]
            max_passes = max(max_passes, n_pass + 1)

        # --- completion: keep configs that linearized e_slot, then
        # promote it out of the linset; only the event's own slot is
        # gathered (at most one slot per row; an id outside [0, C)
        # selects none and empties the row) ---
        in_range = (es >= 0) & (es < C)
        sel = es.clamp(0, C - 1)
        Ds = torch.gather(Dc, 2, didx32[sel][:, None, :].expand(n, S, W))
        Df = (Ds >> dshr32[sel][:, None, None]) & dmask32[sel][:, None, :]
        Df = torch.where(in_range[:, None, None], Df, 0)
        empty = ~(Df != 0).flatten(1).any(1)
        if work is not None:
            int_ops += torch.where(es < 5, 3 * S * W, S * (W // 2)).sum()
        D[rows] = Df  # an emptied row parks on D = 0
        failed = rows[empty]
        done[failed] = True
        failed_at[failed] = e

    if work is not None:
        work["int_ops"] = work.get("int_ops", 0) + int(int_ops)
        work["max_passes"] = max(work.get("max_passes", 0), max_passes)
    return ~done, failed_at, torch.zeros((B,), dtype=torch.bool, device=dev)


def _collision_rank(dst: torch.Tensor, moves: torch.Tensor) -> torch.Tensor:
    """``rank[b, j, s]``: how many sources s' < s slot j of row b moves to
    the same target as s (0 for a source it does not move).  Sources of
    one rank have distinct targets in every (row, slot), so each rank is
    one collision-free scatter."""
    S = dst.shape[2]
    key = torch.where(moves, dst, -1)
    order = torch.argsort(key, dim=2, stable=True)
    sk = torch.gather(key, 2, order)
    pos = torch.arange(S, device=dst.device).expand_as(sk)
    new_run = torch.ones_like(sk, dtype=torch.bool)
    new_run[..., 1:] = sk[..., 1:] != sk[..., :-1]
    start = torch.where(new_run, pos, 0).cummax(dim=2).values
    rank = torch.empty_like(order).scatter_(2, order, pos - start)
    return torch.where(moves, rank, 0)


def dense_queue_reference(
    init_state: torch.Tensor,
    ev_slot: torch.Tensor,
    cand_slot: torch.Tensor,
    cand_f: torch.Tensor,
    cand_a: torch.Tensor,
    cand_b: torch.Tensor,
    tables: Optional[Tables] = None,
    work: Optional[dict] = None,
):
    """The plain PyTorch version of the unordered-queue automaton (K2,
    ``jepsen_tpu/ops/dense.py:build_dense_queue``), on any device: ``(ok
    [B] bool, failed_at [B] int32, overflow [B] bool)`` for an encoded
    queue batch.  ``init_state`` is the initial contents as a value
    bitset (value id v at bit v − 1); ``cand_b`` is not read.

    Per non-padding event of a row still searching: regroup the lanes by
    slot (op codes and value ids summed, as the reference sums them),
    build each slot's ``[W]`` mask of legal source words, run Jacobi
    closure passes ``D |= OR_j ((D & valid_j)[uidx] & umask) << ushl``
    until no word changes or C + 2 passes, complete the event's slot as
    the register automaton does, then OR the completing op's value bit
    into ``enqC`` or ``deqC``.  A value id outside 1..32 has no bit (the
    reference's out-of-range shift gives 0).  Words ride int64 tensors
    masked to 32 bits.

    ``work``, when given, gains ``"int_ops"``, counted as
    :func:`dense_check_reference` counts them: per row still searching
    and per closure pass that changes its D, for each slot with a
    nonzero mask, the AND with the mask, the AND with ``umask``, the
    shift and the OR into the update per word (slot j < 5), or the AND
    and the OR per live word (j ≥ 5: half the words); then D | update
    and the fixpoint compare per word.  Per completion: shift, AND and
    emptiness OR per word (slot < 5), or the emptiness OR per live word.
    Not counted: loads and stores, building the masks, and the pass that
    only confirms the fixpoint.  It also gains ``"max_passes"``, as
    :func:`dense_check_reference` reports it: the most closure passes that
    changed D on any row at any event (at most C, so the C + 2 cap never
    binds: the passes end on the least fixpoint, which the kernel's two
    ordered sweeps reach too)."""
    dev = ev_slot.device
    B, E = ev_slot.shape
    C = cand_slot.shape[2]
    W = _n_words(C)
    if tables is None:
        tables = subset_tables(C, dev)
    uidx, umask, ushl, didx, dmask, dshr = tables
    has = torch.as_tensor(_subset_has(C).astype(np.int64), device=dev)
    max_closure = C + 2
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    slots = torch.arange(C, device=dev)
    others = ~torch.eye(C, dtype=torch.bool, device=dev)
    umask_b, ushl_b = umask[None], ushl[None, :, None]
    dmask_b, dshr_b = dmask[None], dshr[None, :, None]

    D = torch.zeros((B, W), dtype=torch.int64, device=dev)
    D[:, 0] = 1  # the empty linset
    enq_c = init_state.long() & _U32
    deq_c = torch.zeros((B,), dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    failed_at = torch.full((B,), -1, dtype=torch.int32, device=dev)
    int_ops = 0
    max_passes = 0
    if work is not None:  # ops to fold one slot's mask into a pass
        slot_cost = torch.where(slots < 5, 4 * W, W)[None, :]

    for e in range(E):
        rows = ((ev_slot[:, e] >= 0) & ~done).nonzero().squeeze(1)
        n = rows.numel()
        if n == 0:
            continue
        es = ev_slot[rows, e].long()
        eq = cand_slot[rows, e].long()[:, None, :] == slots[None, :, None]
        active = eq.any(dim=2)
        f_s = torch.where(eq, cand_f[rows, e].long()[:, None, :], zero).sum(2)
        a_s = torch.where(eq, cand_a[rows, e].long()[:, None, :], zero).sum(2)
        is_enq = active & (f_s == F_ENQUEUE)
        is_deq = active & (f_s == F_DEQUEUE)
        shift = (a_s - 1) & _U32  # value ids are 1-based
        vbit = torch.where(active & (shift < 32),
                           torch.ones_like(shift) << shift.clamp(max=31), zero)

        # slot pairs matched by value id: slot k holds the open enqueue
        # (resp. another open dequeue) of slot j's value
        same = a_s[:, :, None] == a_s[:, None, :]
        enq_at = same & is_enq[:, None, :] & is_deq[:, :, None]
        other_deq = same & is_deq[:, None, :] & is_deq[:, :, None] & others
        e_mask = torch.zeros((n, C, W), dtype=torch.int64, device=dev)
        forbid = torch.zeros((n, C, W), dtype=torch.int64, device=dev)
        for k in range(C):
            e_mask |= torch.where(enq_at[:, :, k, None], has[k], zero)
            forbid |= torch.where(other_deq[:, :, k, None], has[k], zero)
        ec, dc = enq_c[rows], deq_c[rows]
        enq_done = (ec[:, None] & vbit) != 0
        deq_done = (dc[:, None] & vbit) != 0
        enq_part = torch.where(enq_done[..., None], _U32, e_mask)
        valid = torch.where(
            is_deq[..., None],
            torch.where(deq_done[..., None], zero, enq_part & ~forbid & _U32),
            torch.where(is_enq[..., None], _U32, zero))
        if work is not None:
            per_pass = ((valid != 0).any(2) * slot_cost).sum(1) + 2 * W

        # --- closure: Jacobi passes to fixpoint, capped, per-row stop ---
        uidx_b = uidx[None].expand(n, C, W)
        Dc = D[rows]
        on = torch.ones((n,), dtype=torch.bool, device=dev)
        for n_pass in range(max_closure):
            U = (torch.gather(Dc[:, None, :] & valid, 2, uidx_b)
                 & umask_b) << ushl_b
            add = U[:, 0]
            for j in range(1, C):
                add = add | U[:, j]
            Dn = (Dc | add) & _U32
            changed = (Dn != Dc).any(1) & on
            if work is not None:
                int_ops += int((per_pass * changed).sum())
            Dc = torch.where(on[:, None], Dn, Dc)
            on = changed
            if not bool(on.any()):
                break
            max_passes = max(max_passes, n_pass + 1)

        # --- completion, then the completing op joins the prefix ---
        Ds = torch.gather(Dc[:, None, :].expand(n, C, W), 2,
                          didx[None].expand(n, C, W))
        Dvar = (Ds >> dshr_b) & dmask_b
        onehot = es[:, None] == slots[None, :]
        Df = torch.where(onehot[..., None], Dvar, zero).sum(1)
        empty = ~(Df != 0).any(1)
        if work is not None:
            int_ops += int(torch.where(es < 5, 3 * W, W // 2).sum())
        comp_vbit = torch.where(onehot, vbit, zero).sum(1)
        enq_c[rows] = torch.where((onehot & is_enq).any(1), ec | comp_vbit, ec)
        deq_c[rows] = torch.where((onehot & is_deq).any(1), dc | comp_vbit, dc)
        D[rows] = Df  # an emptied row parks on D = 0
        failed = rows[empty]
        done[failed] = True
        failed_at[failed] = e

    if work is not None:
        work["int_ops"] = work.get("int_ops", 0) + int_ops
        work["max_passes"] = max(work.get("max_passes", 0), max_passes)
    return ~done, failed_at, torch.zeros((B,), dtype=torch.bool, device=dev)


_IN_DTYPES = (torch.int32, torch.int32, torch.int8, torch.int8, torch.int16,
              torch.int16)
_IN_NAMES = ("init_state", "ev_slot", "cand_slot", "cand_f", "cand_a",
             "cand_b")


def batch_shape(arrays) -> Tuple[int, int, int]:
    """Validate an encoded batch as tensors — dtypes, ranks, shapes, one
    device, contiguity — and return ``(B, E, C)``."""
    if len(arrays) != 6:
        raise ValueError("expected the six EncodedBatch arrays")
    for t, dt, name in zip(arrays, _IN_DTYPES, _IN_NAMES):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != arrays[0].device:
            raise ValueError(f"{name} is on {t.device}, init_state on "
                             f"{arrays[0].device}")
    init_state, ev_slot, cand_slot = arrays[:3]
    if init_state.dim() != 1 or ev_slot.dim() != 2 or cand_slot.dim() != 3:
        raise ValueError("shapes must be init_state [B], ev_slot [B, E], "
                         "cand_* [B, E, C]")
    B, E, C = cand_slot.shape
    if init_state.shape[0] != B or tuple(ev_slot.shape) != (B, E):
        raise ValueError("init_state/ev_slot disagree with cand_slot's "
                         "[B, E, C]")
    for t, name in zip(arrays[3:], _IN_NAMES[3:]):
        if tuple(t.shape) != (B, E, C):
            raise ValueError(f"{name} must be [B, E, C] = {(B, E, C)}")
    return B, E, C


def check_inputs(arrays, S: int) -> Tuple[int, int, int]:
    """:func:`batch_shape`, plus the kernel's envelope (C ≤ 12 slots,
    S ≤ 128 states); ``(B, E, C)``."""
    B, E, C = batch_shape(arrays)
    if not 1 <= C <= MAX_C or not 1 <= S <= MR_MAX_STATES:
        raise ValueError(f"(C={C}, S={S}) is outside the dense envelope "
                         f"(C ≤ {MAX_C}, S ≤ {MR_MAX_STATES})")
    return B, E, C


class DenseAutomatonKernel:
    """Wrapper of the hand-written CUDA kernel ``csrc/dense_automaton.cu``
    for one transition family (replaces ``jepsen_tpu/ops/dense.py:
    build_dense``, that family's branch).  Takes CUDA tensors only,
    launches on the current stream without synchronising, and counts its
    launches in :attr:`launches`."""

    def __init__(self, fam: str):
        #: the transition family (a key of :data:`FAMILY_IDS`)
        self.family = fam
        self.name = ("dense_automaton" if fam == "register"
                     else f"dense_automaton[{fam}]")
        #: kernel launches so far (a plain counter; callers reset it)
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = _build.load("dense_automaton").dense_automaton_launch
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, init_state, ev_slot, cand_slot, cand_f, cand_a,
                 cand_b, *, S: int, mr_shape=(0, 0), permit_sources=None):
        """``mr_shape`` is ``(Vr, K)`` for multi-register;
        ``permit_sources`` the int32 :func:`permit_sources` of the acquire
        and release tables, [N+1, S] tensors on the inputs' device, for
        acquired-permits."""
        arrays = (init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b)
        B, E, C = check_inputs(arrays, S)
        dev = init_state.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
        acq_ptr = rel_ptr = None
        n_clients = 0
        if self.family == "acquired-permits":
            acq, rel = permit_sources
            if (acq.dtype != torch.int32 or rel.dtype != torch.int32
                    or acq.device != dev or rel.device != dev
                    or acq.shape != rel.shape or acq.shape[1] != S
                    or not acq.is_contiguous() or not rel.is_contiguous()):
                raise ValueError("permit source tables must be contiguous "
                                 f"int32 [N+1, {S}] tensors on {dev}")
            acq_ptr, rel_ptr = acq.data_ptr(), rel.data_ptr()
            n_clients = acq.shape[0] - 1
        ok = torch.empty((B,), dtype=torch.bool, device=dev)
        failed_at = torch.empty((B,), dtype=torch.int32, device=dev)
        overflow = torch.empty((B,), dtype=torch.bool, device=dev)
        if B == 0:
            return ok, failed_at, overflow
        fn = self._entry()
        vr, kreg = mr_shape
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*(t.data_ptr() for t in arrays), ok.data_ptr(),
                     failed_at.data_ptr(), overflow.data_ptr(), B, E, C, S,
                     FAMILY_IDS[self.family], vr, kreg, acq_ptr, rel_ptr,
                     n_clients, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err} "
                               f"(B={B}, E={E}, C={C}, S={S})")
        self.launches += 1
        return ok, failed_at, overflow


class DenseQueueKernel:
    """Wrapper of the hand-written CUDA kernel for the unordered-queue
    automaton (``dense_queue_launch`` in ``csrc/dense_automaton.cu``;
    replaces ``jepsen_tpu/ops/dense.py:build_dense_queue``).  Takes CUDA
    tensors only, launches on the current stream without synchronising,
    and counts its launches in :attr:`launches`."""

    family = QUEUE
    name = "dense_queue"

    def __init__(self):
        #: kernel launches so far (a plain counter; callers reset it)
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = _build.load("dense_automaton").dense_queue_launch
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, init_state, ev_slot, cand_slot, cand_f, cand_a,
                 cand_b):
        arrays = (init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b)
        B, E, C = check_inputs(arrays, 1)
        dev = init_state.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
        ok = torch.empty((B,), dtype=torch.bool, device=dev)
        failed_at = torch.empty((B,), dtype=torch.int32, device=dev)
        overflow = torch.empty((B,), dtype=torch.bool, device=dev)
        if B == 0:
            return ok, failed_at, overflow
        fn = self._entry()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*(t.data_ptr() for t in arrays), ok.data_ptr(),
                     failed_at.data_ptr(), overflow.data_ptr(), B, E, C,
                     stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err} "
                               f"(B={B}, E={E}, C={C})")
        self.launches += 1
        return ok, failed_at, overflow


#: one wrapper of the dense-automaton kernels per transition family, the
#: queue's included (their launch counts are what show that a run went
#: through each family)
DENSE_KERNELS = {fam: DenseAutomatonKernel(fam) for fam in FAMILY_IDS}
DENSE_KERNELS[QUEUE] = DenseQueueKernel()

#: the register family's wrapper (register, cas-register, mutex and
#: owner-mutex codes)
DENSE_AUTOMATON = DENSE_KERNELS["register"]


class DenseChecker(nn.Module):
    """The dense checker for one ``(spec, E, C, V)`` shape (``V`` a
    scalar domain, or the ``(Vr, K)``/``(N, P)`` pair of multi-register
    and acquired-permits; the queue's is 0): ``forward(init_state,
    ev_slot, cand_slot, cand_f, cand_a, cand_b) -> (ok, failed_at,
    overflow)``.  CUDA tensors go to the CUDA kernel, CPU tensors to the
    plain version; there is no fallback between the two.  The subset-map
    tables and the permit tables are buffers, so they follow the
    module's device."""

    def __init__(self, spec_name: str, E: int, C: int, V: Shape):
        super().__init__()
        if not applicable(spec_name, C, V):
            raise ValueError(f"no dense kernel for {spec_name!r} at C={C}, "
                             f"V={V}")
        from .wgl import DEFAULT_MAX_DISPATCH

        self.spec_name, self.E, self.C, self.V = spec_name, E, C, V
        self.family = family(spec_name)
        self.S = n_states(spec_name, V)
        #: per-dispatch row cap: the engine's shared ceiling (the kernels
        #: keep D on chip, so a row holds only its inputs and outputs;
        #: the kernel audit prices them against the dispatch budget), as
        #: the reference stamps it on its dense kernels
        self.safe_dispatch = DEFAULT_MAX_DISPATCH
        for name, t in zip(("uidx", "umask", "ushl", "didx", "dmask", "dshr"),
                           subset_tables(C)):
            self.register_buffer(name, t, persistent=False)
        self.mr_shape = (0, 0)
        if self.family == "multi-register":
            self.mr_shape = (int(V[0]), int(V[1]))
        if self.family == "acquired-permits":
            _, acq, rel = permits_tables(int(V[0]), int(V[1]))
            for name, t in (("pm_acq", acq), ("pm_rel", rel),
                            ("pm_acq_src", permit_sources(acq)),
                            ("pm_rel_src", permit_sources(rel))):
                self.register_buffer(name, torch.from_numpy(t),
                                     persistent=False)

    def tables(self) -> Tables:
        return (self.uidx, self.umask, self.ushl, self.didx, self.dmask,
                self.dshr)

    def _params(self):
        if self.family == "acquired-permits":
            return self.pm_acq.long(), self.pm_rel.long()
        if self.family == "multi-register":
            return self.mr_shape
        return None

    def on_device(self, device: torch.device) -> "DenseChecker":
        """The cached checker of the same shape on ``device`` (a mesh runs
        one per shard)."""
        return make_dense_fn(self.spec_name, self.E, self.C, self.V, device)

    def reference(self, *arrays, work: Optional[dict] = None):
        """The plain PyTorch version on the arrays' device."""
        check_inputs(arrays, self.S)
        if self.family == QUEUE:
            return dense_queue_reference(*arrays, tables=self.tables(),
                                         work=work)
        return dense_check_reference(*arrays, S=self.S, tables=self.tables(),
                                     work=work, fam=self.family,
                                     params=self._params())

    def forward(self, *arrays):
        if arrays[0].is_cuda:
            kernel = DENSE_KERNELS[self.family]
            if self.family == QUEUE:
                return kernel(*arrays)
            if self.family == "acquired-permits":
                return kernel(*arrays, S=self.S,
                              permit_sources=(self.pm_acq_src,
                                              self.pm_rel_src))
            return kernel(*arrays, S=self.S, mr_shape=self.mr_shape)
        return self.reference(*arrays)


_claim_lock = threading.Lock()


def count_kernel_build(fn) -> bool:
    """True exactly once per cached checker object (the dense and frontier
    factories share it): the cache returns one object per live shape, so
    marking the object counts distinct builds — what
    ``jepsen_kernel_builds_total`` counts."""
    with _claim_lock:
        if getattr(fn, "_obs_build_counted", False):
            return False
        object.__setattr__(fn, "_obs_build_counted", True)
        return True


def make_dense_fn(spec_name: str, E: int, C: int, V: Shape,
                  device: torch.device) -> DenseChecker:
    """The cached :class:`DenseChecker` for a shape, its buffers on
    ``device`` (one module per ``(spec, E, C, V, device)``, like the
    reference's per-shape jit cache; the engine rounds a scalar V and the
    permit client count up to 4, so drifting batches reuse a few).  The
    queue automaton has no value axis, so its V is normalised to 0, as
    the reference normalises it: every value domain and initial bitset
    shares one module."""
    if spec_name == QUEUE:
        V = 0
    fn = _make_dense_fn_cached(spec_name, E, C, V, torch.device(device))
    if count_kernel_build(fn):
        obs.count("jepsen_kernel_builds_total", engine="dense",
                  spec=spec_name)
    return fn


@lru_cache(maxsize=64)
def _make_dense_fn_cached(spec_name: str, E: int, C: int, V: Shape,
                          device: torch.device) -> DenseChecker:
    return DenseChecker(spec_name, E, C, V).to(device)
