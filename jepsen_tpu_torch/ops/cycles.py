"""Batched cycle detection and transactional screens — the port of
:mod:`jepsen_tpu.ops.cycles`.

Dependency graphs become ``(B, n, n)`` uint8 relation matrices
(:mod:`jepsen_tpu_torch.elle.encode`); the screens answer, for every
graph at once:

- **has-cycle** (:func:`has_cycle`, :func:`has_cycle_batch`): a graph is
  cyclic iff the transitive (≥ 1 step) closure of its adjacency has a
  true diagonal — the screen the rw-register per-key version graphs ride;
- **SCC membership** (:func:`screen` members): per relation-filter mask
  of the Elle classify ladder, ``member[v] = ∃j c[v,j] ∧ c[j,v]`` on the
  closure of the filtered subgraph;
- **nonadjacent walks** (:func:`screen` walks): closure of the 2n × 2n
  lifted graph ``[[rest, want], [rest, 0]]`` over (vertex,
  last-edge-was-want); ``walk[v] = ∃j want[v,j] ∧ c[n+j, v]``.

The closure is ``r ← r ∪ r·r`` for ``closure_rounds(n) = ⌈log₂n⌉``
rounds (``mode="fixed"``) or until a round changes no plane of the
dispatch (``mode="earlyexit"``); rounds past the fixpoint are the
identity, so both modes give the same closure and differ only in the
``rounds`` output: the fixed ladder length, or the dispatch-wide count
the reference's ``lax.while_loop`` runs, summed over the filter and
lifted families.

The reference lowers the squaring three ways (``uint8``, ``bf16``,
``packed32``), all byte-identical; the port carries one arithmetic, the
bit-packed boolean semiring (lane ``j`` of a row at word ``j // 32``,
bit ``j % 32``): one round ORs row ``k`` into row ``i`` for every set
bit ``k`` of row ``i``.  Three forms of each function live here:

- the plain PyTorch versions (:func:`has_cycle_reference`,
  :func:`screen_reference`, :func:`packed_closure`), on int64 tensors
  that carry the 32-bit words (``uint32`` has no shifts on the CPU),
  the byte-equality oracle of the kernel; each takes ``work=`` and adds
  the squaring's 32-bit operations.  Beside them the plain twins of the
  kernel's own arithmetic, :func:`semi_naive_closure` and
  :func:`reduced_screen` (same outputs; ``work=`` counts what the kernel
  runs), and the mirrors of its design switches,
  :func:`has_cycle_design` and :func:`screen_design`;
- the wrappers :data:`HAS_CYCLE` and :data:`SCREEN` of the hand-written
  CUDA kernel ``csrc/cycles_closure.cu``, each with its launch counter;
- :func:`has_cycle` / :func:`screen`, which take the kernel for a CUDA
  tensor and the plain version for a CPU tensor, and nothing else.

Batches go through the engine's :class:`~jepsen_tpu_torch.engine.
execution.Executor` as :class:`CyclePlan` / :class:`ScreenPlan` buckets
(self-settling plans: one relation array in, their own pad fill, their
own settle).  Shapes over the dispatch cap (:func:`cycles_max_dispatch`:
bytes per row over the port's budget, and the kernel's largest plane)
take the numpy host paths (``_np_*``) by that rule, never as a fallback
from a failed launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from . import _build
from .dense import WORD_LANES, pack_words_np, word_count

CLOSURE_MODES = ("fixed", "earlyexit")

#: the closure mode when neither the caller nor a calibration picks one
DEFAULT_CLOSURE_MODE = "fixed"

#: device memory one screen dispatch may hold (its relation bytes, its
#: outputs and the per-plane round scratch): the frontier search's 4 GiB
#: (``wgl.FRONTIER_DISPATCH_BUDGET``), 5% of an H100's 80 GB, so a window
#: of 4 chunks (each a quarter of the cap) stays far below the card's
#: memory.  The reference's ``CYCLES_DISPATCH_BUDGET`` is a TPU crash
#: calibration and is not carried over.
CYCLES_DISPATCH_BUDGET = 4 << 30

#: largest row count per dispatch, the engine's shared ceiling
DEFAULT_CYCLES_MAX_DISPATCH = 16384

#: largest plane (rows = columns) the kernel closes: one thread block
#: keeps the plane in shared memory, 1024 rows × 32 words = 128 KB of the
#: 227 KB a block may hold.  Screens over n vertices close 2n-vertex
#: lifted planes, so they dispatch up to n = 512.
MAX_PLANE = 1024

#: most filter masks and lifted queries one screen dispatch takes (the
#: classify ladder has at most 6 and 2)
MAX_FILTERS, MAX_LIFTED = 8, 4

#: elements of the plain closure's squaring transient per chunk of
#: planes (int64: 512 MB)
_PLAIN_CHUNK_ELEMS = 1 << 26

#: the kernel's designs, mirrored from ``csrc/cycles_closure.cu``
#: (``kHasCycleWarpMaxN``, ``kDoubleMaxN``, ``CYCLES_REDUCED_LIFTED``):
#: has-cycle keeps a plane in a warp's registers up to
#: ``HAS_CYCLE_WARP_MAX_N`` vertices and in two shared-memory copies up to
#: ``DOUBLE_MAX_N``; the fixed-mode screen closes each lifted query as an
#: n-vertex plane while ``REDUCED_LIFTED``
HAS_CYCLE_WARP_MAX_N = 32
DOUBLE_MAX_N = 512
REDUCED_LIFTED = True


def _bucket(n: int) -> int:
    """Pad sizes to powers of two (min 16), as the reference buckets
    has-cycle batches."""
    return max(16, 1 << (n - 1).bit_length())


def closure_rounds(n: int) -> int:
    """Squaring rounds that guarantee full transitive closure of an
    n-vertex graph (path length doubles per round)."""
    return max(1, math.ceil(math.log2(max(2, n))))


def _check_mode(mode: str) -> None:
    if mode not in CLOSURE_MODES:
        raise ValueError(f"closure mode {mode!r} is not one of "
                         f"{CLOSURE_MODES}")


def closure_mode(mode: Optional[str] = None) -> str:
    """The resolved closure mode of the engine's screens: ``mode`` > the
    active calibration's ``closure_mode`` (:mod:`..tune.artifact`) >
    :data:`DEFAULT_CLOSURE_MODE`.  Both modes give the same closure."""
    from ..tune import artifact as _cal

    if mode is not None:
        _check_mode(mode)
    return _cal.resolve_knob(mode, lambda cal: cal.closure_mode(),
                             DEFAULT_CLOSURE_MODE)


# ---------------------------------------------------------------------------
# bit packing (K8) and the plain closure (K6)
# ---------------------------------------------------------------------------


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """``(..., n) bool → (..., W) int64`` words (values < 2³²), lane ``j``
    at word ``j // 32``, bit ``j % 32`` — the layout of
    :func:`jepsen_tpu_torch.ops.dense.pack_words_np` and the reference's
    ``_pack_words``."""
    n = bits.shape[-1]
    W = word_count(n)
    lanes = bits.to(torch.int64)
    pad = W * WORD_LANES - n
    if pad:
        lanes = torch.nn.functional.pad(lanes, (0, pad))
    weights = torch.ones((), dtype=torch.int64, device=bits.device) << \
        torch.arange(WORD_LANES, dtype=torch.int64, device=bits.device)
    return (lanes.reshape(lanes.shape[:-1] + (W, WORD_LANES))
            * weights).sum(-1)


def unpack_words(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_words`: ``(..., W) → (..., n)`` bool; lanes
    past ``n`` are word-floor padding and are dropped."""
    shifts = torch.arange(WORD_LANES, dtype=torch.int64, device=words.device)
    lanes = (words.to(torch.int64)[..., None] >> shifts) & 1
    return lanes.reshape(words.shape[:-1] + (-1,))[..., :n] > 0


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR over ``dim`` (PyTorch has no OR reduction): halving."""
    x = x.movedim(dim, 0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        head = x[:h] | x[h:2 * h]
        x = torch.cat([head, x[2 * h:]]) if x.shape[0] % 2 else head
    return x[0]


def _square(rw: torch.Tensor, n: int):
    """One squaring round's new hops for a ``(P, n, W)`` word stack:
    ``sq[p, i] = OR of row k over the set bits k of row i``, and each
    plane's set-bit count."""
    reach = unpack_words(rw, n)  # (P, n, n): does row i hold bit k?
    zero = torch.zeros((), dtype=rw.dtype, device=rw.device)
    sq = _or_reduce(torch.where(reach[..., None], rw[:, None, :, :], zero), 2)
    return sq, reach.flatten(1).sum(1)


def packed_closure(words: torch.Tensor, n: int, mode: str = "fixed",
                   work: Optional[dict] = None):
    """Transitive (≥ 1 step) closure of a ``(P, n, W)`` word stack by
    rounds of ``r ← r ∪ r·r``, each reading only the previous round's
    rows.  Returns ``(closure words, rounds)``: ``closure_rounds(n)`` in
    ``"fixed"`` mode, else ``min(closure_rounds(n), max over planes of
    the first round that left the plane unchanged)`` — the count the
    reference's early-exit loop runs over the whole stack.

    A plane that stopped changing is not squared again (later rounds are
    the identity).  ``work["int_ops"]`` gains the kernel's own count for
    every round that changed a plane: one OR per set bit per live word,
    then the OR into the row and the compare, per word."""
    _check_mode(mode)
    R = closure_rounds(n)
    P, rows, W = words.shape
    rw = words.to(torch.int64).clone()
    first = torch.full((P,), R, dtype=torch.int64, device=rw.device)
    active = torch.arange(P, device=rw.device)
    per = max(1, _PLAIN_CHUNK_ELEMS // max(1, rows * rows * W))
    for rnd in range(1, R + 1):
        if active.numel() == 0:
            break
        still = []
        for lo in range(0, active.numel(), per):
            idx = active[lo:lo + per]
            old = rw[idx]
            sq, bits = _square(old, n)
            new = old | sq
            changed = (new != old).flatten(1).any(1)
            if work is not None:
                work["int_ops"] = work.get("int_ops", 0) + int(
                    (W * bits[changed]).sum()) + 2 * rows * W * int(
                        changed.sum())
            rw[idx] = new
            first[idx[~changed]] = rnd
            still.append(idx[changed])
        active = torch.cat(still)
    if mode == "fixed":
        return rw, R
    return rw, int(first.max()) if P else 1


def has_cycle_design(n: int) -> str:
    """Which design of the has-cycle kernel a launch over ``n``-vertex
    graphs runs: ``"warp"`` (a row a lane, ⌊32/n⌋ planes a warp, rounds
    by shuffles), ``"double"`` (two shared-memory copies of the plane,
    :func:`semi_naive_closure`) or ``"single"`` (one copy, the Jacobi
    round of :func:`packed_closure` staged in registers)."""
    if n <= HAS_CYCLE_WARP_MAX_N:
        return "warp"
    return "double" if n <= DOUBLE_MAX_N else "single"


def screen_design(mode: str, n: int) -> str:
    """How the screen kernel answers the nonadjacent-walk queries over
    ``n``-vertex graphs: ``"reduced"`` (each query closed as the n-vertex
    plane ``M = Rs ∪ Wn·Rs``, :func:`reduced_screen`; ``"fixed"`` mode,
    whose round count does not depend on the data) or ``"lifted"`` (the
    2n-vertex lifted plane, whose first unchanged round ``"earlyexit"``
    reports; and past :data:`DOUBLE_MAX_N`, where M's two copies would
    not fit).  The filter planes always run :func:`semi_naive_closure`."""
    _check_mode(mode)
    if mode == "fixed" and REDUCED_LIFTED and n <= DOUBLE_MAX_N:
        return "reduced"
    return "lifted"


def _square_sel(sel: torch.Tensor, rw: torch.Tensor, n: int) -> torch.Tensor:
    """``sq[p, i] = OR of row k of rw over the set bits k of sel[p, i]``
    for ``(P, rows, W)`` word stacks over ``n`` columns (rows of ``rw``)."""
    reach = unpack_words(sel, n)
    zero = torch.zeros((), dtype=rw.dtype, device=rw.device)
    return _or_reduce(torch.where(reach[..., None], rw[:, None, :, :], zero),
                      2)


def _row_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Set bits of each row of a ``(..., W)`` word stack."""
    return unpack_words(words, n).sum(-1)


def semi_naive_closure(words: torch.Tensor, n: int, mode: str = "fixed",
                       work: Optional[dict] = None):
    """The kernel's closure for planes of up to :data:`DOUBLE_MAX_N` rows:
    the rounds of :func:`packed_closure`, each row OR-ing in only the rows
    that can add to it.  With ``Δ_t[i] = r_t[i] & ~r_{t-1}[i]`` and
    ``C_t`` the rows that changed in round t − 1, round t ORs row k into
    row i for k in ``r_t[i] & (Δ_t[i] | C_t)``: any other k of ``r_t[i]``
    was in ``r_{t-1}[i]`` with an unchanged row, already OR-ed in.  Round
    1 takes every set bit; a row with nothing to OR in is skipped.  Same
    outputs as :func:`packed_closure`, plane by plane and round by round.

    ``work["int_ops"]`` gains the kernel's own count for every round it
    runs, the final unchanged one included: per row the word operations
    that form its iteration set, and for every row not skipped one OR per
    set bit per word plus the OR into the row and the compare.
    ``work["stale_rows"]`` gains the rows whose round differs from the
    full Jacobi round (computed only when ``work`` is given; 0 when the
    order is exact), and ``work["plane_rounds"]`` is set to each plane's
    first unchanged round (``closure_rounds(n)`` if every round changed
    it)."""
    _check_mode(mode)
    R = closure_rounds(n)
    P, rows, W = words.shape
    cur = words.to(torch.int64).clone()
    prev = cur.clone()
    changed = torch.ones((P, rows), dtype=torch.bool, device=cur.device)
    first = torch.full((P,), R, dtype=torch.int64, device=cur.device)
    active = torch.arange(P, device=cur.device)
    per = max(1, _PLAIN_CHUNK_ELEMS // max(1, rows * rows * W))
    for rnd in range(1, R + 1):
        if active.numel() == 0:
            break
        still = []
        for lo in range(0, active.numel(), per):
            idx = active[lo:lo + per]
            x = cur[idx]
            sel = x & ((x & ~prev[idx]) | pack_words(changed[idx])[:, None])
            new = x | _square_sel(sel, x, n)
            row_changed = (new != x).any(-1)
            if work is not None:
                full = x | _square_sel(x, x, n)
                run = (sel != 0).any(-1) | (rnd == 1)
                work["int_ops"] = work.get("int_ops", 0) + rows * W * len(
                    idx) + int((W * _row_bits(sel, n)[run]).sum()) + \
                    2 * W * int(run.sum())
                work["stale_rows"] = work.get("stale_rows", 0) + int(
                    (full != new).any(-1).sum())
            prev[idx] = x
            cur[idx] = new
            changed[idx] = row_changed
            plane = row_changed.any(-1)
            first[idx[~plane]] = rnd
            still.append(idx[plane])
        active = torch.cat(still)
    if work is not None:
        work["plane_rounds"] = first
    if mode == "fixed":
        return cur, R
    return cur, int(first.max()) if P else 1


def _diagonal(words: torch.Tensor, n: int) -> torch.Tensor:
    """``(P, n, W)`` closure words → ``(P, n)`` bool ``c[v, v]``."""
    v = torch.arange(n, device=words.device)
    return ((words[:, v, v // WORD_LANES] >> (v % WORD_LANES)) & 1) > 0


def check_relations(rel: torch.Tensor) -> Tuple[int, int]:
    """``(B, n)`` of a ``(B, n, n)`` uint8 relation (or adjacency) batch;
    raises on any other shape or dtype."""
    if rel.dim() != 3 or rel.shape[1] != rel.shape[2]:
        raise ValueError(f"relations must be [B, n, n], got "
                         f"{tuple(rel.shape)}")
    if rel.dtype not in (torch.uint8, torch.bool):
        raise ValueError(f"relations must be uint8 or bool, got {rel.dtype}")
    return int(rel.shape[0]), int(rel.shape[1])


def has_cycle_reference(adj: torch.Tensor, mode: str = "fixed",
                        work: Optional[dict] = None, closure: bool = False):
    """Plain version of the has-cycle screen: ``(B, n, n)`` uint8/bool →
    ``(flags (B,) bool, rounds (B,) int32)`` (plus the ``(B, n, n)`` bool
    closure when ``closure``) — the reference's ``_cyclic_fn``."""
    B, n = check_relations(adj)
    closed, used = packed_closure(pack_words(adj > 0), n, mode, work)
    flags = _diagonal(closed, n).any(-1)
    rounds = torch.full((B,), used, dtype=torch.int32, device=adj.device)
    if closure:
        return flags, rounds, unpack_words(closed, n)
    return flags, rounds


def lifted(rel: torch.Tensor, want: int, rest: int) -> torch.Tensor:
    """The ``(B, 2n, 2n)`` bool lifted graph ``[[rest, want], [rest, 0]]``
    over (vertex, last-edge-was-want): a want edge leaves only state 0 and
    lands in state 1, a rest edge lands in state 0."""
    aw = (rel & want) > 0
    ar = (rel & rest) > 0
    top = torch.cat([ar, aw], dim=-1)
    bot = torch.cat([ar, torch.zeros_like(ar)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def screen_reference(rel: torch.Tensor, masks: Sequence[int],
                     nonadj: Sequence[Tuple[int, int]], mode: str = "fixed",
                     work: Optional[dict] = None):
    """Plain version of the transactional screen: ``(B, n, n)`` uint8
    relation bits → ``(members (B, F, n) bool, walks (B, Q, n) bool,
    rounds (B,) int32)`` — the reference's packed ``_screen_fn_variant``:
    one closure over the ``(B·F, n, n)`` filter stack and one over the
    ``(B·Q, 2n, 2n)`` lifted stack; rounds summed over the two."""
    B, n = check_relations(rel)
    rel = rel.to(torch.uint8)
    F, Q = len(masks), len(nonadj)
    used = 0
    members = torch.zeros((B, F, n), dtype=torch.bool, device=rel.device)
    walks = torch.zeros((B, Q, n), dtype=torch.bool, device=rel.device)
    if F:
        marr = torch.tensor(list(masks), dtype=torch.uint8,
                            device=rel.device)
        planes = (rel[:, None] & marr[None, :, None, None]) > 0
        closed, um = packed_closure(
            pack_words(planes.reshape(B * F, n, n)), n, mode, work)
        c = unpack_words(closed, n).reshape(B, F, n, n)
        members = (c & c.transpose(-1, -2)).any(-1)
        used += um
    if Q:
        stack = torch.stack([lifted(rel, w, r) for w, r in nonadj], dim=1)
        closed, uw = packed_closure(
            pack_words(stack.reshape(B * Q, 2 * n, 2 * n)), 2 * n, mode,
            work)
        c = unpack_words(closed, 2 * n).reshape(B, Q, 2 * n, 2 * n)
        aw = torch.stack([(rel & w) > 0 for w, _ in nonadj], dim=1)
        reach = c[:, :, n:, :n]  # from (·, 1) to (·, 0), ≥ 1 step
        walks = (aw & reach.transpose(-1, -2)).any(-1)
        used += uw
    rounds = torch.full((B,), used, dtype=torch.int32, device=rel.device)
    return members, walks, rounds


def reduced_screen(rel: torch.Tensor, masks: Sequence[int],
                   nonadj: Sequence[Tuple[int, int]], mode: str = "fixed",
                   work: Optional[dict] = None):
    """Plain version of what the screen kernel computes, with the outputs
    of :func:`screen_reference`.  Members are the diagonals of the filter
    planes closed by :func:`semi_naive_closure`.  A nonadjacent-walk query
    (want, rest) on the ``"reduced"`` design (:func:`screen_design`):
    with ``Wn = rel & want``, ``Rs = rel & rest`` and the n-vertex plane
    ``M = Rs ∪ Wn·Rs``, ``walk[v] = ∃k: (Wn·Rs)[v, k] ∧ (k = v ∨
    M⁺[k, v])`` — from (j, 1) the lifted walk's first step is a rest edge
    into state 0, and every path between state-0 vertices is a chain of
    "rest" or "want then rest" steps, the edges of M.  On the
    ``"lifted"`` design the query closes the 2n-vertex lifted plane as
    :func:`screen_reference` does.

    ``work["int_ops"]`` counts the kernel's own operations: the
    semi-naive closures (:func:`semi_naive_closure`), M's product (one OR
    per want bit per word, and the OR of ``Rs[v]``), the product again
    at read-out (the kernel recomputes ``Wn·Rs``; the closure took both
    of its planes) and one bit test per set bit of ``Wn·Rs``; a lifted
    plane counts as in :func:`packed_closure`."""
    B, n = check_relations(rel)
    rel = rel.to(torch.uint8)
    F, Q = len(masks), len(nonadj)
    W = word_count(n)
    used = 0
    members = torch.zeros((B, F, n), dtype=torch.bool, device=rel.device)
    walks = torch.zeros((B, Q, n), dtype=torch.bool, device=rel.device)
    if F:
        marr = torch.tensor(list(masks), dtype=torch.uint8,
                            device=rel.device)
        planes = (rel[:, None] & marr[None, :, None, None]) > 0
        closed, um = semi_naive_closure(
            pack_words(planes.reshape(B * F, n, n)), n, mode, work)
        members = _diagonal(closed, n).reshape(B, F, n)
        used += um
    if Q and screen_design(mode, n) == "reduced":
        eye = torch.eye(n, dtype=torch.bool, device=rel.device)
        for q, (want, rest) in enumerate(nonadj):
            wn = pack_words((rel & want) > 0)
            rs = pack_words((rel & rest) > 0)
            wr = _square_sel(wn, rs, n)
            closed, _ = semi_naive_closure(rs | wr, n, "fixed", work)
            star = unpack_words(closed, n) | eye
            hops = unpack_words(wr, n)
            walks[:, q] = (hops & star.transpose(-1, -2)).any(-1)
            if work is not None:
                work["int_ops"] = work.get("int_ops", 0) + (
                    2 * W * int(_row_bits(wn, n).sum()) + B * n * W
                    + int(hops.sum()))
        used += closure_rounds(2 * n)
    elif Q:
        stack = torch.stack([lifted(rel, w, r) for w, r in nonadj], dim=1)
        closed, uw = packed_closure(
            pack_words(stack.reshape(B * Q, 2 * n, 2 * n)), 2 * n, mode,
            work)
        c = unpack_words(closed, 2 * n).reshape(B, Q, 2 * n, 2 * n)
        aw = torch.stack([(rel & w) > 0 for w, _ in nonadj], dim=1)
        walks = (aw & c[:, :, n:, :n].transpose(-1, -2)).any(-1)
        used += uw
    rounds = torch.full((B,), used, dtype=torch.int32, device=rel.device)
    return members, walks, rounds


# ---------------------------------------------------------------------------
# the CUDA kernel's wrappers (K6 has-cycle, K7 screen; K8 inside both)
# ---------------------------------------------------------------------------


def _require_cuda_u8(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {name} "
                         f"on {t.device}")
    if t.dtype not in (torch.uint8, torch.bool) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous uint8 or bool tensor")


def _kernel_n(n: int, lo: int, hi: int) -> None:
    if n < lo or n > hi or n & (n - 1):
        raise ValueError(f"n={n} must be a power of two in [{lo}, {hi}]")


class HasCycleKernel:
    """Wrapper of ``cycles_has_cycle_launch`` in ``csrc/cycles_closure.cu``
    (replaces ``jepsen_tpu/ops/cycles.py:376`` ``_cyclic_fn`` with
    ``_bool_closure``, and ``:884`` ``_reach_fn`` when asked for the
    closure).  Takes a contiguous ``(B, n, n)`` uint8/bool CUDA tensor,
    n a power of two in [16, 1024]; launches on the current stream
    without synchronising and counts its launches in :attr:`launches`."""

    name = "cycles_has_cycle"

    def __init__(self):
        #: kernel launches so far (a plain counter; callers reset it)
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = _build.load("cycles_closure").cycles_has_cycle_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, adj: torch.Tensor, mode: str = "fixed",
                 closure: bool = False):
        _check_mode(mode)
        _require_cuda_u8(adj, "adj")
        B, n = check_relations(adj)
        _kernel_n(n, 16, MAX_PLANE)
        dev = adj.device
        flags = torch.empty((B,), dtype=torch.bool, device=dev)
        rounds = torch.empty((B,), dtype=torch.int32, device=dev)
        out = (torch.empty((B, n, n), dtype=torch.bool, device=dev)
               if closure else None)
        if B:
            scratch = torch.empty((2,), dtype=torch.int32, device=dev)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = self._entry()(
                    adj.data_ptr(), flags.data_ptr(), rounds.data_ptr(),
                    out.data_ptr() if out is not None else None,
                    scratch.data_ptr(), B, n, int(mode == "earlyexit"),
                    stream)
            if err != 0:
                raise RuntimeError(f"{self.name} launch failed: CUDA error "
                                   f"{err} (B={B}, n={n})")
            self.launches += 1
        return (flags, rounds, out) if closure else (flags, rounds)


class ScreenKernel:
    """Wrapper of ``cycles_screen_launch`` in ``csrc/cycles_closure.cu``
    (replaces ``jepsen_tpu/ops/cycles.py:400`` ``_screen_fn_variant``, its
    packed lowering).  Takes a contiguous ``(B, n, n)`` uint8 CUDA
    tensor, n a power of two in [32, 512], at most
    :data:`MAX_FILTERS` masks and :data:`MAX_LIFTED` queries; launches on
    the current stream without synchronising and counts its launches in
    :attr:`launches`."""

    name = "cycles_screen"

    def __init__(self):
        #: kernel launches so far (a plain counter; callers reset it)
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = _build.load("cycles_closure").cycles_screen_launch
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p, ctypes.c_int]
                           + [ctypes.c_void_p] * 2 + [ctypes.c_int,
                                                      ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, rel: torch.Tensor, masks: Sequence[int],
                 nonadj: Sequence[Tuple[int, int]], mode: str = "fixed"):
        _check_mode(mode)
        _require_cuda_u8(rel, "rel")
        B, n = check_relations(rel)
        _kernel_n(n, 32, MAX_PLANE // 2)
        F, Q = len(masks), len(nonadj)
        if F > MAX_FILTERS or Q > MAX_LIFTED:
            raise ValueError(f"{F} masks / {Q} lifted queries exceed "
                             f"{MAX_FILTERS} / {MAX_LIFTED}")
        vals = list(masks) + [x for q in nonadj for x in q]
        if any(not 0 <= int(v) < 256 for v in vals):
            raise ValueError("masks and (want, rest) must be bytes")
        dev = rel.device
        members = torch.empty((B, F, n), dtype=torch.bool, device=dev)
        walks = torch.empty((B, Q, n), dtype=torch.bool, device=dev)
        rounds = torch.empty((B,), dtype=torch.int32, device=dev)
        if B:
            u8 = ctypes.c_uint8
            m_arr = (u8 * MAX_FILTERS)(*masks)
            w_arr = (u8 * MAX_LIFTED)(*(w for w, _ in nonadj))
            r_arr = (u8 * MAX_LIFTED)(*(r for _, r in nonadj))
            scratch = torch.empty((2,), dtype=torch.int32, device=dev)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = self._entry()(
                    rel.data_ptr(), members.data_ptr(), walks.data_ptr(),
                    rounds.data_ptr(), scratch.data_ptr(), B, n, F,
                    ctypes.addressof(m_arr), Q, ctypes.addressof(w_arr),
                    ctypes.addressof(r_arr), int(mode == "earlyexit"),
                    stream)
            if err != 0:
                raise RuntimeError(f"{self.name} launch failed: CUDA error "
                                   f"{err} (B={B}, n={n}, F={F}, Q={Q})")
            self.launches += 1
        return members, walks, rounds


#: the has-cycle entry point's wrapper (its launch count shows a run went
#: through the kernel)
HAS_CYCLE = HasCycleKernel()

#: the screen entry point's wrapper
SCREEN = ScreenKernel()


def has_cycle(adj: torch.Tensor, mode: str = "fixed"):
    """``(flags, rounds)`` of a ``(B, n, n)`` batch: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if adj.is_cuda:
        return HAS_CYCLE(adj, mode)
    return has_cycle_reference(adj, mode)


def screen(rel: torch.Tensor, masks: Sequence[int],
           nonadj: Sequence[Tuple[int, int]], mode: str = "fixed"):
    """``(members, walks, rounds)`` of a ``(B, n, n)`` relation batch: the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if rel.is_cuda:
        return SCREEN(rel, masks, nonadj, mode)
    return screen_reference(rel, masks, nonadj, mode)


# ---------------------------------------------------------------------------
# dispatch caps and the engine plans
# ---------------------------------------------------------------------------


# jt: budget(0.9..1.01, allocated=0.9..1.01)
def cycles_row_bytes(n: int, n_filters: int = 1, n_lifted: int = 0) -> int:
    """Device bytes one row of a cycles dispatch holds: its ``n × n``
    relation bytes, a byte per vertex and a 4-byte round slot per plane,
    and its 4-byte ``rounds`` (the has-cycle kernel's one flag per row is
    within the screen's count at one filter).  A launch holds 4 bytes a
    plane less (its round slots live in shared memory), the has-cycle
    kernel n + 3 less (one flag, not n member bytes): the kernel audit's
    band."""
    return n * n + (max(1, n_filters) + n_lifted) * (n + 4) + 4


def cycles_max_dispatch(n: int, n_filters: int = 1, n_lifted: int = 0,
                        max_dispatch: Optional[int] = None) -> int:
    """Largest per-dispatch row count of a cycles kernel over ``n``-vertex
    graphs with ``n_filters`` filter planes and ``n_lifted`` lifted
    (2n × 2n) planes per row: :data:`CYCLES_DISPATCH_BUDGET` over
    :func:`cycles_row_bytes`, at most ``max_dispatch``.  0 when even one
    row exceeds the budget, or a plane exceeds :data:`MAX_PLANE` — callers
    take those graphs to the host path instead of dispatching."""
    if max_dispatch is None:
        max_dispatch = DEFAULT_CYCLES_MAX_DISPATCH
    per_row = cycles_row_bytes(n, n_filters, n_lifted)
    plane = 2 * n if n_lifted else n
    if per_row > CYCLES_DISPATCH_BUDGET or plane > MAX_PLANE:
        return 0
    return max(1, min(max_dispatch, CYCLES_DISPATCH_BUDGET // per_row))


class ScreenResult:
    """One graph's device screens, bucket-width: ``members[mask]`` and
    ``walks[(want, rest)]`` are per-vertex bool arrays over the padded
    bucket (callers slice by their own vertex count/order)."""

    __slots__ = ("members", "walks")

    def __init__(self, members, walks):
        self.members = members
        self.walks = walks


def _settle_closure_obs(plan, rounds: np.ndarray, n_live: int) -> None:
    """Record one settled dispatch's closure evidence (the reference's
    names): rounds run against the plan's full ladder (the earlyexit
    savings; zero in "fixed" mode), the live share of the dispatched
    planes, the arithmetic that ran (the port has one: 32-bit packed
    words), the live share of the carried word lanes, and the boolean
    operations the rounds stand for (~2·n³ per plane weight and round)."""
    if not obs.enabled() or rounds.size == 0:
        return
    used = int(rounds[: max(1, n_live)].max())
    obs.count("jepsen_cycles_closure_rounds_total", used, mode=plan.mode)
    obs.count("jepsen_cycles_closure_rounds_saved_total",
              max(0, plan.rounds_full - used), mode=plan.mode)
    obs.gauge_set("jepsen_cycles_packed_plane_occupancy",
                  n_live / rounds.shape[0])
    obs.count("jepsen_cycles_impl_total", 1, impl="packed32")
    obs.gauge_set("jepsen_cycles_word_lane_occupancy",
                  plan.E / (word_count(plan.E) * WORD_LANES))
    obs.count("jepsen_cycles_closure_flops_total",
              int(2.0 * float(plan.E) ** 3 * plan.frontier * used
                  * max(1, n_live)), mode=plan.mode)


class CyclePlan:
    """Self-settling Executor plan for the has-cycle screen: one
    ``(B, n, n)`` uint8 adjacency input, one cyclic flag (and the rounds)
    per row.  Row tokens are ``(sink, idx)``; settle writes ``sink[idx]``."""

    kernel = "cycles"
    #: neutral pad rows are all-zero matrices: edge-free, so acyclic
    pad_fills = (0,)
    __slots__ = ("fn", "disp", "E", "C", "frontier", "mode", "rounds_full")

    def __init__(self, n: int, mode: Optional[str] = None,
                 max_dispatch: Optional[int] = None):
        self.mode = mode = closure_mode(mode)
        self.fn = functools.partial(has_cycle, mode=mode)
        self.E, self.C, self.frontier = n, 0, 1
        self.rounds_full = closure_rounds(n)
        self.disp = cycles_max_dispatch(n, 1, 0, max_dispatch)

    def run_rows(self, mesh, arrays):
        """One padded chunk sharded over ``mesh`` (per-shard flags and
        rounds, nothing synchronised)."""
        from ..parallel import mesh as mesh_mod

        return mesh_mod.sharded_elle(self.fn, mesh, arrays[0], 2)

    def settle_rows(self, rows, mat, n_live: int) -> None:
        _settle_closure_obs(self, np.asarray(mat[1]), n_live)
        flags = np.asarray(mat[0])[:n_live]
        for row, (sink, idx) in enumerate(rows):
            sink[idx] = bool(flags[row])


class ScreenPlan:
    """Self-settling Executor plan for the full transactional screen of
    one (vertex bucket, filter profile): settle hands each row token's
    sink a :class:`ScreenResult` keyed by the profile's masks.  Its
    ``frontier`` is the profile's plane weight (the cost proxy's axis)."""

    kernel = "cycles"
    pad_fills = (0,)  # see CyclePlan.pad_fills
    __slots__ = ("fn", "disp", "E", "C", "frontier", "masks", "nonadj",
                 "mode", "rounds_full")

    def __init__(self, n: int, masks: Tuple[int, ...],
                 nonadj: Tuple[Tuple[int, int], ...],
                 mode: Optional[str] = None,
                 max_dispatch: Optional[int] = None):
        from ..elle import encode as encode_mod

        self.masks = tuple(masks)
        self.nonadj = tuple(nonadj)
        self.mode = mode = closure_mode(mode)
        self.fn = functools.partial(screen, masks=self.masks,
                                    nonadj=self.nonadj, mode=mode)
        self.E, self.C = n, 0
        self.frontier = encode_mod.plane_weight(self.masks, self.nonadj)
        self.rounds_full = ((closure_rounds(n) if self.masks else 0)
                            + (closure_rounds(2 * n) if self.nonadj else 0))
        self.disp = cycles_max_dispatch(n, len(self.masks), len(self.nonadj),
                                        max_dispatch)

    def run_rows(self, mesh, arrays):
        """One padded chunk sharded over ``mesh`` (per-shard members,
        walks and rounds, nothing synchronised)."""
        from ..parallel import mesh as mesh_mod

        return mesh_mod.sharded_elle(self.fn, mesh, arrays[0], 3)

    def settle_rows(self, rows, mat, n_live: int) -> None:
        _settle_closure_obs(self, np.asarray(mat[2]), n_live)
        members = np.asarray(mat[0])[:n_live]
        walks = np.asarray(mat[1])[:n_live]
        for row, (sink, idx) in enumerate(rows):
            sink[idx] = ScreenResult(
                {m: members[row, f] for f, m in enumerate(self.masks)},
                {q: walks[row, w] for w, q in enumerate(self.nonadj)},
            )


def _submit_elle_buckets(planned, window, executor, device) -> None:
    """Dispatch planned buckets through the engine (``executor``, sharded
    when it has a mesh, else one on ``device``), largest estimated cost
    first, then drain (every settle has run when this returns)."""
    from .. import device as device_mod
    from ..engine import execution, planning

    ex = executor if executor is not None else execution.Executor(
        window, device=device_mod.resolve(device))
    planned.sort(key=planning.estimated_cost, reverse=True)
    sub0 = ex.submitted
    total_rows = 0
    for pb in planned:
        total_rows += len(pb.rows)
        ex.submit(pb)
    ex.drain()
    n_disp = ex.submitted - sub0
    if obs.enabled() and n_disp:
        obs.registry().histogram(
            "jepsen_elle_graphs_per_dispatch",
            buckets=(1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0),
        ).observe(total_rows / n_disp)


# ---------------------------------------------------------------------------
# host paths for shapes over the dispatch cap
# ---------------------------------------------------------------------------


def _np_bool_closure(adj: np.ndarray) -> np.ndarray:
    """Host transitive closure by boolean matmul squaring over any leading
    batch shape."""
    r = np.asarray(adj, dtype=bool)
    for _ in range(closure_rounds(r.shape[-1])):
        r = r | (r @ r)
    return r


def _np_has_cycle(adj: np.ndarray):
    """Host has-cycle of one ``(n, n)`` matrix (→ bool) or a ``(B, n, n)``
    batch (→ ``(B,)`` bool)."""
    r = _np_bool_closure(adj)
    any_diag = np.diagonal(r, axis1=-2, axis2=-1).any(axis=-1)
    return any_diag if any_diag.ndim else bool(any_diag)


def _np_screen(rel: np.ndarray, masks: Sequence[int],
               nonadj: Sequence[Tuple[int, int]]):
    """Pure-numpy screen: ``(B, n, n)`` uint8 → ``(members (B, F, n),
    walks (B, Q, n))``."""
    rel = np.asarray(rel, np.uint8)
    B, n = rel.shape[0], rel.shape[-1]
    members = np.zeros((B, len(masks), n), bool)
    for f, mask in enumerate(masks):
        r = _np_bool_closure((rel & np.uint8(mask)) > 0)
        members[:, f] = (r & np.swapaxes(r, -1, -2)).any(axis=-1)
    walks = np.zeros((B, len(nonadj), n), bool)
    for q, (want, rest) in enumerate(nonadj):
        aw = (rel & np.uint8(want)) > 0
        ar = (rel & np.uint8(rest)) > 0
        top = np.concatenate([ar, aw], axis=-1)
        bot = np.concatenate([ar, np.zeros_like(ar)], axis=-1)
        c = _np_bool_closure(np.concatenate([top, bot], axis=-2))
        walks[:, q] = (aw & np.swapaxes(c[:, n:, :n], -1, -2)).any(axis=-1)
    return members, walks


#: host-path stacking bound, in uint32 words of resident state
_NP_STACK_BUDGET = 1 << 26


def _np_chunk_rows(n: int) -> int:
    """Host-path chunk size for ``n``-vertex graphs (word-packed rows of
    ``n·W`` words)."""
    return max(1, _NP_STACK_BUDGET // (n * word_count(n)))


def _np_packed_closure(rw: np.ndarray, n: int) -> np.ndarray:
    """Word-packed host closure: ``(B, n, W) uint32 → (B, n, W)``, ``n`` a
    multiple of 32; stops at the fixpoint."""
    rw = np.array(rw, np.uint32, copy=True)
    for _ in range(closure_rounds(n)):
        sq = np.zeros_like(rw)
        for j in range(WORD_LANES):
            pj = ((rw >> np.uint32(j)) & np.uint32(1)).astype(bool)
            rj = rw[:, j::WORD_LANES, :]
            sq |= np.bitwise_or.reduce(
                np.where(pj[..., None], rj[:, None, :, :], np.uint32(0)),
                axis=2,
            )
        nxt = rw | sq
        if np.array_equal(nxt, rw):
            break
        rw = nxt
    return rw


def _np_packed_has_cycle(rw: np.ndarray, n: int) -> np.ndarray:
    """Cyclic flags of a word-packed ``(B, n, W)`` stack, closed in
    sub-blocks whose squaring transient stays under the stack budget."""
    B, W = rw.shape[0], rw.shape[-1]
    blk = max(1, _NP_STACK_BUDGET // (n * W * W))
    flags = np.zeros(B, bool)
    idx = np.arange(n)
    shifts = (idx % WORD_LANES).astype(np.uint32)
    for lo in range(0, B, blk):
        closed = _np_packed_closure(rw[lo:lo + blk], n)
        diag = (closed[:, idx, idx // WORD_LANES] >> shifts) & 1
        flags[lo:lo + blk] = diag.any(axis=-1)
    return flags


# ---------------------------------------------------------------------------
# batch entry points
# ---------------------------------------------------------------------------


def has_cycle_batch(mats: Sequence[np.ndarray], window: Optional[int] = None,
                    executor=None, max_dispatch: Optional[int] = None,
                    device=None, mode: Optional[str] = None) -> np.ndarray:
    """Which of these adjacency matrices contain a cycle?  Matrices bucket
    by padded size (:func:`_bucket`), and each bucket dispatches through
    the engine :class:`~jepsen_tpu_torch.engine.execution.Executor`
    (``executor=``, else one on ``device`` with ``window``) under
    :func:`cycles_max_dispatch`; a bucket whose cap is 0 is decided on the
    host by the word-packed numpy closure.  ``mode`` resolves through
    :func:`closure_mode`."""
    from ..engine import planning

    out = np.zeros(len(mats), dtype=bool)
    by_bucket: dict = {}
    for i, m in enumerate(mats):
        by_bucket.setdefault(_bucket(max(1, m.shape[0])), []).append(i)
    planned = []
    for n, idxs in by_bucket.items():
        plan = CyclePlan(n, mode, max_dispatch)
        if plan.disp == 0:
            nw = word_count(n) * WORD_LANES  # word floor
            chunk = _np_chunk_rows(nw)
            for lo in range(0, len(idxs), chunk):
                part = idxs[lo:lo + chunk]
                stack = np.zeros((len(part), nw, word_count(nw)), np.uint32)
                for row, i in enumerate(part):
                    m = np.asarray(mats[i], dtype=bool)
                    plane = np.zeros((nw, nw), bool)
                    plane[: m.shape[0], : m.shape[1]] = m
                    stack[row] = pack_words_np(plane)
                out[part] = _np_packed_has_cycle(stack, nw)
            continue
        batch = np.zeros((len(idxs), n, n), dtype=np.uint8)
        for row, i in enumerate(idxs):
            m = mats[i]
            batch[row, : m.shape[0], : m.shape[1]] = np.asarray(m, bool)
        planned.append(planning.PlannedBucket(
            n, plan, (batch,), [(out, i) for i in idxs]))
    if planned:
        _submit_elle_buckets(planned, window, executor, device)
    return out


def screen_graphs(encs: Sequence, window: Optional[int] = None,
                  executor=None, max_dispatch: Optional[int] = None,
                  device=None, mode: Optional[str] = None
                  ) -> List[Optional[ScreenResult]]:
    """The full transactional screens of a batch of encoded graphs
    (:class:`jepsen_tpu_torch.elle.encode.EncodedGraph`): bucket by
    (vertex bucket, filter profile), stack each bucket into one
    ``(B, n, n)`` relation batch and dispatch it through the Executor.
    Graphs whose profile has cap 0 come back ``None`` — the caller keeps
    them on the CPU path.  ``mode`` resolves through :func:`closure_mode`
    (argument > calibration > ``"fixed"``)."""
    from ..elle import encode as encode_mod
    from ..engine import planning

    results: List[Optional[ScreenResult]] = [None] * len(encs)
    buckets, order = encode_mod.bucket_graphs(encs)
    planned = []
    for key in order:
        n, masks, nonadj = key
        plan = ScreenPlan(n, masks, nonadj, mode, max_dispatch)
        if plan.disp == 0:
            continue  # beyond the cap even one row at a time: CPU
        idxs = buckets[key]
        batch = encode_mod.stack_rel([encs[i] for i in idxs], n)
        planned.append(planning.PlannedBucket(
            key, plan, (batch,), [(results, i) for i in idxs]))
    if planned:
        _submit_elle_buckets(planned, window, executor, device)
    return results


def reachability(adj: np.ndarray, device=None) -> np.ndarray:
    """Full boolean transitive closure of one adjacency matrix: the
    has-cycle kernel at B = 1 returning its closure on a CUDA device, the
    plain version on the CPU, and the host closure past
    :data:`MAX_PLANE`."""
    from .. import device as device_mod

    adj = np.asarray(adj, dtype=bool)
    k = adj.shape[0]
    n = _bucket(max(1, k))
    if n > MAX_PLANE:
        return _np_bool_closure(adj)
    padded = np.zeros((1, n, n), dtype=np.uint8)
    padded[0, :k, :k] = adj
    t = torch.from_numpy(padded).to(device_mod.resolve(device))
    if t.is_cuda:
        _, _, closed = HAS_CYCLE(t, closure=True)
    else:
        _, _, closed = has_cycle_reference(t, closure=True)
    return closed[0, :k, :k].cpu().numpy()
