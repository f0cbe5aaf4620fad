"""Batched linearizability checking on the GPU — the port's entry point,
:func:`check_batch` (the counterpart of :mod:`jepsen_tpu.ops.wgl`).

It takes the reference's whole model table (:data:`.step_kernels.SPECS`)
and routes each encoded bucket as the reference's :func:`kernel_choice`
does:

- the unordered queue (:data:`DIRECT_FIRST_SPECS`) goes to the CPU
  oracle, whose direct checker beats every device kernel on it;
- a bucket inside the dense envelope (C ≤ 12 and a value domain ≤ 32,
  or S ≤ 128 composite states for multi-register and the permit
  semaphore) runs the dense subset automaton (:mod:`.dense`);
- the lock family outside the envelope (:data:`LINEAR_FRONTIER_SPECS`)
  goes to the oracle (``"oracle-routed"``), as does a dense-only spec
  (the permits) outside it;
- every other bucket runs the generic frontier search: per history a scan
  over events of a frontier of at most F configs ``(state, linset
  words)``; each completing event closes the frontier under linearizing
  every open op (K3 steps, F·C candidates, exact dedup and compaction
  back to F, K5) and keeps the configs that linearized the completing op.
  On the card that is the CUDA kernel ``csrc/frontier_search.cu`` (K4,
  with K3 and K5 inside it: one warp per history with its frontier in
  shared memory, or one block per history for large capacities,
  :func:`frontier_design`); with ``device="cpu"`` its plain PyTorch
  version :func:`frontier_check_reference`;
- a frontier row that overflows (more than F distinct configs, or a
  closure cut at ``max_closure``) reports overflow, never a verdict, and
  climbs the escalation ladder (:func:`escalate_overflows`: F × each
  ``escalation`` factor, then once at the provably sufficient capacity
  when affordable); rows still overflowed go to the CPU oracle, tagged
  ``"oracle-overflow"``;
- unencodable histories, and every history of a model without a spec
  (the fenced mutexes, the FIFO queue), go to the CPU oracle, tagged
  ``"oracle-fallback"``, as in the reference.

Given a :class:`~jepsen_tpu_torch.parallel.mesh.Mesh` (``mesh=``), every
dispatch shards its rows over the mesh's devices, each device running its
own checker on its shard with every row cap per device; with no mesh and
no device the run adopts every CUDA device when there are two or more
(:func:`~jepsen_tpu_torch.parallel.mesh.engine_default_mesh`).  Sharding
never moves a verdict: padding rows are neutral and sliced off.

Models that declare a partition (multi-register per key, multi-mutex
per lock name) are split into per-partition sub-histories ahead of all
of this (:mod:`jepsen_tpu_torch.engine.decompose`), unless the caller
passes ``decomposed=False``.

The port has one compaction, the reference's exact ``allpairs``
semantics: every duplicate config is removed, the lowest lane of each
class survives, survivors keep lane order.  Device results keep the
reference's dict schema with ``"engine": "gpu"`` where the reference
writes ``"tpu"``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import models as m
from ..history import History
from . import _build
from . import dense as dense_mod
from . import encode as encode_mod
from .step_kernels import STEP_IDS, STEPS

#: largest row count per device dispatch — bounds device memory for huge
#: keyspaces; the flagship shape (16384 × 1000-op histories) is one chunk
DEFAULT_MAX_DISPATCH = 16384

#: per-array pad fill for chunked dispatch: ev_slot/cand_slot use -1 as
#: "padding", so a padded row is an all-padding history (ok, never
#: failed) and every chunk of a bucket launches at one shape
_PAD_FILLS = (0, -1, -1, 0, 0, 0)

#: frontier capacity of the base pass
DEFAULT_FRONTIER = 128

#: overflowed rows retry on the device at frontier × each factor before
#: the CPU oracle gets them
ESCALATION_FACTORS = (4,)

#: largest frontier the guaranteed-sufficient escalation may allocate;
#: above it the oracle takes the leftovers
MAX_SUFFICIENT_FRONTIER = 8192

#: the CUDA kernel runs its warp design (one warp per history, the
#: frontier and its dedup table in shared memory) while C is at most
#: FRONTIER_WARP_MAX_C and F·(1 + W) + T, the words of F configs and a
#: table of T ≥ max(4F, 8) slots, at most FRONTIER_WARP_MAX_WORDS;
#: every other shape its block design (``kWarpMaxC``, ``kWarpMaxWords``
#: in ``csrc/frontier_search.cu``)
FRONTIER_WARP_MAX_WORDS = 8192
FRONTIER_WARP_MAX_C = 64

#: device memory one frontier dispatch may hold: its workspace (the
#: closure's F·(C+1) candidate lanes, the dedup table, the frontier) plus
#: its inputs and outputs.  4 GiB is 5% of an H100's 80 GB, so a window
#: of 4 in-flight chunks (each given a quarter of the cap, see
#: engine/execution.py) stays far below the card's memory next to the
#: dense path and the plain versions.
FRONTIER_DISPATCH_BUDGET = 4 << 30


#: single-lock model family whose frontier grows linearly in C — one
#: lock means at most one blocked acquire can linearize before the next
#: release completes, so past the dense envelope the CPU oracle (the
#: search-free direct checkers of checker/locks_direct.py) takes these
#: batches, as the reference routes them.  Not in the set: the permit
#: semaphore, which admits n_permits concurrent holders and, dense-only,
#: goes to the oracle outside its envelope anyway.
LINEAR_FRONTIER_SPECS = frozenset(
    {"mutex", "owner-mutex", "reentrant-mutex"}
)

#: specs the CPU direct checker takes even inside the dense envelope:
#: the unordered queue factors per value into a greedy matching
#: (checker/locks_direct.py), so the reference never dispatches it
DIRECT_FIRST_SPECS = frozenset({"unordered-queue"})


def _dense_domain(n_values):
    """The dense envelope's ``V``: a pair as it is, a scalar domain
    rounded up to 4."""
    if isinstance(n_values, (tuple, list)):
        return tuple(n_values)
    return encode_mod.round_up(n_values, 4)


def kernel_choice(spec_name: str, C: int, n_values) -> str:
    """Which engine the reference routes a shape to: "oracle" (a CPU
    direct algorithm takes it: :data:`DIRECT_FIRST_SPECS`, or the lock
    family outside the dense envelope), "dense" (subset automaton, no
    overflow) or "frontier" (the generic device search).  ``n_values`` is
    the value-domain bound, or a (Vr, K) / (N, P) pair."""
    if spec_name in DIRECT_FIRST_SPECS:
        return "oracle"
    if n_values is not None and dense_mod.applicable(
            spec_name, C, _dense_domain(n_values)):
        return "dense"
    if spec_name in LINEAR_FRONTIER_SPECS:
        return "oracle"
    return "frontier"


def make_best_check_fn(spec_name: str, E: int, C: int, F: int,
                       max_closure: int, n_values, device):
    """The device checker for a shape: the dense automaton inside its
    envelope, else the frontier search at capacity ``F``.  ``None`` when
    :func:`kernel_choice` routes the shape to the oracle, or for a
    dense-only spec outside its envelope (it has no frontier step): the
    caller sends those batches to the oracle with no dispatch."""
    choice = kernel_choice(spec_name, C, n_values)
    if choice == "oracle":
        return None
    if choice == "dense":
        return dense_mod.make_dense_fn(spec_name, E, C,
                                       _dense_domain(n_values), device)
    if spec_name not in STEPS:
        return None
    return make_check_fn(spec_name, E, C, F, max_closure, device)


def value_domain(spec_name: str, init_state, cand_a, cand_b) -> int:
    """Exclusive upper bound of the kernel state/value-id domain of a
    batch — the reentrant-mutex automaton runs over {0, 2c-1, 2c}, wider
    than the raw client-id bound, so its domain widens to 2N + 1."""
    n_values = 1 + int(
        max(
            np.asarray(init_state).max(),
            np.asarray(cand_a).max(),
            np.asarray(cand_b).max(),
        )
    )
    if spec_name == "reentrant-mutex":
        n_values = max(n_values, 2 * (n_values - 1) + 1)
    return n_values


# ---------------------------------------------------------------------------
# the frontier search: plain version (K4 with K3 and K5)
# ---------------------------------------------------------------------------

_TWO32 = 1 << 32
_HALF32 = 1 << 31


def linset_words(C: int) -> int:
    """32-bit linset words per config for ``C`` open-op slots."""
    return (C + 31) // 32


def _config_keys(states: torch.Tensor, words: torch.Tensor) -> list:
    """int64 key columns of each config, most significant first; equal
    columns iff equal configs.  ``states`` [n, K] int32, ``words`` [n, K,
    W] int64 holding 32-bit words.  Column 0 is state·2³² + word 0, the
    rest pack two more words each (the first offset by -2³¹), so no
    column overflows int64."""
    W = words.shape[-1]
    cols = [states.long() * _TWO32 + words[..., 0]]
    for w in range(1, W, 2):
        hi = words[..., w] - _HALF32
        lo = words[..., w + 1] if w + 1 < W else torch.zeros_like(hi)
        cols.append(hi * _TWO32 + lo)
    return cols


def _exact_survivors(states, words, valid) -> torch.Tensor:
    """[n, K] bool: the valid lanes that are the lowest valid lane of
    their class of equal configs — the reference's ``allpairs`` dedup
    (every duplicate removed, the minimum lane survives) by a stable
    lexicographic sort and a per-class ``amin``, without the [K, K]
    equality matrix."""
    n, K = valid.shape
    dev = valid.device
    cols = _config_keys(states, words)
    order = torch.arange(K, device=dev).expand(n, K)
    for col in reversed(cols):  # least significant column first
        _, idx = torch.sort(col.gather(1, order), dim=1, stable=True)
        order = order.gather(1, idx)
    first = torch.zeros((n, K), dtype=torch.bool, device=dev)
    first[:, 0] = True
    for col in cols:
        s = col.gather(1, order)
        first[:, 1:] |= s[:, 1:] != s[:, :-1]
    group = first.long().cumsum(1) - 1
    lane = torch.where(valid.gather(1, order), order, K)
    low = torch.full((n, K), K, dtype=torch.int64, device=dev)
    low = low.scatter_reduce(1, group, lane, "amin")
    keep = low.gather(1, group) == order
    return torch.zeros_like(valid).scatter(1, order, keep)


def _compact(states, words, v2, F: int):
    """Survivors in lane order into F slots: ``(states [n, F], words
    [n, F, W], valid [n, F], count [n])`` (the reference's
    ``_rank_gather``; slots past the count hold zeros, not its clamped
    gathers — nothing reads an invalid slot)."""
    n, K = v2.shape
    W = words.shape[-1]
    prefix = v2.long().cumsum(1)
    count = prefix[:, -1]
    dest = torch.where(v2 & (prefix <= F), prefix - 1, F)
    st = torch.zeros((n, F + 1), dtype=states.dtype, device=states.device)
    st.scatter_(1, dest, states)
    ws = torch.zeros((n, F + 1, W), dtype=words.dtype, device=words.device)
    ws.scatter_(1, dest[:, :, None].expand(n, K, W), words)
    valid = torch.arange(F, device=v2.device)[None, :] < count[:, None]
    return st[:, :F], ws[:, :F], valid, count


def _closure_pass(st, ws, vl, cs, cf, ca, cb, step, F: int):
    """One closure iteration over n rows (the reference's while-loop
    body): expand every config by every open slot it has not linearized,
    append the F·C candidates after the F old lanes (lane F + f·C + c),
    dedup exactly and compact back to F.  Returns ``(states, words,
    valid, grew, overflowed, cands, born)``; ``cands`` [n, F] counts each
    config's valid candidates, for the operation count, and ``born``
    [n, F, C] marks the candidate lanes that survived."""
    n, C = cs.shape
    W = ws.shape[2]
    active = cs >= 0
    slot = torch.where(active, cs, 0)
    wix = slot >> 5
    sh = slot & 31
    sel = ws.gather(2, wix[:, None, :].expand(n, F, C))
    already = (sel >> sh[:, None, :]) & 1
    st2, ok2 = step(st[:, :, None], cf[:, None, :], ca[:, None, :],
                    cb[:, None, :])
    st2 = st2.expand(n, F, C)
    nv = vl[:, :, None] & active[:, None, :] & (already == 0) & ok2
    onehot = wix[:, :, None] == torch.arange(W, device=cs.device)
    setbit = torch.where(onehot, torch.ones_like(sh)[:, :, None]
                         << sh[:, :, None], 0)
    nws = ws[:, :, None, :] | setbit[:, None, :, :]
    all_st = torch.cat([st, st2.reshape(n, F * C)], 1)
    all_ws = torch.cat([ws, nws.reshape(n, F * C, W)], 1)
    all_vl = torch.cat([vl, nv.reshape(n, F * C)], 1)
    v2 = _exact_survivors(all_st, all_ws, all_vl)
    grew = v2[:, F:].any(1)
    s3, w3, v3, count = _compact(all_st, all_ws, v2, F)
    return s3, w3, v3, grew, count > F, nv.sum(2), v2[:, F:].view(n, F, C)


def _get_bit(ws, slot):
    """Linset bit of ``slot`` [n] in each config ``ws`` [n, F, W]."""
    n, F, _ = ws.shape
    word = ws.gather(2, (slot >> 5)[:, None, None].expand(n, F, 1))[..., 0]
    return (word >> (slot & 31)[:, None]) & 1


def frontier_check_reference(
    init_state: torch.Tensor,
    ev_slot: torch.Tensor,
    cand_slot: torch.Tensor,
    cand_f: torch.Tensor,
    cand_a: torch.Tensor,
    cand_b: torch.Tensor,
    *,
    spec_name: str,
    F: int,
    max_closure: int,
    work: Optional[dict] = None,
):
    """The plain PyTorch version of the frontier search, on any device:
    ``(ok [B] bool, failed_at [B] int32, overflow [B] bool)``, equal to
    the reference's ``build_batched(..., compaction="allpairs")`` on
    every row, overflowed rows included.

    Per non-padding event of a row not yet done: the closure loop runs
    while the last pass grew the frontier, nothing overflowed and fewer
    than ``max_closure`` passes ran (stopping at the cap while growing
    counts as overflow); then configs holding the completing slot's bit
    survive with that bit cleared, and a row left with none is done at
    that event (``failed_at`` counts padding events too).  Overflow
    accumulates over the events a row processes.  Linset words ride
    int64 tensors masked to 32 bits (``uint32`` has no shifts on the
    CPU).

    ``work``, when given, gains ``"int_ops"``: the 32-bit integer
    operations the search needs for these inputs — what
    ``chip_smoke.py`` prices the kernel's bound with.  Per event of a
    row, counted semi-naively: every config is expanded once, the
    event's starting configs by the first closure pass and the configs a
    pass adds by the next, at 4 per (config, open slot) pair (test the
    slot's bit, the step's compare, set the bit, the validity AND); every
    config enters the event's dedup table once, the starting configs and
    each valid candidate, at 2·W + 3 (hash and compare W + 1 words, one
    prefix add); per completion, 3 per valid config (test and clear the
    bit, count it).  Not counted: loads and stores, clearing the dedup
    table, the step's other compares and selects, and the configs a
    naive closure expands again on every pass.

    ``work`` also gains ``"stale_survivors"``: survivors whose parent an
    earlier closure pass of the same event expanded (0 on every input,
    which is what lets the kernel expand only the configs the last pass
    appended), and ``"max_frontier"``: the most configs a frontier held
    after a closure pass."""
    step = STEPS[spec_name]
    dev = ev_slot.device
    B, E = ev_slot.shape
    C = cand_slot.shape[2]
    W = linset_words(C)
    states = torch.zeros((B, F), dtype=torch.int32, device=dev)
    states[:, 0] = init_state
    words = torch.zeros((B, F, W), dtype=torch.int64, device=dev)
    valid = torch.zeros((B, F), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    failed_at = torch.full((B,), -1, dtype=torch.int32, device=dev)
    overflow = torch.zeros((B,), dtype=torch.bool, device=dev)
    int_ops = stale = max_frontier = 0

    for e in range(E):
        # padding events and finished rows leave the carry alone
        rows = ((ev_slot[:, e] >= 0) & ~done).nonzero().squeeze(1)
        n = rows.numel()
        if n == 0:
            continue
        st, ws, vl = states[rows], words[rows], valid[rows]
        cs = cand_slot[rows, e].long()
        cf, ca, cb = cand_f[rows, e], cand_a[rows, e], cand_b[rows, e]
        changed = torch.ones((n,), dtype=torch.bool, device=dev)
        ovf = torch.zeros((n,), dtype=torch.bool, device=dev)
        it = torch.zeros((n,), dtype=torch.int64, device=dev)
        fresh = vl.clone()  # configs this event has not expanded yet
        while True:
            live = (changed & ~ovf & (it < max_closure)).nonzero().squeeze(1)
            if live.numel() == 0:
                break
            s3, w3, v3, grew, o3, cands, born = _closure_pass(
                st[live], ws[live], vl[live], cs[live], cf[live], ca[live],
                cb[live], step, F)
            if work is not None:
                fr, held = fresh[live], vl[live].sum(1)
                inserts = ((cands * fr).sum(1)
                           + torch.where(it[live] == 0, held, 0))
                pairs = fr.sum(1) * (cs[live] >= 0).sum(1)
                int_ops += int((4 * pairs + (2 * W + 3) * inserts).sum())
                stale += int((born & ~fr[:, :, None]).sum())
                max_frontier = max(max_frontier, int(v3.sum(1).max()))
                # the old configs survive first, in order: the rest are new
                fresh[live] = v3 & (torch.arange(F, device=dev)[None, :]
                                    >= held[:, None])
            st[live], ws[live], vl[live] = s3, w3, v3
            changed[live] = grew
            ovf[live] |= o3
            it[live] += 1
        ovf_c = ovf | (changed & (it >= max_closure))

        es = ev_slot[rows, e].long()
        has = _get_bit(ws, es) == 1
        if work is not None:
            int_ops += int(3 * vl.sum())
        vl_f = vl & has
        clear = torch.where(
            (es >> 5)[:, None] == torch.arange(W, device=dev)[None, :],
            torch.ones_like(es)[:, None] << (es & 31)[:, None], 0)
        states[rows] = st
        words[rows] = ws & ~clear[:, None, :]
        valid[rows] = vl_f
        empty = ~vl_f.any(1)
        failed_at[rows[empty]] = e
        done[rows[empty]] = True
        overflow[rows] |= ovf_c

    if work is not None:
        work["int_ops"] = work.get("int_ops", 0) + int_ops
        work["stale_survivors"] = work.get("stale_survivors", 0) + stale
        work["max_frontier"] = max(work.get("max_frontier", 0), max_frontier)
    return ~done, failed_at, overflow


# ---------------------------------------------------------------------------
# the frontier search: the CUDA kernel's wrapper and the checker module
# ---------------------------------------------------------------------------


def frontier_row_bytes(F: int, E: int, C: int) -> int:
    """Device bytes one row of a frontier dispatch holds, at most: its
    inputs (4 + 4E + 6EC), its outputs (6) and the block design's
    workspace — for K = F·(C+1) candidate lanes their states, W words each
    and table slots, a dedup table of under 4K slots, two frontier buffers
    of F configs, 4-byte elements (the kernel's own count,
    ``frontier_search_workspace_bytes``, is what the wrapper allocates:
    none for a shape that runs the warp design, which keeps its frontier
    in shared memory)."""
    W = linset_words(C)
    K = F * (C + 1)
    workspace = 4 * (K * (2 + W) + 4 * K + 2 * F * (1 + W)) + 16
    return workspace + 4 + 4 * E + 6 * E * C + 6


def frontier_design(F: int, C: int) -> str:
    """Which design of the CUDA kernel a launch at capacity ``F`` over
    ``C`` slots runs: ``"warp"`` (one warp per history, the frontier, its
    dedup table and the event's candidate lanes in the warp's slice of
    shared memory, no block barrier) while ``C ≤``
    :data:`FRONTIER_WARP_MAX_C` and F·(1 + W) + T ≤
    :data:`FRONTIER_WARP_MAX_WORDS` (T the smallest power of two ≥ 4F
    and ≥ 8), else ``"block"`` (one block per history, its workspace in
    device memory)."""
    W = linset_words(C)
    T = 1 << (max(4 * F, 8) - 1).bit_length()
    if C <= FRONTIER_WARP_MAX_C and F * (1 + W) + T <= FRONTIER_WARP_MAX_WORDS:
        return "warp"
    return "block"


def frontier_max_dispatch(F: int, E: int, C: int,
                          max_dispatch: int = DEFAULT_MAX_DISPATCH) -> int:
    """Largest per-dispatch row count of a frontier search at capacity
    ``F`` over ``E`` events and ``C`` slots: :data:`FRONTIER_DISPATCH_BUDGET`
    over :func:`frontier_row_bytes`, at most ``max_dispatch``.  0 when even
    one row exceeds the budget — callers must not dispatch that shape
    (the escalation rung is skipped, the oracle takes the rows)."""
    per_row = frontier_row_bytes(F, E, C)
    if per_row > FRONTIER_DISPATCH_BUDGET:
        return 0
    return max(1, min(max_dispatch, FRONTIER_DISPATCH_BUDGET // per_row))


def check_frontier_inputs(arrays):
    """:func:`dense.batch_shape` plus the frontier's own limits: C ≤ 127
    (cand_slot is int8) and every slot id in [-1, C).  Returns
    ``(B, E, C)``."""
    B, E, C = dense_mod.batch_shape(arrays)
    if not 1 <= C <= 127:
        raise ValueError(f"C={C} is outside 1..127 (int8 slot ids)")
    for t, name in ((arrays[1], "ev_slot"), (arrays[2], "cand_slot")):
        if t.numel():
            lo, hi = (int(x) for x in torch.aminmax(t))
            if lo < -1 or hi >= C:
                raise ValueError(f"{name} holds slot ids in [{lo}, {hi}], "
                                 f"outside [-1, {C})")
    return B, E, C


class FrontierSearchKernel:
    """Wrapper of the hand-written CUDA kernel ``csrc/frontier_search.cu``
    (replaces ``jepsen_tpu/ops/wgl.py:build_batched`` with its step
    functions and exact compaction; :func:`frontier_design` says which of
    its two designs a shape runs).  Takes CUDA tensors only, allocates
    the per-row workspace the kernel asks for, launches on the current
    stream without synchronising, and counts its launches in
    :attr:`launches`."""

    name = "frontier_search"

    def __init__(self):
        #: kernel launches so far (a plain counter; callers reset it)
        self.launches = 0
        self._fn = None

    def _entry(self):
        """``(launch, workspace_bytes)`` of the loaded library."""
        if self._fn is None:
            lib = _build.load(self.name)
            size = lib.frontier_search_workspace_bytes
            size.argtypes = [ctypes.c_int, ctypes.c_int]
            size.restype = ctypes.c_longlong
            fn = lib.frontier_search_launch
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn, size
        return self._fn

    def __call__(self, init_state, ev_slot, cand_slot, cand_f, cand_a,
                 cand_b, *, spec_name: str, F: int, max_closure: int):
        arrays = (init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b)
        dev = init_state.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
        B, E, C = check_frontier_inputs(arrays)
        if F < 1:
            raise ValueError(f"frontier capacity F={F} must be ≥ 1")
        ok = torch.empty((B,), dtype=torch.bool, device=dev)
        failed_at = torch.empty((B,), dtype=torch.int32, device=dev)
        overflow = torch.empty((B,), dtype=torch.bool, device=dev)
        if B == 0:
            return ok, failed_at, overflow
        fn, size = self._entry()
        workspace = torch.empty((B * size(F, C),), dtype=torch.uint8,
                                device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*(t.data_ptr() for t in arrays), ok.data_ptr(),
                     failed_at.data_ptr(), overflow.data_ptr(),
                     workspace.data_ptr(), B, E, C, F, max_closure,
                     STEP_IDS[spec_name], stream)
        if err != 0:
            raise RuntimeError(
                f"frontier_search launch failed: CUDA error {err} (B={B}, "
                f"E={E}, C={C}, F={F}, spec={spec_name})")
        self.launches += 1
        return ok, failed_at, overflow


#: the one wrapper of the frontier-search kernel (its launch count is what
#: shows that a run went through the kernel)
FRONTIER_SEARCH = FrontierSearchKernel()


class FrontierChecker:
    """The frontier search for one ``(spec, E, C, F, max_closure)`` shape,
    called as ``checker(init_state, ev_slot, cand_slot, cand_f, cand_a,
    cand_b) -> (ok, failed_at, overflow)``.  CUDA tensors go to the CUDA
    kernel, CPU tensors to the plain version; there is no fallback
    between the two.  It holds no tensors, so one checker serves every
    device.  :attr:`safe_dispatch` is the shape's per-dispatch row cap
    (:func:`frontier_max_dispatch`)."""

    def __init__(self, spec_name: str, E: int, C: int, F: int,
                 max_closure: int):
        if spec_name not in STEPS:
            raise ValueError(f"no frontier step for {spec_name!r}")
        self.spec_name, self.E, self.C = spec_name, E, C
        self.F, self.max_closure = F, max_closure
        self.safe_dispatch = frontier_max_dispatch(F, E, C)

    def reference(self, *arrays, work: Optional[dict] = None):
        """The plain PyTorch version on the arrays' device."""
        check_frontier_inputs(arrays)
        return frontier_check_reference(
            *arrays, spec_name=self.spec_name, F=self.F,
            max_closure=self.max_closure, work=work)

    def __call__(self, *arrays):
        if arrays[0].is_cuda:
            return FRONTIER_SEARCH(*arrays, spec_name=self.spec_name,
                                   F=self.F, max_closure=self.max_closure)
        return self.reference(*arrays)


_checker = lru_cache(maxsize=64)(FrontierChecker)


def make_check_fn(spec_name: str, E: int, C: int, F: int, max_closure: int,
                  device=None) -> FrontierChecker:
    """The cached :class:`FrontierChecker` for a shape (one per shape, like
    the reference's per-shape jit cache).  ``device`` is taken for parity
    with :func:`.dense.make_dense_fn` and not used: the checker runs where
    its inputs lie."""
    return _checker(spec_name, E, C, F, max_closure)


# ---------------------------------------------------------------------------
# routing and the escalation ladder
# ---------------------------------------------------------------------------


def sufficient_frontier(n_values, C: int,
                        spec_name: Optional[str] = None) -> Optional[int]:
    """A frontier capacity that can never overflow, when affordable.

    A register-family config is (value id < n_values, linset ⊆ C slots),
    so at most n_values·2^C distinct configs exist (a multi-register
    ``(Vr, K)`` pair counts Vr^K states); for the unordered queue a
    config's state is a function of its linset, so 2^C.  With exact dedup
    a frontier that large cannot overflow, so one rerun at it settles
    every overflowed row on the device.  For states that outgrow value
    ids (the mutex, the packed multi-register) the bound is a heuristic:
    the rerun still tracks overflow.  Rounded up to a power of two; None
    above :data:`MAX_SUFFICIENT_FRONTIER` (or C ≥ 31)."""
    if C >= 31:
        return None
    if isinstance(n_values, (tuple, list)):  # multi-register (Vr, K)
        n_values = int(n_values[0]) ** int(n_values[1])
    bound = (1 << C) if spec_name == "unordered-queue" else n_values << C
    if bound <= 0 or bound > MAX_SUFFICIENT_FRONTIER:
        return None
    return 1 << (bound - 1).bit_length()


class BucketPlan:
    """The routing decision for one encoded ``[B, E, C]`` bucket: which
    kernel serves the shape, the device checker, its per-dispatch row cap
    (0 = not even one row fits: the oracle takes the bucket), and the
    shape facts (``mc``, ``n_values``, ``frontier``) the escalation ladder
    needs."""

    __slots__ = ("spec", "E", "C", "mc", "n_values", "kernel", "fn", "disp",
                 "frontier")

    def overflow_engine(self) -> str:
        """The engine tag of a row the device leaves unresolved: routed to
        the oracle by choice, or landed there off the device."""
        return ("oracle-routed" if self.kernel == "oracle"
                else "oracle-overflow")


def plan_bucket(model, spec, arrays, *, device,
                frontier: int = DEFAULT_FRONTIER,
                max_closure: Optional[int] = None,
                max_dispatch: int = DEFAULT_MAX_DISPATCH) -> BucketPlan:
    """Pick the kernel for one encoded bucket's arrays (the 6-tuple
    ``(init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b)`` with at
    least one row).  The permit automaton's shape is ``(N, P)``, clients
    rounded up to 4 and the model's permit count; multi-register's is
    ``(Vr, K)`` (:func:`.dense.mr_shape_probe`); every other spec's is
    :func:`value_domain`.  An explicit ``max_closure`` asks for the
    frontier search's truncation semantics and forces it, as in the
    reference; a dense-only spec has none, so the oracle takes such a
    bucket.  ``plan.fn is None`` sends the bucket to the oracle."""
    init_state, ev_slot, cand_slot, _cand_f, cand_a, cand_b = arrays
    plan = BucketPlan()
    plan.spec = spec
    plan.frontier = frontier
    plan.E = E = ev_slot.shape[1]
    plan.C = C = cand_slot.shape[2]  # bucketed to actual concurrency
    # closure depth is bounded by the open-op count (≤ C), +1 for the
    # fixpoint-confirming pass
    plan.mc = mc = max_closure if max_closure is not None else C + 1
    if spec.name == "acquired-permits":
        # client ids are contiguous 1..N; N rounds up to 4 so drifting
        # client counts share a few shapes (a larger table is a superset)
        n_values = (encode_mod.round_up(int(max(cand_a.max(), 0)), 4),
                    int(getattr(model, "n_permits", 2)))
    elif spec.name == "multi-register":
        n_values = dense_mod.mr_shape_probe(init_state, cand_a, cand_b)
    else:
        n_values = value_domain(spec.name, init_state, cand_a, cand_b)
    plan.n_values = n_values
    if max_closure is None:
        plan.kernel = kernel_choice(spec.name, C, n_values)
        plan.fn = make_best_check_fn(spec.name, E, C, frontier, mc,
                                     n_values, device)
    else:
        plan.kernel = "frontier"
        plan.fn = (None if spec.dense_only
                   else make_check_fn(spec.name, E, C, frontier, mc, device))
    plan.disp = (0 if plan.fn is None else
                 min(max_dispatch,
                     getattr(plan.fn, "safe_dispatch", max_dispatch)))
    return plan


#: rows each escalation rung re-ran, by capacity (a plain counter on the
#: CPU and the card alike; callers clear it) — what shows that a run
#: climbed the ladder
ESCALATIONS: Dict[int, int] = {}


def _run_rows(fn, arrays, device, disp: int, mesh=None):
    """Run ``fn`` over host ``arrays`` in chunks of at most ``disp`` rows on
    ``device``, or sharded over ``mesh`` (``disp`` is then the whole
    chunk: the mesh size × the per-device cap), synchronously; outputs as
    numpy."""
    from ..parallel import mesh as mesh_mod

    placement = mesh if mesh is not None else mesh_mod.Mesh((device,))
    B = arrays[0].shape[0]
    outs = []
    for lo in range(0, B, disp):
        shards = mesh_mod.sharded_check(
            fn, placement, *(a[lo:lo + disp] for a in arrays))
        outs.append(tuple(np.concatenate([s.cpu().numpy() for s in o])
                          for o in shards))
    return tuple(np.concatenate([o[i] for o in outs]) for i in range(3))


def overflow_rows(arrays, overflow: np.ndarray):
    """The overflowed rows of host ``arrays`` as an escalation rung reruns
    them: ``(rows, sub-arrays)``, the sub-arrays padded to a multiple of 8
    rows with neutral all-padding rows."""
    bad = np.flatnonzero(overflow)
    n_pad = encode_mod.round_up(len(bad), 8) - len(bad)
    sub = tuple(a[np.concatenate([bad, np.zeros((n_pad,), bad.dtype)])]
                for a in arrays)
    sub[1][len(bad):] = -1  # ev_slot: every event padding
    return bad, sub


def escalate_overflows(plan: BucketPlan, arrays, ok: np.ndarray,
                       failed_at: np.ndarray, overflow: np.ndarray, *,
                       device, mesh=None, escalation=ESCALATION_FACTORS,
                       sufficient_rung: bool = True,
                       max_dispatch: int = DEFAULT_MAX_DISPATCH) -> None:
    """Retry overflowed rows on the device at growing frontier capacities,
    writing verdicts back into ``ok``/``failed_at``/``overflow`` in place:
    F × each ``escalation`` factor, then — when ``sufficient_rung`` and
    :func:`sufficient_frontier` is affordable and no rung reached it —
    once at ``max(sufficient, F)``.  Each rerun is padded to a multiple of
    8 rows with neutral all-padding rows; a rung that cannot dispatch
    even one row is skipped.  Under a ``mesh`` the reruns shard over its
    devices, each holding at most the rung's per-device cap.  Rows still
    overflowed afterwards are the oracle's.  A plan with no device
    checker (oracle-routed, or a dense-only spec) has no rungs."""
    if plan.fn is None or plan.spec.dense_only:
        return
    capacities = [plan.frontier * factor for factor in escalation]
    suff = (sufficient_frontier(plan.n_values, plan.C, plan.spec.name)
            if sufficient_rung else None)
    if suff is not None and not any(c >= suff for c in capacities):
        capacities.append(max(suff, plan.frontier))
    for capacity in capacities:
        if not overflow.any():
            break
        fn2 = make_check_fn(plan.spec.name, plan.E, plan.C, capacity,
                            plan.mc, device)
        # per-device cap: a mesh rerun shards its rows evenly
        n_dev = 1 if mesh is None else mesh.size
        disp2 = min(max_dispatch, fn2.safe_dispatch) * n_dev
        if disp2 == 0:
            continue
        bad, sub = overflow_rows(arrays, overflow)
        n_bad = len(bad)
        ESCALATIONS[capacity] = ESCALATIONS.get(capacity, 0) + n_bad
        ok2, failed2, ovf2 = (x[:n_bad] for x in
                              _run_rows(fn2, sub, device, disp2, mesh))
        ok[bad] = ok2
        failed_at[bad] = failed2
        overflow[bad] = ovf2


def check_batch(
    model: m.Model,
    histories: Sequence[History],
    *,
    frontier: int = DEFAULT_FRONTIER,
    slot_cap: int = encode_mod.DEFAULT_SLOT_CAP,
    max_closure: Optional[int] = None,
    escalation=ESCALATION_FACTORS,
    oracle_fallback: bool = True,
    sufficient_rung: bool = True,
    max_dispatch: int = DEFAULT_MAX_DISPATCH,
    window: Optional[int] = None,
    bucketed: bool = True,
    decomposed: bool = True,
    device=None,
    mesh=None,
    stats: Optional[dict] = None,
) -> List[dict]:
    """Check a batch of histories; per-history result dicts in input
    order, as :func:`jepsen_tpu.ops.wgl.check_batch` returns them (with
    ``"engine": "gpu"`` for device verdicts).

    ``device`` defaults to the current CUDA device and raises without
    CUDA; ``device="cpu"`` runs the plain PyTorch version of every kernel.
    ``mesh`` (a :class:`~jepsen_tpu_torch.parallel.mesh.Mesh`) shards
    every dispatch over its devices; with neither ``mesh`` nor ``device``
    the run adopts :func:`~jepsen_tpu_torch.parallel.mesh.
    engine_default_mesh` (every CUDA device when there are two or more;
    naming a device keeps the run on it).  Row caps are per device, and
    sharding never moves a verdict.  ``stats``, when given, gains the
    run's dispatch counters: the devices, the padding rows and the live
    and total rows per device.
    Histories are encoded into per-(E, C) shape buckets and dispatched
    through a bounded in-flight ``window`` (default 4; 1 = strictly
    serial); CPU-oracle fallbacks run on a worker pool alongside device
    work.  Verdicts are independent of ``window`` and ``bucketed``.

    Frontier shapes search at capacity ``frontier``; ``max_closure``
    (default C + 1 per bucket) caps each closure and, when given, forces
    the frontier search for every bucket.  Overflowed rows retry on the
    device at frontier × each ``escalation`` factor, then (with
    ``sufficient_rung``) once at a capacity that cannot overflow when
    that is affordable, and only then go to the oracle
    (``"oracle-overflow"``).  With ``oracle_fallback=False`` rows the
    device cannot settle report ``"unknown"``.  Batches larger than
    ``max_dispatch`` rows run as chunks.

    Models that declare a partition (multi-register per key, multi-mutex
    per lock name) are split into per-partition sub-histories ahead of
    planning when ``decomposed`` (the default, as in the reference); the
    sub-verdicts AND back into one result per history, a failing one
    naming its ``failed-partition``.  Decomposition never moves a
    verdict."""
    from ..engine import pipeline

    return pipeline.run(
        model,
        histories,
        frontier=frontier,
        slot_cap=slot_cap,
        max_closure=max_closure,
        escalation=escalation,
        oracle_fallback=oracle_fallback,
        sufficient_rung=sufficient_rung,
        max_dispatch=max_dispatch,
        window=window,
        bucketed=bucketed,
        decomposed=decomposed,
        device=device,
        mesh=mesh,
        stats=stats,
    )


def batch_stats(results: Sequence[dict]) -> dict:
    """Engine breakdown for a check_batch result list — the share of
    histories the device decided vs the CPU oracle."""
    counts: dict = {}
    kernels: dict = {}
    for r in results:
        counts[r.get("engine", "?")] = counts.get(r.get("engine", "?"), 0) + 1
        if r.get("engine") == "gpu":
            k = r.get("kernel", "?")
            kernels[k] = kernels.get(k, 0) + 1
    n = max(1, len(results))
    return {
        "engines": counts,
        "kernels": kernels,
        "device-rate": counts.get("gpu", 0) / n,
        "oracle-rate": sum(
            v for k, v in counts.items() if k.startswith("oracle")
        ) / n,
    }


def analysis(model: m.Model, history: History, **kw) -> dict:
    """Single-history entry point matching checker.linear.analysis."""
    return check_batch(model, [history], **kw)[0]
