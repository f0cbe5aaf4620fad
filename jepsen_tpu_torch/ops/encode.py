"""Host-side encoding of histories into the padded int arrays the device
kernels consume.

A copy of :mod:`jepsen_tpu.ops.encode`: the same arrays, dtypes, fallback
lists and row order for the same histories (``tests/test_torch_encode.py``
pins it), so the port and the JAX package can be held against each
other on identical inputs.  Encoding stays host numpy; the engine moves
the stacked arrays to the device.

The key idea is *slot remapping*: at any moment at most ``slot_cap`` ops
are open (invoked, not yet ok — including indeterminate ops, which stay
open forever), so each op borrows a transient slot id and a config's
linearized-set fits one uint32 **independent of history length**.  Slots
free when their op completes (the completed op joins the common linearized
prefix); info ops hold their slot to the end.

Invoke and info events are no-ops for the search (closure is deferred to
the filtering events — see jepsen_tpu_torch.checker.linear), so the event stream
the device sees is just the *ok* completions, each with a snapshot of the
currently-open candidate ops:

- ``ev_slot[E]``      slot of the op completing at event e (-1 = padding)
- ``cand_slot[E,C]``  open slots at event e (-1 = unused lane)
- ``cand_f/a/b[E,C]`` the op encodings for those slots

Histories whose open-op count ever exceeds slot_cap fall back to the CPU
oracle (reported by returning None), mirroring how the reference degrades
to :unknown rather than guessing (checker.clj:74-85).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..history import History
from ..checker import linear
from .. import models as m
from .step_kernels import ModelSpec, spec_for

DEFAULT_SLOT_CAP = 32

#: value ids ride int16 lanes to halve HBM/PCIe traffic for the event
#: stream; histories with more distinct values fall back to the oracle
MAX_VALUE_ID = 32_000


@dataclass
class EncodedHistory:
    init_state: int
    ev_slot: np.ndarray      # [E] int32
    cand_slot: np.ndarray    # [E, C] int8 (-1 = unused lane)
    cand_f: np.ndarray       # [E, C] int8
    cand_a: np.ndarray       # [E, C] int16
    cand_b: np.ndarray       # [E, C] int16
    n_ops: int
    #: peak concurrently-open op count — every slot id used is < this, so
    #: the batch can trim candidate lanes (and linset bits) down to it
    max_open: int = 0


@dataclass
class EncodedBatch:
    """A stack of encoded histories padded to common [B, E, C] shapes."""

    init_state: np.ndarray   # [B] int32
    ev_slot: np.ndarray      # [B, E] int32
    cand_slot: np.ndarray    # [B, E, C]
    cand_f: np.ndarray       # [B, E, C]
    cand_a: np.ndarray       # [B, E, C]
    cand_b: np.ndarray       # [B, E, C]
    #: positions of histories that could not be encoded (oracle fallback)
    fallback: List[int] = field(default_factory=list)
    #: original batch order index per encoded row
    row_history: List[int] = field(default_factory=list)


def _prepare_encoding(history, model, spec):
    """Shared front half: event stream + per-op (f, a, b) codes, or
    None when the model/ops can't be encoded."""
    events, ops = linear.prepare(history, pure_fs=spec.pure_fs)
    valmap: Dict[Any, int] = {}
    try:
        init = spec.init_state(model, valmap)
        enc_ops = [spec.encode_op(op, valmap) for op in ops]
    except ValueError:
        return None
    if len(valmap) > MAX_VALUE_ID:
        return None  # value ids would overflow the int16 lanes
    return events, ops, init, enc_ops


def encode_history(
    history: History,
    model: m.Model,
    slot_cap: int = DEFAULT_SLOT_CAP,
    spec: Optional[ModelSpec] = None,
) -> Optional[EncodedHistory]:
    """Encode one history, or None if unsupported (model has no kernel,
    open-op count exceeds slot_cap, or an op can't be encoded).

    The per-event candidate snapshots are built vectorized — an op is a
    candidate at completion row r iff its invoke precedes r's event
    position and its own completion doesn't, a CONTIGUOUS row range
    computed via searchsorted, so work and memory scale with candidate
    pairs (E × average open ops), never E × n_ops — because host
    encoding is the production ingest path and per-event Python loops
    would cap the device's throughput (SURVEY.md §7, host↔device feed
    rate).  Only slot assignment stays a (cheap, O(n)) sequential
    pass: which slot an op borrows depends on the free set at its
    invoke."""
    import heapq

    spec = spec or spec_for(model)
    if spec is None:
        return None
    pre = _prepare_encoding(history, model, spec)
    if pre is None:
        return None
    events, ops, init, enc_ops = pre

    n = len(ops)
    T = len(events)
    # event-position bookkeeping: t_inv[o], t_done[o] (inf if never ok),
    # and the stream positions of ok events (the kernel's rows); kept in
    # Python lists while the pass runs (a numpy element access costs
    # more than an event's work) and made arrays after it
    t_inv_l = [0] * n
    t_done_l = [T + 1] * n
    ok_pos = []
    ok_op_ids = []
    slot_l = [-1] * n
    free: list = list(range(slot_cap))
    heapq.heapify(free)
    heappop, heappush = heapq.heappop, heapq.heappush
    open_count = 0
    max_open = 0
    for t, (kind, op_id) in enumerate(events):
        if kind == "invoke":
            if not free:
                return None  # too many concurrently-open ops
            slot_l[op_id] = heappop(free)
            t_inv_l[op_id] = t
            open_count += 1
            if open_count > max_open:
                max_open = open_count
        elif kind == "ok":
            t_done_l[op_id] = t
            ok_pos.append(t)
            ok_op_ids.append(op_id)
            heappush(free, slot_l[op_id])
            open_count -= 1
        # info: op keeps its slot forever
    t_inv = np.asarray(t_inv_l, np.int64)
    t_done = np.asarray(t_done_l, np.int64)
    slot = np.asarray(slot_l, np.int16)

    E = len(ok_pos)
    C = slot_cap
    cand_slot = np.full((E, C), -1, np.int8)
    cand_f = np.zeros((E, C), np.int8)
    cand_a = np.zeros((E, C), np.int16)
    cand_b = np.zeros((E, C), np.int16)
    if E:
        ok_pos_a = np.asarray(ok_pos, np.int64)
        # an op is a candidate at completion row r iff r's event
        # position lies in (t_inv, t_done] — and rows are ordered by
        # position, so each op's candidacy is one CONTIGUOUS row range:
        # total work scales with candidate pairs (E × avg open ops),
        # not E × n_ops
        r_lo = np.searchsorted(ok_pos_a, t_inv, side="right")
        r_hi = np.searchsorted(ok_pos_a, t_done, side="right") - 1
        spans = np.maximum(r_hi - r_lo + 1, 0)
        op_idx = np.repeat(np.arange(n), spans)
        span_starts = np.concatenate(([0], np.cumsum(spans[:-1])))
        within = np.arange(int(spans.sum())) - np.repeat(span_starts, spans)
        rows = np.repeat(r_lo, spans) + within
        # lane order: ops ascending within each row (pairs arrive
        # op-major; resort row-major)
        order = np.lexsort((op_idx, rows))
        rows, op_idx = rows[order], op_idx[order]
        counts = np.bincount(rows, minlength=E)
        row_starts = np.concatenate(([0], np.cumsum(counts[:-1])))
        lanes = np.arange(len(op_idx)) - np.repeat(row_starts, counts)
        fab = np.asarray(enc_ops, np.int32).reshape(n, 3)
        cand_slot[rows, lanes] = slot[op_idx].astype(np.int8)
        cand_f[rows, lanes] = fab[op_idx, 0].astype(np.int8)
        cand_a[rows, lanes] = fab[op_idx, 1].astype(np.int16)
        cand_b[rows, lanes] = fab[op_idx, 2].astype(np.int16)
        ev_slot_arr = slot[np.asarray(ok_op_ids, np.int64)].astype(np.int32)
    else:
        ev_slot_arr = np.full((0,), -1, np.int32)

    return EncodedHistory(
        init_state=init,
        ev_slot=ev_slot_arr,
        cand_slot=cand_slot,
        cand_f=cand_f,
        cand_a=cand_a,
        cand_b=cand_b,
        n_ops=n,
        max_open=max_open,
    )


def round_up(n: int, multiple: int = 64) -> int:
    """Bucket sizes to multiples to bound recompilation."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def bucket_key(
    e: EncodedHistory, slot_cap: int, event_bucket: int = 64
) -> tuple:
    """The padded ``(E, C)`` shape bucket one encoded history stacks
    into: events round to ``event_bucket`` (bounding recompiles),
    candidate lanes to the history's own peak concurrency rounded to 4
    and capped at ``slot_cap``.  Shared by :func:`batch_encode`'s
    bucketed mode and the streaming bucketer in
    :mod:`jepsen_tpu_torch.engine.planning`, so the two can never disagree
    about which histories share a compiled shape."""
    E = round_up(e.ev_slot.shape[0], event_bucket)
    C = min(slot_cap, round_up(e.max_open, 4))
    return E, C


def global_shape(
    encoded: Sequence[EncodedHistory], slot_cap: int, event_bucket: int = 64
) -> tuple:
    """The historical single-batch padded ``(E, C)``: every history
    padded to the global max event count, candidate lanes to the
    batch's peak concurrency (rounded to 4, capped at ``slot_cap``) —
    this shrinks the frontier-expansion width and sort size, usually
    the dominant cost.  The ONE definition both ``batch_encode``'s
    unbucketed mode and the engine's ``bucketed=False`` path read, so
    "bucketed=False restores the old single-batch behavior" can never
    silently desynchronize."""
    E = round_up(max(e.ev_slot.shape[0] for e in encoded), event_bucket)
    C = min(slot_cap, round_up(max(e.max_open for e in encoded), 4))
    return E, C


def empty_batch(slot_cap: int, fallback=(), rows=()) -> EncodedBatch:
    """A zero-row EncodedBatch (the all-fallback shape)."""
    return EncodedBatch(
        init_state=np.zeros((0,), np.int32),
        ev_slot=np.zeros((0, 0), np.int32),
        cand_slot=np.zeros((0, 0, slot_cap), np.int8),
        cand_f=np.zeros((0, 0, slot_cap), np.int8),
        cand_a=np.zeros((0, 0, slot_cap), np.int16),
        cand_b=np.zeros((0, 0, slot_cap), np.int16),
        fallback=list(fallback),
        row_history=list(rows),
    )


def stack_encoded(
    encoded: Sequence[EncodedHistory],
    rows: Sequence[int],
    E: int,
    C: int,
    fallback=(),
) -> EncodedBatch:
    """Stack encoded histories into one padded ``[B, E, C]`` batch.
    Candidate lanes are trimmed to ``C`` — sound because every slot id
    used is < the history's ``max_open`` ≤ C (the caller derives C from
    the stack's peak concurrency, see :func:`bucket_key`)."""
    B = len(encoded)
    init_state = np.zeros((B,), np.int32)
    ev_slot = np.full((B, E), -1, np.int32)
    cand_slot = np.full((B, E, C), -1, np.int8)
    cand_f = np.zeros((B, E, C), np.int8)
    cand_a = np.zeros((B, E, C), np.int16)
    cand_b = np.zeros((B, E, C), np.int16)
    for bi, e in enumerate(encoded):
        n = e.ev_slot.shape[0]
        init_state[bi] = e.init_state
        ev_slot[bi, :n] = e.ev_slot
        cand_slot[bi, :n] = e.cand_slot[:, :C]
        cand_f[bi, :n] = e.cand_f[:, :C]
        cand_a[bi, :n] = e.cand_a[:, :C]
        cand_b[bi, :n] = e.cand_b[:, :C]
    return EncodedBatch(
        init_state=init_state,
        ev_slot=ev_slot,
        cand_slot=cand_slot,
        cand_f=cand_f,
        cand_a=cand_a,
        cand_b=cand_b,
        fallback=list(fallback),
        row_history=list(rows),
    )


def batch_encode(
    histories: Sequence[History],
    model: m.Model,
    slot_cap: int = DEFAULT_SLOT_CAP,
    event_bucket: int = 64,
    bucketed: bool = False,
):
    """Encode histories into padded batches; unencodable ones land in
    ``fallback`` for the CPU oracle.

    ``bucketed=False`` (the default, the historical behavior) returns
    ONE :class:`EncodedBatch` padded to the global max event count —
    every short history pays the longest history's padding.
    ``bucketed=True`` instead returns a ``List[EncodedBatch]``, one per
    padded ``(E, C)`` shape bucket (:func:`bucket_key`), sorted by
    shape, so the engine dispatches tight shapes; the global
    ``fallback`` list rides on the FIRST returned batch (an
    all-fallback input returns a single zero-row batch carrying it)."""
    spec = spec_for(model)
    encoded: List[EncodedHistory] = []
    rows: List[int] = []
    fallback: List[int] = []
    for i, h in enumerate(histories):
        e = encode_history(h, model, slot_cap, spec) if spec else None
        if e is None:
            fallback.append(i)
        else:
            encoded.append(e)
            rows.append(i)

    if not bucketed:
        if not encoded:
            return empty_batch(slot_cap, fallback, rows)
        E, C = global_shape(encoded, slot_cap, event_bucket)
        return stack_encoded(encoded, rows, E, C, fallback)

    buckets: dict = {}
    for e, i in zip(encoded, rows):
        buckets.setdefault(bucket_key(e, slot_cap, event_bucket), []).append(
            (e, i)
        )
    if not buckets:
        return [empty_batch(slot_cap, fallback, rows)]
    out: List[EncodedBatch] = []
    for key in sorted(buckets):
        E, C = key
        es = [e for e, _ in buckets[key]]
        idxs = [i for _, i in buckets[key]]
        out.append(
            stack_encoded(es, idxs, E, C, fallback if not out else ())
        )
    return out
