"""Polynomial-time direct linearizability checker for plain mutex
histories — a copy of :mod:`jepsen_tpu.checker.locks_direct` (same
verdicts, same result dicts).

General linearizability checking is NP-complete (the knossos search the
reference consumes at jepsen/src/jepsen/checker.clj:199-203 is
exponential), but a SINGLE plain lock is special: the model state is one
bit, every acquire is interchangeable with every other acquire (the
``models.Mutex`` step ignores the process), and likewise every release —
so a history is linearizable iff the completed ops admit an ALTERNATING
placement (acquire, release, acquire, …, seeded by the initial state)
with each op placed inside its invocation→completion window.  That is a
two-type interval scheduling problem, decidable greedily:

- Sweep ``linear.prepare``'s event list in order (the windows are
  defined by event positions, so the sweep IS the timeline).
- Lazy placement: an op is placed at the latest legal moment — its own
  completion event.  Placing later never hurts (windows constrain
  order, not absolute time), so any feasible schedule can be deformed
  into this one.
- When the lock state blocks the op being placed (acquire while locked
  / release while free), place ONE pending helper of the opposite kind
  first — the one with the EARLIEST deadline (completion index;
  crashed/info ops carry deadline ∞ and are thereby used only when no
  mandatory helper exists).  The standard EDF exchange argument
  applies because same-kind ops are interchangeable: if some feasible
  schedule uses a later-deadline helper here, swapping it with the
  EDF choice (placed elsewhere ≤ its earlier deadline) stays feasible.
- Info/crashed ops (knossos semantics: concurrent forever, may
  linearize once at any point after invocation, or never) sit in the
  pending pools indefinitely and are consumed only as helpers.

O(n log n) per history versus the exponential config search — this is
the engine ``wgl.check_batch`` routes single-lock batches outside the
dense envelope to, decided without any search at all.

Owner-aware locks lose that interchangeability but gain a stronger
structure instead: a client's ops are sequential in real time, so its
holds form statically-segmented spans each mandatorily occupying a
real-time core, and validity reduces to pairwise-disjoint cores plus
client-local count bounds (``_spans_check_events`` — the reentrant
argument; the non-reentrant owner-aware mutex is the same argument at
hold bound 1).  Histories whose crash structure leaves a span without
a fixed core return None and fall back to the generic search.
"""

from __future__ import annotations

import heapq
from typing import Optional

from ..history import History, INVOKE, OK
from .. import models as m
from . import linear


def _check_events(events: list, ops: list, locked0: bool) -> dict:
    """The greedy sweep over ``linear.prepare`` output.  Returns the
    analysis dict; ``{"valid?": None}`` is never produced — callers get
    a definite True/False (this checker has no budget to blow)."""
    # completion event index per op id = the op's placement deadline;
    # ops with no OK event (info/crashed) never expire
    inf = float("inf")
    deadline = [inf] * len(ops)
    for idx, (kind, op_id) in enumerate(events):
        if kind == OK:
            deadline[op_id] = idx

    pend_acq: list = []  # (deadline, op_id) heaps; lazy deletion
    pend_rel: list = []
    placed = [False] * len(ops)
    locked = locked0

    def pop_helper(heap) -> Optional[int]:
        while heap:
            _, cand = heapq.heappop(heap)
            if not placed[cand]:
                return cand
        return None

    for kind, op_id in events:
        f = ops[op_id].f
        if f == "acquire":
            is_acq = True
        elif f == "release":
            is_acq = False
        else:
            # not a plain-lock history after all — let the caller's
            # generic search handle it
            return {"valid?": None}
        if kind == INVOKE:
            heapq.heappush(
                pend_acq if is_acq else pend_rel,
                (deadline[op_id], op_id),
            )
        elif kind == OK:
            if placed[op_id]:
                continue  # consumed earlier as a helper
            if is_acq and locked:
                helper = pop_helper(pend_rel)
                if helper is None:
                    return {
                        "valid?": False,
                        "op": ops[op_id].to_dict(),
                        "error": "cannot acquire a held lock",
                        "algorithm": "direct-mutex",
                    }
                placed[helper] = True
                locked = False
            elif not is_acq and not locked:
                helper = pop_helper(pend_acq)
                if helper is None:
                    return {
                        "valid?": False,
                        "op": ops[op_id].to_dict(),
                        "error": "cannot release a free lock",
                        "algorithm": "direct-mutex",
                    }
                placed[helper] = True
                locked = True
            placed[op_id] = True
            locked = is_acq
        # INFO events carry no obligation: the op stays pending forever

    return {
        "valid?": True,
        "op-count": len(ops),
        "algorithm": "direct-mutex",
    }


def _index_and_group(events: list, ops: list):
    """Shared preamble for the owner-family and semaphore arguments:
    build completion/invocation indices, group op ids per client, and
    apply the sequentiality gate (a crashed op followed by more ops
    from the same client makes that client's structure point-flexible,
    so every fixed-core/extremal argument must hand off).  Returns
    (comp_idx, inv_idx, by_client) or None — None means 'fall back to
    the generic search'."""
    from ..models.locks import _client as _owner_client

    inf = float("inf")
    comp_idx = {}
    for idx, (kind, op_id) in enumerate(events):
        if kind == OK:
            comp_idx[op_id] = idx
    inv_idx = {}
    by_client: dict = {}
    for idx, (kind, op_id) in enumerate(events):
        if kind != INVOKE:
            continue
        inv_idx[op_id] = idx
        c = _owner_client(ops[op_id])
        if c is None:
            return None
        by_client.setdefault(c, []).append(op_id)
    for ids in by_client.values():
        for a, b in zip(ids, ids[1:]):
            if comp_idx.get(a, inf) > inv_idx[b]:
                return None
    return comp_idx, inv_idx, by_client


def _spans_check_events(
    events: list, ops: list, max_count: int, algo: str, model=None
) -> dict:
    """Direct decision for owner-aware lock histories (reentrant up to
    ``max_count`` holds; ``max_count=1`` IS the non-reentrant
    owner-aware mutex).

    Owner matching kills the plain-mutex interchangeability, but it
    buys something stronger: a client's lock ops are sequential in
    real time (one client = one logical thread), so its hold-count
    trajectory is FIXED and holds group into statically-segmented
    maximal nonzero-count SPANS — a span runs from the acquire that
    takes the count 0→1 (ok'd at event index ``ao``) to the release
    that returns it to 0 (invoked at ``ri``).  In-span validity is
    purely client-local: the count must never exceed ``max_count``,
    and a completed release at count 0 is unsatisfiable.  Across
    clients, a span mandatorily occupies the core [ao, ri] — its
    first acquire linearizes before ``ao``, its last release after
    ``ri``, and the count never reaches 0 in between — so two
    overlapping cores mean two owners at once: invalid.  Conversely,
    disjoint cores order the spans, and consecutive spans can always
    pick points (release just after its invocation, acquire just
    before its ok): VALID ⇔ pairwise-disjoint span cores.

    Crashed ops keep knossos semantics where a fixed core still
    exists: a span whose last release is info keeps its core (we may
    CHOOSE to linearize the release; with more holds outstanding the
    span stays open forever whether it peels or not, so nothing is
    ambiguous); a span never closed holds forever — core [ao, ∞); a
    trailing crashed acquire or unmatched crashed release is optional
    and never needs placing.  A crashed op followed by more ops from
    the same client makes that client's spans point-flexible (no
    fixed core), so the sequentiality gate returns
    ``{"valid?": None}`` and the caller falls back to the generic
    search: the direct path only ever decides shapes its argument
    covers."""
    inf = float("inf")
    grouped = _index_and_group(events, ops)
    if grouped is None:
        return {"valid?": None}
    comp_idx, inv_idx, by_client = grouped

    cores = []  # (start, end, witness_op_id, span_op_ids)
    for c, ids in by_client.items():
        count = 0
        span_start = None  # acquire-ok index opening the current span
        span_ops: list = []
        for op_id in ids:
            op = ops[op_id]
            done = op_id in comp_idx
            if op.f == "acquire":
                if not done:
                    # trailing crashed acquire: optional, never placed
                    # (placing an acquire only ever adds constraints)
                    continue
                count += 1
                if count > max_count:
                    return {
                        "valid?": False,
                        "op": op.to_dict(),
                        "error": (
                            f"client {c!r} acquires while already "
                            f"holding (bound {max_count})"
                        ),
                        "algorithm": algo,
                    }
                if count == 1:
                    span_start = comp_idx[op_id]
                if model is not None:  # span ops feed the replay only
                    span_ops.append(op_id)
            elif op.f == "release":
                if count == 0:
                    if done:
                        return {
                            "valid?": False,
                            "op": op.to_dict(),
                            "error": (
                                f"client {c!r} cannot release: never held"
                            ),
                            "algorithm": algo,
                        }
                    continue  # crashed unmatched release: optional
                # a crashed release here is necessarily the client's
                # LAST op (sequentiality gate); linearizing it is OUR
                # choice, so count==1 lets the span close at its
                # invocation, and with more holds outstanding the span
                # stays open forever whether it peels or not
                count -= 1
                if model is not None:
                    span_ops.append(op_id)
                if count == 0:
                    cores.append(
                        (span_start, inv_idx[op_id], op_id, span_ops)
                    )
                    span_start = None
                    span_ops = []
            else:
                return {"valid?": None}
        if span_start is not None:
            # span never closed: held forever from its first acquire
            cores.append((span_start, inf, ids[-1], span_ops))

    cores.sort(key=lambda t: (t[0], t[1]))
    for (s1, e1, w1, _o1), (s2, e2, w2, _o2) in zip(cores, cores[1:]):
        if s2 <= e1:  # cores share an instant: two owners at once
            return {
                "valid?": False,
                "op": ops[w2].to_dict(),
                "error": "two clients' hold spans overlap",
                "algorithm": algo,
            }

    if model is not None:
        # Disjoint cores FORCE the linearization order (spans by core,
        # ops client-sequential within a span), so full semantic
        # validity — including the fenced models' monotonic-token
        # rules, which depend on the global observation order — is
        # decided by replaying the model's own step function over that
        # one order.  The optional-op choices above (skip trailing
        # crashed acquires and stray releases, linearize a span-closing
        # crashed release) are each maximally permissive, so an
        # inconsistent replay means no linearization exists.
        state = model
        for _s, _e, _w, span in cores:
            for op_id in span:
                state = state.step(ops[op_id])
                if state.is_inconsistent:
                    return {
                        "valid?": False,
                        "op": ops[op_id].to_dict(),
                        "error": str(getattr(state, "msg", "inconsistent")),
                        "algorithm": algo,
                    }
    return {"valid?": True, "op-count": len(ops), "algorithm": algo}


def _owner_check_events(events: list, ops: list) -> dict:
    """Non-reentrant owner-aware mutex = the spans argument at hold
    bound 1.  No replay: the count walk already decides these models
    exactly (differentially validated), so the fast path stays fast."""
    return _spans_check_events(events, ops, 1, "direct-owner-mutex")


def _reentrant_check_events(events: list, ops: list, max_count: int) -> dict:
    return _spans_check_events(
        events, ops, max_count, "direct-reentrant-mutex"
    )


def _fenced_check_events(events: list, ops: list, model) -> dict:
    """Fenced flavors: segmentation + disjoint cores as above, then the
    forced-order replay carries the monotonic-fence rules via the
    model's own step function."""
    return _spans_check_events(
        events, ops, 1, "direct-fenced-mutex", model
    )


def _reentrant_fenced_check_events(events: list, ops: list, model) -> dict:
    return _spans_check_events(
        events, ops, model.max_count, "direct-reentrant-fenced-mutex",
        model,
    )


def _permits_check_events(events: list, ops: list, n_permits: int) -> dict:
    """Direct decision for SEMAPHORE (acquired-permits) histories.

    No cores needed here — the exact condition falls out of an
    extremal placement.  Every completed acquire must linearize by its
    ok (index ``ao``) and every release may linearize as early as just
    after its invocation (``ri``), so

        H(t) = #{acquires: ao ≤ t} − #{releases placed: ri ≤ t}

    is a LOWER bound on permits outstanding at time t under ANY
    placement: H(t) > n_permits anywhere means no linearization
    exists.  Conversely, placing each acquire just before its ok and
    each release just after its invocation — in anchor order, which
    respects every client's sequential op order — realizes exactly H,
    so H ≤ n_permits everywhere (plus per-client release sanity, which
    is deterministic because a client's op order is fixed) IS
    linearizability.  Optional crashed ops resolve maximally
    permissively: trailing crashed acquires are never placed (placing
    only raises H), trailing crashed releases are placed whenever the
    client holds a permit (placing only lowers H and nothing of that
    client follows).  Crashed ops with successors fall back to the
    generic search, as in the lock checkers."""
    algo = "direct-acquired-permits"
    grouped = _index_and_group(events, ops)
    if grouped is None:
        return {"valid?": None}
    comp_idx, inv_idx, by_client = grouped

    deltas = []  # (anchor_index, +1/-1, op_id)
    for c, ids in by_client.items():
        held = 0
        for op_id in ids:
            op = ops[op_id]
            done = op_id in comp_idx
            if op.f == "acquire":
                if not done:
                    continue  # trailing crashed acquire: never placed
                held += 1
                deltas.append((comp_idx[op_id], 1, op_id))
            elif op.f == "release":
                if held == 0:
                    if done:
                        return {
                            "valid?": False,
                            "op": op.to_dict(),
                            "error": (
                                f"client {c!r} releases a permit it "
                                "does not hold"
                            ),
                            "algorithm": algo,
                        }
                    continue  # trailing crashed release, nothing held
                held -= 1
                deltas.append((inv_idx[op_id], -1, op_id))
            else:
                return {"valid?": None}

    deltas.sort()
    outstanding = 0
    for _idx, d, op_id in deltas:
        outstanding += d
        if outstanding > n_permits:
            return {
                "valid?": False,
                "op": ops[op_id].to_dict(),
                "error": (
                    f"more than {n_permits} permits necessarily "
                    "outstanding"
                ),
                "algorithm": algo,
            }
    return {"valid?": True, "op-count": len(ops), "algorithm": algo}


def _queue_check_events(events: list, ops: list, init_counts) -> dict:
    """Direct decision for UNORDERED-QUEUE histories.

    The model factors per value: enqueues never block and dequeue(v)
    only touches v's count, so constraints exist only WITHIN a value —
    each completed dequeue of v needs its own enqueue of v linearized
    before it (or an initial copy of v).  For a dequeue with deadline
    ``do`` (its ok index) and an enqueue invoked at ``ei``, points
    satisfying enq < deq exist iff ``ei < do``; distinct pairs share
    no resource beyond the one-enqueue-per-dequeue injection, so
    per-value validity is a bipartite matching under that threshold
    condition — and because later dequeues have later deadlines,
    greedy assignment in deadline order (consume ANY available
    enqueue) is exact.  Crashed enqueues are placeable helpers
    (window (ei, ∞)); crashed dequeues are optional and never consumed
    (placing one only spends an enqueue).  Unlike the lock checkers
    this needs no client-sequentiality gate: values, not clients, are
    the unit of interaction, so every history shape is decidable."""
    algo = "direct-unordered-queue"
    comp_idx = {}
    for idx, (kind, op_id) in enumerate(events):
        if kind == OK:
            comp_idx[op_id] = idx
    enq_by_value: dict = {}
    deqs = []  # (deadline, value, op_id) — completed dequeues only
    for idx, (kind, op_id) in enumerate(events):
        if kind != INVOKE:
            continue
        op = ops[op_id]
        if op.f == "enqueue":
            # completed or crashed: both may linearize (crashed ones at
            # any point after invocation — knossos semantics)
            enq_by_value.setdefault(op.value, []).append(idx)
        elif op.f == "dequeue":
            if op_id in comp_idx:
                deqs.append((comp_idx[op_id], op.value, op_id))
        else:
            return {"valid?": None}

    counts = dict(init_counts or {})
    deqs.sort()
    cursor: dict = {}  # per-value index of the next unconsumed enqueue
    for deadline, v, op_id in deqs:
        if v is None:
            return {
                "valid?": False,
                "op": ops[op_id].to_dict(),
                "error": "dequeue with unknown value",
                "algorithm": algo,
            }
        if counts.get(v, 0) > 0:
            counts[v] -= 1  # initial copies serve any dequeue
            continue
        pool = enq_by_value.get(v)
        # any enqueue invoked before this dequeue's deadline works,
        # and staying available for later (later-deadline) dequeues is
        # automatic — consume the earliest-invoked, via a cursor so
        # the matching stays O(n)
        i = cursor.get(v, 0)
        if pool and i < len(pool) and pool[i] < deadline:
            cursor[v] = i + 1
            continue
        return {
            "valid?": False,
            "op": ops[op_id].to_dict(),
            "error": f"dequeued {v!r} without a matching enqueue",
            "algorithm": algo,
        }
    return {"valid?": True, "op-count": len(ops), "algorithm": algo}


def dispatch_events(model, events: list, ops: list) -> Optional[dict]:
    """Events-level entry point — the ONE place that owns which models
    the direct arguments cover: plain ``models.Mutex`` via greedy
    alternation scheduling; the initially-free owner-aware family
    (``OwnerMutex``, ``ReentrantMutex``, ``FencedMutex``,
    ``ReentrantFencedMutex``) via disjoint span cores — with a
    forced-order model replay carrying the fenced flavors' token
    rules; initially-empty ``AcquiredPermits`` via the extremal
    mandatory-count argument.  Shared by :func:`analysis` and
    ``linear.analysis``'s hook so the two entries cannot diverge.
    Returns None for uncovered models or histories outside the
    structure a direct argument covers — callers then use the generic
    search."""
    from ..models.locks import FencedMutex, ReentrantFencedMutex

    if type(model) is m.Mutex:
        out = _check_events(events, ops, bool(model.locked))
    elif type(model) is m.OwnerMutex and model.owner is None:
        out = _owner_check_events(events, ops)
    elif (
        type(model) is m.ReentrantMutex
        and model.owner is None
        and model.count == 0
    ):
        out = _reentrant_check_events(events, ops, model.max_count)
    elif type(model) is FencedMutex and model.owner is None:
        out = _fenced_check_events(events, ops, model)
    elif (
        type(model) is ReentrantFencedMutex
        and model.owner is None
        and model.count == 0
    ):
        out = _reentrant_fenced_check_events(events, ops, model)
    elif type(model) is m.AcquiredPermits and not model.acquired:
        out = _permits_check_events(events, ops, model.n_permits)
    elif type(model) is m.UnorderedQueue:
        out = _queue_check_events(events, ops, dict(model.items))
    else:
        return None
    return None if out["valid?"] is None else out


def analysis(model, history: History) -> Optional[dict]:
    """History-level wrapper over :func:`dispatch_events`, result-dict
    compatible with ``linear.analysis``."""
    from ..models.locks import FencedMutex, ReentrantFencedMutex

    if type(model) not in (
        m.Mutex,
        m.OwnerMutex,
        m.ReentrantMutex,
        FencedMutex,
        ReentrantFencedMutex,
        m.AcquiredPermits,
        m.UnorderedQueue,
    ):
        return None  # skip prepare() for models no argument covers
    events, ops = linear.prepare(history)
    return dispatch_events(model, events, ops)
