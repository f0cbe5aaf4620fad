"""Linearizability checking — CPU oracle.

A copy of :mod:`jepsen_tpu.checker.linear` (same verdicts and result
dicts): the search, the search-free direct checkers for the lock family,
the permit semaphore and the unordered queue
(:mod:`.locks_direct`), and the per-key decomposition of models that
declare a partition.  Only the reference's telemetry span stays out.

Event-driven just-in-time linearization (the knossos.linear / knossos.wgl
algorithm family the reference consumes at checker.clj:199-203):

A *configuration* is ``(model-state, linearized-set)`` where the
linearized-set holds ops that have been linearized but whose completion
event hasn't been reached yet.  Walking the history event by event:

- ``invoke i``: op i becomes *open* (callable).  No expansion yet —
  closure is deferred to the next filtering event, which is sound because
  closure only ever grows the config set.
- ``ok i``: first expand the closure — repeatedly linearize any open,
  not-yet-linearized op against every config (dropping inconsistent
  steps) until fixpoint — then keep only configs that linearized i, and
  remove i from their linearized-sets (it is now part of the common
  prefix).  An empty config set here means the history is not
  linearizable, and op i is the witness.
- ``info i``: op i stays open forever — it may linearize at any later
  point, or never.
- ``fail i``: op i never happened; it and its invocation are removed in
  preprocessing.

The device path in :mod:`jepsen_tpu_torch.ops.dense` runs the same search
as a dense subset automaton; this module is its differential-test oracle
and the engine's fallback for histories the device cannot take.
"""

from __future__ import annotations

import concurrent.futures
import threading as _threading
import time as _time
from typing import Any, Dict, FrozenSet, Iterable, Optional, Set, Tuple

from ..history import History, INVOKE, OK, FAIL, INFO, Op
from ..models import Model

#: Bound on the config-set size before we give up with :unknown.  Mirrors
#: the reference's practice of truncating/giving-up on pathological
#: searches (checker.clj:213-216).
DEFAULT_MAX_CONFIGS = 100_000


def prepare(history: History, pure_fs: Iterable[Any] = ()) -> Tuple[list, list]:
    """Preprocess a raw history into (events, ops):

    events: [(kind, op_id)] with kind ∈ {invoke, ok, info};
    ops:    [Op] per op id, with completion values propagated onto the
            invocation (so a read's observed value is available when the
            op linearizes).

    Failed ops are dropped entirely; indeterminate ops whose :f is in
    pure_fs (state-preserving reads) are dropped too.

    One fused pass: pairing, failure/pure-read dropping, and value
    propagation together.  The returned ops ALIAS the caller's Op
    objects except where a completion changed the value (those are
    copied before mutation) — callers must treat them as read-only;
    anything needing to mutate must copy first.  The former
    copy-every-invocation pipeline dominated host encoding cost
    (SURVEY.md §7, host↔device feed rate).
    """
    pure = set(pure_fs)
    events: list = []
    ops: list = []
    open_by_process: Dict[Any, int] = {}
    dropped: set = set()
    def propagate(op_id, value):
        """Copy-on-write value propagation: the ops list holds the
        caller's Op objects until a completion actually changes one —
        unconditional copies dominated the host encode path (~30% of
        batch_encode, SURVEY §7 host↔device feed rate)."""
        if value is not None and ops[op_id].value != value:
            ops[op_id] = ops[op_id].copy()
            ops[op_id].value = value

    for op in history:
        p = op.process
        if not isinstance(p, int):
            continue
        t = op.type
        if t == INVOKE:
            op_id = len(ops)
            ops.append(op)
            open_by_process[p] = op_id
            events.append((INVOKE, op_id))
        elif t == OK:
            op_id = open_by_process.pop(p, None)
            if op_id is not None:
                propagate(op_id, op.value)
                events.append((OK, op_id))
        elif t == FAIL:
            op_id = open_by_process.pop(p, None)
            if op_id is not None:
                dropped.add(op_id)  # a failed op never took effect
        elif t == INFO:
            op_id = open_by_process.pop(p, None)
            if op_id is not None:
                if op.f in pure:
                    # a crashed pure read always linearizes and never
                    # changes state: drop it to shrink the search
                    dropped.add(op_id)
                else:
                    # an info completion may still carry payload the
                    # invocation lacked (e.g. lock clients stamp WHO
                    # acted on the way out); without it an owner-aware
                    # model could never linearize the op and would
                    # wrongly poison every later legitimate step
                    propagate(op_id, op.value)
                    events.append((INFO, op_id))
    # processes whose invoke never completed at all: same as info (open
    # forever)
    for op_id in open_by_process.values():
        events.append((INFO, op_id))
    if dropped:
        # compact ids so dropped ops vanish entirely (their values must
        # not leak into encoders' value maps or domain probes)
        remap: Dict[int, int] = {}
        kept: list = []
        for op_id, op in enumerate(ops):
            if op_id not in dropped:
                remap[op_id] = len(kept)
                kept.append(op)
        ops = kept
        events = [
            (k, remap[op_id]) for k, op_id in events if op_id not in dropped
        ]
    return events, ops


def _closure(
    configs: Set[Tuple[Model, FrozenSet[int]]],
    open_ops: Set[int],
    ops: list,
    max_configs: int,
    parents: Optional[Dict] = None,
    deadline: Optional[float] = None,
) -> Tuple[Set[Tuple[Model, FrozenSet[int]]], bool]:
    """Expand configs by linearizing open ops until fixpoint.
    Returns (configs, reason) with reason None (fixpoint reached),
    "configs" (max_configs blown), or "deadline" (budget blown).  When
    ``parents`` is given, each
    newly reached config records (parent-config, op-id) so a witness
    path can be reconstructed for failure reports.  A ``deadline``
    (time.monotonic timestamp) bounds WALL TIME the way max_configs
    bounds memory: blown budgets report overflowed, which the caller
    turns into an honest "unknown"."""
    frontier = configs
    seen = set(configs)
    while frontier:
        if deadline is not None and _time.monotonic() > deadline:
            return seen, "deadline"
        new: Set[Tuple[Model, FrozenSet[int]]] = set()
        for model, linset in frontier:
            for op_id in open_ops:
                if op_id in linset:
                    continue
                op = ops[op_id]
                model2 = model.step(op)
                if model2.is_inconsistent:
                    continue
                cfg = (model2, linset | {op_id})
                if cfg not in seen:
                    seen.add(cfg)
                    new.add(cfg)
                    if parents is not None:
                        parents[cfg] = ((model, linset), op_id)
                    if len(seen) > max_configs:
                        return seen, "configs"
        frontier = new
    return seen, None


def _final_paths(
    configs: Set[Tuple[Model, FrozenSet[int]]],
    parents: Dict,
    ops: list,
    failing_op: Op,
    limit: int = 10,
) -> list:
    """Representative linearization paths (since the previous completed
    op) leading to each final config — the knossos-report
    ``:final-paths`` equivalent.  ``why`` records the model's exact
    complaint when the failing op steps from that config's state."""
    paths = []
    for cfg in sorted(configs, key=lambda c: repr(c))[:limit]:
        stepped = cfg[0].step(failing_op)
        why = (
            str(getattr(stepped, "msg", "inconsistent"))
            if stepped.is_inconsistent
            else "op not linearizable here"
        )
        steps = []
        cur = cfg
        while cur in parents:
            (pcfg, op_id) = parents[cur]
            steps.append(
                {
                    "op": ops[op_id].to_dict(),
                    "op-id": op_id,
                    "model": repr(cur[0]),
                }
            )
            cur = pcfg
        steps.reverse()
        paths.append(
            {
                "init": repr(cur[0]),
                "steps": steps,
                "pending": sorted(cfg[1]),
                "why": why,
            }
        )
    return paths


def _partition_by_key(model: Model, events: list, ops: list):
    """P-compositionality (knossos-style, arXiv:1504.00204), driven by
    the models' partition protocol (``partition_key`` /
    ``subhistory_model`` / ``partition_op`` — the same protocol the
    engine-side pass :mod:`jepsen_tpu.engine.decompose` consumes):
    a history whose every op touches exactly one partition is
    linearizable iff each partition's subhistory is linearizable
    against that partition's sub-model.  Returns
    [(submodel, events, ops)] per partition in first-seen order, or
    None when the model declares no partition or any op's partition is
    undeterminable.  The per-partition searches are exponentially
    smaller than the product search (the config set factors across
    partitions).  Ops here are post-``prepare`` (completion values
    propagated onto invocations), so a dequeue's value is resolved."""
    key_fn = getattr(model, "partition_key", None)
    if not callable(key_fn):
        return None
    op_key: list = []
    for op in ops:
        k = key_fn(op)
        if k is None:
            return None
        op_key.append(k)
    parts: Dict[Any, Tuple[list, list, Dict[int, int]]] = {}
    order: list = []
    for kind, op_id in events:
        k = op_key[op_id]
        if k not in parts:
            parts[k] = ([], [], {})
            order.append(k)
        ev_k, ops_k, remap = parts[k]
        if op_id not in remap:
            remap[op_id] = len(ops_k)
            ops_k.append(model.partition_op(ops[op_id], k))
        ev_k.append((kind, remap[op_id]))
    return [
        (model.subhistory_model(k), parts[k][0], parts[k][1]) for k in order
    ]


def _search_fast(
    model: Model,
    events: list,
    ops: list,
    max_configs: int,
    deadline: Optional[float],
    budget_s: Optional[float],
) -> dict:
    """The hot search core: states interned to ints, (state, op) steps
    memoized, linearized-sets as int bitmasks — configs are (int, int)
    tuples, so hashing and set algebra cost a fraction of the
    object-based path.  Mask bits are compact SLOTS recycled as ops
    complete (bounded by peak concurrency plus never-returning info
    ops), not global op ids — masks stay machine-word sized on long
    histories.  Same algorithm and verdicts as the witness path; the
    step memo is sound because Model.step is a pure function of
    (state value, op value)."""
    states: list = [model]
    sids: Dict[Model, int] = {model: 0}
    step_memo: Dict[Tuple[int, int], int] = {}
    configs: Set[Tuple[int, int]] = {(0, 0)}
    open_ops: list = []
    slot_of: Dict[int, int] = {}
    slot_owner: Dict[int, int] = {}
    free_slots: list = []
    next_slot = 0

    def overflow_out(reason: str, op_id: int) -> dict:
        return {
            "valid?": "unknown",
            "error": (
                f"oracle time budget ({budget_s}s) exceeded; "
                "aborting search"
                if reason == "deadline"
                else f"config set exceeded {max_configs}; aborting search"
            ),
            "op": ops[op_id].to_dict(),
        }

    def sample_configs(cfgs) -> list:
        out = []
        for sid, mask in list(cfgs)[:10]:
            pending = []
            m = mask
            while m:
                low = m & -m
                pending.append(slot_owner.get(low.bit_length() - 1))
                m ^= low
            out.append(
                {"model": repr(states[sid]), "pending": sorted(pending)}
            )
        return out

    for kind, op_id in events:
        if kind == INVOKE:
            open_ops.append(op_id)
            if free_slots:
                slot = free_slots.pop()
            else:
                slot = next_slot
                next_slot += 1
            slot_of[op_id] = slot
            slot_owner[slot] = op_id
        elif kind == OK:
            # closure to fixpoint, then filter on op_id's bit
            frontier = configs
            seen = set(configs)
            reason = None
            while frontier:
                if deadline is not None and _time.monotonic() > deadline:
                    reason = "deadline"
                    break
                new: Set[Tuple[int, int]] = set()
                for sid, mask in frontier:
                    for oid in open_ops:
                        bit = 1 << slot_of[oid]
                        if mask & bit:
                            continue
                        key = (sid, oid)
                        nsid = step_memo.get(key)
                        if nsid is None:
                            m2 = states[sid].step(ops[oid])
                            if m2.is_inconsistent:
                                nsid = -1
                            else:
                                nsid = sids.get(m2)
                                if nsid is None:
                                    nsid = len(states)
                                    sids[m2] = nsid
                                    states.append(m2)
                            step_memo[key] = nsid
                        if nsid < 0:
                            continue
                        cfg = (nsid, mask | bit)
                        if cfg not in seen:
                            seen.add(cfg)
                            new.add(cfg)
                            if len(seen) > max_configs:
                                reason = "configs"
                                break
                    if reason:
                        break
                if reason:
                    break
                frontier = new
            if reason:
                return overflow_out(reason, op_id)
            slot = slot_of[op_id]
            bit = 1 << slot
            survivors = {
                (sid, mask & ~bit) for sid, mask in seen if mask & bit
            }
            if not survivors:
                return {
                    "valid?": False,
                    "op": ops[op_id].to_dict(),
                    "configs": sample_configs(seen),
                }
            configs = survivors
            open_ops.remove(op_id)
            # no surviving mask holds the bit anymore: recycle the slot
            del slot_of[op_id]
            del slot_owner[slot]
            free_slots.append(slot)
        elif kind == INFO:
            pass

    return {
        "valid?": True,
        "configs": sample_configs(configs),
        "op-count": len(ops),
    }


#: worker-pool width for concurrent oracle searches.  The searches are
#: pure Python, so threads trade GIL slices among themselves — the win
#: the pipelined engine buys is overlap with DEVICE wall time (the kernel
#: computes while the interpreter grinds the fallback searches).
DEFAULT_ORACLE_WORKERS = 4

# the guard must pre-exist the first caller: creating it lazily would
# itself race (two first callers, two locks, two leaked executors)
_pool_lock = _threading.Lock()
_pool = None


def oracle_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The shared bounded worker pool for oracle fallback searches — one
    per process, :data:`DEFAULT_ORACLE_WORKERS` wide.  The engine
    (:mod:`jepsen_tpu_torch.engine`) submits fallback analyses here so
    the search runs concurrently with in-flight device dispatches."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=DEFAULT_ORACLE_WORKERS,
                thread_name_prefix="jepsen-oracle",
            )
        return _pool


def analysis_async(
    model: Model,
    history: History,
    pure_fs: Iterable[Any] = (),
    max_configs: int = DEFAULT_MAX_CONFIGS,
    witness: bool = False,
    budget_s: Optional[float] = None,
) -> concurrent.futures.Future:
    """:func:`analysis` submitted to the shared oracle worker pool;
    returns a ``concurrent.futures.Future``.  Safe because the search is
    a pure function of its arguments (interned states and memos are all
    call-local)."""
    return oracle_pool().submit(
        analysis, model, history, pure_fs, max_configs, witness, budget_s
    )


def analysis(
    model: Model,
    history: History,
    pure_fs: Iterable[Any] = (),
    max_configs: int = DEFAULT_MAX_CONFIGS,
    witness: bool = False,
    budget_s: Optional[float] = None,
) -> dict:
    """Check history against model. Returns
    {"valid?": True|False|"unknown", ...} with a witness :op on failure
    and sample :configs (truncated to 10, as the reference does at
    checker.clj:213-216).  ``witness=True`` additionally reconstructs
    ``final-paths`` (one linearization path per surviving config since
    the last completed op) and ``op-ids``/``ops`` context for the
    failure-witness renderer.

    Exception to the shape: the lock family, the permit semaphore and
    the unordered queue decide via the search-free direct checker
    (:mod:`.locks_direct`), whose results carry an ``algorithm`` and NO
    ``configs`` key (there is no config set to sample) —
    ``witness=True`` failures still re-search for the full report.
    Treat ``configs`` as optional.

    ``budget_s`` bounds wall time: the exponential search reports an
    honest "unknown" past the budget instead of hanging a whole analysis
    on one poisoned history.  None (the default) keeps the search
    unbounded."""
    deadline = (
        _time.monotonic() + budget_s if budget_s is not None else None
    )
    events, ops = prepare(history, pure_fs)

    # Per-key decomposition first when the model factors (knossos-style
    # P-compositionality) — for BOTH paths: the fast search checks each
    # key, and a witness run then searches ONLY the failing key's
    # subhistory, so the witness report stays focused and the
    # object-based search never pays the whole-history state space.
    def witness_confirm(r, m, ev, op_l):
        """A fast-search failure re-searched with parent pointers so the
        report carries final-paths; the definite False is KEPT if the
        witness search cannot confirm within the remaining budget."""
        w = _search_witness(m, ev, op_l, max_configs, deadline, budget_s)
        return w if w.get("valid?") is False else r

    # Single-lock histories decide in O(n log n) with no search at all
    # (checker/locks_direct.py: plain mutex via greedy alternation
    # scheduling, owner-aware mutex via disjoint hold cores) — no
    # config space, no budget, no "unknown".  Witness requests still
    # re-search a failure so the final-paths report exists; the direct
    # verdict stands if the witness search blows its budget.  A None
    # return (uncovered model or structure) falls through to the
    # generic search.
    from . import locks_direct

    d = locks_direct.dispatch_events(model, events, ops)
    if d is not None:
        if d["valid?"] is False and witness:
            return witness_confirm(d, model, events, ops)
        return d

    parts = _partition_by_key(model, events, ops)
    if parts is not None and len(parts) > 1:
        worst = None
        for m_k, ev_k, ops_k in parts:
            # a partition's sub-model may itself have a direct checker
            # (multi-mutex → per-lock Mutex decides in O(n log n));
            # fall through to the fast search otherwise
            d_k = locks_direct.dispatch_events(m_k, ev_k, ops_k)
            r = d_k if d_k is not None else _search_fast(
                m_k, ev_k, ops_k, max_configs, deadline, budget_s
            )
            if r["valid?"] is False:
                if witness:
                    return witness_confirm(r, m_k, ev_k, ops_k)
                return r
            if r["valid?"] == "unknown":
                worst = r
        if worst is not None:
            return worst
        return {"valid?": True, "op-count": len(ops)}
    r = _search_fast(model, events, ops, max_configs, deadline, budget_s)
    if witness and r["valid?"] is False:
        return witness_confirm(r, model, events, ops)
    return r


def _search_witness(
    model: Model,
    events: list,
    ops: list,
    max_configs: int,
    deadline: Optional[float],
    budget_s: Optional[float],
) -> dict:
    """The object-based search with parent pointers: slower than
    :func:`_search_fast`, but a failure carries ``final-paths`` (one
    linearization path per surviving config since the last completed
    op) for the witness renderer."""
    configs: Set[Tuple[Model, FrozenSet[int]]] = {(model, frozenset())}
    open_ops: Set[int] = set()
    parents: Dict = {}

    for kind, op_id in events:
        if kind == INVOKE:
            open_ops.add(op_id)
        elif kind == OK:
            configs, overflow = _closure(
                configs, open_ops, ops, max_configs, parents, deadline
            )
            if overflow:
                return {
                    "valid?": "unknown",
                    "error": (
                        f"oracle time budget ({budget_s}s) exceeded; "
                        "aborting search"
                        if overflow == "deadline"
                        else f"config set exceeded {max_configs}; "
                        "aborting search"
                    ),
                    "op": ops[op_id].to_dict(),
                }
            # keep configs that linearized op_id; promote it into the prefix
            survivors = {
                (m, linset - {op_id}) for (m, linset) in configs if op_id in linset
            }
            if not survivors:
                out = {
                    "valid?": False,
                    "op": ops[op_id].to_dict(),
                    "configs": [
                        {"model": repr(m), "pending": sorted(linset)}
                        for m, linset in list(configs)[:10]
                    ],
                }
                out["final-paths"] = _final_paths(
                    configs, parents, ops, ops[op_id]
                )
                out["failed-op-id"] = op_id
                out["ops"] = [o.to_dict() for o in ops]
                out["open-ops"] = sorted(open_ops)
                return out
            configs = survivors
            parents = {}  # re-root paths at the new common prefix
            open_ops.discard(op_id)
        elif kind == INFO:
            # stays open forever; nothing to do
            pass

    return {
        "valid?": True,
        "configs": [
            {"model": repr(m), "pending": sorted(linset)}
            for m, linset in list(configs)[:10]
        ],
        "op-count": len(ops),
    }
