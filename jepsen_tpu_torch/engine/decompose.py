"""P-compositionality front-end: decompose histories before dispatch — the
port of :mod:`jepsen_tpu.engine.decompose`.

"Faster linearizability checking via P-compositionality"
(arXiv:1504.00204): when a model is a product of independent
per-partition sub-models — registers per key, locks per name — a history
is linearizable iff every per-partition sub-history is, and the product
of small searches is exponentially cheaper than one big one.  This pass
runs ahead of ``wgl.plan_bucket``:

- Models declare the factoring through the partition protocol on
  :class:`jepsen_tpu_torch.models.Model` (``partition_key(op)`` /
  ``subhistory_model(key)`` / ``partition_op(op, key)``); models without
  a declared partition pass through unchanged.
- :func:`split_history` splits one history into per-partition
  sub-histories, pairing invocations with completions and keeping
  real-time order inside each partition.  Any op whose partition cannot
  be determined keeps the WHOLE history undecomposed — pass-through is
  always sound, so the pass never guesses.
- :class:`DecomposedRun` owns a batch's result slots and feeds up to two
  :class:`~jepsen_tpu_torch.engine.planning.RunContext` streams — the
  pass-through histories under the parent model, and the flattened
  sub-histories under the sub-model family, one seeded sub-model per
  row — through the unchanged planning and execution layers.
- Verdicts AND at settle (:func:`merge_partition_results`): the first
  ``valid? = false`` sub-verdict in partition order wins, so results do
  not depend on window size, bucketing or interleaving, and the failing
  partition is named as ``failed-partition``.

The pass is on by default (``check_batch(..., decomposed=False)`` turns
it off per call).  It counts what it did in :mod:`..obs` under the
reference's names (``jepsen_engine_decomposed_total`` by route,
``jepsen_engine_partitions_total``, the
``jepsen_engine_partition_fanout`` histogram).  The reference's verdict
WAL and streaming-ingest seams serve its checker daemon and are not
ported, nor is its per-run interning of sub-models (so it has no
``jepsen_engine_decompose_cache_evictions_total``): each sub-history
builds its own.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import obs
from ..history import FAIL, INVOKE, History
from .planning import RunContext

#: bucket bounds of the partitions-per-history histogram
FANOUT_BUCKETS = (2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 1024.0)

#: sentinel key for failed op pairs: dropped from every partition, the
#: same treatment ``linear.prepare`` gives them undecomposed
_DROPPED = object()


def partitioner(model):
    """The model's ``partition_key`` method, or None when the model
    declares no partition protocol (the base class pins the attribute
    to None)."""
    fn = getattr(model, "partition_key", None)
    return fn if callable(fn) else None


def routing_gain_possible(model) -> bool:
    """Whether splitting ``model``'s histories ahead of dispatch can change
    their routing for the better.  Specs the routing already hands to a
    CPU direct algorithm outright (``wgl.DIRECT_FIRST_SPECS``: the
    unordered queue, whose direct checker factors per value itself) gain
    nothing, so the pass treats them as pass-through."""
    from ..ops import step_kernels, wgl

    spec = step_kernels.spec_for(model)
    return spec is None or spec.name not in wgl.DIRECT_FIRST_SPECS


def split_history(model, history):
    """Split one history into per-partition sub-histories, or return None
    when it must pass through undecomposed (the model declares no
    partition, or some op's partition is undeterminable).

    Returns ``[(key, submodel, subhistory), ...]`` in first-seen key
    order.  Invocations pair with their completions by process; the
    pair's key resolves from the completion first (a read's observation
    lives there), then the invocation.  Failed pairs drop (they never
    took effect), orphan completions and non-client (non-int process)
    events are skipped exactly as ``linear.prepare`` skips them, and each
    partition keeps its events in real-time order.  Ops enter
    sub-histories through ``model.partition_op``; originals are never
    mutated."""
    key_fn = partitioner(model)
    if key_fn is None:
        return None
    records: List[list] = []  # [invoke_op, completion_op | None]
    rec_of_event: List[int] = []  # per history position, -1 = skipped
    open_of: Dict[int, int] = {}
    for op in history:
        p = op.process
        if not isinstance(p, int):
            rec_of_event.append(-1)
            continue
        if op.type == INVOKE:
            open_of[p] = len(records)
            rec_of_event.append(len(records))
            records.append([op, None])
        else:
            ri = open_of.pop(p, None)
            if ri is None:
                rec_of_event.append(-1)  # orphan completion
                continue
            records[ri][1] = op
            rec_of_event.append(ri)

    keys: List[Any] = []
    for inv, comp in records:
        if comp is not None and comp.type == FAIL:
            keys.append(_DROPPED)  # never took effect; no key needed
            continue
        k = key_fn(comp) if comp is not None else None
        if k is None:
            k = key_fn(inv)
        if k is None:
            return None  # undeterminable partition: pass through whole
        keys.append(k)

    parts: Dict[Any, History] = {}
    order: List[Any] = []
    for pos, op in enumerate(history):
        ri = rec_of_event[pos]
        if ri < 0:
            continue
        k = keys[ri]
        if k is _DROPPED:
            continue
        sub = parts.get(k)
        if sub is None:
            sub = parts[k] = History()
            order.append(k)
        sub.append(model.partition_op(op, k))
    return [(k, model.subhistory_model(k), parts[k]) for k in order]


def merge_partition_results(parts: Sequence[Tuple[Any, dict]]) -> dict:
    """AND a decomposed history's sub-verdicts into one result dict.

    The first ``valid? = false`` sub-verdict wins (then the first
    non-True, i.e. "unknown"), first in partition order.  The winning
    sub-result's fields (engine, kernel, failed-event — in sub-history
    event coordinates) carry through, plus ``failed-partition`` and
    ``partitions``.  An all-True history reports the uniform sub-engine
    (or ``"mixed"``), the uniform kernel of device rows (``"gpu"``) and
    the uniform direct-checker ``algorithm``; whenever any sub-history
    went to the oracle its count rides along as ``oracle-partitions``."""
    n = len(parts)
    n_oracle = sum(
        1 for _k, r in parts
        if str(r.get("engine", "")).startswith("oracle")
    )
    winner = next(
        ((k, r) for k, r in parts if r.get("valid?") is False), None
    )
    if winner is None:
        winner = next(
            ((k, r) for k, r in parts if r.get("valid?") is not True), None
        )
    if winner is not None:
        key, r = winner
        out = dict(r)
        out["failed-partition"] = key
        out["partitions"] = n
        if n_oracle:
            out["oracle-partitions"] = n_oracle
        return out
    engines = {r.get("engine") for _k, r in parts}
    out = {
        "valid?": True,
        "engine": engines.pop() if len(engines) == 1 else "mixed",
        "partitions": n,
    }
    if out["engine"] == "gpu":
        kernels = {r.get("kernel") for _k, r in parts}
        if len(kernels) == 1:
            out["kernel"] = kernels.pop()
    algorithms = {r.get("algorithm") for _k, r in parts}
    if len(algorithms) == 1 and None not in algorithms:
        out["algorithm"] = algorithms.pop()
    if n_oracle:
        out["oracle-partitions"] = n_oracle
    return out


class DecomposedRun:
    """One batch's decomposition bookkeeping: the parent result slots plus
    up to two planning streams, :attr:`main_ctx` (pass-through histories
    under the parent model: every history when the model declares no
    partition or ``enabled`` is False) and :attr:`sub_ctx` (the flattened
    per-partition sub-histories, one seeded sub-model per row).
    :meth:`feed` yields each planner row as the split makes it;
    :meth:`results` assigns pass-through results home and ANDs the
    sub-verdicts of each decomposed history."""

    def __init__(self, model, histories: Sequence, *,
                 oracle_fallback: bool = True,
                 oracle_budget_s: Optional[float] = None,
                 enabled: bool = True):
        self.model = model
        self._histories = histories
        self.n = len(histories)
        self._pass_idx: List[int] = []
        self._parts_of: Dict[int, List[Tuple[Any, int]]] = {}
        self._active = bool(enabled and partitioner(model) is not None
                            and routing_gain_possible(model))
        self._kw = {"oracle_fallback": oracle_fallback,
                    "oracle_budget_s": oracle_budget_s}
        self.main_ctx: Optional[RunContext] = None
        self.sub_ctx: Optional[RunContext] = None
        #: histories split, and the sub-histories they split into
        self.n_decomposed = 0
        self.n_partitions = 0

    def feed(self):
        """Generator: classify and split the histories one at a time,
        yielding ``(ctx, idx)`` for each planner row the moment it
        exists, so the split interleaves with encode and dispatch."""
        rec = obs.enabled()
        for i, h in enumerate(self._histories):
            parts = split_history(self.model, h) if self._active else None
            if parts is None or len(parts) <= 1:
                # ≤ 1 partition gains nothing and would only re-tag the
                # result dict: the history passes through whole
                self._pass_idx.append(i)
                if self.main_ctx is None:
                    self.main_ctx = RunContext(self.model, [], **self._kw)
                if rec and self._active:
                    obs.count("jepsen_engine_decomposed_total",
                              route="passthrough")
                yield self.main_ctx, self.main_ctx.append(h)
                continue
            slots = []
            for key, submodel, subh in parts:
                if self.sub_ctx is None:
                    self.sub_ctx = RunContext(submodel, [], models=[],
                                              **self._kw)
                slots.append((key, self.sub_ctx.append(subh, submodel)))
            self._parts_of[i] = slots
            self.n_partitions += len(slots)
            self.n_decomposed += 1
            if rec:
                obs.count("jepsen_engine_decomposed_total",
                          route="decomposed")
                obs.count("jepsen_engine_partitions_total", len(slots))
                obs.registry().histogram(
                    "jepsen_engine_partition_fanout", buckets=FANOUT_BUCKETS,
                ).observe(len(slots))
            for _key, idx in slots:
                yield self.sub_ctx, idx

    @property
    def contexts(self) -> List[RunContext]:
        return [c for c in (self.main_ctx, self.sub_ctx) if c is not None]

    def drain_oracles(self) -> None:
        for ctx in self.contexts:
            ctx.drain_oracles()

    def results(self) -> List[dict]:
        """Per-history results in input order (after :meth:`feed` has run
        out and the oracles have drained)."""
        out: List[Optional[dict]] = [None] * self.n
        if self.main_ctx is not None:
            for local, parent in enumerate(self._pass_idx):
                out[parent] = self.main_ctx.results[local]
        if self.sub_ctx is not None:
            subres = self.sub_ctx.results
            for parent, slots in self._parts_of.items():
                out[parent] = merge_partition_results(
                    [(key, subres[s]) for key, s in slots]
                )
        return out  # type: ignore[return-value]
