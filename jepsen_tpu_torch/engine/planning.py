"""The pure per-run **planning** half of the checker engine — the port of
:mod:`jepsen_tpu.engine.planning`.

Everything per-run and pure lives here: encoding histories into per-(E,
C) shape buckets, stacking a bucket into padded arrays and planning its
kernel route (``wgl.plan_bucket``).  Everything that owns the device
lives in :mod:`jepsen_tpu_torch.engine.execution`.  The reference's
tuning reads are gone: its defaults are constants or arguments here.
Settles feed :mod:`..obs` as the reference's do: the time to the first
verdict and to the first violation, and the per-engine row counts of a
finished run (:func:`finish_run_telemetry`).

Row identity is an opaque token ``(ctx, idx)``: every planned row carries
the :class:`RunContext` it belongs to, so the execution layer can route
each verdict home.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import obs

#: rows a shape bucket accumulates before flushing mid-stream, per device
#: (the default dispatch cap: ordinary batches flush once per bucket,
#: larger keyspaces stream — encode of flush k+1 overlaps device work of k)
DEFAULT_FLUSH_ROWS = 16384

#: sentinel distinct from every bucket key (``None`` is the legitimate
#: key of unbucketed mode): this history routed to the oracle pool
_ROUTED_ORACLE = object()


def _note_settle_times(result: dict) -> None:
    """Record the run's time-to-first-verdict / time-to-violation gauges
    the moment a slot settles: seconds since the tracer's wall origin,
    written once — the first settle and the first ``valid? = false``
    verdict win."""
    if not obs.enabled():
        return
    import time as _time

    reg = obs.registry()
    dt = _time.time() - obs.tracer().wall_origin
    if reg.value("jepsen_run_first_verdict_seconds") is None:
        obs.gauge_set("jepsen_run_first_verdict_seconds", round(dt, 6))
    if (result.get("valid?") is False
            and reg.value("jepsen_run_first_violation_seconds") is None):
        obs.gauge_set("jepsen_run_first_violation_seconds", round(dt, 6))


class RunContext:
    """One run's bookkeeping: the histories being checked, their result
    slots, per-history model overrides (the decomposition front-end's
    sub-history context seeds one sub-model per row), and the oracle
    hand-off state.

    Thread contract (by phase ordering, not locks): during planning only
    the planning thread touches the context; during execution only the
    executor thread assigns results; the consumer calls
    :meth:`drain_oracles` and reads :attr:`results` after execution."""

    def __init__(
        self,
        model,
        histories: Sequence,
        *,
        models: Optional[List] = None,
        oracle_fallback: bool = True,
        oracle_budget_s: Optional[float] = None,
    ):
        from ..ops.step_kernels import spec_for

        self.model = model
        self.histories = list(histories)
        #: per-history models, or None: every history checks against
        #: ``model``
        self.models = models
        self.spec = spec_for(model)
        self.oracle_fallback = oracle_fallback
        #: wall-time bound of each oracle search (None: unbounded)
        self.oracle_budget_s = oracle_budget_s
        self.results: List[Optional[dict]] = [None] * len(self.histories)
        self.oracle_futs: Dict[int, Tuple[Any, str]] = {}
        #: budgeted searches, run serially at :meth:`drain_oracles`
        self.oracle_deferred: List[Tuple[int, str]] = []

    def model_for(self, idx: int):
        """The model history ``idx`` checks against (encode's initial
        state and the oracle both read it, so they cannot disagree about
        a sub-history's seeded state)."""
        return self.model if self.models is None else self.models[idx]

    def append(self, history, model=None) -> int:
        """Grow the context by one history (and its result slot) while it
        is still being planned; returns the new index."""
        idx = len(self.histories)
        self.histories.append(history)
        self.results.append(None)
        if self.models is not None:
            self.models.append(model if model is not None else self.model)
        elif model is not None and model is not self.model:
            self.models = [self.model] * idx + [model]
        return idx

    def assign(self, idx: int, result: dict) -> None:
        self.results[idx] = result
        _note_settle_times(result)

    def route_oracle(self, idx: int, engine_tag: str,
                     unresolved_tag: str) -> None:
        """Queue one history for the CPU oracle worker pool (running
        concurrently with device work), or tag it unknown when the caller
        runs the oracle itself (``oracle_fallback=False``).

        Budgeted searches (``oracle_budget_s``) are not overlapped: the
        budget is a wall-clock deadline, and worker threads sharing the
        interpreter would burn it faster than a serial search, flipping
        verdicts to "unknown".  They run one after another at
        :meth:`drain_oracles`, as in the reference."""
        from ..checker import linear

        if not self.oracle_fallback:
            self.assign(idx, {"valid?": "unknown", "engine": unresolved_tag})
            return
        if self.oracle_budget_s is not None:
            self.oracle_deferred.append((idx, engine_tag))
            return
        self.oracle_futs[idx] = (
            linear.analysis_async(
                self.model_for(idx), self.histories[idx],
                pure_fs=self.spec.pure_fs if self.spec else (),
            ),
            engine_tag,
        )

    def drain_oracles(self) -> None:
        """Collect the concurrent oracle verdicts, then run the budgeted
        searches serially (see :meth:`route_oracle`)."""
        from ..checker import linear

        for idx, (fut, engine_tag) in self.oracle_futs.items():
            r = fut.result()
            r["engine"] = engine_tag
            self.assign(idx, r)
        pure = self.spec.pure_fs if self.spec else ()
        for idx, engine_tag in self.oracle_deferred:
            r = linear.analysis(
                self.model_for(idx), self.histories[idx], pure_fs=pure,
                budget_s=self.oracle_budget_s,
            )
            r["engine"] = engine_tag
            self.assign(idx, r)


class PlannedBucket:
    """One stacked-and-routed bucket, ready for the execution layer: the
    plan (a :class:`~jepsen_tpu_torch.ops.wgl.BucketPlan`, or an Elle
    screen's self-settling plan), its arrays (the padded 6-tuple of a
    history bucket, the one relation batch of a screen) and one row token
    per array row (``(ctx, idx)``, or a screen's ``(sink, idx)``)."""

    __slots__ = ("key", "plan", "arrays", "rows")

    def __init__(self, key, plan, arrays, rows):
        self.key = key
        self.plan = plan
        self.arrays = arrays
        self.rows = rows


class Planner:
    """Pure per-run planning: stream host encode into per-(E, C) shape
    buckets and plan each flush's kernel route on ``device``.  The flush
    threshold is a per-device feed rate: on an ``n_devices`` mesh a flush
    fans out over every device, so it waits for ``n_devices`` ×
    :data:`DEFAULT_FLUSH_ROWS` rows."""

    def __init__(
        self,
        model,
        *,
        slot_cap: int,
        device,
        max_dispatch: int,
        frontier: int,
        max_closure: Optional[int] = None,
        bucketed: bool = True,
        n_devices: int = 1,
    ):
        from ..ops.step_kernels import spec_for

        self.model = model
        self.spec = spec_for(model)
        self.slot_cap = slot_cap
        self.device = device
        self.max_dispatch = max_dispatch
        self.frontier = frontier
        self.max_closure = max_closure
        self.bucketed = bucketed
        self.flush_rows = max(1, n_devices) * DEFAULT_FLUSH_ROWS
        #: distinct shape buckets of finished streams, and bucket flushes
        #: planned (a bucket that streams mid-input flushes more than once)
        self.n_buckets = 0
        self.n_flushes = 0

    def encode_one(self, ctx: RunContext, idx: int):
        """Encode one history of ``ctx`` against its own model
        (``ctx.model_for``); ``None`` routes it to the oracle — every
        history of a model without a spec (the fenced mutexes, the FIFO
        queue, an undecomposed multi-mutex) does."""
        from ..ops import encode as encode_mod

        if self.spec is None:
            return None
        return encode_mod.encode_history(
            ctx.histories[idx], ctx.model_for(idx), self.slot_cap, self.spec
        )

    def bucket_key(self, e) -> Optional[tuple]:
        from ..ops import encode as encode_mod

        return (
            encode_mod.bucket_key(e, self.slot_cap) if self.bucketed else None
        )

    def _accumulate(self, ctx: RunContext, idx: int, buckets, order):
        """Encode one history into its bucket.  Returns the bucket key
        the history landed in (``None`` IS a valid key in unbucketed
        mode), or :data:`_ROUTED_ORACLE` when it went to the oracle
        instead — that search starts NOW, on the worker pool."""
        e = self.encode_one(ctx, idx)
        if e is None:
            ctx.route_oracle(idx, "oracle-fallback", "unencodable")
            return _ROUTED_ORACLE
        key = self.bucket_key(e)
        acc = buckets.get(key)
        if acc is None:
            acc = buckets[key] = ([], [])
            order.append(key)
        acc[0].append(e)
        acc[1].append((ctx, idx))
        return key

    def plan_rows(self, key, encs: list, rows: list) -> Optional[PlannedBucket]:
        """Stack one bucket's encoded histories and plan its kernel
        route; ``rows`` are ``(ctx, idx)`` tokens aligned with ``encs``.
        Returns ``None`` for an empty bucket."""
        from ..ops import encode as encode_mod
        from ..ops import wgl

        if not encs:
            return None
        if key is not None:
            E, C = key
        else:
            E, C = encode_mod.global_shape(encs, self.slot_cap)
        batch = encode_mod.stack_encoded(encs, rows, E, C)
        arrays = (
            batch.init_state, batch.ev_slot, batch.cand_slot,
            batch.cand_f, batch.cand_a, batch.cand_b,
        )
        self.n_flushes += 1
        plan = wgl.plan_bucket(
            self.model, self.spec, arrays, device=self.device,
            frontier=self.frontier,
            max_closure=self.max_closure, max_dispatch=self.max_dispatch,
        )
        return PlannedBucket(key, plan, arrays, batch.row_history)

    def open_stream(self) -> "BucketStream":
        return BucketStream(self)


class BucketStream:
    """One in-progress streaming pass over a :class:`Planner`:
    :meth:`feed` accumulates (and mid-stream-flushes) one history at a
    time, :meth:`finish` plans the residual buckets and yields them
    largest estimated cost first (big buckets keep the dispatch window
    busy while small ones fill the tail; ties keep first-seen order)."""

    __slots__ = ("planner", "buckets", "order", "finished")

    def __init__(self, planner: Planner):
        self.planner = planner
        self.buckets: Dict[Any, Tuple[list, list]] = {}
        self.order: List[Any] = []  # first-seen bucket order
        self.finished = False

    def feed(self, ctx: RunContext, idx: int):
        """Encode history ``idx`` of ``ctx``; yields a
        :class:`PlannedBucket` when its bucket fills mid-stream."""
        if self.finished:
            raise RuntimeError("BucketStream already finished")
        p = self.planner
        key = p._accumulate(ctx, idx, self.buckets, self.order)
        if key is _ROUTED_ORACLE:
            return
        acc = self.buckets[key]
        if p.bucketed and len(acc[0]) >= p.flush_rows:
            pb = p.plan_rows(key, *acc)
            self.buckets[key] = ([], [])
            if pb is not None:
                yield pb

    def finish(self):
        """Plan every residual bucket, then yield biggest-cost-first."""
        if self.finished:
            raise RuntimeError("BucketStream already finished")
        p = self.planner
        planned = []
        for key in self.order:
            pb = p.plan_rows(key, *self.buckets[key])
            if pb is not None:
                planned.append(pb)
        p.n_buckets += len(self.order)
        self.finished = True
        planned.sort(key=estimated_cost, reverse=True)
        yield from planned


def estimated_cost(pb: PlannedBucket) -> float:
    """Per-bucket device-cost proxy the dispatch order ranks by: rows × E
    for the dense automaton (a fixed-width scan), rows × F·(C+1)·⌈E/32⌉
    for the frontier search (its closure's candidate lanes over the
    event scan), rows × E²·F for the Elle screens (the n × n closure over
    the profile's plane weight F), 0 for a bucket the oracle takes.  It
    reads no value domain, so the pairs of the composite automata pass
    through.  It only ranks buckets; it never changes a verdict."""
    plan = pb.plan
    rows = len(pb.rows)
    if plan.fn is None or plan.disp == 0:
        return 0.0
    if plan.kernel == "dense":
        return float(rows * plan.E)
    if plan.kernel == "cycles":
        return float(rows) * plan.E * plan.E * max(1, plan.frontier)
    words = max(1, -(-plan.E // 32))
    return float(rows * plan.frontier * (plan.C + 1) * words)


def finish_run_telemetry(results: Sequence[Optional[dict]]) -> None:
    """Per-history engine-outcome counters of a finished run
    (``jepsen_engine_rows_total``): device rows count under their kernel
    name, everything else under its engine tag."""
    from ..ops import wgl

    if not (obs.enabled() and results):
        return
    stats = wgl.batch_stats([r for r in results if r is not None])
    for eng, cnt in stats["engines"].items():
        if eng == "gpu":
            continue
        obs.count("jepsen_engine_rows_total", cnt, engine=eng)
    for k, cnt in stats["kernels"].items():
        obs.count("jepsen_engine_rows_total", cnt, engine=k)
