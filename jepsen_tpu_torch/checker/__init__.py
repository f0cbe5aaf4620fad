"""The Checker seam of the port — the counterpart of
:mod:`jepsen_tpu.checker`'s protocol half and its ``linearizable``
checker.

A checker validates a history against expectations, returning a dict with
at least ``{"valid?": True | False | "unknown"}``.  :func:`check_safe` is
the seam every checker goes through (:func:`compose` and the independent
lift included); it opens a ``checker/<name>`` span in :mod:`..obs`.
:func:`linearizable` plugs the device analysis plane in behind it; the
CPU oracle it falls back on is :mod:`.linear`.

Differences from the reference, by design:

- The device route is named ``"gpu"``.  ``"tpu"`` is accepted as its
  alias, so test maps written for the reference run unchanged; device
  results carry ``"engine": "gpu"`` where the reference writes ``"tpu"``
  (the race arm's included).
- ``"auto"`` resolves to ``"gpu"`` when :func:`~..ops.wgl.supported`
  says the model has a device step, else ``"oracle"``; it never resolves
  to the service.  ``algorithm="service"`` runs the analysis on the
  resident checker daemon (:mod:`..serve`) through the
  :class:`~..serve.client.ServiceClient` the caller passes as
  ``client=`` (there is no environment switch), and raises without one.
  The client's fallback to the in-process engine is counted on it and
  tagged ``"service-fallback"`` in the result.  An unknown algorithm
  raises (the reference runs the oracle for any name it does not
  know).
- ``linearizable(..., device=)`` is passed to every device call:
  ``None`` runs on the current CUDA device (and raises without CUDA),
  ``"cpu"`` runs the plain PyTorch versions.

The reference's O(n) checkers run on the host, as there: unhandled
exceptions (checker.clj:124-151), stats (:153-183), queue (:218-238),
set (:240-291), set-full (:294-592), total-queue (:594-687), unique-ids
(:689-734) and counter (:737-795); ``timeline.html`` is in
:mod:`.timeline`; the latency and rate plots (:func:`perf_checker`,
checker.clj:797-829) in :mod:`.perf` over :mod:`.svg`; the clock plot
(:func:`clock_plot`, checker.clj:831-837) in :mod:`.clock`; and
:func:`log_file_pattern` (checker.clj:839-881) searches the nodes'
downloaded logs.
(reference semantics: jepsen/src/jepsen/checker.clj)
"""

from __future__ import annotations

import os
import re
import threading
import traceback
from collections import Counter
from typing import Any, Callable, Dict, Optional

from .. import obs
from ..history import FAIL, INFO, INVOKE, OK, History, Op
from ..util import integer_interval_set_str, real_pmap

UNKNOWN = "unknown"

#: Larger numbers dominate when merging composed verdicts.
#: (reference: checker.clj:29-34)
VALID_PRIORITIES = {True: 0, False: 1, UNKNOWN: 0.5}


def merge_valid(valids) -> Any:
    """Merge validity values; the highest-priority one wins.
    (reference: checker.clj:36-50)"""
    out = True
    for v in valids:
        if v not in VALID_PRIORITIES:
            raise ValueError(f"{v!r} is not a known valid? value")
        if VALID_PRIORITIES[v] > VALID_PRIORITIES[out]:
            out = v
    return out


class Checker:
    """Verify a history. Returns {"valid?": ...} plus details.

    opts keys include "subdirectory" — a directory within the test's store
    directory for output files.
    """

    def check(self, test: dict, history: History,
              opts: Optional[dict] = None) -> dict:
        raise NotImplementedError

    def __call__(self, test, history, opts=None) -> dict:
        return self.check(test, history, opts or {})


class FnChecker(Checker):
    """Adapt a plain function (test, history, opts) -> dict."""

    def __init__(self, fn: Callable[[dict, History, dict], dict],
                 name: str = "fn"):
        self.fn = fn
        self.name = name

    def check(self, test, history, opts=None):
        return self.fn(test, history, opts or {})


def checker(fn: Callable) -> Checker:
    return FnChecker(fn, getattr(fn, "__name__", "fn"))


def checker_name(chk: Checker) -> str:
    """A human-readable name for spans/telemetry: the FnChecker's
    function name, else the class name without its leading underscore."""
    name = getattr(chk, "name", None)
    if name:
        return str(name)
    return type(chk).__name__.lstrip("_")


def check_safe(chk: Checker, test: dict, history: History,
               opts: Optional[dict] = None) -> dict:
    """Like check, but returns {"valid?": "unknown", "error": ...} on crash.
    (reference: checker.clj:74-85)

    The universal checker seam (compose and the independent lift both
    funnel through here), so each checker gets its own obs span."""
    try:
        with obs.span(
            f"checker/{checker_name(chk)}", cat="checker"
        ) as sp:
            result = chk.check(test, history, opts or {})
            if isinstance(result, dict):
                sp.set("valid", result.get("valid?"))
        return result if result is not None else {"valid?": True}
    except Exception:
        return {"valid?": UNKNOWN, "error": traceback.format_exc()}


class _Noop(Checker):
    def check(self, test, history, opts=None):
        return None


def noop() -> Checker:
    """(reference: checker.clj:68-72)"""
    return _Noop()


class _Compose(Checker):
    def __init__(self, checker_map: Dict[str, Checker]):
        self.checker_map = dict(checker_map)

    def check(self, test, history, opts=None):
        items = list(self.checker_map.items())
        results = real_pmap(
            lambda kv: (kv[0], check_safe(kv[1], test, history, opts)), items
        )
        out = dict(results)
        out["valid?"] = merge_valid(
            r.get("valid?") for r in out.values() if r is not None
        )
        return out


def compose(checker_map: Dict[str, Checker]) -> Checker:
    """Run a map of named checkers (in parallel, each worker on the
    caller's CUDA device); merged verdict.  (reference: checker.clj:87-99)"""
    return _Compose(checker_map)


class _ConcurrencyLimit(Checker):
    def __init__(self, limit: int, chk: Checker):
        self.sem = threading.Semaphore(limit)
        self.chk = chk

    def check(self, test, history, opts=None):
        with self.sem:
            return self.chk.check(test, history, opts)


def concurrency_limit(limit: int, chk: Checker) -> Checker:
    """Bound concurrent executions of a memory-hungry checker.
    (reference: checker.clj:101-116)"""
    return _ConcurrencyLimit(limit, chk)


class _UnbridledOptimism(Checker):
    def check(self, test, history, opts=None):
        return {"valid?": True}


def unbridled_optimism() -> Checker:
    """Everything is awesome.  (reference: checker.clj:118-122)"""
    return _UnbridledOptimism()


class _UnhandledExceptions(Checker):
    def check(self, test, history, opts=None):
        infos = [
            op
            for op in history
            if op.type == INFO and op.extra.get("exception") is not None
        ]
        groups: Dict[Any, list] = {}
        for op in infos:
            groups.setdefault(op.extra.get("exception_class"), []).append(op)
        exes = [
            {
                "class": cls,
                "count": len(ops),
                "example": ops[0].to_dict(),
            }
            for cls, ops in sorted(
                groups.items(), key=lambda kv: len(kv[1]), reverse=True
            )
        ]
        out: dict = {"valid?": True}
        if exes:
            out["exceptions"] = exes
        return out


def unhandled_exceptions() -> Checker:
    """Frequency table of unhandled exceptions attached to :info ops.
    (reference: checker.clj:124-151)"""
    return _UnhandledExceptions()


def _stats_for(completions) -> dict:
    ok = sum(1 for op in completions if op.type == OK)
    fail = sum(1 for op in completions if op.type == FAIL)
    info = sum(1 for op in completions if op.type == INFO)
    return {
        "valid?": ok > 0,
        "count": ok + fail + info,
        "ok-count": ok,
        "fail-count": fail,
        "info-count": info,
    }


class _Stats(Checker):
    def check(self, test, history, opts=None):
        completions = [
            op
            for op in history
            if op.type != INVOKE and isinstance(op.process, int)
        ]
        by_f: Dict[Any, list] = {}
        for op in completions:
            by_f.setdefault(op.f, []).append(op)
        groups = {f: _stats_for(ops) for f, ops in sorted(by_f.items(), key=lambda kv: str(kv[0]))}
        out = _stats_for(completions)
        out["by-f"] = groups
        out["valid?"] = merge_valid(g["valid?"] for g in groups.values()) if groups else True
        return out


def stats() -> Checker:
    """Success/failure rates overall and by :f; valid iff every :f has some
    ok op.  (reference: checker.clj:153-183)"""
    return _Stats()


class _Queue(Checker):
    def __init__(self, model):
        self.model = model

    def check(self, test, history, opts=None):
        state = self.model
        for op in history:
            if op.f == "enqueue" and op.type == INVOKE:
                state = state.step(op)
            elif op.f == "dequeue" and op.type == OK:
                state = state.step(op)
            if state.is_inconsistent:
                return {"valid?": False, "error": state.msg}
        return {"valid?": True, "final-queue": repr(state)}


def queue(model) -> Checker:
    """Every dequeue must come from somewhere: assume every non-failing
    enqueue succeeded, only OK dequeues succeeded, and reduce the model over
    that. O(n).  (reference: checker.clj:218-238)"""
    return _Queue(model)


class _SetChecker(Checker):
    def check(self, test, history, opts=None):
        attempts = {
            op.value for op in history if op.type == INVOKE and op.f == "add"
        }
        adds = {op.value for op in history if op.type == OK and op.f == "add"}
        final_read = None
        for op in history:
            if op.type == OK and op.f == "read":
                final_read = op.value
        if final_read is None:
            return {"valid?": UNKNOWN, "error": "Set was never read"}
        final_read = set(final_read)
        ok = final_read & attempts
        unexpected = final_read - attempts
        lost = adds - final_read
        recovered = ok - adds
        return {
            "valid?": not lost and not unexpected,
            "attempt-count": len(attempts),
            "acknowledged-count": len(adds),
            "ok-count": len(ok),
            "lost-count": len(lost),
            "recovered-count": len(recovered),
            "unexpected-count": len(unexpected),
            "ok": integer_interval_set_str(ok),
            "lost": integer_interval_set_str(lost),
            "unexpected": integer_interval_set_str(unexpected),
            "recovered": integer_interval_set_str(recovered),
        }


def set_checker() -> Checker:
    """Adds followed by a final read: every acknowledged add must be
    present; nothing unattempted may appear.  (reference: checker.clj:240-291)"""
    return _SetChecker()


# ---------------------------------------------------------------------------
# set-full: per-element visibility state machine
# ---------------------------------------------------------------------------


class _SetFullElement:
    """Tracks one element's timeline.  (reference: checker.clj:294-407)"""

    __slots__ = ("element", "known", "last_present", "last_absent")

    def __init__(self, element):
        self.element = element
        self.known: Optional[Op] = None       # completion proving existence
        self.last_present: Optional[Op] = None  # latest read invoke observing it
        self.last_absent: Optional[Op] = None   # latest read invoke missing it

    def on_add_ok(self, op: Op):
        if self.known is None:
            self.known = op

    def on_read_present(self, inv: Op, op: Op):
        if self.known is None:
            self.known = op
        if self.last_present is None or self.last_present.index < inv.index:
            self.last_present = inv

    def on_read_absent(self, inv: Op, op: Op):
        if self.last_absent is None or self.last_absent.index < inv.index:
            self.last_absent = inv

    def results(self) -> dict:
        idx = lambda op, d=-1: op.index if op is not None else d  # noqa: E731
        stable = bool(
            self.last_present is not None
            and idx(self.last_absent) < idx(self.last_present)
        )
        lost = bool(
            self.known is not None
            and self.last_absent is not None
            and idx(self.last_present) < idx(self.last_absent)
            and self.known.index < self.last_absent.index
        )
        known_time = self.known.time if self.known else None
        stable_time = (
            (self.last_absent.time + 1 if self.last_absent else 0) if stable else None
        )
        lost_time = (
            (self.last_present.time + 1 if self.last_present else 0) if lost else None
        )
        ns_to_ms = lambda ns: int(ns // 1_000_000)  # noqa: E731
        return {
            "element": self.element,
            "outcome": "stable" if stable else ("lost" if lost else "never-read"),
            "stable-latency": (
                ns_to_ms(max(0, stable_time - known_time)) if stable else None
            ),
            "lost-latency": (
                ns_to_ms(max(0, lost_time - known_time)) if lost else None
            ),
        }


def frequency_distribution(points, values) -> Optional[dict]:
    """Percentiles (0–1) of a collection.  (reference: checker.clj:409-420)"""
    ordered = sorted(values)
    if not ordered:
        return None
    n = len(ordered)
    return {p: ordered[min(n - 1, int(n * p))] for p in points}


class _SetFull(Checker):
    def __init__(self, linearizable: bool = False):
        self.linearizable = linearizable

    def check(self, test, history, opts=None):
        elements: Dict[Any, _SetFullElement] = {}
        pending_reads: Dict[Any, Op] = {}
        dups: Dict[Any, int] = {}
        for op in history:
            if not isinstance(op.process, int):
                continue
            if op.f == "add":
                if op.type == INVOKE:
                    if op.value not in elements:
                        elements[op.value] = _SetFullElement(op.value)
                elif op.type == OK:
                    el = elements.get(op.value)
                    if el is not None:
                        el.on_add_ok(op)
            elif op.f == "read":
                if op.type == INVOKE:
                    pending_reads[op.process] = op
                elif op.type == FAIL:
                    pending_reads.pop(op.process, None)
                elif op.type == INFO:
                    pass
                elif op.type == OK:
                    inv = pending_reads.pop(op.process, op)
                    values = op.value or []
                    counts = Counter(values)
                    for v, c in counts.items():
                        if c > 1:
                            dups[v] = max(dups.get(v, 0), c)
                    vset = set(values)
                    for element, state in elements.items():
                        if element in vset:
                            state.on_read_present(inv, op)
                        else:
                            state.on_read_absent(inv, op)
        rs = [
            elements[k].results()
            for k in sorted(elements.keys(), key=lambda x: (str(type(x)), x))
        ]
        outcomes: Dict[str, list] = {}
        for r in rs:
            outcomes.setdefault(r["outcome"], []).append(r)
        stable = outcomes.get("stable", [])
        lost = outcomes.get("lost", [])
        never_read = outcomes.get("never-read", [])
        stale = [r for r in stable if r["stable-latency"] and r["stable-latency"] > 0]
        worst_stale = sorted(stale, key=lambda r: r["stable-latency"], reverse=True)[:8]
        if lost:
            valid: Any = False
        elif not stable:
            valid = UNKNOWN
        elif self.linearizable and stale:
            valid = False
        else:
            valid = True
        if dups:
            valid = merge_valid([valid, False])
        out = {
            "valid?": valid,
            "attempt-count": len(rs),
            "stable-count": len(stable),
            "lost-count": len(lost),
            "lost": sorted(r["element"] for r in lost),
            "never-read-count": len(never_read),
            "never-read": sorted(r["element"] for r in never_read),
            "stale-count": len(stale),
            "stale": sorted(r["element"] for r in stale),
            "worst-stale": worst_stale,
            "duplicated-count": len(dups),
            "duplicated": dict(sorted(dups.items(), key=lambda kv: str(kv[0]))),
        }
        points = [0, 0.5, 0.95, 0.99, 1]
        sl = frequency_distribution(points, [r["stable-latency"] for r in rs if r["stable-latency"] is not None])
        ll = frequency_distribution(points, [r["lost-latency"] for r in rs if r["lost-latency"] is not None])
        if sl:
            out["stable-latencies"] = sl
        if ll:
            out["lost-latencies"] = ll
        return out


def set_full(linearizable: bool = False) -> Checker:
    """Rigorous set analysis: per-element stable/lost/never-read outcomes
    with stability latencies; stale reads fail linearizable sets.
    (reference: checker.clj:461-592)"""
    return _SetFull(linearizable=linearizable)


# ---------------------------------------------------------------------------
# queues, ids, counters
# ---------------------------------------------------------------------------


def expand_queue_drain_ops(history: History) -> History:
    """Expand ok :drain ops (value = list of elements) into dequeue
    invoke/ok pairs.  (reference: checker.clj:594-626)"""
    out = History()
    for op in history:
        if op.f != "drain":
            out.append(op)
        elif op.type in (INVOKE, FAIL):
            continue
        elif op.type == OK:
            for element in op.value or []:
                out.append(op.copy(type=INVOKE, f="dequeue", value=None))
                out.append(op.copy(type=OK, f="dequeue", value=element))
        else:
            raise ValueError(f"Not sure how to handle a crashed drain operation: {op!r}")
    return out


class _TotalQueue(Checker):
    def check(self, test, history, opts=None):
        history = expand_queue_drain_ops(history)
        attempts = Counter(
            op.value for op in history if op.type == INVOKE and op.f == "enqueue"
        )
        enqueues = Counter(
            op.value for op in history if op.type == OK and op.f == "enqueue"
        )
        dequeues = Counter(
            op.value for op in history if op.type == OK and op.f == "dequeue"
        )
        ok = dequeues & attempts
        unexpected = Counter(
            {v: c for v, c in dequeues.items() if v not in attempts}
        )
        duplicated = dequeues - attempts - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues
        return {
            "valid?": not lost and not unexpected,
            "attempt-count": sum(attempts.values()),
            "acknowledged-count": sum(enqueues.values()),
            "ok-count": sum(ok.values()),
            "unexpected-count": sum(unexpected.values()),
            "duplicated-count": sum(duplicated.values()),
            "lost-count": sum(lost.values()),
            "recovered-count": sum(recovered.values()),
            "lost": dict(lost),
            "unexpected": dict(unexpected),
            "duplicated": dict(duplicated),
            "recovered": dict(recovered),
        }


def total_queue() -> Checker:
    """What goes in must come out (assuming the history drains the queue).
    O(n).  (reference: checker.clj:628-687)"""
    return _TotalQueue()


class _UniqueIds(Checker):
    def check(self, test, history, opts=None):
        attempted = sum(
            1 for op in history if op.type == INVOKE and op.f == "generate"
        )
        acks = [op.value for op in history if op.type == OK and op.f == "generate"]
        counts = Counter(acks)
        dups = {k: v for k, v in counts.items() if v > 1}
        rng = [min(acks), max(acks)] if acks else [None, None]
        return {
            "valid?": not dups,
            "attempted-count": attempted,
            "acknowledged-count": len(acks),
            "duplicated-count": len(dups),
            "duplicated": dict(
                sorted(dups.items(), key=lambda kv: kv[1], reverse=True)[:48]
            ),
            "range": rng,
        }


def unique_ids() -> Checker:
    """A unique-id generator must emit distinct values.
    (reference: checker.clj:689-734)"""
    return _UniqueIds()


class _CounterChecker(Checker):
    def check(self, test, history, opts=None):
        lower = 0
        upper = 0
        pending_reads: Dict[Any, list] = {}
        reads = []
        completed = history.complete().without_failures()
        for op in completed:
            if op.f == "read":
                if op.type == INVOKE:
                    pending_reads[op.process] = [lower, op.value]
                elif op.type == OK:
                    r = pending_reads.pop(op.process, None)
                    if r is not None:
                        # observed value was propagated onto the invoke by
                        # complete(); prefer the completion's value
                        reads.append([r[0], op.value, upper])
            elif op.f == "add":
                if op.type == INVOKE:
                    if op.value is None or op.value < 0:
                        raise ValueError(f"counter add must be non-negative: {op!r}")
                    upper += op.value
                elif op.type == OK:
                    lower += op.value
        errors = [r for r in reads if not (r[0] <= r[1] <= r[2])]
        return {"valid?": not errors, "reads": reads, "errors": errors}


def counter() -> Checker:
    """Monotonically increasing counter: each read must fall within
    [sum of ok adds at invoke, sum of attempted adds at completion].
    (reference: checker.clj:737-795)"""
    return _CounterChecker()


#: after one race arm answers, how long a wedged straggler may hold up
#: an indefinite ("unknown") verdict before we settle for it
RACE_LOSER_WAIT_S = 60.0

#: the algorithms :func:`linearizable` takes; ``"tpu"`` is the
#: reference's name of the device route
ALGORITHMS = ("auto", "gpu", "tpu", "oracle", "race", "service")


class _Linearizable(Checker):
    def _oracle_analysis(self, history) -> dict:
        """One call: linear.analysis(witness=True) runs the fast
        interned-int search (per-key decomposed where the model factors)
        and re-searches only a failing history's failing partition with
        parent pointers, keeping the definite False even if the witness
        pass blows the shared budget — so valid verdicts ride the fast
        path, failures carry final-paths/ops, and total wall time stays
        bounded by oracle_budget_s."""
        from . import linear

        return linear.analysis(
            self.model, history, pure_fs=self.pure_fs, witness=True,
            budget_s=self.oracle_budget_s,
        )

    def _race(self, test, history) -> dict:
        """Run the device analysis and the CPU oracle concurrently; the
        first DEFINITE (non-unknown) verdict wins.  Both arms tag their
        result so the report says who won.  Arms run on daemon threads
        (the device arm on the caller's CUDA device): a hung device must
        never pin process exit, and the loser's result is simply
        dropped."""
        import queue

        from .. import device as device_mod
        from ..ops import wgl

        def kernel():
            if not wgl.supported(self.model):
                return None
            from . import locks_direct

            d = locks_direct.analysis(self.model, history)
            if d is not None:
                # models a direct polynomial checker covers decide in
                # microseconds; a True verdict IS this arm's answer,
                # while a False CONCEDES so the oracle arm's witnessed
                # report (final-paths for the failure renderer) wins
                if d["valid?"] is True:
                    d.setdefault("engine", "direct")
                    return d
                return None
            # oracle_fallback=False: unencodable/overflowing histories
            # come back "unknown" (conceding the race) instead of
            # duplicating the oracle arm's exponential search
            out = wgl.analysis(self.model, history, oracle_fallback=False,
                               device=self.device)
            out.setdefault("engine", "gpu")
            return out

        def oracle():
            out = self._oracle_analysis(history)
            out["engine"] = "oracle"
            return out

        results: "queue.Queue" = queue.Queue()

        def run(arm):
            try:
                results.put(("ok", arm()))
            except Exception as e:  # noqa: BLE001 — other arm decides
                results.put(("err", e))

        n_arms = 2
        for arm in (kernel, oracle):
            threading.Thread(target=device_mod.carry_current(run),
                             args=(arm,), daemon=True).start()
        last = None
        for i in range(n_arms):
            try:
                # the first answer may wait as long as it needs; once one
                # arm has spoken, a wedged straggler only gets a bounded
                # grace period before we settle for what we have
                status, out = results.get(
                    timeout=None if i == 0 else RACE_LOSER_WAIT_S
                )
            except queue.Empty:
                break
            if status == "err":
                last = {"valid?": "unknown", "error": repr(out)}
                continue
            if out is not None and out.get("valid?") != "unknown":
                return out
            last = out or last
        return last or {"valid?": "unknown", "error": "no arm finished"}

    def __init__(
        self,
        model,
        algorithm: str = "auto",
        pure_fs=("read",),
        oracle_budget_s=None,
        device=None,
        client=None,
    ):
        if model is None:
            raise ValueError(
                "The linearizable checker requires a model. It received None."
            )
        if algorithm == "service" and client is None:
            raise ValueError(
                "algorithm='service' needs the resident checker service: "
                "pass client=ServiceClient(...) naming its address")
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}: one of "
                             f"{ALGORITHMS}")
        self.model = model
        self.algorithm = "gpu" if algorithm == "tpu" else algorithm
        self.pure_fs = tuple(pure_fs)
        #: wall-time bound for the exponential CPU oracle search; past it
        #: the verdict is an honest "unknown" (check-safe semantics,
        #: checker.clj:74-85) instead of an analysis that hangs for hours
        #: on one poisoned key
        self.oracle_budget_s = oracle_budget_s
        #: where the device route runs (None: the current CUDA device)
        self.device = device
        #: the checker daemon's client of the "service" route
        self.client = client

    def check(self, test, history, opts=None):
        algorithm = self.algorithm
        if algorithm == "auto":
            from ..ops import wgl

            algorithm = "gpu" if wgl.supported(self.model) else "oracle"
        if algorithm == "race":
            # knossos-style competition: device kernel and CPU oracle run
            # concurrently, first definite verdict wins (reference:
            # checker.clj:199-203)
            a = self._race(test, history)
        elif algorithm == "gpu":
            from ..ops import wgl
            from ..parallel import mesh as mesh_mod

            # through the pipelined engine: test["engine-window"] bounds
            # its in-flight device dispatches (None takes the default);
            # an explicit test mesh flows through like the batched lift's
            a = wgl.analysis(
                self.model, history, oracle_budget_s=self.oracle_budget_s,
                window=(test or {}).get("engine-window"),
                mesh=mesh_mod.resolve_mesh(test or {}),
                device=self.device,
            )
        elif algorithm == "service":
            from ..serve import client as serve_client

            # the daemon when it serves the history; a budgeted search
            # (deadline semantics) or a refusal runs in-process, counted
            a = serve_client.analysis(
                self.model, history, client=self.client,
                oracle_budget_s=self.oracle_budget_s,
                window=(test or {}).get("engine-window"),
                device=self.device,
            )
        else:
            a = self._oracle_analysis(history)
        # Failure witness: linear.svg with final configs/paths around the
        # non-linearizable op (reference: checker.clj:206-210).  Only when
        # the test has a real store identity — unit checks on bare test
        # maps should not litter the working directory.
        if (
            a.get("valid?") is False
            and test
            and test.get("name")
            and test.get("start-time")
        ):
            from .. import store as store_mod
            from . import linear_svg

            try:
                out = store_mod.path_(
                    test, *(opts or {}).get("subdirectory", []), "linear.svg"
                )
                if linear_svg.render_witness(
                    self.model, history, a, out, pure_fs=self.pure_fs,
                    budget_s=self.oracle_budget_s,
                ):
                    a["witness"] = out
            except Exception as e:  # noqa: BLE001 — never mask the verdict
                a["witness-error"] = repr(e)
        # Truncate potentially huge fields (reference: checker.clj:213-216)
        if "configs" in a:
            a["configs"] = a["configs"][:10]
        if "final-paths" in a:
            a["final-paths"] = a["final-paths"][:10]
        if "ops" in a:
            del a["ops"]  # witness-renderer context; huge on long tests
        return a


def linearizable(
    model,
    algorithm: str = "auto",
    pure_fs=("read",),
    oracle_budget_s=None,
    device=None,
    client=None,
) -> Checker:
    """Validate linearizability against a model.  algorithm: "auto" (the
    device route when the model has a device step, else the oracle),
    "gpu" (alias "tpu"), "oracle", or "race" (device and oracle
    concurrently, first definite verdict wins — knossos's competition
    mode), or "service" (the checker daemon behind ``client``, a
    :class:`~jepsen_tpu_torch.serve.client.ServiceClient`; raises without
    one).  ``oracle_budget_s`` bounds the exponential CPU search's wall
    time; past it the verdict is an honest "unknown".  ``device`` is
    passed to every device call (None: the current CUDA device, raising
    without CUDA; "cpu": the plain PyTorch versions).
    (reference: checker.clj:185-216)"""
    return _Linearizable(model, algorithm, pure_fs, oracle_budget_s, device,
                         client)


class _LogFilePattern(Checker):
    def __init__(self, pattern, filename: str):
        self.pattern = re.compile(pattern)
        self.filename = filename

    def check(self, test, history, opts=None):
        from .. import store as store_mod

        def search(node):
            path = store_mod.path(test, node, self.filename)
            if not os.path.exists(path):
                return []
            found = []
            with open(path, "r", errors="replace") as f:
                for line in f:
                    if self.pattern.search(line):
                        found.append({"node": node, "line": line.rstrip("\n")})
            return found

        matches = [
            m for ms in real_pmap(search, test.get("nodes", [])) for m in ms
        ]
        return {"valid?": not matches, "count": len(matches), "matches": matches}


def log_file_pattern(pattern, filename: str) -> Checker:
    """Search each node's downloaded log file for a pattern; matches fail
    the test.  (reference: checker.clj:839-881; uses Python re instead of
    shelling out to grep -P)"""
    return _LogFilePattern(pattern, filename)


# ---------------------------------------------------------------------------
# Graph checkers (SVG renderers; reference used gnuplot)
# ---------------------------------------------------------------------------


class _LatencyGraph(Checker):
    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}

    def check(self, test, history, opts=None):
        if not test.get("store?", True):
            return {"valid?": True}
        from . import perf as perf_mod

        o = {**self.opts, **(opts or {})}
        perf_mod.point_graph(test, history, o)
        perf_mod.quantiles_graph(test, history, o)
        return {"valid?": True}


def latency_graph(opts: Optional[dict] = None) -> Checker:
    """Plots latency raw + quantiles.  (reference: checker.clj:797-808)"""
    return _LatencyGraph(opts)


class _RateGraph(Checker):
    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}

    def check(self, test, history, opts=None):
        if not test.get("store?", True):
            return {"valid?": True}
        from . import perf as perf_mod

        perf_mod.rate_graph(test, history, {**self.opts, **(opts or {})})
        return {"valid?": True}


def rate_graph(opts: Optional[dict] = None) -> Checker:
    """Plots throughput over time.  (reference: checker.clj:810-820)"""
    return _RateGraph(opts)


def perf_checker(opts: Optional[dict] = None) -> Checker:
    """Composes latency + rate graphs.  (reference: checker.clj:822-829;
    named perf_checker because the submodule jepsen_tpu_torch.checker.perf
    holds the plot functions)"""
    return compose(
        {"latency-graph": latency_graph(opts), "rate-graph": rate_graph(opts)}
    )


def clock_plot() -> Checker:
    """Plots clock offsets on all nodes.  (reference: checker.clj:831-837)"""
    from . import clock as clock_mod

    return clock_mod.plotter()
