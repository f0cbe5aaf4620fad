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

The reference's O(n) checkers (``stats``, ``set``, ``queue``,
``counter``, …) serve the test harness and are not ported.
(reference semantics: jepsen/src/jepsen/checker.clj)
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, Dict, Optional

from .. import obs
from ..history import History
from ..util import real_pmap

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
