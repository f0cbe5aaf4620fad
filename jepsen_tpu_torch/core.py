"""Test lifecycle orchestration (reference: jepsen/src/jepsen/core.clj).

``run(test)`` drives the full lifecycle: prepare, OS/DB setup (when a
remote control plane is configured), client+nemesis setup, the
interpreter, analysis, and persistence:

    run! (core.clj:327) → prepare-test:311 → with-os/with-db:93-181
    → run-case!:214 (client+nemesis setup/teardown:183-212 around
      generator.interpreter/run!) → analyze!:221 → log-results:239

In-process tests use a dummy remote + fake clients and skip OS/DB setup,
exactly like the reference's ``:ssh {:dummy? true}`` mode
(control.clj:40, core_test.clj:55-120).

The port's differences: ``obs?`` defaults to on, with no environment
switch.  ``tracing`` names a JSONL file that the run's per-client spans
(:mod:`.trace`, wired by :func:`~.trace.wire`) are appended to.  The
analysis runs where the test's checkers
say (``device=``); the interpreter's worker threads never touch CUDA.
"""

from __future__ import annotations

import datetime
import logging
import threading
from typing import Optional

from . import checker as checker_mod
from . import client as client_mod
from . import interpreter
from . import nemesis as nemesis_mod
from . import obs
from .history import History
from .util import real_pmap, with_relative_time

log = logging.getLogger(__name__)


class Synchronizer:
    """A reusable barrier for :conn-barrier style cross-node sync during
    DB setup (reference: core.clj:44-57 synchronize)."""

    def __init__(self, parties: int):
        self.barrier = threading.Barrier(parties)

    def synchronize(self, timeout: Optional[float] = None):
        self.barrier.wait(timeout)


def prepare_test(test: dict) -> dict:
    """Fill in start-time, barrier, default keys.
    (reference: core.clj:311-325)"""
    test = dict(test)
    test.setdefault("start-time", datetime.datetime.now().strftime("%Y%m%dT%H%M%S.%f")[:-3])
    test.setdefault("nodes", ["n1", "n2", "n3", "n4", "n5"])
    test.setdefault("concurrency", len(test["nodes"]))
    test.setdefault("barrier", Synchronizer(len(test["nodes"])))
    test.setdefault("checker", checker_mod.unbridled_optimism())
    test.setdefault("nemesis", nemesis_mod.noop())
    test.setdefault("client", client_mod.noop())
    return test


def run_case(test: dict) -> History:
    """Set up nemesis + per-node clients, run the interpreter, tear down.
    (reference: core.clj:183-218)"""
    client = test["client"]
    nemesis = nemesis_mod.validate(test["nemesis"])

    nemesis = nemesis.setup(test)
    test = {**test, "nemesis": nemesis}

    # Track successfully-opened clients even if a later node's open
    # raises, so teardown ALWAYS covers what was opened (reference
    # guarantees teardown of both nemesis and clients, core.clj:183-212).
    clients: list = []
    clients_lock = threading.Lock()

    def open_and_setup(node):
        c = client.open(test, node)
        with clients_lock:
            clients.append((c, node))
        c.setup(test)
        return c

    try:
        with obs.span("setup", cat="phase"):
            real_pmap(open_and_setup, test["nodes"])
        with obs.span("generator", cat="phase"):
            return interpreter.run(test)
    finally:
        with obs.span("teardown", cat="phase"):
            try:
                nemesis.teardown(test)
            finally:

                def teardown_and_close(cn):
                    c, _node = cn
                    try:
                        c.teardown(test)
                    finally:
                        c.close(test)

                with clients_lock:
                    opened = list(clients)
                real_pmap(teardown_and_close, opened)


_snarf_lock = threading.Lock()


def snarf_logs(test: dict) -> None:
    """Download every DB log file (db.LogFiles) from every node into the
    test's store directory under ``<store>/<node>/<short-path>``, where
    short paths drop the nodes' common directory prefix.  Worker crashes
    and missing files are tolerated per-file so one broken node can't
    lose the others' logs.  (reference: core.clj:102-135 snarf-logs!)"""
    from . import control
    from . import db as db_mod
    from . import store as store_mod

    db = test.get("db")
    if not isinstance(db, db_mod.LogFiles) or not test.get("store?", True):
        return

    with _snarf_lock, obs.span("snarf-logs", cat="phase"):
        log.info("Snarfing log files")

        def snarf_node(test, node):
            try:
                full_paths = [str(p) for p in db.log_files(test, node)]
            except Exception:
                log.exception("couldn't list log files on %s", node)
                return
            if not full_paths:
                return
            from .util import drop_common_proper_prefix

            shorts = [
                "/".join(parts)
                for parts in drop_common_proper_prefix(
                    [p.split("/") for p in full_paths]
                )
            ]
            import subprocess

            from .control import RemoteError

            transfer_errors = (
                FileNotFoundError,
                RemoteError,
                # docker/k8s remotes raise CalledProcessError when cp
                # fails; the ssh transports wrap scp failures in
                # RuntimeError
                subprocess.CalledProcessError,
                RuntimeError,
            )
            for remote, short in zip(full_paths, shorts):
                dest = store_mod.path_(
                    test, str(node), short.lstrip("/")
                )
                try:
                    control.download(remote, dest)
                except transfer_errors as e:
                    # tolerate vanished remote files / broken transfers
                    # (reference tolerates pipe-closed and not-yet-created
                    # files, core.clj:119-134); local store errors like a
                    # full disk still propagate
                    log.info("couldn't download %s from %s: %s", remote, node, e)

        control.on_nodes(test, snarf_node)
        # an aborted run never reaches save_1, so refresh the symlinks
        # here too (reference: core.clj:135 update-symlinks!)
        store_mod.update_symlinks(test)


def maybe_snarf_logs(test: dict) -> None:
    """snarf_logs, swallowing everything — used on the abort path where
    a snarf error must not supersede the root cause.
    (reference: core.clj:137-148 maybe-snarf-logs!)"""
    try:
        snarf_logs(test)
    except Exception:
        log.exception("Error snarfing logs")


def analyze(test: dict) -> dict:
    """Index the history, run checkers, attach results.
    (reference: core.clj:221-237)"""
    with obs.span("analyze", cat="phase"):
        history = test["history"]
        if isinstance(history, History):
            history.index_ops()
        results = checker_mod.check_safe(
            test["checker"], test, history, {}
        )
    return {**test, "results": results}


def log_results(test: dict) -> dict:
    """(reference: core.clj:239-253)"""
    r = test.get("results", {})
    verdict = r.get("valid?")
    if verdict is False:
        log.warning("Analysis invalid! (ﾉಥ益ಥ）ﾉ ┻━┻")
    elif verdict == "unknown":
        log.warning("Errors occurred during analysis, but no anomalies found. ಠ~ಠ")
    else:
        log.info("Everything looks good! ヽ(‘ー`)ノ")
    return test


def run(test: dict) -> dict:
    """Full lifecycle; returns the test with :history and :results.
    Persistence is 3-phase (save_0 at start, save_1 once the history is
    durable, save_2 after analysis) unless ``store?`` is False.
    (reference: core.clj:327-406 + store.clj:413-456)"""
    from contextlib import nullcontext

    from . import store as store_mod

    test = prepare_test(test)
    storing = test.get("store?", True)

    # observability (obs): default on, per-test opt-out via obs? (the
    # CLI's --no-obs).  Each run resets the process-global
    # tracer+registry so a prior in-process run's spans can't leak into
    # this run's exports.
    observing = bool(test.get("obs?", True))
    if observing:
        obs.enable(reset=True)
    else:
        obs.disable()

    # span tracing turns on for the run — not at test-build time, so
    # building several test maps can't cross-wire each other's
    # exporters through the process-global tracer — and off again
    # after it, so later runs in the same process don't inherit a
    # stale exporter (trace.wire stores the endpoint; the reference
    # configures its tracer once per run, dgraph/core.clj:118)
    tracing_endpoint = test.get("tracing")
    if tracing_endpoint:
        from . import trace

        trace.tracing(tracing_endpoint)

    if storing:
        store_mod.start_logging(test, test.get("logging-json?", False))
    try:
        writer_ctx = (
            store_mod.with_writer(test) if storing else nullcontext(test)
        )
        with writer_ctx as test:
            if storing:
                test = store_mod.save_0(test)
            try:
                test = _run_body(test)
            except BaseException:
                # abort path: the spans recorded up to the crash are the
                # flight recorder's whole point — export them best-effort
                # (like maybe_snarf_logs) without superseding the cause
                if observing:
                    try:
                        _finish_obs(test, storing)
                    except Exception:
                        log.exception("obs export failed on abort")
                raise
            if observing:
                test = _finish_obs(test, storing)
            if storing:
                test = store_mod.save_2(test)
            return log_results(test)
    finally:
        if tracing_endpoint:
            trace.tracing()
        if storing:
            store_mod.stop_logging(test)


def _finish_obs(test: dict, storing: bool) -> dict:
    """Distill the run's spans+metrics: summary dict into
    ``results["obs"]`` (durable via save_2) and ``test["obs-summary"]``
    (for the CLI breakdown table), artifact files (Chrome trace,
    span JSONL, Prometheus dump) into the store directory."""
    from . import store as store_mod

    summary = obs.summary()
    results = test.get("results")
    if isinstance(results, dict):
        test = {**test, "results": {**results, "obs": summary}}
    test = {**test, "obs-summary": summary}
    if storing:
        try:
            paths = obs.export_all(store_mod.test_dir(test))
            log.info("Wrote trace artifacts: %s", sorted(paths.values()))
        except Exception:
            # telemetry must never fail a run that already has results
            # (any export error — full disk, a serialization surprise —
            # would otherwise abort before save_2 writes results.json)
            log.exception("obs export failed")
    return test


def _run_body(test: dict) -> dict:
    """OS/DB setup, the run itself, history save, analysis."""
    from . import db as db_mod
    from . import store as store_mod

    storing = test.get("store?", True)
    db = test.get("db")
    os_ = test.get("os")
    control_ctx = _control_context(test)
    with control_ctx:
        if os_ is not None:
            with obs.span("os-setup", cat="phase"):
                _on_nodes(test, lambda node: os_.setup(test, node))
        if db is not None:
            with obs.span("db-start", cat="phase"):
                db_mod.cycle(test)
        try:
            try:
                with with_relative_time():
                    # anchor span timestamps to the history's t=0 so
                    # exports/overlays can align them with op times
                    obs.set_run_anchor()
                    history = run_case(test)
                test = {**test, "history": history}
                if storing:
                    with obs.span("save-history", cat="phase"):
                        test = store_mod.save_1(test)
                result = analyze(test)
            except BaseException:
                # abort path, before DB teardown deletes the logs; must
                # not supersede the root cause (reference: core.clj:150-170
                # with-log-snarfing)
                maybe_snarf_logs(test)
                raise
            # success path: snarf errors (e.g. unwritable store) propagate
            # rather than silently losing all DB logs — but outside the
            # except above, so they can't trigger a second snarf
            snarf_logs(test)
            return result
        finally:
            if db is not None and not test.get("leave-db-running?"):
                with obs.span("db-teardown", cat="phase"):
                    _on_nodes(test, lambda node: db.teardown(test, node))


def _control_context(test: dict):
    """The remote-session context for this test (dummy by default)."""
    from . import control

    remote = test.get("remote")
    if remote is None:
        return control.dummy_session(test)
    return control.with_session(test, remote)


def _on_nodes(test: dict, fn):
    """Run fn on every node concurrently.
    (reference: control.clj:295-311 on-nodes)"""
    from . import control

    return dict(
        zip(
            test["nodes"],
            real_pmap(
                lambda node: control.with_node(node, lambda: fn(node)), test["nodes"]
            ),
        )
    )
