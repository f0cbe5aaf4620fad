"""The interpreter: executes a generator against real worker threads,
building the history.

(reference: jepsen/src/jepsen/generator/interpreter.clj — Worker protocol
:19-31, ClientWorker re-open logic :33-67, worker thread loop :99-164,
scheduler loop :181-292, crash-to-:info conversion :142-157,
max-pending-interval :166-170.)

One thread per worker (concurrency clients + 1 nemesis) with a
size-1 in-queue each and a shared completion queue; a single scheduler
thread drives the generator, dispatches invocations, applies completions,
and retires crashed processes.

Online checking is opt-in per test map, with no environment switch: a
test carrying a :class:`~jepsen_tpu_torch.serve.client.ServiceClient`
under ``"live-client"`` ships its history to that daemon's ``/feed`` as
it lands (the reference reads ``JEPSEN_TPU_LIVE=1`` and builds a client
of its own).  Nothing here touches CUDA: the workers run the clients and
the nemesis, and the check runs after :func:`run` returns, on the
caller's thread.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Any, Dict, List, Optional

from . import client as client_mod
from . import generator as gen
from . import obs
from .history import History, NEMESIS, Op
from .util import relative_time_nanos

#: Max micros to wait before re-polling a pending generator
#: (reference: interpreter.clj:166-170)
MAX_PENDING_INTERVAL_US = 1000

#: Live shipper: bounded buffer between the scheduler and the shipper
#: thread; a full buffer drops (and counts) rather than blocking the
#: workload (doc/checker-service.md "Online checking")
LIVE_BUFFER_OPS = 4096
#: Live shipper: max events shipped in one ``/feed`` append
LIVE_BATCH_OPS = 64


class _LiveShipper:
    """Ships history events to a daemon feed session as they land.

    Contract with the workload: **never block, never fail.**
    :meth:`offer` is a ``put_nowait`` off the scheduler loop — a full
    buffer or a dead daemon drops events (counted as
    ``jepsen_feed_drops_total``) instead of applying backpressure to op
    timing, and every daemon error is swallowed after counting.  The
    post-hoc checker stays the authority on the verdict either way;
    the feed only buys earlier detection.

    Ships BOTH invocations and completions, in history-append order:
    the daemon's incremental probe needs the real concurrency
    structure, and serializing inv/comp pairs would narrow
    linearization windows into false violations.
    """

    #: consecutive append failures before the shipper gives up for the
    #: rest of the run (the resilient client already retried each one)
    MAX_STRIKES = 3

    def __init__(self, model, client):
        self._q = queue.Queue(maxsize=LIVE_BUFFER_OPS)
        self._closing = threading.Event()
        self._client = client
        self._model = model
        self._session = None
        self._dead = threading.Event()
        self.final_results: Optional[list] = None
        self._thread = threading.Thread(
            target=self._run, name="jepsen-live-shipper", daemon=True
        )
        self._thread.start()

    def offer(self, op: dict) -> None:
        """Enqueue one history event (scheduler thread; never blocks)."""
        if self._dead.is_set() or not isinstance(op.get("process"), int):
            return  # nemesis/system events aren't model operations
        import time as _time

        try:
            self._q.put_nowait((_time.time(), op))
        except queue.Full:
            obs.count("jepsen_feed_drops_total")

    def close(self, wait_s: float = 10.0) -> None:
        """Flush the buffer and close the feed session, bounded in time
        — teardown must not hang on a wedged daemon."""
        self._closing.set()
        self._thread.join(timeout=wait_s)

    # ── shipper thread ────────────────────────────────────────────

    def _drain(self, max_n: int):
        batch = []
        while len(batch) < max_n:
            try:
                batch.append(self._q.get_nowait())
            except queue.Empty:
                break
        return batch

    def _run(self):
        import logging
        import time as _time

        log = logging.getLogger(__name__)
        try:
            self._session = self._client.open_feed(self._model)
        except Exception as e:
            log.info("live feed disabled (no daemon session): %s", e)
            self._dead.set()
            return
        strikes = 0
        while True:
            batch = self._drain(LIVE_BATCH_OPS)
            if not batch:
                if self._closing.is_set():
                    break
                _time.sleep(0.05)
                continue
            t_inv = min(t for t, _ in batch)
            ops = [op for _, op in batch]
            try:
                self._session.append(ops=ops, t_inv=t_inv)
                strikes = 0
            except Exception:
                # the resilient client already retried; this delta is
                # lost to the feed (the post-hoc check still sees it)
                obs.count("jepsen_feed_drops_total", len(ops))
                strikes += 1
                if strikes >= self.MAX_STRIKES:
                    log.info(
                        "live feed gave up after %d failed deltas",
                        strikes)
                    self._dead.set()
                    return
        try:
            self.final_results = self._session.close()
            if self.final_results:
                log.info(
                    "live feed closed: online verdict valid?=%s",
                    self.final_results[-1].get("valid?"))
        except Exception as e:
            log.info("live feed close failed: %s", e)
        finally:
            self._dead.set()


def _live_model(test: dict):
    """The model the live feed probes against: an explicit
    ``test["model"]`` wins, else the checker's (the linearizable
    checker carries one).  None → live shipping stays off."""
    model = test.get("model")
    if model is None:
        model = getattr(test.get("checker"), "model", None)
    return model


def _make_shipper(test: dict) -> Optional[_LiveShipper]:
    """A shipper to ``test["live-client"]``, or None when the test
    carries no client or the model has no wire form."""
    client = test.get("live-client")
    if client is None:
        return None
    model = _live_model(test)
    if model is None:
        return None
    try:
        from .serve import protocol

        protocol.model_to_wire(model)  # no wire form → nothing to feed
    except Exception:
        return None
    return _LiveShipper(model, client)


class ClientWorker:
    """Wraps a client, reopening it when its process changes (unless the
    client is reusable).  (reference: interpreter.clj:33-67)"""

    def __init__(self, node):
        self.node = node
        self.process = None
        self.client: Optional[client_mod.Client] = None

    def invoke(self, test: dict, op: dict) -> dict:
        while True:
            if self.process != op["process"] and not client_mod.is_reusable(
                self.client, test
            ):
                self.close(test)
                try:
                    self.client = client_mod.validate(test["client"]).open(
                        test, self.node
                    )
                    self.process = op["process"]
                except Exception as e:
                    self.client = None
                    return {
                        **op,
                        "type": "fail",
                        "error": ["no-client", str(e)],
                    }
                continue
            return self.client.invoke(test, op)

    def close(self, test: dict) -> None:
        if self.client is not None:
            self.client.close(test)
            self.client = None


class NemesisWorker:
    """(reference: interpreter.clj:69-76)"""

    def invoke(self, test: dict, op: dict) -> dict:
        return test["nemesis"].invoke(test, op)

    def close(self, test: dict) -> None:
        pass


def make_worker(test: dict, worker_id: Any):
    """client for integer ids (round-robin over nodes), nemesis
    otherwise.  (reference: interpreter.clj:80-97)"""
    if isinstance(worker_id, int):
        nodes = test.get("nodes") or [None]
        return ClientWorker(nodes[worker_id % len(nodes)])
    return NemesisWorker()


class _WorkerThread:
    """Thread + queues for one worker.  (reference: interpreter.clj:99-164)"""

    def __init__(self, test: dict, out: "queue.Queue", worker, worker_id):
        self.id = worker_id
        self.inq: "queue.Queue" = queue.Queue(maxsize=1)
        self.test = test
        self.out = out
        self.worker = worker
        self.thread = threading.Thread(
            target=self._run, name=f"jepsen-worker-{worker_id}", daemon=True
        )
        self.thread.start()

    def _run(self):
        test, out, worker = self.test, self.out, self.worker
        # captured once per worker thread: with tracing disabled the
        # hot loop below pays exactly this one pre-paid branch per op
        # (no span objects, no counter lookups — tests/test_obs.py
        # asserts zero records allocated)
        tracing = obs.enabled()
        try:
            while True:
                op = self.inq.get()
                try:
                    t = op.get("type")
                    if t == "exit":
                        return
                    elif t == "sleep":
                        import time as _t

                        _t.sleep(op["value"])
                        out.put(op)
                    elif t == "log":
                        import logging

                        logging.getLogger(__name__).info(op.get("value"))
                        out.put(op)
                    elif tracing:
                        with obs.span(
                            f"op/{op.get('f')}", cat="op"
                        ) as sp:
                            res = worker.invoke(test, op)
                            sp.set("worker", self.id)
                            # guard non-dict results: telemetry must
                            # not change how a buggy client fails
                            t_res = (
                                res.get("type")
                                if isinstance(res, dict) else "?"
                            )
                            sp.set("type", t_res)
                        obs.count_op(t_res)
                        out.put(res)
                    else:
                        out.put(worker.invoke(test, op))
                except Exception as e:
                    # worker crash ⇒ indeterminate op
                    # (reference: interpreter.clj:142-157)
                    if tracing:
                        obs.count_op("info")
                    out.put(
                        {
                            **op,
                            "type": "info",
                            "exception": traceback.format_exc(),
                            "exception_class": type(e).__name__,
                            "error": f"indeterminate: {e}",
                        }
                    )
        finally:
            try:
                worker.close(test)
            except Exception:
                pass


def goes_in_history(op: dict) -> bool:
    """:sleep and :log ops are not journaled.
    (reference: interpreter.clj:172-179)"""
    return op.get("type") not in ("sleep", "log")


def run(test: dict) -> History:
    """Evaluate all ops from test["generator"] against workers driving
    test["client"] / test["nemesis"]; returns the History.
    (reference: interpreter.clj:181-292)"""
    ctx = gen.context(test)
    worker_ids = gen.all_threads(ctx)
    completions: "queue.Queue" = queue.Queue(maxsize=len(worker_ids))
    workers = [
        _WorkerThread(test, completions, make_worker(test, wid), wid)
        for wid in worker_ids
    ]
    invocations: Dict[Any, "queue.Queue"] = {w.id: w.inq for w in workers}
    g = gen.validate(gen.friendly_exceptions(test.get("generator")))

    outstanding = 0
    poll_timeout_us = 0
    history: List[dict] = []
    # online checking: opt-in shipper feeding the checker daemon a
    # live copy of the history (test["live-client"]); never blocks the
    # scheduler, never fails the run
    shipper = _make_shipper(test)

    try:
        while True:
            op_done = None
            if poll_timeout_us > 0:
                try:
                    op_done = completions.get(timeout=poll_timeout_us / 1e6)
                except queue.Empty:
                    op_done = None
            else:
                try:
                    op_done = completions.get_nowait()
                except queue.Empty:
                    op_done = None

            if op_done is not None:
                # completion-first: latency sensitive
                # (reference: interpreter.clj:212-241)
                thread = gen.process_to_thread(ctx, op_done.get("process"))
                now = relative_time_nanos()
                op_done = {**op_done, "time": now}
                ctx = {
                    **ctx,
                    "time": now,
                    "free_threads": tuple(ctx["free_threads"]) + (thread,),
                }
                g = gen.update(g, test, ctx, op_done)
                if thread != NEMESIS and op_done.get("type") == "info":
                    workers_map = dict(ctx["workers"])
                    workers_map[thread] = gen.next_process(ctx, thread)
                    ctx = {**ctx, "workers": workers_map}
                if goes_in_history(op_done):
                    history.append(op_done)
                    if shipper is not None:
                        shipper.offer(op_done)
                outstanding -= 1
                poll_timeout_us = 0
                continue

            now = relative_time_nanos()
            ctx = {**ctx, "time": now}
            res = gen.op(g, test, ctx)

            if res is None:
                if outstanding > 0:
                    poll_timeout_us = MAX_PENDING_INTERVAL_US
                    continue
                for q in invocations.values():
                    q.put({"type": "exit"})
                for w in workers:
                    w.thread.join(timeout=10)
                if shipper is not None:
                    shipper.close()
                return _to_history(history)

            op, g2 = res
            if op == gen.PENDING:
                poll_timeout_us = MAX_PENDING_INTERVAL_US
                continue

            if now < op["time"]:
                # not time yet; sleep until then (or a completion)
                poll_timeout_us = max(1, int((op["time"] - now) / 1000))
                continue

            thread = gen.process_to_thread(ctx, op["process"])
            invocations[thread].put(op)
            ctx = {
                **ctx,
                "time": op["time"],
                "free_threads": tuple(
                    t for t in ctx["free_threads"] if t != thread
                ),
            }
            g2 = gen.update(g2, test, ctx, op)
            if goes_in_history(op):
                history.append(op)
                if shipper is not None:
                    shipper.offer(op)
            g = g2
            outstanding += 1
            poll_timeout_us = 0
    except BaseException:
        # abnormal exit: keep offering exit until each worker drains its
        # in-flight op and accepts it, bounded in time (reference keeps
        # offering through the queue, interpreter.clj:294-309; workers
        # are daemon threads as a last resort)
        import time as _time

        if shipper is not None:
            # bounded; the abort cause below must not wait on a daemon
            shipper.close(wait_s=2.0)
        deadline = _time.monotonic() + 10.0
        pending = list(workers)
        while pending and _time.monotonic() < deadline:
            still = []
            for w in pending:
                if not w.thread.is_alive():
                    continue
                try:
                    w.inq.put_nowait({"type": "exit"})
                except queue.Full:
                    still.append(w)
            pending = still
            if pending:
                _time.sleep(0.01)
        raise


def _to_history(ops: List[dict]) -> History:
    h = History(Op.from_dict(d) for d in ops)
    return h.index_ops()
