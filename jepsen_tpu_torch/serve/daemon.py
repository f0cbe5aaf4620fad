"""The resident checker daemon: one process owns the CUDA device, the
loaded kernel libraries and the oracle worker pool, and many client runs
share them — the port of :mod:`jepsen_tpu.serve.daemon`, with its
``/feed`` sessions, its ``/watch`` verdict channel and its supervisor.

Why: a fresh interpreter pays the CUDA start and every kernel's first
load; a run of many small keyed checks pays a launch per bucket.  A
resident daemon pays the first two once, and merges same-shape buckets
of concurrent runs into shared launches.

- **Request handlers** (one thread per connection, stdlib
  :class:`ThreadingHTTPServer`) do the host half: decode the batch, split
  it (:class:`~jepsen_tpu_torch.engine.decompose.DecomposedRun`) and
  encode each stream into raw shape buckets
  (:meth:`~jepsen_tpu_torch.engine.planning.Planner.encode_buckets`).
  Unencodable histories go to the oracle pool at once.
- **The device thread** owns ONE resident
  :class:`~jepsen_tpu_torch.engine.execution.Executor`, created on that
  thread (the dispatch window is owner-thread confined).  It takes the
  whole queued backlog, groups compatible requests (same wire model and
  options), merges same-(E, C) buckets across them
  (:func:`~jepsen_tpu_torch.engine.planning.merge_buckets`), plans and
  dispatches them, and signals each request when its rows have settled.
  Per-row ``(ctx, idx)`` tokens route every verdict to its own run.
- **Admission** is bounded by queued requests and queued rows; past
  either bound ``/check`` answers 503 and the client decides.
- **Coalescing is backpressure-driven**: a lone request dispatches at
  once; requests arriving while the device is busy merge into the next
  batch.  ``coalesce_wait_s`` adds a bounded gather window.
- **Device faults** answer the requests of the faulting group with an
  error that names the fault, count it in ``/status`` (``device_faults``)
  and reset the executor; the daemon keeps serving.  A fault is never
  routed to the CPU oracle: that would hide a kernel failure behind a
  right answer.

- **Online sessions** (``POST /feed``): a run opens a session and sends
  deltas as it records them, whole histories or raw op events; each
  delta is encoded and dispatched through the device thread the moment
  it arrives and coalesces with concurrent traffic, so a violation
  settles (and reaches the WAL and every ``/watch`` subscriber) near the
  op that caused it.  In op mode every delta checks the whole prefix
  again; partitions that did not change come back from the
  decomposition's ``SubmodelCache``.  A delta that cannot be dispatched
  (refused, or a device fault) commits nothing: the session's run is
  rolled back and a retry of the same ``seq`` dispatches again.
- **The verdict channel** (``GET /watch``): every settled verdict as a
  server-sent event tailing the verdict WAL; an event's ``id:`` is the
  WAL's row offset and ``Last-Event-ID`` resumes right after it.
- **The supervisor** (:func:`supervise`, :func:`supervise_fleet`):
  ``python -m jepsen_tpu_torch.serve --supervise [--fleet N]`` runs the
  daemon (or N of them, on their own ports and WALs) as child processes
  and restarts one that dies.  It holds no device.

``POST /shutdown`` stops admission, lets the device thread finish every
queued request, then stops the server.  ``/status`` carries the daemon's
own kernel launch counters (:func:`kernel_launches`), rows per launch,
cold and coalesced dispatches — what a client in another process cannot
read any other way.  Every knob is an argument (:func:`serve`) or a
flag of ``python -m jepsen_tpu_torch.serve``; nothing is read from the
environment.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from .. import obs, util
from ..engine import decompose, execution, planning
from ..history import History
from ..obs import drift as obs_drift
from ..obs import journal as obs_journal
from ..obs import profiling as obs_profiling
from ..obs import propagate
from . import protocol

#: admission bounds: queued requests and queued rows.  Twice the
#: independent lift's concurrency (``util.bounded_pmap``), so the port's
#: own keyed ``linearizable(algorithm="service")`` fits under the default
#: (the reference's 8 would refuse half of one keyed check)
DEFAULT_MAX_QUEUE_RUNS = 2 * util.DEFAULT_PMAP_LIMIT
DEFAULT_MAX_QUEUE_ROWS = 65536

#: how long a handler waits for the device thread before answering 500
DEFAULT_REQUEST_TIMEOUT_S = 600.0

#: idle-window WAL compaction threshold in bytes (0 disables)
DEFAULT_WAL_COMPACT_BYTES = 32 * 1024 * 1024

#: where ``POST /profile`` writes when the request names no directory
DEFAULT_PROFILE_DIR = "profiles"


def kernel_launches() -> Dict[str, int]:
    """This process's launch counters of the hand-written kernels, by
    wrapper: the dense families (``dense/<family>``), the frontier search,
    the two Elle closures and the verdict counts."""
    from ..ops import cycles, dense, wgl
    from ..parallel import mesh

    out = {f"dense/{fam}": k.launches for fam, k in dense.DENSE_KERNELS.items()}
    out[wgl.FRONTIER_SEARCH.name] = wgl.FRONTIER_SEARCH.launches
    out[cycles.HAS_CYCLE.name] = cycles.HAS_CYCLE.launches
    out[cycles.SCREEN.name] = cycles.SCREEN.launches
    out[mesh.VERDICT_STATS.name] = mesh.VERDICT_STATS.launches
    return out


class _Stream:
    """One planning stream of a request: its tag (``"main"`` or
    ``"sub"``), the representative model and spec that plan it, and its
    raw encoded buckets."""

    __slots__ = ("tag", "model", "spec", "buckets", "order")

    def __init__(self, tag, model, spec, buckets, order):
        self.tag = tag
        self.model = model
        self.spec = spec
        self.buckets = buckets
        self.order = order


class _NoOracles:
    """The oracle interface of a request that submits none (``/elle``)."""

    def abandon_oracles(self) -> int:
        return 0


class _ElleRequest:
    """One admitted ``/elle`` batch: encoded graphs whose (vertex bucket,
    filter profile) buckets coalesce across requests."""

    kind = "elle"

    def __init__(self, graphs, trace_id: Optional[str] = None):
        self.graphs = graphs
        self.rows = self.n = len(graphs)
        self.t_admitted = time.perf_counter()
        self.device_done = threading.Event()
        self.error: Optional[str] = None
        self.diag: dict = {}
        self.abandoned = False
        self.results: Optional[list] = None
        self.run = _NoOracles()
        self.trace_id = trace_id


class _Request:
    """One admitted ``/check`` batch between a handler thread and the
    device thread.  The handler writes it before the queue put; the
    device thread's results are read after ``device_done`` (the event is
    the happens-before edge).  ``run`` holds the result slots, the
    oracle hand-off and the partition merge."""

    kind = "check"

    def __init__(self, run, streams, group_key, plan_opts, exec_opts, n,
                 trace_id: Optional[str] = None):
        self.run = run
        self.streams = streams
        #: rows queued for the device (decomposition multiplies them)
        self.rows = sum(len(ctx.histories) for _t, ctx in run.streams())
        self.group_key = group_key
        self.plan_opts = plan_opts
        self.exec_opts = exec_opts
        self.n = n
        self.t_admitted = time.perf_counter()
        self.device_done = threading.Event()
        self.error: Optional[str] = None
        self.diag: dict = {}
        #: the handler gave up: the device thread skips the request and
        #: cancels its oracle work
        self.abandoned = False
        self.trace_id = trace_id
        #: slots pre-filled from the verdict WAL
        self.replayed = 0


class _FeedDelta(_Request):
    """One admitted ``/feed`` delta: a :class:`_Request` whose streams
    carry only the rows the delta created, and whose ``rows`` the caller
    sets to them (the row bound counts the delta, not the session).  Its
    ``kind`` keeps feed traffic out of the ``/check`` counters."""

    kind = "feed"


class _FeedSession:
    """One open ``/feed`` session: its run grows by
    ``DecomposedRun.extend`` per delta, one delta at a time (``lock``)."""

    def __init__(self, sid, run, plan_opts, exec_opts, group_key, trace_id,
                 prior):
        self.sid = sid
        self.run = run
        self.plan_opts = plan_opts
        self.exec_opts = exec_opts
        self.group_key = group_key
        self.trace_id = trace_id
        self.lock = threading.Lock()
        #: the highest ingested delta ``seq``: a retried append at or
        #: below it is acknowledged without being ingested again
        self.last_seq = -1
        #: op mode: the raw event dicts in shipped order
        self.ops: List[dict] = []
        #: run indices of the client's whole histories, in feed order
        self.history_idx: List[int] = []
        #: run index of the latest op-prefix probe
        self.probe_idx: Optional[int] = None
        #: verdicts an earlier daemon life settled under this session id,
        #: replayed into each delta's fresh slots
        self.prior = prior
        #: set when a delta timed out with the device thread still
        #: holding its rows: the session cannot take another delta
        self.broken: Optional[str] = None


class AdmissionState:
    """Everything a request touches before the device thread owns it:
    the bounded queue and row budget, the retry cache, the open feed
    sessions, the ``/watch`` subscriber count, the counters and the stop
    flag, behind one condition (which is also the device thread's
    wake-up)."""

    def __init__(self, max_queue_runs: int, max_queue_rows: int):
        self.max_queue_runs = max_queue_runs
        self.max_queue_rows = max_queue_rows
        self._wake = threading.Condition()
        self._stopping = threading.Event()
        self._queue: list = []
        self._queued_rows = 0
        self._in_flight = 0
        self.stats = {
            "requests": 0, "histories": 0, "rejected": 0,
            "coalesced": 0, "coalesced_dispatches": 0, "batches": 0,
            "warm_dispatches": 0, "cold_dispatches": 0, "errors": 0,
            "device_faults": 0, "elle_requests": 0, "elle_graphs": 0,
            "replayed": 0, "deduped": 0, "wal_compactions": 0,
            "feed_sessions": 0, "feed_deltas": 0, "feed_histories": 0,
            "watch_events": 0,
        }
        #: open feed sessions by session id
        self._feeds: Dict[str, _FeedSession] = {}
        #: live ``/watch`` subscribers
        self._watchers = 0
        #: live rows the executor dispatched, by kernel
        self.dispatch_rows: Dict[str, int] = {}
        #: completed responses by request id: a retry of an answered
        #: request is served from here, never counted twice
        self._done: "OrderedDict[str, Tuple[int, dict]]" = OrderedDict()
        self._done_cap = 128

    def precheck(self, n_rows: int) -> bool:
        """A cheap capacity check before the host half, so a request that
        will be refused pays no encode (``admit`` decides for real)."""
        with self._wake:
            return not (self._stopping.is_set()
                        or len(self._queue) >= self.max_queue_runs
                        or self._queued_rows + n_rows > self.max_queue_rows)

    def admit(self, req) -> bool:
        with self._wake:
            if self._stopping.is_set():
                return False
            if (len(self._queue) >= self.max_queue_runs
                    or self._queued_rows + req.rows > self.max_queue_rows):
                self.stats["rejected"] += 1
                obs.count("jepsen_serve_rejected_total")
                return False
            self._queue.append(req)
            self._queued_rows += req.rows
            if req.kind == "elle":
                self.stats["elle_requests"] += 1
                self.stats["elle_graphs"] += req.n
                obs.count("jepsen_serve_elle_requests_total")
                obs.count("jepsen_serve_elle_graphs_total", req.n)
            elif req.kind == "feed":
                pass  # counted under jepsen_feed_* once ingested
            else:
                self.stats["requests"] += 1
                self.stats["histories"] += req.n
                obs.count("jepsen_serve_requests_total")
                obs.count("jepsen_serve_histories_total", req.n)
            obs.gauge_set("jepsen_serve_queue_depth", len(self._queue))
            self._wake.notify()
            return True

    def backlogged(self, count: bool = False) -> dict:
        """The 503 body; ``count`` counts the refusal (``admit`` counts
        its own)."""
        with self._wake:
            if count:
                self.stats["rejected"] += 1
            depth = len(self._queue)
        if count:
            obs.count("jepsen_serve_rejected_total")
        return {"error": "backlogged", "queue_depth": depth,
                "stopping": self._stopping.is_set()}

    def take_batch(self, coalesce_wait_s: float) -> list:
        """Pop the whole backlog (the coalescing unit), waiting up to
        ``coalesce_wait_s`` after the first arrival for company.  Returns
        [] after about a second with nothing queued (a housekeeping
        turn) or once stopping with the queue empty."""
        with self._wake:
            idle_waits = 0
            while not self._queue:
                if self._stopping.is_set():
                    return []
                self._wake.wait(timeout=0.2)
                idle_waits += 1
                if not self._queue and idle_waits >= 5:
                    return []
            if coalesce_wait_s > 0:
                deadline = time.monotonic() + coalesce_wait_s
                while (len(self._queue) < self.max_queue_runs
                       and not self._stopping.is_set()):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._wake.wait(timeout=remaining)
            batch, self._queue = self._queue, []
            self._queued_rows = 0
            self._in_flight = len(batch)
            obs.gauge_set("jepsen_serve_queue_depth", 0)
            return batch

    def drain_queue(self) -> list:
        with self._wake:
            queued, self._queue = self._queue, []
            self._queued_rows = 0
            return queued

    def bump(self, **deltas) -> None:
        with self._wake:
            for k, v in deltas.items():
                self.stats[k] += v

    def dedup_hit(self, req_id) -> Optional[Tuple[int, dict]]:
        if not req_id:
            return None
        with self._wake:
            hit = self._done.get(req_id)
            if hit is None:
                return None
            self._done.move_to_end(req_id)
            self.stats["deduped"] += 1
        obs.count("jepsen_serve_request_dedup_total")
        return hit

    def dedup_store(self, req_id, code: int, payload: dict) -> None:
        if not req_id or code != 200:
            return  # a failure is retried for real
        with self._wake:
            self._done[req_id] = (code, payload)
            self._done.move_to_end(req_id)
            while len(self._done) > self._done_cap:
                self._done.popitem(last=False)

    def watchers(self, delta: int) -> None:
        """A ``/watch`` subscriber came (+1) or went (-1)."""
        with self._wake:
            self._watchers += delta
            n = self._watchers
        obs.gauge_set("jepsen_watch_subscribers", n)


class CheckerDaemon:
    """The resident service.  ``start(block=False)`` returns once the
    device thread is ready (``port`` then holds the bound port, useful
    with ``port=0``) and raises when the device could not be set up.
    ``device`` is None for the current CUDA device (probed with
    :func:`jepsen_tpu_torch.platform.ensure_usable_backend` first, never
    falling back to the CPU), or a device such as ``"cpu"``."""

    def __init__(
        self,
        host: str = protocol.DEFAULT_HOST,
        port: int = protocol.DEFAULT_PORT,
        *,
        device=None,
        window: Optional[int] = None,
        max_queue_runs: Optional[int] = None,
        max_queue_rows: Optional[int] = None,
        coalesce_wait_s: float = 0.0,
        request_timeout_s: float = DEFAULT_REQUEST_TIMEOUT_S,
        journal_path: Optional[str] = None,
        wal_path: Optional[str] = None,
        wal_compact_bytes: int = DEFAULT_WAL_COMPACT_BYTES,
        drift: bool = True,
        drift_threshold: Optional[float] = None,
        decomposed: bool = True,
    ):
        self.host = host
        self.port = port
        self.window = window
        self._device_arg = device
        #: the resolved device, set by the device thread before ready
        self.device = None
        # `is None`, not truthiness: max_queue_runs=0 refuses all work
        self.admission = AdmissionState(
            DEFAULT_MAX_QUEUE_RUNS if max_queue_runs is None
            else max_queue_runs,
            DEFAULT_MAX_QUEUE_ROWS if max_queue_rows is None
            else max_queue_rows)
        self.coalesce_wait_s = coalesce_wait_s
        self.request_timeout_s = request_timeout_s
        #: dispatch journal (off unless given), and the drift sentinel
        #: riding it
        self.journal_path = journal_path
        self.drift = drift
        self.drift_threshold = drift_threshold
        #: split partitionable histories per key / lock before planning
        #: (``check_batch``'s ``decomposed=``, for every request)
        self.decomposed = decomposed
        #: verdict WAL (off unless given); on start its rows become the
        #: replay index of retried request ids
        self.wal_path = wal_path
        self._wal: Optional[obs_journal.VerdictWAL] = None
        self._wal_replay: Dict[str, dict] = {}
        self.wal_compact_bytes = wal_compact_bytes
        self.t_start = time.time()
        self._server: Optional[ThreadingHTTPServer] = None
        self._device_thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._platform: Optional[str] = None
        self._fatal: Optional[str] = None
        self._n_devices: Optional[int] = None
        self._executor = None

    @property
    def stats(self) -> dict:
        return self.admission.stats

    # -- the device thread ---------------------------------------------------

    def _device_loop(self) -> None:
        """The execution half: owns the device and the dispatch window
        for the daemon's whole life."""
        try:
            import torch

            from .. import device as device_mod
            from ..platform import ensure_usable_backend

            dev = self._device_arg
            if dev is None or torch.device(dev).type == "cuda":
                ensure_usable_backend()
            device = device_mod.resolve(dev)
            if device.type == "cuda":
                torch.cuda.set_device(device)
            # created here: the dispatch window is confined to this thread
            executor = execution.Executor(self.window, device=device)
            # published to handler threads by `_ready.set()`
            self.device = executor.device
            self._platform = "gpu" if executor.device.type == "cuda" \
                else "cpu"
            self._n_devices = executor.n_devices
            self._executor = executor
        except Exception as e:  # noqa: BLE001 — reported by start()
            self._fatal = repr(e)
            self._ready.set()
            self._fail_all_queued()
            return
        self._ready.set()
        while True:
            batch = self.admission.take_batch(self.coalesce_wait_s)
            if not batch:
                if self.admission._stopping.is_set():
                    return  # drained: every admitted request settled
                self._maybe_compact_wal()
                continue
            try:
                self._process_batch(executor, batch)
            except Exception as e:  # noqa: BLE001 — one bad batch must
                # not kill the daemon: its unsettled requests answer 500
                executor.reset()
                self._fail(batch, f"batch failed: {e!r}")
            with self.admission._wake:
                self.admission._in_flight = 0

    def _fail(self, reqs, error: str) -> int:
        """Answer every unsettled request of ``reqs`` with ``error``."""
        n = 0
        for req in reqs:
            if not req.device_done.is_set():
                req.error = error
                req.run.abandon_oracles()
                req.device_done.set()
                n += 1
        self.admission.bump(errors=n)
        return n

    def _device_fault(self, executor, reqs, e: Exception) -> None:
        """A dispatch of ``reqs`` raised: answer them with the fault,
        count it, and leave the executor clean for the next group."""
        executor.reset()
        self.admission.bump(device_faults=1)
        obs.count("jepsen_serve_device_faults_total")
        self._fail(reqs, f"device fault: {e!r}")

    def _maybe_compact_wal(self) -> None:
        """Idle-turn WAL compaction past :attr:`wal_compact_bytes`: keep
        the rows of the request ids the retry cache still answers and of
        every open feed session."""
        wal = self._wal
        if wal is None or self.wal_compact_bytes <= 0:
            return
        try:
            if os.path.getsize(wal.path) <= self.wal_compact_bytes:
                return
        except OSError:
            return
        with self.admission._wake:
            keep = set(self.admission._done) | set(self.admission._feeds)
        wal.compact(keep_reqs=keep)
        self.admission.bump(wal_compactions=1)
        obs.count("jepsen_serve_wal_compactions_total")

    def _fail_all_queued(self) -> None:
        for req in self.admission.drain_queue():
            req.error = f"device thread failed: {self._fatal}"
            req.device_done.set()

    def _process_batch(self, executor, batch: list) -> None:
        """Group compatible requests, merge same-shape buckets across
        each group, dispatch the groups largest estimated cost first."""
        self.admission.bump(batches=1)
        groups: Dict[Tuple, List[_Request]] = {}
        elle_reqs: List[_ElleRequest] = []
        for req in batch:
            if req.abandoned:
                req.run.abandon_oracles()
                continue
            if isinstance(req, _ElleRequest):
                elle_reqs.append(req)
            else:
                groups.setdefault(req.group_key, []).append(req)
        attrs = {"requests": len(batch),
                 "groups": len(groups) + bool(elle_reqs)}
        ids = ",".join(sorted({r.trace_id for r in batch if r.trace_id}))
        if ids:
            attrs[propagate.ATTR_TRACE_IDS] = ids
        with obs.span("serve/batch", cat="serve", **attrs):
            if elle_reqs:
                try:
                    self._process_elle(executor, elle_reqs)
                except Exception as e:  # noqa: BLE001 — answered, counted
                    self._device_fault(executor, elle_reqs, e)
                for req in elle_reqs:
                    req.device_done.set()
            planned = {}
            for gkey, reqs in groups.items():
                try:
                    planned[gkey] = self._plan_group(executor, reqs)
                except Exception as e:  # noqa: BLE001 — answered, counted
                    self._device_fault(executor, reqs, e)
            order = sorted(
                planned,
                key=lambda k: sum(planning.estimated_cost(pb)
                                  for pb in planned[k][0]),
                reverse=True)
            for gkey in order:
                reqs = groups[gkey]
                try:
                    self._dispatch_group(executor, reqs, *planned[gkey])
                except Exception as e:  # noqa: BLE001 — answered, counted
                    self._device_fault(executor, reqs, e)
                for req in reqs:
                    if req.abandoned:
                        req.run.abandon_oracles()
                    req.device_done.set()

    def _process_elle(self, executor, reqs: List[_ElleRequest]) -> None:
        """The Elle arm of a batch: every queued request's graphs screen
        through one ``screen_graphs`` pass on the resident executor, so
        same-(bucket, profile) graphs share dispatches."""
        from ..ops import cycles as ops_cycles

        if len(reqs) > 1:
            obs.count("jepsen_serve_elle_coalesced_total", len(reqs))
        for req in reqs:
            obs.observe("jepsen_serve_queue_wait_seconds",
                        time.perf_counter() - req.t_admitted)
        attrs = {"graphs": sum(r.n for r in reqs)}
        ids = ",".join(sorted({r.trace_id for r in reqs if r.trace_id}))
        if ids:
            attrs[propagate.ATTR_TRACE_IDS] = ids
        executor.journal_context = {"coalesced": len(reqs), "trace_id": ids}
        encs = [g for req in reqs for g in req.graphs]
        pc0 = dict(executor.phase_counts)
        with obs.span("serve/screen", cat="serve", **attrs):
            results = ops_cycles.screen_graphs(encs, executor=executor)
        self._count_phases(executor, pc0)
        lo = 0
        for req in reqs:
            req.results = results[lo:lo + req.n]
            req.diag = {
                "coalesced_with": len(reqs) - 1,
                "graphs": req.n,
                "queue_wait_s": round(time.perf_counter() - req.t_admitted,
                                      4),
            }
            lo += req.n

    def _plan_group(self, executor, reqs: List[_Request]):
        """Merge a compatible group's buckets per stream tag (only
        same-spec buckets stack) and plan each merged bucket."""
        first = reqs[0]
        tags: List[str] = []
        for req in reqs:
            for st in req.streams:
                if st.tag not in tags:
                    tags.append(st.tag)
        planned = []
        n_buckets = 0
        for tag in tags:
            streams = [st for req in reqs for st in req.streams
                       if st.tag == tag]
            rep = streams[0]
            planner = planning.Planner(
                rep.model, spec=rep.spec, device=executor.device,
                n_devices=executor.n_devices, bucketed=True,
                **first.plan_opts)
            merged, order = planning.merge_buckets(
                (st.buckets, st.order) for st in streams)
            n_buckets += len(order)
            for key in order:
                pb = planner.plan_rows(key, *merged[key])
                if pb is not None:
                    planned.append(pb)
        return planned, n_buckets

    def _count_phases(self, executor, pc0: dict) -> Tuple[int, int]:
        warm = executor.phase_counts["execute"] - pc0["execute"]
        cold = executor.phase_counts["compile"] - pc0["compile"]
        if warm:
            obs.count("jepsen_serve_warm_hits_total", warm)
        self.admission.bump(warm_dispatches=warm, cold_dispatches=cold)
        return warm, cold

    def _dispatch_group(self, executor, reqs: List[_Request],
                        planned: list, n_buckets: int) -> None:
        first = reqs[0]
        for req in reqs:
            obs.observe("jepsen_serve_queue_wait_seconds",
                        time.perf_counter() - req.t_admitted)
        if len(reqs) > 1:
            self.admission.bump(coalesced=len(reqs))
            obs.count("jepsen_serve_coalesced_requests_total", len(reqs))
        # the resident executor adopts the group's execution policy;
        # groups run one after another with a drain between
        executor.escalation = first.exec_opts["escalation"]
        executor.sufficient_rung = first.exec_opts["sufficient_rung"]
        executor.max_dispatch = first.exec_opts["max_dispatch"]
        ids = ",".join(sorted({r.trace_id for r in reqs if r.trace_id}))
        executor.journal_context = {"coalesced": len(reqs), "trace_id": ids}
        attrs = {"requests": len(reqs), "buckets": n_buckets}
        if ids:
            attrs[propagate.ATTR_TRACE_IDS] = ids
        owner = {id(ctx): i for i, req in enumerate(reqs)
                 for ctx in req.run.contexts}
        pc0 = dict(executor.phase_counts)
        coalesced_chunks = 0
        rows: Dict[str, int] = {}
        planned.sort(key=planning.estimated_cost, reverse=True)
        with obs.span("serve/dispatch", cat="serve", **attrs):
            for pb in planned:
                s0 = executor.submitted
                executor.submit(pb)
                n_chunks = executor.submitted - s0
                if n_chunks:
                    rows[pb.plan.kernel] = (rows.get(pb.plan.kernel, 0)
                                            + len(pb.rows))
                if len({owner.get(id(tok[0])) for tok in pb.rows}) > 1:
                    coalesced_chunks += n_chunks
            executor.drain()
        warm, cold = self._count_phases(executor, pc0)
        with self.admission._wake:
            self.stats["coalesced_dispatches"] += coalesced_chunks
            for k, v in rows.items():
                self.admission.dispatch_rows[k] = \
                    self.admission.dispatch_rows.get(k, 0) + v
        if coalesced_chunks:
            obs.count("jepsen_serve_coalesced_dispatches_total",
                      coalesced_chunks)
        for req in reqs:
            req.diag = {
                "coalesced_with": len(reqs) - 1,
                "warm_dispatches": warm,
                "cold_dispatches": cold,
                "coalesced_dispatches": coalesced_chunks,
                "queue_wait_s": round(time.perf_counter() - req.t_admitted,
                                      4),
                "buckets": n_buckets,
                "partitions": req.run.n_partitions,
            }

    # -- status ----------------------------------------------------------------

    def status(self) -> dict:
        from .. import tune
        from ..ops import wgl

        adm = self.admission
        with adm._wake:
            stats = dict(adm.stats)
            rows = dict(adm.dispatch_rows)
            depth = len(adm._queue)
            in_flight = adm._in_flight
            feed_open = len(adm._feeds)
            watchers = adm._watchers
        total = stats["warm_dispatches"] + stats["cold_dispatches"]
        launches = kernel_launches()
        dense_launches = sum(v for k, v in launches.items()
                             if k.startswith("dense/"))
        per_kernel = {"dense": dense_launches,
                      "frontier": launches["frontier_search"],
                      "cycles": (launches["cycles_has_cycle"]
                                 + launches["cycles_screen"])}
        rows_per_launch = {k: round(rows[k] / per_kernel[k], 4)
                           for k in rows if per_kernel.get(k)}
        cal = tune.active()
        reg = obs.registry()
        busy_s = (reg.window_seconds_sum("jepsen_kernel_compile_seconds")
                  + reg.window_seconds_sum("jepsen_kernel_execute_seconds"))
        qw_mean = reg.window_mean("jepsen_serve_queue_wait_seconds")
        lag_mean = reg.window_mean("jepsen_feed_ingest_lag_seconds")
        live = {
            "requests_per_s": round(
                reg.window_rate("jepsen_serve_requests_total"), 4),
            "histories_per_s": round(
                reg.window_rate("jepsen_serve_histories_total"), 4),
            "elle_graphs_per_s": round(
                reg.window_rate("jepsen_serve_elle_graphs_total"), 4),
            "dispatches_per_s": round(
                reg.window_rate("jepsen_kernel_dispatches_total"), 4),
            "queue_wait_mean_s": (round(qw_mean, 4)
                                  if qw_mean is not None else None),
            "device_busy_ratio": round(min(1.0, busy_s / 60.0), 4),
            "feed_deltas_per_s": round(
                reg.window_rate("jepsen_feed_deltas_total"), 4),
            "watch_events_per_s": round(
                reg.window_rate("jepsen_watch_events_total"), 4),
            "feed_lag_mean_s": (round(lag_mean, 4)
                                if lag_mean is not None else None),
        }
        journal = obs_journal.active()
        sentinel = obs_drift.active()
        return {
            "calibration": cal.calibration_id if cal is not None else None,
            "ok": self._fatal is None,
            "error": self._fatal,
            "pid": os.getpid(),
            "platform": self._platform,
            "device": str(self.device) if self.device is not None else None,
            "uptime_s": round(time.time() - self.t_start, 1),
            "window": execution.default_window(self.window),
            "n_devices": self._n_devices,
            "queue_depth": depth,
            "in_flight": in_flight,
            "max_queue_runs": adm.max_queue_runs,
            "max_queue_rows": adm.max_queue_rows,
            "stopping": adm._stopping.is_set(),
            "warm_hit_ratio": (round(stats["warm_dispatches"] / total, 4)
                               if total else None),
            # the daemon's own kernel counters: launches per wrapper and
            # live rows per launch by kernel
            "kernel_launches": launches,
            # rows each frontier escalation rung re-ran, by capacity
            "escalations": dict(wgl.ESCALATIONS),
            "dispatch_rows": rows,
            "rows_per_launch": rows_per_launch,
            "journal_path": journal.path if journal else None,
            "journal_rows": journal.written if journal else 0,
            "drift": sentinel.snapshot() if sentinel is not None else None,
            "wal_path": self._wal.path if self._wal else None,
            "wal_rows": self._wal.written if self._wal else 0,
            # the online monitor: open feed sessions, /watch subscribers
            "feed_open": feed_open,
            "watch_subscribers": watchers,
            "live": live,
            **stats,
        }

    def trace_dump(self, trace_id: str) -> dict:
        """``GET /trace?ctx=``: this daemon's finished spans of one trace
        and the clock metadata :func:`..obs.propagate.adopt` needs."""
        t = obs.tracer()
        spans = [d for d in (rec.to_dict() for rec in t.finished())
                 if propagate.span_matches(d, trace_id)]
        return {"spans": spans, "pid": os.getpid(),
                "wall_origin": t.wall_origin, "origin_ns": t.origin_ns}

    # -- lifecycle ----------------------------------------------------------------

    def start(self, block: bool = True) -> "CheckerDaemon":
        obs.enable()  # the live /metrics needs the registry recording
        if self.journal_path:
            obs_journal.configure(self.journal_path)
            if self.drift:
                # a restarted daemon rescores the rows it journalled
                obs_drift.configure(self.drift_threshold).scan(
                    self.journal_path)
        if self.wal_path:
            # the replay index first, then the writer (which seals a torn
            # tail)
            self._wal_replay = obs_journal.replay_index(self.wal_path)
            self._wal = obs_journal.VerdictWAL(self.wal_path)
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           _make_handler(self))
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._device_thread = threading.Thread(
            target=self._device_loop, name="jepsen-serve-device",
            daemon=True)
        self._device_thread.start()
        self._ready.wait()
        if self._fatal is not None:
            self._server.server_close()
            raise RuntimeError(f"checker daemon could not start: "
                               f"{self._fatal}")
        if block:
            print(f"jepsen_tpu_torch checker service on "
                  f"http://{self.host}:{self.port}/ (pid {os.getpid()}, "
                  f"device {self.device})", flush=True)
            try:
                self._server.serve_forever()
            finally:
                self.stop()
        else:
            threading.Thread(target=self._server.serve_forever,
                             daemon=True).start()
        return self

    def request_shutdown(self) -> dict:
        """Stop admitting, let the device thread drain, then stop the
        server from a helper thread (the calling handler still has to
        write its response)."""
        adm = self.admission
        with adm._wake:
            already = adm._stopping.is_set()
            adm._stopping.set()
            draining = len(adm._queue)
            adm._wake.notify_all()
        if not already:
            threading.Thread(target=self._finish_stop, daemon=True).start()
        return {"ok": True, "draining": draining}

    def _finish_stop(self) -> None:
        if self._device_thread is not None:
            self._device_thread.join(timeout=self.request_timeout_s)
        time.sleep(0.05)  # let in-flight handlers finish writing
        if self._server is not None:
            self._server.shutdown()

    def stop(self) -> None:
        """Synchronous teardown: drain, stop, join."""
        self.request_shutdown()
        if self._device_thread is not None:
            self._device_thread.join(timeout=30)
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()

    # -- handlers ------------------------------------------------------------------

    def handle_profile(self, body: bytes) -> Tuple[int, dict]:
        """``POST /profile``: one bounded ``torch.profiler`` window on the
        serving process; the traffic in flight is what gets profiled."""
        try:
            req = protocol.decode_body(body) if body else {}
        except Exception as e:  # noqa: BLE001 — malformed input
            return 400, {"error": f"bad request: {e!r}"}
        if not isinstance(req, dict):
            return 400, {"error": "bad request: body must be an object"}
        try:
            seconds = float(req.get("seconds", 1.0))
        except (TypeError, ValueError):
            return 400, {"error": "bad request: seconds must be a number"}
        label = str(req.get("label") or "")
        out_dir = req.get("dir")
        if not out_dir:
            stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
            out_dir = os.path.join(DEFAULT_PROFILE_DIR,
                                   f"{stamp}-{label}" if label else stamp)
        try:
            manifest = obs_profiling.capture(out_dir, seconds=seconds,
                                             label=label, device=self.device)
        except Exception as e:  # noqa: BLE001 — capture is best-effort
            return 500, {"error": f"profile capture failed: {e!r}"}
        return 200, {"ok": True, "dir": out_dir, "manifest": manifest}

    def handle_check(self, body: bytes) -> Tuple[int, dict]:
        if self._fatal is not None:
            return 500, {"error": f"device thread failed: {self._fatal}"}
        try:
            payload = protocol.decode_body(body)
            model = protocol.model_from_wire(payload["model"])
            histories = protocol.histories_from_wire(payload["histories"])
            opts = payload.get("opts") or {}
        except Exception as e:  # noqa: BLE001 — malformed input
            return 400, {"error": f"bad request: {e!r}"}
        ctx = propagate.parse_ctx(payload.get("trace_ctx"))
        attrs = {"histories": len(histories)}
        if ctx:
            attrs[propagate.ATTR_TRACE_ID] = ctx["trace_id"]
            attrs[propagate.ATTR_ROLE] = "daemon"
            attrs["parent_sid"] = ctx["parent_sid"]
        with obs.span("serve/check", cat="serve", **attrs):
            return self._check_flow(payload, model, histories, opts,
                                    ctx["trace_id"] if ctx else None)

    @staticmethod
    def _check_opts(wire_model: dict, opts: dict):
        """A request's planning and execution options and its compatible
        group key: requests share dispatches only when the model and
        every option agree."""
        from ..ops import encode as encode_mod
        from ..ops import wgl

        plan_opts = {
            "slot_cap": opts.get("slot_cap", encode_mod.DEFAULT_SLOT_CAP),
            "frontier": opts.get("frontier", wgl.DEFAULT_FRONTIER),
            "max_closure": opts.get("max_closure"),
            "max_dispatch": opts.get("max_dispatch",
                                     wgl.DEFAULT_MAX_DISPATCH),
        }
        esc = opts.get("escalation")
        exec_opts = {
            "escalation": (wgl.ESCALATION_FACTORS if esc is None
                           else tuple(esc)),
            "sufficient_rung": bool(opts.get("sufficient_rung", True)),
            "max_dispatch": plan_opts["max_dispatch"],
        }
        group_key = (
            json.dumps(wire_model, sort_keys=True, default=repr),
            json.dumps(plan_opts, sort_keys=True),
            json.dumps({**exec_opts,
                        "escalation": list(exec_opts["escalation"])},
                       sort_keys=True),
        )
        return plan_opts, exec_opts, group_key

    def _check_flow(self, payload, model, histories, opts,
                    trace_id: Optional[str]) -> Tuple[int, dict]:
        adm = self.admission
        #: the client's idempotency key, and the WAL run id
        req_id = payload.get("req")
        cached = adm.dedup_hit(req_id)
        if cached is not None:
            return cached
        if not adm.precheck(len(histories)):
            return 503, adm.backlogged(count=True)
        plan_opts, exec_opts, group_key = self._check_opts(payload["model"],
                                                           opts)
        run = decompose.DecomposedRun(
            model, histories,
            oracle_fallback=bool(opts.get("oracle_fallback", True)),
            enabled=self.decomposed)
        replayed = 0
        if self._wal is not None:
            run.attach_wal(self._wal.sink_for(req_id
                                              or protocol.request_id()))
            prior = self._wal_replay.get(req_id) if req_id else None
            if prior:
                replayed = run.replay(prior)
                if replayed:
                    adm.bump(replayed=replayed)
                    obs.count("jepsen_serve_wal_replayed_total", replayed)
        streams = []
        with obs.span("serve/plan", cat="serve", histories=len(histories)):
            for tag, sctx in run.streams():
                planner = planning.Planner(
                    sctx.model, spec=sctx.spec, device=self.device,
                    bucketed=True, **plan_opts)
                buckets, order = planner.encode_buckets(sctx)
                streams.append(_Stream(tag, sctx.model, sctx.spec, buckets,
                                       order))
        req = _Request(run, streams, group_key, plan_opts, exec_opts,
                       len(histories), trace_id=trace_id)
        req.replayed = replayed
        if not adm.admit(req):
            req.abandoned = True
            run.abandon_oracles()
            return 503, adm.backlogged()
        if not req.device_done.wait(self.request_timeout_s):
            # the device thread owns the run now: it cancels the oracle
            # work when it sees the flag
            req.abandoned = True
            return 500, {"error": "device thread timed out"}
        if req.error is not None:
            return 500, {"error": req.error}
        run.drain_oracles()
        diag = dict(req.diag)
        diag["replayed"] = req.replayed
        diag["settled"] = run.settled_count()
        body = {"results": protocol.sanitize_results(run.results()),
                "diag": diag}
        adm.dedup_store(req_id, 200, body)
        return 200, body

    def handle_elle(self, body: bytes) -> Tuple[int, dict]:
        """Screen a batch of encoded dependency graphs on the resident
        executor (see :meth:`_process_elle`)."""
        if self._fatal is not None:
            return 500, {"error": f"device thread failed: {self._fatal}"}
        try:
            payload = protocol.decode_body(body)
            graphs = protocol.elle_graphs_from_wire(payload["graphs"])
        except Exception as e:  # noqa: BLE001 — malformed input
            return 400, {"error": f"bad request: {e!r}"}
        ctx = propagate.parse_ctx(payload.get("trace_ctx"))
        attrs = {"graphs": len(graphs)}
        if ctx:
            attrs[propagate.ATTR_TRACE_ID] = ctx["trace_id"]
            attrs[propagate.ATTR_ROLE] = "daemon"
            attrs["parent_sid"] = ctx["parent_sid"]
        with obs.span("serve/elle", cat="serve", **attrs):
            return self._elle_flow(graphs, ctx["trace_id"] if ctx else None,
                                   payload.get("req"))

    def _elle_flow(self, graphs, trace_id: Optional[str],
                   req_id: Optional[str]) -> Tuple[int, dict]:
        adm = self.admission
        cached = adm.dedup_hit(req_id)
        if cached is not None:
            return cached
        req = _ElleRequest(graphs, trace_id=trace_id)
        if not adm.admit(req):
            return 503, adm.backlogged()
        if not req.device_done.wait(self.request_timeout_s):
            req.abandoned = True
            return 500, {"error": "device thread timed out"}
        if req.error is not None:
            return 500, {"error": req.error}
        body = {"results": protocol.elle_results_to_wire(req.results or []),
                "diag": req.diag}
        adm.dedup_store(req_id, 200, body)
        return 200, body

    # -- the /feed entry (handler threads) -----------------------------------

    def handle_feed(self, body: bytes) -> Tuple[int, dict]:
        """Online checking: ``open`` a session, ``append`` deltas (whole
        histories and/or raw op events), ``close`` for the merged
        results.  Every delta is dispatched through the device thread
        the moment it arrives."""
        if self._fatal is not None:
            return 500, {"error": f"device thread failed: {self._fatal}"}
        try:
            payload = protocol.decode_body(body)
            fop = payload.get("op")
        except Exception as e:  # noqa: BLE001 — malformed input
            return 400, {"error": f"bad request: {e!r}"}
        with obs.span("serve/feed", cat="serve", op=str(fop)):
            if fop == "open":
                return self._feed_open(payload)
            if fop == "append":
                return self._feed_append(payload)
            if fop == "close":
                return self._feed_close(payload)
            return 400, {"error": f"unknown feed op {fop!r}"}

    def _feed_open(self, payload) -> Tuple[int, dict]:
        try:
            model = protocol.model_from_wire(payload["model"])
            opts = payload.get("opts") or {}
            plan_opts, exec_opts, group_key = self._check_opts(
                payload["model"], opts)
        except Exception as e:  # noqa: BLE001 — malformed input
            return 400, {"error": f"bad request: {e!r}"}
        ctx = propagate.parse_ctx(payload.get("trace_ctx"))
        # the session id doubles as the WAL run id: a session reopened
        # after a restart replays what the earlier life settled
        sid = payload.get("req") or protocol.request_id()
        run = decompose.DecomposedRun(
            model, [], oracle_fallback=bool(opts.get("oracle_fallback", True)),
            enabled=self.decomposed, lazy=True)
        prior: dict = {}
        if self._wal is not None:
            run.attach_wal(self._wal.sink_for(sid))
            prior = dict(self._wal_replay.get(sid) or {})
        s = _FeedSession(sid, run, plan_opts, exec_opts, group_key,
                         ctx["trace_id"] if ctx else None, prior)
        adm = self.admission
        with adm._wake:
            if adm._stopping.is_set():
                return 503, {"error": "stopping", "stopping": True}
            if sid in adm._feeds:
                # a retried open: the live session keeps its state
                return 200, {"session": sid, "resumed": True}
            adm._feeds[sid] = s
            adm.stats["feed_sessions"] += 1
            n_open = len(adm._feeds)
        obs.count("jepsen_feed_sessions_total")
        obs.gauge_set("jepsen_feed_open_sessions", n_open)
        return 200, {"session": sid, "resumed": False}

    def _feed_session(self, payload):
        sid = payload.get("session")
        with self.admission._wake:
            s = self.admission._feeds.get(sid)
        if s is None:
            return None, (404, {"error": f"unknown feed session {sid!r}"})
        return s, None

    def _forget_feed(self, s: _FeedSession) -> None:
        adm = self.admission
        with adm._wake:
            adm._feeds.pop(s.sid, None)
            n_open = len(adm._feeds)
        obs.gauge_set("jepsen_feed_open_sessions", n_open)

    def _feed_append(self, payload) -> Tuple[int, dict]:
        s, err = self._feed_session(payload)
        if s is None:
            return err
        try:
            seq = int(payload.get("seq"))
        except (TypeError, ValueError):
            return 400, {"error": "bad seq"}
        with s.lock:
            if s.broken is not None:
                return 500, {"error": s.broken}
            if seq <= s.last_seq:
                # a retried delta whose answer was lost: already ingested
                return 200, {"session": s.sid, "seq": seq,
                             "duplicate": True, "accepted": 0,
                             "settled": s.run.settled_count()}
            try:
                histories = protocol.histories_from_wire(
                    payload.get("histories") or [])
            except Exception as e:  # noqa: BLE001 — malformed input
                return 400, {"error": f"bad request: {e!r}"}
            n_client = len(histories)
            ops = payload.get("ops") or []
            all_ops = s.ops
            if ops:
                # op mode: check the assembled prefix again; the buffer
                # commits only with the delta
                try:
                    all_ops = s.ops + [dict(o) for o in ops]
                    probe = History.from_dicts(all_ops)
                except Exception as e:  # noqa: BLE001 — malformed input
                    return 400, {"error": f"bad ops: {e!r}"}
                histories = histories + [probe]
            base = s.run.n
            code, resp = self._feed_dispatch(s, histories,
                                             payload.get("t_inv"))
            if code != 200:
                return code, resp
            s.history_idx.extend(range(base, base + n_client))
            if ops:
                s.ops = all_ops
                s.probe_idx = base + n_client
            s.last_seq = seq
            resp["seq"] = seq
            return code, resp

    def _feed_dispatch(self, s: _FeedSession, histories,
                       t_inv) -> Tuple[int, dict]:
        """Ingest one delta: extend the session's run, replay what an
        earlier life settled into the fresh slots, encode only the new
        rows and send them through the device thread under the session's
        group key.  A delta that is refused or faults is rolled back."""
        adm = self.admission
        if not histories:
            return 200, {"session": s.sid, "accepted": 0, "rows": 0,
                         "replayed": 0, "settled": s.run.settled_count()}
        if not adm.precheck(len(histories)):
            return 503, adm.backlogged(count=True)
        base = s.run.n
        rows = s.run.extend(histories)
        replayed = 0
        if s.prior:
            replayed = s.run.replay(s.prior)
            if replayed:
                adm.bump(replayed=replayed)
                obs.count("jepsen_serve_wal_replayed_total", replayed)
        streams = []
        with obs.span("serve/feed-plan", cat="serve",
                      histories=len(histories)):
            for tag, sctx in s.run.streams():
                idxs = [i for c, i in rows if c is sctx]
                if not idxs:
                    continue
                planner = planning.Planner(
                    sctx.model, spec=sctx.spec, device=self.device,
                    bucketed=True, **s.plan_opts)
                buckets, order = planner.encode_rows(sctx, idxs)
                streams.append(_Stream(tag, sctx.model, sctx.spec, buckets,
                                       order))
        req = _FeedDelta(s.run, streams, s.group_key, s.plan_opts,
                         s.exec_opts, len(histories), trace_id=s.trace_id)
        req.rows = len(rows)
        if not adm.admit(req):
            req.abandoned = True
            s.run.abandon_oracles()
            s.run.truncate(base)
            return 503, adm.backlogged()
        if not req.device_done.wait(self.request_timeout_s):
            # the device thread still holds the rows: nothing can roll
            # them back, so the session takes no further delta
            req.abandoned = True
            s.broken = "a delta of this session timed out on the device"
            return 500, {"error": "device thread timed out"}
        if req.error is not None:
            # a device fault: answered, counted and reset by the device
            # thread; the retry of this seq dispatches again
            s.run.truncate(base)
            return 500, {"error": req.error}
        s.run.drain_oracles()
        if t_inv is not None:
            try:
                obs.observe("jepsen_feed_ingest_lag_seconds",
                            max(0.0, time.time() - float(t_inv)))
            except (TypeError, ValueError):
                pass
        adm.bump(feed_deltas=1, feed_histories=len(histories))
        obs.count("jepsen_feed_deltas_total")
        obs.count("jepsen_feed_histories_total", len(histories))
        return 200, {"session": s.sid, "accepted": len(histories),
                     "rows": len(rows), "replayed": replayed,
                     "settled": s.run.settled_count(),
                     "diag": dict(req.diag)}

    def _feed_close(self, payload) -> Tuple[int, dict]:
        adm = self.admission
        req_id = payload.get("req")
        cached = adm.dedup_hit(req_id)
        if cached is not None:
            return cached
        s, err = self._feed_session(payload)
        if s is None:
            return err
        with s.lock:
            if s.broken is not None:
                self._forget_feed(s)
                return 500, {"error": s.broken}
            # every op delta checked the whole prefix it completed, so
            # the last probe is the op history's verdict
            s.run.drain_oracles()
            results = s.run.results()
            out = [results[i] for i in s.history_idx]
            if s.probe_idx is not None:
                out.append(results[s.probe_idx])
            body = {
                "results": protocol.sanitize_results(out),
                "diag": {
                    "session": s.sid,
                    "deltas": s.last_seq + 1,
                    "histories": len(s.history_idx),
                    "ops": len(s.ops),
                    "settled": s.run.settled_count(),
                    "partitions": s.run.n_partitions,
                },
            }
        self._forget_feed(s)
        adm.dedup_store(req_id, 200, body)
        return 200, body


def _make_handler(daemon: CheckerDaemon):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, payload: dict):
            self._reply(code, protocol.encode_body(payload))

        def do_GET(self):  # noqa: N802 — http.server API
            try:
                if self.path == "/healthz":
                    ok = daemon._fatal is None
                    self._reply_json(200 if ok else 500, {
                        "ok": ok,
                        "error": daemon._fatal,
                        "platform": daemon._platform,
                        "uptime_s": round(time.time() - daemon.t_start, 1),
                    })
                elif self.path == "/status":
                    self._reply_json(200, daemon.status())
                elif self.path == "/metrics":
                    # the same formatter as the metrics.prom file dump
                    self._reply(200, obs.render_prom().encode(),
                                "text/plain; version=0.0.4")
                elif self.path.startswith("/trace"):
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    ctx = (q.get("ctx") or [""])[0]
                    if not ctx:
                        self._reply_json(400, {"error": "missing ctx"})
                    else:
                        self._reply_json(200, daemon.trace_dump(ctx))
                elif self.path.startswith("/watch"):
                    self._serve_watch()
                else:
                    self._reply_json(404, {"error": "not found"})
            except BrokenPipeError:
                pass

        def _serve_watch(self):
            """The verdict channel: settled verdicts as server-sent events
            tailing the verdict WAL.  An event's ``id:`` is the WAL's
            logical row offset (a damaged line takes none), and
            ``Last-Event-ID`` resumes right after it.  A comment line
            keeps a quiet stream alive every 5 s (a gone subscriber shows
            only on a write); the stream is unframed, so the connection
            closes when it ends (at shutdown)."""
            wal = daemon._wal
            if wal is None:
                self._reply_json(404, {"error": "no verdict WAL"})
                return
            try:
                start = int(self.headers.get("Last-Event-ID")) + 1
            except (TypeError, ValueError):
                start = 0
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-store")
            self.send_header("Connection", "close")
            self.end_headers()
            adm = daemon.admission
            adm.watchers(+1)
            tail = obs_journal.WalTail(wal.path, start=start)
            first = True
            quiet_s = 0.0
            try:
                while not adm._stopping.is_set():
                    events = tail.poll()
                    if events:
                        if first:  # what settled before this subscriber
                            obs.count("jepsen_watch_replay_rows_total",
                                      len(events))
                        self.wfile.write("".join(
                            f"id: {off}\ndata: "
                            f"{json.dumps(row, sort_keys=True)}\n\n"
                            for off, row in events).encode())
                        self.wfile.flush()
                        obs.count("jepsen_watch_events_total", len(events))
                        adm.bump(watch_events=len(events))
                        quiet_s = 0.0
                    else:
                        time.sleep(0.1)
                        quiet_s += 0.1
                        if quiet_s >= 5.0:
                            self.wfile.write(b": keep-alive\n\n")
                            self.wfile.flush()
                            quiet_s = 0.0
                    first = False
            except OSError:
                pass  # the subscriber went away
            finally:
                adm.watchers(-1)

        def do_POST(self):  # noqa: N802 — http.server API
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                if self.path == "/check":
                    self._reply_json(*daemon.handle_check(body))
                elif self.path == "/elle":
                    self._reply_json(*daemon.handle_elle(body))
                elif self.path == "/feed":
                    self._reply_json(*daemon.handle_feed(body))
                elif self.path == "/profile":
                    self._reply_json(*daemon.handle_profile(body))
                elif self.path == "/shutdown":
                    self._reply_json(200, daemon.request_shutdown())
                else:
                    self._reply_json(404, {"error": "not found"})
            except BrokenPipeError:
                pass

        def log_message(self, fmt, *args):
            pass  # the daemon's metrics are its log

    return Handler


def serve(host: str = protocol.DEFAULT_HOST,
          port: int = protocol.DEFAULT_PORT, *,
          device=None, block: bool = True, **kw) -> CheckerDaemon:
    """Build and start a checker daemon (the ``python -m
    jepsen_tpu_torch.serve`` entry).  ``device=None`` runs on the current
    CUDA device and raises when there is none; ``device="cpu"`` runs the
    plain PyTorch versions.  Other keywords go to :class:`CheckerDaemon`."""
    return CheckerDaemon(host, port, device=device, **kw).start(block=block)


# -- the supervisor ---------------------------------------------------------------

#: the child's entry: ``python -m jepsen_tpu_torch.serve`` that finds this
#: package from any working directory (the child keeps the caller's, where
#: relative paths and ``calibration.json`` are read)
_CHILD_MAIN = (
    "import sys; sys.path.insert(0, {root!r}); "
    "from jepsen_tpu_torch.serve.__main__ import main; "
    "sys.exit(main(sys.argv[1:]))"
).format(root=os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def supervise(child_args, *, max_restarts: int = 16, backoff_s: float = 1.0,
              max_backoff_s: float = 30.0, _state: Optional[dict] = None,
              _signals: bool = True) -> int:
    """``python -m jepsen_tpu_torch.serve --supervise``: run the daemon
    (``python -m jepsen_tpu_torch.serve`` with ``child_args``) as a child
    process and restart it whenever it dies abnormally (a kill, a device
    wedge, an exit for want of CUDA), after a backoff that doubles up to
    ``max_backoff_s``.  The restarted child gets the same arguments, so
    the same port and WAL: a client that retries its request ids replays
    what the crashed life settled.  The supervisor itself never touches
    the device.  Returns 0 on a clean exit (``/shutdown``) or when the
    supervisor is signalled, and the child's last exit code once
    ``max_restarts`` restarts are spent.

    ``_state`` and ``_signals`` serve :func:`supervise_fleet`, which runs
    one supervisor per member on worker threads (where ``signal.signal``
    is illegal) under one handler of its own."""
    import signal
    import subprocess

    cmd = [sys.executable, "-c", _CHILD_MAIN, *child_args]
    state = _state if _state is not None else {"sig": None, "proc": None}

    def _forward(signum, frame):
        state["sig"] = signum
        p = state["proc"]
        if p is not None and p.poll() is None:
            p.terminate()

    if _signals:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _forward)
    restarts = 0
    delay = backoff_s
    while True:
        if state["sig"] is not None:
            return 0
        proc = subprocess.Popen(cmd)
        state["proc"] = proc
        rc = proc.wait()  # the supervisor's job is the child's lifetime
        if state["sig"] is not None or rc == 0:
            return 0
        restarts += 1
        if restarts > max_restarts:
            print(f"jepsen_tpu_torch serve: restart budget exhausted "
                  f"(rc={rc})", file=sys.stderr, flush=True)
            return rc
        print(f"jepsen_tpu_torch serve: child exited rc={rc}; restart "
              f"{restarts}/{max_restarts} in {delay:.1f}s",
              file=sys.stderr, flush=True)
        time.sleep(delay)
        delay = min(delay * 2, max_backoff_s)


def _flag_value(args, flag: str) -> Optional[str]:
    """The value of ``flag`` in an argument list (``--flag V`` or
    ``--flag=V``; the last wins), or None."""
    value = None
    for i, a in enumerate(args):
        if a == flag and i + 1 < len(args):
            value = args[i + 1]
        elif a.startswith(flag + "="):
            value = a[len(flag) + 1:]
    return value


def _with_flag(args, flag: str, value: Optional[str]) -> list:
    """``args`` without any ``flag`` (either form), then ``flag value``
    appended unless ``value`` is None."""
    out, skip = [], False
    for a in args:
        if skip:
            skip = False
        elif a == flag:
            skip = True
        elif not a.startswith(flag + "="):
            out.append(a)
    return out + ([flag, value] if value is not None else [])


def fleet_member_args(i: int, args) -> list:
    """Fleet member ``i``'s daemon arguments: ``--port P+i`` (P from
    ``args``, else the default port) and, when ``args`` name a verdict
    WAL, ``--wal ROOT-i.EXT`` (two daemons appending to one WAL would
    interleave rows).  Every other argument, ``--device`` included,
    passes unchanged: on one card the members share it."""
    base = int(_flag_value(args, "--port") or protocol.DEFAULT_PORT)
    out = _with_flag(args, "--port", str(base + i))
    wal = _flag_value(args, "--wal")
    if wal is not None and wal.lower() not in ("0", "false", "off", "no",
                                                 ""):
        root, ext = os.path.splitext(wal)
        out = _with_flag(out, "--wal", f"{root}-{i}{ext}")
    return out


def supervise_fleet(n: int, child_args, *, base_port: Optional[int] = None,
                    max_restarts: int = 16, backoff_s: float = 1.0,
                    max_backoff_s: float = 30.0) -> int:
    """``python -m jepsen_tpu_torch.serve --supervise --fleet N``: N
    supervised daemons on one host, on ports ``base_port`` … ``base_port
    + N - 1`` (``base_port`` defaults to ``child_args``' ``--port``) with
    one WAL each (:func:`fleet_member_args`).  One signal handler on the
    calling (main) thread stops every member; one supervisor thread runs
    each.  Returns the worst member exit code (0 when all exited
    cleanly)."""
    import signal

    if base_port is not None:
        child_args = _with_flag(child_args, "--port", str(base_port))
    boxes = [{"sig": None, "proc": None} for _ in range(n)]

    def _forward(signum, frame):
        for b in boxes:
            b["sig"] = signum
            p = b["proc"]
            if p is not None and p.poll() is None:
                p.terminate()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _forward)
    rcs = [0] * n

    def _member(i: int) -> None:
        rcs[i] = supervise(fleet_member_args(i, child_args),
                           max_restarts=max_restarts, backoff_s=backoff_s,
                           max_backoff_s=max_backoff_s, _state=boxes[i],
                           _signals=False)

    threads = [threading.Thread(target=_member, args=(i,),
                                name=f"jepsen-fleet-{i}", daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    ports = ", ".join(_flag_value(fleet_member_args(i, child_args),
                                  "--port") for i in range(n))
    print(f"jepsen_tpu_torch serve: supervising a fleet of {n} (ports "
          f"{ports})", file=sys.stderr, flush=True)
    for t in threads:
        t.join()  # the fleet supervisor's job is the members' lifetimes
    return max(rcs)
