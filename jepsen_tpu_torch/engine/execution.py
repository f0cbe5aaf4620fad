"""The device-owning **execution** half of the checker engine — the port
of :mod:`jepsen_tpu.engine.execution` for one CUDA device, a mesh of
them (:mod:`jepsen_tpu_torch.parallel.mesh`), or the CPU.

JAX dispatches asynchronously and syncs when a result is read; here a
chunk dispatch is, per shard of the chunk's rows (one shard without a
mesh): inputs copied from pinned host memory onto the shard's device
with ``non_blocking=True``, the kernel launched on that device's current
CUDA stream, outputs copied back into pinned host tensors with
``non_blocking=True``, and a :class:`torch.cuda.Event` recorded after
them.  :class:`DispatchWindow` keeps at most ``window`` such chunks in
flight and retires the oldest by synchronising its events.  On the CPU a
dispatch runs the plain PyTorch version synchronously.

Both classes are **owner-thread confined**: ``submit``/``drain`` must
come from the thread that created them (checked at run time).  The
oracle worker pool interacts with execution only through the futures
each :class:`~jepsen_tpu_torch.engine.planning.RunContext` holds.

Telemetry (:mod:`..obs`, the reference's names), none of it a device
sync — each time is read where the engine already waits:

- ``engine/dispatch`` span around each retire's wait, its seconds in
  ``jepsen_engine_bubble_seconds``, and the peak in-flight depth in
  ``jepsen_engine_inflight_depth``;
- ``jepsen_kernel_dispatches_total`` by kernel and phase, and
  ``jepsen_kernel_{compile,execute}_seconds`` from dispatch to settle:
  "compile" is the first dispatch of a kernel at a row shape (on the
  card it includes the ``nvcc`` build of a first use), "execute" every
  later one;
- ``jepsen_engine_shard_pad_rows_total``, and under a mesh the live
  share of each device's rows, ``jepsen_engine_device_occupancy_ratio``;
- when a dispatch journal is configured (:mod:`..obs.journal`), one row
  per settled chunk, scored by the drift sentinel when one is active
  (:mod:`..obs.drift`); nothing is built or written without a journal.

The window depth and the row-bucket floor resolve as argument > active
calibration (:mod:`..tune.artifact`) > :data:`DEFAULT_WINDOW` /
:data:`ROW_BUCKET` (:func:`default_window`, :func:`row_bucket_floor`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..obs import drift as obs_drift
from ..obs import journal as obs_journal

#: default bound on concurrently in-flight device dispatches; 1 = the
#: strictly serial dispatch-sync-dispatch path
DEFAULT_WINDOW = 4

#: minimum dispatch row bucket: a chunk's row count rounds up to the next
#: power of two ≥ this (never past the chunk cap) with neutral
#: all-padding rows, so repeat traffic reuses a few stable shapes
ROW_BUCKET = 64


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def row_bucket_floor(row_bucket: Optional[int] = None) -> int:
    """The resolved minimum dispatch row bucket: ``row_bucket`` (rounded
    up to a power of two, so the geometric ladder stays intact) > the
    active calibration > :data:`ROW_BUCKET`."""
    from ..tune import artifact as _cal

    if row_bucket is not None:
        row_bucket = _pow2_at_least(max(1, int(row_bucket)))
    return _cal.resolve_knob(row_bucket, lambda cal: cal.row_bucket(),
                             ROW_BUCKET)


def default_window(window: Optional[int] = None) -> int:
    """The resolved in-flight window: ``window`` > the active calibration
    > :data:`DEFAULT_WINDOW`."""
    from ..tune import artifact as _cal

    if window is not None:
        window = max(1, int(window))
    return _cal.resolve_knob(window, lambda cal: max(1, cal.window()),
                             DEFAULT_WINDOW)


def row_bucket_target(n: int, floor: Optional[int] = None) -> int:
    """Row count → its stable dispatch shape: the next power of two,
    floored at ``floor`` (default :func:`row_bucket_floor`)."""
    target = row_bucket_floor() if floor is None else floor
    while target < n:
        target *= 2
    return target


def shard_row_target(n: int, n_shards: int,
                     floor: Optional[int] = None) -> int:
    """Row count → its stable dispatch shape on an ``n_shards``-device
    mesh: the per-shard row count rounds up to a power of two, floored so
    that the whole chunk never drops below ``floor`` rows (default
    :func:`row_bucket_floor`; a tiny batch pays the same neutral rows
    spread over the mesh, not ``floor`` per device).  ``n_shards = 1`` is
    :func:`row_bucket_target`; the result is a multiple of ``n_shards``."""
    if floor is None:
        floor = row_bucket_floor()
    if n_shards <= 1:
        return row_bucket_target(n, floor)
    per_floor = _pow2_at_least(max(1, -(-floor // n_shards)))
    per = max(per_floor, _pow2_at_least(max(1, -(-n // n_shards))))
    return n_shards * per


def _pad_rows(a: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad axis 0 of ``a`` up to ``n`` rows with ``fill``."""
    if a.shape[0] >= n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


class InFlight:
    """One dispatched chunk on the card: per shard, its outputs' pinned
    host copies and the event recorded after them, and the device outputs
    the copies read (kept alive until the events have passed; the pinned
    inputs are held by PyTorch's host allocator until their copies are
    done).  It retires when every shard's event has fired."""

    __slots__ = ("events", "outputs", "keepalive")

    def __init__(self, events, outputs, keepalive):
        self.events = events
        self.outputs = outputs
        self.keepalive = keepalive


def _materialize(out):
    """Wait for a chunk and return its outputs as numpy (the sync point)."""
    if isinstance(out, InFlight):
        for event in out.events:
            event.synchronize()
        return tuple(np.concatenate([shard[i].numpy() for shard in out.outputs])
                     for i in range(len(out.outputs[0])))
    return tuple(np.asarray(x) for x in out)


def _collect(outs):
    """Output-major per-shard device outputs → host outputs (every shard on
    the CPU) or an :class:`InFlight` (per shard: pinned host copies on the
    shard's device's current stream, then an event)."""
    n_shards = len(outs[0])
    if all(s.device.type == "cpu" for o in outs for s in o):
        return tuple(np.concatenate([s.numpy() for s in o]) for o in outs)
    events, host = [], []
    for d in range(n_shards):
        shard = [o[d] for o in outs]
        dev = shard[0].device
        with torch.cuda.device(dev):
            out_host = tuple(torch.empty(o.shape, dtype=o.dtype,
                                         pin_memory=True) for o in shard)
            for h, o in zip(out_host, shard):
                h.copy_(o, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        events.append(event)
        host.append(out_host)
    return InFlight(events, host, outs)


_claim_lock = threading.Lock()

#: dispatch shapes claimed so far per Elle plan kind (a history plan's
#: checker keeps its own)
_PLAN_SHAPES: Dict[tuple, set] = {}


def dispatch_owner(plan):
    """What a plan's first-dispatch claims belong to: a history plan's
    checker, cached per kernel shape (a rebuilt checker compiles anew, as
    the reference's per-executable claim does), or — for an Elle plan,
    rebuilt per call — its kind, vertex bucket, filter profile and mode."""
    if hasattr(plan, "settle_rows"):
        return (type(plan).__name__, plan.E, plan.mode,
                getattr(plan, "masks", None), getattr(plan, "nonadj", None))
    return plan.fn


def claim_first_dispatch(owner, shape) -> bool:
    """True exactly once per :func:`dispatch_owner` and dispatch
    ``shape``: the first dispatch is the "compile" phase of the kernel
    telemetry, every later one "execute"."""
    with _claim_lock:
        if isinstance(owner, tuple):
            shapes = _PLAN_SHAPES.setdefault(owner, set())
        else:
            shapes = getattr(owner, "_obs_dispatched_shapes", None)
            if shapes is None:
                shapes = set()
                object.__setattr__(owner, "_obs_dispatched_shapes", shapes)
        if shape in shapes:
            return False
        shapes.add(shape)
        return True


class DispatchWindow:
    """A bounded window of in-flight device dispatches.

    ``submit(key, thunk)`` first retires (syncs) the oldest entries until
    fewer than ``window`` are in flight, then calls ``thunk`` — which
    must *dispatch* device work and return an :class:`InFlight` (or
    already-host outputs) — and enqueues its result.  ``drain()`` retires
    everything left.  Retirement materializes the outputs and hands
    ``(key, outputs)`` to ``on_retire``.

    window=1 is the serial contract: every dispatch fully settles before
    the next one is issued.
    """

    def __init__(
        self,
        window: Optional[int] = None,
        on_retire: Optional[Callable[[Any, tuple], None]] = None,
    ):
        self.window = default_window(window)
        self.on_retire = on_retire
        #: (key, in-flight out), oldest first
        self._inflight: deque = deque()
        self._owner = threading.get_ident()
        #: dispatches so far, the most in flight at once, and the host
        #: seconds spent blocked on a retiring dispatch
        self.submitted = 0
        self.peak_depth = 0
        self.bubble_s = 0.0

    def _check_owner(self) -> None:
        if threading.get_ident() != self._owner:
            raise RuntimeError(
                "DispatchWindow is owner-thread confined: submit/drain "
                "must run on the creating thread (oracle workers hand "
                "results back through Futures, never drive the window)"
            )

    def submit(self, key, thunk, attrs: Optional[dict] = None) -> None:
        """Dispatch one unit of device work, first retiring the oldest
        entries until there is room.  ``attrs`` label the entry's
        ``engine/dispatch`` span."""
        self._check_owner()
        while len(self._inflight) >= self.window:
            self._retire()
        self._inflight.append((key, thunk(), attrs))
        self.submitted += 1
        depth = len(self._inflight)
        if depth > self.peak_depth:
            self.peak_depth = depth
        obs.gauge_max("jepsen_engine_inflight_depth", depth)

    def _retire(self) -> None:
        key, out, attrs = self._inflight.popleft()
        t0 = time.perf_counter()
        if obs.enabled():
            with obs.span("engine/dispatch", cat="engine", **(attrs or {})):
                mat = _materialize(out)
        else:
            mat = _materialize(out)
        wait = time.perf_counter() - t0
        self.bubble_s += wait
        obs.observe("jepsen_engine_bubble_seconds", wait)
        if self.on_retire is not None:
            self.on_retire(key, mat)

    def drain(self) -> None:
        """Retire every in-flight dispatch, oldest first."""
        self._check_owner()
        while self._inflight:
            self._retire()

    @property
    def depth(self) -> int:
        """Dispatches in flight now."""
        return len(self._inflight)

    def abandon(self) -> int:
        """Drop every in-flight entry without retiring it (no sync, no
        ``on_retire``): the recovery path after a dispatch raised, where
        syncing the survivors could raise the same device fault again.
        The dropped work finishes (or fails) on the card by itself.
        Returns the number dropped."""
        self._check_owner()
        n = len(self._inflight)
        self._inflight.clear()
        return n


class Executor:
    """Device-owning execution of planned buckets on one device, or on
    every device of a :class:`~jepsen_tpu_torch.parallel.mesh.Mesh`.

    ``submit(planned_bucket)`` splits the bucket into chunks of at most
    the plan's dispatch cap — every chunk padded with neutral rows to one
    stable row count — and dispatches them through the executor's
    :class:`DispatchWindow`; ``drain()`` retires everything in flight and
    then runs the escalation ladder.  Row verdicts route through each
    row's ``(ctx, idx)`` token back to its
    :class:`~jepsen_tpu_torch.engine.planning.RunContext`.

    A plan may settle itself (the Elle screens' :class:`~jepsen_tpu_torch.
    ops.cycles.CyclePlan` / ``ScreenPlan``): it carries its own input
    arrays and neutral ``pad_fills``, and ``settle_rows(rows, mat,
    n_live)`` takes its chunk's outputs — no escalation ladder, no
    verdict unpack.  History plans keep the six-array tuple, its pad
    fills and the ``(ok, failed_at, overflow)`` outputs.

    A frontier chunk gets 1/window of the plan's row cap, so the chunks
    in flight together hold at most one cap's worth of device memory;
    when the cap is below the window, the bucket dispatches serially at
    the full cap.  Dense chunks keep the full cap.  Every cap is per
    device: on a mesh of n devices a chunk holds n × the cap and splits
    into n equal shards (:func:`shard_row_target`), padded with neutral
    rows, one CUDA event per shard.  The padding and live rows each
    device was handed are kept in :attr:`shard_pad_rows`,
    :attr:`dev_rows_live` and :attr:`dev_rows_total`, the peak rows in
    flight on one device per (kernel, E, C, F, cap) in
    :attr:`chip_row_accounting`.  A chunk with
    overflowed rows is parked and escalates at :meth:`drain`, with the
    window empty.  A bucket with no device checker (routed to the
    oracle) or whose cap is 0 (not even one row fits) settles inline:
    its rows go to the oracle pool at once, overlapping the remaining
    device work.
    """

    def __init__(self, window: Optional[int] = None, *,
                 device: Optional[torch.device] = None, mesh=None,
                 escalation=None, sufficient_rung: bool = True,
                 max_dispatch: Optional[int] = None,
                 row_bucket: Optional[int] = None):
        from ..ops import wgl
        from ..parallel import mesh as mesh_mod

        if device is None and mesh is None:
            raise ValueError("an Executor needs a device or a mesh")
        device, mesh = mesh_mod.run_placement(device, mesh)
        self.device = device
        #: the mesh chunks shard over (None: the one device)
        self.mesh = mesh
        #: what a chunk dispatches over: the mesh, or a mesh of the device
        self._placement = mesh if mesh is not None else \
            mesh_mod.Mesh((device,))
        self.escalation = (wgl.ESCALATION_FACTORS if escalation is None
                           else escalation)
        self.sufficient_rung = sufficient_rung
        self.max_dispatch = (wgl.DEFAULT_MAX_DISPATCH if max_dispatch is None
                             else max_dispatch)
        #: the resolved row-bucket floor (:func:`row_bucket_floor`)
        self.row_bucket = row_bucket_floor(row_bucket)
        self._win = DispatchWindow(window, on_retire=self._settle_chunk)
        #: chunk_id -> (plan, padded host arrays, rows, live row count,
        #: telemetry phase, dispatch time, rows per device, accounting key)
        self._chunks: Dict[int, tuple] = {}
        self._next_chunk = 0
        #: chunks whose base pass overflowed, parked until the window drains:
        #: an escalation rerun holds a larger frontier, and running it on top
        #: of in-flight base chunks would exceed the memory the caps allow
        self._pending_escalations: List[tuple] = []
        #: neutral padding rows dispatched so far, to row buckets and to
        #: equal shards (plain counters, callers reset them)
        self.shard_pad_rows = 0
        #: per device of the placement: live rows and all rows handed to it
        self.dev_rows_live: List[int] = [0] * self.n_devices
        self.dev_rows_total: List[int] = [0] * self.n_devices
        #: rows in flight on one device, and their peak against the plan's
        #: per-device cap, keyed by (kernel, E, C, F, cap): a frontier
        #: shape's peak stays within its cap at any window depth, a dense
        #: one within cap × window (the tuner's budget evidence)
        self._chip_rows_inflight: Dict[tuple, int] = {}
        self.chip_row_accounting: Dict[tuple, dict] = {}
        #: extra journal fields the caller owns (``coalesced``,
        #: ``trace_id``)
        self.journal_context: Dict[str, Any] = {}
        #: chunk dispatches by telemetry phase: "compile" is a kernel's
        #: first dispatch at a row shape (cold), "execute" every later one
        self.phase_counts = {"compile": 0, "execute": 0}

    @property
    def submitted(self) -> int:
        """Chunks dispatched so far."""
        return self._win.submitted

    @property
    def peak_depth(self) -> int:
        return self._win.peak_depth

    @property
    def window_size(self) -> int:
        return self._win.window

    @property
    def bubble_s(self) -> float:
        return self._win.bubble_s

    @property
    def n_devices(self) -> int:
        """Shards each dispatch splits into (1 = no mesh)."""
        return self._placement.size

    def counters(self) -> dict:
        """The dispatch counters as plain values: the placement's devices,
        padding rows, and live and total rows per device."""
        return {"devices": [str(d) for d in self._placement.devices],
                "shard_pad_rows": self.shard_pad_rows,
                "dev_rows_live": list(self.dev_rows_live),
                "dev_rows_total": list(self.dev_rows_total)}

    # -- settle path (runs inside window retirement, owner thread) -------

    def _settle_chunk(self, chunk_id, mat):
        (plan, arrays, rows, n_live, phase, t_dispatch, chip_rows,
         acct_key) = self._chunks.pop(chunk_id)
        self._chip_rows_inflight[acct_key] -= chip_rows
        elapsed = time.perf_counter() - t_dispatch
        if obs.enabled():
            # dispatch-to-settled latency; under pipelining chunks
            # overlap, so these sum past the wall clock by design
            obs.observe(f"jepsen_kernel_{phase}_seconds", elapsed,
                        engine=plan.kernel)
        if obs_journal.active() is not None:
            self._journal_dispatch(plan, phase, n_live, elapsed)
        settle = getattr(plan, "settle_rows", None)
        if settle is not None:
            settle(rows, mat, n_live)
            return
        # np.array, not asarray: the escalation pass writes into these
        ok, failed_at, overflow = (np.array(x)[:n_live] for x in mat)
        if overflow.any():
            self._pending_escalations.append(
                (plan, arrays, rows, ok, failed_at, overflow))
        else:
            self._assign_rows(plan, rows, ok, failed_at, overflow)

    def _journal_dispatch(self, plan, phase: str, n_live: int,
                          elapsed: float) -> None:
        """One schema-v1 journal row per settled chunk, then the drift
        sentinel's score of it.  Best-effort: ``emit`` drops a row it
        cannot write, and a dispatch never fails for the journal."""
        from ..tune import artifact as _cal

        cal = _cal.active()
        compile_hit = phase == "compile"
        ctx = self.journal_context
        row = obs_journal.emit(
            kernel=str(plan.kernel),
            E=int(plan.E),
            C=int(plan.C),
            F=int(plan.frontier),
            rows=int(n_live),
            n_devices=int(self.n_devices),
            mesh_shape=[self.n_devices] if self.mesh is not None else [1],
            window=int(self.window_size),
            compile_s=round(elapsed, 6) if compile_hit else 0.0,
            execute_s=0.0 if compile_hit else round(elapsed, 6),
            coalesced=int(ctx.get("coalesced", 1)),
            cache="miss" if compile_hit else "hit",
            closure_mode=str(getattr(plan, "mode", "") or ""),
            union="",
            calibration=cal.calibration_id if cal is not None else "",
            trace_id=str(ctx.get("trace_id", "") or ""),
        )
        if row is not None:
            sentinel = obs_drift.active()
            if sentinel is not None:
                sentinel.observe_row(row)

    def _settle_rows(self, plan, arrays, rows, ok, failed_at, overflow):
        """Escalate a chunk's overflows on the device, then assign verdicts
        (still-overflowed rows join each row's oracle pool)."""
        from ..ops import wgl

        wgl.escalate_overflows(
            plan, arrays, ok, failed_at, overflow, device=self.device,
            mesh=self.mesh, escalation=self.escalation,
            sufficient_rung=self.sufficient_rung,
            max_dispatch=self.max_dispatch,
        )
        self._assign_rows(plan, rows, ok, failed_at, overflow)

    @staticmethod
    def _assign_rows(plan, rows, ok, failed_at, overflow):
        unresolved = "routed" if plan.kernel == "oracle" else "overflow"
        for row, (ctx, hist_idx) in enumerate(rows):
            if overflow[row]:
                # routed to the oracle, or still overflowed after
                # escalation: the oracle decides, never a guess
                ctx.route_oracle(hist_idx, plan.overflow_engine(),
                                 unresolved)
            elif ok[row]:
                ctx.assign(hist_idx, {
                    "valid?": True,
                    "engine": "gpu",
                    "kernel": plan.kernel,
                })
            else:
                ctx.assign(hist_idx, {
                    "valid?": False,
                    "engine": "gpu",
                    "kernel": plan.kernel,
                    "failed-event": int(failed_at[row]),
                })

    # -- dispatch path ----------------------------------------------------

    def _launch(self, plan, arrays):
        """Run ``plan`` on one padded chunk, sharded over the placement:
        the plan's own ``run_rows`` (the Elle screens), else the history
        checker through :func:`~jepsen_tpu_torch.parallel.mesh.
        sharded_check`.  Returns host outputs (CPU) or an
        :class:`InFlight` (CUDA, nothing synchronised)."""
        from ..parallel import mesh as mesh_mod

        run_rows = getattr(plan, "run_rows", None)
        if run_rows is not None:
            outs = run_rows(self._placement, arrays)
        else:
            outs = mesh_mod.sharded_check(plan.fn, self._placement, *arrays)
        return _collect(outs)

    def _dispatch(self, plan, chunk, rows) -> None:
        chunk_id = self._next_chunk
        self._next_chunk += 1
        n_live, n_rows = len(rows), chunk[0].shape[0]
        phase = ("compile" if claim_first_dispatch(
            dispatch_owner(plan), (str(self.device), n_rows, self.n_devices))
            else "execute")
        self.phase_counts[phase] += 1
        if obs.enabled():
            obs.count("jepsen_kernel_dispatches_total", 1,
                      engine=plan.kernel, phase=phase)
            if n_rows > n_live:
                obs.count("jepsen_engine_shard_pad_rows_total",
                          n_rows - n_live)
        self.shard_pad_rows += n_rows - n_live
        shard = n_rows // self.n_devices
        for d in range(self.n_devices):
            self.dev_rows_total[d] += shard
            self.dev_rows_live[d] += min(max(n_live - d * shard, 0), shard)
        # per-device budget accounting, keyed by the plan's shape and its
        # cap (the same kernel at another cap is another ledger entry)
        key = (plan.kernel, plan.E, plan.C, plan.frontier, plan.disp)
        acct = self.chip_row_accounting.setdefault(
            key, {"kernel": plan.kernel, "peak_chip_rows": 0,
                  "chip_cap": plan.disp})
        self._chunks[chunk_id] = (plan, chunk, rows, n_live, phase,
                                  time.perf_counter(), shard, key)

        def thunk():
            # counted inside the thunk: submit retires older chunks first
            # (their settles decrement), so counting earlier would
            # overstate the peak by a retired chunk
            cur = self._chip_rows_inflight.get(key, 0) + shard
            self._chip_rows_inflight[key] = cur
            acct["peak_chip_rows"] = max(acct["peak_chip_rows"], cur)
            return self._launch(plan, chunk)

        self._win.submit(
            chunk_id, thunk,
            {"engine": plan.kernel, "rows": n_live, "phase": phase},
        )

    def submit(self, pb) -> None:
        """Dispatch one planned bucket in capped chunks through the
        window (or hand it to the oracle inline when no row fits)."""
        from ..ops import wgl

        plan, arrays, rows = pb.plan, pb.arrays, pb.rows
        B = arrays[0].shape[0]
        if hasattr(plan, "settle_rows") and plan.disp == 0:
            raise ValueError("no row of this bucket fits one dispatch: its "
                             "graphs belong on the host path")
        if plan.fn is None or plan.disp == 0:
            # no device checker (an oracle-routed shape, a dense-only spec
            # outside its envelope) or not even one row fits: every
            # escalation rung is as undispatchable (caps shrink as the
            # capacity grows), so settling here dispatches nothing and
            # hands the rows to the oracle pool at once
            self._settle_rows(plan, arrays, rows, np.zeros((B,), bool),
                              np.zeros((B,), np.int32), np.ones((B,), bool))
            return
        per_device = plan.disp
        serialize = False
        if plan.kernel != "dense" and self._win.window > 1:
            if per_device >= self._win.window:
                per_device //= self._win.window
            else:
                serialize = True
        # every cap is per device: a chunk shards evenly over the mesh
        cap = per_device * self.n_devices
        # one stable shape per bucket: a short bucket pads to its power-of
        # -two row bucket (per shard), a long one to full cap-row chunks
        # (the tail too), so a bucket never launches at a per-tail-size
        # shape, and every chunk splits into equal shards
        target = min(cap, shard_row_target(B, self.n_devices,
                                           self.row_bucket))
        pad_fills = getattr(plan, "pad_fills", wgl._PAD_FILLS)
        for lo in range(0, B, cap):
            hi = min(lo + cap, B)
            chunk = tuple(
                _pad_rows(np.asarray(a[lo:hi]), target, fill)
                for a, fill in zip(arrays, pad_fills)
            )
            if serialize:
                self._win.drain()
            self._dispatch(plan, chunk, rows[lo:hi])
        if serialize:
            self._win.drain()

    def reset(self) -> int:
        """Discard every piece of transient dispatch state — the window's
        in-flight entries (unsynced: :meth:`DispatchWindow.abandon`), the
        chunk map and the parked escalations — without assigning a
        verdict, leaving the executor usable.  The service calls it when
        a batch raised: a window still holding the failed batch's chunks
        would retire them into the next batch, and its parked escalations
        would settle into abandoned runs.  Returns the number of
        dispatches abandoned."""
        n = self._win.abandon()
        self._chunks.clear()
        self._pending_escalations = []
        self._chip_rows_inflight.clear()
        return n

    def drain(self) -> None:
        """Retire every in-flight dispatch, then run the escalation ladder
        with the window empty.  Parked chunks merge per plan first (live
        rows only: tail chunks carry neutral padding rows), so a bucket
        pays one padded rerun per rung, not one ladder per chunk."""
        self._win.drain()
        if obs.enabled() and self.mesh is not None:
            # per-device occupancy: the live (non-padding) share of the
            # rows each device was handed; pads sit at the shard tail
            for d, total in enumerate(self.dev_rows_total):
                if total:
                    obs.gauge_set("jepsen_engine_device_occupancy_ratio",
                                  self.dev_rows_live[d] / total,
                                  device=str(d))
        pending, self._pending_escalations = self._pending_escalations, []
        merged: Dict[int, List[tuple]] = {}
        for item in pending:
            merged.setdefault(id(item[0]), []).append(item)
        for group in merged.values():
            n = [len(g[2]) for g in group]
            arrays = tuple(
                np.concatenate([g[1][i][:k] for g, k in zip(group, n)])
                for i in range(6)
            )
            self._settle_rows(
                group[0][0], arrays, [r for g in group for r in g[2]],
                *(np.concatenate([g[i] for g in group]) for i in (3, 4, 5)),
            )
