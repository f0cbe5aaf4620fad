"""The pipelined dispatch engine behind ``wgl.check_batch`` — the port of
:func:`jepsen_tpu.engine.pipeline.run`.

- **Shape buckets.**  Histories encode one at a time into per-``(E, C)``
  buckets (``encode.bucket_key``), so a short history does not pay a
  long one's padding; a bucket flushes into device chunks when it
  reaches the flush threshold or at end of input.
- **Dispatch window.**  Chunk dispatches are asynchronous CUDA launches;
  :class:`~jepsen_tpu_torch.engine.execution.DispatchWindow` bounds how
  many are in flight and syncs only the oldest when the window fills —
  window=1 is the serial dispatch-sync-dispatch path.
- **Escalation.**  Frontier rows that overflow are parked and climb
  the escalation ladder once the window has drained
  (:meth:`~jepsen_tpu_torch.engine.execution.Executor.drain`).
- **Concurrent oracle.**  Unencodable histories go to the CPU-oracle
  worker pool the moment they are met, rows still overflowed after the
  ladder join when it ends, so oracle wall time hides behind the
  remaining device work.
- **Decomposition.**  Ahead of all of this, histories of a model that
  declares a partition split into per-partition sub-histories
  (:mod:`.decompose`); the sub-histories flow through their own planner
  into the same executor, and their verdicts AND back at the end.
- **Mesh.**  A run given a :class:`~jepsen_tpu_torch.parallel.mesh.Mesh`
  shards every chunk over its devices; a run given neither a mesh nor a
  device adopts :func:`~jepsen_tpu_torch.parallel.mesh.
  engine_default_mesh` (every CUDA device when there are two or more).

Pipeline telemetry (:mod:`..obs`, the reference's names): an
``engine/pipeline`` span per run (buckets, flushes, chunks, peak
in-flight depth, window, devices, and the decomposition's counts),
``jepsen_engine_bucket_count`` (high-water),
``jepsen_engine_occupancy_ratio`` (1 − blocked/wall over the device
phase, the oracle drain excluded) and ``jepsen_engine_rows_total`` per
engine (:func:`~.planning.finish_run_telemetry`).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

from .. import obs
from ..parallel import mesh as mesh_mod
from .decompose import DecomposedRun
from .execution import Executor
from .planning import Planner, estimated_cost, finish_run_telemetry


def run(
    model,
    histories: Sequence,
    *,
    slot_cap: int,
    device,
    max_dispatch: int,
    frontier: int,
    max_closure: Optional[int] = None,
    escalation=None,
    oracle_fallback: bool = True,
    sufficient_rung: bool = True,
    oracle_budget_s: Optional[float] = None,
    window: Optional[int] = None,
    bucketed: bool = True,
    decomposed: bool = True,
    mesh=None,
    stats: Optional[dict] = None,
) -> List[dict]:
    """Check ``histories`` through the full pipeline on ``device`` (a
    device, or None for the default CUDA device) or over ``mesh``;
    per-history result dicts in input order.  With neither, the mesh is
    :func:`~jepsen_tpu_torch.parallel.mesh.engine_default_mesh`'s.
    ``stats``, when given, gains the run's dispatch
    counters (:meth:`Executor.counters`).  ``oracle_budget_s`` bounds each
    oracle search; budgeted searches run serially after the device work
    (:meth:`~.planning.RunContext.route_oracle`).  This is
    ``check_batch``'s engine — call that, not this."""
    device, mesh = mesh_mod.run_placement(device, mesh)
    n_devices = 1 if mesh is None else mesh.size
    dec = DecomposedRun(model, histories, oracle_fallback=oracle_fallback,
                        oracle_budget_s=oracle_budget_s, enabled=decomposed)
    ex = Executor(window, device=device, mesh=mesh, escalation=escalation,
                  sufficient_rung=sufficient_rung, max_dispatch=max_dispatch)
    t0 = time.perf_counter()
    with obs.span("engine/pipeline", cat="engine") as sp:
        streams = {}  # id(ctx) -> the BucketStream of its planner
        for ctx, idx in dec.feed():
            stream = streams.get(id(ctx))
            if stream is None:
                stream = streams[id(ctx)] = Planner(
                    ctx.model, slot_cap=slot_cap, device=device,
                    max_dispatch=max_dispatch, frontier=frontier,
                    max_closure=max_closure, bucketed=bucketed,
                    n_devices=n_devices,
                ).open_stream()
            for pb in stream.feed(ctx, idx):
                ex.submit(pb)
        # end-of-input buckets of every stream, largest estimated cost
        # first
        finished = [pb for stream in streams.values()
                    for pb in stream.finish()]
        finished.sort(key=estimated_cost, reverse=True)
        for pb in finished:
            ex.submit(pb)
        ex.drain()
        t_device_end = time.perf_counter()
        dec.drain_oracles()
        n_buckets = sum(st.planner.n_buckets for st in streams.values())
        if sp:
            sp.set("buckets", n_buckets)
            sp.set("flushes",
                   sum(st.planner.n_flushes for st in streams.values()))
            sp.set("chunks", ex.submitted)
            sp.set("peak-inflight", ex.peak_depth)
            sp.set("window", ex.window_size)
            sp.set("devices", ex.n_devices)
            if dec.n_decomposed:
                sp.set("decomposed", dec.n_decomposed)
                sp.set("partitions", dec.n_partitions)
    if stats is not None:
        stats.update(ex.counters())
    results = dec.results()
    if obs.enabled():
        if n_buckets:
            obs.gauge_max("jepsen_engine_bucket_count", n_buckets)
        # occupancy over the device phase only: the oracle drain would
        # let an oracle-bound run read as a busy device
        elapsed = t_device_end - t0
        if ex.submitted and elapsed > 0:
            obs.gauge_set("jepsen_engine_occupancy_ratio",
                          max(0.0, 1.0 - ex.bubble_s / elapsed))
        finish_run_telemetry(results)
    return results
