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
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..parallel import mesh as mesh_mod
from .decompose import DecomposedRun
from .execution import Executor
from .planning import Planner, estimated_cost


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
    counters (:meth:`Executor.counters`).  This is ``check_batch``'s
    engine — call that, not this."""
    device, mesh = mesh_mod.run_placement(device, mesh)
    n_devices = 1 if mesh is None else mesh.size
    dec = DecomposedRun(model, histories, oracle_fallback=oracle_fallback,
                        enabled=decomposed)
    ex = Executor(window, device=device, mesh=mesh, escalation=escalation,
                  sufficient_rung=sufficient_rung, max_dispatch=max_dispatch)
    streams = {}  # id(ctx) -> the BucketStream of that context's planner
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
    # end-of-input buckets of every stream, largest estimated cost first
    finished = [pb for stream in streams.values() for pb in stream.finish()]
    finished.sort(key=estimated_cost, reverse=True)
    for pb in finished:
        ex.submit(pb)
    ex.drain()
    dec.drain_oracles()
    if stats is not None:
        stats.update(ex.counters())
    return dec.results()
