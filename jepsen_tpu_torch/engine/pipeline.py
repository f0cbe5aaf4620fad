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
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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
) -> List[dict]:
    """Check ``histories`` through the full pipeline on ``device`` (a
    resolved :class:`torch.device`); per-history result dicts in input
    order.  This is ``check_batch``'s engine — call that, not this."""
    dec = DecomposedRun(model, histories, oracle_fallback=oracle_fallback,
                        enabled=decomposed)
    ex = Executor(window, device=device, escalation=escalation,
                  sufficient_rung=sufficient_rung, max_dispatch=max_dispatch)
    streams = {}  # id(ctx) -> the BucketStream of that context's planner
    for ctx, idx in dec.feed():
        stream = streams.get(id(ctx))
        if stream is None:
            stream = streams[id(ctx)] = Planner(
                ctx.model, slot_cap=slot_cap, device=device,
                max_dispatch=max_dispatch, frontier=frontier,
                max_closure=max_closure, bucketed=bucketed,
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
    return dec.results()
