"""Elle-equivalent transactional anomaly checker.

Black-box transactional safety analysis: histories of micro-op
transactions are reduced to typed dependency graphs (ww/wr/rw +
process/realtime), and Adya anomalies are cycles with particular edge
profiles.  Two inference modes:

- :mod:`list_append` — appends + list reads; version order is recovered
  exactly from read prefixes (the strongest mode)
- :mod:`rw_register` — writes + point reads; version order is inferred
  from sound sources only

The reference consumes the external Elle 0.1.3 library for this
(jepsen/project.clj:11, jepsen/src/jepsen/tests/cycle.clj:5-16).  This
package is the port of :mod:`jepsen_tpu.elle`: the host analysis is the
reference's, and the bulk cycle screening runs on the GPU
(:mod:`jepsen_tpu_torch.ops.cycles` — batched bit-packed boolean closure
in a hand-written CUDA kernel).
"""

from __future__ import annotations

from typing import Optional

from ..history import History
from . import consistency, core, cycles, graph, list_append, rw_register


def _workload_module(opts: dict):
    workload = opts.get("workload", "list-append")
    if workload == "list-append":
        return list_append
    if workload == "rw-register":
        return rw_register
    raise KeyError(f"unknown elle workload {workload!r}")


def check(opts: Optional[dict], history: History, device=None,
          client=None) -> dict:
    """Elle-style entry point: opts include ``workload`` ("list-append"
    or "rw-register"), plus ``consistency-models`` / ``anomalies`` and
    ``screen-route``; the screens run on ``device`` (default: the current
    CUDA device), or on the checker daemon behind ``client`` (a
    :class:`~jepsen_tpu_torch.serve.client.ServiceClient`)."""
    opts = opts or {}
    return _workload_module(opts).check(history, opts, device, client)


def check_batch(opts: Optional[dict], histories, device=None,
                executor=None, client=None) -> list:
    """Batched Elle analysis: all histories' dependency graphs are built
    first, then screened together through
    :func:`jepsen_tpu_torch.elle.cycles.classify_graphs` — graphs from
    many histories stack into shared ``(B, n, n)`` dispatches through
    the engine Executor (``executor``, sharded over its mesh when it has
    one, else a local one on ``device``), and only graphs (and ladder
    rungs) the screens proved cyclic pay the CPU Tarjan + witness
    search.  ``opts["screen-route"]`` forces ``"device"``/``"cpu"``
    routing (default: self-calibrating auto).  rw-register's per-key
    version-graph screen runs in ``prepare`` on ``device`` (the
    executor's device when one is given).  Per-history results are
    byte-identical to :func:`check` and to the reference's.  With
    ``client`` the screens run on the checker daemon (``POST /elle``);
    when it does not answer they run in-process and every result carries
    ``"service-fallback"`` with the reason."""
    opts = opts or {}
    mod = _workload_module(opts)
    if executor is not None:
        device = executor.device
    preps = [mod.prepare(h, opts, device) for h in histories]
    fell: list = []
    cyc = cycles.classify_graphs(
        [p[0] for p in preps], route=opts.get("screen-route"),
        executor=executor, device=device, client=client, fallbacks=fell,
    )
    return cycles.tag_fallback(
        [mod.finish(p, c) for p, c in zip(preps, cyc)], fell)
