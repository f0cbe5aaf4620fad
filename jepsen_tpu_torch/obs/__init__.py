"""Run-wide observability for the port: spans and metrics threaded through
the checker seam, the engine, the oracle and Elle — the port of
:mod:`jepsen_tpu.obs`'s facade.

One process-global :class:`~.tracer.Tracer` and
:class:`~.metrics.MetricsRegistry` are fed by hooks at the reference's
seams and under its names:

- per-checker spans (``check_safe``, ``checker/<name>``) — ``checker``
- the pipelined engine (``engine/pipeline``, ``engine/dispatch``,
  ``engine/oracle``), its kernel compile/execute timings, dispatch,
  padding, routing and row counters, the frontier's high-water and
  safe-dispatch gauges — ``engine``
- Elle's screen routes and closure counters
- the harness: ``core.run`` phases (setup / generator / teardown /
  save-history / analyze) — ``phase``; interpreter op invokes and their
  ok/info/fail counters (:func:`count_op`) — ``op``; nemesis fault
  invokes — ``nemesis``; control commands — ``control``

Exports (:mod:`.export`): ``trace.json`` (Chrome trace_event),
``trace-spans.jsonl`` and ``metrics.prom`` (Prometheus text), plus a
summary dict.  :mod:`.profiling` adds a bounded ``torch.profiler``
capture with the device's own kernel times.

Everything is stdlib-only.  On by default, as in the reference; there is
no environment switch — :func:`disable` and :func:`enable` are the knobs.
Disabled hooks cost one branch: :func:`span` returns a shared null
context with no allocation, and counters check the flag before taking
their lock.  No hook synchronises the device: spans time what the engine
already waits on.
"""

from __future__ import annotations

from typing import Optional

from . import export as export_mod
from . import propagate as propagate_mod
from .metrics import MetricsRegistry
from .tracer import NULL_SPAN, SpanRecord, Tracer  # noqa: F401 (re-export)

_tracer = Tracer(enabled=True)
_registry = MetricsRegistry(enabled=True)


def tracer() -> Tracer:
    return _tracer


def registry() -> MetricsRegistry:
    return _registry


def enabled() -> bool:
    return _tracer.enabled


def enable(reset: bool = False) -> None:
    if reset:
        _tracer.reset()
        _registry.reset()
        propagate_mod.reset()
    _tracer.enabled = True
    _registry.enabled = True


def disable() -> None:
    _tracer.enabled = False
    _registry.enabled = False


def reset() -> None:
    _tracer.reset()
    _registry.reset()
    propagate_mod.reset()


# -- span + metric shorthands (the instrumentation surface) -----------------


def span(name: str, cat: str = "", **attrs):
    """Context manager for one span; shared null context when disabled
    (one branch, zero allocation — safe in hot loops)."""
    if not _tracer.enabled:
        return NULL_SPAN
    return _tracer.span(name, cat, attrs or None)


def count(name: str, n: int = 1, **labels) -> None:
    if not _registry.enabled:
        return
    _registry.counter(name, **labels).inc(n)


def gauge_set(name: str, v: float, **labels) -> None:
    if not _registry.enabled:
        return
    _registry.gauge(name, **labels).set(v)


def gauge_max(name: str, v: float, **labels) -> None:
    if not _registry.enabled:
        return
    _registry.gauge(name, **labels).set_max(v)


def observe(name: str, v: float, **labels) -> None:
    if not _registry.enabled:
        return
    _registry.histogram(name, **labels).observe(v)


def count_op(completion_type) -> None:
    """Interpreter hot-loop counter: one branch when disabled."""
    if not _registry.enabled:
        return
    _registry.counter(
        "jepsen_interpreter_ops_total", type=str(completion_type)
    ).inc()


# -- run anchoring ----------------------------------------------------------


def set_run_anchor() -> None:
    """Record the monotonic instant of the run's t=0 (call inside
    ``util.with_relative_time``) so exports can align span times with
    history op times."""
    if not _tracer.enabled:
        return
    import time as _t

    from ..util import relative_time_nanos

    try:
        _tracer.run_anchor_ns = _t.monotonic_ns() - relative_time_nanos()
    except RuntimeError:
        _tracer.run_anchor_ns = None


def run_anchor_ns() -> Optional[int]:
    return _tracer.run_anchor_ns


def phase_intervals() -> list:
    """Completed lifecycle phases as ``(name, start_s, end_s)`` relative
    to the run anchor (history time axis); empty when no anchor was set
    or tracing is off.  Used by checker.perf's phase overlay."""
    if not _tracer.enabled:
        # disable() doesn't clear the buffer/anchor — without this
        # check an obs-off run following an obs-on run in the same
        # process would overlay the PREVIOUS run's stale phases
        return []
    anchor = _tracer.run_anchor_ns
    if anchor is None:
        return []
    out = []
    for rec in _tracer.finished(cat="phase"):
        if rec.t1 is None:
            continue
        out.append(
            (rec.name, (rec.t0 - anchor) / 1e9, (rec.t1 - anchor) / 1e9)
        )
    out.sort(key=lambda t: t[1])
    return out


# -- exports ----------------------------------------------------------------


def export_all(directory: str) -> dict:
    return export_mod.export_all(_tracer, _registry, directory)


def render_prom() -> str:
    """Live Prometheus exposition text for the process registry — the
    same formatter :func:`export_all`'s ``metrics.prom`` uses."""
    return export_mod.render_prom(_registry)


def summary() -> dict:
    return export_mod.summary(_tracer, _registry)


def format_summary(s: Optional[dict] = None) -> str:
    return export_mod.format_summary(s if s is not None else summary())
