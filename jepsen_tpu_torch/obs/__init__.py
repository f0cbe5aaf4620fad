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

Not ported: ``count_op``, ``set_run_anchor`` and ``phase_intervals``
serve the test harness's interpreter and run phases.
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
