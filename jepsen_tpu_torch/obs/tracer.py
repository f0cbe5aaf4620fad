"""Span tracer: nestable, thread-aware, bounded, dependency-free — a copy
of :mod:`jepsen_tpu.obs.tracer`.

A span is one timed region of the run — a lifecycle phase, a worker op
invoke, a nemesis fault, a checker, a kernel dispatch.  Spans nest per
thread (each thread keeps its own stack, so a worker's ``op`` span
parents any ``control/exec`` spans the client issues), carry a
category + string attributes, and record monotonic-nanosecond
timestamps so durations are immune to wall-clock steps (the clock
discipline the harness's relative clock uses).

Finished spans land in one bounded, lock-protected buffer.  When the
buffer fills, further spans are *counted as dropped* rather than
grown without limit — a runaway generator can't OOM the harness
through its own telemetry.  Exports (Chrome ``trace_event`` JSON,
span JSONL) read the buffer snapshot; see :mod:`jepsen_tpu_torch.obs.export`.

Cost contract: ``Tracer.span(...)`` when disabled returns a shared
null context — one branch, zero allocation — which is what lets the
interpreter hot loop keep the hook unconditionally.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

#: Span buffer capacity.  ~120 bytes/record ⇒ a full buffer is ~25 MB,
#: bounded regardless of run length.
DEFAULT_MAX_SPANS = 200_000


class SpanRecord:
    """One finished (or live) span.  ``t0``/``t1`` are raw
    ``time.monotonic_ns()`` stamps; exports rebase them on the tracer
    origin (trace-relative) or the run anchor (history-relative)."""

    __slots__ = ("name", "cat", "t0", "t1", "tid", "pid", "attrs", "sid",
                 "parent")

    def __init__(self, name: str, cat: str, tid: int, pid: int,
                 sid: int, parent: Optional[int], attrs: Optional[dict]):
        self.name = name
        self.cat = cat
        self.t0 = time.monotonic_ns()
        self.t1: Optional[int] = None
        self.tid = tid
        self.pid = pid
        self.sid = sid
        self.parent = parent
        self.attrs: Optional[Dict[str, str]] = attrs

    def set(self, k, v) -> None:
        """Attach/overwrite one attribute on the live span."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[str(k)] = str(v)

    def duration_s(self) -> float:
        end = self.t1 if self.t1 is not None else time.monotonic_ns()
        return (end - self.t0) / 1e9

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "cat": self.cat,
            "t0": self.t0,
            "t1": self.t1,
            "tid": self.tid,
            "pid": self.pid,
            "sid": self.sid,
            "parent": self.parent,
            "attrs": self.attrs or {},
        }


class _NullSpan:
    """The shared disabled-mode span: supports the context-manager and
    ``set`` surface with zero allocation.  ``bool(null_span)`` is False
    so call sites can branch on the handle itself."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, k, v):
        pass

    def duration_s(self) -> float:
        return 0.0

    def __bool__(self):
        return False


NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager binding one SpanRecord to the thread's stack."""

    __slots__ = ("_tracer", "_rec")

    def __init__(self, tracer: "Tracer", rec: SpanRecord):
        self._tracer = tracer
        self._rec = rec

    def __enter__(self) -> SpanRecord:
        self._tracer._push(self._rec)
        # re-stamp t0 here so stack bookkeeping isn't inside the
        # measured region
        self._rec.t0 = time.monotonic_ns()
        return self._rec

    def __exit__(self, exc_type, exc, tb):
        rec = self._rec
        rec.t1 = time.monotonic_ns()
        if exc_type is not None:
            rec.set("error", exc_type.__name__)
        self._tracer._pop(rec)
        return False


class Tracer:
    def __init__(self, enabled: bool = True,
                 max_spans: int = DEFAULT_MAX_SPANS):
        self.enabled = enabled
        self.max_spans = max_spans
        self.origin_ns = time.monotonic_ns()
        self.wall_origin = time.time()
        #: monotonic ns of the run's t=0 (util.with_relative_time
        #: entry); lets exports align spans with history op times
        self.run_anchor_ns: Optional[int] = None
        self._lock = threading.Lock()
        self._spans: List[SpanRecord] = []  # jt: guarded-by(_lock)
        self._dropped = 0  # jt: guarded-by(_lock)
        self._next_sid = 0  # jt: guarded-by(_lock)
        self._local = threading.local()  # per-thread by construction

    # -- span lifecycle ----------------------------------------------------

    def span(self, name: str, cat: str = "", attrs: Optional[dict] = None):
        """A context manager recording one span; the shared null span
        when disabled (one branch, no allocation)."""
        if not self.enabled:
            return NULL_SPAN
        stack = self._stack()
        parent = stack[-1].sid if stack else None
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
        rec = SpanRecord(
            name, cat, threading.get_ident(), os.getpid(), sid, parent,
            # str-coerce like SpanRecord.set: attrs must stay
            # JSON-serializable for the exporters no matter what a
            # call site passes (numpy scalars, ops, …)
            {str(k): str(v) for k, v in attrs.items()} if attrs else None,
        )
        return _SpanCtx(self, rec)

    def current(self) -> Optional[SpanRecord]:
        stack = self._stack()
        return stack[-1] if stack else None

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, rec: SpanRecord) -> None:
        self._stack().append(rec)

    def _pop(self, rec: SpanRecord) -> None:
        stack = self._stack()
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:  # tolerate mis-nested exits
            stack.remove(rec)
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(rec)
            else:
                self._dropped += 1

    # -- introspection -----------------------------------------------------

    def finished(self, cat: Optional[str] = None) -> List[SpanRecord]:
        """Snapshot of finished spans, in completion order."""
        with self._lock:
            spans = list(self._spans)
        if cat is not None:
            spans = [s for s in spans if s.cat == cat]
        return spans

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def reset(self) -> None:
        """Drop all recorded spans and re-anchor the trace origin.
        Thread-local stacks are untouched — live spans from other
        threads complete into the fresh buffer."""
        with self._lock:
            self._spans = []
            self._dropped = 0
            self._next_sid = 0
        self.origin_ns = time.monotonic_ns()
        self.wall_origin = time.time()
        self.run_anchor_ns = None
