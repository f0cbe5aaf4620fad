"""In-process span tracing — the port's copy of :mod:`jepsen_tpu.trace`
(reference: dgraph/src/jepsen/dgraph/trace.clj).

The reference wraps client and nemesis operations in opencensus spans
sampled per a tracer config and exported to a jaeger collector
(trace.clj:9-39).  The same surface here: ``tracing(endpoint)`` turns
sampling on iff a destination is configured, ``with_trace(name)`` wraps
a body in a (nested) span, ``context()`` exposes the current
span/trace ids, and ``annotate``/``attribute`` decorate the live span
(trace.clj:41-73).  Export is a pluggable callable over finished spans;
the default ``JsonlExporter`` appends them to a file — the same
flight-recorder role without an external collector (a jaeger/OTLP
exporter would plug in at this seam).

Spans are tracked per thread (client workers are logically
single-threaded, interpreter.py), so nesting follows each worker's call
stack exactly like the reference's scoped spans.
"""

from __future__ import annotations

import json
import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

_local = threading.local()


def _span_stack() -> list:
    st = getattr(_local, "spans", None)
    if st is None:
        st = _local.spans = []
    return st


def _hex_id(bits: int) -> str:
    return f"{random.getrandbits(bits):0{bits // 4}x}"


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "start", "end", "annotations", "attributes",
    )

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _hex_id(64)
        self.parent_id = parent_id
        self.start = time.time()
        self.end: Optional[float] = None
        self.annotations: List[dict] = []
        self.attributes: Dict[str, str] = {}

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace-id": self.trace_id,
            "span-id": self.span_id,
            "parent-id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "annotations": self.annotations,
            "attributes": self.attributes,
        }


class JsonlExporter:
    """Appends finished spans to a JSONL file (thread-safe)."""

    def __init__(self, path: str):
        self.path = path
        self.lock = threading.Lock()

    def __call__(self, span: Span) -> None:
        line = json.dumps(span.to_dict())
        with self.lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


class Tracer:
    def __init__(
        self,
        sample: bool = False,
        exporter: Optional[Callable[[Span], None]] = None,
    ):
        self.sample = sample
        self.exporter = exporter


#: module-level tracer, configured by tracing(); never-sample default
#: mirrors the reference's Samplers/neverSample fallback (trace.clj:9-14)
_tracer = Tracer()


def tracing(
    endpoint: Optional[str] = None,
    exporter: Optional[Callable[[Span], None]] = None,
) -> dict:
    """Configure global tracing: sampling turns on iff a destination is
    given (reference: trace.clj:35-39 — always-sample when an endpoint
    is provided, never-sample otherwise).  ``endpoint`` names a JSONL
    file path here; pass a custom ``exporter`` callable to ship spans
    elsewhere."""
    global _tracer
    if exporter is None and endpoint:
        exporter = JsonlExporter(endpoint)
    _tracer = Tracer(sample=exporter is not None, exporter=exporter)
    return {"endpoint": endpoint, "config": _tracer.sample,
            "exporter": exporter}


@contextmanager
def with_trace(name: str):
    """Wrap a body in a tracing span (reference: trace.clj:41-49).  A
    no-op when sampling is off."""
    if not _tracer.sample:
        yield None
        return
    stack = _span_stack()
    parent = stack[-1] if stack else None
    span = Span(
        name,
        parent.trace_id if parent else _hex_id(128),
        parent.span_id if parent else None,
    )
    stack.append(span)
    try:
        yield span
    finally:
        span.end = time.time()
        stack.pop()
        if _tracer.exporter is not None:
            _tracer.exporter(span)


def context() -> Dict[str, str]:
    """Current {span-id, trace-id} (reference: trace.clj:51-58); zeros
    outside any span, like an invalid opencensus context."""
    stack = _span_stack()
    if not stack:
        return {"span-id": "0" * 16, "trace-id": "0" * 32}
    span = stack[-1]
    return {"span-id": span.span_id, "trace-id": span.trace_id}


def annotate(message: str) -> None:
    """Annotate the current span (reference: trace.clj:60-64)."""
    stack = _span_stack()
    if stack:
        stack[-1].annotations.append(
            {"time": time.time(), "message": str(message)}
        )


def attribute(k: Any, v: Any) -> None:
    """Set a string attribute on the current span; coerces both sides
    to str (the reference warns opencensus throws on non-strings,
    trace.clj:66-73 — coercion is the friendlier contract)."""
    stack = _span_stack()
    if stack:
        stack[-1].attributes[str(k)] = str(v)


class Traced:
    """Client decorator wrapping every protocol call in a span.

    The reference traces each dgraph client function body individually
    (dgraph/client.clj:55-377 wraps open!/close!/mutate/query/... in
    with-trace).  One wrapper at the Client-protocol seam covers every
    client flavor of a suite instead, and tags invoke spans with the
    op's :f (and key, when the value is an independent [k v] tuple)."""

    def __init__(self, client):
        self.client = client

    def open(self, test, node):
        with with_trace("client.open"):
            attribute("node", node)
            opened = self.client.open(test, node)
        return Traced(opened) if opened is not self.client else self

    def setup(self, test):
        with with_trace("client.setup"):
            return self.client.setup(test)

    def invoke(self, test, op):
        with with_trace("client.invoke"):
            attribute("f", op.get("f"))
            v = op.get("value")
            # tag independent [k v] pairs only — a 2-micro-op txn is
            # also a 2-element sequence, but its head is a micro-op
            # list, not a scalar key
            if (
                isinstance(v, (list, tuple))
                and len(v) == 2
                and not isinstance(v[0], (list, tuple, dict))
            ):
                attribute("key", v[0])
            return self.client.invoke(test, op)

    def teardown(self, test):
        with with_trace("client.teardown"):
            return self.client.teardown(test)

    def close(self, test):
        with with_trace("client.close"):
            return self.client.close(test)

    def reusable(self, test):
        inner = getattr(self.client, "reusable", None)
        return bool(inner and inner(test))


def wire(test: dict, endpoint: Optional[str]) -> dict:
    """Wire span tracing into a built test map: record the endpoint
    (core.run configures the global tracer from it at run start, and
    unconfigures it at run end) and wrap the client so every protocol
    call gets a span.  With no endpoint the test map is untouched —
    untraced runs pay nothing."""
    if endpoint:
        test["tracing"] = endpoint
        test["client"] = Traced(test["client"])
    return test
