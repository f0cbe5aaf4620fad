"""Cross-process trace propagation: the ``trace_ctx`` wire form and the
adoption of remote spans — a copy of :mod:`jepsen_tpu.obs.propagate`.

A run that goes through the checker service crosses two processes, each
with its own tracer.  This module joins them:

- :func:`make_ctx` mints a ``trace_ctx`` — a random 64-bit trace id plus
  the client span's id — that the service client puts on its ``/check``
  and ``/elle`` bodies (:mod:`jepsen_tpu_torch.serve.protocol`);
- :func:`parse_ctx` validates it on the daemon, which tags its request,
  batch and dispatch spans with the trace id so ``GET /trace?ctx=`` can
  slice its span buffer per run;
- :func:`adopt` stores the daemon's span dicts fetched after a request,
  and :func:`jepsen_tpu_torch.obs.export.chrome_trace` merges them into
  the client's Chrome trace, aligned by wall clock and joined with flow
  events.

Plain dict plumbing: no sockets, no tracer mutation.
"""

from __future__ import annotations

import os
import secrets
import threading
from typing import Any, Dict, List, Optional

#: wire keys of a trace_ctx
CTX_KEYS = ("trace_id", "parent_sid")

#: span attributes the two sides stamp
ATTR_TRACE_ID = "trace_id"
ATTR_TRACE_IDS = "trace_ids"  # comma-joined, on shared (coalesced) spans
ATTR_ROLE = "ctx_role"  # "client" | "daemon"

_lock = threading.Lock()
#: adopted remote span dicts, with their alignment metadata
_remote: List[Dict[str, Any]] = []


def new_trace_id() -> str:
    """A random 64-bit hex trace id (a valid Chrome flow-event id)."""
    return secrets.token_hex(8)


def make_ctx(parent_sid: int = 0,
             trace_id: Optional[str] = None) -> Dict[str, Any]:
    """A trace_ctx for one request through the service."""
    return {"trace_id": trace_id or new_trace_id(),
            "parent_sid": int(parent_sid)}


def parse_ctx(obj: Any) -> Optional[Dict[str, Any]]:
    """The validated trace_ctx of a request body; None when absent or
    malformed (propagation never fails a check)."""
    if not isinstance(obj, dict):
        return None
    tid = obj.get("trace_id")
    if not isinstance(tid, str) or not 1 <= len(tid) <= 64:
        return None
    if not all(c in "0123456789abcdef" for c in tid):
        return None
    try:
        psid = int(obj.get("parent_sid", 0))
    except (TypeError, ValueError):
        return None
    return {"trace_id": tid, "parent_sid": psid}


def span_matches(span_dict: Dict[str, Any], trace_id: str) -> bool:
    """Whether a finished-span dict belongs to ``trace_id``: by its
    ``trace_id`` attribute, or as a member of the comma-joined
    ``trace_ids`` a coalesced daemon span carries."""
    attrs = span_dict.get("attrs") or {}
    if attrs.get(ATTR_TRACE_ID) == trace_id:
        return True
    ids = attrs.get(ATTR_TRACE_IDS)
    return isinstance(ids, str) and trace_id in ids.split(",")


def adopt(rows: List[Dict[str, Any]], *, pid: Optional[int] = None,
          wall_origin: Optional[float] = None,
          origin_ns: Optional[int] = None) -> int:
    """Store remote span dicts for this process's export.  ``pid``,
    ``wall_origin`` and ``origin_ns`` come with the daemon's ``/trace``
    payload and let the exporter rebase its monotonic timestamps.  Rows
    from this very process are refused (an in-process daemon shares the
    tracer: its spans are already local).  Returns the rows adopted."""
    if pid is not None and pid == os.getpid():
        return 0
    kept = []
    for r in rows:
        if not isinstance(r, dict) or "name" not in r:
            continue
        rec = dict(r)
        rec["_remote_pid"] = pid
        rec["_remote_wall_origin"] = wall_origin
        rec["_remote_origin_ns"] = origin_ns
        kept.append(rec)
    with _lock:
        _remote.extend(kept)
    return len(kept)


def adopted() -> List[Dict[str, Any]]:
    """A snapshot of the adopted remote spans."""
    with _lock:
        return list(_remote)


def reset() -> None:
    """Drop the adopted spans (``obs.reset`` / ``obs.enable(reset=True)``)."""
    with _lock:
        _remote.clear()
