"""Wire protocol of the resident checker service — a copy of
:mod:`jepsen_tpu.serve.protocol`, byte for byte on the wire: the same
request built by either package encodes to the same bytes, so a client of
one speaks to a daemon of the other.

JSON with tuples (the reference's ``codec``: a tuple crosses as
``{"__tuple__": [...]}``) over local HTTP.  Endpoints:

- ``POST /check`` — ``{"model": <wire model>, "histories": [[<op dict>,
  ...], ...], "opts": {...}}`` → ``{"results": [...], "diag": {...}}``;
  the results are the dicts ``wgl.check_batch`` returns for the batch.
- ``POST /elle`` — encoded dependency graphs → their screen masks.
- ``GET /healthz``, ``GET /status``, ``GET /metrics`` (Prometheus text),
  ``GET /trace?ctx=``, ``POST /profile``, ``POST /shutdown`` (drain, then
  stop).
- ``POST /feed`` (streaming ingest) has its request builders here, so
  the module is whole, but the port's daemon does not serve it yet.

A model travels by its state; one without a wire form makes
:func:`model_to_wire` raise :class:`UnsupportedModel`, and the client
runs that batch in-process.  ``opts`` keys are ``check_batch``'s keyword
arguments in :data:`CHECK_OPTS`; a budgeted oracle search
(``oracle_budget_s``) is a wall-clock deadline that assumes the run's own
serial drain, so such runs stay in-process.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..history import History

#: default TCP port of the local daemon (loopback only)
DEFAULT_PORT = 8519
DEFAULT_HOST = "127.0.0.1"

#: check_batch keyword arguments a client may send
CHECK_OPTS = (
    "frontier", "slot_cap", "max_closure", "escalation",
    "oracle_fallback", "sufficient_rung", "max_dispatch",
)


class UnsupportedModel(ValueError):
    """The model's state cannot cross the wire: run the batch
    in-process."""


# -- the codec: JSON with tuples ----------------------------------------------


#: leaves the codec passes through as they are (a subclass takes the
#: general path, with the same result)
_LEAVES = frozenset((str, int, float, bool, type(None)))


def _encode_value(v: Any) -> Any:
    """Tuples as ``{"__tuple__": [...]}``, dict keys as strings, the rest
    as it is.  Leaves are tested by exact type first: a body of a million
    op fields makes no call per leaf."""
    if isinstance(v, tuple):
        return {"__tuple__": [x if type(x) in _LEAVES else _encode_value(x)
                              for x in v]}
    if isinstance(v, list):
        return [x if type(x) in _LEAVES else _encode_value(x) for x in v]
    if isinstance(v, dict):
        return {str(k): x if type(x) in _LEAVES else _encode_value(x)
                for k, x in v.items()}
    return v


def _decode_object(d: dict) -> Any:
    """``json.loads``' object hook: a ``{"__tuple__": [...]}`` object is a
    tuple (its items are decoded already, inside out)."""
    if len(d) == 1 and "__tuple__" in d:
        return tuple(d["__tuple__"])
    return d


def encode_body(payload: Any) -> bytes:
    if payload is None:
        return b""
    return json.dumps(_encode_value(payload)).encode()


def decode_body(data: bytes) -> Any:
    if not data:
        return None
    return json.loads(data.decode(), object_hook=_decode_object)


# -- models ---------------------------------------------------------------------


def _plain(v):
    """Reject state the codec would mangle (sets, objects, non-string
    dict keys — JSON stringifies those silently), so such a model falls
    back instead of arriving as a different one."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if isinstance(v, dict):
        for k in v:
            if not isinstance(k, str):
                raise UnsupportedModel(
                    f"non-string dict key in model state: {k!r}")
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, frozenset):
        # order-free state (the unordered queue): a sorted list
        return sorted((_plain(x) for x in v), key=repr)
    raise UnsupportedModel(f"unserializable model state: {v!r}")


def _kv_pairs(d: dict) -> list:
    """A state dict with arbitrary keys as a sorted ``[key, value]`` pair
    list: through a JSON object ``{0: 0}`` would come back ``{"0": 0}``,
    a different model."""
    return sorted(([_plain(k), _plain(v)] for k, v in d.items()), key=repr)


def _from_kv_pairs(pairs) -> dict:
    return {tuple(k) if isinstance(k, list) else k: v for k, v in pairs}


def model_to_wire(model) -> dict:
    """A model's wire form; raises :class:`UnsupportedModel` for a model
    with none."""
    from .. import models as m
    from ..models import locks as lock_models

    if isinstance(model, m.Register) and not isinstance(model, m.CASRegister):
        return {"type": "register", "value": _plain(model.value)}
    if isinstance(model, m.CASRegister):
        return {"type": "cas-register", "value": _plain(model.value)}
    if type(model) is m.Mutex:
        return {"type": "mutex", "locked": bool(model.locked)}
    if isinstance(model, m.MultiRegister):
        return {"type": "multi-register",
                "values": _kv_pairs(model._as_dict())}
    if isinstance(model, m.FIFOQueue):
        return {"type": "fifo-queue", "items": _plain(list(model.items))}
    if isinstance(model, m.UnorderedQueue):
        return {"type": "unordered-queue", "items": _plain(model.items)}
    if type(model) is m.MultiMutex:
        return {"type": "multi-mutex", "held": _plain(model.held)}
    if type(model) is lock_models.OwnerMutex:
        return {"type": "owner-mutex", "owner": _plain(model.owner)}
    raise UnsupportedModel(
        f"no wire form for model {type(model).__name__}; "
        "the client runs this batch in-process"
    )


def model_from_wire(d: dict):
    from .. import models as m
    from ..models import locks as lock_models

    t = d.get("type")
    if t == "register":
        return m.register(d.get("value"))
    if t == "cas-register":
        return m.cas_register(d.get("value"))
    if t == "mutex":
        return m.mutex() if not d.get("locked") else m.Mutex(True)
    if t == "multi-register":
        return m.multi_register(_from_kv_pairs(d.get("values") or []))
    if t == "fifo-queue":
        return m.FIFOQueue(tuple(d.get("items") or ()))
    if t == "unordered-queue":
        return m.UnorderedQueue(frozenset(d.get("items") or ()))
    if t == "multi-mutex":
        return m.MultiMutex(frozenset(d.get("held") or ()))
    if t == "owner-mutex":
        return lock_models.OwnerMutex(d.get("owner"))
    raise UnsupportedModel(f"unknown wire model type {t!r}")


# -- histories and results ------------------------------------------------------


def histories_to_wire(histories) -> List[list]:
    return [h.to_dicts() for h in histories]


def histories_from_wire(dicts: List[list]) -> List[History]:
    return [History.from_dicts(ds) for ds in dicts]


def sanitize_results(results: List[Optional[dict]]) -> List[dict]:
    """Engine result dicts made wire-safe: JSON leaves pass untouched
    (byte-equality with the in-process path depends on it), anything
    exotic an oracle analysis attached degrades to its repr."""
    return [{k: _wire_safe(v) for k, v in (r or {}).items()}
            for r in results]


def _wire_safe(v):
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return type(v)(_wire_safe(x) for x in v)
    if isinstance(v, dict):
        return {str(k): _wire_safe(x) for k, x in v.items()}
    try:  # numpy scalars
        import numpy as np

        if isinstance(v, np.generic):
            return v.item()
    except Exception:  # noqa: BLE001 — repr below
        pass
    return repr(v)


def request_id() -> str:
    """A fresh idempotent request id: the client mints one per logical
    request and sends it unchanged on every retry, so the daemon answers
    a retry from its cache and keys the request's WAL rows by it."""
    import uuid

    return uuid.uuid4().hex


def _check_opts_to_wire(opts: Optional[Dict[str, Any]]) -> dict:
    """Validate and normalise serviceable check opts."""
    wire_opts = {}
    for k, v in (opts or {}).items():
        if k not in CHECK_OPTS:
            raise UnsupportedModel(f"opt {k!r} is not serviceable")
        if k == "escalation" and v is not None:
            v = list(v)
        wire_opts[k] = v
    return wire_opts


def check_request(model, histories, opts: Optional[Dict[str, Any]] = None,
                  trace_ctx: Optional[Dict[str, Any]] = None,
                  req: Optional[str] = None) -> bytes:
    """A ``POST /check`` body; raises :class:`UnsupportedModel` when the
    model or an opt has no wire form.  ``trace_ctx``
    (:mod:`..obs.propagate`) only tags the daemon's spans; ``req`` is the
    idempotent request id (:func:`request_id`)."""
    body = {
        "model": model_to_wire(model),
        "histories": histories_to_wire(histories),
        "opts": _check_opts_to_wire(opts),
    }
    if trace_ctx:
        body["trace_ctx"] = dict(trace_ctx)
    if req:
        body["req"] = req
    return encode_body(body)


# -- the Elle screens -------------------------------------------------------------


class WireGraph:
    """The daemon's view of one encoded screen graph: the shape
    ``ops.cycles.screen_graphs`` takes (the client side holds
    :class:`jepsen_tpu_torch.elle.encode.EncodedGraph`)."""

    __slots__ = ("rel", "n", "masks", "nonadj")

    def __init__(self, rel, masks, nonadj):
        import numpy as np

        self.rel = np.asarray(rel, dtype=np.uint8)
        self.n = self.rel.shape[0]
        self.masks = tuple(int(m) for m in masks)
        self.nonadj = tuple((int(w), int(r)) for w, r in nonadj)


def elle_request(encs, trace_ctx: Optional[Dict[str, Any]] = None,
                 req: Optional[str] = None) -> bytes:
    """A ``POST /elle`` body from encoded graphs: per graph its uint8
    relation-bit matrix and its canonical filter profile."""
    import numpy as np

    body = {
        "graphs": [
            {
                "rel": np.asarray(enc.rel).astype(np.int64).tolist(),
                "masks": list(enc.masks),
                "nonadj": [list(p) for p in enc.nonadj],
            }
            for enc in encs
        ],
    }
    if trace_ctx:
        body["trace_ctx"] = dict(trace_ctx)
    if req:
        body["req"] = req
    return encode_body(body)


def elle_graphs_from_wire(items) -> List[WireGraph]:
    return [WireGraph(g["rel"], g.get("masks") or (), g.get("nonadj") or ())
            for g in items]


def elle_results_to_wire(results) -> list:
    """Per-graph screen masks as JSON, aligned with the request's sorted
    masks and nonadj pairs; ``None`` (a graph no dispatch can take)
    crosses as null and stays on the client's CPU path."""
    out = []
    for r in results:
        if r is None:
            out.append(None)
            continue
        out.append({
            "members": [[int(b) for b in r.members[m]]
                        for m in sorted(r.members)],
            "walks": [[int(b) for b in r.walks[q]] for q in sorted(r.walks)],
        })
    return out


def elle_results_from_wire(items, encs) -> list:
    """The client's inverse of :func:`elle_results_to_wire`, keyed by each
    graph's own sorted masks (both sides sort independently)."""
    import numpy as np

    from ..ops.cycles import ScreenResult

    out = []
    for enc, item in zip(encs, items):
        if item is None:
            out.append(None)
            continue
        members = {m: np.asarray(row, dtype=bool)
                   for m, row in zip(sorted(enc.masks), item["members"])}
        walks = {q: np.asarray(row, dtype=bool)
                 for q, row in zip(sorted(enc.nonadj), item["walks"])}
        out.append(ScreenResult(members, walks))
    return out


# -- the feed (streaming ingest) ---------------------------------------------------


def feed_open_request(model, opts: Optional[Dict[str, Any]] = None,
                      trace_ctx: Optional[Dict[str, Any]] = None,
                      req: Optional[str] = None) -> bytes:
    """A ``POST /feed`` session-open body (``req`` doubles as the
    session's WAL run id)."""
    body = {
        "op": "open",
        "model": model_to_wire(model),
        "opts": _check_opts_to_wire(opts),
    }
    if trace_ctx:
        body["trace_ctx"] = dict(trace_ctx)
    if req:
        body["req"] = req
    return encode_body(body)


def feed_append_request(session: str, seq: int, histories=None, ops=None,
                        t_inv: Optional[float] = None) -> bytes:
    """A ``POST /feed`` delta body: ``seq`` is session-monotonic (a
    retried append acks without re-dispatch); whole ``histories`` and/or
    raw op dicts ``ops``; ``t_inv`` the wall-clock invoke time of the
    delta's oldest op."""
    body: Dict[str, Any] = {"op": "append", "session": session,
                            "seq": int(seq)}
    if histories:
        body["histories"] = histories_to_wire(histories)
    if ops:
        body["ops"] = list(ops)
    if t_inv is not None:
        body["t_inv"] = float(t_inv)
    return encode_body(body)


def feed_close_request(session: str, seq: int,
                       req: Optional[str] = None) -> bytes:
    """A ``POST /feed`` session-close body (``req`` keys the close
    response in the retry cache)."""
    body: Dict[str, Any] = {"op": "close", "session": session,
                            "seq": int(seq)}
    if req:
        body["req"] = req
    return encode_body(body)
