"""A Dgraph stand-in that honours the schema's ``int`` type:
``fake_servers.FakeDgraph`` whose query answers give the predicates
``/alter`` declared ``int`` as JSON numbers.

Dgraph stores a value of an ``int`` predicate as an integer and answers
queries of it with a JSON number, however the mutation spelled it (the
suite's n-quads write ``<value> "5"``).  ``FakeDgraph`` ignores the
schema and answers with the string it stored, so the dgraph suite's
register client reads ``"5"`` after writing ``5`` and the cas-register
model calls every run invalid, in both packages.  ``TypedDgraph`` records
the ``int`` predicates of each ``/alter`` and turns their values in
``/query`` answers into numbers; everything else is ``FakeDgraph``'s,
unchanged.  Stdlib only, like ``fake_servers``.
"""

from __future__ import annotations

import re
from urllib.parse import urlparse

from fake_servers import FakeDgraph, _DgraphHandler

_INT_PRED = re.compile(r"^\s*([\w.]+)\s*:\s*int\b", re.M)


class _TypedDgraphHandler(_DgraphHandler):
    def _path(self) -> str:
        return urlparse(self.path).path

    def _body(self) -> bytes:
        raw = super()._body()
        if self._path() == "/alter":
            with self.fake_store.lock:
                self.fake_store.kv.setdefault("int_preds", set()).update(
                    _INT_PRED.findall(raw.decode()))
        return raw

    def _send(self, obj, status=200):
        # called under the store's lock (FakeDgraph.do_POST holds it)
        rows = (obj.get("data") or {}).get("q") if (
            self._path() == "/query" and isinstance(obj, dict)) else None
        ints = self.fake_store.kv.get("int_preds", ())
        for row in rows or ():
            for pred, v in row.items():
                if pred in ints and isinstance(v, str) and \
                        re.fullmatch(r"-?\d+", v):
                    row[pred] = int(v)
        super()._send(obj, status)


class TypedDgraph(FakeDgraph):
    handler_class = _TypedDgraphHandler
