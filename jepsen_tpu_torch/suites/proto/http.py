"""JSON-over-HTTP helper on http.client.

The port's copy of :mod:`jepsen_tpu.suites.proto.http`.

Backs every suite whose database speaks REST: etcd (v3 gRPC-gateway +
v2 keys API), consul KV, elasticsearch, crate (_sql), dgraph, faunadb,
chronos, hazelcast, ignite.  (The reference uses clj-http / verschlimmbesserung
/ per-DB JVM clients for these.)

One persistent connection per client; requests and replies are JSON
unless raw bytes are requested.
"""

from __future__ import annotations

import http.client
import json
import socket
from typing import Any, Dict, Optional, Tuple
from urllib.parse import urlencode

from . import IndeterminateError, ProtocolError


class HttpError(ProtocolError):
    def __init__(self, status: int, body: Any):
        super().__init__(f"HTTP {status}: {body!r}", code=status)
        self.status = status
        self.body = body


class JsonHttpClient:
    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.conn: Optional[http.client.HTTPConnection] = None

    def connect(self) -> "JsonHttpClient":
        self.conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        self.conn.connect()
        return self

    def close(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def request(
        self,
        method: str,
        path: str,
        body: Any = None,
        params: Optional[Dict[str, Any]] = None,
        headers: Optional[Dict[str, str]] = None,
        form: bool = False,
        ok: Tuple[int, ...] = (200, 201, 204),
        raise_on_error: bool = True,
    ) -> Tuple[int, Any]:
        """One request → (status, parsed-JSON-or-text body).

        A transport failure *after* the request may have applied server
        side, so it raises IndeterminateError; a clean non-2xx status is
        a definite HttpError (unless raise_on_error=False).
        """
        if self.conn is None:
            self.connect()
        if params:
            path = f"{path}?{urlencode(params)}"
        hdrs = dict(headers or {})
        payload = None
        if body is not None:
            if form:
                payload = urlencode(body)
                hdrs.setdefault("Content-Type", "application/x-www-form-urlencoded")
            elif isinstance(body, (bytes, str)):
                payload = body
            else:
                payload = json.dumps(body)
                hdrs.setdefault("Content-Type", "application/json")
        try:
            self.conn.request(method, path, body=payload, headers=hdrs)
            resp = self.conn.getresponse()
            raw = resp.read()
            status = resp.status
        except (OSError, socket.timeout, http.client.HTTPException) as e:
            # connection state unknown; drop it so the next call redials
            self.close()
            raise IndeterminateError(f"http {method} {path} failed: {e}") from e
        try:
            parsed = json.loads(raw) if raw else None
        except ValueError:
            parsed = raw.decode(errors="replace")
        if raise_on_error and status not in ok:
            raise HttpError(status, parsed)
        return status, parsed

    # convenience verbs
    def get(self, path: str, **kw) -> Tuple[int, Any]:
        return self.request("GET", path, **kw)

    def put(self, path: str, body: Any = None, **kw) -> Tuple[int, Any]:
        return self.request("PUT", path, body=body, **kw)

    def post(self, path: str, body: Any = None, **kw) -> Tuple[int, Any]:
        return self.request("POST", path, body=body, **kw)

    def delete(self, path: str, **kw) -> Tuple[int, Any]:
        return self.request("DELETE", path, **kw)
