"""PostgreSQL frontend/backend wire protocol v3, simple-query flavor.

The port's copy of :mod:`jepsen_tpu.suites.proto.pgwire`.

Backs the postgres-rds, stolon, cockroachdb, and yugabyte-YSQL suites
(the reference drives all four through JDBC: e.g.
cockroachdb/src/jepsen/cockroach/client.clj, stolon/src/jepsen/stolon/db.clj).

Implements: StartupMessage, auth (trust / cleartext / MD5 /
SCRAM-SHA-256), the simple Query cycle, and error surfacing with
SQLSTATE codes so callers can classify definite vs indeterminate
failures (serialization failures, unique violations, …).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import socket
import struct
from typing import Any, List, Optional, Tuple

from . import IndeterminateError, ProtocolError


class PgError(ProtocolError):
    """ErrorResponse from the backend; ``code`` is the SQLSTATE."""

    def __init__(self, fields: dict):
        self.fields = fields
        super().__init__(
            f"{fields.get('S', 'ERROR')} {fields.get('C', '?????')}: "
            f"{fields.get('M', '')}",
            code=fields.get("C"),
        )

    @property
    def serialization_failure(self) -> bool:
        # 40001 serialization_failure, 40P01 deadlock_detected
        return self.code in ("40001", "40P01")


class QueryResult:
    def __init__(self):
        self.columns: List[str] = []
        self.rows: List[List[Optional[str]]] = []
        self.command: Optional[str] = None

    def __repr__(self):
        return f"QueryResult(cols={self.columns}, rows={len(self.rows)}, {self.command!r})"


class PgClient:
    def __init__(
        self,
        host: str,
        port: int = 5432,
        user: str = "postgres",
        password: str = "",
        database: str = "postgres",
        timeout: float = 10.0,
        options: Optional[dict] = None,
    ):
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.database = database
        self.timeout = timeout
        self.options = options or {}
        self.sock: Optional[socket.socket] = None
        self._buf = b""
        self.parameters: dict = {}
        self.in_txn = False

    # -- low-level framing -------------------------------------------------

    def _send(self, data: bytes) -> None:
        try:
            self.sock.sendall(data)
        except OSError as e:
            raise IndeterminateError(f"send failed: {e}") from e

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            try:
                chunk = self.sock.recv(65536)
            except (OSError, socket.timeout) as e:
                raise IndeterminateError(f"recv failed: {e}") from e
            if not chunk:
                raise IndeterminateError("connection closed by server")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    def _read_message(self) -> Tuple[bytes, bytes]:
        """→ (type byte, payload)."""
        head = self._recv_exact(5)
        t, ln = head[:1], struct.unpack("!I", head[1:])[0]
        return t, self._recv_exact(ln - 4)

    @staticmethod
    def _msg(t: bytes, payload: bytes) -> bytes:
        return t + struct.pack("!I", len(payload) + 4) + payload

    # -- startup & auth ----------------------------------------------------

    def connect(self) -> "PgClient":
        self.sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        params = {"user": self.user, "database": self.database, **self.options}
        body = struct.pack("!I", 196608)  # protocol 3.0
        for k, v in params.items():
            body += k.encode() + b"\0" + str(v).encode() + b"\0"
        body += b"\0"
        self._send(struct.pack("!I", len(body) + 4) + body)
        self._auth()
        # drain until ReadyForQuery
        while True:
            t, payload = self._read_message()
            if t == b"Z":
                break
            if t == b"E":
                raise PgError(self._parse_error(payload))
            if t == b"S":
                k, v = payload.split(b"\0")[:2]
                self.parameters[k.decode()] = v.decode()
        return self

    def _auth(self) -> None:
        while True:
            t, payload = self._read_message()
            if t == b"E":
                raise PgError(self._parse_error(payload))
            if t != b"R":
                # ParameterStatus etc. may arrive after auth ok; push back
                self._buf = (
                    t + struct.pack("!I", len(payload) + 4) + payload + self._buf
                )
                return
            (kind,) = struct.unpack("!I", payload[:4])
            if kind == 0:  # AuthenticationOk
                return
            if kind == 3:  # CleartextPassword
                self._send(self._msg(b"p", self.password.encode() + b"\0"))
            elif kind == 5:  # MD5Password
                salt = payload[4:8]
                inner = hashlib.md5(
                    self.password.encode() + self.user.encode()
                ).hexdigest()
                digest = (
                    "md5" + hashlib.md5(inner.encode() + salt).hexdigest()
                )
                self._send(self._msg(b"p", digest.encode() + b"\0"))
            elif kind == 10:  # SASL: pick SCRAM-SHA-256
                mechs = payload[4:].split(b"\0")
                if b"SCRAM-SHA-256" not in mechs:
                    raise ProtocolError(f"unsupported SASL mechanisms: {mechs}")
                self._scram()
            else:
                raise ProtocolError(f"unsupported auth request {kind}")

    def _scram(self) -> None:
        """SCRAM-SHA-256 exchange (RFC 5802/7677)."""
        nonce = base64.b64encode(os.urandom(18)).decode()
        first_bare = f"n={self.user},r={nonce}"
        msg = b"SCRAM-SHA-256\0" + struct.pack(
            "!I", len(first_bare) + 3
        ) + b"n,," + first_bare.encode()
        self._send(self._msg(b"p", msg))
        t, payload = self._read_message()
        if t == b"E":
            raise PgError(self._parse_error(payload))
        assert t == b"R" and struct.unpack("!I", payload[:4])[0] == 11
        server_first = payload[4:].decode()
        fields = dict(f.split("=", 1) for f in server_first.split(","))
        r, s, i = fields["r"], fields["s"], int(fields["i"])
        if not r.startswith(nonce):
            raise ProtocolError("SCRAM server nonce mismatch")
        salted = hashlib.pbkdf2_hmac(
            "sha256", self.password.encode(), base64.b64decode(s), i
        )
        client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        stored_key = hashlib.sha256(client_key).digest()
        final_wo_proof = f"c={base64.b64encode(b'n,,').decode()},r={r}"
        auth_msg = f"{first_bare},{server_first},{final_wo_proof}".encode()
        sig = hmac.new(stored_key, auth_msg, hashlib.sha256).digest()
        proof = base64.b64encode(
            bytes(a ^ b for a, b in zip(client_key, sig))
        ).decode()
        self._send(self._msg(b"p", f"{final_wo_proof},p={proof}".encode()))
        t, payload = self._read_message()
        if t == b"E":
            raise PgError(self._parse_error(payload))
        assert t == b"R" and struct.unpack("!I", payload[:4])[0] == 12
        server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
        expect = hmac.new(server_key, auth_msg, hashlib.sha256).digest()
        got = dict(
            f.split("=", 1) for f in payload[4:].decode().split(",")
        ).get("v", "")
        if base64.b64decode(got) != expect:
            raise ProtocolError("SCRAM server signature mismatch")
        # next R message is AuthenticationOk; handled by _auth loop

    @staticmethod
    def _parse_error(payload: bytes) -> dict:
        fields = {}
        for part in payload.split(b"\0"):
            if part:
                fields[chr(part[0])] = part[1:].decode(errors="replace")
        return fields

    # -- queries -----------------------------------------------------------

    def query(self, sql: str) -> QueryResult:
        """Run one simple query; returns rows as text columns.

        Raises PgError for backend errors (definite — the statement did
        not commit, though an explicit COMMIT that errors is still
        definite abort) and IndeterminateError for transport failures.
        """
        if self.sock is None:
            self.connect()
        self._send(self._msg(b"Q", sql.encode() + b"\0"))
        res = QueryResult()
        err: Optional[PgError] = None
        while True:
            t, payload = self._read_message()
            if t == b"T":  # RowDescription
                (ncols,) = struct.unpack("!H", payload[:2])
                off, cols = 2, []
                for _ in range(ncols):
                    end = payload.index(b"\0", off)
                    cols.append(payload[off:end].decode())
                    off = end + 1 + 18
                res.columns = cols
            elif t == b"D":  # DataRow
                (ncols,) = struct.unpack("!H", payload[:2])
                off, row = 2, []
                for _ in range(ncols):
                    (ln,) = struct.unpack("!i", payload[off : off + 4])
                    off += 4
                    if ln < 0:
                        row.append(None)
                    else:
                        row.append(payload[off : off + ln].decode())
                        off += ln
                res.rows.append(row)
            elif t == b"C":  # CommandComplete
                res.command = payload.rstrip(b"\0").decode()
            elif t == b"E":
                err = PgError(self._parse_error(payload))
            elif t == b"Z":  # ReadyForQuery: txn status I/T/E
                self.in_txn = payload[:1] in (b"T", b"E")
                break
            # ignore N (notice), S (parameter), I (empty), K (key data)
        if err is not None:
            raise err
        return res

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.sendall(self._msg(b"X", b""))
            except OSError:
                pass
            try:
                self.sock.close()
            finally:
                self.sock = None


def quote_literal(s: Any) -> str:
    """Escape a value as a SQL string literal."""
    return "'" + str(s).replace("'", "''") + "'"
