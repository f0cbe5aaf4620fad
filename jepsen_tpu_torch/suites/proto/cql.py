"""Cassandra CQL binary protocol v4 — the port's copy of
:mod:`jepsen_tpu.suites.proto.cql`.

Backs the yugabyte YCQL workloads (the reference uses the cassaforte /
DataStax Java driver: yugabyte/src/yugabyte/ycql/client.clj).
Implements STARTUP/READY, QUERY with text-format values, RESULT
decoding (void / rows / set_keyspace), and ERROR frames surfaced with
their CQL error codes so callers can separate definite failures
(invalid query, already-exists) from timeouts (write_timeout 0x1100,
read_timeout 0x1200 → indeterminate).
"""

from __future__ import annotations

import socket
import struct
from typing import List, Optional, Tuple

from . import IndeterminateError, ProtocolError

VERSION_REQ = 0x04
VERSION_RESP = 0x84

OP_ERROR, OP_STARTUP, OP_READY, OP_QUERY, OP_RESULT = 0x00, 0x01, 0x02, 0x07, 0x08

CONSISTENCY = {
    "one": 0x0001,
    "quorum": 0x0004,
    "all": 0x0005,
    "serial": 0x0008,
    "local-one": 0x000A,
}

WRITE_TIMEOUT, READ_TIMEOUT = 0x1100, 0x1200


class CqlError(ProtocolError):
    @property
    def timeout(self) -> bool:
        return self.code in (WRITE_TIMEOUT, READ_TIMEOUT)


class CqlResult:
    def __init__(self):
        self.columns: List[str] = []
        self.col_types: List[int] = []  # CQL option ids per column
        self.rows: List[List[Optional[bytes]]] = []
        self.kind: str = "void"

    def cell_int(self, row: List[Optional[bytes]], i: int) -> Optional[int]:
        """Decode column i of a row as an integer, honouring the
        column's wire type (fixed-width ints vs text)."""
        cell = row[i]
        if cell is None:
            return None
        t = self.col_types[i] if i < len(self.col_types) else 0x000D
        if t in (0x0002, 0x0009, 0x0013, 0x0014):  # bigint/int/small/tiny
            return int.from_bytes(cell, "big", signed=True)
        return int(cell.decode())

    def cell_bool(self, row: List[Optional[bytes]], i: int) -> Optional[bool]:
        cell = row[i]
        if cell is None:
            return None
        t = self.col_types[i] if i < len(self.col_types) else 0x000D
        if t == 0x0004:  # boolean
            return cell != b"\x00"
        return cell.decode().lower() in ("true", "1")


class CqlClient:
    def __init__(self, host: str, port: int = 9042, timeout: float = 10.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self._buf = b""
        self._stream = 0

    # -- framing -----------------------------------------------------------

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

    def _send_frame(self, opcode: int, body: bytes) -> None:
        self._stream = (self._stream + 1) % 0x7FFF
        header = struct.pack(
            "!BBhBI", VERSION_REQ, 0, self._stream, opcode, len(body)
        )
        try:
            self.sock.sendall(header + body)
        except OSError as e:
            raise IndeterminateError(f"send failed: {e}") from e

    def _read_frame(self) -> Tuple[int, bytes]:
        header = self._recv_exact(9)
        _v, _flags, _stream, opcode, ln = struct.unpack("!BBhBI", header)
        return opcode, self._recv_exact(ln)

    # -- connection --------------------------------------------------------

    def connect(self) -> "CqlClient":
        self.sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # STARTUP: string map {"CQL_VERSION": "3.0.0"}
        k, v = b"CQL_VERSION", b"3.0.0"
        body = struct.pack("!H", 1)
        body += struct.pack("!H", len(k)) + k + struct.pack("!H", len(v)) + v
        self._send_frame(OP_STARTUP, body)
        opcode, payload = self._read_frame()
        if opcode == OP_ERROR:
            raise self._error(payload)
        if opcode != OP_READY:
            raise ProtocolError(f"expected READY, got opcode {opcode:#x}")
        return self

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None

    @staticmethod
    def _error(payload: bytes) -> CqlError:
        (code,) = struct.unpack("!I", payload[:4])
        (n,) = struct.unpack("!H", payload[4:6])
        return CqlError(payload[6 : 6 + n].decode(errors="replace"), code=code)

    # -- queries -----------------------------------------------------------

    def query(self, cql: str, consistency: str = "quorum") -> CqlResult:
        if self.sock is None:
            self.connect()
        q = cql.encode()
        body = struct.pack("!I", len(q)) + q
        body += struct.pack("!HB", CONSISTENCY[consistency], 0)
        self._send_frame(OP_QUERY, body)
        opcode, payload = self._read_frame()
        if opcode == OP_ERROR:
            raise self._error(payload)
        if opcode != OP_RESULT:
            raise ProtocolError(f"expected RESULT, got opcode {opcode:#x}")
        return self._decode_result(payload)

    def _decode_result(self, payload: bytes) -> CqlResult:
        res = CqlResult()
        (kind,) = struct.unpack("!I", payload[:4])
        if kind == 1:
            res.kind = "void"
            return res
        if kind == 3:
            res.kind = "set_keyspace"
            return res
        if kind != 2:
            res.kind = f"kind-{kind}"
            return res
        res.kind = "rows"
        flags, ncols = struct.unpack("!II", payload[4:12])
        off = 12
        if flags & 0x0001:  # global tables spec: ks + table
            for _ in range(2):
                (n,) = struct.unpack("!H", payload[off : off + 2])
                off += 2 + n
        for _ in range(ncols):
            if not flags & 0x0001:
                for _ in range(2):
                    (n,) = struct.unpack("!H", payload[off : off + 2])
                    off += 2 + n
            (n,) = struct.unpack("!H", payload[off : off + 2])
            res.columns.append(payload[off + 2 : off + 2 + n].decode())
            off += 2 + n
            (t,) = struct.unpack("!H", payload[off : off + 2])
            off += 2
            res.col_types.append(t)
            if t == 0x0000:  # custom: string class name
                (n,) = struct.unpack("!H", payload[off : off + 2])
                off += 2 + n
            elif t in (0x0020, 0x0022):  # list/set: one inner type
                off += 2
            elif t == 0x0021:  # map: two inner types
                off += 4
        (nrows,) = struct.unpack("!I", payload[off : off + 4])
        off += 4
        for _ in range(nrows):
            row = []
            for _ in range(ncols):
                (n,) = struct.unpack("!i", payload[off : off + 4])
                off += 4
                if n < 0:
                    row.append(None)
                else:
                    row.append(payload[off : off + n])
                    off += n
            res.rows.append(row)
        return res


def int_value(cell: Optional[bytes]) -> Optional[int]:
    """Decode a bigint/int cell."""
    if cell is None:
        return None
    return int.from_bytes(cell, "big", signed=True)


def text_value(cell: Optional[bytes]) -> Optional[str]:
    if cell is None:
        return None
    return cell.decode()
