"""MySQL client/server protocol (handshake v10 + COM_QUERY).

The port's copy of :mod:`jepsen_tpu.suites.proto.mysql`.

Backs the tidb, galera, percona, and mysql-cluster suites (the
reference uses clojure.java.jdbc + the MariaDB/MySQL JDBC driver:
tidb/src/tidb/sql.clj, galera/src/jepsen/galera.clj).

Implements packet framing, HandshakeResponse41 with
mysql_native_password (plus auth-switch handling), text-protocol
COM_QUERY result sets, and ERR packets surfaced with their server error
codes (1213 deadlock, 1205 lock wait timeout, …).
"""

from __future__ import annotations

import hashlib
import socket
import struct
from typing import List, Optional, Tuple

from . import IndeterminateError, ProtocolError

CLIENT_LONG_PASSWORD = 0x1
CLIENT_FOUND_ROWS = 0x2  # affected_rows counts matched, not changed, rows
CLIENT_PROTOCOL_41 = 0x200
CLIENT_TRANSACTIONS = 0x2000
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000
CLIENT_CONNECT_WITH_DB = 0x8


class MysqlError(ProtocolError):
    """ERR packet; ``code`` is the server error number."""

    @property
    def retriable(self) -> bool:
        # 1213 ER_LOCK_DEADLOCK, 1205 ER_LOCK_WAIT_TIMEOUT,
        # 8002/8022/9007 TiDB txn retry errors
        return self.code in (1213, 1205, 8002, 8022, 9007)


class MysqlResult:
    def __init__(self):
        self.columns: List[str] = []
        self.rows: List[List[Optional[str]]] = []
        self.affected_rows = 0
        self.last_insert_id = 0


def _native_password(password: str, scramble: bytes) -> bytes:
    """SHA1(pw) XOR SHA1(scramble + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(scramble + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def _lenenc(data: bytes, off: int) -> Tuple[Optional[int], int]:
    """Parse a length-encoded integer → (value-or-None-for-NULL, new off)."""
    first = data[off]
    if first < 0xFB:
        return first, off + 1
    if first == 0xFB:
        return None, off + 1
    if first == 0xFC:
        return struct.unpack("<H", data[off + 1 : off + 3])[0], off + 3
    if first == 0xFD:
        return int.from_bytes(data[off + 1 : off + 4], "little"), off + 4
    return struct.unpack("<Q", data[off + 1 : off + 9])[0], off + 9


class MysqlClient:
    def __init__(
        self,
        host: str,
        port: int = 3306,
        user: str = "root",
        password: str = "",
        database: str = "",
        timeout: float = 10.0,
    ):
        self.host = host
        self.port = port
        self.user = user
        self.password = password
        self.database = database
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self._buf = b""
        self._seq = 0

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

    def _read_packet(self) -> bytes:
        head = self._recv_exact(4)
        ln = int.from_bytes(head[:3], "little")
        self._seq = (head[3] + 1) & 0xFF
        return self._recv_exact(ln)

    def _send_packet(self, payload: bytes) -> None:
        head = len(payload).to_bytes(3, "little") + bytes([self._seq])
        self._seq = (self._seq + 1) & 0xFF
        try:
            self.sock.sendall(head + payload)
        except OSError as e:
            raise IndeterminateError(f"send failed: {e}") from e

    @staticmethod
    def _err(payload: bytes) -> MysqlError:
        code = struct.unpack("<H", payload[1:3])[0]
        msg = payload[3:]
        if msg[:1] == b"#":  # SQL state marker
            msg = msg[6:]
        return MysqlError(msg.decode(errors="replace"), code=code)

    # -- connection --------------------------------------------------------

    def connect(self) -> "MysqlClient":
        self.sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._seq = 0
        greeting = self._read_packet()
        if greeting[:1] == b"\xff":
            raise self._err(greeting)
        # protocol version byte, server version (nul string)
        off = greeting.index(b"\0", 1) + 1
        off += 4  # thread id
        scramble = greeting[off : off + 8]
        off += 8 + 1  # auth data part 1 + filler
        off += 2 + 1 + 2 + 2  # caps low, charset, status, caps high
        auth_len = greeting[off]
        off += 1 + 10  # auth data len + reserved
        scramble += greeting[off : off + max(13, auth_len - 8)].rstrip(b"\0")
        scramble = scramble[:20]

        # FOUND_ROWS makes `UPDATE … WHERE val = old` report matched
        # rows, so a CAS to the same value still counts as applied —
        # without it the SQL register clients would report false
        # linearizability violations when old == new.
        caps = (
            CLIENT_LONG_PASSWORD
            | CLIENT_FOUND_ROWS
            | CLIENT_PROTOCOL_41
            | CLIENT_TRANSACTIONS
            | CLIENT_SECURE_CONNECTION
            | CLIENT_PLUGIN_AUTH
        )
        if self.database:
            caps |= CLIENT_CONNECT_WITH_DB
        auth = _native_password(self.password, scramble)
        payload = struct.pack("<IIB23x", caps, 1 << 24, 33)  # utf8_general_ci
        payload += self.user.encode() + b"\0"
        payload += bytes([len(auth)]) + auth
        if self.database:
            payload += self.database.encode() + b"\0"
        payload += b"mysql_native_password\0"
        self._send_packet(payload)

        reply = self._read_packet()
        if reply[:1] == b"\xfe":  # AuthSwitchRequest
            plugin_end = reply.index(b"\0", 1)
            plugin = reply[1:plugin_end].decode()
            new_scramble = reply[plugin_end + 1 :].rstrip(b"\0")[:20]
            if plugin == "mysql_native_password":
                self._send_packet(_native_password(self.password, new_scramble))
            elif plugin == "mysql_clear_password":
                self._send_packet(self.password.encode() + b"\0")
            else:
                raise ProtocolError(f"unsupported auth plugin {plugin}")
            reply = self._read_packet()
        if reply[:1] == b"\xff":
            raise self._err(reply)
        return self

    def close(self) -> None:
        if self.sock is not None:
            try:
                self._seq = 0
                self._send_packet(b"\x01")  # COM_QUIT
            except Exception:
                pass
            try:
                self.sock.close()
            finally:
                self.sock = None

    # -- queries -----------------------------------------------------------

    def query(self, sql: str) -> MysqlResult:
        """COM_QUERY with the text protocol."""
        if self.sock is None:
            self.connect()
        self._seq = 0
        self._send_packet(b"\x03" + sql.encode())
        first = self._read_packet()
        res = MysqlResult()
        if first[:1] == b"\xff":
            raise self._err(first)
        if first[:1] == b"\x00":  # OK packet
            res.affected_rows, off = _lenenc(first, 1)
            res.last_insert_id, _ = _lenenc(first, off)
            return res
        ncols, _ = _lenenc(first, 0)
        for _ in range(ncols):
            coldef = self._read_packet()
            # catalog, schema, table, org_table, name — all lenenc strings
            off = 0
            for i in range(5):
                ln, off = _lenenc(coldef, off)
                if i == 4:
                    res.columns.append(coldef[off : off + ln].decode())
                off += ln
        pkt = self._read_packet()
        if pkt[:1] == b"\xfe" and len(pkt) < 9:  # EOF before rows
            pkt = self._read_packet()
        while True:
            if pkt[:1] == b"\xff":
                raise self._err(pkt)
            if pkt[:1] == b"\xfe" and len(pkt) < 9:  # EOF/OK: done
                return res
            off, row = 0, []
            while off < len(pkt):
                ln, off = _lenenc(pkt, off)
                if ln is None:
                    row.append(None)
                else:
                    row.append(pkt[off : off + ln].decode(errors="replace"))
                    off += ln
            res.rows.append(row)
            pkt = self._read_packet()
