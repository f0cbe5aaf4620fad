"""ZooKeeper client protocol (jute serialization over TCP).

The port's copy of :mod:`jepsen_tpu.suites.proto.zk`.

Backs the zookeeper suite (the reference uses the Curator/avout JVM
stack: zookeeper/src/jepsen/zookeeper.clj).  Implements the session
handshake (ConnectRequest/Response), the length-prefixed jute framing,
and the request types the workloads need: create, getData, setData
(with compare-and-set via version), delete, exists, getChildren.

Jute primitives: int/long are big-endian; ustring and buffer are
4-byte-length-prefixed (length -1 = null); vectors are count-prefixed.
"""

from __future__ import annotations

import socket
import struct
from typing import List, Optional, Tuple

from . import IndeterminateError, ProtocolError

# request types (org.apache.zookeeper.ZooDefs.OpCode)
CREATE, DELETE, EXISTS, GET_DATA, SET_DATA, GET_CHILDREN = 1, 2, 3, 4, 5, 8
PING, CLOSE = 11, -11

# error codes (KeeperException.Code)
OK = 0
NO_NODE = -101
BAD_VERSION = -103
NODE_EXISTS = -110
CONNECTION_LOSS = -4

ERR_NAMES = {
    NO_NODE: "NoNode",
    BAD_VERSION: "BadVersion",
    NODE_EXISTS: "NodeExists",
    CONNECTION_LOSS: "ConnectionLoss",
}

# world-readable-writable ACL: perms=31 (ALL), scheme "world", id "anyone"
OPEN_ACL = [(31, "world", "anyone")]


class ZkError(ProtocolError):
    def __init__(self, code: int):
        super().__init__(
            f"zookeeper error {ERR_NAMES.get(code, code)}", code=code
        )


class Stat:
    """The subset of jute Stat the workloads use."""

    __slots__ = ("czxid", "mzxid", "version")

    def __init__(self, czxid: int, mzxid: int, version: int):
        self.czxid = czxid
        self.mzxid = mzxid
        self.version = version

    def __repr__(self):
        return f"Stat(version={self.version})"


def _buffer(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack("!i", -1)
    return struct.pack("!i", len(b)) + b


def _ustring(s: str) -> bytes:
    return _buffer(s.encode())


def _read_buffer(data: bytes, off: int) -> Tuple[Optional[bytes], int]:
    (n,) = struct.unpack("!i", data[off : off + 4])
    off += 4
    if n < 0:
        return None, off
    return data[off : off + n], off + n


def _read_stat(data: bytes, off: int) -> Tuple[Stat, int]:
    # czxid mzxid ctime mtime version cversion aversion ephemeralOwner
    # dataLength numChildren pzxid
    czxid, mzxid, _ct, _mt, version = struct.unpack(
        "!qqqqi", data[off : off + 36]
    )
    return Stat(czxid, mzxid, version), off + 36 + 4 + 4 + 8 + 4 + 4 + 8


class ZkClient:
    def __init__(
        self,
        host: str,
        port: int = 2181,
        timeout: float = 10.0,
        session_timeout_ms: int = 10000,
    ):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.session_timeout_ms = session_timeout_ms
        self.sock: Optional[socket.socket] = None
        self._buf = b""
        self._xid = 0
        self.session_id = 0

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

    def _send_frame(self, payload: bytes) -> None:
        try:
            self.sock.sendall(struct.pack("!i", len(payload)) + payload)
        except OSError as e:
            raise IndeterminateError(f"send failed: {e}") from e

    def _read_frame(self) -> bytes:
        (n,) = struct.unpack("!i", self._recv_exact(4))
        return self._recv_exact(n)

    # -- session -----------------------------------------------------------

    def connect(self) -> "ZkClient":
        self.sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        req = struct.pack("!iqiq", 0, 0, self.session_timeout_ms, 0) + _buffer(
            b"\0" * 16
        )
        self._send_frame(req)
        resp = self._read_frame()
        _proto, _timeout, self.session_id = struct.unpack("!iiq", resp[:16])
        return self

    def close(self) -> None:
        if self.sock is not None:
            try:
                self._xid += 1
                self._send_frame(struct.pack("!ii", self._xid, CLOSE))
            except Exception:
                pass
            try:
                self.sock.close()
            finally:
                self.sock = None

    # -- request cycle -----------------------------------------------------

    def _call(self, op_type: int, payload: bytes) -> bytes:
        if self.sock is None:
            self.connect()
        self._xid += 1
        self._send_frame(struct.pack("!ii", self._xid, op_type) + payload)
        frame = self._read_frame()
        xid, _zxid, err = struct.unpack("!iqi", frame[:16])
        if err != OK:
            raise ZkError(err)
        return frame[16:]

    # -- operations --------------------------------------------------------

    def create(
        self,
        path: str,
        data: bytes = b"",
        flags: int = 0,
        acl=OPEN_ACL,
    ) -> str:
        body = _ustring(path) + _buffer(data)
        body += struct.pack("!i", len(acl))
        for perms, scheme, ident in acl:
            body += struct.pack("!i", perms) + _ustring(scheme) + _ustring(ident)
        body += struct.pack("!i", flags)
        resp = self._call(CREATE, body)
        out, _ = _read_buffer(resp, 0)
        return out.decode()

    def get_data(self, path: str) -> Tuple[bytes, Stat]:
        resp = self._call(GET_DATA, _ustring(path) + b"\0")
        data, off = _read_buffer(resp, 0)
        stat, _ = _read_stat(resp, off)
        return (data or b""), stat

    def set_data(self, path: str, data: bytes, version: int = -1) -> Stat:
        """version -1 = unconditional; otherwise compare-and-set."""
        resp = self._call(
            SET_DATA, _ustring(path) + _buffer(data) + struct.pack("!i", version)
        )
        stat, _ = _read_stat(resp, 0)
        return stat

    def delete(self, path: str, version: int = -1) -> None:
        self._call(DELETE, _ustring(path) + struct.pack("!i", version))

    def exists(self, path: str) -> Optional[Stat]:
        try:
            resp = self._call(EXISTS, _ustring(path) + b"\0")
        except ZkError as e:
            if e.code == NO_NODE:
                return None
            raise
        stat, _ = _read_stat(resp, 0)
        return stat

    def get_children(self, path: str) -> List[str]:
        resp = self._call(GET_CHILDREN, _ustring(path) + b"\0")
        (n,) = struct.unpack("!i", resp[:4])
        off, out = 4, []
        for _ in range(n):
            s, off = _read_buffer(resp, off)
            out.append(s.decode())
        return sorted(out)
