"""Redis serialization protocol (RESP2) client.

The port's copy of :mod:`jepsen_tpu.suites.proto.resp`.

Used by the disque and raftis suites (the reference drives both through
carmine, a Clojure Redis client: disque/src/jepsen/disque.clj,
raftis/src/jepsen/raftis.clj).  RESP2 is symmetric and tiny: commands go
out as arrays of bulk strings; replies are simple strings (+), errors
(-), integers (:), bulk strings ($), or arrays (*).
"""

from __future__ import annotations

import socket
from typing import Any, List, Optional, Union

from . import IndeterminateError, ProtocolError

Reply = Union[None, int, str, bytes, List[Any]]


class RespClient:
    def __init__(self, host: str, port: int = 6379, timeout: float = 5.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self._buf = b""

    # -- connection --------------------------------------------------------

    def connect(self) -> "RespClient":
        self.sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return self

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None

    # -- wire --------------------------------------------------------------

    def _encode(self, args: tuple) -> bytes:
        out = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out.append(b"$%d\r\n%s\r\n" % (len(b), b))
        return b"".join(out)

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            try:
                chunk = self.sock.recv(65536)
            except (OSError, socket.timeout) as e:
                raise IndeterminateError(f"recv failed: {e}") from e
            if not chunk:
                raise IndeterminateError("connection closed mid-reply")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            try:
                chunk = self.sock.recv(65536)
            except (OSError, socket.timeout) as e:
                raise IndeterminateError(f"recv failed: {e}") from e
            if not chunk:
                raise IndeterminateError("connection closed mid-reply")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n:]
        return data

    def _read_reply(self) -> Reply:
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            msg = rest.decode()
            raise ProtocolError(msg, code=msg.split(" ", 1)[0])
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = self._read_exact(n + 2)[:-2]
            return data.decode(errors="replace")
        if kind == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._read_reply() for _ in range(n)]
        raise ProtocolError(f"unparseable RESP reply: {line!r}")

    # -- public ------------------------------------------------------------

    def call(self, *args: Any) -> Reply:
        """Issue one command and return its decoded reply."""
        if self.sock is None:
            self.connect()
        try:
            self.sock.sendall(self._encode(args))
        except OSError as e:
            raise IndeterminateError(f"send failed: {e}") from e
        return self._read_reply()
