"""Thread-safe auto-reopening connection wrapper — the port's copy of
:mod:`jepsen_tpu.reconnect`.

(reference: jepsen/src/jepsen/reconnect.clj — wrapper :16-54, open!
:55-77, reopen! :78-90, with-conn retry semantics :90-146.)  Used by DB
clients whose connections break mid-test.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional


class Wrapper:
    def __init__(
        self,
        open_fn: Callable[[], Any],
        close_fn: Callable[[Any], None] = lambda conn: None,
        name: str = "conn",
        log: bool = True,
    ):
        self.open_fn = open_fn
        self.close_fn = close_fn
        self.name = name
        self.lock = threading.RLock()
        self.conn: Optional[Any] = None

    def open(self) -> "Wrapper":
        with self.lock:
            if self.conn is None:
                self.conn = self.open_fn()
        return self

    def close(self) -> None:
        with self.lock:
            if self.conn is not None:
                try:
                    self.close_fn(self.conn)
                finally:
                    self.conn = None

    def reopen(self) -> None:
        """(reference: reconnect.clj:78-90)"""
        with self.lock:
            self.close()
            self.conn = self.open_fn()

    def with_conn(self, fn: Callable[[Any], Any], retries: int = 1) -> Any:
        """Run fn(conn); on failure reopen and retry up to `retries`
        times before re-raising."""
        attempt = 0
        while True:
            with self.lock:
                if self.conn is None:
                    self.conn = self.open_fn()
                conn = self.conn
            try:
                return fn(conn)
            except Exception:
                attempt += 1
                try:
                    self.reopen()
                except Exception:
                    pass
                if attempt > retries:
                    raise


def wrapper(open_fn, close_fn=lambda c: None, **kw) -> Wrapper:
    return Wrapper(open_fn, close_fn, **kw)
