"""Auto-retrying Remote decorator for flaky transports — the port's copy
of :mod:`jepsen_tpu.control.retry`.

(reference: jepsen/src/jepsen/control/retry.clj — 5 tries, ~100 ms
backoff :16-22; reconnects the underlying remote between attempts
:36-72.)
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from .core import Command, Remote, RemoteError, Result

log = logging.getLogger(__name__)

RETRIES = 5
BACKOFF_SECONDS = 0.1


class RetryRemote(Remote):
    def __init__(self, remote: Remote, retries: int = RETRIES, backoff: float = BACKOFF_SECONDS):
        self.remote = remote
        self.retries = retries
        self.backoff = backoff
        # one RetryRemote per (node, worker): the connection and its
        # reconnect cycle live on that worker's thread, never shared
        self._node = None  # jt: guarded-by(owner-thread)
        self._test = None  # jt: guarded-by(owner-thread)
        self._conn: Optional[Remote] = None  # jt: guarded-by(owner-thread)

    def connect(self, node, test=None):
        r = RetryRemote(self.remote, self.retries, self.backoff)
        r._node = node
        r._test = test
        # initial connect: plain retries, no reconnect of a
        # not-yet-existing connection (and never on the prototype)
        r._conn = r._with_retries(
            lambda: self.remote.connect(node, test), reconnect=False
        )
        return r

    def disconnect(self):
        if self._conn is not None:
            self._conn.disconnect()

    def _reconnect(self):
        try:
            if self._conn is not None:
                self._conn.disconnect()
        except Exception:
            pass
        self._conn = self.remote.connect(self._node, self._test)

    def _with_retries(self, thunk, reconnect: bool = True):
        attempt = 0
        while True:
            attempt += 1
            try:
                return thunk()
            except RemoteError:
                raise  # command genuinely failed; don't mask semantics
            except Exception as e:
                if attempt >= self.retries:
                    raise
                from .. import obs

                obs.count(
                    "jepsen_remote_retries_total",
                    error=type(e).__name__,
                )
                log.warning(
                    "remote op failed (%s); retrying %d/%d",
                    e,
                    attempt,
                    self.retries,
                )
                time.sleep(self.backoff)
                if reconnect:
                    try:
                        self._reconnect()
                    except Exception:
                        pass

    def execute(self, command: Command) -> Result:
        return self._with_retries(lambda: self._conn.execute(command))

    def upload(self, local_paths, remote_path):
        return self._with_retries(
            lambda: self._conn.upload(local_paths, remote_path)
        )

    def download(self, remote_paths, local_path):
        return self._with_retries(
            lambda: self._conn.download(remote_paths, local_path)
        )


def retry(remote: Remote, **kw) -> RetryRemote:
    return RetryRemote(remote, **kw)
