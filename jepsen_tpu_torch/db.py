"""Database lifecycle protocols (reference: jepsen/src/jepsen/db.clj).

- ``DB``: install/start (:11-19) and teardown a database on a node
- ``Process``: start!/kill! (:21-25)
- ``Pause``: pause!/resume! (:26-30)
- ``Primary``: primaries/setup-primary! (:31-39)
- ``LogFiles``: log-files (:40-48)
- ``cycle``: teardown → setup with 3 retries (:117-158)

The reference's ``tcpdump`` DB (db.clj:49-115) needs the control plane's
daemon helpers, which the port does not have yet.
"""

from __future__ import annotations

import logging
from typing import Any, Iterable, List

from .util import real_pmap

log = logging.getLogger(__name__)

SETUP_RETRIES = 3  # (reference: db.clj:117-119)


class DB:
    def setup(self, test: dict, node: Any) -> None:
        pass

    def teardown(self, test: dict, node: Any) -> None:
        pass


class Process:
    """Databases whose processes can be started and killed.
    (reference: db.clj:21-25)"""

    def start(self, test: dict, node: Any) -> None:
        raise NotImplementedError

    def kill(self, test: dict, node: Any) -> None:
        raise NotImplementedError


class Pause:
    """(reference: db.clj:26-30)"""

    def pause(self, test: dict, node: Any) -> None:
        raise NotImplementedError

    def resume(self, test: dict, node: Any) -> None:
        raise NotImplementedError


class Primary:
    """(reference: db.clj:31-39)"""

    def primaries(self, test: dict) -> List[Any]:
        raise NotImplementedError

    def setup_primary(self, test: dict, node: Any) -> None:
        pass


class LogFiles:
    """(reference: db.clj:40-48)"""

    def log_files(self, test: dict, node: Any) -> Iterable[str]:
        return ()


class NoopDB(DB):
    pass


def noop() -> DB:
    return NoopDB()


def cycle(test: dict, retries: int = SETUP_RETRIES) -> None:
    """Teardown then set up the DB on every node, retrying setup failures
    up to `retries` times.  Runs setup-primary on the first node for
    Primary DBs.  (reference: db.clj:121-158)"""
    from . import control

    db = test["db"]
    attempt = 0
    while True:
        attempt += 1
        try:
            real_pmap(
                lambda node: control.with_node(
                    node, lambda n=node: (db.teardown(test, n), db.setup(test, n))
                ),
                test["nodes"],
            )
            if isinstance(db, Primary):
                node = test["nodes"][0]
                control.with_node(node, lambda: db.setup_primary(test, node))
            return
        except Exception:
            if attempt >= retries:
                raise
            log.exception("DB setup failed; retrying (%d/%d)", attempt, retries)
            continue
