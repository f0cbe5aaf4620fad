"""Write/read-register txn workload: unique writes, point reads.
(reference: jepsen/src/jepsen/tests/cycle/wr.clj — its docstring
enumerates the anomaly vocabulary this checker reports)
"""

from __future__ import annotations

from typing import Optional

from . import TxnGenerator, checker as elle_checker
from ...checker import Checker


def gen(opts: Optional[dict] = None):
    """(reference: wr.clj:10-13)"""
    return TxnGenerator("wr", opts or {})


def checker(opts: Optional[dict] = None, device=None,
            client=None) -> Checker:
    """Default anomalies [G2 G1a G1b internal] — catches everything —
    when the opts carry no anomaly/model selection.
    (reference: wr.clj:15-52)"""
    opts = dict(opts or {})
    if "anomalies" not in opts and "consistency-models" not in opts:
        opts["anomalies"] = ["G2", "G1a", "G1b", "internal"]
    return elle_checker("rw-register", opts, device, client)


def test(opts: Optional[dict] = None) -> dict:
    """Partial test: generator + checker; bring a client.  Options:
    key-count, min-txn-length, max-txn-length, max-writes-per-key,
    anomalies, consistency-models, and ``device`` (where the checker's
    screens run: None the current CUDA device, ``"cpu"`` the plain
    versions).  (reference: wr.clj)"""
    opts = opts or {}
    return {"generator": gen(opts),
            "checker": checker(opts, opts.get("device"))}
