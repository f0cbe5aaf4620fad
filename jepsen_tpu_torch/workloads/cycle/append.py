"""List-append txn workload: clients take ops like

    {"type": "invoke", "f": "txn",
     "value": [["r", 3, None], ["append", 3, 2], ["r", 3, None]]}

and complete them with observed lists filled in.
(reference: jepsen/src/jepsen/tests/cycle/append.clj)
"""

from __future__ import annotations

from typing import Optional

from . import TxnGenerator, checker as elle_checker
from ...checker import Checker


def gen(opts: Optional[dict] = None):
    """(reference: append.clj:23-26)"""
    return TxnGenerator("append", opts or {})


def checker(opts: Optional[dict] = None, device=None,
            client=None) -> Checker:
    """Defaults to the reference's {:anomalies [:G1 :G2]} when the opts
    carry no anomaly/model selection.  (reference: append.clj:11-21)"""
    opts = dict(opts or {})
    if "anomalies" not in opts and "consistency-models" not in opts:
        opts["anomalies"] = ["G1", "G2"]
    return elle_checker("list-append", opts, device, client)


def test(opts: Optional[dict] = None) -> dict:
    """Partial test: generator + checker; bring a client.  Options:
    key-count, min-txn-length, max-txn-length, max-writes-per-key,
    anomalies, consistency-models, and ``device`` (where the checker's
    screens run: None the current CUDA device, ``"cpu"`` the plain
    versions).  (reference: append.clj:28-55)"""
    opts = opts or {}
    return {"generator": gen(opts),
            "checker": checker(opts, opts.get("device"))}
