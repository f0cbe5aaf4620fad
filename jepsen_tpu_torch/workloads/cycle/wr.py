"""Write/read-register txn workload checker: unique writes, point reads.
(reference: jepsen/src/jepsen/tests/cycle/wr.clj — its docstring
enumerates the anomaly vocabulary this checker reports)
"""

from __future__ import annotations

from typing import Optional

from . import checker as elle_checker
from ...checker import Checker


def checker(opts: Optional[dict] = None, device=None,
            client=None) -> Checker:
    """Default anomalies [G2 G1a G1b internal] — catches everything —
    when the opts carry no anomaly/model selection.
    (reference: wr.clj:15-52)"""
    opts = dict(opts or {})
    if "anomalies" not in opts and "consistency-models" not in opts:
        opts["anomalies"] = ["G2", "G1a", "G1b", "internal"]
    return elle_checker("rw-register", opts, device, client)
