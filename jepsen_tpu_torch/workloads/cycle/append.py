"""List-append txn workload checker: clients take ops like

    {"type": "invoke", "f": "txn",
     "value": [["r", 3, None], ["append", 3, 2], ["r", 3, None]]}

and complete them with observed lists filled in.
(reference: jepsen/src/jepsen/tests/cycle/append.clj)
"""

from __future__ import annotations

from typing import Optional

from . import checker as elle_checker
from ...checker import Checker


def checker(opts: Optional[dict] = None, device=None,
            client=None) -> Checker:
    """Defaults to the reference's {:anomalies [:G1 :G2]} when the opts
    carry no anomaly/model selection.  (reference: append.clj:11-21)"""
    opts = dict(opts or {})
    if "anomalies" not in opts and "consistency-models" not in opts:
        opts["anomalies"] = ["G1", "G2"]
    return elle_checker("list-append", opts, device, client)
