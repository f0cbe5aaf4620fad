"""Adya's proscribed weak-consistency phenomena: the G2 (anti-dependency
cycle) probe via paired predicate inserts.

Clients take ``{"f": "insert", "value": [k, [a_id, b_id]]}`` ops (one id
nil per op), read both tables under a predicate, and insert only if both
reads are empty — so at most one of each pair may commit under
serializability.  The port's copy of :mod:`jepsen_tpu.workloads.adya`;
its checker re-keys a history read back from JSON
(:func:`~jepsen_tpu_torch.independent.rekey`), as the port's lifts do, so
``cli analyze`` of a stored run counts its keys (the reference's sees
plain lists and counts none).
(reference: jepsen/src/jepsen/tests/adya.clj)
"""

from __future__ import annotations

import itertools
from typing import Any, Dict

from .. import generator as gen
from .. import independent
from ..checker import Checker
from ..history import OK


def g2_gen():
    """Pairs of :insert ops per key: one with a-id, one with b-id;
    ids globally unique.  (reference: adya.clj:12-58)"""
    ids = itertools.count(1)

    def fgen(k):
        return [
            gen.once(
                lambda test, ctx: {
                    "type": "invoke",
                    "f": "insert",
                    "value": [None, next(ids)],
                }
            ),
            gen.once(
                lambda test, ctx: {
                    "type": "invoke",
                    "f": "insert",
                    "value": [next(ids), None],
                }
            ),
        ]

    return independent.concurrent_generator(2, list(range(100_000)), fgen)


class _G2Checker(Checker):
    def check(self, test, history, opts=None):
        # At most one successful insert per key.  Values here are the
        # independent-keyed tuples [k, [a_id, b_id]].
        keys: Dict[Any, int] = {}
        for op in independent.rekey(history):
            if op.f != "insert":
                continue
            v = op.value
            if not independent.is_tuple(v):
                continue
            k = v.key
            if op.type == OK:
                keys[k] = keys.get(k, 0) + 1
            else:
                keys.setdefault(k, 0)
        inserted = [k for k, c in keys.items() if c > 0]
        illegal = {k: c for k, c in sorted(keys.items(), key=lambda kv: str(kv[0])) if c > 1}
        return {
            "valid?": not illegal,
            "key-count": len(keys),
            "legal-count": len(inserted) - len(illegal),
            "illegal-count": len(illegal),
            "illegal": illegal,
        }


def g2_checker() -> Checker:
    """(reference: adya.clj:60-87)"""
    return _G2Checker()


def workload(opts=None) -> dict:
    """The paired-insert G2 workload package, shared by every suite that
    wires a predicate-insert client (faunadb g2, cockroach adya).
    (reference: jepsen/src/jepsen/tests/adya.clj:12-87)"""
    return {
        "generator": g2_gen(),
        "checker": g2_checker(),
        "concurrency": 2,
    }
