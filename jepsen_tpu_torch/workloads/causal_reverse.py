"""Strict-serializability anomaly: T1 < T2, but T2 visible without T1 —
the port's copy of :mod:`jepsen_tpu.workloads.causal_reverse`.

Concurrent blind inserts over keys plus multi-key reads; replaying the
history tracks which writes completed before each write began, so any
read observing w_i but missing some w_j < w_i is a violation.
(reference: jepsen/src/jepsen/tests/causal_reverse.clj)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Set

from .. import checker as checker_mod
from .. import generator as gen
from .. import independent
from ..checker import Checker
from ..history import INVOKE, OK


def graph(history) -> Dict[Any, Set[Any]]:
    """First-order write-precedence: value -> set of writes completed
    before its invocation.  (reference: causal_reverse.clj:21-47)"""
    completed: Set[Any] = set()
    expected: Dict[Any, Set[Any]] = {}
    for op in history:
        if op.f != "write":
            continue
        if op.type == INVOKE:
            expected[op.value] = set(completed)
        elif op.type == OK:
            completed.add(op.value)
    return expected


def errors(history, expected: Dict[Any, Set[Any]]) -> list:
    """Reads that observe a write but miss an earlier acknowledged one.
    (reference: causal_reverse.clj:49-72)"""
    errs = []
    for op in history:
        if op.type != OK or op.f != "read":
            continue
        seen = set(op.value or [])
        our_expected: Set[Any] = set()
        for v in seen:
            our_expected |= expected.get(v, set())
        missing = our_expected - seen
        if missing:
            err = op.copy(value=None)
            errs.append(
                {
                    "op": err.to_dict(),
                    "missing": sorted(missing, key=str),
                    "expected-count": len(our_expected),
                }
            )
    return errs


class _CausalReverseChecker(Checker):
    def check(self, test, history, opts=None):
        expected = graph(history)
        errs = errors(history, expected)
        return {"valid?": not errs, "errors": errs}


def checker() -> Checker:
    """(reference: causal_reverse.clj:74-84)"""
    return _CausalReverseChecker()


def workload(opts: Optional[dict] = None) -> dict:
    """Options: ``nodes`` (only the count matters), ``per-key-limit``
    (default 500).  (reference: causal_reverse.clj:89-114)"""
    opts = opts or {}
    n = len(opts.get("nodes", ["n1"]))
    reads = {"f": "read"}

    def fgen(k):
        counter = iter(range(10**12))

        def writes():
            return {"f": "write", "value": next(counter)}

        return gen.limit(
            opts.get("per-key-limit", 500),
            gen.stagger(1 / 100, gen.mix([reads, writes])),
        )

    # no perf checker here: build_test composes one into every suite
    # run; a second instance would race the same SVG paths
    return {
        "checker": checker_mod.compose(
            {
                "sequential": independent.checker(checker()),
            }
        ),
        "generator": independent.concurrent_generator(
            n, list(range(10_000)), fgen
        ),
    }
