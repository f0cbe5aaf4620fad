"""Cockroach-style ``sets`` workload: sequential unique adds into one
table, a single final read, and a checker accounting for every element
class — ok / lost / unexpected / duplicates / revived (failed adds that
appear anyway) / recovered (indeterminate adds that appear).

The port's copy of :mod:`jepsen_tpu.suites.crdb_sets`.

Reference: cockroachdb/src/jepsen/cockroach/sets.clj — check-sets
(:20-94: the six element classes and their interval-set/fraction
reporting), SetsClient (:96-131: ``set (val int)`` table, insert per
add, full-table final read), test (:133-150: sequential staggered adds
+ one final read).  The generic set workload (suites/common.py) keeps
the richer per-element set-full timeline; this one mirrors cockroach's
exact report shape.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

from .. import generator as gen
from ..checker import Checker
from ..history import INVOKE, OK, FAIL, INFO
from ..util import fraction, integer_interval_set_str


class SetsChecker(Checker):
    """(reference: cockroach/sets.clj:20-94 check-sets)"""

    def check(self, test, history, opts=None):
        attempts, adds, fails, unsure = set(), set(), set(), set()
        final = None
        for op in history:
            if op.f == "add":
                if op.type == INVOKE:
                    attempts.add(op.value)
                elif op.type == OK:
                    adds.add(op.value)
                elif op.type == FAIL:
                    fails.add(op.value)
                elif op.type == INFO:
                    unsure.add(op.value)
            elif op.f == "read" and op.type == OK:
                final = op.value
        if final is None:
            return {"valid?": "unknown", "error": "Set was never read"}

        final_set = set(final)
        dups = sorted(v for v, n in Counter(final).items() if n > 1)
        ok = final_set & adds
        unexpected = final_set - attempts
        revived = final_set & fails
        lost = adds - final_set
        recovered = final_set & unsure
        return {
            "valid?": not (lost or unexpected or dups or revived),
            "duplicates": dups,
            "ok": integer_interval_set_str(ok),
            "lost": integer_interval_set_str(lost),
            "unexpected": integer_interval_set_str(unexpected),
            "recovered": integer_interval_set_str(recovered),
            "revived": integer_interval_set_str(revived),
            "ok-frac": fraction(len(ok), len(attempts)),
            "revived-frac": fraction(len(revived), len(fails)),
            "unexpected-frac": fraction(len(unexpected), len(attempts)),
            "lost-frac": fraction(len(lost), len(attempts)),
            "recovered-frac": fraction(len(recovered), len(attempts)),
        }


def workload(opts: Optional[dict] = None) -> dict:
    """Sequential adds staggered during the run; one final read.
    (reference: cockroach/sets.clj:133-150 test)"""
    counter = {"n": 0}

    def add(test, ctx):
        v = counter["n"]
        counter["n"] += 1
        return {"type": "invoke", "f": "add", "value": v}

    final = gen.clients(
        gen.each_thread(
            gen.once({"type": "invoke", "f": "read", "value": None})
        )
    )
    return {
        "generator": add,
        "final-generator": final,
        "checker": SetsChecker(),
    }
