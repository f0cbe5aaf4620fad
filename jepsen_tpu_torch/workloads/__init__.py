"""Reusable workloads: partial test maps bundling a generator + checker
(and sometimes defaults) that DB suites mix into their tests.

Mirrors the reference's jepsen.tests namespace family
(jepsen/src/jepsen/tests.clj and jepsen/src/jepsen/tests/*.clj):
``noop_test`` lives here and each workload gets its own module.  The
registry holds what the port has: ``linearizable-register``.  The cycle
workloads (:mod:`.cycle`) have their checkers but not yet their
transaction generators; bank, long-fork, causal, causal-reverse and
adya-g2 are not ported yet.
"""

from __future__ import annotations

from .. import checker as checker_mod
from .. import client as client_mod
from .. import db as db_mod
from .. import nemesis as nemesis_mod


def noop_test() -> dict:
    """Boring test stub; a basis for more complex tests.
    (reference: tests.clj:12-25)"""
    return {
        "name": "noop",
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "db": db_mod.noop(),
        "client": client_mod.noop(),
        "nemesis": nemesis_mod.noop(),
        "generator": None,
        "checker": checker_mod.unbridled_optimism(),
        "store?": False,
    }


def workload(name: str, opts: dict | None = None) -> dict:
    """Look up a workload package by name."""
    opts = opts or {}
    table = _table(opts)
    if name not in table:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(table)}")
    return table[name]()


def names() -> list:
    """Every in-process workload name (for test-all and --help)."""
    return sorted(_table({}))


def _table(opts: dict) -> dict:
    from . import linearizable_register  # local import keeps startup light

    return {
        "linearizable-register": lambda: linearizable_register.test(opts),
    }
