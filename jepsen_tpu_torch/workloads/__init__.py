"""Reusable workloads: partial test maps bundling a generator + checker
(and sometimes defaults) that DB suites mix into their tests.

Mirrors the reference's jepsen.tests namespace family
(jepsen/src/jepsen/tests.clj and jepsen/src/jepsen/tests/*.clj):
``noop_test`` lives here and each workload gets its own module (bank,
long_fork, causal, causal_reverse, adya, linearizable_register,
cycle/append, cycle/wr): the registry holds the reference's eight names.
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
    from . import (  # local imports keep startup light
        adya,
        bank,
        causal,
        causal_reverse,
        linearizable_register,
        long_fork,
    )
    from .cycle import append as cycle_append
    from .cycle import wr as cycle_wr

    return {
        "bank": lambda: bank.test(opts),
        "long-fork": lambda: long_fork.workload(opts.get("group-size", 2)),
        "causal": lambda: causal.test(opts),
        "causal-reverse": lambda: causal_reverse.workload(opts),
        # the paired-insert generator runs 2 threads per key, so the
        # worker count must divide evenly (the reference's
        # concurrent-generator asserts the same, independent.clj);
        # default 1n x 5 nodes = 5 workers would crash
        "adya-g2": lambda: {
            **adya.workload(opts),
            "concurrency": 2 * len(
                opts.get("nodes") or ["n1", "n2", "n3", "n4", "n5"]
            ),
        },
        "linearizable-register": lambda: linearizable_register.test(opts),
        "list-append": lambda: cycle_append.test(opts),
        "rw-register": lambda: cycle_wr.test(opts),
    }
