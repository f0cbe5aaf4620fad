"""Comments workload: strict-serializability via write-visibility order.

The port's copy of :mod:`jepsen_tpu.suites.comments`.

Writers blindly insert globally-unique ids across sharded tables; a
reader transaction scans every table.  Replaying the history, any write
that completed before another write was *invoked* must be visible
whenever the later write is — seeing w_i without some earlier w_j is
exactly the "comment appeared before the post it replies to" anomaly
(T1 < T2 in real time, T2 visible without T1: a strict-serializability
violation that plain serializability permits).

Reference: cockroachdb/src/jepsen/cockroach/comments.clj:1-177 — the
Client inserts (id, key) rows into ``comment_<hash(id) % n>`` and reads
ids back across all tables in one txn; the checker accumulates the
completed-before set per write invocation and diffs each read against
the union of its seen writes' expectations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from .. import generator as gen
from .. import independent
from ..checker import Checker
from ..history import INVOKE, OK
from . import sql

TABLE_PREFIX = "comment_"
TABLE_COUNT = 10


def table_for(id_: int, table_count: int = TABLE_COUNT) -> str:
    return f"{TABLE_PREFIX}{id_ % table_count}"


class CommentsClient(sql._Base):
    """(reference: comments.clj:42-88)"""

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.table_count = int(self.opts.get("table-count", TABLE_COUNT))

    def setup(self, test):
        self._exec_ddl(
            *(
                f"CREATE TABLE IF NOT EXISTS {TABLE_PREFIX}{i} "
                "(id INT PRIMARY KEY, key INT)"
                for i in range(self.table_count)
            )
        )

    def invoke(self, test, op):
        k, v = op["value"]
        try:
            if op["f"] == "write":
                v = int(v)
                self.conn.query(
                    f"INSERT INTO {table_for(v, self.table_count)} "
                    f"(id, key) VALUES ({v}, {int(k)})"
                )
                return {**op, "type": "ok"}
            if op["f"] == "read":
                seen: List[int] = []
                self.conn.query("BEGIN")
                try:
                    for i in range(self.table_count):
                        res = self.conn.query(
                            f"SELECT id FROM {TABLE_PREFIX}{i} "
                            f"WHERE key = {int(k)}"
                        )
                        seen.extend(int(r[0]) for r in res.rows)
                    self.conn.query("COMMIT")
                except Exception:
                    try:
                        self.conn.query("ROLLBACK")
                    except Exception:
                        pass
                    raise
                return {**op, "type": "ok",
                        "value": independent.kv(k, sorted(seen))}
            raise ValueError(f"unknown f {op['f']!r}")
        except sql.IndeterminateError as e:
            return self._info(op, e)
        except (sql.PgError, sql.MysqlError) as e:
            return self._fail(op, e)


class CommentsChecker(Checker):
    """Replay: expected[w] = writes completed before w's invocation;
    a read seeing w but missing any of expected[w] is an error.
    (reference: comments.clj:90-141)"""

    def check(self, test, history, opts=None):
        completed: Set[int] = set()
        expected: Dict[int, Set[int]] = {}
        errors = []
        for op in history:
            if op.f == "write":
                if op.type == INVOKE:
                    expected[op.value] = set(completed)
                elif op.type == OK:
                    completed.add(op.value)
            elif op.f == "read" and op.type == OK and op.value is not None:
                seen = set(op.value)
                want: Set[int] = set()
                for w in seen:
                    want |= expected.get(w, set())
                missing = want - seen
                if missing:
                    errors.append(
                        {
                            "index": op.index,
                            "process": op.process,
                            "missing": sorted(missing),
                            "expected-count": len(want),
                        }
                    )
        return {"valid?": not errors, "errors": errors}


def workload(opts: Optional[dict] = None) -> dict:
    """Concurrent blind writes + full-scan reads per independent key.
    (reference: comments.clj:144-177)"""
    opts = dict(opts or {})
    n = max(1, len(opts.get("nodes", ["n1"])))
    ids = {"n": 0}

    def write(test, ctx):
        ids["n"] += 1
        return {"type": "invoke", "f": "write", "value": ids["n"]}

    def read(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def fgen(k):
        return gen.limit(16, gen.mix([write, read]))

    return {
        "generator": independent.concurrent_generator(
            n, range(100_000), fgen
        ),
        "checker": independent.checker(CommentsChecker()),
        "concurrency": 2 * n,
    }
