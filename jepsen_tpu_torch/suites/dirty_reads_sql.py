"""Dirty-read probe for the MySQL-replication suites (Galera,
Percona XtraDB).

The port's copy of :mod:`jepsen_tpu.suites.dirty_reads_sql`.

Writers race to set EVERY row of a table to one unique value inside a
serializable transaction (read-all in random order, then update-all);
readers read all rows at once.  Two anomalies fall out: a read whose
rows disagree (the writer's txn was seen half-applied) and a read
containing a *failed* writer's value (the dirty read proper).

Reference: galera/src/jepsen/galera/dirty_reads.clj:28-120 and its
namespace-for-namespace twin percona/src/jepsen/percona/dirty_reads.clj
— client (:28-67: n rows seeded to -1, read-all / write-everything
transactions), checker (:73-96: inconsistent-reads = rows disagree,
dirty-reads = failed write visible), generator (:98-105: reads mixed
with sequentially-numbered writes).
"""

from __future__ import annotations

from typing import Optional

from .. import generator as gen
from ..checker import Checker
from ..history import FAIL, OK
from . import sql

N_ROWS = 10  # rows per table (reference passes n per-test; 10 typical)


class DirtyReadsClient(sql._Base):
    """(reference: dirty_reads.clj:28-67 Client)"""

    dialect = "mysql"

    def __init__(self, opts: Optional[dict] = None):
        import random as _random

        super().__init__(opts)
        self.n = int(self.opts.get("rows", N_ROWS))
        # private rng: worker threads must not race the seeded module
        # rng the scheduler draws deterministic schedules from
        self.rng = _random.Random()

    def setup(self, test):
        self._exec_ddl(
            "CREATE TABLE IF NOT EXISTS dirty "
            "(id INT NOT NULL PRIMARY KEY, x BIGINT NOT NULL)"
        )
        for i in range(self.n):
            try:
                self.conn.query(
                    f"INSERT INTO dirty (id, x) VALUES ({i}, -1)"
                )
            except (sql.PgError, sql.MysqlError):
                pass  # another client seeded this row

    def invoke(self, test, op):
        try:
            if op["f"] == "read":
                res = self.conn.query("SELECT x FROM dirty ORDER BY id")
                return {**op, "type": "ok",
                        "value": [int(r[0]) for r in res.rows]}
            if op["f"] == "write":
                x = int(op["value"])
                order = list(range(self.n))
                self.rng.shuffle(order)
                self.conn.query("BEGIN")
                try:
                    for i in order:
                        self.conn.query(
                            f"SELECT x FROM dirty WHERE id = {i}"
                        )
                    for i in order:
                        self.conn.query(
                            f"UPDATE dirty SET x = {x} WHERE id = {i}"
                        )
                    self.conn.query("COMMIT")
                    return {**op, "type": "ok"}
                except (sql.PgError, sql.MysqlError) as e:
                    try:
                        self.conn.query("ROLLBACK")
                    except Exception:  # noqa: BLE001
                        pass
                    return self._fail(op, e)
            raise ValueError(f"unknown f {op['f']!r}")
        except sql.IndeterminateError as e:
            return self._info(op, e)
        except (sql.PgError, sql.MysqlError) as e:
            return self._fail(op, e)


class DirtyReadsChecker(Checker):
    """A failed write's value must never be read; every read must be
    internally uniform (reference: dirty_reads.clj:73-96)."""

    def check(self, test, history, opts=None):
        failed_writes = {
            op.value for op in history
            if op.type == FAIL and op.f == "write"
        }
        reads = [op.value for op in history
                 if op.type == OK and op.f == "read" and op.value]
        inconsistent = [r for r in reads if len(set(r)) > 1]
        filthy = [r for r in reads
                  if any(x in failed_writes for x in r)]
        return {
            "valid?": not filthy,
            "inconsistent-reads": inconsistent[:10],
            "dirty-reads": filthy[:10],
        }


class _Writes(gen.Generator):
    """Sequentially numbered writes (reference: dirty_reads.clj:100-105
    — an infinite seq over (range))."""

    def __init__(self, i: int = 0):
        self.i = i

    def op(self, test, ctx):
        return (
            gen.fill_in_op({"f": "write", "value": self.i}, ctx),
            _Writes(self.i + 1),
        )

    def update(self, test, ctx, event):
        return self


def workload(opts: Optional[dict] = None) -> dict:
    """(reference: dirty_reads.clj:107-120 test-)"""
    return {
        "generator": gen.mix([
            gen.repeat({"f": "read", "value": None}),
            _Writes(),
        ]),
        "checker": DirtyReadsChecker(),
    }
