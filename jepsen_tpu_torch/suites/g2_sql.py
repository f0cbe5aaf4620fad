"""Predicate-based G2 (anti-dependency cycle) client for SQL suites.

The port's copy of :mod:`jepsen_tpu.suites.g2_sql`.

Each insert op reads *predicates* over two tables inside one
transaction — ``value % 3 = 0`` rather than a primary-key lookup, so
the database can't dodge the anti-dependency with per-key locks — and
inserts its row only when both predicate reads come back empty.  Under
serializability at most one insert of each pair may commit; the paired
generator and checker are the shared adya workload
(jepsen_tpu_torch.workloads.adya).

Reference: cockroachdb/src/jepsen/cockroach/adya.clj:24-76 G2Client +
jepsen/src/jepsen/tests/adya.clj:12-58 (table shapes, predicate text,
and insert semantics).
"""

from __future__ import annotations

from typing import Optional

from . import sql

TABLES = ("a", "b")


class G2Client(sql._Base):
    def setup(self, test):
        self._exec_ddl(
            *(
                f"CREATE TABLE IF NOT EXISTS {t} "
                "(id INT PRIMARY KEY, key INT, value INT)"
                for t in TABLES
            )
        )

    def invoke(self, test, op):
        assert op["f"] == "insert", op
        k, ids = op["value"]
        a_id, b_id = ids
        table = "a" if a_id is not None else "b"
        id_ = a_id if a_id is not None else b_id
        try:
            self.conn.query("BEGIN")
            try:
                hit = False
                for t in TABLES:
                    res = self.conn.query(
                        f"SELECT id FROM {t} "
                        f"WHERE key = {int(k)} AND value % 3 = 0"
                    )
                    hit = hit or bool(res.rows)
                if hit:
                    self.conn.query("ROLLBACK")
                    return {**op, "type": "fail", "error": "conflict"}
                self.conn.query(
                    f"INSERT INTO {table} (id, key, value) "
                    f"VALUES ({int(id_)}, {int(k)}, 30)"
                )
                self.conn.query("COMMIT")
            except Exception:
                try:
                    self.conn.query("ROLLBACK")
                except Exception:
                    pass
                raise
            return {**op, "type": "ok"}
        except sql.IndeterminateError as e:
            return self._info(op, e)
        except (sql.PgError, sql.MysqlError) as e:
            return self._fail(op, e)


def client(opts: Optional[dict] = None) -> G2Client:
    return G2Client(opts)
