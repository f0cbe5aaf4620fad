"""Monotonic-inserts workload for the SQL suites.

The port's copy of :mod:`jepsen_tpu.suites.monotonic`.

Clients insert successive integer values tagged with a database-assigned
transaction timestamp, spread over several tables; a final read returns
every row ordered by that timestamp.  The checker verifies that the
timestamp order agrees with insertion order (globally and per process /
per table), and accounts for lost, duplicated, revived (failed-but-seen)
and recovered (indeterminate-but-seen) rows.

Reference: cockroachdb/src/jepsen/cockroach/monotonic.clj:32-248 — the
client creates per-key tables and inserts (val, sts, node, process, tb)
rows with ``cluster_logical_timestamp()``; check-monotonic computes
off-order pairs, lost/dup/revived/recovered sets.  This implementation
is dialect-generic (cockroach / pg / mysql timestamp expressions) so the
same workload runs on cockroachdb, tidb, stolon, and yugabyte-ysql.
"""

from __future__ import annotations

from decimal import Decimal
from typing import Any, Dict, List, Optional

from .. import generator as gen
from ..checker import Checker
from ..history import OK, FAIL, INFO
from . import sql

#: timestamp expression per dialect.  Only cockroach's
#: cluster_logical_timestamp() is a *commit* timestamp monotone with
#: commit order (the property the reference relies on,
#: monotonic.clj:81-96); pg's clock_timestamp() and mysql's now(6) are
#: wall-clock *statement* time — two concurrent txns can commit in
#: reverse wall-clock order on a perfectly correct DB, so those
#: dialects only support the per-process / per-table ordering checks.
TS_EXPR = {
    "cockroach": "cluster_logical_timestamp()",
    "pg": "extract(epoch from clock_timestamp())",
    "mysql": "unix_timestamp(now(6))",
}

#: dialects whose TS_EXPR is a real commit timestamp: the global
#: timestamp-vs-value ordering check is only sound on these
COMMIT_ORDERED_DIALECTS = {"cockroach"}

TABLE_COUNT = 2


def table_name(i: int) -> str:
    return f"mono{i}"


class MonotonicClient(sql._Base):
    """Insert sequential values with DB timestamps; final read returns
    all rows ordered by timestamp.  (reference: monotonic.clj:81-145)"""

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.table_count = int(self.opts.get("table-count", TABLE_COUNT))

    def setup(self, test):
        self._exec_ddl(
            *(
                f"CREATE TABLE IF NOT EXISTS {table_name(i)} "
                "(val INT, sts TEXT, proc INT, tb INT)"
                for i in range(self.table_count)
            )
        )

    def invoke(self, test, op):
        try:
            if op["f"] == "add":
                v = int(op["value"])
                tb = v % self.table_count
                ts = TS_EXPR[self.dialect if self.dialect in TS_EXPR else "pg"]
                # mysql spells string casts CHAR, everyone else TEXT
                txt = "CHAR" if self.dialect == "mysql" else "TEXT"
                proc = op.get("process", -1)
                proc = proc if isinstance(proc, int) else -1
                self.conn.query(
                    f"INSERT INTO {table_name(tb)} (val, sts, proc, tb) "
                    f"VALUES ({v}, CAST({ts} AS {txt}), {proc}, {tb})"
                )
                return {**op, "type": "ok"}
            if op["f"] == "read":
                union = " UNION ALL ".join(
                    f"SELECT val, sts, proc, tb FROM {table_name(i)}"
                    for i in range(self.table_count)
                )
                # bare DECIMAL is DECIMAL(10,0) on mysql — keep the
                # fractional digits or sub-second reorders vanish
                dec = (
                    "DECIMAL(30,10)" if self.dialect == "mysql" else "DECIMAL"
                )
                res = self.conn.query(
                    f"SELECT val, sts, proc, tb FROM ({union}) AS u "
                    f"ORDER BY CAST(sts AS {dec}), val"
                )
                out = [
                    [int(r[0]), str(r[1]), int(r[2]), int(r[3])]
                    for r in res.rows
                ]
                return {**op, "type": "ok", "value": out}
            raise ValueError(f"unknown f {op['f']!r}")
        except sql.IndeterminateError as e:
            return self._info(op, e)
        except (sql.PgError, sql.MysqlError) as e:
            return self._fail(op, e)


def _non_monotonic(rows: List[list], field: int, strict: bool) -> List[list]:
    """Successive row pairs where ``field`` fails to increase
    ((reference: monotonic.clj:147-154 non-monotonic)."""
    bad = []
    for x, y in zip(rows, rows[1:]):
        a, b = x[field], y[field]
        if field == 1:  # timestamps compare numerically
            a, b = Decimal(a), Decimal(b)
        ok = a < b if strict else a <= b
        if not ok:
            bad.append([x, y])
    return bad


def _non_monotonic_by(rows: List[list], group: int, field: int) -> Dict[Any, list]:
    """(reference: monotonic.clj:156-164 non-monotonic-by)"""
    groups: Dict[Any, List[list]] = {}
    for r in rows:
        groups.setdefault(r[group], []).append(r)
    return {
        k: _non_monotonic(sub, field, strict=True)
        for k, sub in sorted(groups.items())
        if _non_monotonic(sub, field, strict=True)
    }


class MonotonicChecker(Checker):
    """(reference: monotonic.clj:166-248 check-monotonic)"""

    def __init__(self, use_global: bool = False):
        self.use_global = use_global

    def check(self, test, history, opts=None):
        adds, fails, infos = set(), set(), set()
        final = None
        for op in history:
            if op.f == "add":
                if op.type == OK:
                    adds.add(op.value)
                elif op.type == FAIL:
                    fails.add(op.value)
                elif op.type == INFO:
                    infos.add(op.value)
            elif op.f == "read" and op.type == OK:
                final = op.value
        if final is None:
            return {"valid?": "unknown", "error": "set was never read"}

        from collections import Counter

        vals = [r[0] for r in final]
        counts = Counter(vals)
        seen = set(counts)
        dups = sorted(v for v, c in counts.items() if c > 1)
        lost = sorted(adds - seen)
        revived = sorted(seen & fails)
        recovered = sorted(seen & infos)
        off_order_sts = _non_monotonic(final, 1, strict=False)
        off_order_vals = _non_monotonic(final, 0, strict=True)
        per_proc = _non_monotonic_by(final, 2, 0)
        per_table = _non_monotonic_by(final, 3, 0)
        valid = (
            not lost
            and not dups
            and not revived
            and not off_order_sts
            and not per_proc
            and (not off_order_vals if self.use_global else True)
        )
        return {
            "valid?": valid,
            "lost": lost,
            "duplicates": dups,
            "revived": revived,
            "recovered": recovered,
            "order-by-errors": off_order_sts,
            "value-reorders": off_order_vals,
            "value-reorders-per-process": per_proc,
            "value-reorders-per-table": per_table,
        }


def workload(opts: Optional[dict] = None) -> dict:
    """add ops with sequential values during the run; one final read.
    The strict global value-order check (``linearizable?``) only engages
    on commit-timestamp dialects (:data:`COMMIT_ORDERED_DIALECTS`) —
    wall-clock timestamps would produce false reorder findings.
    (reference: monotonic.clj:251-283 test)"""
    opts = dict(opts or {})
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
        "checker": MonotonicChecker(
            use_global=(
                bool(opts.get("linearizable?", False))
                and opts.get("dialect", sql._Base.dialect)
                in COMMIT_ORDERED_DIALECTS
            )
        ),
    }
