"""Shared SQL clients for the relational suites.

The port's copy of :mod:`jepsen_tpu.suites.sql`.

The reference repeats the same JDBC client patterns across cockroachdb,
tidb, yugabyte(ysql), stolon, galera, percona and mysql-cluster:
open a connection, create a table, then run register/bank/set/append
workload ops inside transactions with retry/indeterminacy handling
(e.g. tidb/src/tidb/sql.clj, cockroachdb/src/jepsen/cockroach/client.clj,
galera/src/jepsen/galera/dirty_reads.clj).  This module implements those
clients once over the from-scratch wire protocols
(:mod:`.proto.pgwire`, :mod:`.proto.mysql`), parameterized by dialect.

Dialects: ``pg`` (postgres, stolon, RDS), ``cockroach`` (pgwire +
UPSERT), ``mysql`` (tidb, galera, percona, ndb).
"""

from __future__ import annotations

from typing import Any, Optional

from .. import client as client_mod
from .. import independent
from .proto import IndeterminateError
from .proto.mysql import MysqlClient, MysqlError
from .proto.pgwire import PgClient, PgError


class Conn:
    """One SQL connection + dialect-specific statement shapes."""

    def __init__(self, dialect: str, host: str, opts: dict):
        self.dialect = dialect
        self.opts = opts
        if dialect in ("pg", "cockroach"):
            self.c = PgClient(
                host,
                port=opts.get("port", 26257 if dialect == "cockroach" else 5432),
                user=opts.get("user", "root" if dialect == "cockroach"
                              else "postgres"),
                password=opts.get("password", ""),
                database=opts.get("database", "postgres"),
                timeout=opts.get("timeout", 10.0),
            )
        elif dialect == "mysql":
            self.c = MysqlClient(
                host,
                port=opts.get("port", 3306),
                user=opts.get("user", "root"),
                password=opts.get("password", ""),
                database=opts.get("database", ""),
                timeout=opts.get("timeout", 10.0),
            )
        else:
            raise ValueError(f"unknown dialect {dialect!r}")

    # -- statement shapes ----------------------------------------------
    def upsert(self, table: str, key: int, col: str, val: Any) -> str:
        if self.dialect == "cockroach":
            return f"UPSERT INTO {table} (id, {col}) VALUES ({key}, {val})"
        if self.dialect == "pg":
            return (
                f"INSERT INTO {table} (id, {col}) VALUES ({key}, {val}) "
                f"ON CONFLICT (id) DO UPDATE SET {col} = {val}"
            )
        return (
            f"INSERT INTO {table} (id, {col}) VALUES ({key}, {val}) "
            f"ON DUPLICATE KEY UPDATE {col} = {val}"
        )

    def concat_append(self, table: str, key: int, elem: Any) -> str:
        v = str(elem)
        if self.dialect == "cockroach":
            return (
                f"INSERT INTO {table} (id, vals) VALUES ({key}, '{v}') "
                f"ON CONFLICT (id) DO UPDATE "
                f"SET vals = concat({table}.vals, ',', '{v}')"
            )
        if self.dialect == "pg":
            return (
                f"INSERT INTO {table} (id, vals) VALUES ({key}, '{v}') "
                f"ON CONFLICT (id) DO UPDATE "
                f"SET vals = {table}.vals || ',' || '{v}'"
            )
        return (
            f"INSERT INTO {table} (id, vals) VALUES ({key}, '{v}') "
            f"ON DUPLICATE KEY UPDATE vals = concat(vals, ',', '{v}')"
        )

    def query(self, sql: str):
        return self.c.query(sql)

    def close(self):
        self.c.close()


class _Base(client_mod.Client):
    dialect = "pg"

    def __init__(self, opts: Optional[dict] = None):
        self.opts = dict(opts or {})
        self.dialect = self.opts.get("dialect", type(self).dialect)
        self.conn: Optional[Conn] = None

    def open(self, test, node):
        c = type(self)(self.opts)
        c.conn = Conn(
            self.dialect, self.opts.get("host", str(node)), self.opts
        )
        return c

    def _fail(self, op, e):
        return {**op, "type": "fail", "error": str(e)}

    def _info(self, op, e):
        return {**op, "type": "info", "error": str(e)}

    def close(self, test):
        if self.conn:
            self.conn.close()

    def _exec_ddl(self, *stmts: str) -> None:
        for s in stmts:
            try:
                self.conn.query(s)
            except (PgError, MysqlError):
                pass  # already exists
            except IndeterminateError:
                pass


class RegisterClient(_Base):
    """Per-key CAS registers: ``registers (id primary key, val)``.
    (reference: cockroachdb register.clj, tidb register.clj)"""

    TABLE = "registers"

    def setup(self, test):
        self._exec_ddl(
            f"CREATE TABLE IF NOT EXISTS {self.TABLE} "
            "(id INT PRIMARY KEY, val INT)"
        )

    def invoke(self, test, op):
        k, v = op["value"]
        try:
            if op["f"] == "read":
                res = self.conn.query(
                    f"SELECT val FROM {self.TABLE} WHERE id = {int(k)}"
                )
                val = int(res.rows[0][0]) if res.rows and res.rows[0][0] is not None else None
                return {**op, "type": "ok", "value": independent.kv(k, val)}
            if op["f"] == "write":
                self.conn.query(
                    self.conn.upsert(self.TABLE, int(k), "val", int(v))
                )
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = v
                res = self.conn.query(
                    f"UPDATE {self.TABLE} SET val = {int(new)} "
                    f"WHERE id = {int(k)} AND val = {int(old)}"
                )
                affected = getattr(res, "affected_rows", None)
                if affected is None:
                    # pgwire: command tag "UPDATE n"
                    affected = int((res.command or "UPDATE 0").split()[-1])
                if affected == 1:
                    return {**op, "type": "ok"}
                return {**op, "type": "fail", "error": "cas-miss"}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return self._info(op, e)
        except (PgError, MysqlError) as e:
            return self._fail(op, e)


class BankClient(_Base):
    """Bank transfers in explicit transactions.
    (reference: tests/bank.clj clients in cockroach/tidb suites)"""

    TABLE = "accounts"

    def setup(self, test):
        self._exec_ddl(
            f"CREATE TABLE IF NOT EXISTS {self.TABLE} "
            "(id INT PRIMARY KEY, balance INT)"
        )
        n = len(test.get("accounts", range(8)))
        total = test.get("total-amount", 100)
        per = total // n
        first = total - per * (n - 1)
        for i, acct in enumerate(test.get("accounts", range(8))):
            try:
                self.conn.query(
                    self.conn.upsert(
                        self.TABLE, int(acct), "balance",
                        first if i == 0 else per,
                    )
                )
            except (PgError, MysqlError, IndeterminateError):
                pass

    def invoke(self, test, op):
        try:
            if op["f"] == "read":
                res = self.conn.query(
                    f"SELECT id, balance FROM {self.TABLE}"
                )
                value = {int(r[0]): int(r[1]) for r in res.rows}
                return {**op, "type": "ok", "value": value}
            if op["f"] == "transfer":
                frm, to = int(op["value"]["from"]), int(op["value"]["to"])
                amt = int(op["value"]["amount"])
                self.conn.query("BEGIN")
                try:
                    res = self.conn.query(
                        f"SELECT balance FROM {self.TABLE} WHERE id = {frm}"
                    )
                    bal = int(res.rows[0][0]) if res.rows else None
                    if bal is None or (
                        bal < amt and not test.get("negative-balances?")
                    ):
                        self.conn.query("ROLLBACK")
                        return {**op, "type": "fail",
                                "error": "insufficient funds"}
                    self.conn.query(
                        f"UPDATE {self.TABLE} SET balance = balance - {amt} "
                        f"WHERE id = {frm}"
                    )
                    self.conn.query(
                        f"UPDATE {self.TABLE} SET balance = balance + {amt} "
                        f"WHERE id = {to}"
                    )
                    self.conn.query("COMMIT")
                    return {**op, "type": "ok"}
                except (PgError, MysqlError) as e:
                    try:
                        self.conn.query("ROLLBACK")
                    except Exception:
                        pass
                    return self._fail(op, e)
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return self._info(op, e)
        except (PgError, MysqlError) as e:
            return self._fail(op, e)


class SetClient(_Base):
    """Unique-element set: ``sets (val int)``.
    (reference: tidb sets.clj, cockroach sets.clj)"""

    TABLE = "sets"

    def setup(self, test):
        self._exec_ddl(
            f"CREATE TABLE IF NOT EXISTS {self.TABLE} (val INT)"
        )

    def invoke(self, test, op):
        try:
            if op["f"] == "add":
                self.conn.query(
                    f"INSERT INTO {self.TABLE} (val) VALUES "
                    f"({int(op['value'])})"
                )
                return {**op, "type": "ok"}
            if op["f"] == "read":
                res = self.conn.query(f"SELECT val FROM {self.TABLE}")
                return {**op, "type": "ok",
                        "value": sorted(int(r[0]) for r in res.rows)}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return self._info(op, e)
        except (PgError, MysqlError) as e:
            return self._fail(op, e)


class CounterClient(_Base):
    """Plain-int counter: SQL has no counter column type, so a single
    row's int is bumped with column arithmetic and reads return the
    current value.  (reference: yugabyte ysql/counter.clj:12-28 —
    ``UPDATE counter SET count = count + ? WHERE id = 0``)"""

    TABLE = "counters"

    def setup(self, test):
        self._exec_ddl(
            f"CREATE TABLE IF NOT EXISTS {self.TABLE} "
            "(id INT PRIMARY KEY, count INT)"
        )
        try:
            self.conn.query(
                f"INSERT INTO {self.TABLE} (id, count) VALUES (0, 0)"
            )
        except (PgError, MysqlError):
            pass  # row already seeded by another worker

    def invoke(self, test, op):
        try:
            if op["f"] == "add":
                self.conn.query(
                    f"UPDATE {self.TABLE} SET count = count + "
                    f"{int(op['value'])} WHERE id = 0"
                )
                return {**op, "type": "ok"}
            if op["f"] == "read":
                res = self.conn.query(
                    f"SELECT count FROM {self.TABLE} WHERE id = 0"
                )
                v = int(res.rows[0][0]) if res.rows else 0
                return {**op, "type": "ok", "value": v}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return self._info(op, e)
        except (PgError, MysqlError) as e:
            return self._fail(op, e)


class AppendClient(_Base):
    """Elle list-append txns over ``lists (id, vals text)``: each micro-op
    batch runs in one transaction; reads parse the comma-joined list.
    (reference: tests/cycle/append.clj clients in tidb txn.clj,
    yugabyte ysql append.clj)"""

    TABLE = "lists"

    def setup(self, test):
        self._exec_ddl(
            f"CREATE TABLE IF NOT EXISTS {self.TABLE} "
            "(id INT PRIMARY KEY, vals TEXT)"
        )

    def invoke(self, test, op):
        txn = op["value"]
        out = []
        try:
            self.conn.query("BEGIN")
            try:
                for f, k, v in txn:
                    if f == "r":
                        res = self.conn.query(
                            f"SELECT vals FROM {self.TABLE} "
                            f"WHERE id = {int(k)}"
                        )
                        raw = res.rows[0][0] if res.rows else None
                        vals = ([int(x) for x in raw.split(",") if x != ""]
                                if raw else [])
                        out.append(["r", k, vals])
                    elif f == "append":
                        self.conn.query(
                            self.conn.concat_append(self.TABLE, int(k), v)
                        )
                        out.append(["append", k, v])
                    else:
                        raise ValueError(f"unknown micro-op {f!r}")
                self.conn.query("COMMIT")
                return {**op, "type": "ok", "value": out}
            except (PgError, MysqlError) as e:
                try:
                    self.conn.query("ROLLBACK")
                except Exception:
                    pass
                return self._fail(op, e)
        except IndeterminateError as e:
            return self._info(op, e)


class TxnClient(_Base):
    """Read/write micro-op transactions over ``txns (id, val int)`` —
    serves the long-fork and rw-register (Elle) workloads, whose ops
    carry ``[["r", k, None], ["w", k, v], …]`` micro-op lists under f
    "txn"/"read"/"write".  (reference: tidb txn.clj, dgraph wr.clj,
    tests/long_fork.clj:38-48)"""

    TABLE = "txns"

    def setup(self, test):
        self._exec_ddl(
            f"CREATE TABLE IF NOT EXISTS {self.TABLE} "
            "(id INT PRIMARY KEY, val INT)"
        )

    def invoke(self, test, op):
        txn = op["value"]
        out = []
        try:
            self.conn.query("BEGIN")
            try:
                for f, k, v in txn:
                    if f == "r":
                        res = self.conn.query(
                            f"SELECT val FROM {self.TABLE} "
                            f"WHERE id = {int(k)}"
                        )
                        val = (int(res.rows[0][0])
                               if res.rows and res.rows[0][0] is not None
                               else None)
                        out.append(["r", k, val])
                    elif f == "w":
                        self.conn.query(
                            self.conn.upsert(self.TABLE, int(k), "val",
                                             int(v))
                        )
                        out.append(["w", k, v])
                    else:
                        raise ValueError(f"unknown micro-op {f!r}")
                self.conn.query("COMMIT")
                return {**op, "type": "ok", "value": out}
            except (PgError, MysqlError) as e:
                try:
                    self.conn.query("ROLLBACK")
                except Exception:
                    pass
                return self._fail(op, e)
        except IndeterminateError as e:
            return self._info(op, e)


CLIENTS = {
    "register": RegisterClient,
    "bank": BankClient,
    "set": SetClient,
    "counter": CounterClient,
    "list-append": AppendClient,
    "long-fork": TxnClient,
    "rw-register": TxnClient,
}


def client_for(workload: str, opts: dict) -> client_mod.Client:
    try:
        cls = CLIENTS[workload]
    except KeyError:
        raise KeyError(
            f"no SQL client for workload {workload!r}; have {sorted(CLIENTS)}"
        )
    return cls(opts)
