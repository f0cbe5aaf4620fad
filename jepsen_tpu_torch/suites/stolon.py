"""Stolon (HA PostgreSQL) suite.

The port's copy of :mod:`jepsen_tpu.suites.stolon`.

Reference: stolon/src/jepsen/stolon/{db,client,append,set,bank}.clj —
install PostgreSQL from the pgdg apt repo (db.clj:44-60) plus the
stolon release tarball; each node runs a ``stolon-keeper`` (manages the
local postgres), a ``stolon-sentinel`` (leader election via the store),
and a ``stolon-proxy`` (routes clients to the master, port 25432);
cluster state lives in an etcd/consul store (db.clj:27-43,62-150).
Clients speak pgwire through the proxy via :mod:`.sql` (dialect
``pg``).
"""

from __future__ import annotations

import itertools as _itertools
import threading as _threading

from typing import Optional

from ..control import util as cu
from ..control import execute, sudo
from ..os_setup import debian
from . import common, sql

DIR = "/opt/stolon"
PROXY_PORT = 25432
CLUSTER = "jepsen"
STORE_PORT = 2379  # etcd store endpoints (reference: db.clj:62-70)
DEFAULT_TARBALL = (
    "https://github.com/sorintlab/stolon/releases/download/v0.16.0/"
    "stolon-v0.16.0-linux-amd64.tar.gz"
)


class StolonDB(common.DaemonDB):
    dir = DIR
    binary = "bin/stolon-keeper"
    logfile = f"{DIR}/keeper.log"    # (reference: db.clj:31-33)
    pidfile = f"{DIR}/keeper.pid"
    sentinel_logfile = f"{DIR}/sentinel.log"
    sentinel_pidfile = f"{DIR}/sentinel.pid"
    proxy_logfile = f"{DIR}/proxy.log"
    proxy_pidfile = f"{DIR}/proxy.pid"

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.tarball = (opts or {}).get("tarball", DEFAULT_TARBALL)

    def install(self, test, node):
        # (reference: db.clj:44-60 install-pg! — pgdg apt repo)
        debian.install(["postgresql-12", "postgresql-client-12"])
        with sudo():
            execute("systemctl", "stop", "postgresql", check=False)
            cu.install_archive(self.tarball, DIR)

    def _store_endpoints(self, test) -> str:
        return ",".join(
            f"http://{n}:{STORE_PORT}" for n in test["nodes"]
        )

    def start(self, test, node):
        store = [
            "--store-backend", "etcdv3",
            "--store-endpoints", self._store_endpoints(test),
        ]
        if node == test["nodes"][0]:
            execute(
                f"{DIR}/bin/stolonctl", "init", "--cluster-name", CLUSTER,
                *store, "-y", check=False,
            )
        cu.start_daemon(
            {"logfile": self.sentinel_logfile,
             "pidfile": self.sentinel_pidfile, "chdir": DIR},
            f"{DIR}/bin/stolon-sentinel",
            "--cluster-name", CLUSTER, *store,
        )
        cu.start_daemon(
            {"logfile": self.logfile, "pidfile": self.pidfile, "chdir": DIR},
            f"{DIR}/bin/stolon-keeper",
            "--cluster-name", CLUSTER, *store,
            "--uid", f"keeper{test['nodes'].index(node)}",
            "--data-dir", f"{DIR}/data",
            "--pg-listen-address", str(node),
            "--pg-su-password", "pw",
            "--pg-repl-username", "repl",
            "--pg-repl-password", "pw",
            "--pg-bin-path", "/usr/lib/postgresql/12/bin",
        )
        cu.start_daemon(
            {"logfile": self.proxy_logfile, "pidfile": self.proxy_pidfile,
             "chdir": DIR},
            f"{DIR}/bin/stolon-proxy",
            "--cluster-name", CLUSTER, *store,
            "--listen-address", "0.0.0.0",
            "--port", str(PROXY_PORT),
        )

    def kill(self, test, node):
        for pidfile, name in [
            (self.proxy_pidfile, "stolon-proxy"),
            (self.pidfile, "stolon-keeper"),
            (self.sentinel_pidfile, "stolon-sentinel"),
        ]:
            cu.stop_daemon(pidfile=pidfile, cmd=name)
        cu.grepkill("postgres")

    def await_ready(self, test, node):
        cu.await_tcp_port(PROXY_PORT, timeout_s=300)

    def wipe(self, test, node):
        with sudo():
            execute("rm", "-rf", f"{DIR}/data")

    def log_files(self, test, node):
        return [self.logfile, self.sentinel_logfile, self.proxy_logfile]


def _opts(opts: Optional[dict]) -> dict:
    o = dict(opts or {})
    o.setdefault("dialect", "pg")
    o.setdefault("port", PROXY_PORT)
    o.setdefault("user", "postgres")
    o.setdefault("password", "pw")
    return o


def db(opts: Optional[dict] = None):
    return StolonDB(opts)


def client(opts: Optional[dict] = None):
    return sql.RegisterClient(_opts(opts))


WORKLOADS = ("register", "bank", "set", "list-append")


def workloads(opts: Optional[dict] = None) -> dict:
    opts = _opts(opts)
    out = {w: common.generic_workload(w, opts) for w in WORKLOADS}
    # the double-spend probe (reference: stolon/ledger.clj)
    out["ledger"] = ledger_workload(opts)
    return out


def test(opts: Optional[dict] = None) -> dict:
    opts = _opts(opts)
    wname = opts.get("workload", "list-append")
    w = workloads(opts)[wname]
    c = (
        LedgerClient(opts)
        if wname == "ledger"
        else sql.client_for(wname, opts)
    )
    return common.build_test(
        f"stolon-{wname}", opts, db=StolonDB(opts),
        client=c, workload=w,
    )


# ---------------------------------------------------------------------
# ledger: the double-spend probe
# (reference: stolon/src/jepsen/stolon/ledger.clj)
# ---------------------------------------------------------------------

LEDGER_TABLE = "ledger"


class LedgerClient(sql._Base):
    """A bank ledger where each transfer is a row; withdrawals insert
    only if the account's balance (summed from the other rows, inside
    the same transaction) stays non-negative — so a double-spend race
    is exactly a G2-item anomaly made concrete.

    Reference: ledger.clj — add-entry!/balance-select (:27-52),
    transfer!'s read-then-conditionally-insert with a jitter sleep
    between (:54-69), per-client unique row ids (:74-131)."""

    dialect = "pg"

    #: row-id counter shared across worker clones (class-level so every
    #: open()ed copy draws from one sequence; CPython's itertools.count
    #: is safe under the GIL but the lock keeps that explicit)
    _ids = _itertools.count(1)
    _ids_lock = _threading.Lock()

    ISOLATION_LEVELS = (
        "SERIALIZABLE", "REPEATABLE READ",
        "READ COMMITTED", "READ UNCOMMITTED",
    )

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        # validate ONCE, where a raise aborts test construction — a
        # per-invoke raise would be downgraded to info ops and the
        # misconfigured run would pass vacuously
        self.isolation = (
            str(self.opts.get("isolation", "serializable"))
            .upper()
            .replace("-", " ")
        )
        if self.isolation not in self.ISOLATION_LEVELS:
            raise ValueError(
                f"unknown isolation {self.isolation!r}; "
                f"expected one of {self.ISOLATION_LEVELS}"
            )

    def _next_id(self) -> int:
        with LedgerClient._ids_lock:
            return next(LedgerClient._ids)

    def setup(self, test):
        self._exec_ddl(
            f"CREATE TABLE IF NOT EXISTS {LEDGER_TABLE} "
            "(id INT PRIMARY KEY, account INT NOT NULL, "
            "amount INT NOT NULL)"
        )

    def invoke(self, test, op):
        import random as _random
        import time as _time

        account, amount = op["value"]
        rid = self._next_id()
        # the double-spend is only an anomaly under serializability —
        # at read committed two concurrent balance checks passing is
        # LEGAL, so without this the checker would flag healthy
        # clusters (reference: ledger.clj:117-121 sets the test's
        # isolation on every connection; validated in __init__)
        try:
            try:
                self.conn.query(
                    f"BEGIN ISOLATION LEVEL {self.isolation}"
                )
            except (sql.PgError, sql.MysqlError) as e:
                # a refused BEGIN is a definite failure, like every
                # other sql client's error path
                return self._fail(op, e)
            try:
                if amount > 0:
                    self.conn.query(
                        f"INSERT INTO {LEDGER_TABLE} (id, account, amount) "
                        f"VALUES ({rid}, {int(account)}, {int(amount)})"
                    )
                    ok = True
                else:
                    res = self.conn.query(
                        f"SELECT amount FROM {LEDGER_TABLE} "
                        f"WHERE account = {int(account)} AND id != {rid}"
                    )
                    balance = sum(int(r[0]) for r in res.rows)
                    if balance + amount < 0:
                        ok = False
                    else:
                        # the jitter widens the double-spend window
                        # (reference: ledger.clj:66)
                        _time.sleep(_random.random() * 0.01)
                        self.conn.query(
                            f"INSERT INTO {LEDGER_TABLE} "
                            "(id, account, amount) "
                            f"VALUES ({rid}, {int(account)}, {int(amount)})"
                        )
                        ok = True
                self.conn.query("COMMIT")
                return {**op, "type": "ok" if ok else "fail"}
            except (sql.PgError, sql.MysqlError) as e:
                try:
                    self.conn.query("ROLLBACK")
                except Exception:
                    pass
                return self._fail(op, e)
        except sql.IndeterminateError as e:
            return self._info(op, e)


class LedgerChecker(common.checker_mod.Checker):
    """Every account's most-charitable balance (deposits count even
    when indeterminate; withdrawals only when acknowledged) must be
    exactly zero-or-positive... the reference flags ANY nonzero
    balance, since its generator funds then fully drains each account.
    We flag only negative balances — a double-spend's signature — so
    the checker also serves the random-transfer generator.
    (reference: ledger.clj:139-163 check-account/checker)"""

    def check(self, test, history, opts=None):
        from ..history import OK, INFO

        per_account: dict = {}
        for op in history:
            if op.f != "transfer" or op.type not in (OK, INFO):
                continue
            account, amount = op.value
            if amount > 0 or op.type == OK:
                per_account[account] = per_account.get(account, 0) + amount
        errs = [
            {"account": a, "balance": b}
            for a, b in sorted(per_account.items())
            if b < 0
        ]
        return {"valid?": not errs, "errors": errs[:10]}


class _LedgerGen(common.gen.Generator):
    """Fund each account, then attempt a burst of double-spends.
    (reference: ledger.clj:165-173 fund-then-double-spend-gen)"""

    def __init__(self, account: int = 0, queue: tuple = ()):
        self.account = account
        self.queue = queue

    def op(self, test, ctx):
        queue = self.queue
        account = self.account
        if not queue:
            burst = 2 ** common.gen.rng.randrange(5)
            queue = ((account, 10),) + ((account, -9),) * burst
            account += 1
        filled = common.gen.fill_in_op(
            {"f": "transfer", "value": list(queue[0])}, ctx
        )
        if filled == common.gen.PENDING:
            return (common.gen.PENDING, self)
        return (filled, _LedgerGen(account, queue[1:]))

    def update(self, test, ctx, event):
        return self


def ledger_workload(opts: Optional[dict] = None) -> dict:
    """(reference: ledger.clj:184-189 workload)"""
    return {"generator": _LedgerGen(), "checker": LedgerChecker()}
