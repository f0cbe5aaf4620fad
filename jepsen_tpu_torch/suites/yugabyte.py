"""YugabyteDB suite — the port's copy of :mod:`jepsen_tpu.suites.yugabyte`.

Reference: yugabyte/src/yugabyte/* — the largest reference suite
(~3.6k LoC): a tarball install with ``yb-master`` processes on the
first ``replication-factor`` nodes and ``yb-tserver`` everywhere
(auto.clj:49-140), and two API families for every workload:

- **YCQL** (Cassandra protocol, port 9042): bank, counter, set,
  single/multi-key-acid, long-fork (yugabyte/ycql/*.clj)
- **YSQL** (PostgreSQL protocol, port 5433): bank, append, long-fork,
  default-value (yugabyte/ysql/*.clj)

YCQL clients here ride :mod:`.proto.cql` (LWT ``IF`` conditions give
CAS); YSQL clients reuse the shared :mod:`.sql` pgwire clients.
"""

from __future__ import annotations

from typing import Optional

from .. import client as client_mod
from .. import independent
from ..control import util as cu
from ..control import execute, sudo
from . import common, sql, yb_nemesis
from .proto import IndeterminateError
from .proto.cql import CqlClient, CqlError

DIR = "/opt/yugabyte"  # (reference: auto.clj dir)
MASTER_RPC_PORT = 7100
TSERVER_RPC_PORT = 9100
YCQL_PORT = 9042
YSQL_PORT = 5433
DEFAULT_TARBALL = (
    "https://downloads.yugabyte.com/yugabyte-2.1.2.0-linux.tar.gz"
)
KEYSPACE = "jepsen"


class YugabyteDB(common.DaemonDB):
    """yb-master on the first RF nodes, yb-tserver everywhere.
    (reference: auto.clj:57-76 master-nodes, 90-140 start!)"""

    dir = DIR
    binary = "bin/yb-tserver"
    logfile = f"{DIR}/tserver.log"
    pidfile = f"{DIR}/tserver.pid"
    master_logfile = f"{DIR}/master.log"
    master_pidfile = f"{DIR}/master.pid"

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.tarball = (opts or {}).get("tarball", DEFAULT_TARBALL)
        self.rf = (opts or {}).get("replication-factor", 3)

    def master_nodes(self, test):
        return test["nodes"][: min(self.rf, len(test["nodes"]))]

    def master_addresses(self, test) -> str:
        return ",".join(
            f"{n}:{MASTER_RPC_PORT}" for n in self.master_nodes(test)
        )

    def install(self, test, node):
        with sudo():
            cu.install_archive(self.tarball, DIR)
            execute(f"{DIR}/bin/post_install.sh", check=False)

    def start(self, test, node):
        if node in self.master_nodes(test):
            self.start_master(test, node)
            cu.await_tcp_port(MASTER_RPC_PORT, timeout_s=120)
        self.start_tserver(test, node)

    # granular component control — the per-suite nemesis targets
    # masters and tservers separately (reference: auto.clj
    # start-master!/start-tserver!/stop-*/kill-*, consumed by
    # yugabyte/nemesis.clj:12-46 process-nemesis)

    def start_master(self, test, node):
        if node not in self.master_nodes(test):
            return "not a master node"
        masters = self.master_addresses(test)
        cu.start_daemon(
            {"logfile": self.master_logfile,
             "pidfile": self.master_pidfile, "chdir": DIR},
            f"{DIR}/bin/yb-master",
            "--master_addresses", masters,
            "--rpc_bind_addresses", f"{node}:{MASTER_RPC_PORT}",
            "--fs_data_dirs", f"{DIR}/data/master",
            "--replication_factor", str(self.rf),
        )
        return "started"

    def start_tserver(self, test, node):
        masters = self.master_addresses(test)
        cu.start_daemon(
            {"logfile": self.logfile, "pidfile": self.pidfile, "chdir": DIR},
            f"{DIR}/bin/yb-tserver",
            "--tserver_master_addrs", masters,
            "--rpc_bind_addresses", f"{node}:{TSERVER_RPC_PORT}",
            "--fs_data_dirs", f"{DIR}/data/tserver",
            "--start_pgsql_proxy",
            "--pgsql_proxy_bind_address", f"0.0.0.0:{YSQL_PORT}",
            "--cql_proxy_bind_address", f"0.0.0.0:{YCQL_PORT}",
        )
        return "started"

    def stop_master(self, test, node):
        cu.stop_daemon(pidfile=self.master_pidfile, cmd="yb-master")
        return "stopped"

    def stop_tserver(self, test, node):
        cu.stop_daemon(pidfile=self.pidfile, cmd="yb-tserver")
        return "stopped"

    def kill_master(self, test, node):
        cu.grepkill("yb-master", 9)
        return "killed"

    def kill_tserver(self, test, node):
        cu.grepkill("yb-tserver", 9)
        return "killed"

    def kill(self, test, node):
        cu.stop_daemon(pidfile=self.pidfile, cmd="yb-tserver")
        cu.stop_daemon(pidfile=self.master_pidfile, cmd="yb-master")

    def await_ready(self, test, node):
        cu.await_tcp_port(YCQL_PORT, timeout_s=300)

    def wipe(self, test, node):
        with sudo():
            execute("rm", "-rf", f"{DIR}/data")

    def log_files(self, test, node):
        return [self.logfile, self.master_logfile]


# ---------------------------------------------------------------------
# YCQL clients (reference: yugabyte/ycql/*.clj)
# ---------------------------------------------------------------------


class YcqlRegisterClient(client_mod.Client):
    """Per-key CAS registers with LWT: writes unconditional, CAS via
    ``IF val = old`` (reference: ycql/single_key_acid.clj)."""

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}
        self.conn: Optional[CqlClient] = None

    def open(self, test, node):
        c = type(self)(self.opts)
        c.conn = CqlClient(
            self.opts.get("host", str(node)),
            self.opts.get("port", YCQL_PORT),
            timeout=self.opts.get("timeout", 10.0),
        )
        return c

    def setup(self, test):
        for stmt in (
            f"CREATE KEYSPACE IF NOT EXISTS {KEYSPACE}",
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.registers "
            "(id int PRIMARY KEY, val int)",
        ):
            try:
                self.conn.query(stmt)
            except (CqlError, IndeterminateError):
                pass

    def invoke(self, test, op):
        k, v = op["value"]
        t = f"{KEYSPACE}.registers"
        try:
            if op["f"] == "read":
                res = self.conn.query(
                    f"SELECT val FROM {t} WHERE id = {int(k)}",
                    consistency="quorum",
                )
                val = res.cell_int(res.rows[0], 0) if res.rows else None
                return {**op, "type": "ok", "value": independent.kv(k, val)}
            if op["f"] == "write":
                self.conn.query(
                    f"INSERT INTO {t} (id, val) VALUES ({int(k)}, {int(v)})"
                )
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = v
                res = self.conn.query(
                    f"UPDATE {t} SET val = {int(new)} WHERE id = {int(k)} "
                    f"IF val = {int(old)}"
                )
                applied = bool(res.rows) and res.cell_bool(res.rows[0], 0)
                if applied:
                    return {**op, "type": "ok"}
                return {**op, "type": "fail", "error": "cas-miss"}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except CqlError as e:
            if e.timeout:
                return {**op, "type": "info", "error": str(e)}
            return {**op, "type": "fail", "error": str(e)}

    def close(self, test):
        if self.conn:
            self.conn.close()


class YcqlSetClient(client_mod.Client):
    """Set workload: one row per element (reference: ycql/set.clj)."""

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}
        self.conn: Optional[CqlClient] = None

    def open(self, test, node):
        c = type(self)(self.opts)
        c.conn = CqlClient(
            self.opts.get("host", str(node)),
            self.opts.get("port", YCQL_PORT),
            timeout=self.opts.get("timeout", 10.0),
        )
        return c

    def setup(self, test):
        for stmt in (
            f"CREATE KEYSPACE IF NOT EXISTS {KEYSPACE}",
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.elements "
            "(val int PRIMARY KEY)",
        ):
            try:
                self.conn.query(stmt)
            except (CqlError, IndeterminateError):
                pass

    def invoke(self, test, op):
        t = f"{KEYSPACE}.elements"
        try:
            if op["f"] == "add":
                self.conn.query(
                    f"INSERT INTO {t} (val) VALUES ({int(op['value'])})"
                )
                return {**op, "type": "ok"}
            if op["f"] == "read":
                res = self.conn.query(f"SELECT val FROM {t}",
                                      consistency="quorum")
                return {**op, "type": "ok",
                        "value": sorted(res.cell_int(r, 0) for r in res.rows)}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except CqlError as e:
            if e.timeout:
                return {**op, "type": "info", "error": str(e)}
            return {**op, "type": "fail", "error": str(e)}

    def close(self, test):
        if self.conn:
            self.conn.close()


# ---------------------------------------------------------------------


def _ysql_opts(opts: Optional[dict]) -> dict:
    o = dict(opts or {})
    o.setdefault("dialect", "pg")
    o.setdefault("port", YSQL_PORT)
    o.setdefault("user", "postgres")
    return o


def db(opts: Optional[dict] = None):
    return YugabyteDB(opts)


def client(opts: Optional[dict] = None):
    return YcqlRegisterClient(opts)


class YcqlCounterClient(client_mod.Client):
    """Counter column increments (reference: ycql/counter.clj)."""

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}
        self.conn: Optional[CqlClient] = None

    def open(self, test, node):
        c = type(self)(self.opts)
        c.conn = CqlClient(
            self.opts.get("host", str(node)),
            self.opts.get("port", YCQL_PORT),
            timeout=self.opts.get("timeout", 10.0),
        )
        return c

    def setup(self, test):
        for stmt in (
            f"CREATE KEYSPACE IF NOT EXISTS {KEYSPACE}",
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.counters "
            "(id int PRIMARY KEY, val counter)",
        ):
            try:
                self.conn.query(stmt)
            except (CqlError, IndeterminateError):
                pass

    def invoke(self, test, op):
        t = f"{KEYSPACE}.counters"
        try:
            if op["f"] == "add":
                self.conn.query(
                    f"UPDATE {t} SET val = val + {int(op['value'])} "
                    "WHERE id = 0"
                )
                return {**op, "type": "ok"}
            if op["f"] == "read":
                res = self.conn.query(
                    f"SELECT val FROM {t} WHERE id = 0",
                    consistency="quorum",
                )
                val = res.cell_int(res.rows[0], 0) if res.rows else 0
                return {**op, "type": "ok", "value": val or 0}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except CqlError as e:
            if e.timeout:
                return {**op, "type": "info", "error": str(e)}
            return {**op, "type": "fail", "error": str(e)}

    def close(self, test):
        if self.conn:
            self.conn.close()


def workloads(opts: Optional[dict] = None) -> dict:
    """ycql.* and ysql.* workload names, like the reference's
    workload-per-API naming (runner.clj).  single-key-acid is the
    reference's name for the per-key linearizable CAS-register probe
    (single_key_acid.clj:1-45: 2n-thread key groups, half writers/CAS,
    half readers) — the same shape as the register workload, exposed
    under both names so reference users find it."""
    opts = dict(opts or {})
    out = {}
    for w in ("register", "set", "counter"):
        out[f"ycql.{w}"] = common.generic_workload(w, opts)
    for w in ("register", "bank", "set", "counter", "list-append",
              "long-fork"):
        out[f"ysql.{w}"] = common.generic_workload(w, _ysql_opts(opts))
    out["ycql.single-key-acid"] = common.generic_workload("register", opts)
    out["ysql.single-key-acid"] = common.generic_workload(
        "register", _ysql_opts(opts)
    )
    # the CQL transfer is unconditional balance arithmetic (no read
    # inside the txn), so balances legitimately go negative — the
    # reference pairs it with the allow-negative bank workload
    # (yugabyte/bank.clj:13-14 workload-allow-neg, bank.clj:183)
    out["ycql.bank"] = common.generic_workload(
        "bank", {**opts, "negative-balances?": True}
    )
    out["ycql.long-fork"] = common.generic_workload("long-fork", opts)
    # list-append with one table per key (reference: ysql/append_table
    # .clj); the txn checker is the shared elle list-append checker
    out["ysql.append-table"] = common.generic_workload(
        "list-append", _ysql_opts(opts)
    )
    out["ysql.multi-key-acid"] = multi_key_acid_workload(opts)
    out["ycql.multi-key-acid"] = multi_key_acid_workload(opts)
    out["ysql.default-value"] = default_value_workload(opts)
    return out


_YCQL_CLIENTS = {
    "register": YcqlRegisterClient,
    "single-key-acid": YcqlRegisterClient,
    "set": YcqlSetClient,
    "counter": YcqlCounterClient,
}


def _client_for(wname: str, opts: dict) -> client_mod.Client:
    api, _, w = wname.partition(".")
    if api == "ycql":
        if w == "multi-key-acid":
            return YcqlMultiKeyAcidClient(opts)
        if w == "bank":
            return YcqlBankClient(opts)
        if w == "long-fork":
            return YcqlLongForkClient(opts)
        return _YCQL_CLIENTS[w](opts)
    if w == "multi-key-acid":
        return MultiKeyAcidClient(_ysql_opts(opts))
    if w == "default-value":
        return DefaultValueClient(_ysql_opts(opts))
    if w == "append-table":
        return AppendTableClient(_ysql_opts(opts))
    if w == "single-key-acid":
        w = "register"
    return sql.client_for(w, _ysql_opts(opts))


def test(opts: Optional[dict] = None) -> dict:
    opts = dict(opts or {})
    wname = opts.get("workload", "ycql.register")
    w = workloads(opts)[wname]
    db_ = YugabyteDB(opts)
    # the suite fault menu (master/tserver targeting, partition
    # geometries, clock skew) takes over when any of its fault names is
    # requested (reference: yugabyte/nemesis.clj:240-247)
    pkg = None
    if set(opts.get("faults", ())) & yb_nemesis.KNOWN_FAULTS:
        pkg = common.suite_nemesis_package(
            opts, db_, yb_nemesis.package(opts, db_),
            yb_nemesis.KNOWN_FAULTS,
        )
    return common.build_test(
        f"yugabyte-{wname}", opts, db=db_,
        client=_client_for(wname, opts), workload=w,
        nemesis_package=pkg,
    )


# ---------------------------------------------------------------------
# multi-key ACID (YSQL)
# ---------------------------------------------------------------------

MKA_TABLE = "multi_key_acid"
MKA_KEYS = (0, 1, 2)


class MultiKeyAcidClient(sql._Base):
    """Transactional writes over a composite-key table, checked as a
    linearizable multi-register per independent key.

    Reference: yugabyte/src/yugabyte/ysql/multi_key_acid.clj:14-52 — one
    table (k1, k2, val, PK (k1, k2)); :write runs every [w k1 v] mop as
    an upsert inside one transaction, :read selects the k1s of its mops
    and rewrites them with the observed values.
    """

    dialect = "pg"

    def setup(self, test):
        self._exec_ddl(
            f"CREATE TABLE IF NOT EXISTS {MKA_TABLE} "
            "(k1 INT, k2 INT, val INT, PRIMARY KEY (k1, k2))"
        )

    def _upsert(self, k1: int, k2: int, v: int) -> str:
        if self.dialect == "cockroach":
            return (
                f"UPSERT INTO {MKA_TABLE} (k1, k2, val) "
                f"VALUES ({k1}, {k2}, {v})"
            )
        if self.dialect == "mysql":
            return (
                f"INSERT INTO {MKA_TABLE} (k1, k2, val) "
                f"VALUES ({k1}, {k2}, {v}) "
                f"ON DUPLICATE KEY UPDATE val = {v}"
            )
        return (
            f"INSERT INTO {MKA_TABLE} (k1, k2, val) "
            f"VALUES ({k1}, {k2}, {v}) "
            f"ON CONFLICT (k1, k2) DO UPDATE SET val = {v}"
        )

    def invoke(self, test, op):
        k2, mops = op["value"]
        try:
            if op["f"] == "read":
                k1s = sorted({k for _f, k, _v in mops})
                in_list = ", ".join(str(k) for k in k1s)
                res = self.conn.query(
                    f"SELECT k1, val FROM {MKA_TABLE} "
                    f"WHERE k2 = {k2} AND k1 IN ({in_list})"
                )
                got = {int(r[0]): (None if r[1] is None else int(r[1]))
                       for r in res.rows}
                out = [[f, k, got.get(k)] for f, k, _v in mops]
                return {**op, "type": "ok",
                        "value": independent.kv(k2, out)}
            if op["f"] == "write":
                self.conn.query("BEGIN")
                try:
                    for f, k1, v in mops:
                        assert f == "w", f
                        self.conn.query(self._upsert(k1, k2, v))
                    self.conn.query("COMMIT")
                except Exception:
                    try:
                        self.conn.query("ROLLBACK")
                    except Exception:
                        pass
                    raise
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return self._info(op, e)
        except (sql.PgError, sql.MysqlError) as e:
            return self._fail(op, e)


def multi_key_acid_workload(opts: Optional[dict] = None) -> dict:
    """Random read/write transactions over 3 sub-keys per independent
    key, checked linearizable against the multi-register model.
    (reference: yugabyte/src/yugabyte/multi_key_acid.clj:40-72)

    Reads of absent rows surface as None mops, which the model treats
    as always-legal — the same semantics as the reference's
    MultiRegister ("Nil reads are always legal",
    multi_key_acid.clj:22-27), so a vanished row is only caught once a
    non-None read of that key disagrees with the model state.  The check
    runs where ``opts["device"]`` says."""
    import random as _random

    from .. import checker as checker_mod
    from .. import models
    from .. import util as util_mod

    opts = dict(opts or {})
    n = max(1, len(opts.get("nodes", ["n1"])))

    def r(test, ctx):
        ks = util_mod.random_nonempty_subset(MKA_KEYS)
        return {"type": "invoke", "f": "read",
                "value": [["r", k, None] for k in sorted(ks)]}

    def w(test, ctx):
        ks = util_mod.random_nonempty_subset(MKA_KEYS)
        return {"type": "invoke", "f": "write",
                "value": [["w", k, _random.randint(0, 4)] for k in sorted(ks)]}

    from .. import generator as gen_mod

    def fgen(k):
        return gen_mod.process_limit(
            20, gen_mod.stagger(1 / 20, gen_mod.reserve(n, r, w))
        )

    return {
        "generator": independent.concurrent_generator(
            2 * n, range(100_000), fgen
        ),
        "checker": independent.checker(
            checker_mod.linearizable(models.multi_register({}), pure_fs=(),
                                     device=opts.get("device"))
        ),
        "concurrency": 4 * n,
    }


class YcqlMultiKeyAcidClient(client_mod.Client):
    """The CQL flavor of multi-key ACID: writes ride one
    ``BEGIN TRANSACTION … END TRANSACTION`` statement (YCQL's
    distributed-transaction syntax), reads select the sub-keys with an
    ``IN`` predicate.  Checked by the same linearizable multi-register
    workload as the YSQL flavor.

    Reference: yugabyte/src/yugabyte/ycql/multi_key_acid.clj:13-61 —
    a transactional table (id, ik, val, PK (id, ik)); :write stitches
    its inserts into a single transaction statement, :read rewrites its
    mops with the observed values.
    """

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}
        self.conn: Optional[CqlClient] = None

    def open(self, test, node):
        c = type(self)(self.opts)
        c.conn = CqlClient(
            self.opts.get("host", str(node)),
            self.opts.get("port", YCQL_PORT),
            timeout=self.opts.get("timeout", 10.0),
        )
        return c

    def setup(self, test):
        for stmt in (
            f"CREATE KEYSPACE IF NOT EXISTS {KEYSPACE}",
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.multi_key_acid "
            "(id int, ik int, val int, PRIMARY KEY (id, ik)) "
            "WITH transactions = {'enabled': 'true'}",
        ):
            try:
                self.conn.query(stmt)
            except (CqlError, IndeterminateError):
                pass

    def invoke(self, test, op):
        ik, mops = op["value"]
        t = f"{KEYSPACE}.multi_key_acid"
        try:
            if op["f"] == "read":
                ids = sorted({k for _f, k, _v in mops})
                in_list = ", ".join(str(i) for i in ids)
                res = self.conn.query(
                    f"SELECT id, val FROM {t} "
                    f"WHERE ik = {int(ik)} AND id IN ({in_list})",
                    consistency="quorum",
                )
                got = {
                    res.cell_int(r, 0): res.cell_int(r, 1) for r in res.rows
                }
                out = [[f, k, got.get(k)] for f, k, _v in mops]
                return {**op, "type": "ok", "value": independent.kv(ik, out)}
            if op["f"] == "write":
                inserts = "".join(
                    f"INSERT INTO {t} (id, ik, val) "
                    f"VALUES ({int(k)}, {int(ik)}, {int(v)}); "
                    for f, k, v in mops
                )
                self.conn.query(
                    f"BEGIN TRANSACTION {inserts}END TRANSACTION"
                )
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except CqlError as e:
            if e.timeout:
                return {**op, "type": "info", "error": str(e)}
            return {**op, "type": "fail", "error": str(e)}

    def close(self, test):
        if self.conn:
            self.conn.close()


# ---------------------------------------------------------------------
# YCQL bank (reference: yugabyte/src/yugabyte/ycql/bank.clj:20-58)
# ---------------------------------------------------------------------


class _YcqlBase(client_mod.Client):
    """Shared CQL connection plumbing for the YCQL workload clients."""

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}
        self.conn: Optional[CqlClient] = None

    def open(self, test, node):
        c = type(self)(self.opts)
        c.conn = CqlClient(
            self.opts.get("host", str(node)),
            self.opts.get("port", YCQL_PORT),
            timeout=self.opts.get("timeout", 10.0),
        )
        return c

    def close(self, test):
        if self.conn:
            self.conn.close()

    def _ddl(self, *stmts: str) -> None:
        for stmt in stmts:
            try:
                self.conn.query(stmt)
            except (CqlError, IndeterminateError):
                pass


class YcqlBankClient(_YcqlBase):
    """Bank transfers as one YCQL distributed transaction: two
    balance-arithmetic UPDATEs inside BEGIN/END TRANSACTION; reads are a
    full-table scan.  (reference: ycql/bank.clj:20-58 CQLBank — the
    transfer statement shape at :46-56)"""

    def setup(self, test):
        self._ddl(
            f"CREATE KEYSPACE IF NOT EXISTS {KEYSPACE}",
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.accounts "
            "(id int PRIMARY KEY, balance bigint) "
            "WITH transactions = {'enabled': 'true'}",
        )
        accounts = list(test.get("accounts", range(8)))
        total = test.get("total-amount", 100)
        t = f"{KEYSPACE}.accounts"
        for i, acct in enumerate(accounts):
            bal = total if i == 0 else 0
            self._ddl(
                f"INSERT INTO {t} (id, balance) "
                f"VALUES ({int(acct)}, {int(bal)})"
            )

    def invoke(self, test, op):
        t = f"{KEYSPACE}.accounts"
        try:
            if op["f"] == "read":
                res = self.conn.query(
                    f"SELECT id, balance FROM {t}", consistency="quorum"
                )
                value = {
                    res.cell_int(r, 0): res.cell_int(r, 1) for r in res.rows
                }
                return {**op, "type": "ok", "value": value}
            if op["f"] == "transfer":
                frm = int(op["value"]["from"])
                to = int(op["value"]["to"])
                amt = int(op["value"]["amount"])
                self.conn.query(
                    "BEGIN TRANSACTION "
                    f"UPDATE {t} SET balance = balance - {amt} "
                    f"WHERE id = {frm}; "
                    f"UPDATE {t} SET balance = balance + {amt} "
                    f"WHERE id = {to}; "
                    "END TRANSACTION"
                )
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except CqlError as e:
            if e.timeout:
                return {**op, "type": "info", "error": str(e)}
            return {**op, "type": "fail", "error": str(e)}


class YcqlLongForkClient(_YcqlBase):
    """Long-fork txns over an indexed table: single-row writes, group
    reads through the key2 value index rewritten into the txn mops.
    (reference: ycql/long_fork.clj:13-55 — the index-backed read at
    :31-44, the insert at :46-50)"""

    def setup(self, test):
        self._ddl(
            f"CREATE KEYSPACE IF NOT EXISTS {KEYSPACE}",
            f"CREATE TABLE IF NOT EXISTS {KEYSPACE}.long_fork "
            "(key int PRIMARY KEY, key2 int, val int) "
            "WITH transactions = {'enabled': 'true'}",
            f"CREATE INDEX IF NOT EXISTS long_forks "
            f"ON {KEYSPACE}.long_fork (key2) INCLUDE (val)",
        )

    def invoke(self, test, op):
        t = f"{KEYSPACE}.long_fork"
        txn = op["value"]
        try:
            if op["f"] == "read":
                ks = sorted({k for _f, k, _v in txn})
                in_list = ", ".join(str(k) for k in ks)
                res = self.conn.query(
                    f"SELECT key2, val FROM {t} WHERE key2 IN ({in_list})",
                    consistency="quorum",
                )
                got = {
                    res.cell_int(r, 0): res.cell_int(r, 1) for r in res.rows
                }
                out = [[f, k, got.get(k)] for f, k, _v in txn]
                return {**op, "type": "ok", "value": out}
            if op["f"] == "write":
                [[_f, k, v]] = txn
                self.conn.query(
                    f"INSERT INTO {t} (key, key2, val) "
                    f"VALUES ({int(k)}, {int(k)}, {int(v)})"
                )
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except CqlError as e:
            if e.timeout:
                return {**op, "type": "info", "error": str(e)}
            return {**op, "type": "fail", "error": str(e)}


# ---------------------------------------------------------------------
# YSQL default-value (reference: yugabyte/src/yugabyte/default_value.clj
# and ysql/default_value.clj)
# ---------------------------------------------------------------------

DV_TABLE = "foo"


class DefaultValueClient(sql._Base):
    """Concurrent create/drop-table churn against inserts and reads of a
    table whose second column carries DEFAULT 0; any read observing a
    NULL there is the anomaly.  (reference: ysql/default_value.clj:
    create-table!:41-52, insert!:25-28, read-natural:36-39,
    invoke-op!:104-117 — missing-relation errors fail the op rather
    than crash, like the reference's with-table/catch-dne handling)"""

    dialect = "pg"

    def setup(self, test):
        # the probe simulates a migration against an *existing* table
        # (default_value.clj:1-11); seeding it also keeps short runs
        # from recording zero ok reads/inserts when the generator's
        # 1-in-26 create-table draw comes late
        self._exec_ddl(
            f"CREATE TABLE IF NOT EXISTS {DV_TABLE} "
            "(dummy INT, v INT DEFAULT 0)"
        )

    def invoke(self, test, op):
        try:
            if op["f"] == "create-table":
                self.conn.query(
                    f"CREATE TABLE IF NOT EXISTS {DV_TABLE} "
                    "(dummy INT, v INT DEFAULT 0)"
                )
                return {**op, "type": "ok"}
            if op["f"] == "drop-table":
                self.conn.query(f"DROP TABLE IF EXISTS {DV_TABLE}")
                return {**op, "type": "ok"}
            if op["f"] == "insert":
                self.conn.query(f"INSERT INTO {DV_TABLE} (dummy) VALUES (1)")
                return {**op, "type": "ok"}
            if op["f"] == "read":
                res = self.conn.query(f"SELECT v FROM {DV_TABLE}")
                rows = [
                    None if r[0] is None else int(r[0]) for r in res.rows
                ]
                return {**op, "type": "ok", "value": rows}
            raise ValueError(f"unknown f {op['f']!r}")
        except sql.IndeterminateError as e:
            return self._info(op, e)
        except (sql.PgError, sql.MysqlError) as e:
            # a read/insert racing a drop-table legitimately fails with
            # "does not exist" — an op failure, not a harness crash
            return self._fail(op, e)


class DefaultValueChecker(common.checker_mod.Checker):
    """valid? iff no ok read observed a NULL in the defaulted column.
    (reference: default_value.clj:70-103 bad-row/bad-read/checker)"""

    def check(self, test, history, opts=None):
        from ..history import OK

        reads = [
            op for op in history if op.type == OK and op.f == "read"
        ]
        bad = [
            {"op-index": op.index, "bad-rows": [v for v in (op.value or []) if v is None]}
            for op in reads
            if any(v is None for v in (op.value or []))
        ]
        return {
            "valid?": not bad,
            "read-count": len(reads),
            "bad-read-count": len(bad),
            "bad-reads": bad[:10],
        }


def default_value_workload(opts: Optional[dict] = None) -> dict:
    """DDL churn (create/drop) mixed 1:25 with reads and inserts,
    staggered tightly.  (reference: default_value.clj:generator:60-68)"""
    from .. import generator as gen_mod

    def r(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    def i(test, ctx):
        return {"type": "invoke", "f": "insert", "value": None}

    def create(test, ctx):
        return {"type": "invoke", "f": "create-table", "value": None}

    def drop(test, ctx):
        return {"type": "invoke", "f": "drop-table", "value": None}

    mix = [create, drop] + [r, i] * 25
    return {
        "generator": gen_mod.stagger(1 / 100, gen_mod.mix(mix)),
        "checker": DefaultValueChecker(),
    }


# ---------------------------------------------------------------------
# ysql.append-table: one TABLE per list key (reference:
# yugabyte/src/yugabyte/ysql/append_table.clj)
# ---------------------------------------------------------------------


class AppendTableClient(sql._Base):
    """List-append where each key is its own table and rows are the
    list elements: append = INSERT, read = SELECT ordered by the key
    column.  Tables are created lazily when an op hits
    "relation does not exist" — YB can't CREATE IF NOT EXISTS safely,
    so the reference swallows already-exists races the same way
    (append_table.clj:76-120 create-table!/with-table).

    The reference documents that YB offers no safe transactional row
    order (append_table.clj:10-16) and ships NOW()-keyed inserts
    (insert!, :44-60) plus a COUNT(*)-keyed variant
    (insert-using-count!, :34-42); ``append-table-key`` picks
    ("now"/"count", default "now")."""

    dialect = "pg"

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.key_mode = self.opts.get("append-table-key", "now")

    @staticmethod
    def _table(k) -> str:
        return f"append{int(k)}"

    def _create(self, table: str):
        # straight through conn.query, NOT _exec_ddl: that helper
        # swallows every DDL error, which would hide real CREATE
        # failures; only the already-exists race is benign here
        ddl = (
            f"CREATE TABLE IF NOT EXISTS {table} "
            "(k TIMESTAMP DEFAULT CURRENT_TIMESTAMP, v INT)"
            if self.key_mode == "now" else
            f"CREATE TABLE IF NOT EXISTS {table} (k INT, v INT)"
        )
        try:
            self.conn.query(ddl)
        except (sql.PgError, sql.MysqlError) as e:
            if "already exists" not in str(e):
                raise

    def _mop(self, f, k, v):
        table = self._table(k)
        if f == "r":
            res = self.conn.query(
                f"SELECT k, v FROM {table} ORDER BY k"
            )
            return ["r", k, [int(row[-1]) for row in res.rows]]
        if f == "append":
            if self.key_mode == "count":
                n = int(self.conn.query(
                    f"SELECT count(*) FROM {table}").rows[0][0])
                self.conn.query(
                    f"INSERT INTO {table} (k, v) "
                    f"VALUES ({n}, {int(v)})"
                )
            else:
                self.conn.query(
                    f"INSERT INTO {table} (v) VALUES ({int(v)})"
                )
            return ["append", k, v]
        raise ValueError(f"unknown micro-op {f!r}")

    @staticmethod
    def _missing_table(e) -> bool:
        msg = str(e)
        return ("does not exist" in msg or "no such table" in msg
                or "doesn't exist" in msg)

    def _run_txn(self, txn):
        """One attempt: BEGIN/COMMIT around multi-statement work like
        the reference's with-txn (append_table.clj:131-140; count-mode
        appends are two statements even alone)."""
        use_txn = len(txn) > 1 or (
            self.key_mode == "count"
            and any(f == "append" for f, _k, _v in txn)
        )
        if not use_txn:
            return [self._mop(f, k, v) for f, k, v in txn]
        self.conn.query("BEGIN")
        try:
            out = [self._mop(f, k, v) for f, k, v in txn]
            self.conn.query("COMMIT")
            return out
        except Exception:
            try:
                self.conn.query("ROLLBACK")
            except Exception:  # noqa: BLE001
                pass
            raise

    def invoke(self, test, op):
        txn = op["value"]
        try:
            try:
                out = self._run_txn(txn)
            except (sql.PgError, sql.MysqlError) as e:
                if not self._missing_table(e):
                    raise
                # lazily create every table the txn touches (outside
                # the aborted txn), then retry once
                for _f, k, _v in txn:
                    self._create(self._table(k))
                out = self._run_txn(txn)
            return {**op, "type": "ok", "value": out}
        except sql.IndeterminateError as e:
            return self._info(op, e)
        except (sql.PgError, sql.MysqlError) as e:
            return self._fail(op, e)
