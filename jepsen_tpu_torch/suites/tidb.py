"""TiDB suite — the port's copy of :mod:`jepsen_tpu.suites.tidb`.

Reference: tidb/src/tidb/{db,sql,core,bank,register,sets,txn,long_fork,
monotonic,sequential,table}.clj — each node runs all three components:
``pd-server`` (placement driver, peer port 2380 / client 2379),
``tikv-server`` (port 20160), and ``tidb-server`` (MySQL protocol, port
4000), installed from a tarball and started in dependency order with
config files written per node (db.clj:19-170).  Clients speak the MySQL
protocol via :mod:`.sql` (dialect ``mysql``).
"""

from __future__ import annotations

from typing import Optional

from .. import generator as gen_mod_base
from ..checker import Checker
from ..control import util as cu
from ..control import execute, sudo
from . import common, sql

DIR = "/opt/tidb"          # (reference: db.clj tidb-dir)
PD_PEER_PORT = 2380
PD_CLIENT_PORT = 2379
KV_PORT = 20160
DB_PORT = 4000
DEFAULT_TARBALL = (
    "https://download.pingcap.org/tidb-v3.0.0-linux-amd64.tar.gz"
)


class TiDB(common.DaemonDB):
    """pd → tikv → tidb on every node (reference: db.clj:180-260)."""

    dir = DIR
    binary = "bin/tidb-server"
    logfile = f"{DIR}/tidb.log"
    pidfile = f"{DIR}/tidb.pid"

    pd_logfile = f"{DIR}/pd.log"      # (reference: db.clj:30-33)
    pd_pidfile = f"{DIR}/pd.pid"
    kv_logfile = f"{DIR}/tikv.log"
    kv_pidfile = f"{DIR}/tikv.pid"

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.tarball = (opts or {}).get("tarball", DEFAULT_TARBALL)

    def install(self, test, node):
        with sudo():
            cu.install_archive(self.tarball, DIR)

    def _pd_name(self, test, node) -> str:
        return f"pd{test['nodes'].index(node) + 1}"  # (reference: db.clj:53)

    def _pd_endpoints(self, test) -> str:
        return ",".join(f"{n}:{PD_CLIENT_PORT}" for n in test["nodes"])

    def start_pd(self, test, node):
        """(reference: db.clj start-pd!)"""
        initial = ",".join(
            f"{self._pd_name(test, n)}=http://{n}:{PD_PEER_PORT}"
            for n in test["nodes"]
        )
        cu.start_daemon(
            {"logfile": self.pd_logfile, "pidfile": self.pd_pidfile,
             "chdir": DIR},
            f"{DIR}/bin/pd-server",
            "--name", self._pd_name(test, node),
            "--data-dir", f"{DIR}/data/pd",
            "--client-urls", f"http://0.0.0.0:{PD_CLIENT_PORT}",
            "--advertise-client-urls", f"http://{node}:{PD_CLIENT_PORT}",
            "--peer-urls", f"http://0.0.0.0:{PD_PEER_PORT}",
            "--advertise-peer-urls", f"http://{node}:{PD_PEER_PORT}",
            "--initial-cluster", initial,
            "--log-file", f"{DIR}/pd.app.log",
        )

    def start_kv(self, test, node):
        """(reference: db.clj start-kv!)"""
        cu.start_daemon(
            {"logfile": self.kv_logfile, "pidfile": self.kv_pidfile,
             "chdir": DIR},
            f"{DIR}/bin/tikv-server",
            "--pd", self._pd_endpoints(test),
            "--addr", f"0.0.0.0:{KV_PORT}",
            "--advertise-addr", f"{node}:{KV_PORT}",
            "--data-dir", f"{DIR}/data/tikv",
            "--log-file", f"{DIR}/tikv.app.log",
        )

    def start_db(self, test, node):
        """(reference: db.clj start-db!)"""
        cu.start_daemon(
            {"logfile": self.logfile, "pidfile": self.pidfile, "chdir": DIR},
            f"{DIR}/bin/tidb-server",
            "--store", "tikv",
            "--path", self._pd_endpoints(test),
            "-P", str(DB_PORT),
            "--log-file", f"{DIR}/tidb.app.log",
        )

    def stop_pd(self, test, node):
        cu.stop_daemon(pidfile=self.pd_pidfile, cmd="pd-server")

    def stop_kv(self, test, node):
        cu.stop_daemon(pidfile=self.kv_pidfile, cmd="tikv-server")

    def stop_db(self, test, node):
        cu.stop_daemon(pidfile=self.pidfile, cmd="tidb-server")

    # SIGSTOP/SIGCONT per component (reference: nemesis.clj pause-*/
    # resume-* via cu/signal!)
    def pause_pd(self, test, node):
        cu.signal("pd-server", "STOP")

    def pause_kv(self, test, node):
        cu.signal("tikv-server", "STOP")

    def pause_db(self, test, node):
        cu.signal("tidb-server", "STOP")

    def resume_pd(self, test, node):
        cu.signal("pd-server", "CONT")

    def resume_kv(self, test, node):
        cu.signal("tikv-server", "CONT")

    def resume_db(self, test, node):
        cu.signal("tidb-server", "CONT")

    def start(self, test, node):
        self.start_pd(test, node)
        cu.await_tcp_port(PD_CLIENT_PORT, timeout_s=120)
        self.start_kv(test, node)
        cu.await_tcp_port(KV_PORT, timeout_s=120)
        self.start_db(test, node)

    def kill(self, test, node):
        self.stop_db(test, node)
        self.stop_kv(test, node)
        self.stop_pd(test, node)

    # -- PD control plane (HTTP API + pd-ctl) ------------------------
    # The reference drives these through pd-ctl and clj-http against
    # the PD client port (nemesis.clj slow-primary-nemesis,
    # schedule-nemesis; db.clj pd-members/pd-leader/pd-transfer-leader!).

    def _pd_http(self, node) -> "JsonHttpClient":
        from .proto.http import JsonHttpClient

        return JsonHttpClient(str(node), PD_CLIENT_PORT, timeout=5.0)

    def _pd_get(self, node, path):
        """GET a PD API path → parsed body, or "timeout" — nemesis
        probes must not throw."""
        c = self._pd_http(node)
        try:
            status, body = c.request(
                "GET", path, ok=(200,), raise_on_error=False,
            )
            return body if status == 200 else "timeout"
        except Exception:  # noqa: BLE001
            return "timeout"
        finally:
            c.close()

    def pd_members(self, test, node):
        """The PD membership map ({"members": [{"name": ...}, ...]}),
        or "timeout"."""
        return self._pd_get(node, "/pd/api/v1/members")

    def pd_leader(self, test, node):
        """The PD leader member map, or "timeout"."""
        return self._pd_get(node, "/pd/api/v1/leader")

    def pd_leader_node(self, test, node):
        """Map the PD leader's member name (pd1, pd2, …) back to its
        cluster node, or None."""
        leader = self.pd_leader(test, node)
        if not isinstance(leader, dict):
            return None
        name = leader.get("name")
        for n in test["nodes"]:
            if self._pd_name(test, n) == name:
                return n
        return None

    def pd_transfer_leader(self, test, node, member_name):
        """Ask PD to transfer leadership to ``member_name``.  Returns
        (status, body); (None, error) when PD is unreachable."""
        c = self._pd_http(node)
        try:
            return c.request(
                "POST", f"/pd/api/v1/leader/transfer/{member_name}",
                ok=(200,), raise_on_error=False,
            )
        except Exception as e:  # noqa: BLE001
            return None, repr(e)
        finally:
            c.close()

    def pd_ctl(self, test, node, *args):
        """Run one pd-ctl command on ``node`` (reference:
        nemesis.clj:63-68 — `echo cmds | pd-ctl -d`)."""
        from ..control import lit

        return execute(
            "echo", *args, lit("|"), f"{DIR}/bin/pd-ctl", "-d",
            "-u", f"http://127.0.0.1:{PD_CLIENT_PORT}",
        )

    def await_ready(self, test, node):
        cu.await_tcp_port(DB_PORT, timeout_s=300)

    def wipe(self, test, node):
        with sudo():
            execute("rm", "-rf", f"{DIR}/data")

    def log_files(self, test, node):
        return [self.logfile, self.kv_logfile, self.pd_logfile]


def _opts(opts: Optional[dict]) -> dict:
    o = dict(opts or {})
    o.setdefault("dialect", "mysql")
    o.setdefault("port", DB_PORT)
    o.setdefault("user", "root")
    o.setdefault("database", "test")
    return o


def db(opts: Optional[dict] = None):
    return TiDB(opts)


def client(opts: Optional[dict] = None):
    return sql.RegisterClient(_opts(opts))


WORKLOADS = ("register", "bank", "set", "list-append", "long-fork")


def workloads(opts: Optional[dict] = None) -> dict:
    from . import monotonic, sequential

    opts = _opts(opts)
    out = {w: common.generic_workload(w, opts) for w in WORKLOADS}
    # suite-specific probes (reference: tidb/txn.clj, table.clj,
    # monotonic.clj, sequential.clj — the latter two ride the shared
    # dialect-generic SQL implementations)
    out["txn"] = common.generic_workload("rw-register", opts)
    out["table"] = table_workload(opts)
    out["monotonic"] = monotonic.workload(opts)
    out["sequential"] = sequential.workload(opts)
    return out


def _client_for(wname: str, opts: dict):
    from . import monotonic, sequential

    if wname == "txn":
        return TidbTxnClient(opts)
    if wname == "list-append":
        # the reference serves append through the striped txn client
        # (txn.clj:41-49); val must be a string column for CONCAT
        return TidbTxnClient({**opts, "val-type": "text"})
    if wname == "table":
        return TableClient(opts)
    if wname == "monotonic":
        return monotonic.MonotonicClient(opts)
    if wname == "sequential":
        return sequential.SequentialClient(opts)
    return sql.client_for(
        wname if wname in sql.CLIENTS else "register", opts
    )


def test(opts: Optional[dict] = None) -> dict:
    from . import tidb_nemesis

    opts = _opts(opts)
    wname = opts.get("workload", "register")
    w = workloads(opts)[wname]
    database = TiDB(opts)
    pkg = None
    faults = set(opts.get("faults", ()))
    if faults & tidb_nemesis.KNOWN_FAULTS:
        # suite-specific fault menu (reference: tidb/nemesis.clj via
        # run.clj); anything the menu doesn't know rides the generic
        # packages alongside it
        pkg = common.suite_nemesis_package(
            opts, database,
            tidb_nemesis.package(opts, database),
            tidb_nemesis.KNOWN_FAULTS,
        )
    return common.build_test(
        f"tidb-{wname}", opts, db=database,
        client=_client_for(wname, opts),
        workload=w, nemesis_package=pkg,
    )


# ---------------------------------------------------------------------
# Striped transactional client (reference: tidb/src/tidb/txn.clj:1-92)
# ---------------------------------------------------------------------

TXN_TABLE_COUNT = 7  # (reference: txn.clj:92 table-count default)


class TidbTxnClient(sql._Base):
    """Micro-op transactions striped over ``txn0``..``txnN`` tables with
    a secondary ``sk`` column, serving the wr (rw-register) and
    list-append workloads.

    Reference: tidb/src/tidb/txn.clj — table-for striping by key hash
    (:13-16), mop! executing r (by id, or sk under use-index /
    predicate-read, with an optional read-lock suffix) / w (upsert) /
    append (CONCAT upsert) (:18-49), single-mop transactions skipping
    BEGIN (:58-66), and the (sk, val) index under use-index (:55-57).
    """

    dialect = "mysql"

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.table_count = int(self.opts.get("table-count", TXN_TABLE_COUNT))
        self.val_type = self.opts.get("val-type", "int")
        self.use_index = bool(self.opts.get("use-index"))
        self.read_lock = self.opts.get("read-lock", "")

    def table_for(self, k) -> str:
        return f"txn{hash(k) % self.table_count}"

    def setup(self, test):
        for i in range(self.table_count):
            self._exec_ddl(
                f"CREATE TABLE IF NOT EXISTS txn{i} "
                "(id INT NOT NULL PRIMARY KEY, sk INT NOT NULL, "
                f"val {self.val_type})"
            )
            if self.use_index:
                self._exec_ddl(
                    f"CREATE INDEX txn{i}_sk_val ON txn{i} (sk, val)"
                )

    def _mop(self, f, k, v):
        t = self.table_for(k)
        if f == "r":
            col = "sk" if self.use_index else "id"
            lock = f" {self.read_lock}" if self.read_lock else ""
            res = self.conn.query(
                f"SELECT val FROM {t} WHERE {col} = {int(k)}{lock}"
            )
            raw = res.rows[0][0] if res.rows else None
            if self.val_type == "int":
                return ["r", k, None if raw is None else int(raw)]
            vals = [int(x) for x in str(raw).split(",") if x != ""] if raw else []
            return ["r", k, vals]
        if f == "w":
            self.conn.query(
                f"INSERT INTO {t} (id, sk, val) "
                f"VALUES ({int(k)}, {int(k)}, {int(v)}) "
                f"ON DUPLICATE KEY UPDATE val = {int(v)}"
            )
            return ["w", k, v]
        if f == "append":
            self.conn.query(
                f"INSERT INTO {t} (id, sk, val) "
                f"VALUES ({int(k)}, {int(k)}, '{int(v)}') "
                f"ON DUPLICATE KEY UPDATE val = CONCAT(val, ',', '{int(v)}')"
            )
            return ["append", k, v]
        raise ValueError(f"unknown micro-op {f!r}")

    def invoke(self, test, op):
        txn = op["value"]
        use_txn = len(txn) > 1
        try:
            if use_txn:
                self.conn.query("BEGIN")
            try:
                out = [self._mop(f, k, v) for f, k, v in txn]
                if use_txn:
                    self.conn.query("COMMIT")
                return {**op, "type": "ok", "value": out}
            except (sql.PgError, sql.MysqlError) as e:
                if use_txn:
                    try:
                        self.conn.query("ROLLBACK")
                    except Exception:
                        pass
                return self._fail(op, e)
        except sql.IndeterminateError as e:
            return self._info(op, e)


# ---------------------------------------------------------------------
# Table-creation workload (reference: tidb/src/tidb/table.clj)
# ---------------------------------------------------------------------


class TableClient(sql._Base):
    """create-table / insert racing DDL visibility: inserting into a
    table whose creation was acknowledged must never fail with
    "doesn't exist".  (reference: table.clj:16-51 TableClient)"""

    dialect = "mysql"

    def invoke(self, test, op):
        try:
            if op["f"] == "create-table":
                self.conn.query(
                    f"CREATE TABLE IF NOT EXISTS t{int(op['value'])} "
                    "(id INT NOT NULL PRIMARY KEY, val INT)"
                )
                return {**op, "type": "ok"}
            if op["f"] == "insert":
                table, k = op["value"]
                try:
                    self.conn.query(
                        f"INSERT INTO t{int(table)} (id) VALUES ({int(k)})"
                    )
                    return {**op, "type": "ok"}
                except (sql.PgError, sql.MysqlError) as e:
                    msg = str(e)
                    if "doesn't exist" in msg or "no such table" in msg:
                        return {**op, "type": "fail",
                                "error": "doesn't-exist"}
                    if "Duplicate" in msg or "UNIQUE" in msg:
                        return {**op, "type": "fail",
                                "error": "duplicate-key"}
                    raise
            raise ValueError(f"unknown f {op['f']!r}")
        except sql.IndeterminateError as e:
            return self._info(op, e)
        except (sql.PgError, sql.MysqlError) as e:
            return self._fail(op, e)


class _TableGen(gen_mod_base.Generator):
    """80% insert into the last *acknowledged* table, else create the
    next one; acks tracked through generator update events — the same
    bookkeeping the reference keeps in a shared atom
    (table.clj:60-68 generator, :28-33 ack in invoke!)."""

    def __init__(self):
        self.last_created = None
        self.next_create = 0
        self.next_insert = 0

    def op(self, test, ctx):
        from .. import generator as gen_mod

        if self.last_created is not None and gen_mod.rng.random() < 0.8:
            # distinct ids per insert (the reference's fixed id 0 makes
            # every insert after the first a duplicate-key failure;
            # fresh ids keep the DDL-visibility race exercised all run
            # and the stats checker meaningful)
            self.next_insert += 1
            return (
                gen_mod.fill_in_op(
                    {"f": "insert",
                     "value": [self.last_created, self.next_insert]}, ctx
                ),
                self,
            )
        self.next_create += 1
        return (
            gen_mod.fill_in_op(
                {"f": "create-table", "value": self.next_create}, ctx
            ),
            self,
        )

    def update(self, test, ctx, event):
        if (
            event.get("type") == "ok"
            and event.get("f") == "create-table"
        ):
            v = event.get("value")
            if self.last_created is None or v > self.last_created:
                self.last_created = v
        return self


class TableChecker(Checker):
    """No insert may fail with doesn't-exist.  (reference:
    table.clj:69-77 checker)"""

    def check(self, test, history, opts=None):
        from ..history import FAIL

        bad = [
            {"op-index": op.index, "value": op.value}
            for op in history
            if op.type == FAIL and op.error == "doesn't-exist"
        ]
        return {"valid?": not bad, "errors": bad[:10]}


def table_workload(opts: Optional[dict] = None) -> dict:
    """(reference: table.clj:79-84 workload)"""
    return {"generator": _TableGen(), "checker": TableChecker()}
