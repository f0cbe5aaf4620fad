"""CockroachDB suite.

The port's copy of :mod:`jepsen_tpu.suites.cockroachdb`.

Reference: cockroachdb/src/jepsen/cockroach.clj + cockroach/{auto,
client,register,bank,sets,monotonic,sequential,adya,comments,nemesis,
runner}.clj — install a cockroach tarball to /opt/cockroach
(auto.clj:143-150), start ``cockroach start --insecure --join=…`` on
every node (auto.clj:49-77), and run register/bank/sets/monotonic/g2
workloads over JDBC with retry handling (client.clj).  Clients here
ride the pgwire protocol (cockroach speaks it natively) via
:mod:`.sql`, dialect ``cockroach`` (UPSERT, 40001 retry errors).
"""

from __future__ import annotations

from typing import Optional

from ..control import util as cu
from ..control import execute, sudo
from . import common, sql

DIR = "/opt/cockroach"  # (reference: auto.clj:33)
PORT = 26257
HTTP_PORT = 8080
DEFAULT_TARBALL = (
    "https://binaries.cockroachdb.com/cockroach-v2.1.7.linux-amd64.tgz"
)


class CockroachDB(common.DaemonDB):
    dir = DIR
    binary = "cockroach"
    logfile = f"{DIR}/logs/cockroach.stderr"
    pidfile = f"{DIR}/cockroach.pid"

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.tarball = (opts or {}).get("tarball", DEFAULT_TARBALL)

    def install(self, test, node):
        with sudo():
            cu.install_archive(self.tarball, DIR)
            execute("mkdir", "-p", f"{DIR}/logs")

    def start_args(self, test, node):
        # (reference: auto.clj:49-77 start!/join flags)
        join = ",".join(f"{n}:{PORT}" for n in test["nodes"])
        return [
            "start", "--insecure",
            "--store", f"path={DIR}/data",
            "--listen-addr", f"0.0.0.0:{PORT}",
            "--advertise-addr", f"{node}:{PORT}",
            "--http-addr", f"0.0.0.0:{HTTP_PORT}",
            "--join", join,
            "--background",
        ]

    def setup(self, test, node):
        super().setup(test, node)
        if node == test["nodes"][0]:
            # first node bootstraps the cluster
            execute(f"{DIR}/cockroach", "init", "--insecure",
                    "--host", f"{node}:{PORT}", check=False)

    def await_ready(self, test, node):
        cu.await_tcp_port(PORT, timeout_s=120)

    def wipe(self, test, node):
        with sudo():
            execute("rm", "-rf", f"{DIR}/data", f"{DIR}/logs")


def _opts(opts: Optional[dict]) -> dict:
    o = dict(opts or {})
    o.setdefault("dialect", "cockroach")
    o.setdefault("port", PORT)
    o.setdefault("user", "root")
    o.setdefault("database", "defaultdb")
    return o


def db(opts: Optional[dict] = None):
    return CockroachDB(opts)


def client(opts: Optional[dict] = None):
    return sql.RegisterClient(_opts(opts))


WORKLOADS = ("register", "bank", "set", "list-append")


def workloads(opts: Optional[dict] = None) -> dict:
    from ..workloads import adya
    from . import comments, crdb_sets, monotonic, sequential

    opts = _opts(opts)
    out = {w: common.generic_workload(w, opts) for w in WORKLOADS}
    # suite-specific probes (reference: cockroach/monotonic.clj,
    # sequential.clj, comments.clj, adya.clj, sets.clj)
    out["monotonic"] = monotonic.workload(opts)
    out["sequential"] = sequential.workload(opts)
    out["comments"] = comments.workload(opts)
    out["g2"] = adya.workload(opts)
    out["sets"] = crdb_sets.workload(opts)
    return out


def _client_for(wname: str, opts: dict):
    from . import comments, g2_sql, monotonic, sequential

    if wname == "monotonic":
        return monotonic.MonotonicClient(opts)
    if wname == "sequential":
        return sequential.SequentialClient(opts)
    if wname == "comments":
        return comments.CommentsClient(opts)
    if wname == "g2":
        return g2_sql.G2Client(opts)
    if wname == "sets":
        # cockroach's SetsClient shape == the shared SQL set client
        # (sets.clj:96-131); only the checker differs
        return sql.client_for("set", opts)
    return sql.client_for(wname, opts)


def test(opts: Optional[dict] = None) -> dict:
    from . import crdb_nemesis

    opts = _opts(opts)
    wname = opts.get("workload", "register")
    w = workloads(opts)[wname]
    database = CockroachDB(opts)
    pkg = None
    name = f"cockroachdb-{wname}"
    if opts.get("nemesis"):
        # the named-bundle menu (reference: cockroach/nemesis.clj via
        # runner.clj --nemesis/--nemesis2); generic opts["faults"]
        # still rides build_test's default path when unset
        pkg = crdb_nemesis.package(opts, database)
        # the suffix comes from the menu package — compose_packages
        # below strips non-standard keys like "name"
        name = f"{name}-{pkg['name']}"
        if opts.get("faults"):
            # the menu consumes opts["nemesis"] only — every entry in
            # opts["faults"] is a leftover for the generic packages
            # (known=set(): a menu-named fault in "faults" would
            # otherwise be silently claimed-but-never-run)
            pkg = common.suite_nemesis_package(
                opts, database, pkg, set()
            )
    return common.build_test(
        name, opts, db=database,
        client=_client_for(wname, opts), workload=w,
        nemesis_package=pkg,
    )
