"""MySQL Cluster (NDB) suite.

The port's copy of :mod:`jepsen_tpu.suites.mysql_cluster`.

Reference: mysql-cluster/src/jepsen/mysql_cluster.clj — install the
mysql-cluster debs (install!:41-51), then run all three roles on every
node with distinct node-id ranges (mgmd 1+, ndbd 11+, mysqld 21+;
:53-73): ``ndb_mgmd`` management daemons with a config.ini listing the
whole cluster, ``ndbd`` data nodes, and ``mysqld`` SQL frontends with
``ndbcluster`` enabled.  Clients via :mod:`.sql` (dialect ``mysql``).
"""

from __future__ import annotations

from typing import Optional

from ..control import util as cu
from ..control import execute, sudo
from ..os_setup import debian
from . import common, sql

PORT = 3306
MGMD_PORT = 1186
MGMD_DIR = "/var/lib/mysql/cluster"    # (reference: :53-55)
NDBD_DIR = "/var/lib/mysql/data"
MYSQLD_DIR = "/var/lib/mysql/mysql"

MGMD_ID_OFFSET, NDBD_ID_OFFSET, MYSQLD_ID_OFFSET = 1, 11, 21  # (:56-58)


def config_ini(test: dict) -> str:
    """config.ini listing every role on every node.
    (reference: :75-110 nbd-mgmd-conf)"""
    nodes = list(test["nodes"])
    out = [
        "[ndbd default]",
        f"NoOfReplicas={min(2, len(nodes))}",
        "DataMemory=98M",
        "IndexMemory=32M",
    ]
    for i, n in enumerate(nodes):
        out += ["[ndb_mgmd]",
                f"NodeId={MGMD_ID_OFFSET + i}",
                f"HostName={n}",
                f"DataDir={MGMD_DIR}"]
    for i, n in enumerate(nodes):
        out += ["[ndbd]",
                f"NodeId={NDBD_ID_OFFSET + i}",
                f"HostName={n}",
                f"DataDir={NDBD_DIR}"]
    for i, n in enumerate(nodes):
        out += ["[mysqld]",
                f"NodeId={MYSQLD_ID_OFFSET + i}",
                f"HostName={n}"]
    return "\n".join(out) + "\n"


def connect_string(test: dict) -> str:
    return ",".join(f"{n}:{MGMD_PORT}" for n in test["nodes"])


class MysqlClusterDB(common.DaemonDB):
    logfile = "/var/log/mysql/error.log"
    proc_name = "mysqld"

    def install(self, test, node):
        # (reference: :41-51 — mysql-cluster community debs + libaio)
        debian.install(["libaio1", "mysql-cluster-community-server"])
        with sudo():
            execute("service", "mysql", "stop", check=False)
            execute("mkdir", "-p", MGMD_DIR, NDBD_DIR, MYSQLD_DIR)

    def configure(self, test, node):
        with sudo():
            cu.write_file(config_ini(test), f"{MGMD_DIR}/config.ini")
            cu.write_file(
                "\n".join([
                    "[mysqld]",
                    "ndbcluster",
                    "bind-address=0.0.0.0",
                    f"ndb-connectstring={connect_string(test)}",
                    "[mysql_cluster]",
                    f"ndb-connectstring={connect_string(test)}",
                ]) + "\n",
                "/etc/mysql/conf.d/cluster.cnf",
            )

    def start(self, test, node):
        i = test["nodes"].index(node)
        with sudo():
            execute(
                "ndb_mgmd", f"--ndb-nodeid={MGMD_ID_OFFSET + i}",
                "-f", f"{MGMD_DIR}/config.ini",
                f"--configdir={MGMD_DIR}", check=False,
            )
            execute(
                "ndbd", f"--ndb-nodeid={NDBD_ID_OFFSET + i}",
                f"--connect-string={connect_string(test)}", check=False,
            )
            execute("service", "mysql", "start", check=False)

    def kill(self, test, node):
        with sudo():
            execute("service", "mysql", "stop", check=False)
            cu.grepkill("mysqld")
            cu.grepkill("ndbd")
            cu.grepkill("ndb_mgmd")

    def await_ready(self, test, node):
        cu.await_tcp_port(PORT, timeout_s=300)

    def wipe(self, test, node):
        with sudo():
            execute("rm", "-rf", NDBD_DIR, MGMD_DIR)


def _opts(opts: Optional[dict]) -> dict:
    o = dict(opts or {})
    o.setdefault("dialect", "mysql")
    o.setdefault("port", PORT)
    o.setdefault("user", "root")
    return o


def db(opts: Optional[dict] = None):
    return MysqlClusterDB(opts)


def client(opts: Optional[dict] = None):
    return sql.RegisterClient(_opts(opts))


WORKLOADS = ("register", "bank", "set")


def workloads(opts: Optional[dict] = None) -> dict:
    opts = _opts(opts)
    return {w: common.generic_workload(w, opts) for w in WORKLOADS}


def test(opts: Optional[dict] = None) -> dict:
    opts = _opts(opts)
    wname = opts.get("workload", "register")
    w = workloads(opts)[wname]
    return common.build_test(
        f"mysql-cluster-{wname}", opts, db=MysqlClusterDB(opts),
        client=sql.client_for(wname, opts), workload=w,
    )
