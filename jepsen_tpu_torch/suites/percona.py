"""Percona XtraDB Cluster suite.

The port's copy of :mod:`jepsen_tpu.suites.percona`.

Reference: percona/src/jepsen/percona.clj + percona/dirty_reads.clj —
same shape as galera: install percona-xtradb-cluster from the percona
apt repo with debconf preseeding, configure wsrep gossip over the test
nodes, bootstrap node 1, and probe dirty reads / lost updates over the
MySQL protocol.  Clients via :mod:`.sql` (dialect ``mysql``).
"""

from __future__ import annotations

from typing import Optional

from ..control import util as cu
from ..control import execute, sudo
from ..os_setup import debian
from . import common, sql
from .galera import _CNF, ROOT_PW

PORT = 3306


class PerconaDB(common.DaemonDB):
    logfile = "/var/log/mysql/error.log"
    proc_name = "mysqld"

    def install(self, test, node):
        with sudo():
            for line in (
                f"percona-xtradb-cluster-server mysql-server/root_password "
                f"password {ROOT_PW}",
                f"percona-xtradb-cluster-server "
                f"mysql-server/root_password_again password {ROOT_PW}",
            ):
                execute("bash", "-c",
                        f"echo '{line}' | debconf-set-selections")
        debian.install(["rsync", "percona-xtradb-cluster-57"])
        with sudo():
            execute("service", "mysql", "stop", check=False)

    def configure(self, test, node):
        cnf = _CNF.format(
            nodes=",".join(str(n) for n in test["nodes"]), node=node
        ).replace(
            "/usr/lib/galera/libgalera_smm.so",
            "/usr/lib/libgalera_smm.so",
        )
        with sudo():
            cu.write_file(cnf, "/etc/mysql/conf.d/wsrep.cnf")

    def start(self, test, node):
        with sudo():
            if node == test["nodes"][0]:
                execute("service", "mysql", "bootstrap-pxc", check=False)
            else:
                execute("service", "mysql", "start", check=False)

    def kill(self, test, node):
        with sudo():
            execute("service", "mysql", "stop", check=False)
            cu.grepkill("mysqld")

    def await_ready(self, test, node):
        cu.await_tcp_port(PORT, timeout_s=300)

    def wipe(self, test, node):
        with sudo():
            execute("rm", "-rf", "/var/lib/mysql/grastate.dat")


def _opts(opts: Optional[dict]) -> dict:
    o = dict(opts or {})
    o.setdefault("dialect", "mysql")
    o.setdefault("port", PORT)
    o.setdefault("user", "root")
    o.setdefault("password", ROOT_PW)
    return o


def db(opts: Optional[dict] = None):
    return PerconaDB(opts)


def client(opts: Optional[dict] = None):
    return sql.SetClient(_opts(opts))


WORKLOADS = ("set", "bank", "register")


def workloads(opts: Optional[dict] = None) -> dict:
    from . import dirty_reads_sql

    opts = _opts(opts)
    out = {w: common.generic_workload(w, opts) for w in WORKLOADS}
    # the suite's signature probe (reference: percona/
    # dirty_reads.clj): failed writers' values must never be read
    out["dirty-reads"] = dirty_reads_sql.workload(opts)
    return out


def test(opts: Optional[dict] = None) -> dict:
    from . import dirty_reads_sql

    opts = _opts(opts)
    wname = opts.get("workload", "bank")
    w = workloads(opts)[wname]
    if wname == "dirty-reads":
        return common.build_test(
            f"percona-{wname}", opts, db=db(opts),
            client=dirty_reads_sql.DirtyReadsClient(opts), workload=w,
        )
    return common.build_test(
        f"percona-{wname}", opts, db=PerconaDB(opts),
        client=sql.client_for(wname, opts), workload=w,
    )
