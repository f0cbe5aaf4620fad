"""MariaDB Galera Cluster suite.

The port's copy of :mod:`jepsen_tpu.suites.galera`.

Reference: galera/src/jepsen/galera.clj + galera/dirty_reads.clj —
install mariadb-galera-server from the mariadb apt repo with debconf
root-password preseeding (galera.clj:34-55), write a galera.cnf whose
``wsrep_cluster_address`` gossip URL lists every node, bootstrap the
first node with ``galera_new_cluster``, and probe for dirty reads /
lost updates over the MySQL protocol.  Clients via :mod:`.sql`
(dialect ``mysql``).
"""

from __future__ import annotations

from typing import Optional

from ..control import util as cu
from ..control import execute, sudo
from ..os_setup import debian
from . import common, sql

PORT = 3306
ROOT_PW = "jepsen"  # (reference: galera.clj:44-45 debconf preseed)

_CNF = """[mysqld]
bind-address = 0.0.0.0
binlog_format = ROW
default_storage_engine = InnoDB
innodb_autoinc_lock_mode = 2
wsrep_on = ON
wsrep_provider = /usr/lib/galera/libgalera_smm.so
wsrep_cluster_name = jepsen
wsrep_cluster_address = gcomm://{nodes}
wsrep_node_address = {node}
wsrep_node_name = {node}
wsrep_sst_method = rsync
"""


class GaleraDB(common.DaemonDB):
    logfile = "/var/log/mysql/error.log"
    proc_name = "mysqld"

    def install(self, test, node):
        # (reference: galera.clj:34-55 install!)
        with sudo():
            for line in (
                f"mariadb-galera-server-10.0 mysql-server/root_password "
                f"password {ROOT_PW}",
                f"mariadb-galera-server-10.0 mysql-server/root_password_again "
                f"password {ROOT_PW}",
            ):
                execute("bash", "-c",
                        f"echo '{line}' | debconf-set-selections")
        debian.install(["rsync", "mariadb-galera-server"])
        with sudo():
            execute("service", "mysql", "stop", check=False)

    def configure(self, test, node):
        cnf = _CNF.format(
            nodes=",".join(str(n) for n in test["nodes"]), node=node
        )
        with sudo():
            cu.write_file(cnf, "/etc/mysql/conf.d/galera.cnf")

    def start(self, test, node):
        with sudo():
            if node == test["nodes"][0]:
                # bootstrap the primary component on the first node
                execute("galera_new_cluster", check=False)
                execute("service", "mysql", "start", check=False)
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
    return GaleraDB(opts)


def client(opts: Optional[dict] = None):
    return sql.SetClient(_opts(opts))


WORKLOADS = ("set", "bank", "register")


def workloads(opts: Optional[dict] = None) -> dict:
    from . import dirty_reads_sql

    opts = _opts(opts)
    out = {w: common.generic_workload(w, opts) for w in WORKLOADS}
    # the suite's signature probe (reference: galera/
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
            f"galera-{wname}", opts, db=db(opts),
            client=dirty_reads_sql.DirtyReadsClient(opts), workload=w,
        )
    return common.build_test(
        f"galera-{wname}", opts, db=GaleraDB(opts),
        client=sql.client_for(wname, opts), workload=w,
    )
