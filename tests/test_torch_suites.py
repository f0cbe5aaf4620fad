"""The wire-protocol suites on the port — etcd, consul, zookeeper, raftis,
disque, postgres-rds and stolon (``jepsen_tpu_torch.suites``) — against
the JAX package's; the MySQL/SQL family's (cockroachdb, galera, percona,
mysql_cluster) assembly, DB automation and workload clients too, the rest
of it in ``tests/test_torch_sql_suites.py``.

- **Clients.**  Each suite's client runs a scripted sequence of ops
  against a fresh fake server (``tests/fake_servers.py``; disque's
  ``tests/fake_disque.py`` adds ``ACKJOB``), once through the reference's
  client and once through the port's, each behind
  ``test_torch_proto.Relay``: the same completions and the same request
  bytes.  The SQL clients run in each dialect, the SQL suites' own
  workload clients in their suites' dialects.
- **DB automation.**  Each suite's ``db.setup``/``teardown`` on each
  package's recording ``DummyRemote`` emits the same commands, node by
  node (``install_archive``, ``Debian.install``, config files, daemons);
  so do ``os_setup``'s operating systems and ``control.util``'s archive
  helpers.
- **Generators.**  Each suite's workload generators give the reference's
  op lists from one seed (``generator.sim``).
- **Checkers.**  The same histories give the same whole result maps in
  the reference's suite checkers and the port's (the register and lock
  ``linearizable`` lifts on the plain versions, the queue checkers,
  ``UnreadOkSetChecker``, stolon's ``LedgerChecker``), valid and invalid.
- **Full runs.**  Every suite runs in-process with ``device="cpu"`` against
  its fake server, as the reference's ``*_full_test_in_process`` tests
  do (``db`` noop, ``ssh`` dummy, ``time-limit`` 2), and comes out valid;
  its history gives the reference's checker's result.  Every thread a run
  or a fake server starts has ended when the test does.
"""

import contextlib
import importlib
import itertools
import json
import random
import threading
import time

import pytest

from fake_disque import FakeDisque
from fake_servers import (FakeCql, FakeDgraph, FakeHttpKv, FakeMysql, FakePg,
                          FakeRedis, FakeZk)
from test_torch_proto import Relay
from jepsen_tpu import control as ref_control
from jepsen_tpu import db as ref_db
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import history as ref_history
from jepsen_tpu import independent as ref_ind
from jepsen_tpu import os_setup as ref_os
from jepsen_tpu import suites as ref_suites
from jepsen_tpu.control import util as ref_cu
from jepsen_tpu.generator import sim as ref_sim
from jepsen_tpu.suites import common as ref_common
from jepsen_tpu_torch import control, core
from jepsen_tpu_torch import db as port_db
from jepsen_tpu_torch import generator as port_gen
from jepsen_tpu_torch import history as port_history
from jepsen_tpu_torch import independent as port_ind
from jepsen_tpu_torch import os_setup, suites
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.generator import sim as port_sim
from jepsen_tpu_torch.suites import common

NODES = ["n1", "n2", "n3"]
PORTED = ("cockroachdb", "consul", "dgraph", "disque", "etcd", "galera",
          "mysql_cluster", "percona", "postgres_rds", "raftis", "stolon",
          "tidb", "yugabyte", "zookeeper")
JOIN_S = 30

PACKAGES = {
    "ref": dict(suite=ref_suites.suite, control=ref_control, cu=ref_cu,
                os=ref_os, gen=ref_gen, sim=ref_sim, common=ref_common,
                db=ref_db),
    "port": dict(suite=suites.suite, control=control, cu=cu, os=os_setup,
                 gen=port_gen, sim=port_sim, common=common, db=port_db),
}


@pytest.fixture(autouse=True)
def _exact_reference(monkeypatch):
    # the reference's exact frontier dedup, where a key leaves the dense
    # envelope (its CPU default is best-effort)
    monkeypatch.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")


@contextlib.contextmanager
def own_threads():
    """Fails if a thread started inside outlives it (the interpreter's
    workers, the fake servers' handlers, the relays' pumps).  The port's
    oracle pool (``jepsen-oracle_*``) is one per process and idles."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + JOIN_S
    while True:
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()
                and not t.name.startswith("jepsen-oracle")]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, left


def gpu_names(x):
    if isinstance(x, dict):
        return {gpu_names(k): gpu_names(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(gpu_names(v) for v in x)
    return "gpu" if x == "tpu" else x


def plain(result):
    """A result map as JSON gives it back (sets sorted)."""
    def default(o):
        if isinstance(o, (set, frozenset)):
            return sorted(o, key=repr)
        if hasattr(o, "to_dict"):
            return o.to_dict()
        return repr(o)

    return gpu_names(json.loads(json.dumps(result, default=default,
                                           sort_keys=True)))


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------


def test_the_registry_holds_the_ported_suites():
    assert suites.SUITES == tuple(sorted(PORTED + ("localkv",)))
    assert set(suites.SUITES) <= set(ref_suites.SUITES)
    for name in set(ref_suites.SUITES) - set(suites.SUITES):
        with pytest.raises(NotImplementedError,
                           match=f"jepsen_tpu/suites/{name}.py"):
            suites.suite(name)
    assert suites.suite("postgres-rds") is suites.suite("postgres_rds")


@pytest.mark.parametrize("name", PORTED)
def test_each_suite_assembles_as_the_reference(name):
    port, ref = suites.suite(name), ref_suites.suite(name)
    opts = {"nodes": NODES, "device": "cpu"}
    pw, rw = port.workloads(dict(opts)), ref.workloads({"nodes": NODES})
    assert sorted(pw) == sorted(rw)
    for wname in pw:
        t = port.test({**opts, "workload": wname})
        r = ref.test({"nodes": NODES, "workload": wname})
        for k in ("db", "client", "generator", "checker", "nemesis"):
            assert t.get(k) is not None, (name, wname, k)
        assert t["name"] == r["name"]
        assert type(t["client"]).__name__ == type(r["client"]).__name__
        assert type(t["db"]).__name__ == type(r["db"]).__name__
        assert t.get("concurrency") == r.get("concurrency")
        assert t["device"] == "cpu"
        assert sorted(k for k in t if k != "device") == sorted(r)
        pc, rc = t["checker"].checker_map, r["checker"].checker_map
        assert sorted(pc) == sorted(rc)
        assert type(pc["workload"]).__name__ == type(rc["workload"]).__name__
    assert type(port.client({})).__name__ == type(ref.client({})).__name__


def test_the_idle_clock_package_is_disarmed_in_a_suite_run():
    """The idle clock package in a suite run is the reference's (it was
    disarmed while ``nemesis/time.py`` was not ported).  A suite's
    nemesis answers the reference's fs and plots its fault windows; set
    up and torn down on a recording remote it runs the reference's
    commands, the clock's included (``bump-time`` and ``strobe-time``
    built with gcc, ntp stopped, ``ntpdate`` at teardown), and it sets up
    in every ported suite.  Asked for, the clock fault gives the
    reference's op lists from one seed."""
    opts = {"nodes": NODES, "faults": ["partition"]}
    t = suites.suite("etcd").test({**opts, "device": "cpu"})
    r = ref_suites.suite("etcd").test(dict(opts))
    assert t["nemesis"].fs() == r["nemesis"].fs()
    assert t["plot"] == r["plot"]
    cmds = {}
    for name, (m, tt) in {"ref": (ref_control, r),
                          "port": (control, t)}.items():
        remote = m.DummyRemote()
        with m.with_session({"nodes": NODES}, remote):
            tt["nemesis"].setup(tt).teardown(tt)
        cmds[name] = _recorded(remote.log)
    assert cmds["port"] == cmds["ref"]
    clock = ("mkdir -p /opt/jepsen", "cat > /opt/jepsen/", "gcc ",
             "service ntp", "systemctl stop systemd-timesyncd", "ntpdate ")
    for node in NODES:
        ran = [c[0] for c in cmds["port"][node]]
        assert any("gcc -O2 -o /opt/jepsen/bump-time" in c for c in ran)
        assert any("ntpdate" in c for c in ran)
        assert any(c.startswith(clock) for c in ran)
    for name in PORTED:
        t = suites.suite(name).test({"nodes": NODES, "faults": [],
                                     "device": "cpu"})
        with control.with_session(t, control.DummyRemote()):
            t["nemesis"].setup(t).teardown(t)

    def build(m):
        return m["gen"].limit(300, m["suite"]("etcd").test({
            "nodes": NODES, "faults": ["clock"], "interval": 1,
            "time-limit": 10, "rate": 10})["generator"])

    for seed in (45100, 7):
        port = _sim("port", build, 6, seed, test={"nodes": NODES})
        assert port == _sim("ref", build, 6, seed, test={"nodes": NODES})
        fs = {o["f"] for o in port if o["process"] == "nemesis"}
        assert fs >= {"bump-clock", "strobe-clock", "reset-clock"}, fs


# ---------------------------------------------------------------------------
# DB automation on the recording remote
# ---------------------------------------------------------------------------


def _recorded(log):
    by_node = {}
    for node, c in log:
        entry = c if isinstance(c, tuple) else (
            c.cmd, c.sudo, c.stdin, c.dir, c.sudo_password)
        by_node.setdefault(node, []).append(entry)
    return by_node


def both(fn, nodes=NODES):
    """``fn(pkg, test)`` under each package's recording remote: ``{pkg:
    (answer, commands by node)}``."""
    out = {}
    for name, m in PACKAGES.items():
        test = {"name": "suitetest", "nodes": list(nodes)}
        remote = m["control"].DummyRemote()
        with m["control"].with_session(test, remote):
            answer = fn(m, test)
        out[name] = (answer, _recorded(remote.log))
    return out


DB_OPTS = {
    "etcd": [{}, {"version": "v3.4.0"}],
    "consul": [{}, {"version": "1.0.0"}],
    "zookeeper": [{}, {"version": "3.4.5+dfsg-2"}],
    "raftis": [{}],
    "disque": [{}, {"version": "1.0-rc1"}],
    "postgres_rds": [{}],
    "stolon": [{}, {"tarball": "file:///tmp/stolon.tar.gz"}],
    "cockroachdb": [{}, {"tarball": "file:///tmp/cockroach.tgz"}],
    "galera": [{}],
    "percona": [{}],
    "mysql_cluster": [{}],
    "tidb": [{}, {"tarball": "file:///tmp/tidb.tgz"}],
    "yugabyte": [{}, {"tarball": "file:///tmp/yb.tgz",
                      "replication-factor": 1}],
    "dgraph": [{}, {"version": "v1.0.17"}],
}


@pytest.mark.parametrize("name,opts", [(n, o) for n in PORTED
                                       for o in DB_OPTS[n]])
def test_db_automation_emits_the_reference_commands(name, opts):
    def run(m, test):
        db = m["suite"](name).db(opts)
        m["control"].on_nodes(test, lambda t, n: db.setup(t, n))
        m["control"].on_nodes(test, lambda t, n: db.teardown(t, n))
        logs = m["control"].on_nodes(
            test, lambda t, n: list(db.log_files(t, n))
            if hasattr(db, "log_files") else None)
        if hasattr(db, "pause"):
            m["control"].on_nodes(test, lambda t, n: db.pause(t, n))
            m["control"].on_nodes(test, lambda t, n: db.resume(t, n))
        return type(db).__name__, logs

    out = both(run)
    assert out["port"] == out["ref"]
    if name != "postgres_rds":
        assert all(out["port"][1][n] for n in NODES)


@pytest.mark.parametrize("os_name", ["noop", "debian", "ubuntu", "centos",
                                     "smartos"])
def test_os_setup_emits_the_reference_commands(os_name):
    def run(m, test):
        o = getattr(m["os"], os_name)
        m["control"].on_nodes(test, lambda t, n: o.setup(t, n))
        m["control"].on_nodes(test, lambda t, n: o.teardown(t, n))
        if hasattr(o, "install"):
            m["control"].on_nodes(test, lambda t, n: o.install(["jq", "git"]))
        if os_name == "smartos":
            m["control"].on_nodes(test, lambda t, n: o.install(
                {"jq": "1.6", "git": "2.0"}))
            m["control"].on_nodes(test, lambda t, n: o.uninstall("jq"))
        if hasattr(o, "installed_version"):
            return m["control"].on_nodes(
                test, lambda t, n: o.installed_version("jq"))
        return None

    out = both(run)
    assert out["port"] == out["ref"]
    if os_name != "noop":
        assert all(out["port"][1][n] for n in NODES)
    assert type(getattr(os_setup, os_name)).__name__ == \
        type(getattr(ref_os, os_name)).__name__


def test_os_setup_extra_packages_and_hostfile():
    def run(m, test):
        o = m["os"].Debian(["openjdk-8-jre"])
        m["control"].on_nodes(test, lambda t, n: o.setup(t, n))
        m["control"].on_nodes(test, lambda t, n: m["os"].setup_hostfile(t, n))
        return o.base_packages + o.extra_packages

    out = both(run)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("url", [
    "https://example.invalid/etcd-v3.1.5-linux-amd64.tar.gz",
    "https://example.invalid/consul_0.5.2_linux_amd64.zip",
    "file:///tmp/local.tar.gz",
    "/tmp/plain-path.tgz",
])
def test_archive_helpers_emit_the_reference_commands(url):
    def run(m, test):
        def on(t, n):
            return (m["cu"].install_archive(url, "/opt/db"),
                    m["cu"].install_archive(url, "/opt/db", force=True),
                    m["cu"].cached_wget(url, force=True),
                    m["cu"].ls_full("/opt"), m["cu"].file_contents("/x"),
                    m["cu"].tmp_file(".cfg"), m["cu"].tmp_dir())
        return m["control"].on_nodes(test, on)

    out = both(run)
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

#: case → (suite, workload, workers); the whole test's generator (the
#: workload's at rate 10 in a 10 s time limit, then its final reads) and
#: the workload's own
GENERATOR_CASES = {
    "etcd-register": ("etcd", "register", 6),
    "etcd-set": ("etcd", "set", 3),
    "consul-register": ("consul", "register", 6),
    "zookeeper-register": ("zookeeper", "register", 6),
    "zookeeper-lock": ("zookeeper", "lock", 3),
    "raftis-register": ("raftis", "register", 6),
    "disque-queue": ("disque", "queue", 3),
    "disque-linearizable-queue": ("disque", "linearizable-queue", 3),
    "postgres_rds-set": ("postgres_rds", "set", 3),
    "postgres_rds-bank": ("postgres_rds", "bank", 3),
    "postgres_rds-list-append": ("postgres_rds", "list-append", 3),
    "stolon-register": ("stolon", "register", 6),
    "stolon-ledger": ("stolon", "ledger", 3),
    "stolon-list-append": ("stolon", "list-append", 3),
}


def _sim(package, build, n, seed, test=None):
    m = PACKAGES[package]
    m["gen"].set_seed(seed)
    sim = m["sim"]
    state = {}
    transitions = {None: "ok", "ok": "fail", "fail": "info", "info": "ok"}

    def complete(ctx, inv):
        # ok, fail and info completions in turn per thread, so the
        # generators' updates see each kind
        t = sim.process_to_thread(ctx, inv["process"])
        state[t] = transitions[state.get(t)]
        return {**inv, "type": state[t],
                "time": inv["time"] + sim.PERFECT_LATENCY}

    ops = sim.simulate(build(m), complete, ctx=sim.n_plus_nemesis_context(n),
                       test=test, seed=seed)
    return json.loads(json.dumps(ops, default=list))


def _case_ops(package, case, seed, whole):
    name, wname, n = GENERATOR_CASES[case]
    opts = {"nodes": NODES, "workload": wname, "time-limit": 10, "rate": 10,
            "faults": []}

    def build(m):
        if whole:
            return m["gen"].limit(400, m["suite"](name).test(dict(opts))[
                "generator"])
        w = m["suite"](name).workloads(dict(opts))[wname]
        return m["gen"].limit(300, w["generator"])

    return _sim(package, build, n, seed,
                test={"nodes": NODES, "accounts": list(range(8)),
                      "total-amount": 100, "max-transfer": 5})


@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_suite_generators_give_the_reference_ops(case):
    for seed in (45100, 7):
        for whole in (False, True):
            ref = _case_ops("ref", case, seed, whole)
            port = _case_ops("port", case, seed, whole)
            assert port == ref, (case, seed, whole)
            assert [o for o in ref if o["type"] == "invoke"], case


@pytest.mark.parametrize("builder,opts", [
    ("set_workload", {}),
    ("counter_workload", {}),
    ("counter_workload", {"decrements?": True}),
    ("queue_workload", {}),
    ("linearizable_queue_workload", {"op-limit": 25}),
    ("independent_set_workload", {"nodes": NODES, "per-key-limit": 5}),
    ("register_workload", {"nodes": NODES}),
])
def test_generic_workload_generators_give_the_reference_ops(builder, opts):
    def build(m):
        w = getattr(m["common"], builder)(dict(opts))
        parts = [m["gen"].limit(200, w["generator"])]
        if w.get("final-generator") is not None:
            parts.append(w["final-generator"])
        return m["gen"].phases(*parts)

    n = 2 * len(NODES) if builder in ("independent_set_workload",
                                      "register_workload") else 3
    for seed in (45100, 7):
        assert _sim("port", build, n, seed) == _sim("ref", build, n, seed)
    pw = getattr(common, builder)({**opts, "device": "cpu"})
    rw = getattr(ref_common, builder)(dict(opts))
    assert sorted(pw) == sorted(rw)
    for name in ("set", "counter", "register", "linearizable-register",
                 "bank"):
        assert sorted(common.generic_workload(name, {"nodes": NODES})) == \
            sorted(ref_common.generic_workload(name, {"nodes": NODES}))


# ---------------------------------------------------------------------------
# the suites' clients against their fake servers
# ---------------------------------------------------------------------------


def _ops(*specs):
    return [{"type": "invoke", "f": f, "value": v, "process": 0}
            for f, v in specs]


REGISTER_OPS = _ops(("read", [0, None]), ("write", [0, 3]),
                    ("read", [0, None]), ("cas", [0, [3, 4]]),
                    ("cas", [0, [3, 5]]), ("read", [0, None]),
                    ("cas", [1, [0, 1]]), ("write", [1, 2]),
                    ("read", [1, None]), ("cas", [1, [2, 2]]),
                    ("read", [1, None]))

#: case → (suite, client class, fake server factory, extra opts, ops)
CLIENT_CASES = {
    "etcd": ("etcd", "EtcdClient", FakeHttpKv, {}, REGISTER_OPS + _ops(
        ("add", 1), ("add", 2))),
    "etcd-set": ("etcd", "_SetReadClient", FakeHttpKv, {}, _ops(
        ("read", None), ("add", 0), ("add", 1), ("add", 1), ("read", None),
        ("write", [5, 1]), ("read", [5, None]))),
    "consul": ("consul", "ConsulClient", FakeHttpKv, {}, REGISTER_OPS),
    "consul-consistent": ("consul", "ConsulClient", FakeHttpKv,
                          {"consistency": "consistent"}, REGISTER_OPS),
    "zookeeper": ("zookeeper", "ZkRegisterClient", FakeZk, {}, REGISTER_OPS),
    "raftis": ("raftis", "RaftisClient", FakeRedis, {}, _ops(
        ("read", [0, None]), ("write", [0, 3]), ("read", [0, None]),
        ("write", [1, 4]), ("read", [1, None]), ("cas", [1, [4, 5]]))),
    "disque": ("disque", "DisqueClient", FakeDisque, {}, _ops(
        ("dequeue", None), ("enqueue", 1), ("enqueue", 2), ("dequeue", None),
        ("enqueue", 3), ("drain", None), ("dequeue", None), ("nope", None))),
}

SQL_OPS = {
    "RegisterClient": REGISTER_OPS,
    "BankClient": _ops(("read", None),
                       ("transfer", {"from": 0, "to": 1, "amount": 5}),
                       ("transfer", {"from": 1, "to": 2, "amount": 500}),
                       ("read", None)),
    "SetClient": _ops(("add", 1), ("add", 2), ("read", None)),
    "CounterClient": _ops(("add", 1), ("add", 3), ("read", None),
                          ("add", -1), ("read", None)),
    "AppendClient": _ops(("txn", [["append", 1, 1], ["r", 1, None]]),
                         ("txn", [["r", 2, None], ["append", 2, 5],
                                  ["append", 1, 2], ["r", 1, None]]),
                         ("txn", [["x", 1, None]])),
    "TxnClient": _ops(("txn", [["w", 1, 1], ["r", 1, None]]),
                      ("txn", [["r", 2, None], ["w", 2, 5], ["r", 2, None]]),
                      ("txn", [["x", 1, None]])),
}
DIALECTS = {"pg": (FakePg, {"user": "postgres"}),
            "cockroach": (FakePg, {"user": "postgres"}),
            "mysql": (lambda: FakeMysql(password="pw"),
                      {"user": "root", "password": "pw"})}
for _cls, _ops_list in SQL_OPS.items():
    for _d, (_fake, _extra) in DIALECTS.items():
        CLIENT_CASES[f"sql-{_cls}-{_d}"] = (
            "sql", _cls, _fake, {"dialect": _d, **_extra}, _ops_list)
#: tidb's own clients over MySQL: the striped transactional client's
#: rw-register and append micro-ops (the reference's
#: tests/test_suite_workloads.py:967-1015) and the table client
#: (:1017-1037)
_MYSQL = {"dialect": "mysql", "user": "root", "password": "pw"}
CLIENT_CASES["tidb-txn"] = ("tidb", "TidbTxnClient", DIALECTS["mysql"][0],
                            _MYSQL, _ops(
                                ("txn", [["w", 5, 3], ["r", 5, None]]),
                                ("txn", [["r", 5, None]]),
                                ("txn", [["w", 12, 9], ["r", 12, None]]),
                                ("txn", [["r", 7, None], ["w", 7, 1]]),
                                ("txn", [["x", 1, None]])))
CLIENT_CASES["tidb-txn-append"] = (
    "tidb", "TidbTxnClient", DIALECTS["mysql"][0],
    {**_MYSQL, "val-type": "text"}, _ops(
        ("txn", [["append", 3, 1]]), ("txn", [["append", 3, 2]]),
        ("txn", [["r", 3, None]]),
        ("txn", [["append", 4, 1], ["r", 4, None], ["r", 9, None]])))
CLIENT_CASES["tidb-table"] = ("tidb", "TableClient", DIALECTS["mysql"][0],
                              _MYSQL, _ops(
                                  ("insert", [1, 0]), ("create-table", 1),
                                  ("insert", [1, 0]), ("insert", [1, 0]),
                                  ("create-table", 1), ("create-table", 2),
                                  ("insert", [2, 5]), ("nope", None)))
#: yugabyte's YCQL clients over CQL (the reference's
#: tests/test_suites.py:215-240 and tests/test_suite_workloads.py:697-840)
#: and its YSQL clients over pgwire (:217-257, :842-870, :2366-2392)
_PG = {"user": "postgres", "dialect": "pg"}
_MKA = [[f, k, v] for f, k, v in (("w", 0, 3), ("w", 2, 4))]
_MKA_READ = [["r", 0, None], ["r", 1, None], ["r", 2, None]]
CLIENT_CASES.update({
    "yugabyte-ycql-register": ("yugabyte", "YcqlRegisterClient", FakeCql, {},
                               REGISTER_OPS),
    "yugabyte-ycql-set": ("yugabyte", "YcqlSetClient", FakeCql, {}, _ops(
        ("read", None), ("add", 0), ("add", 1), ("add", 2), ("add", 1),
        ("read", None), ("nope", None))),
    "yugabyte-ycql-multi-key-acid": (
        "yugabyte", "YcqlMultiKeyAcidClient", FakeCql, {}, _ops(
            ("read", [3, _MKA_READ]), ("write", [3, _MKA]),
            ("read", [3, _MKA_READ]), ("write", [3, [["w", 1, 9]]]),
            ("read", [3, _MKA_READ[1:]]), ("read", [4, _MKA_READ[:1]]),
            ("nope", [3, []]))),
    "yugabyte-ycql-bank": ("yugabyte", "YcqlBankClient", FakeCql, {}, _ops(
        ("read", None), ("transfer", {"from": 0, "to": 2, "amount": 7}),
        ("transfer", {"from": 1, "to": 0, "amount": 40}), ("read", None),
        ("nope", None))),
    "yugabyte-ycql-long-fork": (
        "yugabyte", "YcqlLongForkClient", FakeCql, {}, _ops(
            ("read", [["r", 0, None]]), ("write", [["w", 0, 1]]),
            ("write", [["w", 2, 5]]),
            ("read", [["r", 0, None], ["r", 1, None], ["r", 2, None]]),
            ("nope", []))),
    "yugabyte-ysql-multi-key-acid": (
        "yugabyte", "MultiKeyAcidClient", FakePg, _PG, _ops(
            ("write", [5, _MKA]), ("read", [5, _MKA_READ]),
            ("write", [5, [["w", 0, 9]]]), ("read", [5, _MKA_READ[:1]]),
            ("read", [6, _MKA_READ[:1]]), ("nope", [5, []]))),
    "yugabyte-ysql-default-value": (
        "yugabyte", "DefaultValueClient", FakePg, _PG, _ops(
            ("read", None), ("create-table", None), ("insert", None),
            ("insert", None), ("read", None), ("drop-table", None),
            ("read", None), ("insert", None), ("create-table", None),
            ("read", None), ("nope", None))),
})
for _mode in ("now", "count"):
    CLIENT_CASES[f"yugabyte-ysql-append-table-{_mode}"] = (
        "yugabyte", "AppendTableClient", FakePg,
        {**_PG, "append-table-key": _mode}, _ops(
            ("txn", [["append", 7, 1], ["r", 7, None]]),
            ("txn", [["append", 7, 2], ["append", 7, 3], ["r", 7, None]]),
            ("txn", [["r", 8, None]]), ("txn", [["append", 8, 4]]),
            ("txn", [["x", 8, None]])))
#: dgraph's clients over its HTTP API (the reference's
#: tests/test_suite_workloads.py:326-410, :619-660, :1113-1200, :2060-2085)
CLIENT_CASES.update({
    "dgraph-register": ("dgraph", "DgraphClient", FakeDgraph, {},
                        REGISTER_OPS + _ops(("add", 3), ("add", 3))),
    "dgraph-set": ("dgraph", "DgraphSetClient", FakeDgraph, {}, _ops(
        ("read", None), ("add", 0), ("add", 1), ("add", 1), ("read", None))),
    "dgraph-upsert": ("dgraph", "DgraphUpsertClient", FakeDgraph, {}, _ops(
        ("read", ["a@x", None]), ("upsert", ["a@x", None]),
        ("upsert", ["a@x", None]), ("read", ["a@x", None]),
        ("upsert", ["b@x", None]), ("nope", ["b@x", None]))),
    "dgraph-delete": ("dgraph", "DgraphDeleteClient", FakeDgraph, {}, _ops(
        ("upsert", [5, None]), ("upsert", [5, None]), ("read", [5, None]),
        ("delete", [5, None]), ("delete", [5, None]), ("read", [5, None]),
        ("nope", [5, None]))),
    "dgraph-bank": ("dgraph", "DgraphBankClient", FakeDgraph, {}, _ops(
        ("read", None), ("transfer", {"from": 0, "to": 1, "amount": 10}),
        ("read", None), ("transfer", {"from": 1, "to": 0, "amount": 10}),
        ("read", None), ("transfer", {"from": 2, "to": 0, "amount": 5}),
        ("nope", None))),
    "dgraph-txn": ("dgraph", "DgraphTxnClient", FakeDgraph, {}, _ops(
        ("txn", [["w", 5, 1]]), ("txn", [["r", 5, None], ["w", 5, 2]]),
        ("txn", [["w", 9, 4], ["r", 9, None], ["w", 9, 5], ["r", 9, None]]),
        ("txn", [["r", 5, None], ["r", 9, None], ["r", 1, None]]),
        ("txn", [["x", 1, None]]))),
    "dgraph-sequential": ("dgraph", "DgraphSequentialClient", FakeDgraph, {},
                          _ops(("read", [3, None]), ("inc", [3, None]),
                               ("inc", [3, None]), ("read", [3, None]),
                               ("inc", [4, None]), ("nope", [4, None]))),
})
CLIENT_CASES["stolon-ledger"] = ("stolon", "LedgerClient", FakePg,
                                 {"user": "postgres", "dialect": "pg"},
                                 _ops(("transfer", [0, 10]),
                                      ("transfer", [0, -9]),
                                      ("transfer", [0, -9]),
                                      ("transfer", [1, -1])))


#: the SQL suites' own workload clients, each in the dialects its suites
#: speak (dirty-reads: galera and percona over MySQL; the others:
#: cockroachdb, whose pgwire dialect is ``cockroach``)
SQL_WORKLOAD_CASES = {
    "dirty_reads_sql": ("DirtyReadsClient", _ops(
        ("read", None), ("write", 1), ("read", None), ("write", 2),
        ("read", None), ("nope", None)), ("mysql", "pg"), {"rows": 4}),
    "monotonic": ("MonotonicClient", _ops(
        ("add", 0), ("add", 1), ("add", 2), ("add", 3), ("read", None),
        ("add", 4), ("read", None)), ("cockroach", "pg", "mysql"), {}),
    "sequential": ("SequentialClient", _ops(
        ("read", 7), ("write", 7), ("read", 7), ("write", 8), ("read", 9),
        ("read", 8)), ("cockroach", "mysql"), {"key-count": 3}),
    "comments": ("CommentsClient", _ops(
        ("write", [0, 1]), ("write", [0, 2]), ("write", [1, 3]),
        ("read", [0, None]), ("read", [1, None]), ("read", [9, None])),
        ("cockroach",), {"table-count": 4}),
    "g2_sql": ("G2Client", _ops(
        ("insert", [1, [10, None]]), ("insert", [1, [None, 11]]),
        ("insert", [2, [None, 12]]), ("insert", [2, [13, None]])),
        ("cockroach",), {}),
}
for _mod, (_cls, _ops_list, _dialects, _extra) in SQL_WORKLOAD_CASES.items():
    for _d in _dialects:
        CLIENT_CASES[f"{_mod}-{_d}"] = (
            _mod, _cls, DIALECTS[_d][0],
            {"dialect": _d, **DIALECTS[_d][1], **_extra}, _ops_list)


def _client_module(pkg, name):
    if name not in PORTED:
        root = "jepsen_tpu" if pkg == "ref" else "jepsen_tpu_torch"
        return importlib.import_module(f"{root}.suites.{name}")
    return PACKAGES[pkg]["suite"](name)


def _client_run(pkg, case):
    name, cls, fake, extra, ops = CLIENT_CASES[case]
    mod = _client_module(pkg, name)
    if cls == "LedgerClient":
        # the row ids come from a class-level counter: start both at 1
        mod.LedgerClient._ids = itertools.count(1)
    srv = fake().start()
    relay = Relay(srv.port)
    test = {"nodes": ["n1"], "accounts": [0, 1, 2], "total-amount": 30}
    c = None
    try:
        c = getattr(mod, cls)({"host": "127.0.0.1", "port": relay.port,
                               **extra}).open(test, "n1")
        if hasattr(c, "rng"):
            # the dirty-read writers' private row order, seeded alike
            c.rng = random.Random(45100)
        if hasattr(c, "setup"):
            c.setup(test)
        out = []
        for op in ops:
            try:
                r = c.invoke(test, dict(op))
            except Exception as e:  # noqa: BLE001 — compared by class
                r = ("raised", type(e).__name__, str(e))
            if isinstance(r, dict) and isinstance(r.get("value"), dict) \
                    and "client" in r["value"]:
                r = {**r, "value": {"client": "zk-uid"}}
            out.append(r)
    finally:
        if c is not None:
            c.close(test)
        relay.close()
        srv.stop()
    sent = [bytes(b).replace(b"127.0.0.1:%d" % relay.port,
                             b"127.0.0.1:PORT") for b in relay.sent]
    return json.loads(json.dumps(out, default=list)), sent


@pytest.mark.parametrize("case", sorted(CLIENT_CASES))
def test_suite_clients_against_their_fakes(case):
    with own_threads():
        ref, port = _client_run("ref", case), _client_run("port", case)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert any(r.get("type") == "ok" for r in port[0] if isinstance(r, dict))


def test_the_zookeeper_lock_client():
    """The reference's ``test_zk_lock_client_roundtrip`` on the port: a
    contended lock, double acquires and releases refused locally, each
    client's own identity."""
    zookeeper = suites.suite("zookeeper")
    with own_threads():
        srv = FakeZk().start()
        c1 = c2 = None
        try:
            opts = {"host": "127.0.0.1", "port": srv.port}
            c1 = zookeeper.ZkLockClient(opts).open({"nodes": ["n1"]}, "n1")
            c2 = zookeeper.ZkLockClient(opts).open({"nodes": ["n1"]}, "n1")

            def inv(c, f):
                return c.invoke({}, {"f": f, "value": None,
                                     "type": "invoke"})

            r = inv(c1, "acquire")
            assert r["type"] == "ok" and r["value"] == c1._me()
            assert r["value"]["client"] != c2._me()["client"]
            assert (inv(c2, "acquire")["error"], inv(c1, "acquire")["error"],
                    inv(c2, "release")["error"]) == (
                "taken", "already-held", "not-held")
            assert inv(c1, "release")["type"] == "ok"
            assert inv(c2, "acquire")["type"] == "ok"
            srv.stop()
            r = inv(c2, "release")
            assert r["type"] == "info" and r["value"] == c2._me()
            assert not c2.held
        finally:
            for c in (c1, c2):
                if c is not None:
                    c.close({})
            srv.stop()


# ---------------------------------------------------------------------------
# checkers
# ---------------------------------------------------------------------------


def _ref_history(dicts):
    out = []
    for d in dicts:
        v = d["value"]
        if isinstance(v, port_ind.KV):
            d = {**d, "value": ref_ind.kv(v[0], v[1])}
        out.append(d)
    return ref_history.History.from_dicts(out).index_ops()


def _port_history(dicts):
    return port_history.History.from_dicts(dicts).index_ops()


def _h(*specs):
    """Ops from ``(process, type, f, value[, extra])`` tuples."""
    out = []
    for i, s in enumerate(specs):
        p, t, f, v = s[:4]
        out.append({"index": i, "type": t, "process": p, "f": f, "value": v,
                    "time": i * 1000, **(s[4] if len(s) > 4 else {})})
    return out


def _kv(k, v):
    return port_ind.kv(k, v)


def _workload_checker(pkg, suite, wname, opts=None):
    opts = {"nodes": NODES, **(opts or {})}
    if pkg == "port":
        opts["device"] = "cpu"
    return PACKAGES[pkg]["suite"](suite).workloads(opts)[wname]["checker"]


def _check_both(make, dicts, test=None):
    t = {"name": "suitetest", "store?": False, **(test or {})}
    ref = make("ref").check(t, _ref_history(dicts), {})
    port = make("port").check(t, _port_history(dicts), {})
    return plain(ref), plain(port)


REGISTER_HISTORIES = {
    "valid": _h((0, "invoke", "write", _kv(0, 1)), (0, "ok", "write", _kv(0, 1)),
                (1, "invoke", "read", _kv(0, None)),
                (1, "ok", "read", _kv(0, 1)),
                (2, "invoke", "cas", _kv(1, [0, 2])),
                (2, "fail", "cas", _kv(1, [0, 2])),
                (0, "invoke", "read", _kv(1, None)),
                (0, "ok", "read", _kv(1, None))),
    "stale-read": _h((0, "invoke", "write", _kv(0, 1)),
                     (0, "ok", "write", _kv(0, 1)),
                     (0, "invoke", "write", _kv(0, 2)),
                     (0, "ok", "write", _kv(0, 2)),
                     (1, "invoke", "read", _kv(0, None)),
                     (1, "ok", "read", _kv(0, 1))),
    "lost-cas": _h((0, "invoke", "write", _kv(3, 1)),
                   (0, "ok", "write", _kv(3, 1)),
                   (1, "invoke", "cas", _kv(3, [1, 2])),
                   (1, "ok", "cas", _kv(3, [1, 2])),
                   (2, "invoke", "read", _kv(3, None)),
                   (2, "ok", "read", _kv(3, 1)),
                   (2, "invoke", "cas", _kv(4, [None, 1])),
                   (2, "info", "cas", _kv(4, [None, 1]))),
}


@pytest.mark.parametrize("suite", ["etcd", "consul", "zookeeper", "raftis",
                                   "postgres_rds", "stolon"])
@pytest.mark.parametrize("case", sorted(REGISTER_HISTORIES))
def test_register_checkers_equal_the_reference(suite, case):
    ref, port = _check_both(
        lambda pkg: _workload_checker(pkg, suite, "register"),
        REGISTER_HISTORIES[case])
    assert port == ref
    assert port["valid?"] is (case == "valid")


def _lock(p, t, f, c="zk-a", extra=None):
    return (p, t, f, None if t == "invoke" else {"client": c}, extra or {})


LOCK_HISTORIES = {
    "valid": _h(_lock(0, "invoke", "acquire"), _lock(0, "ok", "acquire"),
                _lock(1, "invoke", "acquire"),
                (1, "fail", "acquire", None, {"error": "taken"}),
                _lock(0, "invoke", "release"), _lock(0, "ok", "release"),
                _lock(1, "invoke", "acquire", "zk-b"),
                _lock(1, "ok", "acquire", "zk-b"),
                _lock(1, "invoke", "release", "zk-b"),
                _lock(1, "info", "release", "zk-b")),
    "double-grant": _h(_lock(0, "invoke", "acquire"), _lock(0, "ok", "acquire"),
                       _lock(1, "invoke", "acquire", "zk-b"),
                       _lock(1, "ok", "acquire", "zk-b")),
    "foreign-release": _h(_lock(0, "invoke", "acquire"),
                          _lock(0, "ok", "acquire"),
                          _lock(1, "invoke", "release", "zk-b"),
                          _lock(1, "ok", "release", "zk-b")),
}


@pytest.mark.parametrize("case", sorted(LOCK_HISTORIES))
def test_the_lock_checker_equals_the_reference(case):
    ref, port = _check_both(
        lambda pkg: _workload_checker(pkg, "zookeeper", "lock"),
        LOCK_HISTORIES[case])
    assert port == ref
    assert port["valid?"] is (case == "valid")


QUEUE_HISTORIES = {
    "valid": _h((0, "invoke", "enqueue", 1), (0, "ok", "enqueue", 1),
                (1, "invoke", "enqueue", 2), (1, "info", "enqueue", 2),
                (2, "invoke", "dequeue", None), (2, "ok", "dequeue", 1),
                (0, "invoke", "dequeue", None),
                (0, "fail", "dequeue", None, {"error": "empty"}),
                (1, "invoke", "drain", None), (1, "ok", "drain", [2])),
    "lost": _h((0, "invoke", "enqueue", 1), (0, "ok", "enqueue", 1),
               (1, "invoke", "enqueue", 2), (1, "ok", "enqueue", 2),
               (2, "invoke", "dequeue", None), (2, "ok", "dequeue", 2),
               (1, "invoke", "drain", None), (1, "ok", "drain", [])),
    "unexpected-and-duplicated": _h(
        (0, "invoke", "enqueue", 1), (0, "ok", "enqueue", 1),
        (2, "invoke", "dequeue", None), (2, "ok", "dequeue", 1),
        (0, "invoke", "dequeue", None), (0, "ok", "dequeue", 1),
        (1, "invoke", "drain", None), (1, "ok", "drain", [7])),
}


@pytest.mark.parametrize("wname", ["queue", "linearizable-queue"])
@pytest.mark.parametrize("case", sorted(QUEUE_HISTORIES))
def test_the_queue_checkers_equal_the_reference(wname, case):
    dicts = QUEUE_HISTORIES[case]
    if wname == "linearizable-queue":
        # the linearizable workload has no drain: its ops as dequeues
        dicts = [d for d in dicts if d["f"] != "drain"]
    ref, port = _check_both(
        lambda pkg: _workload_checker(pkg, "disque", wname), dicts)
    assert port == ref
    if wname == "queue":
        assert port["valid?"] is (case == "valid")
    else:
        assert port["valid?"] is (case != "unexpected-and-duplicated")


SET_HISTORIES = {
    "valid": _h((0, "invoke", "add", _kv(1, 1)), (0, "ok", "add", _kv(1, 1)),
                (1, "invoke", "add", _kv(1, 2)), (1, "info", "add", _kv(1, 2)),
                (0, "invoke", "read", _kv(1, None)),
                (0, "ok", "read", _kv(1, [1])),
                (2, "invoke", "add", _kv(2, 3)), (2, "ok", "add", _kv(2, 3))),
    "lost": _h((0, "invoke", "add", _kv(1, 1)), (0, "ok", "add", _kv(1, 1)),
               (0, "invoke", "read", _kv(1, None)),
               (0, "ok", "read", _kv(1, []))),
    "reads-all-failed": _h((0, "invoke", "add", _kv(1, 1)),
                           (0, "ok", "add", _kv(1, 1)),
                           (0, "invoke", "read", _kv(1, None)),
                           (0, "fail", "read", _kv(1, None))),
}


@pytest.mark.parametrize("case", sorted(SET_HISTORIES))
def test_the_unread_ok_set_checker_equals_the_reference(case):
    ref, port = _check_both(
        lambda pkg: PACKAGES[pkg]["common"].independent_set_workload(
            {"nodes": NODES})["checker"], SET_HISTORIES[case])
    assert port == ref
    assert port["valid?"] == {"valid": True, "lost": False,
                              "reads-all-failed": "unknown"}[case]
    if case == "valid":
        assert port["results"]["2"] == {"valid?": True, "unread?": True}


ETCD_SET_HISTORIES = {
    "valid": _h((0, "invoke", "add", 0), (0, "ok", "add", 0),
                (1, "invoke", "add", 1), (1, "info", "add", 1),
                (2, "invoke", "read", None), (2, "ok", "read", [0, 1])),
    "lost": _h((0, "invoke", "add", 0), (0, "ok", "add", 0),
               (1, "invoke", "add", 1), (1, "ok", "add", 1),
               (2, "invoke", "read", None), (2, "ok", "read", [1])),
}


@pytest.mark.parametrize("case", sorted(ETCD_SET_HISTORIES))
def test_the_etcd_set_checker_equals_the_reference(case):
    ref, port = _check_both(
        lambda pkg: _workload_checker(pkg, "etcd", "set"),
        ETCD_SET_HISTORIES[case])
    assert port == ref
    assert port["valid?"] is (case == "valid")


LEDGER_HISTORIES = {
    "good": _h((0, "invoke", "transfer", [0, 10]),
               (0, "ok", "transfer", [0, 10]),
               (0, "invoke", "transfer", [0, -9]),
               (0, "ok", "transfer", [0, -9]),
               (1, "invoke", "transfer", [0, -9]),
               (1, "fail", "transfer", [0, -9])),
    "double-spend": _h((0, "invoke", "transfer", [0, 10]),
                       (0, "ok", "transfer", [0, 10]),
                       (0, "invoke", "transfer", [0, -9]),
                       (0, "ok", "transfer", [0, -9]),
                       (1, "invoke", "transfer", [0, -9]),
                       (1, "ok", "transfer", [0, -9])),
    "charitable": _h((0, "invoke", "transfer", [0, 10]),
                     (0, "info", "transfer", [0, 10]),
                     (1, "invoke", "transfer", [0, -9]),
                     (1, "info", "transfer", [0, -9])),
}


@pytest.mark.parametrize("case", sorted(LEDGER_HISTORIES))
def test_the_ledger_checker_equals_the_reference(case):
    ref, port = _check_both(
        lambda pkg: PACKAGES[pkg]["suite"]("stolon").LedgerChecker(),
        LEDGER_HISTORIES[case])
    assert port == ref
    assert port["valid?"] is (case != "double-spend")
    if case == "double-spend":
        assert port["errors"] == [{"account": 0, "balance": -8}]


def test_the_ledger_client_validates_its_isolation():
    stolon = suites.suite("stolon")
    assert stolon.LedgerClient({"isolation": "repeatable-read"}).isolation \
        == "REPEATABLE READ"
    with pytest.raises(ValueError, match="unknown isolation"):
        stolon.LedgerClient({"isolation": "snapshot"})


# ---------------------------------------------------------------------------
# full runs against the fake servers
# ---------------------------------------------------------------------------

#: case → (suite, workload, fake server factory, extra opts, rate)
FULL_RUNS = {
    "etcd-register": ("etcd", "register", FakeHttpKv, {}, 50),
    "etcd-set": ("etcd", "set", FakeHttpKv, {}, 50),
    "consul-register": ("consul", "register", FakeHttpKv, {}, 50),
    "zookeeper-register": ("zookeeper", "register", FakeZk, {}, 50),
    "zookeeper-lock": ("zookeeper", "lock", FakeZk, {}, 40),
    "raftis-register": ("raftis", "register", FakeRedis, {}, 50),
    "disque-linearizable-queue": ("disque", "linearizable-queue", FakeDisque,
                                  {}, 40),
    "disque-queue": ("disque", "queue", FakeDisque, {}, 50),
    "postgres_rds-register": ("postgres_rds", "register", FakePg,
                              {"user": "postgres"}, 50),
    "stolon-list-append": ("stolon", "list-append", FakePg,
                           {"user": "postgres"}, 40),
    "stolon-ledger": ("stolon", "ledger", FakePg, {"user": "postgres"}, 40),
}

_RUNS = {}


def full_run(case):
    """One port run of ``case`` against a fresh fake server (once per
    process): ``(test, history, results)``."""
    if case in _RUNS:
        return _RUNS[case]
    name, wname, fake, extra, rate = FULL_RUNS[case]
    with own_threads():
        srv = fake().start()
        try:
            t = suites.suite(name).test({
                "nodes": NODES, "host": "127.0.0.1", "port": srv.port,
                "time-limit": 2, "rate": rate, "workload": wname,
                "faults": [], "device": "cpu", **extra})
            t["db"] = port_db.noop()
            t["ssh"] = {"dummy?": True}
            result = core.run(t)
        finally:
            srv.stop()
    _RUNS[case] = (t, result["history"], result["results"])
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(FULL_RUNS))
def test_each_suite_runs_valid_against_its_fake(case):
    _RUNS.pop(case, None)
    t, history, results = full_run(case)
    assert results["valid?"] is True, results
    client = [op for op in history if isinstance(op.process, int)]
    oks = [op for op in client if op.type == "ok"]
    # most of the ledger's withdrawals fail by design (each account is
    # funded once, then drained by a burst), as in the reference's run
    least = 1 if FULL_RUNS[case][1] == "ledger" else 6
    assert len(oks) >= least, f"only {len(oks)} ok ops"
    assert {op.f for op in oks} >= {
        "register": {"read", "write"}, "set": {"add", "read"},
        "lock": {"acquire", "release"}, "linearizable-queue": {"enqueue"},
        "queue": {"enqueue", "drain"}, "list-append": {"txn"},
        "ledger": {"transfer"}}[FULL_RUNS[case][1]]
    if FULL_RUNS[case][1] == "lock":
        assert any(op.get("error") == "taken" for op in client), \
            "no contention observed"
    assert set(results) >= {"workload", "stats", "exceptions", "perf"}


@pytest.mark.parametrize("case", sorted(FULL_RUNS))
def test_a_runs_history_gives_the_reference_checkers_result(case):
    """The run's history through the reference's suite checker (the
    reference's workload, built from the same options) gives the port's
    result, whole; an invalid history made from it too."""
    t, history, results = full_run(case)
    name, wname = FULL_RUNS[case][:2]
    dicts = [op.to_dict() for op in history
             if op.process != "nemesis"]

    def make(pkg):
        return _workload_checker(pkg, name, wname)

    ref, port = _check_both(make, dicts)
    assert port == ref
    assert port == plain(results["workload"])
    bad = _spoil(wname, dicts)
    if bad is not None:
        ref, port = _check_both(make, bad)
        assert port == ref
        assert port["valid?"] is False


def _spoil(wname, dicts):
    """The run's history with one completion made wrong: a read of a
    value never written, a lost element, a double grant or spend."""
    out = [dict(d) for d in dicts]
    if wname == "register":
        i = next(i for i, d in enumerate(out) if d["type"] == "ok"
                 and d["f"] == "read")
        out[i]["value"] = port_ind.kv(out[i]["value"][0], 999)
    elif wname == "set":
        reads = [d for d in out if d["type"] == "ok" and d["f"] == "read"]
        gone = min(reads[-1]["value"])
        for d in reads:
            d["value"] = [v for v in d["value"] if v != gone]
    elif wname == "queue":
        i = max(i for i, d in enumerate(out) if d["type"] == "ok"
                and d["f"] == "drain")
        out[i]["value"] = list(out[i]["value"]) + [10 ** 6]
    elif wname == "linearizable-queue":
        i = next(i for i, d in enumerate(out) if d["type"] == "ok"
                 and d["f"] == "dequeue")
        out[i]["value"] = 10 ** 6
    elif wname == "lock":
        acquires = [i for i, d in enumerate(out) if d["type"] == "ok"
                    and d["f"] == "acquire"]
        first = out[acquires[0]]
        inv = {**first, "type": "invoke", "process": 99, "value": None,
               "index": -1}
        done = {**first, "process": 99, "value": {"client": "zk-intruder"},
                "index": -1}
        out[acquires[0] + 1:acquires[0] + 1] = [inv, done]
    elif wname == "ledger":
        funded = next(d for d in out if d["type"] == "ok"
                      and d["value"][1] > 0)
        a = funded["value"][0]
        out += [{"index": -1, "type": "invoke", "process": 99,
                 "f": "transfer", "value": [a, -10 ** 6], "time": 0},
                {"index": -1, "type": "ok", "process": 99,
                 "f": "transfer", "value": [a, -10 ** 6], "time": 1}]
    else:
        return None
    for i, d in enumerate(out):
        d["index"] = i
    return out
