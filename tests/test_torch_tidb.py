"""The tidb suite on the port — ``jepsen_tpu_torch.suites.tidb`` and its
fault menu ``jepsen_tpu_torch.suites.tidb_nemesis`` — against the JAX
package's.

Every command here runs on a recording remote (each package's
``DummyRemote``): nothing installs TiDB, kills or pauses a process,
runs ``pd-ctl`` or wraps a binary in faketime on the machine the tests
run on.

- **Commands.**  ``TiDB``'s install, the start of pd, tikv and tidb, the
  kills, pauses and resumes of each, the wipe and ``pd-ctl``; every
  nemesis of the menu given each of its fs (the process nemesis on drawn
  and on given nodes, the schedulers, the slow primary with PD answering
  and without it): the same answers and the same commands, node by node,
  with their sudo and stdin.
- **Op lists.**  ``mixed_generator``, ``final_generator`` and
  ``full_generator`` for each shorthand and fault, and the whole test's
  generator, give the reference's ops from one seed.
- **Full runs** against ``FakeMysql`` at the reference tests' settings
  (2 nodes, ``db`` noop, ``ssh`` dummy, no faults, ``time-limit`` 2) on
  the plain versions: register, table, txn, monotonic and sequential come
  out valid, the reference's checker gives the port's result on the run's
  history, and the register's keys equal the CPU oracle's.
- **The reference's own assertions** on the ported suite and menu.

The clients' completions and bytes against ``FakeMysql`` are
``CLIENT_CASES`` rows of ``tests/test_torch_suites.py``; ``TiDB``'s setup
and teardown are its ``test_db_automation_emits_the_reference_commands``
cases.
"""

import json
import random

import pytest

from fake_servers import FakeMysql
from test_torch_clock_faults import PACKAGES as CLOCK_PACKAGES
from test_torch_clock_faults import _drain, _sim_ops, normal, on_remote
from test_torch_suites import (PACKAGES, _check_both, _h, own_threads,
                               plain)
from jepsen_tpu_torch import checker, core, independent, models, suites
from jepsen_tpu_torch import db as port_db

NODES = ["n1", "n2", "n3", "n4", "n5"]


def tidb(pkg):
    return PACKAGES[pkg]["suite"]("tidb")


def menu(pkg):
    root = "jepsen_tpu" if pkg == "ref" else "jepsen_tpu_torch"
    return __import__(f"{root}.suites.tidb_nemesis", fromlist=["x"])


def both_on_remote(fn, **test):
    """``fn(pkg, m, test)`` on each package's recording remote; the two
    (answer, commands by node) must be equal.  Returns the port's."""
    out = {pkg: on_remote(pkg, lambda m, t, pkg=pkg: fn(pkg, m, t), **test)
           for pkg in ("ref", "port")}
    assert normal(out["port"][0]) == normal(out["ref"][0])
    assert out["port"][1] == out["ref"][1]
    return out["port"]


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------

DB_STEPS = ("install", "start_pd", "start_kv", "start_db", "start",
            "pause_pd", "pause_kv", "pause_db", "resume_pd", "resume_kv",
            "resume_db", "stop_pd", "stop_kv", "stop_db", "kill", "wipe",
            "await_ready", "teardown", "setup")


@pytest.mark.parametrize("opts", [{}, {"tarball": "file:///tmp/tidb.tgz"}])
def test_the_db_emits_the_reference_commands(opts):
    def run(pkg, m, t):
        db = tidb(pkg).TiDB(opts)
        answers = {}
        for step in DB_STEPS:
            answers[step] = m["control"].on_nodes(
                t, lambda test, node: getattr(db, step)(test, node))
        answers["pd-ctl"] = m["control"].on_nodes(
            t, lambda test, node: db.pd_ctl(test, node, "scheduler", "show"))
        answers["log_files"] = db.log_files(t, "n1")
        answers["names"] = [db._pd_name(t, n) for n in t["nodes"]]
        answers["endpoints"] = db._pd_endpoints(t)
        return answers

    answers, cmds = both_on_remote(run)
    ran = [c[0] for c in cmds["n3"]]
    assert any("--name pd3" in c and "pd-server" in c for c in ran)
    assert any("tikv-server --pd n1:2379,n2:2379" in c for c in ran)
    assert any("tidb-server --store tikv" in c for c in ran)
    assert any("pkill" in c and "STOP" in c or "-STOP" in c for c in ran)
    assert any("pd-ctl -d -u http://127.0.0.1:2379" in c for c in ran)
    assert answers["names"] == ["pd1", "pd2", "pd3", "pd4", "pd5"]


def _process_run(pkg, m, t, seed):
    m["gen"].set_seed(seed)
    nem = menu(pkg).TidbProcessNemesis(tidb(pkg).TiDB({})).setup(t)
    out = []
    for f in sorted(menu(pkg).PROCESS_FS):
        for value in (None, ["n2", "n4"]):
            out.append(nem.invoke(t, {"type": "info", "f": f,
                                      "value": value}))
    nem.teardown(t)
    return out, sorted(nem.fs())


@pytest.mark.parametrize("seed", [45100, 7])
def test_the_process_nemesis_runs_as_the_reference(seed):
    (answers, fs), cmds = both_on_remote(
        lambda pkg, m, t: _process_run(pkg, m, t, seed))
    assert len(answers) == 24 and len(fs) == 12
    assert {n for n in NODES if cmds.get(n)} == set(NODES)


def _stub_pd(pkg, db, leader="pd3"):
    """PD's HTTP answers, the same in both packages: five members, the
    leader ``leader``, and transfers that take."""
    members = {"members": [{"name": f"pd{i}"} for i in range(1, 6)]}
    db.pd_members = lambda test, node: members
    db.pd_leader = lambda test, node: {"name": leader}
    db.pd_transfer_leader = lambda test, node, name: (200, {"to": name})


@pytest.mark.parametrize("pd", ["up", "down"])
@pytest.mark.parametrize("seed", [45100, 7])
def test_the_menu_nemeses_run_as_the_reference(pd, seed, monkeypatch):
    """The scheduler and slow-primary nemeses, and the full composition's
    partitions and clock, on the recording remote (PD's HTTP stubbed
    where it is up; without it the slow primary is recorded as failed)."""
    for pkg in ("ref", "port"):
        # no PD anywhere: the probes answer "timeout" without a socket
        monkeypatch.setattr(tidb(pkg).TiDB, "_pd_get",
                            lambda self, node, path: "timeout")

    def run(pkg, m, t):
        m["gen"].set_seed(seed)
        db = tidb(pkg).TiDB({})
        if pd == "up":
            _stub_pd(pkg, db)
        mm = menu(pkg)
        out = []
        sched = mm.ScheduleNemesis(db).setup(t)
        for f in sorted(mm.SCHEDULE_FS):
            out.append(sched.invoke(t, {"type": "info", "f": f,
                                        "value": None}))
        slow = mm.SlowPrimaryNemesis(db).setup(t)
        out.append(slow.invoke(t, {"type": "info", "f": "slow-primary",
                                   "value": None}))
        full = mm.full_nemesis(db).setup(t)
        grudge = {"n1": ["n2", "n3"], "n2": ["n1"], "n3": ["n1"]}
        for f, v in (("start-partition", grudge), ("stop-partition", None),
                     ("kill-kv", ["n1"]), ("start-kv", None),
                     ("del-shuffle-region", None), ("bump-clock",
                                                    {"n2": 1000}),
                     ("reset-clock", None)):
            out.append(full.invoke(t, {"type": "info", "f": f, "value": v}))
        full.teardown(t)
        return out, sorted(map(str, full.fs()))

    (answers, fs), cmds = both_on_remote(run)
    slow = answers[len(menu("port").SCHEDULE_FS)]
    if pd == "up":
        assert slow["value"]["isolated"] is True
        assert slow["value"]["transfer-status"] == 200
        # every pd-server restarted under faketime, the victim's slow
        entries = [c for n in NODES for c in cmds[n]]
        assert any("pd-server.real" in c[0] for c in entries)
        assert any(c[2] and 'FAKETIME="+0.000000s x0.1"' in c[2]
                   for c in entries)
    else:
        assert slow["error"] == "pd-members-unreachable"
    assert "slow-primary" in fs and "shuffle-leader" in fs


# ---------------------------------------------------------------------------
# op lists
# ---------------------------------------------------------------------------


#: case → the fault names of ``package``'s options (the shorthands, each
#: fault alone and a mix); the interval and long-recovery where given
SCHEDULES = {
    "kill": (["kill"], {}),
    "pause": (["pause"], {}),
    "schedules": (["schedules"], {}),
    "partition": (["partition"], {}),
    "clock-skew": (["clock-skew"], {}),
    "slow-primary": (["slow-primary"], {}),
    "restart-kv-without-pd": (["restart-kv-without-pd"], {}),
    "partition-pd-leader": (["partition-pd-leader"], {}),
    "kill-kv+partition-one": (["kill-kv", "partition-one"], {}),
    "everything": (["kill", "pause", "schedules", "partition",
                    "clock-skew"], {"interval": 3}),
    "fixed-schedule": (["kill-db", "shuffle-region"],
                       {"schedule": "fixed", "interval": 2}),
    "long-recovery": (["pause-pd", "partition-ring"],
                      {"long-recovery": True, "interval": 5}),
}


#: the schedules that take the whole generator (with sleep ops)
SPECIAL = ("restart-kv-without-pd", "slow-primary")


def _special_ops(pkg, opts, seed):
    CLOCK_PACKAGES[pkg]["gen"].set_seed(seed)
    p = menu(pkg).package(dict(opts), tidb(pkg).TiDB({}))
    return _drain(pkg, p["generator"], 12)


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_the_fault_schedules_give_the_reference_ops(case):
    faults, extra = SCHEDULES[case]
    opts = {"faults": faults, **extra}

    def whole(pkg, m):
        p = menu(pkg).package(dict(opts), tidb(pkg).TiDB({}))
        return m["gen"].time_limit(900, m["gen"].nemesis(p["generator"]))

    def final(pkg, m):
        p = menu(pkg).package(dict(opts), tidb(pkg).TiDB({}))
        return m["gen"].nemesis(p["final_generator"] or [])

    for seed in (45100, 7):
        if case in SPECIAL:
            # their sleep ops: drawn with virtual time stepped past them,
            # as the reference's own test draws them
            port, ref = (_special_ops(pkg, opts, seed)
                         for pkg in ("port", "ref"))
            assert port == ref, (case, seed)
            continue
        port, ref = (_sim_ops(pkg, lambda m, pkg=pkg: whole(pkg, m), seed)
                     for pkg in ("port", "ref"))
        assert port == ref, (case, seed)
        assert _sim_ops("port", lambda m: final("port", m), seed) == \
            _sim_ops("ref", lambda m: final("ref", m), seed)
    fs = {o.get("f") for o in port if o["process"] == "nemesis"} - {None}
    assert len(fs) >= 2, fs
    p = menu("port").package(dict(opts), tidb("port").TiDB({}))
    r = menu("ref").package(dict(opts), tidb("ref").TiDB({}))
    assert normal(p["perf"]) == normal(r["perf"])
    assert normal(p["final_generator"]) == normal(r["final_generator"])


def test_the_generators_and_shorthands_equal_the_references():
    port, ref = menu("port"), menu("ref")
    for name in ("PROCESS_FS", "RECOVERY_FS", "SCHEDULE_FS", "KNOWN_FAULTS",
                 "_SCHEDULERS"):
        assert normal(getattr(port, name)) == normal(getattr(ref, name))
    n = {"kill": True, "pause": True, "schedules": True, "partition": True,
         "clock-skew": True, "interval": 1}
    assert port.expand_options(n) == ref.expand_options(n)
    assert normal(port.final_generator(port.expand_options(n))) == \
        normal(ref.final_generator(ref.expand_options(n)))
    for f in ("partition_one_gen", "partition_half_gen",
              "partition_ring_gen", "partition_pd_leader_gen"):
        for seed in (45100, 7):
            PACKAGES["port"]["gen"].set_seed(seed)
            PACKAGES["ref"]["gen"].set_seed(seed)
            t = {"nodes": list(NODES)}
            assert normal(getattr(port, f)(t, {})) == \
                normal(getattr(ref, f)(t, {})), f
    with pytest.raises(ValueError, match="special schedule"):
        port.full_generator({"slow-primary": True, "kill-kv": True})
    assert port.full_generator({}) is None


def test_the_whole_tests_generator_gives_the_reference_ops():
    opts = {"nodes": NODES, "faults": ["kill", "partition"], "interval": 2,
            "time-limit": 20, "rate": 10}

    def build(pkg, m):
        # the register generator draws from `random`
        random.seed(seed)
        return m["gen"].limit(500, tidb(pkg).test(dict(opts))["generator"])

    for seed in (45100, 7):
        port, ref = (_sim_ops(pkg, lambda m, pkg=pkg: build(pkg, m), seed,
                              n=10) for pkg in ("port", "ref"))
        assert port == ref
    fs = {o["f"] for o in port if o["process"] == "nemesis"}
    assert fs & {"kill-pd", "kill-kv", "kill-db"}, fs
    assert fs & {"start-pd", "start-kv", "start-db"}, fs


# ---------------------------------------------------------------------------
# full runs against FakeMysql
# ---------------------------------------------------------------------------

#: workload → rate (tests/test_suite_workloads.py:1054-1106, :1440-1500);
#: the register at 100, as phase 32 of chip_smoke.py runs it: at 30 one
#: 2 s run in twenty, at 50 one in twenty-five, completed no cas, which
#: the stats checker (in both packages) calls invalid
FULL_RUNS = {"register": 100, "table": 30, "txn": 30, "monotonic": 40,
             "sequential": 40}


def _opts(wname):
    return {"nodes": ["n1", "n2"], "user": "root", "password": "pw",
            "time-limit": 2, "rate": FULL_RUNS[wname], "workload": wname,
            "faults": []}


@pytest.mark.parametrize("wname", sorted(FULL_RUNS))
def test_each_tidb_workload_runs_valid_and_as_the_reference_checks_it(
        wname):
    with own_threads():
        srv = FakeMysql().start()
        try:
            t = suites.suite("tidb").test({**_opts(wname),
                                           "host": "127.0.0.1",
                                           "port": srv.port,
                                           "device": "cpu"})
            t["db"] = port_db.noop()
            t["ssh"] = {"dummy?": True}
            result = core.run(t)
        finally:
            srv.stop()
    history, results = result["history"], result["results"]
    assert results["valid?"] is True, results
    oks = [op for op in history if isinstance(op.process, int)
           and op.type == "ok"]
    assert len(oks) >= 6, f"only {len(oks)} ok ops"
    assert {op.f for op in oks} >= {
        "register": {"read", "write"}, "table": {"create-table", "insert"},
        "txn": {"txn"}, "monotonic": {"add", "read"},
        "sequential": {"write"}}[wname]
    dicts = [op.to_dict() for op in history if op.process != "nemesis"]

    def make(pkg):
        opts = dict(_opts(wname))
        if pkg == "port":
            opts["device"] = "cpu"
        return tidb(pkg).workloads(opts)[wname]["checker"]

    ref, port = _check_both(make, dicts)
    assert port == ref
    assert port == plain(results["workload"])
    if wname == "register":
        oracle = plain(independent.checker(checker.linearizable(
            models.cas_register(), algorithm="oracle")).check(
                {}, history, {}))
        keys = port["linearizable"]["results"]
        assert sorted(keys) == sorted(oracle["results"])
        for k, r in keys.items():
            o = oracle["results"][k]
            shared = set(r) & set(o)
            assert "valid?" in shared
            assert all(r[f] == o[f] for f in shared), (k, r, o)


TABLE_HISTORIES = {
    "valid": (_h((0, "invoke", "create-table", 1),
                 (0, "ok", "create-table", 1),
                 (0, "invoke", "insert", [1, 0]), (0, "ok", "insert", [1, 0]),
                 (1, "invoke", "insert", [1, 1]),
                 (1, "fail", "insert", [1, 1], {"error": "duplicate-key"})),
              True),
    "doesnt-exist": (_h((0, "invoke", "insert", [1, 0]),
                        (0, "fail", "insert", [1, 0],
                         {"error": "doesn't-exist"})), False),
}


@pytest.mark.parametrize("case", sorted(TABLE_HISTORIES))
def test_the_table_checker_equals_the_reference(case):
    dicts, valid = TABLE_HISTORIES[case]
    ref, port = _check_both(lambda pkg: tidb(pkg).TableChecker(), dicts)
    assert port == ref and port["valid?"] is valid


# ---------------------------------------------------------------------------
# the reference's own assertions on the ported suite and menu
# ---------------------------------------------------------------------------


def dummy_test(**extra):
    from jepsen_tpu_torch.control.core import DummyRemote

    return {"nodes": list(NODES), "remote": DummyRemote(),
            "ssh": {"dummy?": True}, **extra}


def sessions(test):
    from jepsen_tpu_torch import control

    return control.with_session(test, test["remote"])


def test_tidb_process_nemesis_targets_components():
    from jepsen_tpu_torch.suites import tidb as tidb_mod, tidb_nemesis

    db = tidb_mod.TiDB({})
    t = dummy_test(db=db)
    with sessions(t):
        nem = tidb_nemesis.TidbProcessNemesis(db).setup(t)
        for comp in ("pd", "kv", "db"):
            res = nem.invoke(t, {"type": "info", "f": f"kill-{comp}",
                                 "value": None})
            assert res["type"] == "info"
            assert set(res["value"]) <= set(NODES)
            # recovery targets every node
            res = nem.invoke(t, {"type": "info", "f": f"start-{comp}",
                                 "value": None})
            assert sorted(res["value"]) == NODES
            res = nem.invoke(t, {"type": "info", "f": f"pause-{comp}",
                                 "value": None})
            assert set(res["value"]) <= set(NODES)
            res = nem.invoke(t, {"type": "info", "f": f"resume-{comp}",
                                 "value": None})
            assert sorted(res["value"]) == NODES
        # an op :value overrides the targets (nemesis.clj:31-33)
        res = nem.invoke(t, {"type": "info", "f": "kill-kv",
                             "value": ["n2"]})
        assert sorted(res["value"]) == ["n2"]


def test_tidb_schedule_nemesis_runs_pd_ctl():
    from jepsen_tpu_torch.suites import tidb as tidb_mod, tidb_nemesis

    db = tidb_mod.TiDB({})
    t = dummy_test(db=db)
    with sessions(t):
        nem = tidb_nemesis.ScheduleNemesis(db).setup(t)
        res = nem.invoke(t, {"type": "info", "f": "shuffle-leader",
                             "value": None})
        assert res["type"] == "info"
        assert list(res["value"].values()) == ["ok"]
        res = nem.invoke(t, {"type": "info", "f": "del-random-merge",
                             "value": None})
        assert list(res["value"].values()) == ["ok"]


def test_tidb_slow_primary_fails_gracefully_without_pd(monkeypatch):
    from jepsen_tpu_torch.suites import tidb as tidb_mod, tidb_nemesis

    # PD's member list unreachable, as on nodes that run no PD (answered
    # here without a socket)
    monkeypatch.setattr(tidb_mod.TiDB, "_pd_get",
                        lambda self, node, path: "timeout")
    db = tidb_mod.TiDB({})
    t = dummy_test(db=db)
    with sessions(t):
        nem = tidb_nemesis.SlowPrimaryNemesis(db).setup(t)
        res = nem.invoke(t, {"type": "info", "f": "slow-primary",
                             "value": None})
        # PD is unreachable on dummy nodes: recorded, never raised
        assert res["type"] == "info"
        assert res["value"] == "failed"
        assert res["error"] == "pd-members-unreachable"


def test_tidb_generators_expand_and_recover(monkeypatch):
    from jepsen_tpu_torch.suites import tidb as tidb_mod, tidb_nemesis

    n = tidb_nemesis.expand_options(
        {"kill": True, "pause": True, "schedules": True,
         "partition": True, "clock-skew": True, "interval": 1})
    assert n["kill-pd"] and n["pause-kv"] and n["random-merge"]
    assert n["partition-pd-leader"]
    g = tidb_nemesis.mixed_generator(n)
    assert g is not None
    final = tidb_nemesis.final_generator(n)
    fs = [op["f"] for op in final]
    # pauses resume before kills restart; partition heals; schedulers drop
    assert "resume-pd" in fs and "start-kv" in fs
    assert "stop-partition" in fs and "del-shuffle-leader" in fs
    assert fs.index("resume-pd") < fs.index("start-pd")

    # pd-leader partition generator falls back when PD is dead
    monkeypatch.setattr(tidb_mod.TiDB, "_pd_get",
                        lambda self, node, path: "timeout")
    op = tidb_nemesis.partition_pd_leader_gen(
        dummy_test(db=tidb_mod.TiDB({})), {})
    assert op["f"] == "start-partition"
    assert op["partition_type"] == "pd-leader"
    grudge = op["value"]
    assert set(grudge) == set(NODES)
    # one loner cut from four followers
    sizes = sorted(len(v) for v in grudge.values())
    assert sizes == [1, 1, 1, 1, 4]


def _drain_fs(g, t, n_ops, step_ns=int(10e9)):
    """Draw up to n_ops op f's from g, jumping virtual time past
    pending waits (sleep phases)."""
    from jepsen_tpu_torch import generator as gen

    ctx = gen.context({"concurrency": 1, "nodes": NODES})
    fs = []
    guard = 0
    while len(fs) < n_ops and guard < 10_000:
        guard += 1
        res = gen.op(g, t, ctx)
        if res is None:
            break
        o, g = res
        if o != gen.PENDING and isinstance(o, dict) and o.get("f"):
            fs.append(o["f"])
        ctx = {**ctx, "time": ctx["time"] + step_ns}
    return fs


def test_tidb_special_schedules():
    from jepsen_tpu_torch.suites import tidb_nemesis

    t = dummy_test()
    # restart-kv-without-pd: kill all kv, pause all pd, start kv,
    # wait, resume pd — in that order
    g = tidb_nemesis.full_generator({"restart-kv-without-pd": True})
    fs = _drain_fs(g, t, 4)
    assert fs == ["kill-kv", "pause-pd", "start-kv", "resume-pd"], fs

    # slow-primary: alternates slow-primary and partition heals forever
    g = tidb_nemesis.full_generator({"slow-primary": True})
    fs = _drain_fs(g, t, 4)
    assert fs == ["slow-primary", "stop-partition"] * 2, fs


def test_tidb_suite_test_uses_fault_menu():
    tidb_mod = suites.suite("tidb")
    t = tidb_mod.test({
        "nodes": list(NODES),
        "faults": ["kill-kv", "partition-pd-leader", "clock-skew"],
        "time-limit": 5,
        "device": "cpu",
    })
    assert t["name"] == "tidb-register"
    fs = t["nemesis"].fs()
    assert "kill-kv" in fs and "start-partition" in fs
    assert "bump-clock" in fs and "shuffle-leader" in fs

    # a generic fault composes the leftover package alongside: the disk
    # fault's nemesis is not ported yet, so asking for it raises, naming
    # its module
    with pytest.raises(NotImplementedError, match="faultfs"):
        tidb_mod.test({
            "nodes": list(NODES),
            "faults": ["kill-kv", "disk"],
            "time-limit": 5,
            "device": "cpu",
        })
    t = tidb_mod.test({"nodes": list(NODES), "faults": ["kill-kv", "kill"],
                       "time-limit": 5, "device": "cpu"})
    assert "kill-db" in t["nemesis"].fs()


def test_the_suite_is_the_references():
    port, ref = tidb("port"), tidb("ref")
    assert port._opts({}) == ref._opts({})
    assert port.WORKLOADS == ref.WORKLOADS
    assert (port.DIR, port.PD_PEER_PORT, port.PD_CLIENT_PORT, port.KV_PORT,
            port.DB_PORT, port.DEFAULT_TARBALL, port.TXN_TABLE_COUNT) == (
        ref.DIR, ref.PD_PEER_PORT, ref.PD_CLIENT_PORT, ref.KV_PORT,
        ref.DB_PORT, ref.DEFAULT_TARBALL, ref.TXN_TABLE_COUNT)
    c, rc = port.TidbTxnClient({}), ref.TidbTxnClient({})
    assert [c.table_for(k) for k in range(40)] == \
        [rc.table_for(k) for k in range(40)]
    for wname in ("register", "list-append", "txn", "table", "monotonic",
                  "sequential", "bank", "set", "long-fork"):
        assert type(port._client_for(wname, port._opts({}))).__name__ == \
            type(ref._client_for(wname, ref._opts({}))).__name__
    t = port.test({"nodes": NODES, "workload": "list-append",
                   "device": "cpu"})
    assert t["client"].val_type == "text"
    assert json.dumps(sorted(port.test({"nodes": NODES, "device": "cpu",
                                        "faults": ["kill"]})[
        "nemesis"].fs(), key=str)) == json.dumps(sorted(ref.test({
            "nodes": NODES, "faults": ["kill"]})["nemesis"].fs(), key=str))
