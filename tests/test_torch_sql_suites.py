"""The MySQL/SQL suite family on the port — galera, percona,
mysql_cluster and cockroachdb (``jepsen_tpu_torch.suites``) with the
workloads of its own (``monotonic``, ``sequential``, ``comments``,
``crdb_sets``, ``g2_sql`` and galera's ``dirty_reads_sql``) — against the
JAX package's.

- **Checkers.**  The reference tests' histories
  (``tests/test_suite_workloads.py``) give the same whole result maps in
  the reference's checkers and the port's, valid and invalid.
- **Generators.**  Each workload's generator, and each suite's whole
  test generator, give the reference's op lists from one seed
  (``generator.sim``).
- **Full runs.**  Each suite runs in-process against its fake server at
  the reference tests' settings (``db`` noop, ``ssh`` dummy, no faults,
  ``time-limit`` 2) on the plain versions (``device="cpu"``) and comes
  out valid; the reference's checker gives the port's result on the run's
  history, and a register run's keys equal the CPU oracle's.
- **The reference's own assertions** on the ported suites.

The clients' bytes against the fake servers are ``CLIENT_CASES`` rows of
``tests/test_torch_suites.py``; the DB automation's commands are its
``test_db_automation_emits_the_reference_commands`` cases.
"""

import importlib
import json
import random

import pytest

from fake_servers import FakeMysql, FakePg
from test_torch_suites import (NODES, PACKAGES, _check_both, _h, _kv, _sim,
                               own_threads, plain)
from jepsen_tpu_torch import checker, core, independent, models, suites
from jepsen_tpu_torch import db as port_db

SQL_SUITES = ("cockroachdb", "galera", "mysql_cluster", "percona")


def module(pkg, name):
    root = "jepsen_tpu" if pkg == "ref" else "jepsen_tpu_torch"
    return importlib.import_module(f"{root}.suites.{name}")


# ---------------------------------------------------------------------------
# checkers
# ---------------------------------------------------------------------------

OK_ROWS = [[0, "1", 0, 0], [1, "2", 0, 1], [2, "3", 1, 0]]

#: case → (module, checker factory, history, valid?); the histories of
#: the reference's checker tests
CHECKER_CASES = {
    "dirty-reads-valid": (
        "dirty_reads_sql", lambda m: m.DirtyReadsChecker(),
        _h((0, "invoke", "read", None), (0, "ok", "read", [3, 3, 3])), True),
    "dirty-reads-filthy": (
        "dirty_reads_sql", lambda m: m.DirtyReadsChecker(),
        _h((0, "invoke", "write", 7), (0, "fail", "write", 7),
           (1, "invoke", "read", None), (1, "ok", "read", [7, 7, 7])), False),
    "dirty-reads-inconsistent": (
        "dirty_reads_sql", lambda m: m.DirtyReadsChecker(),
        _h((0, "invoke", "read", None), (0, "ok", "read", [1, 2, 1]),
           (1, "invoke", "write", 4), (1, "ok", "write", 4)), True),
    "sequential-valid": (
        "sequential", lambda m: m.SequentialChecker(key_count=3),
        _h((0, "invoke", "read", 7), (0, "ok", "read", [7, ["7_2", "7_1",
                                                          "7_0"]]),
           (0, "invoke", "read", 9), (0, "ok", "read", [9, [None, "9_1",
                                                          "9_0"]])), True),
    "sequential-trailing-nil": (
        "sequential", lambda m: m.SequentialChecker(key_count=3),
        _h((0, "invoke", "read", 7), (0, "ok", "read", [7, ["7_2", None,
                                                          "7_0"]])), False),
    "comments-valid": (
        "comments", lambda m: m.CommentsChecker(),
        _h((0, "invoke", "write", 1), (0, "ok", "write", 1),
           (1, "invoke", "write", 2), (1, "ok", "write", 2),
           (2, "invoke", "read", None), (2, "ok", "read", [1, 2])), True),
    "comments-missing": (
        "comments", lambda m: m.CommentsChecker(),
        _h((0, "invoke", "write", 1), (0, "ok", "write", 1),
           (1, "invoke", "write", 2), (1, "ok", "write", 2),
           (2, "invoke", "read", None), (2, "ok", "read", [2])), False),
    "comments-concurrent": (
        "comments", lambda m: m.CommentsChecker(),
        _h((0, "invoke", "write", 1), (1, "invoke", "write", 2),
           (0, "ok", "write", 1), (1, "ok", "write", 2),
           (2, "invoke", "read", None), (2, "ok", "read", [2])), True),
    "comments-keyed": (
        "comments", lambda m: m.workload({"nodes": NODES})["checker"],
        _h((0, "invoke", "write", _kv(0, 1)), (0, "ok", "write", _kv(0, 1)),
           (1, "invoke", "write", _kv(0, 2)), (1, "ok", "write", _kv(0, 2)),
           (2, "invoke", "read", _kv(0, None)), (2, "ok", "read", _kv(0, [2])),
           (0, "invoke", "write", _kv(1, 3)), (0, "ok", "write", _kv(1, 3)),
           (2, "invoke", "read", _kv(1, None)),
           (2, "ok", "read", _kv(1, [3]))), False),
    "sets-valid": (
        "crdb_sets", lambda m: m.SetsChecker(),
        _h((0, "invoke", "add", 0), (0, "ok", "add", 0),
           (0, "invoke", "add", 1), (0, "ok", "add", 1),
           (1, "invoke", "add", 2), (1, "info", "add", 2),
           (0, "invoke", "read", None), (0, "ok", "read", [0, 1, 2])), True),
    "sets-lost-revived-duplicated-unexpected": (
        "crdb_sets", lambda m: m.SetsChecker(),
        _h((0, "invoke", "add", 0), (0, "ok", "add", 0),
           (0, "invoke", "add", 1), (0, "fail", "add", 1),
           (0, "invoke", "read", None), (0, "ok", "read", [1, 1, 9])), False),
    "sets-never-read": (
        "crdb_sets", lambda m: m.SetsChecker(),
        _h((0, "invoke", "add", 0), (0, "ok", "add", 0)), "unknown"),
}

MONOTONIC_HISTORIES = {
    "valid": (_h((0, "invoke", "add", 0), (0, "ok", "add", 0),
                 (0, "invoke", "add", 1), (0, "ok", "add", 1),
                 (1, "invoke", "add", 2), (1, "ok", "add", 2),
                 (0, "invoke", "read", None), (0, "ok", "read", OK_ROWS)),
              (True, True)),
    "lost": (_h((0, "invoke", "add", 0), (0, "ok", "add", 0),
                (0, "invoke", "add", 1), (0, "ok", "add", 1),
                (0, "invoke", "read", None),
                (0, "ok", "read", [[0, "1", 0, 0]])), (False, False)),
    "reorder-per-process": (
        _h((0, "invoke", "add", 5), (0, "ok", "add", 5),
           (0, "invoke", "add", 3), (0, "ok", "add", 3),
           (0, "invoke", "read", None),
           (0, "ok", "read", [[5, "1", 0, 0], [3, "2", 0, 1]])),
        (False, False)),
    "reorder-global": (
        _h((0, "invoke", "add", 1), (0, "ok", "add", 1),
           (1, "invoke", "add", 0), (1, "ok", "add", 0),
           (0, "invoke", "read", None),
           (0, "ok", "read", [[1, "1.5", 0, 1], [0, "2.25", 1, 0]])),
        (True, False)),
    "timestamps-out-of-order": (
        _h((0, "invoke", "add", 0), (0, "ok", "add", 0),
           (1, "invoke", "add", 1), (1, "ok", "add", 1),
           (0, "invoke", "read", None),
           (0, "ok", "read", [[0, "10", 0, 0], [1, "9.5", 1, 1]])),
        (False, False)),
    "revived": (_h((0, "invoke", "add", 0), (0, "ok", "add", 0),
                   (0, "invoke", "add", 9), (0, "fail", "add", 9),
                   (0, "invoke", "read", None),
                   (0, "ok", "read", [[0, "1", 0, 0], [9, "2", 0, 1]])),
                (False, False)),
    "recovered": (_h((0, "invoke", "add", 0), (0, "ok", "add", 0),
                     (0, "invoke", "add", 4), (0, "info", "add", 4),
                     (0, "invoke", "read", None),
                     (0, "ok", "read", [[0, "1", 0, 0], [4, "2", 0, 1]])),
                  (True, True)),
    "never-read": (_h((0, "invoke", "add", 0), (0, "ok", "add", 0)),
                   ("unknown", "unknown")),
}
for _name, (_dicts, _valid) in MONOTONIC_HISTORIES.items():
    for _g, _v in zip((False, True), _valid):
        CHECKER_CASES[f"monotonic-{_name}-{'global' if _g else 'local'}"] = (
            "monotonic", lambda m, g=_g: m.MonotonicChecker(use_global=g),
            _dicts, _v)


@pytest.mark.parametrize("case", sorted(CHECKER_CASES))
def test_the_sql_checkers_equal_the_reference(case):
    name, make, dicts, valid = CHECKER_CASES[case]
    ref, port = _check_both(lambda pkg: make(module(pkg, name)), dicts)
    assert port == ref
    assert port["valid?"] == valid


def test_the_checkers_helpers_equal_the_reference():
    rows = [[3, "1", 0, 0], [1, "1", 1, 1], [2, "0.5", 0, 1], [4, "7", 1, 0],
            [0, "7.25", 0, 0]]
    seqs = [[None, None, "a", "b"], ["a", "b"], [None, None], ["a", None],
            [None, "a", None, "b"], []]
    m, r = module("port", "monotonic"), module("ref", "monotonic")
    for field in (0, 1, 2, 3):
        for strict in (False, True):
            assert m._non_monotonic(rows, field, strict) == \
                r._non_monotonic(rows, field, strict)
    for group in (2, 3):
        assert m._non_monotonic_by(rows, group, 0) == \
            r._non_monotonic_by(rows, group, 0)
    assert (m.TS_EXPR, m.COMMIT_ORDERED_DIALECTS, m.table_name(3)) == (
        r.TS_EXPR, r.COMMIT_ORDERED_DIALECTS, r.table_name(3))
    s, rs = module("port", "sequential"), module("ref", "sequential")
    assert [s.trailing_nil(x) for x in seqs] == \
        [rs.trailing_nil(x) for x in seqs] == \
        [False, False, False, True, True, False]
    assert [s.table_for(f"{k}_{i}", n) for k in range(20)
            for i in range(3) for n in (1, 3, 5)] == \
        [rs.table_for(f"{k}_{i}", n) for k in range(20)
         for i in range(3) for n in (1, 3, 5)]
    assert s.subkeys(4, "k") == rs.subkeys(4, "k")
    c, rc = module("port", "comments"), module("ref", "comments")
    assert [c.table_for(i) for i in range(25)] == \
        [rc.table_for(i) for i in range(25)]
    mc, rmc = module("port", "mysql_cluster"), module("ref", "mysql_cluster")
    for nodes in (["n1"], NODES, ["a", "b", "c", "d", "e"]):
        assert mc.config_ini({"nodes": nodes}) == \
            rmc.config_ini({"nodes": nodes})
        assert mc.connect_string({"nodes": nodes}) == \
            rmc.connect_string({"nodes": nodes})
    assert module("port", "galera")._CNF == module("ref", "galera")._CNF
    assert module("port", "percona").ROOT_PW == module("ref", "percona").ROOT_PW


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

#: case → (suite, workload, workers, extra options)
GENERATOR_CASES = {
    "cockroachdb-register": ("cockroachdb", "register", 6, {}),
    "cockroachdb-bank": ("cockroachdb", "bank", 3, {}),
    "cockroachdb-set": ("cockroachdb", "set", 3, {}),
    "cockroachdb-list-append": ("cockroachdb", "list-append", 3, {}),
    "cockroachdb-monotonic": ("cockroachdb", "monotonic", 3, {}),
    "cockroachdb-sequential": ("cockroachdb", "sequential", 8, {}),
    "cockroachdb-comments": ("cockroachdb", "comments", 6, {}),
    "cockroachdb-g2": ("cockroachdb", "g2", 4, {}),
    "cockroachdb-sets": ("cockroachdb", "sets", 3, {}),
    "cockroachdb-register-parts": ("cockroachdb", "register", 6,
                                   {"nemesis": "parts"}),
    "cockroachdb-sets-double": (
        "cockroachdb", "sets", 3,
        {"nemesis": ["small-skews", "start-kill-2"],
         "nemesis-schedule": "double"}),
    "galera-dirty-reads": ("galera", "dirty-reads", 4, {}),
    "galera-register": ("galera", "register", 6, {}),
    "galera-bank": ("galera", "bank", 3, {}),
    "percona-dirty-reads": ("percona", "dirty-reads", 4, {}),
    "percona-set": ("percona", "set", 3, {}),
    "mysql_cluster-register": ("mysql_cluster", "register", 6, {}),
    "tidb-register": ("tidb", "register", 6, {}),
    "tidb-bank": ("tidb", "bank", 3, {}),
    "tidb-set": ("tidb", "set", 3, {}),
    "tidb-list-append": ("tidb", "list-append", 3, {}),
    "tidb-long-fork": ("tidb", "long-fork", 3, {}),
    "tidb-txn": ("tidb", "txn", 3, {}),
    "tidb-table": ("tidb", "table", 3, {}),
    "tidb-monotonic": ("tidb", "monotonic", 3, {}),
    "tidb-sequential": ("tidb", "sequential", 8, {}),
    "tidb-register-kill-partition": ("tidb", "register", 6,
                                     {"faults": ["kill", "partition"],
                                      "interval": 2}),
}


def _case_ops(package, case, seed, whole):
    name, wname, n, extra = GENERATOR_CASES[case]
    opts = {"nodes": NODES, "workload": wname, "time-limit": 10, "rate": 10,
            "faults": [], **extra}

    def build(m):
        # the register and sequential generators draw from `random`
        random.seed(seed)
        if whole:
            return m["gen"].limit(400, m["suite"](name).test(dict(opts))[
                "generator"])
        w = m["suite"](name).workloads(dict(opts))[wname]
        parts = [m["gen"].limit(300, w["generator"])]
        if w.get("final-generator") is not None:
            parts.append(w["final-generator"])
        return m["gen"].phases(*parts)

    return _sim(package, build, n, seed,
                test={"nodes": NODES, "accounts": list(range(8)),
                      "total-amount": 100, "max-transfer": 5})


@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_sql_suite_generators_give_the_reference_ops(case):
    for seed in (45100, 7):
        for whole in (False, True):
            ref = _case_ops("ref", case, seed, whole)
            port = _case_ops("port", case, seed, whole)
            assert port == ref, (case, seed, whole)
            assert [o for o in ref if o["type"] == "invoke"], case
    if "nemesis" in GENERATOR_CASES[case][3]:
        assert [o for o in port if o["process"] == "nemesis"], case


# ---------------------------------------------------------------------------
# full runs against the fake servers
# ---------------------------------------------------------------------------

#: case → (suite, workload, fake server, extra opts, rate, nodes); the
#: reference tests' settings (tests/test_suites.py:247-270,
#: tests/test_suite_workloads.py)
FULL_RUNS = {
    "cockroachdb-register": ("cockroachdb", "register", FakePg,
                             {"user": "postgres"}, 50, 3),
    "cockroachdb-monotonic": ("cockroachdb", "monotonic", FakePg,
                              {"user": "postgres"}, 50, 3),
    # five threads are reserved writers: readers need more than five
    "cockroachdb-sequential": ("cockroachdb", "sequential", FakePg,
                               {"user": "postgres", "concurrency": 8}, 50, 3),
    "cockroachdb-comments": ("cockroachdb", "comments", FakePg,
                             {"user": "postgres"}, 50, 3),
    "cockroachdb-g2": ("cockroachdb", "g2", FakePg, {"user": "postgres"}, 40,
                       2),
    "cockroachdb-sets": ("cockroachdb", "sets", FakePg, {"user": "postgres"},
                         50, 3),
    "galera-register": ("galera", "register", FakeMysql,
                        {"user": "root", "password": "pw"}, 40, 3),
    "galera-dirty-reads": ("galera", "dirty-reads", FakeMysql,
                           {"user": "root", "password": "pw",
                            "concurrency": 4}, 40, 3),
    "percona-dirty-reads": ("percona", "dirty-reads", FakeMysql,
                            {"user": "root", "password": "pw",
                             "concurrency": 4}, 40, 3),
    "mysql_cluster-register": ("mysql_cluster", "register", FakeMysql,
                               {"user": "root", "password": "pw"}, 40, 3),
}


def _opts(case):
    name, wname, _, extra, rate, n = FULL_RUNS[case]
    return {"nodes": NODES[:n], "workload": wname, "time-limit": 2,
            "rate": rate, "faults": [], **extra}


@pytest.mark.parametrize("case", sorted(FULL_RUNS))
def test_each_sql_suite_runs_valid_and_as_the_reference_checks_it(case):
    name, wname, fake, _, _, _ = FULL_RUNS[case]
    with own_threads():
        srv = fake().start()
        try:
            t = suites.suite(name).test({**_opts(case), "host": "127.0.0.1",
                                         "port": srv.port, "device": "cpu"})
            t["db"] = port_db.noop()
            t["ssh"] = {"dummy?": True}
            result = core.run(t)
        finally:
            srv.stop()
    history, results = result["history"], result["results"]
    assert results["valid?"] is True, results
    client = [op for op in history if isinstance(op.process, int)]
    oks = [op for op in client if op.type == "ok"]
    assert len(oks) >= 6, f"only {len(oks)} ok ops"
    assert {op.f for op in oks} >= {
        "register": {"read", "write"}, "monotonic": {"add", "read"},
        "sequential": {"write", "read"}, "comments": {"write", "read"},
        "g2": {"insert"}, "sets": {"add", "read"},
        "dirty-reads": {"write", "read"}}[wname]
    assert set(results) >= {"workload", "stats", "exceptions", "perf"}

    # the reference's checker, built from the same options, on the run's
    # history gives the port's result, whole
    dicts = [op.to_dict() for op in history if op.process != "nemesis"]

    def make(pkg):
        opts = dict(_opts(case))
        if pkg == "port":
            opts["device"] = "cpu"
        return PACKAGES[pkg]["suite"](name).workloads(opts)[wname]["checker"]

    ref, port = _check_both(make, dicts)
    assert port == ref
    assert port == plain(results["workload"])
    if wname == "register":
        # key by key, the CPU oracle's verdicts
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


# ---------------------------------------------------------------------------
# the reference's own assertions on the ported suites
# ---------------------------------------------------------------------------


def test_crdb_suite_test_wires_menu():
    cockroachdb = suites.suite("cockroachdb")
    t = cockroachdb.test({
        "nodes": list(NODES), "nemesis": "parts", "time-limit": 5,
        "device": "cpu",
    })
    assert t["name"] == "cockroachdb-register-parts"
    assert ("parts", "start") in t["nemesis"].fs()
    with pytest.raises(ValueError):
        cockroachdb.test({"nodes": list(NODES), "nemesis": "bogus"})
    # a generic fault beside the menu composes its package alongside
    t = cockroachdb.test({"nodes": list(NODES), "nemesis": "parts",
                          "faults": ["kill"], "device": "cpu"})
    assert ("parts", "start") in t["nemesis"].fs()
    assert "kill" in t["nemesis"].fs()
    names = {s["name"] for s in cockroachdb.test({
        "nodes": list(NODES), "nemesis": ["parts", "start-stop"],
        "time-limit": 5, "device": "cpu"})["plot"]["nemeses"]}
    assert names == {"parts", "startstop"}


def test_percona_dirty_reads_assembles():
    percona = suites.suite("percona")
    t = percona.test({"nodes": ["n1"], "workload": "dirty-reads",
                      "faults": [], "device": "cpu"})
    assert t["name"] == "percona-dirty-reads"
    assert isinstance(t["client"],
                      module("port", "dirty_reads_sql").DirtyReadsClient)


@pytest.mark.parametrize("name", SQL_SUITES)
def test_the_sql_suites_defaults_equal_the_references(name):
    port, ref = suites.suite(name), module("ref", name)
    opts = {"nodes": NODES}
    assert port._opts(dict(opts)) == ref._opts(dict(opts))
    assert port.WORKLOADS == ref.WORKLOADS
    assert port.client({}).dialect == ref.client({}).dialect
    t, r = port.test({**opts, "device": "cpu"}), ref.test(dict(opts))
    assert json.dumps(sorted(t["nemesis"].fs(), key=str)) == \
        json.dumps(sorted(r["nemesis"].fs(), key=str))
