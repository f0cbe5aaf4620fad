"""The dgraph suite on the port — ``jepsen_tpu_torch.suites.dgraph`` and
its fault menu ``jepsen_tpu_torch.suites.dgraph_nemesis`` — against the
JAX package's.

Every command here runs on a recording remote (each package's
``DummyRemote``): nothing installs Dgraph, starts or stops a zero or an
alpha, or sets a clock on the machine the tests run on.  The zero's HTTP
API (``/state``, ``/moveTablet``) is ``FakeDgraph``'s.

- **Commands.**  ``DgraphDB``'s zero on the first node and alphas
  everywhere, their starts, stops and kills; the alpha killer and fixer,
  the zero killer, the tablet mover against a fake zero, the clock skew
  (``gen.rng`` drawn once a node, in node order, which the reference
  does on the nodes' threads: compared with its ``on_nodes`` made
  serial) and the full composition: the same answers and commands.
- **Op lists.**  Every workload's generator, the whole test's under the
  whole fault menu, and each fault schedule give the reference's ops
  from one seed.
- **Checkers** on the reference tests' histories: the same result maps.
- **Full runs** (2 nodes, ``db`` noop, ``ssh`` dummy, no faults,
  ``time-limit`` 2) on the plain versions: ``register``, ``wr``,
  ``upsert``, ``delete`` and ``sequential`` come out valid, the
  reference's checker gives the port's result on the run's history
  (exact equality), and the register's keys equal the CPU oracle's.  The
  register runs against ``fake_dgraph.TypedDgraph``, which answers the
  schema's ``int`` predicates as numbers as Dgraph does; against the
  untyped ``FakeDgraph`` its reads are strings and both packages call
  the run invalid alike.
- **The reference's own assertions** on the ported suite and menu.

The clients' completions and bytes against ``FakeDgraph`` are
``CLIENT_CASES`` rows of ``tests/test_torch_suites.py``.
"""

import os
import random

import pytest

from fake_dgraph import TypedDgraph
from fake_servers import FakeDgraph
from test_torch_clock_faults import _sim_ops, normal, on_remote
from test_torch_clock_faults import serial_reference  # noqa: F401
from test_torch_suites import _check_both, _h, _sim, own_threads, plain
from jepsen_tpu_torch import checker, core, independent, models, suites
from jepsen_tpu_torch import db as port_db

NODES = ["n1", "n2", "n3", "n4", "n5"]


def dg(pkg):
    root = "jepsen_tpu" if pkg == "ref" else "jepsen_tpu_torch"
    return __import__(f"{root}.suites.dgraph", fromlist=["x"])


def menu(pkg):
    root = "jepsen_tpu" if pkg == "ref" else "jepsen_tpu_torch"
    return __import__(f"{root}.suites.dgraph_nemesis", fromlist=["x"])


def gen_of(pkg):
    root = "jepsen_tpu" if pkg == "ref" else "jepsen_tpu_torch"
    return __import__(f"{root}.generator", fromlist=["x"])


def both_on_remote(fn, **test):
    """``fn(pkg, m, test)`` on each package's recording remote; the two
    (answer, commands by node) must be equal.  Returns the port's."""
    out = {pkg: on_remote(pkg, lambda m, t, pkg=pkg: fn(pkg, m, t), **test)
           for pkg in ("ref", "port")}
    assert out["port"] == out["ref"]
    return out["port"]


def _inv(c, f, value, test=None):
    return c.invoke(test or {}, {"f": f, "value": value, "type": "invoke"})


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------

DB_STEPS = ("install", "start", "start_zero", "start_alpha", "stop_alpha",
            "stop_zero", "alpha_running", "kill", "await_ready", "wipe",
            "teardown", "setup")


@pytest.mark.parametrize("opts", [{}, {"version": "v1.0.17"}])
def test_the_db_emits_the_reference_commands(opts):
    def run(pkg, m, t):
        db = dg(pkg).DgraphDB(opts)
        answers = {step: m["control"].on_nodes(
            t, lambda test, node, step=step: getattr(db, step)(test, node))
            for step in DB_STEPS}
        answers["log_files"] = db.log_files(t, "n1")
        answers["zeros"] = db.zero_nodes(t)
        return answers

    answers, cmds = both_on_remote(run)
    assert answers["zeros"] == ["n1"]
    for n in NODES:
        ran = [c[0] for c in cmds[n]]
        assert any("start-stop-daemon" in c and "-- alpha --my" in c
                   and "--zero n1:5080" in c for c in ran)
        assert any("tar -xf" in c and "dgraph-linux-amd64" in c for c in ran)
    assert any("-- zero --my n1:5080 --replicas 5" in c[0]
               for c in cmds["n1"])


def test_the_zero_api_answers_as_the_reference():
    """``zero_state`` and ``move_tablet`` against a fake zero, and
    against none (``"timeout"`` and ``(None, error)``, never raised)."""
    out = {}
    for pkg in ("ref", "port"):
        with own_threads():
            srv = FakeDgraph().start()
            try:
                opts = {"host": "127.0.0.1", "port": srv.port,
                        "zero-public-port": srv.port}
                c = dg(pkg).DgraphSequentialClient(opts).open(
                    {"nodes": ["n1"]}, "n1")
                c.setup({})
                assert _inv(c, "inc", independent.kv(0, None))["type"] == \
                    "ok"
                c.close({})
                db = dg(pkg).DgraphDB(opts)
                t = {"nodes": list(NODES)}
                got = [db.zero_state(t, "n1"),
                       db.move_tablet(t, "n1", "value", 2),
                       db.move_tablet(t, "n1", "dgraph.type", 2),
                       db.zero_state(t, "n1")]
            finally:
                srv.stop()
            dead = dg(pkg).DgraphDB(opts)
            got += [dead.zero_state(t, "n1"),
                    dead.move_tablet(t, "n1", "value", 1)[0]]
        out[pkg] = normal(got)
    assert out["port"] == out["ref"]
    assert out["port"][1] == [200, {"data": "moved value to 2"}]
    assert out["port"][2][0] == 500
    assert out["port"][3]["groups"]["2"]["tablets"]["value"]["groupId"] == 2
    assert out["port"][4] == "timeout" and out["port"][5] is None


def _killers_run(pkg, m, t, seed):
    m["gen"].set_seed(seed)
    db = dg(pkg).DgraphDB({})
    mm = menu(pkg)
    out = []
    for nem, fs in ((mm.AlphaKiller(db), ("kill-alpha", "restart-alpha")),
                    (mm.ZeroKiller(db), ("kill-zero", "restart-zero")),
                    (mm.AlphaFixer(db), ("fix-alpha",))):
        nem = nem.setup(t)
        for _ in range(3):
            for f in fs:
                out.append(nem.invoke(t, {"type": "info", "f": f,
                                          "value": None}))
        nem.teardown(t)
        out.append(sorted(nem.fs()))
    return out


@pytest.mark.parametrize("seed", [45100, 7])
def test_the_process_nemeses_run_as_the_reference(seed):
    answers, cmds = both_on_remote(
        lambda pkg, m, t: _killers_run(pkg, m, t, seed))
    # the alpha killer on every node, the zero killer on the first
    assert sorted(answers[0]["value"]) == NODES
    assert set(answers[7]["value"]) <= {"n1"}
    assert answers[6] == ["kill-alpha", "restart-alpha"]
    assert {n for n in NODES if cmds.get(n)} == set(NODES)


@pytest.mark.parametrize("skew", ["tiny", "huge", None])
@pytest.mark.parametrize("seed", [45100, 7])
def test_the_clock_skew_runs_as_the_reference(seed, skew, serial_reference):
    def run(pkg, m, t):
        m["gen"].set_seed(seed)
        nem = menu(pkg).skew_nemesis({"skew": skew}).setup(t)
        out = [nem.invoke(t, {"type": "info", "f": f, "value": None})
               for f in ("start-skew", "stop-skew", "start-skew",
                         "start-skew")]
        nem.teardown(t)
        return out, nem.dt_ms

    (answers, dt), cmds = both_on_remote(run)
    assert dt == {"tiny": 100, "huge": 7500, None: 0}[skew]
    if dt == 0:
        return
    bumped = [n for n in NODES
              for i in (0, 2, 3) if answers[i]["value"][n] != "0"]
    assert bumped and len(bumped) < 3 * len(NODES)
    for n in NODES:
        ran = [c[0] for c in cmds[n]]
        assert ran.count(f"/opt/jepsen/bump-time {dt}") == sum(
            answers[i]["value"][n] == str(dt) for i in (0, 2, 3))


@pytest.mark.parametrize("seed", [45100, 7])
def test_the_tablet_mover_runs_as_the_reference(seed):
    """Against a fresh fake zero per package, its predicates written
    alike: the same moves from one seed, under the same spans."""
    out = {}
    for pkg in ("ref", "port"):
        trace = __import__(("jepsen_tpu" if pkg == "ref" else
                            "jepsen_tpu_torch") + ".trace", fromlist=["x"])
        with own_threads():
            srv = FakeDgraph().start()
            try:
                opts = {"host": "127.0.0.1", "port": srv.port,
                        "zero-public-port": srv.port}
                t = {"nodes": ["n1"], "accounts": [0, 1, 2, 3],
                     "total-amount": 10}
                c = dg(pkg).DgraphBankClient(opts).open(t, "n1")
                c.setup(t)
                for k in range(4):
                    _inv(c, "transfer", {"from": 0, "to": k, "amount": 1}, t)
                c.close(t)
                gen_of(pkg).set_seed(seed)
                db = dg(pkg).DgraphDB(opts)
                spans = []
                trace.tracing(exporter=spans.append)
                try:
                    mover = menu(pkg).TabletMover(db).setup(t)
                    got = [mover.invoke(t, {"type": "info",
                                            "f": "move-tablet",
                                            "value": None})
                           for _ in range(3)]
                finally:
                    trace.tracing()
                state = db.zero_state(t, "n1")
            finally:
                srv.stop()
        out[pkg] = normal((got, state, [s.name for s in spans]))
    assert out["port"] == out["ref"]
    got, state, spans = out["port"]
    assert any(g["value"]["moved"] for g in got)
    assert spans.count("nemesis.tablet-mover.invoke") == 3


# ---------------------------------------------------------------------------
# op lists
# ---------------------------------------------------------------------------

SCHEDULES = {
    "kill-alpha": ["kill-alpha"],
    "kill-zero": ["kill-zero"],
    "fix-alpha": ["fix-alpha"],
    "move-tablet": ["move-tablet"],
    "partition-halves": ["partition-halves"],
    "partition-ring": ["partition-ring"],
    "skew-clock": ["skew-clock"],
    "everything": sorted(["kill-alpha", "kill-zero", "fix-alpha",
                          "move-tablet", "partition-halves",
                          "partition-ring", "skew-clock"]),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_the_fault_schedules_give_the_reference_ops(case):
    opts = {"faults": SCHEDULES[case], "interval": 3}

    def whole(pkg, m):
        p = menu(pkg).package(dict(opts), dg(pkg).DgraphDB({}))
        return m["gen"].time_limit(600, m["gen"].nemesis(p["generator"]))

    def final(pkg, m):
        p = menu(pkg).package(dict(opts), dg(pkg).DgraphDB({}))
        return m["gen"].nemesis(p["final_generator"] or [])

    for seed in (45100, 7):
        port, ref = (_sim_ops(pkg, lambda m, pkg=pkg: whole(pkg, m), seed)
                     for pkg in ("port", "ref"))
        assert port == ref, (case, seed)
        assert _sim_ops("port", lambda m: final("port", m), seed) == \
            _sim_ops("ref", lambda m: final("ref", m), seed)
    fs = {o.get("f") for o in port if o["process"] == "nemesis"} - {None}
    assert fs, case
    p = menu("port")._flags(opts)
    assert p == menu("ref")._flags(opts)
    assert normal(menu("port").final_generator(p)) == \
        normal(menu("ref").final_generator(p))


def test_the_menu_constants_equal_the_references():
    port, ref = menu("port"), menu("ref")
    assert port.SKEWS == ref.SKEWS
    assert port.KNOWN_FAULTS == ref.KNOWN_FAULTS
    assert port.full_generator({}) is None
    for seed in (45100, 7):
        out = {}
        for pkg, m in (("port", port), ("ref", ref)):
            gen_of(pkg).set_seed(seed)
            out[pkg] = normal([m._partition_halves_gen(
                {"nodes": list(NODES)}, {}) for _ in range(3)] + [
                m._partition_ring_gen({"nodes": list(NODES)}, {})])
        assert out["port"] == out["ref"]
    fs = {}
    for pkg in ("port", "ref"):
        nem = menu(pkg).full_nemesis(dg(pkg).DgraphDB({}), {"skew": "big"})
        fs[pkg] = normal(sorted(map(str, nem.fs())))
    assert fs["port"] == fs["ref"]


#: workload → the workers of its generator's simulation
WORKERS = {"register": 6, "upsert": 12, "delete": 12}


def _workload_ops(pkg, wname, seed, whole, faults=()):
    opts = {"nodes": ["n1", "n2", "n3"], "workload": wname, "time-limit": 10,
            "rate": 10, "faults": list(faults), "interval": 2}

    def build(m):
        # the register and delete generators draw from `random`
        random.seed(seed)
        if whole:
            return m["gen"].limit(400, m["suite"]("dgraph").test(
                dict(opts))["generator"])
        w = m["suite"]("dgraph").workloads(dict(opts))[wname]
        return m["gen"].limit(300, w["generator"])

    return _sim(pkg, build, WORKERS.get(wname, 3), seed,
                test={"nodes": opts["nodes"], "accounts": list(range(8)),
                      "total-amount": 100, "max-transfer": 5})


@pytest.mark.parametrize("wname", sorted(dg("ref").workloads(
    {"nodes": ["n1", "n2", "n3"]})))
def test_each_workloads_generator_gives_the_reference_ops(wname):
    for seed in (45100, 7):
        for whole in (False, True):
            ref = _workload_ops("ref", wname, seed, whole)
            port = _workload_ops("port", wname, seed, whole)
            assert port == ref, (wname, seed, whole)
            assert [o for o in ref if o["type"] == "invoke"], wname


def test_the_whole_tests_generator_under_the_menu_gives_the_reference_ops():
    faults = SCHEDULES["everything"]
    for seed in (45100, 7):
        ref = _workload_ops("ref", "sequential", seed, True, faults)
        port = _workload_ops("port", "sequential", seed, True, faults)
        assert port == ref
    fs = {o["f"] for o in port if o["process"] == "nemesis"}
    assert len(fs) >= 4, fs


# ---------------------------------------------------------------------------
# checkers
# ---------------------------------------------------------------------------

UPSERT = {
    "valid": (_h((0, "invoke", "upsert", None), (0, "ok", "upsert", None),
                 (1, "invoke", "upsert", None), (1, "fail", "upsert", None),
                 (0, "invoke", "read", None), (0, "ok", "read", ["0x1"])),
              True),
    "two-uids": (_h((0, "invoke", "upsert", None), (0, "ok", "upsert", None),
                    (1, "invoke", "upsert", None), (1, "ok", "upsert", None),
                    (0, "invoke", "read", None),
                    (0, "ok", "read", ["0x1", "0x2"])), False),
}
DELETE = {
    "valid": (_h((0, "invoke", "read", None), (0, "ok", "read", []),
                 (0, "invoke", "read", None),
                 (0, "ok", "read", [{"uid": "0x1", "key": "5"}])), True),
    "two-records": (_h((0, "invoke", "read", None),
                       (0, "ok", "read", [{"uid": "0x1", "key": "5"},
                                          {"uid": "0x2", "key": "5"}])),
                    False),
    "half-indexed": (_h((0, "invoke", "read", None),
                        (0, "ok", "read", [{"uid": "0x1"}])), False),
}
SEQUENTIAL = {
    "valid": (_h((0, "invoke", "inc", None), (0, "ok", "inc", 1),
                 (1, "invoke", "read", None), (1, "ok", "read", 0),
                 (1, "invoke", "read", None), (1, "ok", "read", 2),
                 (0, "invoke", "read", None), (0, "ok", "read", 2)), True),
    "went-down": (_h((0, "invoke", "inc", None), (0, "ok", "inc", 1),
                     (1, "invoke", "read", None), (1, "ok", "read", 2),
                     (1, "invoke", "read", None), (1, "ok", "read", 1)),
                  False),
}


@pytest.mark.parametrize("case", sorted(UPSERT))
def test_the_upsert_checker_equals_the_reference(case):
    dicts, valid = UPSERT[case]
    ref, port = _check_both(lambda pkg: dg(pkg).UpsertChecker(), dicts)
    assert port == ref and port["valid?"] is valid


@pytest.mark.parametrize("case", sorted(DELETE))
def test_the_delete_checker_equals_the_reference(case):
    dicts, valid = DELETE[case]
    out = {}
    for pkg in ("ref", "port"):
        hist = __import__(("jepsen_tpu" if pkg == "ref" else
                           "jepsen_tpu_torch") + ".history", fromlist=["x"])
        h = hist.History.from_dicts(dicts).index_ops()
        out[pkg] = plain(dg(pkg).DeleteChecker().check(
            {}, h, {"history-key": 5}))
    assert out["port"] == out["ref"] and out["port"]["valid?"] is valid


@pytest.mark.parametrize("case", sorted(SEQUENTIAL))
def test_the_sequential_checker_and_plotter_equal_the_reference(case,
                                                                tmp_path):
    dicts, valid = SEQUENTIAL[case]
    ref, port = _check_both(lambda pkg: dg(pkg).SequentialChecker(), dicts)
    assert port == ref and port["valid?"] is valid
    if not valid:
        pair = port["non-monotonic"][0]
        assert pair[0]["value"] == 2 and pair[1]["value"] == 1
    files = {}
    for pkg in ("ref", "port"):
        base = tmp_path / pkg
        t = {"name": "dg", "start-time": "t0", "store-base": str(base)}
        ref_p, port_p = _check_both(lambda p: dg(pkg).SequentialPlotter(),
                                    dicts, test=t)
        assert ref_p == port_p == {"valid?": True}
        files[pkg] = sorted(os.listdir(base / "dg" / "t0")) if (
            base / "dg" / "t0").exists() else []
    assert files["port"] == files["ref"] == (
        [] if valid else ["sequential-0.svg"])
    port, ref = dg("port"), dg("ref")
    for s, pts in ((2, []), (2, [5]), (2, [5, 6, 20]), (3, [1, 8, 9, 30])):
        assert port.merged_windows(s, pts) == ref.merged_windows(s, pts)
    assert port.merged_windows(2, [5, 6, 20]) == [[3, 8], [18, 22]]


def test_the_suite_is_the_references():
    port, ref = dg("port"), dg("ref")
    for name in ("VERSION", "DIR", "ALPHA_PORT", "ZERO_PORT",
                 "ZERO_PUBLIC_PORT", "SCHEMA", "UPSERT_SCHEMA", "PRED_COUNT",
                 "BANK_SCHEMA", "WR_SCHEMA"):
        assert getattr(port, name) == getattr(ref, name), name
    assert [port.gen_pred("key", k) for k in range(20)] == \
        [ref.gen_pred("key", k) for k in range(20)]
    assert port.gen_preds("amount") == ref.gen_preds("amount")
    names = sorted(ref.workloads({"nodes": NODES}))
    assert sorted(port.workloads({"nodes": NODES, "device": "cpu"})) == names
    for wname in names:
        t = port.test({"nodes": NODES, "workload": wname, "device": "cpu"})
        r = ref.test({"nodes": NODES, "workload": wname})
        assert t["name"] == r["name"] == f"dgraph-{wname}"
        assert type(t["client"]).__name__ == type(r["client"]).__name__


def test_the_reference_nemesis_assertions_on_the_port(tmp_path):
    """tests/test_suite_nemeses.py:381-510 and :590-620 on the port."""
    import json

    from jepsen_tpu_torch import control, trace
    from jepsen_tpu_torch.control.core import DummyRemote
    from jepsen_tpu_torch.suites import dgraph, dgraph_nemesis

    db = dgraph.DgraphDB({})
    t = {"nodes": list(NODES), "remote": DummyRemote(),
         "ssh": {"dummy?": True}, "db": db}
    with control.with_session(t, t["remote"]):
        killer = dgraph_nemesis.AlphaKiller(db).setup(t)
        assert sorted(_inv(killer, "kill-alpha", None, t)["value"]) == NODES
        assert sorted(_inv(killer, "restart-alpha", None, t)["value"]) == \
            NODES
        zk = dgraph_nemesis.ZeroKiller(db).setup(t)
        assert set(_inv(zk, "kill-zero", None, t)["value"]) <= {"n1"}
        assert sorted(_inv(zk, "restart-zero", None, t)["value"]) == ["n1"]
        fixer = dgraph_nemesis.AlphaFixer(db).setup(t)
        assert set(_inv(fixer, "fix-alpha", None, t)["value"].values()) <= \
            {"restarted", "already-running"}

    flags = dgraph_nemesis._flags({
        "faults": ["kill-alpha", "kill-zero", "partition-ring",
                   "skew-clock", "move-tablet"],
        "interval": 0.01, "skew": "big"})
    assert flags["kill-alpha?"] and flags["move-tablet?"]
    assert dgraph_nemesis.full_generator(flags) is not None
    fs = [op["f"] for op in dgraph_nemesis.final_generator(flags)]
    assert "restart-alpha" in fs and "restart-zero" in fs
    assert "stop-partition-ring" in fs and "stop-skew" in fs
    op = dgraph_nemesis._partition_ring_gen({"nodes": list(NODES)}, {})
    assert op["f"] == "start-partition-ring" and set(op["value"]) == \
        set(NODES)

    t = dgraph.test({"nodes": NODES, "workload": "sequential",
                     "faults": ["kill-alpha", "move-tablet"],
                     "device": "cpu"})
    for f in ("kill-alpha", "restart-alpha", "move-tablet"):
        assert f in t["nemesis"].fs(), f
    assert t["name"] == "dgraph-sequential"

    assert dgraph_nemesis.skew_nemesis({"skew": "huge"}).dt_ms == 7500
    assert dgraph_nemesis.skew_nemesis({"skew": "tiny"}).dt_ms == 100
    assert dgraph_nemesis.skew_nemesis({}).dt_ms == 0
    flags = dgraph_nemesis._flags({"faults": ["skew-clock"]})
    assert flags["skew"] == "small"
    assert dgraph_nemesis.skew_nemesis(flags).dt_ms == 250

    # dgraph.test({"tracing": path}) wraps the client and records the
    # endpoint without turning the tracer on
    path = str(tmp_path / "spans.jsonl")
    t = dgraph.test({"tracing": path, "dummy?": True, "device": "cpu"})
    assert isinstance(t["client"], trace.Traced) and t["tracing"] == path
    with trace.with_trace("not-sampled"):
        pass
    assert not os.path.exists(path)
    try:
        trace.tracing(t["tracing"])
        with trace.with_trace("probe"):
            pass
    finally:
        trace.tracing()
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    assert recs and recs[0]["name"] == "probe"


def test_the_reference_client_round_trips_on_the_port():
    """tests/test_suite_workloads.py:360-410, :619-660, :1113-1200 and
    :2060-2085 on the port."""
    dgraph = suites.suite("dgraph")
    with own_threads():
        s = FakeDgraph().start()
        try:
            opts = {"host": "127.0.0.1", "port": s.port}
            c = dgraph.DgraphClient(opts).open({"nodes": ["n1"]}, "n1")
            c.setup({})
            assert _inv(c, "write", [1, 5])["type"] == "ok"
            r = _inv(c, "read", [1, None])
            # the untyped fake answers the string it stored
            assert r["type"] == "ok" and tuple(r["value"]) == (1, "5")
            assert _inv(c, "cas", [1, [5, 6]])["type"] == "ok"
            assert _inv(c, "cas", [1, [5, 7]])["type"] == "fail"
            c.close({})

            u = dgraph.DgraphUpsertClient(opts).open({"nodes": ["n1"]}, "n1")
            u.setup({})
            assert _inv(u, "upsert", independent.kv("a@x", None))["type"] \
                == "ok"
            assert _inv(u, "upsert", independent.kv("a@x", None))["type"] \
                == "fail"
            rr = _inv(u, "read", independent.kv("a@x", None))
            k, uids = rr["value"]
            assert rr["type"] == "ok" and k == "a@x" and len(uids) == 1
            u.close({})

            d = dgraph.DgraphDeleteClient(opts).open({"nodes": ["n1"]}, "n1")
            assert _inv(d, "upsert", independent.kv(5, None))["type"] == "ok"
            r2 = _inv(d, "upsert", independent.kv(5, None))
            assert r2["type"] == "fail" and r2["error"] == "present"
            recs = _inv(d, "read", independent.kv(5, None))["value"][1]
            assert len(recs) == 1 and set(recs[0]) == {"uid", "key"}
            assert _inv(d, "delete", independent.kv(5, None))["type"] == "ok"
            rd = _inv(d, "delete", independent.kv(5, None))
            assert rd["type"] == "fail" and rd["error"] == "not-found"
            assert _inv(d, "read", independent.kv(5, None))["value"][1] == []
            d.close({})

            q = dgraph.DgraphSequentialClient(opts).open({"nodes": ["n1"]},
                                                         "n1")
            assert tuple(_inv(q, "read", independent.kv(3, None))[
                "value"]) == (3, 0)
            for expect in (1, 2, 3):
                r = _inv(q, "inc", independent.kv(3, None))
                assert r["type"] == "ok" and tuple(r["value"]) == (3, expect)
            assert tuple(_inv(q, "inc", independent.kv(4, None))[
                "value"]) == (4, 1)
            q.close({})
        finally:
            s.stop()


def test_the_bank_and_txn_round_trips_on_the_port():
    """tests/test_suite_workloads.py:1113-1200 on the port: the bank's
    striped accounts, first-committer-wins and read-your-writes."""
    dgraph = suites.suite("dgraph")
    with own_threads():
        s = FakeDgraph().start()
        try:
            opts = {"host": "127.0.0.1", "port": s.port}
            t = {"nodes": ["n1"], "accounts": [0, 1, 2], "total-amount": 30}
            c = dgraph.DgraphBankClient(opts).open(t, "n1")
            c.setup(t)
            assert _inv(c, "read", None, t)["value"] == {0: 30}
            assert _inv(c, "transfer", {"from": 0, "to": 1, "amount": 10},
                        t)["type"] == "ok"
            assert _inv(c, "read", None, t)["value"] == {0: 20, 1: 10}
            assert _inv(c, "transfer", {"from": 1, "to": 0, "amount": 10},
                        t)["type"] == "ok"
            assert _inv(c, "read", None, t)["value"] == {0: 30}
            assert _inv(c, "transfer", {"from": 2, "to": 0, "amount": 5},
                        t)["type"] == "fail"
            c.close(t)

            c1 = dgraph.DgraphTxnClient(opts).open({}, "n1")
            c1.setup({})
            assert _inv(c1, "txn", [["w", 5, 1]])["type"] == "ok"
            t1, l1 = dgraph._DgraphTxn(c1.conn), {}
            c1._mop(t1, l1, "r", 5, None)
            c1._mop(t1, l1, "w", 5, 2)
            c2 = dgraph.DgraphTxnClient(opts).open({}, "n1")
            t2, l2 = dgraph._DgraphTxn(c2.conn), {}
            c2._mop(t2, l2, "r", 5, None)
            c2._mop(t2, l2, "w", 5, 3)
            t1.commit()
            with pytest.raises(dgraph.TxnAborted):
                t2.commit()
            assert _inv(c1, "txn", [["r", 5, None]])["value"] == [
                ["r", 5, 2]]
            r = _inv(c1, "txn", [["w", 9, 4], ["r", 9, None]])
            assert r["type"] == "ok" and r["value"] == [["w", 9, 4],
                                                        ["r", 9, 4]]
            c1.close({})
            c2.close({})
        finally:
            s.stop()


# ---------------------------------------------------------------------------
# full runs
# ---------------------------------------------------------------------------

#: workload → (fake server, rate): the reference's
#: ``*_full_test_in_process`` settings (tests/test_suite_workloads.py); the
#: register at rate 100 against the typed fake, as chip_smoke.py's phase
#: 33 runs it
FULL_RUNS = {
    "register": (TypedDgraph, 100),
    "wr": (FakeDgraph, 20),
    "upsert": (FakeDgraph, 30),
    "delete": (FakeDgraph, 40),
    "sequential": (FakeDgraph, 30),
}
NEEDED = {"register": {"read", "write", "cas"}, "wr": {"txn"},
          "upsert": {"upsert", "read"}, "delete": {"read"},
          "sequential": {"inc", "read"}}


def _opts(wname, rate):
    return {"nodes": ["n1", "n2"], "time-limit": 2, "rate": rate,
            "workload": wname, "faults": []}


def _run(wname, fake, rate):
    with own_threads():
        srv = fake().start()
        try:
            t = suites.suite("dgraph").test({
                **_opts(wname, rate), "host": "127.0.0.1",
                "port": srv.port, "device": "cpu"})
            t["db"] = port_db.noop()
            t["ssh"] = {"dummy?": True}
            return core.run(t)
        finally:
            srv.stop()


def _checked_alike(wname, rate, history):
    dicts = [op.to_dict() for op in history if op.process != "nemesis"]

    def make(pkg):
        opts = dict(_opts(wname, rate))
        if pkg == "port":
            opts["device"] = "cpu"
        return dg(pkg).workloads(opts)[wname]["checker"]

    ref, port = _check_both(make, dicts)
    assert port == ref
    return port


def _oracle_keys_equal(port, history):
    keys = port["linearizable"]["results"]
    oracle = plain(independent.checker(checker.linearizable(
        models.cas_register(), algorithm="oracle")).check(
            {}, history, {}))["results"]
    assert sorted(keys) == sorted(oracle)
    for k, r in keys.items():
        o = oracle[k]
        shared = set(r) & set(o)
        assert "valid?" in shared
        assert all(r[f] == o[f] for f in shared), (k, r, o)


@pytest.mark.parametrize("wname", sorted(FULL_RUNS))
def test_each_workload_runs_valid_and_as_the_reference_checks_it(wname):
    fake, rate = FULL_RUNS[wname]
    result = _run(wname, fake, rate)
    history, results = result["history"], result["results"]
    assert results["valid?"] is True, results
    oks = [op for op in history if isinstance(op.process, int)
           and op.type == "ok"]
    assert {op.f for op in oks} >= NEEDED[wname], {op.f for op in oks}
    port = _checked_alike(wname, rate, history)
    assert port == plain(results["workload"])
    if wname == "register":
        _oracle_keys_equal(port, history)


def test_the_register_on_the_untyped_fake_is_invalid_alike():
    """``FakeDgraph`` answers the register's reads with strings: the
    cas-register model refuses them in both packages, and the device
    route (on the plain versions) agrees with the oracle key by key."""
    result = _run("register", FakeDgraph, 100)
    history, results = result["history"], result["results"]
    reads = [op for op in history if op.type == "ok" and op.f == "read"
             and op.value[1] is not None]
    assert reads and all(isinstance(op.value[1], str) for op in reads)
    port = _checked_alike("register", 100, history)
    assert port == plain(results["workload"])
    assert port["valid?"] is False
    _oracle_keys_equal(port, history)
