"""The clock faults on the port — the clock nemesis and its tools
(``jepsen_tpu_torch.nemesis.time``), ``faketime`` and cockroachdb's fault
menu (``jepsen_tpu_torch.suites.crdb_nemesis``) — against the JAX
package's.

Every command here runs on a recording remote (each package's
``DummyRemote``): nothing sets a clock, stops ntp, compiles or runs
``bump-time`` or builds libfaketime on the machine the tests run on.

- **Commands.**  The clock tools (install, bump, strobe, the experiment,
  reset and its ``date`` fallback, the offset probe), the clock nemesis
  set up, given every op and torn down, ``faketime``'s install, wrap and
  unwrap, and every menu bundle's nemesis started and stopped: the same
  answers and the same commands, node by node, with their sudo and stdin.
- **Op lists.**  The clock generators, every menu entry on the single
  schedule and pairs on the double schedule give the reference's ops
  from one seed.
- ``BumpTime`` draws ``gen.rng`` once a node, in node order.
- **The reference's own assertions** on the ported menu and faketime.
"""

import json
import math
import os
import random
import time

import pytest

from fake_servers import FakePg
from jepsen_tpu import control as ref_control
from jepsen_tpu import faketime as ref_faketime
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import net as ref_net
from jepsen_tpu.generator import sim as ref_sim
from jepsen_tpu.nemesis import time as ref_nt
from jepsen_tpu.suites import cockroachdb as ref_cockroachdb
from jepsen_tpu.suites import crdb_nemesis as ref_crdb_nemesis
from jepsen_tpu_torch import control, faketime, net
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.generator import sim
from jepsen_tpu_torch.nemesis import time as nt
from jepsen_tpu_torch.suites import cockroachdb, crdb_nemesis

NODES = ["n1", "n2", "n3", "n4", "n5"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {
    "ref": dict(control=ref_control, gen=ref_gen, sim=ref_sim, nt=ref_nt,
                faketime=ref_faketime, net=ref_net, crdb=ref_crdb_nemesis,
                cockroachdb=ref_cockroachdb),
    "port": dict(control=control, gen=gen, sim=sim, nt=nt, faketime=faketime,
                 net=net, crdb=crdb_nemesis, cockroachdb=cockroachdb),
}


def normal(x):
    """Answers as JSON gives them back (tuples as lists, sets sorted)."""
    def default(o):
        if isinstance(o, (set, frozenset)):
            return sorted(o, key=repr)
        return repr(o)

    return json.loads(json.dumps(x, default=default, sort_keys=True))


@pytest.fixture
def serial_reference(monkeypatch):
    """The reference's ``control.on_nodes`` one node at a time, in node
    order: its ``BumpTime`` draws ``gen.rng`` on the nodes' threads, so
    only then do its draws meet the nodes as the port's do."""
    on_nodes = ref_control.on_nodes

    def serial(test, fn_or_nodes, maybe_fn=None):
        if maybe_fn is None:
            nodes, fn = test["nodes"], fn_or_nodes
        else:
            nodes, fn = fn_or_nodes, maybe_fn
        out = {}
        for node in nodes:
            out.update(on_nodes(test, [node], fn))
        return out

    monkeypatch.setattr(ref_control, "on_nodes", serial)


def recording(pkg, fail=(), out=None):
    """``pkg``'s recording remote; a command starting with a prefix in
    ``fail`` exits 1, and one in ``out`` prints its value."""
    c = PACKAGES[pkg]["control"]
    core = __import__(c.__name__ + ".core", fromlist=["core"])

    class Remote(c.DummyRemote):
        def connect(self, node, test=None):
            return Remote(node, self.log)

        def execute(self, command):
            self.log.append((self.node, command))
            code = 1 if command.cmd.startswith(tuple(fail)) else 0
            said = next((v for k, v in (out or {}).items()
                         if command.cmd.startswith(k)), "")
            return core.Result(cmd=command.cmd, exit=code, out=said,
                               err="refused" if code else "",
                               node=self.node)

    return Remote()


def on_remote(pkg, fn, nodes=NODES, remote=None, **test):
    """``fn(m, test)`` on ``pkg``'s recording remote: (answer, commands by
    node with their sudo and stdin)."""
    m = PACKAGES[pkg]
    t = {"nodes": list(nodes), **test}
    remote = remote or m["control"].DummyRemote()
    with m["control"].with_session(t, remote):
        answer = fn(m, t)
    cmds = {}
    for node, c in remote.log:
        cmds.setdefault(node, []).append(
            c if isinstance(c, tuple) else (c.cmd, c.sudo, c.stdin, c.dir))
    return normal(answer), cmds


def both(fn, **kw):
    out = {pkg: on_remote(pkg, fn, **{k: v(pkg) if callable(v) else v
                                      for k, v in kw.items()})
           for pkg in PACKAGES}
    assert out["port"] == out["ref"]
    return out["port"]


# ---------------------------------------------------------------------------
# the clock tools and the clock nemesis
# ---------------------------------------------------------------------------


def test_the_clock_tools_emit_the_reference_commands():
    def run(m, t):
        def on(test, node):
            m["nt"].install()
            return (m["nt"].bump_time(-300.7), m["nt"].bump_time(4096),
                    m["nt"].strobe_time(16, 2.5, 3),
                    m["nt"].strobe_time_experiment(8, 4, 2),
                    m["nt"].reset_time(), m["nt"].current_offset())
        return m["control"].on_nodes(t, on)

    answers, cmds = both(run)
    assert sorted(cmds) == NODES
    ran = [c[0] for c in cmds["n2"]]
    assert ran[:3] == ["mkdir -p /opt/jepsen", "cat > /opt/jepsen/bump-time.c",
                       "gcc -O2 -o /opt/jepsen/bump-time "
                       "/opt/jepsen/bump-time.c"]
    for cmd in ("/opt/jepsen/bump-time -300", "/opt/jepsen/bump-time 4096",
                "/opt/jepsen/strobe-time 16 2 3",
                "/opt/jepsen/strobe-time-experiment 8 4 2",
                "ntpdate -p 1 -b pool.ntp.org", "date +%s.%N"):
        assert cmd in ran, cmd
    sources = {c[0]: c[2] for c in cmds["n2"] if c[0].startswith("cat > ")}
    for name in ("bump-time", "strobe-time", "strobe-time-experiment"):
        with open(os.path.join(REPO, "native", f"{name}.c")) as f:
            assert sources[f"cat > /opt/jepsen/{name}.c"] == f.read()
    # every tool but the offset probe runs as root
    assert all(c[1] == "root" for c in cmds["n2"] if c[0] != "date +%s.%N")
    assert answers["n2"][-1] is None  # the recording remote prints no date


def test_reset_time_falls_back_to_date_as_the_reference(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1760000000.75)
    _, cmds = both(lambda m, t: m["control"].on_nodes(
        t, lambda test, node: m["nt"].reset_time()),
        remote=lambda pkg: recording(pkg, fail=("ntpdate",)))
    assert [c[0] for c in cmds["n1"]] == [
        "ntpdate -p 1 -b pool.ntp.org", "date +%s -s @1760000000"]


def test_current_offset_reads_the_nodes_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 100.25)
    answers, _ = both(lambda m, t: m["control"].on_nodes(
        t, lambda test, node: m["nt"].current_offset()),
        remote=lambda pkg: recording(pkg, out={"date": "102.5"}))
    assert answers == {n: 2.25 for n in NODES}


#: clock ops as the clock nemesis takes them
CLOCK_OPS = [
    {"f": "bump", "value": {"n1": 64, "n4": -4096}},
    {"f": "strobe", "value": {"n2": {"delta": 16, "period": 2,
                                     "duration": 3},
                              "n5": {"delta": 4, "period": 1,
                                     "duration": 1}}},
    {"f": "reset", "value": ["n3"]},
    {"f": "reset", "value": None},
    {"f": "check-offsets", "value": None},
]


def test_the_clock_nemesis_answers_and_runs_as_the_reference():
    def run(m, t):
        nem = m["nt"].clock_nemesis()
        nem = nem.setup(t) or nem
        answers = [nem.invoke(t, {**op, "type": "info", "process": "nemesis",
                                  "time": i})
                   for i, op in enumerate(CLOCK_OPS)]
        with pytest.raises(ValueError, match="cannot handle"):
            nem.invoke(t, {"f": "melt", "value": None, "type": "info"})
        nem.teardown(t)
        return answers, sorted(nem.fs())

    (answers, fs), cmds = both(run)
    assert fs == ["bump", "check-offsets", "reset", "strobe"]
    assert [a["type"] for a in answers] == ["info"] * len(CLOCK_OPS)
    assert answers[0]["value"] == {"n1": "", "n4": ""}
    assert answers[-1]["value"] == {n: None for n in NODES}
    ran = {n: [c[0] for c in cs] for n, cs in cmds.items()}
    assert "/opt/jepsen/bump-time -4096" in ran["n4"]
    assert "/opt/jepsen/strobe-time 4 1 1" in ran["n5"]
    assert "/opt/jepsen/bump-time -4096" not in ran["n1"]
    for n in NODES:
        assert "service ntp stop" in ran[n]
        assert "systemctl stop systemd-timesyncd" in ran[n]
        assert ran[n][-1] == "ntpdate -p 1 -b pool.ntp.org"  # teardown


def _sim_ops(pkg, build, seed, n=2):
    m = PACKAGES[pkg]
    m["gen"].set_seed(seed)
    s = m["sim"]
    ops = s.simulate(build(m), lambda ctx, inv: {
        **inv, "type": "info", "time": inv["time"] + s.PERFECT_LATENCY},
        ctx=s.n_plus_nemesis_context(n), seed=seed, test={"nodes": NODES})
    return normal(ops)


@pytest.mark.parametrize("name", ["reset_gen", "bump_gen", "strobe_gen",
                                  "check_offsets_gen", "clock_gen"])
def test_the_clock_generators_give_the_reference_ops(name):
    def build(m):
        g = getattr(m["nt"], name)
        g = g() if name == "clock_gen" else g
        return m["gen"].time_limit(60, m["gen"].nemesis(
            m["gen"].stagger(1, g)))

    for seed in (45100, 3):
        port = _sim_ops("port", build, seed)
        assert port == _sim_ops("ref", build, seed)
        done = [o for o in port if o["process"] == "nemesis"
                and o["type"] == "info"]
        assert len(done) > 20
        if name in ("bump_gen", "strobe_gen"):
            assert any(len(o["value"]) > 1 for o in done)


# ---------------------------------------------------------------------------
# faketime
# ---------------------------------------------------------------------------


def test_faketime_emits_the_reference_commands():
    def run(m, t):
        ft = m["faketime"]

        def on(test, node):
            ft.install()
            ft.wrap("/usr/bin/db", 5.0)
            ft.wrap("/usr/bin/db", -2.5, rate=3.0)
            ft.unwrap("/usr/bin/db")
            return [ft.script(), ft.script(1.5), ft.script(-2.5, rate=3.0),
                    ft.script(0.0, rate=0.2)]
        return m["control"].on_nodes(t, on)

    answers, cmds = both(run)
    ran = [c[0] for c in cmds["n3"]]
    assert "make install" in ran and "chmod +x /usr/bin/db" in ran
    assert "mv /usr/bin/db /usr/bin/db.real" in ran
    wrappers = [c[2] for c in cmds["n3"] if c[0] == "cat > /usr/bin/db"]
    assert len(wrappers) == 2
    assert 'FAKETIME="-2.500000s x3.0"' in wrappers[1]
    assert wrappers[1].endswith('exec "/usr/bin/db.real" "$@"\n')
    assert answers["n3"][2] == faketime.script(-2.5, rate=3.0)


def test_faketime_falls_back_and_rewraps_as_the_reference():
    def run(m, t):
        def on(test, node):
            m["faketime"].install()
            m["faketime"].wrap("/opt/db/bin/db", 7.0)
        return m["control"].on_nodes(t, on)

    _, cmds = both(run, remote=lambda pkg: recording(
        pkg, fail=("make",), out={"test -f": "yes\n"}))
    ran = [c[0] for c in cmds["n1"]]
    assert "apt-get install -y faketime" in ran
    # already wrapped: the original stays where it is
    assert not any(c.startswith("mv ") for c in ran)


def test_rand_factor_bounds_and_distribution():
    rng = random.Random(45100)
    vals = [faketime.rand_factor(rng) for _ in range(500)]
    assert all(0.2 <= v <= 5.0 for v in vals)
    # log-uniform: the geometric mean sits near 1, and both halves of
    # the log-range actually occur
    g = math.exp(sum(math.log(v) for v in vals) / len(vals))
    assert 0.8 < g < 1.25
    assert any(v < 0.5 for v in vals) and any(v > 2.0 for v in vals)
    ref_rng = random.Random(45100)
    assert vals == [ref_faketime.rand_factor(ref_rng) for _ in range(500)]


# ---------------------------------------------------------------------------
# cockroachdb's fault menu
# ---------------------------------------------------------------------------


def _drain(pkg, g, n_ops, step_ns=int(10e9)):
    """Up to ``n_ops`` ops of ``g``, virtual time jumping ``step_ns``
    after each draw (past the schedules' sleeps)."""
    m = PACKAGES[pkg]
    ctx = m["gen"].context({"concurrency": 1, "nodes": NODES})
    t = {"nodes": list(NODES)}
    ops = []
    for _ in range(10_000):
        if len(ops) >= n_ops:
            break
        res = m["gen"].op(g, t, ctx)
        if res is None:
            break
        o, g = res
        if o != m["gen"].PENDING and isinstance(o, dict) and o.get("f"):
            ops.append(o)
        ctx = {**ctx, "time": ctx["time"] + step_ns}
    return normal(ops)


def _package(pkg, spec, schedule=None, opts=None):
    m = PACKAGES[pkg]
    o = {"nemesis": spec, **(opts or {})}
    if schedule:
        o["nemesis-schedule"] = schedule
    return m["crdb"].package(o, m["cockroachdb"].CockroachDB({}))


def _schedule(pkg, spec, schedule=None, seed=45100, step_ns=int(3e9)):
    PACKAGES[pkg]["gen"].set_seed(seed)
    p = _package(pkg, spec, schedule)
    return (p["name"], p["clocks"], normal(sorted(p["perf"], key=str)),
            normal(sorted(p["nemesis"].fs(), key=str)),
            _drain(pkg, p["generator"], 24, step_ns)
            if p["generator"] is not None else None,
            _drain(pkg, p["final_generator"], 8)
            if p["final_generator"] is not None else None)


@pytest.mark.parametrize("name", sorted(crdb_nemesis.MENU))
def test_each_menu_entry_gives_the_reference_ops(name):
    assert sorted(crdb_nemesis.MENU) == sorted(ref_crdb_nemesis.MENU)
    for step in (int(3e9), int(10e9)):
        port = _schedule("port", name, step_ns=step)
        assert port == _schedule("ref", name, step_ns=step)
    name_, clocks, _, fs, during, final = port
    if name != "none":
        assert during and all(o["f"][0] == name_ for o in during)
        assert {o["f"][1] for o in during} == (
            {"split"} if name == "split" else {"start", "stop"})
    assert clocks == name.endswith("skews")


DOUBLES = [("parts", "start-stop"), ("small-skews", "start-kill-2"),
           ("majority-ring", "big-skews"), ("strobe-skews", "parts")]


@pytest.mark.parametrize("pair", DOUBLES, ids=["~".join(p) for p in DOUBLES])
def test_the_double_schedule_gives_the_reference_ops(pair):
    for step in (int(2e9), int(3e9)):
        port = _schedule("port", list(pair), "double", step_ns=step)
        assert port == _schedule("ref", list(pair), "double", step_ns=step)
    during = port[4]
    assert {o["f"][0] for o in during} == {
        _package("port", [p])["name"] for p in pair}


def _menu_run(m, t, spec, seed, opts=None):
    """The composed menu's nemesis set up, started and stopped bundle by
    bundle, twice, then torn down."""
    m["gen"].set_seed(seed)
    p = m["crdb"].package({"nemesis": spec, **(opts or {})},
                          m["cockroachdb"].CockroachDB({}))
    nem = p["nemesis"].setup(t) or p["nemesis"]
    names = sorted({f[0] for f in nem.fs()})
    answers = []
    for _ in range(2):
        for name in names:
            for f in sorted({f[1] for f in nem.fs() if f[0] == name}):
                answers.append(nem.invoke(t, {"type": "info", "f": (name, f),
                                              "value": None}))
    nem.teardown(t)
    return answers


def test_the_menu_nemeses_answer_and_run_as_the_reference(serial_reference):
    spec = sorted(n for n in crdb_nemesis.MENU if n != "split")
    for seed in (45100, 9):
        answers, cmds = both(lambda m, t: _menu_run(m, t, spec, seed),
                             net=lambda pkg: PACKAGES[pkg]["net"].iptables)
        assert len(answers) == 4 * (len(spec) - 1)  # blank has no fs
        ran = [c[0] for n in NODES for c in cmds[n]]
        assert any(c.startswith("/opt/jepsen/bump-time 5000") for c in ran)
        assert any(c.startswith("/opt/jepsen/strobe-time 200 10 10")
                   for c in ran)
        assert any("netem" in c for c in ran)
        assert any(c.startswith("iptables") for c in ran)


def test_bump_time_draws_once_a_node_in_node_order(serial_reference):
    def run(m, t):
        m["gen"].set_seed(45100)
        nem = m["crdb"].BumpTime(0.25).setup(t)
        return [nem.invoke(t, {"type": "info", "f": f, "value": None})
                for f in ("start", "stop", "start")]

    answers, cmds = on_remote("port", run)
    rng = random.Random()
    gen.set_seed(45100)
    rng.setstate(gen.rng.getstate())
    for a in (answers[0], answers[2]):
        want = {n: "0.25" if rng.random() < 0.5 else "0" for n in NODES}
        assert a["value"] == want
        assert a["type"] == "info"
    bumped = [n for n in NODES if answers[0]["value"][n] == "0.25"]
    assert bumped and len(bumped) < len(NODES)
    for n in NODES:
        ran = [c[0] for c in cmds[n]]
        assert ran.count("/opt/jepsen/bump-time 250") == (
            (answers[0]["value"][n] == "0.25")
            + (answers[2]["value"][n] == "0.25"))
    # the reference's, its draws taken in node order
    assert on_remote("ref", run) == (answers, cmds)


def test_the_split_nemesis_answers_as_the_reference():
    srv = FakePg().start()
    try:
        opts = {"host": "127.0.0.1", "port": srv.port, "user": "postgres",
                "dialect": "cockroach"}
        for workload in ("register", "sets"):
            def run(m, t):
                nem = m["crdb"].SplitNemesis({**opts, "workload": workload})
                nem = nem.setup(t)
                out = [nem.invoke(t, {"type": "info", "f": "split",
                                      "value": None})]
                m["gen"].set_seed(45100)
                for kr in ({}, {"registers": [3, 9, 4], "sets": [1]},
                           {"registers": [3, 9, 4], "sets": [1]}):
                    out.append(nem.invoke({**t, "keyrange": kr},
                                          {"type": "info", "f": "split",
                                           "value": None}))
                nem.teardown(t)
                return out, sorted(nem.fs()), nem.table, nem.column

            answers, cmds = both(run)
            assert answers[0][0]["value"] == "no-keyrange"
            assert answers[0][1]["value"] == "nothing-to-split"
            assert not cmds
    finally:
        srv.stop()


def test_crdb_split_nemesis_keyrange_paths():
    nem = crdb_nemesis.SplitNemesis({})
    nem.client = None  # no live cluster: probe path degrades cleanly
    res = nem.invoke({"nodes": NODES}, {"type": "info", "f": "split",
                                        "value": None})
    assert res["value"] == "no-keyrange"
    res = nem.invoke({"nodes": NODES, "keyrange": {}},
                     {"type": "info", "f": "split", "value": None})
    assert res["value"] == "nothing-to-split"


def test_crdb_double_schedule_interleaves_two_bundles():
    pkg = _package("port", ["parts", "start-stop"], "double")
    assert pkg["name"] == "parts~startstop"
    fs = [tuple(o["f"]) for o in _drain("port", pkg["generator"], 8,
                                        step_ns=int(3e9))]
    # instance windows overlap and alternate which leads
    assert fs[:4] == [("parts", "start"), ("startstop", "start"),
                      ("parts", "stop"), ("startstop", "stop")], fs
    assert fs[4:6] == [("startstop", "start"), ("parts", "start")], fs
    fin = [tuple(o["f"]) for o in _drain("port", pkg["final_generator"], 4)]
    assert fin == [("parts", "stop"), ("startstop", "stop")]
    with pytest.raises(ValueError):
        _package("port", ["parts"], "double")


def test_crdb_skew_ladder_and_restarting_wrapper(serial_reference):
    db = cockroachdb.CockroachDB({})
    assert crdb_nemesis.small_skews(db)["clocks"] is True
    assert crdb_nemesis.huge_skews(db)["name"] == "huge-skews"
    # big/huge skews pair the bump with a netem slowdown wrapper
    assert isinstance(crdb_nemesis.big_skews(db)["client"],
                      crdb_nemesis.Slowing)
    offsets = {name: getattr(crdb_nemesis, name.replace("-", "_"))(
        db)["client"] for name in ("small-skews", "subcritical-skews",
                                   "critical-skews", "big-skews",
                                   "huge-skews")}
    dts = {k: (c.nem if isinstance(c, crdb_nemesis.Slowing) else c).nem.dt_s
           for k, c in offsets.items()}
    assert dts == {"small-skews": 0.1, "subcritical-skews": 0.2,
                   "critical-skews": 0.25, "big-skews": 0.5,
                   "huge-skews": 5}

    def run(m, t):
        nem = m["crdb"].Restarting(m["crdb"].BumpTime(0.25),
                                   m["cockroachdb"].CockroachDB({})).setup(t)
        return nem.invoke(t, {"type": "info", "f": "stop", "value": None})

    res, _ = both(run)
    clock_value, restarts = res["value"]
    assert sorted(restarts) == NODES and sorted(clock_value) == NODES
