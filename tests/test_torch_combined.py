"""The port's nemesis packages (``jepsen_tpu_torch.nemesis.combined``)
against the JAX package's (which does not import JAX).

- Each package's generator, final generator and the whole localkv test's
  generator, built in both packages and run through each package's
  deterministic simulator from one seed, give equal op lists: every
  ``rng`` draw comes in the reference's order (``tests/test_nemesis.py``
  ``:234-307`` covers the packages' shapes).
- ``db_nodes``, ``grudge``, ``node_specs`` and ``partition_specs`` equal
  the reference's from one seed; the packages' nemeses answer and emit
  commands as the reference's do on a recording remote.
- The idle clock and disk sub-packages are the reference's: the clock
  nemesis (``nemesis/time.py``) answers and emits the reference's
  commands on a recording remote, and the ``clock`` fault's op lists
  equal the reference's; asking for the ``disk`` fault raises
  ``NotImplementedError`` naming ``faultfs.py``, which is not ported.
"""

import random

import pytest

from jepsen_tpu import control as ref_control
from jepsen_tpu import db as ref_db
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import net as ref_net
from jepsen_tpu.generator import sim as ref_sim
from jepsen_tpu.nemesis import combined as ref_combined
from jepsen_tpu.suites import localkv as ref_localkv
from jepsen_tpu_torch import control, db, generator as gen, net
from jepsen_tpu_torch.generator import sim
from jepsen_tpu_torch.nemesis import combined
from jepsen_tpu_torch.suites import localkv

NODES = ["n1", "n2", "n3", "n4", "n5"]

PACKAGES = {
    "port": (gen, sim, combined, db, control, net, localkv),
    "ref": (ref_gen, ref_sim, ref_combined, ref_db, ref_control, ref_net,
            ref_localkv),
}


def _db(pkg, primary=False):
    """A DB with process and pause faults (and primaries when asked)
    whose every action runs one recorded command."""
    _, _, _, d, c, _, _ = PACKAGES[pkg]
    bases = (d.DB, d.Process, d.Pause) + ((d.Primary,) if primary else ())

    def act(name):
        return lambda self, test, node: c.execute(name, node) or name

    return type("RecDB", bases, {
        "start": act("start"), "kill": act("kill"), "pause": act("pause"),
        "resume": act("resume"),
        "primaries": lambda self, test: ["n2", "n4"],
    })()


def _pkg(pkg, build, faults, primary=False, **opts):
    g, _, cm, _, _, _, _ = PACKAGES[pkg]
    return build(cm, {"db": _db(pkg, primary), "faults": set(faults),
                      **opts})


def _ops(pkg, generator, seed, mode="perfect", test=None):
    g, s, _, _, _, _, _ = PACKAGES[pkg]
    g.set_seed(seed)
    ops = s.simulate(generator, lambda ctx, inv: {
        **inv, "type": "info", "time": inv["time"] + s.PERFECT_LATENCY},
        ctx=s.n_plus_nemesis_context(2), seed=seed, test=test)
    return ops


BUILDS = {
    "partition": (lambda cm, o: cm.partition_package(o), ["partition"]),
    "kill": (lambda cm, o: cm.db_package(o), ["kill"]),
    "pause": (lambda cm, o: cm.db_package(o), ["pause"]),
    "kill+pause": (lambda cm, o: cm.db_package(o), ["kill", "pause"]),
    "package partition,kill": (
        lambda cm, o: cm.nemesis_package(o, only_active=True),
        ["partition", "kill"]),
    "package all but clock": (
        lambda cm, o: cm.nemesis_package(o),
        ["partition", "kill", "pause"]),
    "f_map": (lambda cm, o: cm.f_map(lambda f: f"db1-{f}",
                                     cm.partition_package(o)),
              ["partition"]),
    "targets": (lambda cm, o: cm.nemesis_package(
        {**o, "partition": {"targets": ["one", "majority"]},
         "kill": {"targets": ["all", "minority"]}}, only_active=True),
        ["partition", "kill"]),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
@pytest.mark.parametrize("seed", [45100, 3])
def test_package_generators_equal_the_reference(name, seed):
    build, faults = BUILDS[name]
    out = {}
    for pkg in PACKAGES:
        g = PACKAGES[pkg][0]
        p = _pkg(pkg, build, faults, interval=1)
        main = _ops(pkg, g.time_limit(30, g.nemesis(p["generator"])), seed)
        final = _ops(pkg, g.nemesis(p["final_generator"]), seed)
        out[pkg] = (main, final, sorted(p["nemesis"].fs(), key=str),
                    sorted(p["perf"], key=str))
    assert out["port"] == out["ref"]
    main, final, _, _ = out["port"]
    assert len(main) > 10 and final


def test_the_localkv_tests_generator_equals_the_reference():
    opts = {"nodes": NODES, "faults": ["partition", "kill"], "interval": 2,
            "time-limit": 10, "concurrency": 6, "rate": 40}
    out = {}
    for pkg in PACKAGES:
        g, s, _, _, _, _, lk = PACKAGES[pkg]
        t = lk.test(dict(opts))
        random.seed(11)  # the register workload draws from `random`
        g.set_seed(45100)
        out[pkg] = (s.perfect_star(t["generator"],
                                   s.n_plus_nemesis_context(6)),
                    t["plot"], sorted(t["nemesis"].fs()), t["name"],
                    t["concurrency"])
    assert out["port"] == out["ref"]
    ops = out["port"][0]
    fs = {o["f"] for o in ops}
    assert {"read", "write", "start-partition", "kill"} <= fs


@pytest.mark.parametrize("seed", [45100, 8, 9])
def test_node_and_partition_specs_equal_the_reference(seed):
    out = {}
    for pkg in PACKAGES:
        g, _, cm, _, _, _, _ = PACKAGES[pkg]
        g.set_seed(seed)
        test = {"nodes": list(NODES)}
        d = _db(pkg, primary=True)
        out[pkg] = (
            [cm.db_nodes(test, d, spec) for spec in cm.node_specs(d)
             + [["n2"]]],
            [{k: sorted(v) for k, v in cm.grudge(test, d, spec).items()}
             for spec in cm.partition_specs(d) + [{"n1": {"n3"}}]],
            cm.node_specs(_db(pkg)), cm.partition_specs(_db(pkg)),
            [cm.minority_third(n) for n in range(8)],
        )
    assert out["port"] == out["ref"]


def _recorded(log):
    by_node = {}
    for node, c in log:
        by_node.setdefault(node, []).append((c.cmd, c.sudo))
    return by_node


@pytest.mark.parametrize("ops", [
    [{"f": "start-partition", "value": "majority"},
     {"f": "stop-partition", "value": None},
     {"f": "start-partition", "value": "primaries"},
     {"f": "kill", "value": "minority"}, {"f": "start", "value": "all"},
     {"f": "pause", "value": "one"}, {"f": "resume", "value": "all"}],
], ids=["mixed"])
def test_package_nemeses_equal_the_reference(ops):
    out = {}
    for pkg in PACKAGES:
        g, _, cm, _, c, nt, _ = PACKAGES[pkg]
        g.set_seed(45100)
        p = _pkg(pkg, lambda cm, o: cm.nemesis_package(o, only_active=True),
                 ["partition", "kill", "pause"], primary=True)
        test = {"name": "nem", "nodes": list(NODES), "net": nt.iptables}
        remote = c.DummyRemote()
        with c.with_session(test, remote):
            nem = p["nemesis"].setup(test)
            answers = [nem.invoke(test, {**op, "type": "info",
                                         "process": "nemesis", "time": i})
                       for i, op in enumerate(ops)]
            nem.teardown(test)
        out[pkg] = (answers, _recorded(remote.log))
    assert out["port"] == out["ref"]
    answers, cmds = out["port"]
    assert answers[1]["value"] == "network-healed"
    assert any(c == ("kill n1", None) or c[0].startswith("kill")
               for v in cmds.values() for c in v)


#: clock ops as the clock package's nemesis takes them
CLOCK_OPS = [
    {"f": "bump-clock", "value": {"n1": 64, "n3": -4096}},
    {"f": "strobe-clock",
     "value": {"n2": {"delta": 16, "period": 2, "duration": 3}}},
    {"f": "reset-clock", "value": ["n1", "n2"]},
    {"f": "reset-clock", "value": None},
]


def _clock_run(pkg, package):
    """``package``'s nemesis set up, given :data:`CLOCK_OPS` and torn
    down on ``pkg``'s recording remote: its answers and the commands it
    ran, node by node (with their sudo and stdin)."""
    c = PACKAGES[pkg][4]
    test = {"nodes": list(NODES)}
    remote = c.DummyRemote()
    with c.with_session(test, remote):
        nem = package["nemesis"].setup(test)
        answers = [nem.invoke(test, {**op, "type": "info",
                                     "process": "nemesis", "time": i})
                   for i, op in enumerate(CLOCK_OPS)]
        nem.teardown(test)
    cmds = {}
    for node, cmd in remote.log:
        cmds.setdefault(node, []).append((cmd.cmd, cmd.sudo, cmd.stdin))
    return answers, cmds


def test_idle_clock_and_disk_packages_are_the_references():
    for faults in ({"partition"}, set()):
        port = combined.nemesis_package({"db": db.noop(), "faults": faults,
                                         "interval": 1})
        ref = ref_combined.nemesis_package({"db": ref_db.noop(),
                                            "faults": faults,
                                            "interval": 1})
        assert port["nemesis"].fs() == ref["nemesis"].fs()
        assert "reset-clock" in port["nemesis"].fs()
        assert port["perf"] == ref["perf"]
        assert (port["generator"] is None) == (ref["generator"] is None)
    clock = combined.clock_package({"db": db.noop(), "faults": set()})
    ref_clock = ref_combined.clock_package({"db": ref_db.noop(),
                                            "faults": set()})
    assert clock["generator"] is None and clock["final_generator"] is None
    assert clock["perf"] == ref_clock["perf"]
    # idle, its nemesis is the reference's clock nemesis: it builds the
    # clock tools and stops ntp at setup, bumps, strobes and resets as
    # asked and resets at teardown, all on the recording remote
    port, ref = _clock_run("port", clock), _clock_run("ref", ref_clock)
    assert port == ref
    answers, cmds = port
    assert [a["f"] for a in answers] == [o["f"] for o in CLOCK_OPS]
    assert sorted(cmds) == NODES
    ran = [c[0] for c in cmds["n1"]]
    assert "gcc -O2 -o /opt/jepsen/bump-time /opt/jepsen/bump-time.c" in ran
    assert "/opt/jepsen/bump-time 64" in ran
    assert [c[0] for c in cmds["n2"]].count(
        "/opt/jepsen/strobe-time 16 2 3") == 1
    assert combined.disk_package({"faults": ["kill"]}) == \
        dict(combined.NOOP_PACKAGE)
    assert combined.compose_packages([])["perf"] == set()


@pytest.mark.parametrize("fault,module", [("clock", "nemesis/time.py"),
                                          ("disk", "faultfs.py")])
def test_asking_for_an_unported_fault_raises_naming_it(fault, module):
    """Only the disk fault's module (``faultfs.py``) is still to port: it
    raises naming it.  The clock fault's (``nemesis/time.py``) is ported:
    asked for, alone, with the others or by the reference's default
    fault set, it gives the reference's op lists from one seed."""
    if fault == "disk":
        with pytest.raises(NotImplementedError, match=module):
            combined.nemesis_package({"db": db.noop(), "faults": [fault]})
        with pytest.raises(NotImplementedError, match=module):
            localkv.test({"faults": ["partition", fault]})
        return
    assert localkv.test({"faults": ["partition", fault]})["nemesis"].fs() \
        == ref_localkv.test({"faults": ["partition", fault]})["nemesis"].fs()
    test = {"nodes": list(NODES)}
    for build in (lambda cm, o: cm.clock_package(o),
                  lambda cm, o: cm.nemesis_package(o, only_active=True),
                  lambda cm, o: cm.compose_packages(
                      cm.nemesis_packages({"db": o["db"], "interval": 1}))):
        for seed in (45100, 3):
            out = {}
            for pkg in PACKAGES:
                g = PACKAGES[pkg][0]
                p = _pkg(pkg, build, ["kill", fault], interval=1)
                out[pkg] = (
                    _ops(pkg, g.time_limit(30, g.nemesis(p["generator"])),
                         seed, test=test),
                    _ops(pkg, g.nemesis(p["final_generator"]), seed,
                         test=test),
                    sorted(p["nemesis"].fs(), key=str))
            assert out["port"] == out["ref"]
            main, final, _ = out["port"]
            fs = {o["f"] for o in main}
            assert fs >= {"bump-clock", "strobe-clock", "reset-clock"}, fs
            assert {"reset-clock"} <= {o["f"] for o in final}
            bumps = [o["value"] for o in main if o["f"] == "bump-clock"
                     and o["type"] == "invoke"]
            assert any(len(v) > 1 for v in bumps), bumps
