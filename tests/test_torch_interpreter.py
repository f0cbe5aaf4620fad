"""The port's interpreter and ``core`` against the behaviours of
``tests/test_interpreter.py``: the real event loop against the port's
in-memory fakes (reference: jepsen/test/jepsen/core_test.clj:62-249 and
interpreter_test.clj).  Threaded runs are not reproducible, so each is
held by invariants and, where it has a verdict, by the JAX package's
checker on the same history."""

import pytest

from jepsen_tpu_torch import client as client_mod
from jepsen_tpu_torch import core
from jepsen_tpu_torch import fake
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import interpreter
from jepsen_tpu_torch import nemesis as nemesis_mod
from jepsen_tpu_torch.history import NEMESIS
from jepsen_tpu_torch.util import with_relative_time


def base_test(**kw):
    t = {
        "name": "itest",
        "nodes": ["n1", "n2", "n3"],
        "concurrency": 3,
        "client": client_mod.noop(),
        "nemesis": nemesis_mod.noop(),
        "generator": None,
    }
    t.update(kw)
    return t


def run_interp(test):
    with with_relative_time():
        return interpreter.run(test)


def test_empty_generator():
    h = run_interp(base_test(generator=None))
    assert list(h) == []


def test_basic_ops_complete():
    test = base_test(
        generator=gen.clients(gen.limit(10, gen.repeat({"f": "read"})))
    )
    h = run_interp(test)
    invokes = [op for op in h if op.type == "invoke"]
    oks = [op for op in h if op.type == "ok"]
    assert len(invokes) == 10
    assert len(oks) == 10
    # times are monotone nondecreasing
    times = [op.time for op in h]
    assert times == sorted(times)
    # indices assigned
    assert [op.index for op in h] == list(range(len(h)))


def test_basic_cas_history_shape():
    """1000 ops through the real interpreter against the atom client.
    (reference: core_test.clj:62-120 basic-cas-test)"""
    state = fake.AtomState(0)

    def rand_op(test, ctx):
        import random as r

        f = r.choice(["read", "write", "cas"])
        if f == "read":
            return {"f": "read", "value": None}
        if f == "write":
            return {"f": "write", "value": r.randrange(5)}
        return {"f": "cas", "value": (r.randrange(5), r.randrange(5))}

    test = base_test(
        client=fake.AtomClient(state, latency=0.0),
        generator=gen.clients(gen.limit(1000, rand_op)),
    )
    h = run_interp(test)
    invokes = [op for op in h if op.type == "invoke"]
    assert len(invokes) == 1000
    completions = [op for op in h if op.type != "invoke"]
    assert len(completions) == 1000
    # every invoke is eventually matched by a completion from its process
    pair = h.pair_index()
    unpaired = [i for i, op in enumerate(h) if op.type == "invoke" and pair[i] < 0]
    assert unpaired == []
    # the resulting history is linearizable w.r.t. a cas register, by the
    # port's oracle and by the reference's on the same ops
    from jepsen_tpu import history as ref_history
    from jepsen_tpu import models as ref_m
    from jepsen_tpu.checker import linear as ref_linear
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.checker import linear

    out = linear.analysis(m.cas_register(0), h, pure_fs=("read",))
    assert out["valid?"] is True
    ref_h = ref_history.History.from_dicts(h.to_dicts())
    assert ref_linear.analysis(ref_m.cas_register(0), ref_h,
                               pure_fs=("read",))["valid?"] is True


def test_client_crash_becomes_info_and_process_retires():
    """(reference: core_test.clj:179-198 crash recovery;
    interpreter.clj:142-157,233-236)"""
    state = fake.AtomState(0)
    test = base_test(
        concurrency=2,
        client=fake.CrashingClient(state, latency=0.0),
        generator=gen.clients(gen.limit(20, gen.repeat({"f": "read"}))),
    )
    h = run_interp(test)
    infos = [op for op in h if op.type == "info" and isinstance(op.process, int)]
    assert infos, "expected at least one crashed op"
    for op in infos:
        assert op.extra["error"].startswith("indeterminate:")
    # crashed process ids are never reused for new invocations
    seen_after_crash = set()
    crashed = set()
    for op in h:
        if op.type == "info" and isinstance(op.process, int):
            crashed.add(op.process)
        elif op.type == "invoke":
            assert op.process not in crashed, "crashed process reused!"
            seen_after_crash.add(op.process)
    # new process ids appeared (retirement produced fresh ids)
    assert max(seen_after_crash) >= test["concurrency"]


def test_nemesis_ops_route_to_nemesis():
    class RecordingNemesis(nemesis_mod.Nemesis):
        def __init__(self):
            self.ops = []

        def invoke(self, test, op):
            self.ops.append(op)
            return {**op, "type": "info", "value": "done"}

    nem = RecordingNemesis()
    test = base_test(
        nemesis=nem,
        generator=gen.nemesis(gen.limit(3, gen.repeat({"f": "break"}))),
    )
    h = run_interp(test)
    assert len(nem.ops) == 3
    assert all(op.process == NEMESIS for op in h)


def test_generator_exception_propagates():
    """(reference: core_test.clj:200-222)"""

    class Boom(gen.Generator):
        def op(self, test, ctx):
            raise ValueError("gen boom")

    with pytest.raises(RuntimeError, match="ValueError"):
        run_interp(base_test(generator=Boom()))


def test_sleep_and_log_not_in_history():
    test = base_test(
        generator=gen.clients(
            [gen.log("hello"), gen.sleep(0.001), gen.once({"f": "read"})]
        )
    )
    h = run_interp(test)
    assert all(op.f == "read" for op in h)


def test_client_open_failure_becomes_fail_op():
    class BadOpenClient(client_mod.Client):
        def open(self, test, node):
            raise RuntimeError("cannot connect")

        def invoke(self, test, op):
            raise AssertionError("never reached")

    test = base_test(
        client=BadOpenClient(),
        generator=gen.clients(gen.limit(2, gen.repeat({"f": "read"}))),
    )
    h = run_interp(test)
    fails = [op for op in h if op.type == "fail"]
    assert len(fails) == 2
    assert fails[0].extra["error"][0] == "no-client"


def test_run_case_tears_down_on_partial_open_failure():
    """If one node's client open fails, nemesis teardown still runs and
    already-opened clients are closed.  (reference: core.clj:183-212)"""
    events = []

    class PartialClient(client_mod.Client):
        def open(self, test, node):
            if node == "n3":
                raise RuntimeError("n3 refused connection")
            events.append(("open", node))
            c = PartialClient()
            c.node = node
            return c

        def close(self, test):
            events.append(("close", self.node))

        def invoke(self, test, op):
            return {**op, "type": "ok"}

    class TrackedNemesis(nemesis_mod.Nemesis):
        def setup(self, test):
            events.append(("nemesis-setup", None))
            return self

        def invoke(self, test, op):
            return {**op, "type": "info"}

        def teardown(self, test):
            events.append(("nemesis-teardown", None))

    test = core.prepare_test(
        base_test(
            client=PartialClient(),
            nemesis=TrackedNemesis(),
            generator=None,
        )
    )
    with pytest.raises(RuntimeError, match="n3 refused"):
        with with_relative_time():
            core.run_case(test)
    assert ("nemesis-teardown", None) in events
    opened = {n for e, n in events if e == "open"}
    closed = {n for e, n in events if e == "close"}
    assert opened == closed  # every opened client was closed


def test_crashing_client_honors_crash_every():
    state = fake.AtomState(0)
    c = fake.CrashingClient(state, crash_every=2)
    assert c.crash_every == 2
    assert c.open({}, "n1").crash_every == 2


def test_core_run_full_lifecycle():
    """core.run end to end with checker.
    (reference: core.clj:327 run! + analyze!)"""
    from jepsen_tpu_torch import checker as checker_mod
    from jepsen_tpu_torch import models as m

    state = fake.AtomState(0)
    meta_log = []
    test = {
        "name": "lifecycle",
        "nodes": ["n1", "n2"],
        "concurrency": 2,
        "client": fake.AtomClient(state, meta_log=meta_log, latency=0.0),
        "generator": gen.clients(
            gen.limit(
                20,
                gen.mix(
                    [
                        gen.repeat({"f": "read"}),
                        gen.repeat({"f": "write", "value": 3}),
                    ]
                ),
            )
        ),
        "checker": checker_mod.compose(
            {
                "stats": checker_mod.stats(),
                "linear": checker_mod.linearizable(
                    m.cas_register(0), algorithm="oracle", device="cpu"
                ),
            }
        ),
    }
    result = core.run({**test, "store?": False})
    assert result["results"]["valid?"] is True
    assert result["results"]["stats"]["count"] == 20
    # client lifecycle hooks ran per node: open+setup during setup phase,
    # plus interpreter re-opens per process; teardown+close at the end
    assert meta_log.count("setup") == 2
    assert meta_log.count("teardown") == 2
