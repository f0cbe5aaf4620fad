"""The port's copy of the reference's utilities (``util.py``), the harness
helpers of ``obs`` and the control plane's dummy session, against the
JAX package's, which import no JAX: equal outputs on the same seeded
inputs."""

import random

import numpy as np
import pytest

from jepsen_tpu import control as ref_control
from jepsen_tpu import history as ref_history
from jepsen_tpu import util as ref_util
from jepsen_tpu_torch import control, core, obs, util
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import history


def _history_dicts(seed):
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for i in range(60):
        p = int(rng.integers(0, 3))
        out.append({"type": "invoke", "process": p, "f": "read",
                    "value": None, "time": t})
        t += int(rng.integers(1, 1000))
        out.append({"type": str(rng.choice(["ok", "fail", "info"])),
                    "process": p, "f": "read", "value": int(i), "time": t})
        if i % 7 == 0:
            f = str(rng.choice(["start", "stop", "start-clock-skew",
                                "stop-clock-skew"]))
            out.append({"type": "info", "process": "nemesis", "f": f,
                        "value": None, "time": t + 1})
        t += int(rng.integers(1, 1000))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_history_helpers_match(seed):
    ds = _history_dicts(seed)
    h = history.History.from_dicts(ds).index_ops()
    rh = ref_history.History.from_dicts(ds).index_ops()
    assert [o.to_dict() for o in util.history_latencies(h)] == \
        [o.to_dict() for o in ref_util.history_latencies(rh)]
    pairs = util.nemesis_intervals(h)
    ref_pairs = ref_util.nemesis_intervals(rh)
    assert [(a.to_dict(), b and b.to_dict()) for a, b in pairs] == \
        [(a.to_dict(), b and b.to_dict()) for a, b in ref_pairs]
    assert [util.log_op(o) for o in h] == [ref_util.log_op(o) for o in rh]


@pytest.mark.parametrize("seed", range(4))
def test_collection_helpers_match(seed):
    rng = random.Random(seed)
    xs = [rng.randrange(40) for _ in range(rng.randrange(0, 30))]
    assert util.integer_interval_set_str(xs) == \
        ref_util.integer_interval_set_str(xs)
    assert util.chunked(xs, 7) == ref_util.chunked(xs, 7)
    assert util.coll_str(xs, limit=5) == ref_util.coll_str(xs, limit=5)
    paths = [[f"/var/log/{rng.choice('ab')}", f"f{i}.log"]
             for i in range(rng.randrange(1, 4))]
    assert util.drop_common_proper_prefix(paths) == \
        ref_util.drop_common_proper_prefix(paths)
    for n in range(8):
        assert (util.majority(n), util.minority(n)) == \
            (ref_util.majority(n), ref_util.minority(n))
    a, b = random.Random(seed), random.Random(seed)
    assert util.random_nonempty_subset(xs or [1], a) == \
        ref_util.random_nonempty_subset(xs or [1], b)
    assert util.fraction(seed, 3) == ref_util.fraction(seed, 3)
    assert util.fraction(1, 0) == 0.0


def test_relative_time_nests_and_refuses_outside():
    with pytest.raises(RuntimeError, match="outside with_relative_time"):
        util.relative_time_nanos()
    with util.with_relative_time():
        t1 = util.relative_time_nanos()
        with util.with_relative_time():
            assert util.relative_time_nanos() <= t1 + 10 ** 9
        assert util.relative_time_nanos() >= t1


def test_timeout_retry_and_named_locks():
    assert util.timeout(1000, lambda: 5) == 5
    assert util.timeout(10, lambda: __import__("time").sleep(0.5),
                        default="late") == "late"
    with pytest.raises(util.TimeoutError_):
        util.timeout(10, lambda: __import__("time").sleep(0.5))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("again")
        return len(calls)

    assert util.retry(0.0, flaky) == 3
    with pytest.raises(ValueError):
        util.retry(0.0, lambda: (_ for _ in ()).throw(ValueError("x")),
                   tries=2)
    locks = util.NamedLocks()
    assert locks.get("a") is locks.get("a")
    with locks.hold("b"):
        assert locks.get("b").locked()


def test_control_escaping_and_dummy_session_match():
    for arg in ["plain", "has space", "it's", "", ["a b", "c"], True,
                control.lit("$HOME")]:
        ref_arg = ref_control.lit(arg.s) if isinstance(
            arg, control.core.Lit) else arg
        assert control.escape(arg) == ref_control.escape(ref_arg)
    test = {"nodes": ["n1", "n2"]}
    with control.dummy_session(test) as sessions:
        out = control.on_nodes(test, lambda t, node: (
            control.execute("echo", node), control.current_node()))
    assert out == {"n1": ("", "n1"), "n2": ("", "n2")}
    log = sessions["n1"].log
    assert [c.cmd for _n, c in log] == ["echo n1", "echo n2"]


def test_run_phases_and_op_counters_reach_obs():
    """``core.run`` records its phases on the run's time axis and counts
    each completion type (``obs.count_op``, ``obs.phase_intervals``)."""
    from jepsen_tpu_torch import client

    result = core.run({
        "name": "phases", "nodes": ["n1"], "concurrency": 2,
        "client": client.noop(), "store?": False,
        "generator": gen.clients(gen.limit(20, gen.repeat({"f": "r"}))),
    })
    names = [name for name, _t0, _t1 in obs.phase_intervals()]
    assert names == ["setup", "generator", "teardown", "analyze"]
    assert all(t0 <= t1 for _n, t0, t1 in obs.phase_intervals())
    assert result["obs-summary"]["ops"] == {"ok": 20}
    obs.disable()
    assert obs.phase_intervals() == []
    obs.enable(reset=True)
