"""The port's O(n) checkers (``checker/__init__.py``) and its timeline
renderer against the JAX package's, which import no JAX: the same seeded
histories through both give equal results."""

import numpy as np
import pytest

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import history as ref_history
from jepsen_tpu import models as ref_models
from jepsen_tpu.checker import timeline as ref_timeline
from jepsen_tpu_torch import checker as port_checker
from jepsen_tpu_torch import history as port_history
from jepsen_tpu_torch import models as port_models
from jepsen_tpu_torch.checker import timeline as port_timeline


def _ops(rng, n, fs, value, types=("ok", "fail", "info"),
         p=(0.7, 0.2, 0.1), processes=4):
    """n invoke/complete pairs over `processes` processes, completions in
    a shuffled but per-process ordered interleaving."""
    out, t = [], 0
    pending = {}
    for _ in range(n):
        free = [q for q in range(processes) if q not in pending]
        if not free or (pending and rng.random() < 0.5):
            q = int(rng.choice(sorted(pending)))
            inv = pending.pop(q)
            ty = str(rng.choice(types, p=p))
            comp = {**inv, "type": ty, "time": t}
            if inv["f"] in ("read", "dequeue", "generate") and ty == "ok":
                comp["value"] = value(rng, inv["f"], "ok")
            if ty == "info" and rng.random() < 0.5:
                comp["exception"] = "Traceback ..."
                comp["exception_class"] = str(rng.choice(["Boom", "Bust"]))
            out.append(comp)
        else:
            q = int(rng.choice(free))
            f = str(rng.choice(fs))
            inv = {"type": "invoke", "process": q, "f": f,
                   "value": value(rng, f, "invoke"), "time": t}
            pending[q] = inv
            out.append(inv)
        t += int(rng.integers(1, 5_000_000))
    for q, inv in sorted(pending.items()):
        out.append({**inv, "type": "ok", "time": t,
                    "value": value(rng, inv["f"], "ok")
                    if inv["f"] in ("read", "dequeue", "generate")
                    else inv["value"]})
        t += 1
    return out


def _register_value(rng, f, phase):
    if f == "read":
        return None if phase == "invoke" else int(rng.integers(0, 5))
    if f == "cas":
        return [int(rng.integers(0, 5)), int(rng.integers(0, 5))]
    return int(rng.integers(0, 5))


def _set_value(rng, f, phase):
    if f == "add":
        return int(rng.integers(0, 40))
    if phase == "invoke":
        return None
    k = int(rng.integers(0, 20))
    return sorted(int(x) for x in rng.integers(0, 42, size=k))


def _queue_value(rng, f, phase):
    if f == "enqueue":
        return int(rng.integers(0, 30))
    if f == "drain":
        return None if phase == "invoke" else [
            int(x) for x in rng.integers(0, 30, size=int(rng.integers(0, 4)))]
    return None if phase == "invoke" else int(rng.integers(0, 30))


def _id_value(rng, f, phase):
    return None if phase == "invoke" else int(rng.integers(0, 60))


def _counter_value(rng, f, phase):
    if f == "add":
        return int(rng.integers(0, 4))
    return None if phase == "invoke" else int(rng.integers(0, 30))


def _histories(ds):
    return (ref_history.History.from_dicts(ds).index_ops(),
            port_history.History.from_dicts(ds).index_ops())


#: name → (checker builder(checker module, models module), dicts(rng))
CASES = {
    "unhandled-exceptions": (
        lambda c, m: c.unhandled_exceptions(),
        lambda rng: _ops(rng, 200, ["read", "write", "cas"],
                         _register_value)),
    "stats": (
        lambda c, m: c.stats(),
        lambda rng: _ops(rng, 200, ["read", "write", "cas"],
                         _register_value)
        + [{"type": "info", "process": "nemesis", "f": "start",
            "value": None, "time": 10 ** 12}]),
    "stats-never-ok": (
        lambda c, m: c.stats(),
        lambda rng: _ops(rng, 60, ["read", "write"], _register_value,
                         types=("fail", "info"), p=(0.5, 0.5))),
    "queue-unordered": (
        lambda c, m: c.queue(m.unordered_queue()),
        lambda rng: _ops(rng, 200, ["enqueue", "dequeue"], _queue_value)),
    "queue-fifo": (
        lambda c, m: c.queue(m.fifo_queue()),
        lambda rng: _ops(rng, 80, ["enqueue", "enqueue", "dequeue"],
                         _queue_value, processes=1)),
    "set": (
        lambda c, m: c.set_checker(),
        lambda rng: _ops(rng, 200, ["add", "add", "add", "read"],
                         _set_value)),
    "set-never-read": (
        lambda c, m: c.set_checker(),
        lambda rng: _ops(rng, 50, ["add"], _set_value)),
    "set-full": (
        lambda c, m: c.set_full(),
        lambda rng: _ops(rng, 300, ["add", "add", "read"], _set_value)),
    "set-full-linearizable": (
        lambda c, m: c.set_full(linearizable=True),
        lambda rng: _ops(rng, 300, ["add", "add", "read"], _set_value)),
    "total-queue": (
        lambda c, m: c.total_queue(),
        lambda rng: _ops(rng, 300, ["enqueue", "enqueue", "dequeue",
                                    "drain"], _queue_value,
                         types=("ok", "fail"), p=(0.8, 0.2))),
    "unique-ids": (
        lambda c, m: c.unique_ids(),
        lambda rng: _ops(rng, 200, ["generate"], _id_value)),
    "counter": (
        lambda c, m: c.counter(),
        lambda rng: _ops(rng, 300, ["add", "add", "read"], _counter_value,
                         types=("ok", "fail"), p=(0.9, 0.1))),
}


def _result(package, case, ds):
    c, m = ((ref_checker, ref_models) if package == "ref"
            else (port_checker, port_models))
    h = _histories(ds)[0 if package == "ref" else 1]
    chk = CASES[case][0](c, m)
    return c.check_safe(chk, {}, h, {})


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_checker_equals_the_reference(case, seed):
    ds = CASES[case][1](np.random.default_rng(seed))
    ref = _result("ref", case, ds)
    port = _result("port", case, ds)
    assert port == ref


def test_the_corpora_reach_both_verdicts():
    """The parity above covers valid and invalid results of the checkers
    whose verdict the data decides."""
    for case in ("set", "set-full", "total-queue", "unique-ids", "counter",
                 "queue-unordered"):
        verdicts = {_result("port", case, CASES[case][1](
            np.random.default_rng(s)))["valid?"] for s in range(6)}
        assert False in verdicts, case


def test_expand_queue_drain_ops_matches():
    ds = _ops(np.random.default_rng(3), 200,
              ["enqueue", "dequeue", "drain"], _queue_value,
              types=("ok", "fail"), p=(0.8, 0.2))
    ref_h, port_h = _histories(ds)
    assert (port_checker.expand_queue_drain_ops(port_h).to_dicts()
            == ref_checker.expand_queue_drain_ops(ref_h).to_dicts())


def test_timeline_html_matches(tmp_path):
    ds = _ops(np.random.default_rng(4), 120, ["read", "write", "cas"],
              _register_value)
    ref_h, port_h = _histories(ds)
    pages = []
    for chk, h, name in ((ref_timeline.html(), ref_h, "ref"),
                         (port_timeline.html(), port_h, "port")):
        test = {"name": "tl", "start-time": "t0",
                "store-base": str(tmp_path / name)}
        assert chk.check(test, h, {"subdirectory": ["k"]})["valid?"] is True
        with open(tmp_path / name / "tl" / "t0" / "k" / "timeline.html") as f:
            pages.append(f.read())
    assert pages[0] == pages[1]
    assert pages[1].count('class="op ') > 50
