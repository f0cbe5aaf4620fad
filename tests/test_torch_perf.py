"""The port's perf checker (``jepsen_tpu_torch.checker.perf_checker``:
``checker/perf.py`` over ``checker/svg.py``) against the JAX package's
(which does not import JAX): on one stored history — the localkv
suite's generator through the simulator, with latencies, failures,
crashes and partition and kill windows, written as JSON and read back by
each package — the latency and rate SVGs are byte-equal, fault windows
and the run-phase overlay included.
"""

import json
import os
import random

import pytest

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import history as ref_history
from jepsen_tpu import obs as ref_obs
from jepsen_tpu.checker import perf as ref_perf
from jepsen_tpu_torch import checker, history, obs
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import perf
from jepsen_tpu_torch.generator import sim
from jepsen_tpu_torch.suites import localkv

SVGS = ("latency-raw.svg", "latency-quantiles.svg", "rate.svg")
PHASES = [("db-start", -2.5, 0.1), ("generator", 0.1, 9.9),
          ("analyze", 10.5, 11.0)]


def stored_history(tmp_path, seed=5, faults=("partition", "kill")):
    """The localkv test map and its simulated history, stored as JSON
    lines; completions take 1–40 ms and are ok, fail or info."""
    t = localkv.test({"nodes": ["n1", "n2", "n3", "n4", "n5"],
                      "faults": list(faults), "interval": 2,
                      "time-limit": 10, "concurrency": 6, "rate": 40})
    rng = random.Random(seed)

    def complete(ctx, inv):
        if inv["process"] == "nemesis":
            return {**inv, "type": "info",
                    "time": inv["time"] + sim.PERFECT_LATENCY}
        typ = rng.choice(["ok", "ok", "ok", "fail", "info"])
        return {**inv, "type": typ,
                "time": inv["time"] + rng.randint(10 ** 6, 4 * 10 ** 7)}

    random.seed(seed)
    gen.set_seed(seed)
    ops = sim.simulate(t["generator"], complete,
                       ctx=sim.n_plus_nemesis_context(6), seed=seed)
    path = tmp_path / "history.jsonl"
    with open(path, "w") as f:
        for o in sorted(ops, key=lambda o: o["time"]):
            f.write(json.dumps(o) + "\n")
    return t, path


def _load(pkg_history, path):
    with open(path) as f:
        return pkg_history.History.from_dicts(
            [json.loads(line) for line in f]).index_ops()


@pytest.mark.parametrize("phases", [[], PHASES], ids=["no-phases", "phases"])
@pytest.mark.parametrize("faults", [("partition", "kill"), ("kill",)])
def test_perf_svgs_equal_the_reference(tmp_path, monkeypatch, phases,
                                       faults):
    t, path = stored_history(tmp_path, faults=faults)
    monkeypatch.setattr(obs, "phase_intervals", lambda: list(phases))
    monkeypatch.setattr(ref_obs, "phase_intervals", lambda: list(phases))
    out = {}
    for name, chk, hist in (
            ("port", checker.perf_checker(), _load(history, path)),
            ("ref", ref_checker.perf_checker(), _load(ref_history, path))):
        test = {"name": "localkv", "start-time": "20260101T000000.000",
                "store-base": str(tmp_path / name), "plot": t["plot"]}
        assert chk.check(test, hist, {})["valid?"] is True
        d = os.path.join(str(tmp_path / name), "localkv",
                         "20260101T000000.000")
        out[name] = {f: open(os.path.join(d, f), "rb").read() for f in SVGS}
    assert out["port"] == out["ref"]
    # the db package's perf spec names both of its faults
    kinds = {s["name"] for s in t["plot"]["nemeses"]}
    assert kinds == set(faults) | {"pause"}
    rate = out["port"]["rate.svg"].decode()
    # the fault windows are shaded in their package's colours
    assert "#E9A4A0" in rate  # kill
    if "partition" in faults:
        assert "#E9DCA0" in rate
    assert ("generator" in rate) == bool(phases)


def test_perf_functions_equal_the_reference(tmp_path):
    t, path = stored_history(tmp_path, seed=9)
    h, rh = _load(history, path), _load(ref_history, path)
    test = {"name": "x", "plot": t["plot"]}
    assert [vars(r) for r in perf.nemesis_regions(test, h)] == \
        [vars(r) for r in ref_perf.nemesis_regions(test, rh)]
    # the reference's default spec when the test has none
    assert [vars(r) for r in perf.nemesis_regions({}, h)] == \
        [vars(r) for r in ref_perf.nemesis_regions({}, rh)]
    pts = [(i * 0.37, (i * 7919) % 97 + 0.5) for i in range(200)]
    assert perf.latencies_to_quantiles(2.0, perf.QUANTILES, pts) == \
        ref_perf.latencies_to_quantiles(2.0, ref_perf.QUANTILES, pts)
    assert perf.latencies_to_quantiles(1.0, (0.5,), []) == {0.5: []}


def test_no_store_writes_nothing(tmp_path):
    t, path = stored_history(tmp_path)
    test = {"name": "x", "start-time": "t", "store-base": str(tmp_path / "s"),
            "store?": False, "plot": t["plot"]}
    assert checker.perf_checker().check(test, _load(history, path),
                                        {})["valid?"] is True
    assert not (tmp_path / "s").exists()
