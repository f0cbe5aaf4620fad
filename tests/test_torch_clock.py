"""The port's clock plot (``checker/clock.py``, ``checker.clock_plot``) and
``checker.log_file_pattern`` against the JAX package's, which imports no
JAX: the same history gives the same ``clock-skew.svg`` bytes, and the
same node logs the same matches."""

import os

import numpy as np
import pytest

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import history as ref_history
from jepsen_tpu.checker import clock as ref_clock
from jepsen_tpu_torch import checker as port_checker
from jepsen_tpu_torch import history as port_history
from jepsen_tpu_torch.checker import clock as port_clock

PACKAGES = {"ref": (ref_checker, ref_clock, ref_history),
            "port": (port_checker, port_clock, port_history)}

NODES = ["n1.db.example.com", "n2.db.example.com", "n3.db.example.com"]


def _dicts(seed, nodes=NODES):
    """Client ops, a clock nemesis bumping and resetting offsets (ops that
    carry ``clock-offsets``), and a partition interval to shade."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for i in range(120):
        t += int(rng.integers(10 ** 6, 10 ** 8))
        if i % 15 == 3:
            out.append({"type": "info", "process": "nemesis", "f": "bump",
                        "value": None, "time": t,
                        "clock-offsets": {
                            n: float(rng.normal(0, 2)) for n in nodes
                            if rng.random() < 0.8}})
            continue
        if i == 40 or i == 80:
            f = "start-partition" if i == 40 else "stop-partition"
            out.append({"type": "info", "process": "nemesis", "f": f,
                        "value": None, "time": t})
            continue
        p = int(rng.integers(0, 3))
        out.append({"type": "invoke", "process": p, "f": "read",
                    "value": None, "time": t})
        out.append({"type": "ok", "process": p, "f": "read",
                    "value": int(rng.integers(0, 5)), "time": t + 1000})
    return out


def _test(base, name="clock"):
    return {"name": name, "start-time": "20261018T000000.000",
            "store-base": str(base), "nodes": NODES}


@pytest.mark.parametrize("seed", [0, 1])
def test_clock_plot_writes_the_references_svg(tmp_path, seed):
    ds = _dicts(seed)
    out = {}
    for package, (checker, clock, history) in PACKAGES.items():
        test = _test(tmp_path / package)
        h = history.History.from_dicts(ds).index_ops()
        assert clock.history_to_datasets(h) == \
            ref_clock.history_to_datasets(ref_history.History.from_dicts(
                ds).index_ops())
        res = checker.clock_plot().check(test, h, {})
        assert res == {"valid?": True}
        path = os.path.join(str(tmp_path / package), "clock",
                            test["start-time"], "clock-skew.svg")
        out[package] = open(path, "rb").read()
    assert out["port"] == out["ref"] and b"<svg" in out["port"]
    # the short names: the common domain suffix is gone
    assert b"n1.db.example.com" not in out["port"] and b">n1<" in out["port"]


@pytest.mark.parametrize("nodes", [
    [], ["a"], ["n1.x", "n2.x"], ["a.b.c", "d.b.c", "e.f.c"],
    ["same.x", "same.x"], ["n1", "n2.x"],
])
def test_short_node_names_equal_the_reference(nodes):
    assert port_clock.short_node_names(nodes) == \
        ref_clock.short_node_names(nodes)


def test_no_offsets_and_no_store_write_nothing(tmp_path):
    ds = [d for d in _dicts(0) if "clock-offsets" not in d]
    for package, (checker, _clock, history) in PACKAGES.items():
        test = _test(tmp_path / package)
        h = history.History.from_dicts(ds).index_ops()
        assert checker.clock_plot().check(test, h, {}) == {"valid?": True}
        assert checker.clock_plot().check(
            {**test, "store?": False},
            history.History.from_dicts(_dicts(0)).index_ops(), {}) == \
            {"valid?": True}
    assert not list(tmp_path.rglob("*.svg"))


def test_log_file_pattern_equals_the_reference(tmp_path):
    results = {}
    for package, (checker, _clock, history) in PACKAGES.items():
        test = _test(tmp_path / package, name="logs")
        for i, node in enumerate(NODES[:2]):
            d = os.path.join(str(tmp_path / package), "logs",
                             test["start-time"], node)
            os.makedirs(d)
            with open(os.path.join(d, "db.log"), "w") as f:
                f.write("start\n")
                f.write("".join(f"line {j}\n" for j in range(20)))
                if i == 1:
                    f.write("panic: assertion failed: x > 0\n")
                    f.write("PANIC again\n")
                    f.write("\udcff bad byte\n".encode(
                        "utf-8", "surrogateescape").decode("latin-1"))
        h = history.History()
        results[package] = [
            checker.log_file_pattern(p, "db.log").check(test, h, {})
            for p in (r"panic", r"(?i)panic", r"nothing here", r"^line 1\d$")
        ]
    assert results["port"] == results["ref"]
    counts = [r["count"] for r in results["port"]]
    assert counts == [1, 2, 0, 20]
    assert [r["valid?"] for r in results["port"]] == [False, False, True,
                                                      False]
