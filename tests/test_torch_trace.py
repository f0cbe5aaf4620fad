"""The port's span tracing (``trace.py``) against the JAX package's, which
imports no JAX: the same calls give byte-equal span JSONL, and ``cli test
--tracing FILE`` spans every client call of a run.

Span ids come from ``random`` and times from ``time.time``: each package's
run seeds the one and replaces the other with a counter, so the two files
are equal byte for byte.  Every test turns the global tracer off again.
"""

import json
import random
import time

import pytest

from jepsen_tpu import fake as ref_fake
from jepsen_tpu import independent as ref_ind
from jepsen_tpu import trace as ref_trace
from jepsen_tpu_torch import cli
from jepsen_tpu_torch import fake as port_fake
from jepsen_tpu_torch import independent as port_ind
from jepsen_tpu_torch import trace as port_trace

PACKAGES = {"ref": (ref_trace, ref_fake, ref_ind),
            "port": (port_trace, port_fake, port_ind)}


@pytest.fixture(autouse=True)
def _tracers_off():
    yield
    ref_trace.tracing()
    port_trace.tracing()


def _drive(package, path, monkeypatch):
    """One scripted session: nested spans, annotations, attributes and a
    traced client's calls, with seeded ids and a counting clock."""
    trace, fake, ind = PACKAGES[package]
    clock = iter(range(10 ** 6))
    monkeypatch.setattr(time, "time", lambda: float(next(clock)))
    random.seed(45100)
    cfg = trace.tracing(str(path))
    assert cfg["config"] is True and cfg["endpoint"] == str(path)
    outside = trace.context()
    with trace.with_trace("outer") as outer:
        trace.attribute("node", "n1")
        trace.attribute(3, [1, 2])
        inside = trace.context()
        with trace.with_trace("inner"):
            trace.annotate("halfway")
            trace.annotate({"k": 1})
    client = trace.Traced(fake.KeyedAtomClient())
    test = {"nodes": ["n1"]}
    c = client.open(test, "n1")
    c.setup(test)
    ops = [{"type": "invoke", "process": 0, "f": "write",
            "value": ind.kv(4, 2)},
           {"type": "invoke", "process": 0, "f": "read",
            "value": ind.kv(4, None)},
           {"type": "invoke", "process": 0, "f": "cas",
            "value": ind.kv(4, [2, 3])}]
    for op in ops:
        c.invoke(test, op)
    c.teardown(test)
    c.close(test)
    reusable = c.reusable(test)
    trace.tracing()
    with trace.with_trace("untraced") as none:
        pass
    return (outside, inside == {"span-id": outer.span_id,
                                "trace-id": outer.trace_id},
            none, reusable, path.read_bytes())


def test_spans_jsonl_equals_the_reference(tmp_path, monkeypatch):
    ref = _drive("ref", tmp_path / "ref.jsonl", monkeypatch)
    port = _drive("port", tmp_path / "port.jsonl", monkeypatch)
    assert port == ref
    outside, inside_matches, none, _reusable, raw = port
    assert outside == {"span-id": "0" * 16, "trace-id": "0" * 32}
    assert inside_matches and none is None
    spans = [json.loads(line) for line in raw.splitlines()]
    names = [s["name"] for s in spans]
    assert names == ["inner", "outer", "client.open", "client.setup",
                     "client.invoke", "client.invoke", "client.invoke",
                     "client.teardown", "client.close"]
    inner, outer = spans[0], spans[1]
    assert inner["parent-id"] == outer["span-id"]
    assert inner["trace-id"] == outer["trace-id"]
    assert outer["attributes"] == {"node": "n1", "3": "[1, 2]"}
    assert [a["message"] for a in inner["annotations"]] == [
        "halfway", "{'k': 1}"]
    assert [s["attributes"] for s in spans[4:7]] == [
        {"f": "write", "key": "4"}, {"f": "read", "key": "4"},
        {"f": "cas", "key": "4"}]


@pytest.mark.parametrize("value, tagged", [
    ([4, 2], True),                        # an independent [k v] pair
    ([["r", 1, None], ["w", 1, 2]], False),  # a two-mop transaction
    ({"from": 1, "to": 2}, False),
    (7, False),
])
def test_traced_tags_keys_only_of_independent_pairs(tmp_path, monkeypatch,
                                                    value, tagged):
    got = {}
    for package, (trace, _fake, _ind) in PACKAGES.items():
        spans = []
        trace.tracing(exporter=spans.append)

        class Echo:
            def invoke(self, test, op):
                return {**op, "type": "ok"}

        trace.Traced(Echo()).invoke({}, {"f": "x", "value": value})
        got[package] = [s.attributes for s in spans]
        trace.tracing()
    assert got["port"] == got["ref"]
    assert ("key" in got["port"][0]) is tagged


def test_wire_leaves_an_untraced_test_alone():
    client = port_fake.KeyedAtomClient()
    test = {"client": client}
    assert port_trace.wire(test, None) is test and test["client"] is client
    assert "tracing" not in test
    port_trace.wire(test, "spans.jsonl")
    assert test["tracing"] == "spans.jsonl"
    assert isinstance(test["client"], port_trace.Traced)


def test_cli_test_tracing_spans_every_client_call(tmp_path):
    spans_path = tmp_path / "spans.jsonl"
    base = tmp_path / "store"
    rc = cli.run_cli(cli.default_commands(), [
        "test", "--workload", "bank", "--dummy", "--device", "cpu",
        "--time-limit", "1", "--store-base", str(base),
        "--tracing", str(spans_path),
    ])
    assert rc == cli.EXIT_VALID
    assert not port_trace._tracer.sample  # off again after the run
    spans = [json.loads(line) for line in open(spans_path)]
    history = [json.loads(line) for line in
               open(next(base.glob("bank/2*/history.jsonl")))]
    invokes = [op for op in history
               if op["type"] == "invoke" and isinstance(op["process"], int)]
    by_name = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(s)
    assert len(by_name["client.invoke"]) == len(invokes) > 0
    assert sorted(s["attributes"]["f"] for s in by_name["client.invoke"]) \
        == sorted(op["f"] for op in invokes)
    # five nodes: core.run opens, sets up, tears down and closes one client
    # a node; the interpreter opens and closes one more a worker
    others = {n: len(v) for n, v in by_name.items() if n != "client.invoke"}
    assert others == {"client.open": 10, "client.setup": 5,
                      "client.teardown": 5, "client.close": 10}
    for s in spans:
        assert s["end"] >= s["start"] and s["parent-id"] is None
