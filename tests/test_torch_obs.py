"""The port's flight recorder (``jepsen_tpu_torch.obs``): the cases of
``tests/test_obs.py`` that touch the ported modules (tracer, metrics,
export, the facade), the engine's hooks against the JAX package's on the
same ``check_batch`` corpus, the seam's spans, and a CPU
``profiling.capture``.

Every test starts from an empty, enabled port registry and tracer and
leaves the port's obs as it found it; the one test that drives the
reference's obs resets it first and restores its enabled state after.
"""

import json
import os
import random
import threading

import pytest
import torch

from jepsen_tpu import history as ref_history
from jepsen_tpu import models as ref_models
from jepsen_tpu import obs as ref_obs
from jepsen_tpu.ops import dense as ref_dense
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu_torch import checker, device, history, independent, models
from jepsen_tpu_torch import obs, synth, util
from jepsen_tpu_torch.obs import export as export_mod
from jepsen_tpu_torch.obs import metrics as metrics_mod
from jepsen_tpu_torch.obs import profiling
from jepsen_tpu_torch.obs.metrics import MetricsRegistry
from jepsen_tpu_torch.obs.tracer import NULL_SPAN, Tracer
from jepsen_tpu_torch.ops import dense, wgl


@pytest.fixture(autouse=True)
def _fresh_obs():
    """An empty, enabled port obs for each test; its enabled state
    restored (and the buffers emptied) after."""
    was = obs.enabled()
    obs.enable(reset=True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    obs.reset()
    if was:
        obs.enable()
    else:
        obs.disable()


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


def test_span_nesting_and_ordering():
    with obs.span("outer", cat="phase") as outer:
        with obs.span("inner", cat="op") as inner:
            assert obs.tracer().current() is inner
        with obs.span("inner2", cat="op"):
            pass
        assert obs.tracer().current() is outer
    spans = obs.tracer().finished()
    by_name = {s.name: s for s in spans}
    assert by_name["inner"].parent == by_name["outer"].sid
    assert by_name["inner2"].parent == by_name["outer"].sid
    assert by_name["outer"].parent is None
    assert by_name["outer"].t0 <= by_name["inner"].t0
    assert by_name["inner"].t1 <= by_name["outer"].t1
    assert [s.name for s in spans] == ["inner", "inner2", "outer"]


def test_span_attrs_and_error_marking():
    with obs.span("a", cat="x", k="v") as sp:
        sp.set("extra", 7)
    assert obs.tracer().finished()[0].attrs == {"k": "v", "extra": "7"}
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("x")
    rec = obs.tracer().finished()[-1]
    assert rec.name == "boom" and rec.attrs["error"] == "ValueError"


def test_spans_nest_per_thread():
    seen = {}

    def worker():
        with obs.span("w", cat="op"):
            seen["parent"] = obs.tracer().current().parent

    with obs.span("main-root"):
        th = threading.Thread(target=worker)
        th.start()
        th.join()
    assert seen["parent"] is None


def test_span_buffer_is_bounded():
    t = Tracer(enabled=True, max_spans=10)
    for i in range(25):
        with t.span(f"s{i}"):
            pass
    assert len(t) == 10
    assert t.dropped == 15


def test_disabled_mode_allocates_nothing():
    obs.disable()
    s1 = obs.span("x", cat="op")
    s2 = obs.span("y", cat="op")
    assert s1 is NULL_SPAN and s2 is NULL_SPAN
    with s1 as sp:
        sp.set("k", "v")
    obs.count("c_total")
    obs.observe("h_seconds", 0.1)
    obs.gauge_set("g", 1)
    obs.gauge_max("g2", 1)
    assert len(obs.tracer()) == 0
    assert obs.registry().snapshot() == []
    assert obs.render_prom() == ""


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def test_histogram_bucketing():
    reg = MetricsRegistry()
    h = reg.histogram("lat_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.01, 0.05, 0.5, 2.0, 3.0):
        h.observe(v)
    assert h.cumulative() == [2, 3, 4, 6]
    assert h.count == 6
    assert h.sum == pytest.approx(5.565)
    text = reg.prometheus_text()
    assert 'lat_seconds_bucket{le="0.01"} 2' in text
    assert 'lat_seconds_bucket{le="+Inf"} 6' in text
    assert "lat_seconds_count 6" in text


def test_counter_gauge_labels_intern():
    reg = MetricsRegistry()
    c1 = reg.counter("x_total", type="ok")
    assert c1 is reg.counter("x_total", type="ok")
    c1.inc(3)
    assert reg.value("x_total", type="ok") == 3
    g = reg.gauge("hw")
    g.set_max(5)
    g.set_max(3)
    assert reg.value("hw") == 5


def test_windowed_counter_and_rate1m(monkeypatch):
    clock = {"t": 1000.0}
    monkeypatch.setattr(metrics_mod, "_now", lambda: clock["t"])
    reg = MetricsRegistry()
    c = reg.counter("jepsen_req_total", route="a")
    c.inc(6)
    assert reg.window_rate("jepsen_req_total") == pytest.approx(6 / 60)
    assert 'jepsen_req_rate1m{route="a"} 0.1' in reg.prometheus_text()
    clock["t"] += 120
    assert c.window_sum() == 0 and reg.value("jepsen_req_total",
                                             route="a") == 6


def test_series_cardinality_cap_is_an_argument():
    assert MetricsRegistry().max_series == metrics_mod.DEFAULT_MAX_SERIES
    reg = MetricsRegistry(max_series=3)
    for i in range(5):
        reg.counter("jepsen_cap_total", k=str(i)).inc()
    fam = [d for d in reg.snapshot() if d["name"] == "jepsen_cap_total"]
    assert len(fam) == 4
    by_labels = {tuple(sorted(d["labels"].items())): d for d in fam}
    assert by_labels[(("overflow", "1"),)]["value"] == 2
    assert reg.value(metrics_mod.SERIES_DROPPED) == 2
    assert export_mod.validate_prometheus_text(reg.prometheus_text()) is None


# ---------------------------------------------------------------------------
# Exports
# ---------------------------------------------------------------------------


def test_export_all_files_pass_the_validators(tmp_path):
    with obs.span("phase-a", cat="phase"):
        with obs.span("op-b", cat="op", f="read"):
            pass
    obs.count("jepsen_engine_rows_total", 4, engine="dense")
    obs.observe("jepsen_oracle_seconds", 0.2)
    paths = obs.export_all(str(tmp_path))
    assert export_mod.validate_chrome_trace(paths["trace"]) is None
    assert export_mod.validate_prometheus(paths["metrics"]) is None
    with open(paths["trace"]) as f:
        doc = json.load(f)
    assert {e["name"] for e in doc["traceEvents"]} == {"phase-a", "op-b"}
    assert doc["otherData"]["producer"] == "jepsen_tpu_torch.obs"
    op = next(e for e in doc["traceEvents"] if e["name"] == "op-b")
    assert op["args"] == {"f": "read"} and op["ph"] == "X"
    rows = [json.loads(line) for line in open(paths["spans"])]
    assert [r["name"] for r in rows] == ["op-b", "phase-a"]
    text = open(paths["metrics"]).read()
    assert 'jepsen_engine_rows_total{engine="dense"} 4' in text
    assert text == obs.render_prom()


def test_validators_reject_malformed(tmp_path):
    bad = tmp_path / "trace.json"
    bad.write_text("{}")
    assert export_mod.validate_chrome_trace(str(bad)) is not None
    bad.write_text('{"traceEvents": [{"name": "x"}]}')
    assert export_mod.validate_chrome_trace(str(bad)) is not None
    prom = tmp_path / "m.prom"
    prom.write_text("")
    assert export_mod.validate_prometheus(str(prom)) is not None
    prom.write_text("a_total{x=\"y\"} not-a-number\n")
    assert export_mod.validate_prometheus(str(prom)) is not None
    prom.write_text("a_total 3\n")
    assert export_mod.validate_prometheus(str(prom)) is None


def test_summary_folds_engines():
    obs.count("jepsen_engine_rows_total", 7, engine="dense")
    obs.count("jepsen_engine_rows_total", 2, engine="frontier-escalated")
    obs.observe("jepsen_kernel_compile_seconds", 1.5, engine="dense")
    obs.observe("jepsen_kernel_execute_seconds", 0.25, engine="dense")
    obs.observe("jepsen_oracle_seconds", 0.5)
    obs.gauge_max("jepsen_engine_inflight_depth", 3)
    with obs.span("generator", cat="phase"):
        pass
    s = obs.summary()
    assert s["engines"]["dense"]["rows"] == 7
    assert s["engines"]["frontier"]["rows"] == 2
    assert s["engines"]["dense"]["compile_s"] == pytest.approx(1.5)
    assert s["engines"]["dense"]["execute_s"] == pytest.approx(0.25)
    assert s["engines"]["oracle"]["execute_s"] == pytest.approx(0.5)
    assert s["engine-inflight-depth"] == 3
    assert [p["name"] for p in s["phases"]] == ["generator"]
    table = obs.format_summary(s)
    assert "generator" in table and "dense" in table


# ---------------------------------------------------------------------------
# The engine's hooks against the reference's
# ---------------------------------------------------------------------------


def _engine_corpus():
    """Dense buckets with invalid rows, a frontier row (60 values) and
    a row past the slot cap (the oracle)."""
    rng = random.Random(4300)
    hs = [synth.generate_history(rng, n_procs=3, n_ops=60, crash_p=0.02,
                                 corrupt=i % 2 == 1) for i in range(5)]
    hs.append(synth.generate_history(rng, n_procs=12, n_ops=48,
                                     crash_p=0.0))
    hs.append(synth.generate_history(rng, n_procs=3, n_ops=200, n_values=60,
                                     crash_p=0.0))
    return [h.to_dicts() for h in hs]


def _metric_rows(snapshot, name):
    return {d["labels"].get("engine"): d["value"] for d in snapshot
            if d["name"] == name}


def test_engine_hooks_match_the_reference(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
    dicts = _engine_corpus()
    ref_was = ref_obs.enabled()
    # fresh checker caches on both sides: a first build and a first
    # dispatch per shape, as in a fresh process
    ref_dense._make_dense_fn_cached.cache_clear()
    ref_wgl._make_check_fn.cache_clear()
    dense._make_dense_fn_cached.cache_clear()
    wgl._checker.cache_clear()
    try:
        ref_obs.enable(reset=True)
        ref = ref_wgl.check_batch(
            ref_models.cas_register(0),
            [ref_history.History.from_dicts(d) for d in dicts], slot_cap=8)
        ref_snap = ref_obs.registry().snapshot()
    finally:
        ref_obs.reset()
        if not ref_was:
            ref_obs.disable()
    ours = wgl.check_batch(models.cas_register(0),
                           [history.History.from_dicts(d) for d in dicts],
                           slot_cap=8, device="cpu")
    snap = obs.registry().snapshot()
    assert {r["engine"] for r in ref} == {"tpu", "oracle-fallback"}
    assert {r.get("kernel") for r in ours} >= {"dense", "frontier"}
    assert {d["name"] for d in snap} == {d["name"] for d in ref_snap}
    rows = _metric_rows(snap, "jepsen_engine_rows_total")
    assert rows == _metric_rows(ref_snap, "jepsen_engine_rows_total")
    assert rows == {"dense": 5, "frontier": 1, "oracle-fallback": 1}
    assert _metric_rows(snap, "jepsen_kernel_dispatches_total") == \
        _metric_rows(ref_snap, "jepsen_kernel_dispatches_total")
    names = [s.name for s in obs.tracer().finished()]
    assert names.count("engine/pipeline") == 1
    assert names.count("engine/dispatch") >= 2
    assert "engine/oracle" in names
    # a second run dispatches the same shapes: "execute", not "compile"
    obs.enable(reset=True)
    wgl.check_batch(models.cas_register(0),
                    [history.History.from_dicts(d) for d in dicts],
                    slot_cap=8, device="cpu")
    phases = {d["labels"]["phase"] for d in obs.registry().snapshot()
              if d["name"] == "jepsen_kernel_dispatches_total"}
    assert phases == {"execute"}


def test_the_seam_nests_its_spans_per_thread(tmp_path):
    rng = random.Random(4310)
    ops = [history.Op("info", "nemesis", "start")]
    for k in range(4):
        for op in synth.generate_history(rng, n_procs=3, n_ops=30,
                                         corrupt=k == 2):
            ops.append(op.copy(value=independent.kv(k, op.value),
                               process=op.process + 3 * k))
    h = history.History(ops).index_ops()
    out = checker.check_safe(checker.compose({
        "linear": independent.batched_linearizable(models.cas_register(0),
                                                   device="cpu"),
        "ok": checker.unbridled_optimism()}), {"store?": False}, h)
    assert "error" not in out["linear"] and out["valid?"] is False
    spans = {s.name: s for s in obs.tracer().finished()}
    assert {"checker/Compose", "checker/BatchedLinearizable",
            "engine/pipeline", "engine/dispatch"} <= set(spans)
    # compose ran the lift on a worker thread: its span roots that
    # thread's stack, and the engine's span nests under it
    lift, pipe = spans["checker/BatchedLinearizable"], \
        spans["engine/pipeline"]
    assert lift.tid != spans["checker/Compose"].tid and lift.parent is None
    assert pipe.parent == lift.sid and pipe.tid == lift.tid
    assert obs.registry().value("jepsen_kernel_dispatches_total",
                                engine="dense", phase="compile") or \
        obs.registry().value("jepsen_kernel_dispatches_total",
                             engine="dense", phase="execute")
    paths = obs.export_all(str(tmp_path / "obs"))
    assert export_mod.validate_chrome_trace(paths["trace"]) is None
    assert export_mod.validate_prometheus(paths["metrics"]) is None


def test_workers_run_on_the_callers_cuda_device(monkeypatch):
    """``carry_current`` makes the caller's current CUDA device current on
    the worker thread (faked here: no card)."""
    entered = []

    class FakeDevice:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append((self.index, threading.get_ident()))

        def __exit__(self, *exc):
            return False

    assert device.carry_current(len) is len  # no CUDA: nothing to carry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    main = threading.get_ident()
    assert util.real_pmap(lambda x: x * 2, [1, 2, 3]) == [2, 4, 6]
    assert util.bounded_pmap(lambda x: x + 1, [1, 2], limit=2) == [2, 3]
    assert len(entered) == 5
    assert {i for i, _ in entered} == {3}
    assert any(t != main for _, t in entered)


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def test_profiling_capture_on_the_cpu(tmp_path):
    out = str(tmp_path / "prof")
    m = profiling.capture(out, label="cpu", device="cpu",
                          work=lambda: torch.ones(64, 64) @ torch.ones(64, 64))
    loaded = profiling.load_manifest(out)
    assert loaded == json.loads(json.dumps(m))
    assert loaded["trace"] == "trace" and loaded["label"] == "cpu"
    assert loaded["idle"] is False and loaded["kernels"] == {}
    assert loaded["memory"] == [{"device": "cpu", "platform": "cpu",
                                 "peak_bytes_in_use": None,
                                 "bytes_in_use": None}]
    assert export_mod.validate_chrome_trace(
        os.path.join(out, "trace", profiling.TRACE_FILE)) is None
    assert obs.registry().value("jepsen_profile_captures_total") == 1
    idle = profiling.capture(str(tmp_path / "idle"), seconds=0.01,
                             device="cpu")
    assert idle["idle"] is True and idle["requested_seconds"] == 0.01
    assert profiling.load_manifest(str(tmp_path / "none")) is None


def test_profiling_records_a_profiler_that_cannot_start(tmp_path,
                                                         monkeypatch):
    def broken(**kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    m = profiling.capture(str(tmp_path), seconds=0.0, device="cpu")
    assert m["trace"] is None and "no profiler here" in m["trace_error"]


def test_profiling_work_errors_propagate_after_the_manifest(tmp_path):
    def work():
        raise KeyError("boom")

    with pytest.raises(KeyError):
        profiling.capture(str(tmp_path), work=work, device="cpu")
    assert profiling.load_manifest(str(tmp_path))["trace"] == "trace"


def test_profiling_without_a_device_raises_where_cuda_is_absent(
        tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiling.capture(str(tmp_path), seconds=0.0)


def test_kernel_seconds_sums_device_kernels_by_name():
    class Ev:
        def __init__(self, name, dev, t0, t1):
            self.name, self.device_type = name, dev
            self.time_range = type("R", (), {"start": t0, "end": t1})()

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    got = profiling.kernel_seconds([
        Ev("register_warp_kernel", cuda, 0, 1500),
        Ev("register_warp_kernel", cuda, 2000, 2500),
        Ev("Memcpy HtoD (Pinned -> Device)", cuda, 0, 100),
        Ev("aten::copy_", cpu, 0, 9000)])
    assert got == {"register_warp_kernel": pytest.approx(0.002)}
