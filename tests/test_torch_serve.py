"""The port's resident checker service (``jepsen_tpu_torch.serve``) against
the JAX package's ``jepsen_tpu.serve``, and the service's own behaviours.

- The wire: request bodies the port builds are byte-equal to the
  reference's for the same models, histories and options; a body the
  reference builds, POSTed to the port's daemon (``device="cpu"``, port
  0), decodes through the reference's protocol to the reference's
  in-process ``wgl.check_batch`` results, field for field (after the
  engine name ``"tpu"`` → ``"gpu"``).
- ``merge_buckets`` merges the same keys, in the same order, with the
  same row tokens as the reference's.
- The behaviours of ``tests/test_serve.py`` in scope: coalescing with
  per-client routing, 503 past the admission bound, drain on shutdown,
  request-id dedup, ``Executor.reset``, the breaker, the client deadline,
  trace stitching, ``/metrics`` against the file dump, WAL replay after a
  restart, a device fault answered as an error (never sent to the
  oracle), and no start without CUDA unless the CPU is asked for.
- Every argument of the daemon that stands in for one of the reference's
  environment variables (row bound, request timeout, journal, drift, WAL
  compaction), the default admission bound against the independent
  lift's concurrency, and the Elle seam's fallback named in its results.

Every wait carries its own timeout, and the ``daemons`` fixture stops
every daemon (and reaps every process) it started, even when a test
fails.  Small sizes, fixed seeds, invalid histories in every corpus.
"""

import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from jepsen_tpu import history as ref_history
from jepsen_tpu import models as ref_models
from jepsen_tpu.engine import planning as ref_planning
from jepsen_tpu.models import locks as ref_locks
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.serve import protocol as ref_protocol
from jepsen_tpu_torch import checker, history, models, obs, synth
from jepsen_tpu_torch.engine import execution, planning
from jepsen_tpu_torch.models import locks
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.serve import (CheckerDaemon, ServiceClient,
                                    ServiceError, protocol)
from jepsen_tpu_torch.serve import client as serve_client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 60


@pytest.fixture(autouse=True)
def _exact_reference_and_one_thread(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    serve_client.reset_breakers()
    yield
    torch.set_num_threads(n)
    serve_client.reset_breakers()


@pytest.fixture
def daemons():
    """``start(**kw)`` → a started CPU daemon on a free port; every daemon
    is stopped at teardown, pass or fail."""
    started = []

    def start(**kw):
        kw.setdefault("device", "cpu")
        d = CheckerDaemon(port=0, **kw)
        started.append(d)
        return d.start(block=False)

    yield start
    for d in started:
        d.stop()


@pytest.fixture
def spawned():
    """Processes started by ``spawn_daemon``: reaped at teardown."""
    clients = []
    yield clients
    for c in clients:
        if c.spawned is not None and c.spawned.poll() is None:
            serve_client._reap(c.spawned, grace_s=5)


def gpu_names(x):
    if isinstance(x, dict):
        return {gpu_names(k): gpu_names(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(gpu_names(v) for v in x)
    return "gpu" if x == "tpu" else x


def sig(r):
    return (r.get("valid?"), r.get("engine"), r.get("failed-event"))


def corpus(seed, n=6, wide=False):
    """cas-register op dicts: short and long histories, invalid ones
    among them, and (``wide``) one history past the slot cap."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        n_procs, n_ops = [(3, 10), (3, 50), (5, 14)][i % 3]
        out.append(synth.generate_history(
            rng, n_procs=n_procs, n_ops=n_ops, crash_p=0.02,
            corrupt=i % 2 == 0).to_dicts())
    if wide:
        out.append(history.History(
            [history.invoke_op(p, "write", 1) for p in range(40)]
        ).index_ops().to_dicts())
    return out


def port_hists(dicts):
    return [history.History.from_dicts(d) for d in dicts]


def ref_hists(dicts):
    return [ref_history.History.from_dicts(d) for d in dicts]


def local(model, dicts, **kw):
    return wgl.check_batch(model, port_hists(dicts), device="cpu", **kw)


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

MODELS = {
    "register": (lambda: models.register(3), lambda: ref_models.register(3)),
    "cas-register": (lambda: models.cas_register(0),
                     lambda: ref_models.cas_register(0)),
    "mutex": (models.mutex, ref_models.mutex),
    "multi-register": (lambda: models.multi_register({0: 0, 1: 5}),
                       lambda: ref_models.multi_register({0: 0, 1: 5})),
    "fifo-queue": (models.fifo_queue, ref_models.fifo_queue),
    "unordered-queue": (lambda: models.UnorderedQueue(frozenset({3, 1})),
                        lambda: ref_models.UnorderedQueue(frozenset({3, 1}))),
    "multi-mutex": (lambda: models.multi_mutex(("b", "a")),
                    lambda: ref_models.multi_mutex(("b", "a"))),
    "owner-mutex": (locks.owner_mutex, ref_locks.owner_mutex),
}

OPTS = [
    {},
    {"slot_cap": 16, "frontier": 64},
    {"escalation": (2, 8), "sufficient_rung": False, "max_dispatch": 4,
     "oracle_fallback": False, "max_closure": 5},
]


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("opts", range(len(OPTS)))
def test_check_request_bytes_equal_the_reference(name, opts):
    ours_model, ref_model = MODELS[name]
    dicts = corpus(11, n=3)
    ctx = {"trace_id": "ab12cd34", "parent_sid": 7}
    for kw in ({}, {"trace_ctx": ctx, "req": "req-1"}):
        ours = protocol.check_request(ours_model(), port_hists(dicts),
                                      OPTS[opts], **kw)
        ref = ref_protocol.check_request(ref_model(), ref_hists(dicts),
                                         OPTS[opts], **kw)
        assert ours == ref
    # and back: the port decodes its own body to the same model and ops
    body = protocol.decode_body(ours)
    assert body == ref_protocol.decode_body(ref)
    assert protocol.model_to_wire(
        protocol.model_from_wire(body["model"])) == body["model"]
    assert [h.to_dicts() for h in protocol.histories_from_wire(
        body["histories"])] == [h.to_dicts() for h in port_hists(dicts)]


def test_unsupported_models_and_opts_raise_as_the_reference_does():
    for ours, ref in ((locks.fenced_mutex(), ref_locks.fenced_mutex()),
                      (models.register(object()), None)):
        with pytest.raises(protocol.UnsupportedModel):
            protocol.check_request(ours, [], {})
        if ref is not None:
            with pytest.raises(ref_protocol.UnsupportedModel):
                ref_protocol.check_request(ref, [], {})
    with pytest.raises(protocol.UnsupportedModel, match="oracle_budget_s"):
        protocol.check_request(models.cas_register(0), [],
                               {"oracle_budget_s": 1.0})


class _Graph:
    def __init__(self, rel, masks, nonadj):
        self.rel, self.masks, self.nonadj = rel, masks, nonadj


def test_elle_and_feed_request_bytes_equal_the_reference():
    rng = np.random.default_rng(5)
    encs = [_Graph(rng.integers(0, 16, (n, n), dtype=np.uint8),
                   (1, 3, 7), ((1, 2), (3, 4))) for n in (3, 5)]
    ctx = {"trace_id": "ff00", "parent_sid": 2}
    assert protocol.elle_request(encs) == ref_protocol.elle_request(encs)
    assert protocol.elle_request(encs, trace_ctx=ctx, req="r") == \
        ref_protocol.elle_request(encs, trace_ctx=ctx, req="r")
    dicts = corpus(12, n=2)
    assert protocol.feed_open_request(models.cas_register(0), {"slot_cap": 8},
                                      ctx, "q") == \
        ref_protocol.feed_open_request(ref_models.cas_register(0),
                                       {"slot_cap": 8}, ctx, "q")
    ops = [dict(d, process=1) for d in dicts[0][:4]]
    assert protocol.feed_append_request("s", 3, port_hists(dicts), ops,
                                        12.5) == \
        ref_protocol.feed_append_request("s", 3, ref_hists(dicts), ops, 12.5)
    assert protocol.feed_close_request("s", 4, "q:close") == \
        ref_protocol.feed_close_request("s", 4, "q:close")


def test_elle_results_cross_the_wire_both_ways():
    from jepsen_tpu.ops import cycles as ref_cycles
    from jepsen_tpu_torch.ops import cycles

    enc = _Graph(np.zeros((4, 4), np.uint8), (3, 1), ((2, 1),))
    res = cycles.ScreenResult({1: np.array([1, 0, 1, 0], bool),
                               3: np.array([0, 1, 0, 0], bool)},
                              {(2, 1): np.array([1, 1, 0, 0], bool)})
    ref_res = ref_cycles.ScreenResult(res.members, res.walks)
    wire = protocol.elle_results_to_wire([res, None])
    assert wire == ref_protocol.elle_results_to_wire([ref_res, None])
    back = protocol.elle_results_from_wire(
        protocol.decode_body(protocol.encode_body(wire)), [enc, enc])
    assert back[1] is None
    for m in res.members:
        assert (back[0].members[m] == res.members[m]).all()
    assert (back[0].walks[(2, 1)] == res.walks[(2, 1)]).all()


# ---------------------------------------------------------------------------
# the planning seam
# ---------------------------------------------------------------------------


def test_merge_buckets_matches_the_reference():
    a, b = corpus(3, n=6), corpus(11, n=6)
    ours_ctx = [planning.RunContext(models.cas_register(0), port_hists(d))
                for d in (a, b)]
    ref_ctx = [ref_planning.RunContext(ref_models.cas_register(0),
                                       ref_hists(d)) for d in (a, b)]
    ours_planner = planning.Planner(
        models.cas_register(0), slot_cap=32, device="cpu",
        max_dispatch=wgl.DEFAULT_MAX_DISPATCH, frontier=wgl.DEFAULT_FRONTIER)
    ref_planner = ref_planning.Planner(
        ref_models.cas_register(0), slot_cap=32,
        frontier=ref_wgl.DEFAULT_FRONTIER, bucketed=True)
    ours, ours_order = planning.merge_buckets(
        ours_planner.encode_buckets(c) for c in ours_ctx)
    ref, ref_order = ref_planning.merge_buckets(
        ref_planner.encode_buckets(c) for c in ref_ctx)
    assert ours_order == ref_order

    def tokens(merged, ctxs, key):
        return [(ctxs.index(c), i) for c, i in merged[key][1]]

    for key in ours_order:
        assert tokens(ours, ours_ctx, key) == tokens(ref, ref_ctx, key)
        assert len(ours[key][0]) == len(ref[key][0])
    # the coalescing the service exists for: a key holds both runs' rows
    assert any({c for c, _ in tokens(ours, ours_ctx, k)} == {0, 1}
               for k in ours_order)


def test_executor_reset_discards_transient_state():
    win = execution.DispatchWindow(4)
    win.submit(0, lambda: (np.array([0]),))
    win.submit(1, lambda: (np.array([1]),))
    assert win.depth == 2 and win.abandon() == 2 and win.depth == 0
    ex = execution.Executor(4, device="cpu")
    ex._pending_escalations.append(("poison",))
    ex._chunks[7] = ("poison",)
    ex._win.submit(0, lambda: (np.array([0]),))
    assert ex.reset() == 1
    assert not ex._pending_escalations and not ex._chunks
    model = models.cas_register(0)
    dicts = corpus(21, n=3)
    ctx = planning.RunContext(model, port_hists(dicts))
    planner = planning.Planner(model, slot_cap=32, device="cpu",
                               max_dispatch=wgl.DEFAULT_MAX_DISPATCH,
                               frontier=wgl.DEFAULT_FRONTIER)
    buckets, order = planner.encode_buckets(ctx)
    for k in order:
        ex.submit(planner.plan_rows(k, *buckets[k]))
    ex.drain()
    ctx.drain_oracles()
    assert ctx.results == local(model, dicts, slot_cap=32)


@pytest.mark.parametrize("window", [1, 4])
def test_reset_recovers_from_a_mid_dispatch_device_fault(window,
                                                          monkeypatch):
    """A fault on the last launch — earlier ones retired (window 1) or in
    flight (window 4) — leaves the executor clean after ``reset`` and the
    same executor gives clean verdicts for the next batch."""
    model = models.cas_register(0)
    dicts = corpus(33, n=6)
    expected = local(model, dicts, slot_cap=32, max_dispatch=2)

    def run_through(ex):
        ctx = planning.RunContext(model, port_hists(dicts))
        planner = planning.Planner(model, slot_cap=32, device="cpu",
                                   max_dispatch=2,
                                   frontier=wgl.DEFAULT_FRONTIER)
        buckets, order = planner.encode_buckets(ctx)
        for k in order:
            ex.submit(planner.plan_rows(k, *buckets[k]))
        ex.drain()
        ctx.drain_oracles()
        return ctx

    real = execution.Executor._launch
    calls = {"n": 0}

    def counting(self, plan, arrays):
        calls["n"] += 1
        return real(self, plan, arrays)

    monkeypatch.setattr(execution.Executor, "_launch", counting)
    assert run_through(execution.Executor(window, device="cpu",
                                          max_dispatch=2)).results \
        == expected
    total, calls["n"] = calls["n"], 0
    assert total >= 2

    def flaky(self, plan, arrays):
        calls["n"] += 1
        if calls["n"] >= total:
            raise RuntimeError("injected device fault")
        return real(self, plan, arrays)

    monkeypatch.setattr(execution.Executor, "_launch", flaky)
    ex = execution.Executor(window, device="cpu", max_dispatch=2)
    with pytest.raises(RuntimeError, match="injected device fault"):
        run_through(ex)
    ex.reset()
    assert ex._win.depth == 0 and not ex._chunks
    assert not ex._pending_escalations
    monkeypatch.setattr(execution.Executor, "_launch", real)
    assert run_through(ex).results == expected


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------


def test_reference_built_check_bodies_get_the_reference_results(daemons):
    """A ``/check`` body the reference builds, answered by the port's
    daemon, decodes through the reference's protocol to the reference's
    in-process results — valid, invalid and oracle-fallback rows, and
    the decomposed multi-register path."""
    d = daemons()
    client = ServiceClient(port=d.port)
    cases = [
        (ref_models.cas_register(0), corpus(41, n=6, wide=True),
         {"slot_cap": 8}),
        (ref_models.multi_register({0: 0, 1: 0}),
         [synth.generate_mr_history(random.Random(42 + i), n_procs=3,
                                    n_ops=30, n_keys=2, n_values=3,
                                    corrupt=i == 1).to_dicts()
          for i in range(3)], {}),
    ]
    for ref_model, dicts, opts in cases:
        body = ref_protocol.check_request(ref_model, ref_hists(dicts), opts,
                                          req=ref_protocol.request_id())
        code, resp = client._resilient_post("/check", body)
        assert code == 200
        got = ref_protocol.decode_body(resp)["results"]
        want = gpu_names(ref_wgl.check_batch(ref_model, ref_hists(dicts),
                                             **opts))
        assert got == want
        assert {r["valid?"] for r in got} == {True, False}
    assert any(r["engine"] == "oracle-fallback" for r in got) is False
    assert d.status()["errors"] == 0


def test_concurrent_clients_coalesce_with_per_client_routing(daemons):
    model = models.cas_register(0)
    a, b = corpus(3, n=6, wide=True), corpus(11, n=6)
    d = daemons(coalesce_wait_s=0.6)
    out = {}
    barrier = threading.Barrier(2)

    def post(tag, dicts):
        c = ServiceClient(port=d.port)
        barrier.wait(timeout=JOIN_S)
        out[tag] = serve_client.check_batch(model, port_hists(dicts),
                                            client=c, slot_cap=32)
        out[tag + "-fallbacks"] = c.fallbacks

    threads = [threading.Thread(target=post, args=("a", a)),
               threading.Thread(target=post, args=("b", b))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert out["a"] == local(model, a, slot_cap=32)
    assert out["b"] == local(model, b, slot_cap=32)
    assert out["a-fallbacks"] == out["b-fallbacks"] == {}
    assert out["a"][-1]["engine"] == "oracle-fallback"
    st = d.status()
    assert st["coalesced"] == 2 and st["coalesced_dispatches"] >= 1
    assert st["dispatch_rows"]["dense"] >= 12
    assert set(st["kernel_launches"]) >= {"dense/register",
                                          "frontier_search", "cycles_screen"}


def test_backpressure_answers_503_past_the_admission_bound(daemons):
    model = models.cas_register(0)
    dicts = corpus(5, n=3)
    d = daemons(max_queue_runs=1, coalesce_wait_s=2.0)
    ok, errs = {}, []
    barrier = threading.Barrier(3)

    def post(tag):
        c = ServiceClient(port=d.port)
        barrier.wait(timeout=JOIN_S)
        try:
            ok[tag] = c.check_batch(model, port_hists(dicts), slot_cap=32)
        except ServiceError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=post, args=(t,)) for t in "abc"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert errs and all("backlogged" in e for e in errs)
    assert ok
    for res in ok.values():
        assert res == local(model, dicts, slot_cap=32)
    assert d.status()["rejected"] >= 1
    # the seam turns a refusal into a counted, tagged in-process run
    d2 = daemons(max_queue_runs=0)
    c = ServiceClient(port=d2.port)
    got = serve_client.check_batch(model, port_hists(dicts), client=c,
                                   slot_cap=32, device="cpu")
    assert c.fallbacks == {"backlogged": 1}
    assert [sig(r) for r in got] == [sig(r) for r in local(model, dicts,
                                                          slot_cap=32)]
    assert {r["service-fallback"] for r in got} == {"backlogged"}


def test_shutdown_drains_the_queue_first(daemons):
    model = models.cas_register(0)
    dicts = corpus(9, n=6)
    d = daemons(coalesce_wait_s=1.0)
    out = {}

    def post():
        out["res"] = ServiceClient(port=d.port).check_batch(
            model, port_hists(dicts), slot_cap=32)

    t = threading.Thread(target=post)
    t.start()
    deadline = time.monotonic() + JOIN_S
    while d.status()["requests"] < 1 and time.monotonic() < deadline:
        time.sleep(0.02)  # admitted: the device thread is gathering
    assert ServiceClient(port=d.port).shutdown()["ok"]
    t.join(timeout=JOIN_S)
    assert out.get("res") == local(model, dicts, slot_cap=32)
    c = ServiceClient(port=d.port)
    while c.healthy(timeout=0.3) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not c.healthy(timeout=0.3)


def test_request_id_dedup_answers_a_retry_from_the_cache(daemons):
    model = models.cas_register(0)
    d = daemons()
    client = ServiceClient(port=d.port)
    body = protocol.check_request(model, port_hists(corpus(29, n=3)),
                                  {"slot_cap": 32}, req="retry-dup-1")
    code1, resp1 = client._resilient_post("/check", body)
    before = d.status()
    code2, resp2 = client._resilient_post("/check", body)
    after = d.status()
    assert code1 == code2 == 200 and resp1 == resp2
    assert after["deduped"] == before["deduped"] + 1
    assert after["requests"] == before["requests"]
    assert after["histories"] == before["histories"]


def test_a_device_fault_is_answered_as_an_error_never_by_the_oracle(
        daemons, monkeypatch):
    from jepsen_tpu_torch.checker import linear

    model = models.cas_register(0)
    dicts = corpus(7, n=3)
    oracle_calls = []
    real_async = linear.analysis_async
    monkeypatch.setattr(linear, "analysis_async", lambda *a, **k: (
        oracle_calls.append(1), real_async(*a, **k))[1])

    def exploding(pb):
        raise RuntimeError("injected device fault")

    obs.enable(reset=True)
    d = daemons()
    client = ServiceClient(port=d.port)
    # the daemon's resident executor only: the seam's in-process run
    # below builds its own
    d._executor.submit = exploding
    with pytest.raises(ServiceError, match="device fault.*injected"):
        client.check_batch(model, port_hists(dicts), slot_cap=32)
    assert oracle_calls == []
    st = d.status()
    assert st["device_faults"] == 1 and st["errors"] == 1
    assert "jepsen_serve_device_faults_total" in client.metrics_text()
    # the seam falls back, counted and tagged as an error
    got = serve_client.check_batch(model, port_hists(dicts), client=client,
                                   slot_cap=32, device="cpu")
    assert client.fallbacks == {"error": 1}
    assert {r["service-fallback"] for r in got} == {"error"}
    # the executor was reset: the daemon serves the next request
    del d._executor.submit
    assert client.check_batch(model, port_hists(dicts), slot_cap=32) == \
        local(model, dicts, slot_cap=32)
    st = d.status()
    assert st["device_faults"] == 2 and st["errors"] == 2
    obs.enable(reset=True)


def test_serve_raises_without_cuda_unless_the_cpu_is_asked_for(
        monkeypatch):
    from jepsen_tpu_torch import platform
    from jepsen_tpu_torch.serve import daemon

    platform.forget_probe()
    monkeypatch.setattr(platform, "probe_accelerator",
                        lambda **kw: (False, "no CUDA device present"))
    with pytest.raises(RuntimeError, match="no usable CUDA device"):
        daemon.serve(port=0, block=False)
    d = daemon.serve(port=0, device="cpu", block=False)
    try:
        assert ServiceClient(port=d.port).status()["platform"] == "cpu"
    finally:
        d.stop()
    platform.forget_probe()


def test_the_command_exits_non_zero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA")
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.serve", "--port", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no usable CUDA device" in out.stderr


def test_the_client_deadline_is_a_hard_bound():
    obs.enable(reset=True)
    client = ServiceClient(port=serve_client.free_port(), deadline_s=1e-9)
    t0 = time.monotonic()
    with pytest.raises(serve_client.ServiceUnavailable,
                       match="deadline budget"):
        client._resilient_post("/check", b"{}")
    assert time.monotonic() - t0 < 5.0
    assert "jepsen_client_deadline_exhausted_total" in obs.render_prom()
    obs.enable(reset=True)


def test_circuit_breaker_state_machine():
    br = serve_client.CircuitBreaker(failures=2, cooldown_s=0.05)
    assert br.state() == "closed" and br.allow()
    assert br.record_failure() is False and br.state() == "closed"
    assert br.record_failure() is True
    assert br.state() == "open" and br.trips == 1
    assert br.allow(lambda: 1 / 0) is False  # no probe while open
    time.sleep(0.06)
    assert br.state() == "half-open"
    assert br.allow(lambda: False) is False
    assert br.state() == "open" and br.probes == 1
    time.sleep(0.06)
    assert br.allow(lambda: True) is True
    assert br.state() == "closed" and br.probes == 2
    assert br.record_failure() is False
    br.record_success()
    assert br.record_failure() is False and br.state() == "closed"


def test_the_breaker_trips_and_the_seam_answers_in_process():
    model = models.cas_register(0)
    dicts = corpus(17, n=3)
    client = ServiceClient(port=serve_client.free_port(), retries=0,
                           breaker_failures=2, breaker_cooldown_s=60)
    body = protocol.check_request(model, port_hists(dicts), {"slot_cap": 32})
    for _ in range(2):
        with pytest.raises(serve_client.ServiceUnavailable):
            client._resilient_post("/check", body)
    assert client.breaker.state() == "open" and client.breaker.trips == 1
    with pytest.raises(serve_client.ServiceUnavailable, match="circuit open"):
        client._resilient_post("/check", body)
    got = serve_client.check_batch(model, port_hists(dicts), client=client,
                                   slot_cap=32, device="cpu")
    assert client.fallbacks == {"unavailable": 1}
    assert [sig(r) for r in got] == [sig(r) for r in local(model, dicts,
                                                          slot_cap=32)]


def test_the_half_open_probe_recovers_against_a_live_daemon(daemons):
    d = daemons()
    client = ServiceClient(port=d.port, retries=0, breaker_failures=1,
                           breaker_cooldown_s=0.2)
    assert client.breaker.record_failure() is True
    body = protocol.check_request(models.cas_register(0),
                                  port_hists(corpus(19, n=3)),
                                  {"slot_cap": 32})
    with pytest.raises(serve_client.ServiceUnavailable, match="circuit open"):
        client._resilient_post("/check", body)
    time.sleep(0.25)
    code, _ = client._resilient_post("/check", body)
    assert code == 200
    assert client.breaker.state() == "closed" and client.breaker.probes == 1


def test_reap_escalates_and_never_raises():
    class Stuck:
        def __init__(self, dies_on_kill):
            self.calls, self.dies = [], dies_on_kill

        def terminate(self):
            self.calls.append("terminate")

        def kill(self):
            self.calls.append("kill")

        def wait(self, timeout=None):
            self.calls.append("wait")
            if "kill" in self.calls and self.dies:
                return 0
            raise subprocess.TimeoutExpired("daemon", timeout)

    for dies in (True, False):
        p = Stuck(dies)
        serve_client._reap(p, grace_s=0.01)
        assert p.calls == ["terminate", "wait", "kill", "wait"]


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def test_trace_ctx_round_trip():
    from jepsen_tpu.obs import propagate as ref_propagate
    from jepsen_tpu_torch.obs import propagate

    ctx = propagate.make_ctx(parent_sid=7)
    assert propagate.parse_ctx(ctx) == ctx == ref_propagate.parse_ctx(ctx)
    for bad in (None, "x", 7, {}, {"trace_id": "UPPER", "parent_sid": 0},
                {"trace_id": "ab", "parent_sid": "zero"},
                {"trace_id": "g" * 8, "parent_sid": 1},
                {"trace_id": "a" * 65, "parent_sid": 1}):
        assert propagate.parse_ctx(bad) is None
        assert ref_propagate.parse_ctx(bad) is None
    body = protocol.decode_body(protocol.check_request(
        models.cas_register(0), [], {}))
    assert "trace_ctx" not in body


def test_a_service_run_exports_one_stitched_trace(daemons):
    from jepsen_tpu_torch.obs import export, propagate

    obs.enable(reset=True)
    d = daemons()
    client = ServiceClient(port=d.port)
    client.check_batch(models.cas_register(0), port_hists(corpus(17, n=3)),
                       slot_cap=32)
    by_role = {}
    for s in obs.tracer().finished():
        role = (s.attrs or {}).get(propagate.ATTR_ROLE)
        if role:
            by_role.setdefault(role, []).append(s)
    assert by_role.get("client") and by_role.get("daemon")
    tid = by_role["client"][0].attrs[propagate.ATTR_TRACE_ID]
    assert any(s.attrs[propagate.ATTR_TRACE_ID] == tid
               for s in by_role["daemon"])
    assert any(int(s.attrs.get("parent_sid", -1)) == by_role["client"][0].sid
               for s in by_role["daemon"])
    code, body = client._request(f"/trace?ctx={tid}")
    dump = protocol.decode_body(body)
    assert code == 200 and dump["spans"]
    assert all(propagate.span_matches(s, tid) for s in dump["spans"])
    # an in-process daemon shares the tracer: adopting its dump is refused
    assert propagate.adopt(dump["spans"], pid=dump["pid"],
                           wall_origin=dump["wall_origin"],
                           origin_ns=dump["origin_ns"]) == 0
    flows = [e for e in export.chrome_trace(obs.tracer())["traceEvents"]
             if e.get("cat") == "trace_ctx" and e.get("id") == tid]
    assert {"s", "f"} <= {e["ph"] for e in flows}
    obs.enable(reset=True)


def test_adopted_remote_spans_merge_as_the_reference_merges_them():
    from jepsen_tpu.obs import export as ref_export
    from jepsen_tpu_torch.obs import export, propagate

    obs.enable(reset=True)
    t = obs.tracer()
    now = time.monotonic_ns()
    remote = {"name": "serve/check", "cat": "serve", "t0": now,
              "t1": now + 5_000_000, "tid": 1, "pid": os.getpid() + 1,
              "sid": 0, "parent": None,
              "attrs": {"trace_id": "ab12", "ctx_role": "daemon"}}
    local_ev = {"name": "client/check", "cat": "serve", "ph": "X",
                "ts": 1.0, "dur": 2.0, "pid": os.getpid(), "tid": 3,
                "args": {"trace_id": "ab12", "ctx_role": "client"}}
    assert propagate.adopt([remote], pid=remote["pid"],
                           wall_origin=t.wall_origin, origin_ns=now) == 1
    rec = propagate.adopted()[0]
    ev = export._remote_event(rec, t.wall_origin)
    assert ev == ref_export._remote_event(rec, t.wall_origin)
    assert abs(ev["dur"] - 5_000.0) < 1.0
    assert export._flow_events([local_ev, ev]) == \
        ref_export._flow_events([local_ev, ev])
    merged = [e for e in export.chrome_trace(t)["traceEvents"]
              if e.get("pid") == remote["pid"]]
    assert merged and merged[0]["name"] == "serve/check"
    obs.enable(reset=True)


def test_metrics_endpoint_matches_the_file_dump(daemons, tmp_path):
    from jepsen_tpu_torch.obs import export

    obs.enable(reset=True)
    d = daemons()
    client = ServiceClient(port=d.port)
    client.check_batch(models.cas_register(0), port_hists(corpus(23, n=3)),
                       slot_cap=32)
    text = client.metrics_text()
    assert export.validate_prometheus_text(text) is None
    assert "jepsen_serve_requests_total 1" in text
    assert "jepsen_serve_queue_wait_seconds" in text
    path = tmp_path / "metrics.prom"
    export.write_prometheus(obs.registry(), str(path))
    assert path.read_text() == obs.render_prom()
    live = client.status()["live"]
    assert live["requests_per_s"] > 0 and live["queue_wait_mean_s"] is not None
    obs.enable(reset=True)


# ---------------------------------------------------------------------------
# restarts, the verdict WAL and the daemon's other arguments
# ---------------------------------------------------------------------------


def test_a_restarted_daemon_replays_the_wal_into_a_retried_request(
        daemons, tmp_path):
    model = models.multi_register({0: 0, 1: 0})
    dicts = [synth.generate_mr_history(random.Random(60 + i), n_procs=3,
                                       n_ops=30, n_keys=2,
                                       corrupt=i == 1).to_dicts()
             for i in range(3)]
    wal = str(tmp_path / "verdict-wal.jsonl")
    body = protocol.check_request(model, port_hists(dicts), {},
                                  req="run-7")
    d1 = daemons(wal_path=wal)
    code, first = ServiceClient(port=d1.port)._resilient_post("/check",
                                                               body)
    assert code == 200
    first = protocol.decode_body(first)
    assert first["diag"]["replayed"] == 0
    d1.stop()
    d2 = daemons(wal_path=wal)
    code, again = ServiceClient(port=d2.port)._resilient_post("/check",
                                                               body)
    again = protocol.decode_body(again)
    assert code == 200 and again["results"] == first["results"]
    assert again["diag"]["replayed"] == again["diag"]["settled"] > 0
    assert d2.status()["replayed"] == again["diag"]["replayed"]
    assert first["results"] == local(model, dicts)


def test_wal_compaction_past_its_threshold_keeps_the_retry_rows(
        daemons, tmp_path):
    from jepsen_tpu_torch.obs import journal as obs_journal

    model = models.cas_register(0)
    wal = str(tmp_path / "verdict-wal.jsonl")
    d = daemons(wal_path=wal, wal_compact_bytes=1)
    client = ServiceClient(port=d.port)
    body = protocol.check_request(model, port_hists(corpus(31, n=3)),
                                  {"slot_cap": 32}, req="kept-1")
    code, _ = client._resilient_post("/check", body)
    assert code == 200
    deadline = time.monotonic() + JOIN_S
    while d.status()["wal_compactions"] < 1 and time.monotonic() < deadline:
        time.sleep(0.1)  # compaction runs on the device thread's idle turn
    assert d.status()["wal_compactions"] >= 1
    rows = obs_journal.read_verdict_rows(wal)
    assert rows and {r["req"] for r in rows} == {"kept-1"}


def test_the_row_bound_answers_503(daemons):
    model = models.cas_register(0)
    d = daemons(max_queue_rows=3)
    client = ServiceClient(port=d.port)
    with pytest.raises(ServiceError, match="backlogged"):
        client.check_batch(model, port_hists(corpus(37, n=6)), slot_cap=32)
    dicts = corpus(37, n=3)
    assert client.check_batch(model, port_hists(dicts), slot_cap=32) == \
        local(model, dicts, slot_cap=32)
    st = d.status()
    assert st["max_queue_rows"] == 3 and st["rejected"] == 1


def test_the_request_timeout_answers_500(daemons):
    d = daemons(request_timeout_s=0.2, coalesce_wait_s=2.0)
    client = ServiceClient(port=d.port)
    t0 = time.monotonic()
    with pytest.raises(ServiceError, match="timed out"):
        client.check_batch(models.cas_register(0),
                           port_hists(corpus(41, n=3)), slot_cap=32)
    assert time.monotonic() - t0 < 2.0


@pytest.mark.parametrize("drift", [True, False])
def test_the_journal_and_drift_arguments(daemons, tmp_path, drift):
    from jepsen_tpu_torch.obs import drift as obs_drift
    from jepsen_tpu_torch.obs import journal as obs_journal

    path = str(tmp_path / "dispatch-journal.jsonl")
    obs_drift.disable()
    try:
        d = daemons(journal_path=path, drift=drift, drift_threshold=0.75)
        client = ServiceClient(port=d.port)
        client.check_batch(models.cas_register(0),
                           port_hists(corpus(43, n=3)), slot_cap=32)
        st = client.status()
        rows = list(obs_journal.read_rows(path, strict=True))
        assert st["journal_path"] == path
        assert rows and st["journal_rows"] == len(rows)
        if drift:
            assert st["drift"]["threshold"] == 0.75
        else:
            assert st["drift"] is None
    finally:
        obs_journal.configure(None)
        obs_drift.disable()


def test_a_spawned_daemon_drains_and_exits_zero(spawned, tmp_path):
    """A real daemon process: it answers, ``POST /shutdown`` drains it,
    and the process exits 0."""
    model = models.cas_register(0)
    dicts = corpus(71, n=6)
    client = serve_client.spawn_daemon(
        device="cpu", wal=str(tmp_path / "wal"), coalesce_wait=0.05,
        wait_s=JOIN_S, log_path=str(tmp_path / "daemon.log"))
    spawned.append(client)
    assert client.check_batch(model, port_hists(dicts), slot_cap=32) == \
        local(model, dicts, slot_cap=32)
    assert client.last_diag["cold_dispatches"] > 0
    st = client.status()
    assert st["platform"] == "cpu" and st["wal_rows"] > 0
    assert client.shutdown()["ok"]
    assert client.spawned.wait(timeout=JOIN_S) == 0


# ---------------------------------------------------------------------------
# the checker seams through the service
# ---------------------------------------------------------------------------


def test_linearizable_service_route_equals_the_device_route(daemons):
    from jepsen_tpu_torch import independent

    d = daemons(coalesce_wait_s=0.05)
    client = ServiceClient(port=d.port)
    model = models.cas_register(0)
    for dicts in corpus(81, n=4, wide=True):
        h = history.History.from_dicts(dicts)
        ours = checker.linearizable(model, algorithm="service",
                                    client=client).check({}, h)
        want = checker.linearizable(model, algorithm="gpu",
                                    device="cpu").check({}, h)
        assert ours == want
    # the independent lift: one request per key, concurrently
    rng = random.Random(82)
    subs = [synth.generate_history(rng, n_procs=3, n_ops=20,
                                   corrupt=k % 3 == 0) for k in range(6)]
    keyed = history.History([
        history.Op(op.type, op.process + 10 * k, op.f,
                   independent.KV(k, op.value), op.time, -1, **op.extra)
        for k, h in enumerate(subs) for op in h]).index_ops()
    test = {"store?": False}
    got = checker.check_safe(independent.checker(checker.linearizable(
        model, algorithm="service", client=client)), test, keyed)
    want = checker.check_safe(independent.checker(checker.linearizable(
        model, algorithm="gpu", device="cpu")), test, keyed)
    assert got == want and got["valid?"] is False
    assert client.fallbacks == {}
    assert d.status()["requests"] >= 4 + len(subs)


def test_elle_workload_checkers_reach_the_elle_endpoint(daemons):
    from jepsen_tpu_torch import elle
    from jepsen_tpu_torch.workloads.cycle import append

    d = daemons()
    client = ServiceClient(port=d.port)
    hs = synth.generate_txn_batch(seed=90, n_histories=4, mode="append",
                                  n_txns=40, key_count=6)
    opts = {"consistency-models": ["strict-serializable"],
            "screen-route": "device"}
    via = elle.check_batch({**opts, "workload": "list-append"}, hs,
                           device="cpu", client=client)
    want = elle.check_batch({**opts, "workload": "list-append"}, hs,
                            device="cpu")
    assert via == want
    st = d.status()
    assert st["elle_requests"] == 1 and st["elle_graphs"] >= 1
    chk = append.checker(opts, device="cpu", client=client)
    assert chk.check({}, hs[0]) == append.checker(opts, device="cpu").check(
        {}, hs[0])
    assert d.status()["elle_requests"] == 2
    assert client.fallbacks == {}


def test_the_default_bound_takes_the_keyed_lift_whole(daemons):
    """The independent lift sends up to ``util.DEFAULT_PMAP_LIMIT``
    requests at once; a daemon at its default admission bound takes
    them all, so none falls back."""
    from jepsen_tpu_torch import independent, util
    from jepsen_tpu_torch.serve import daemon

    assert daemon.DEFAULT_MAX_QUEUE_RUNS >= util.DEFAULT_PMAP_LIMIT
    d = daemons(coalesce_wait_s=0.3)
    client = ServiceClient(port=d.port)
    model = models.cas_register(0)
    rng = random.Random(84)
    subs = [synth.generate_history(rng, n_procs=3, n_ops=10,
                                   corrupt=k % 5 == 0)
            for k in range(util.DEFAULT_PMAP_LIMIT + 4)]
    keyed = history.History([
        history.Op(op.type, op.process + 10 * k, op.f,
                   independent.KV(k, op.value), op.time, -1, **op.extra)
        for k, h in enumerate(subs) for op in h]).index_ops()
    test = {"store?": False}
    got = checker.check_safe(independent.checker(checker.linearizable(
        model, algorithm="service", client=client)), test, keyed)
    want = checker.check_safe(independent.checker(checker.linearizable(
        model, algorithm="gpu", device="cpu")), test, keyed)
    assert got == want
    assert client.fallbacks == {}
    st = d.status()
    assert st["rejected"] == 0 and st["requests"] == len(subs)


def test_elle_results_name_the_fallback(daemons):
    """A refused or unreachable ``/elle`` screens in-process, counted on
    the client and named in every result it produced."""
    from jepsen_tpu_torch import elle
    from jepsen_tpu_torch.workloads.cycle import append, wr

    hs = synth.generate_txn_batch(seed=91, n_histories=3, mode="append",
                                  n_txns=30, key_count=5)
    opts = {"consistency-models": ["strict-serializable"],
            "screen-route": "device"}
    want = elle.check_batch({**opts, "workload": "list-append"}, hs,
                            device="cpu")
    refusing = ServiceClient(port=daemons(max_queue_runs=0).port)
    got = elle.check_batch({**opts, "workload": "list-append"}, hs,
                           device="cpu", client=refusing)
    assert [{k: v for k, v in r.items() if k != "service-fallback"}
            for r in got] == want
    assert {r["service-fallback"] for r in got} == {"backlogged"}
    assert refusing.fallbacks == {"backlogged": 1}
    one = append.checker(opts, device="cpu", client=refusing).check({}, hs[0])
    assert one.pop("service-fallback") == "backlogged"
    assert one == want[0]
    absent = ServiceClient(port=serve_client.free_port(), retries=0)
    rw = synth.generate_txn_batch(seed=92, n_histories=1, mode="wr",
                                  n_txns=30, key_count=5)[0]
    one = wr.checker(opts, device="cpu", client=absent).check({}, rw)
    assert one.pop("service-fallback") == "unavailable"
    assert one == wr.checker(opts, device="cpu").check({}, rw)
    assert absent.fallbacks == {"unavailable": 1}
    # answered by the daemon: no mark
    served = ServiceClient(port=daemons().port)
    got = elle.check_batch({**opts, "workload": "list-append"}, hs,
                           device="cpu", client=served)
    assert got == want and served.fallbacks == {}
