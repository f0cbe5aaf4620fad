"""Online checking on the port's daemon (``POST /feed``, ``GET /watch``)
against the JAX package.

A feed session is a schedule for the verdicts one batch check of the same
histories gives, never a different checker: however the work is cut into
deltas (whole histories, raw op events, or both), whatever the dispatch
window or the decomposition switch, and however many daemon lives the
session spans (duplicate appends, a SIGKILL and the WAL's replay), the
close results equal the JAX package's ``jepsen_tpu.ops.wgl.check_batch``
on the same histories, as canonical JSON (after the engine name ``"tpu"``
→ ``"gpu"``).  The reference's own client and live shipper, pointed at
the port's daemon, get the reference's verdicts.  ``/watch`` numbers its
events as ``WalTail`` numbers the WAL's rows.

Every daemon runs with ``device="cpu"`` on a free port and is stopped by
a fixture, pass or fail; every wait is bounded.
"""

import json
import os
import random
import signal
import threading
import time

import pytest
import torch

from jepsen_tpu import history as ref_history
from jepsen_tpu import models as ref_models
from jepsen_tpu.obs import journal as ref_journal
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.serve import client as ref_client
from jepsen_tpu.serve import protocol as ref_protocol
from jepsen_tpu_torch import models, obs, synth
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.obs import journal
from jepsen_tpu_torch.serve import (CheckerDaemon, ServiceClient,
                                    ServiceError, protocol)
from jepsen_tpu_torch.serve import client as serve_client

JOIN_S = 60

#: the two kernel routes (the explicit closure cap forces the frontier)
ROUTES = {
    "dense": dict(slot_cap=32, max_dispatch=4),
    "frontier": dict(slot_cap=32, max_dispatch=4, max_closure=9),
}


@pytest.fixture(autouse=True)
def _exact_reference_and_one_thread(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    serve_client.reset_breakers()
    ref_client.reset_breakers()
    yield
    torch.set_num_threads(n)
    serve_client.reset_breakers()
    ref_client.reset_breakers()


@pytest.fixture
def daemons():
    """``start(**kw)`` → a started CPU daemon on a free port; every daemon
    is stopped at teardown."""
    started = []

    def start(**kw):
        kw.setdefault("device", "cpu")
        d = CheckerDaemon(port=0, **kw)
        started.append(d)
        return d.start(block=False)

    yield start
    for d in started:
        d.stop()


def gpu_names(x):
    if isinstance(x, dict):
        return {gpu_names(k): gpu_names(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(gpu_names(v) for v in x)
    return "gpu" if x == "tpu" else x


def canon(results) -> str:
    return json.dumps(protocol.sanitize_results(gpu_names(results)),
                      sort_keys=True)


def ref_check(ref_model, hs, **kw):
    """The JAX package's batch check of port histories."""
    return ref_wgl.check_batch(
        ref_model, [ref_history.History.from_dicts(h.to_dicts())
                    for h in hs], **kw)


def cas_corpus(seed=45100, n=6):
    """Mixed-length cas-register histories, every other one corrupted."""
    rng = random.Random(seed)
    return [synth.generate_history(rng, n_procs=3 + i % 3,
                                   n_ops=12 + 8 * (i % 4), crash_p=0.02,
                                   corrupt=i % 2 == 0)
            for i in range(n)]


def soup_chunks(rng, items):
    """``items`` cut into contiguous chunks of 1-5."""
    out, i = [], 0
    while i < len(items):
        k = rng.randint(1, 5)
        out.append(items[i:i + k])
        i += k
    return out


def feed_all(client, model, kw, batch, seed=0, req=None):
    """One session sending ``batch`` in soup chunks; returns (results,
    replayed rows summed over the appends)."""
    rng = random.Random(seed)
    session = client.open_feed(model, kw, req=req)
    replayed = 0
    for chunk in soup_chunks(rng, batch):
        replayed += session.append(histories=chunk,
                                   t_inv=time.time()).get("replayed", 0)
    return session.close(), replayed


# ---------------------------------------------------------------------------
# a session's results equal the reference's batch check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("window", [1, 4])
def test_feed_equals_the_reference_across_routes_and_windows(
        daemons, route, window):
    kw = ROUTES[route]
    batch = cas_corpus(seed=100 + window)
    expected = ref_check(ref_models.cas_register(0), batch, **kw)
    d = daemons(window=window)
    results, _ = feed_all(ServiceClient(port=d.port), models.cas_register(0),
                          kw, batch, seed=17 * window)
    assert canon(results) == canon(expected)
    assert any(r["valid?"] is False for r in results)
    assert d.status()["feed_deltas"] > 1


@pytest.mark.parametrize("decomposed", [True, False])
def test_feed_equals_the_reference_with_decomposition_on_and_off(
        daemons, monkeypatch, decomposed):
    # the reference's switch is its environment; the port's an argument
    monkeypatch.setenv("JEPSEN_TPU_ENGINE_DECOMPOSE", str(int(decomposed)))
    rng = random.Random(45100)
    keys = {k: 0 for k in range(8)}
    batch = [synth.generate_mr_history(rng, n_procs=4, n_ops=36, n_keys=8,
                                       n_values=4, crash_p=0.02,
                                       corrupt=i % 3 == 0)
             for i in range(5)]
    kw = dict(slot_cap=32, max_dispatch=4)
    expected = ref_check(ref_models.multi_register(keys), batch, **kw)
    d = daemons(decomposed=decomposed)
    results, _ = feed_all(ServiceClient(port=d.port),
                          models.multi_register(keys), kw, batch, seed=3)
    assert canon(results) == canon(expected)
    assert any(r["valid?"] is False for r in results)
    assert ("partitions" in results[0]) is decomposed


@pytest.mark.parametrize("seed", [1, 2])
def test_op_events_in_random_chunks_equal_the_reference(daemons, seed):
    rng = random.Random(seed)
    h = synth.generate_history(rng, n_procs=4, n_ops=24, crash_p=0.02,
                               corrupt=True)
    kw = ROUTES["dense"]
    d = daemons()
    session = ServiceClient(port=d.port).open_feed(models.cas_register(0),
                                                   kw)
    chunks = soup_chunks(rng, h.to_dicts())
    for chunk in chunks:
        session.append(ops=chunk, t_inv=time.time())
    results = session.close()
    assert canon(results) == canon(ref_check(ref_models.cas_register(0),
                                             [h], **kw))
    assert session.last_diag["ops"] == len(h)
    assert session.last_diag["deltas"] == len(chunks)


def test_a_session_mixing_histories_and_ops_equals_the_reference(daemons):
    rng = random.Random(7)
    hists = cas_corpus(seed=7, n=3)
    streamed = synth.generate_history(rng, n_procs=3, n_ops=20,
                                      corrupt=True)
    kw = ROUTES["dense"]
    d = daemons()
    session = ServiceClient(port=d.port).open_feed(models.cas_register(0),
                                                   kw)
    op_chunks = soup_chunks(rng, streamed.to_dicts())
    for i, h in enumerate(hists):
        session.append(histories=[h], ops=op_chunks[i], t_inv=time.time())
    for chunk in op_chunks[len(hists):]:
        session.append(ops=chunk)
    results = session.close()
    ref_model = ref_models.cas_register(0)
    assert canon(results) == canon(ref_check(ref_model, hists, **kw)
                                   + ref_check(ref_model, [streamed], **kw))


# ---------------------------------------------------------------------------
# retries and sessions on the wire
# ---------------------------------------------------------------------------


def test_a_duplicate_seq_is_acknowledged_without_being_ingested(daemons):
    model = models.cas_register(0)
    batch = cas_corpus(seed=21, n=4)
    kw = ROUTES["dense"]
    d = daemons()
    client = ServiceClient(port=d.port)
    session = client.open_feed(model, kw)
    session.append(histories=[batch[0]])
    code, resp = client._resilient_post("/feed", protocol.feed_append_request(
        session.sid, 0, histories=[batch[0]]))
    payload = protocol.decode_body(resp)
    assert code == 200
    assert payload["duplicate"] is True and payload["accepted"] == 0
    for h in batch[1:]:
        session.append(histories=[h])
    results = session.close()
    assert canon(results) == canon(ref_check(ref_models.cas_register(0),
                                             batch, **kw))
    assert d.status()["feed_histories"] == len(batch)


def test_reopening_the_same_session_id_is_idempotent(daemons):
    model = models.cas_register(0)
    d = daemons()
    client = ServiceClient(port=d.port)
    first = client.open_feed(model, ROUTES["dense"])
    assert first.resumed is False
    again = client.open_feed(model, ROUTES["dense"], req=first.req)
    assert again.sid == first.sid and again.resumed is True
    assert d.status()["feed_open"] == 1
    first.append(histories=cas_corpus(seed=5, n=2))
    assert len(first.close()) == 2
    st = d.status()
    assert st["feed_open"] == 0 and st["feed_sessions"] == 1


def test_an_unknown_session_is_a_404(daemons):
    d = daemons()
    client = ServiceClient(port=d.port)
    for body in (protocol.feed_append_request("no-such-session", 0),
                 protocol.feed_close_request("no-such-session", 0)):
        code, resp = client._resilient_post("/feed", body)
        assert code == 404
        assert "unknown feed session" in json.loads(resp)["error"]
    code, _ = client._resilient_post("/feed", protocol.encode_body(
        {"op": "rewind"}))
    assert code == 400


def _keyed_corpus(seed, n):
    rng = random.Random(seed)
    return [synth.generate_mr_history(rng, n_procs=3, n_ops=24, n_keys=3,
                                      n_values=3, corrupt=i % 2 == 0)
            for i in range(n)]


#: (port model, reference model, corpus): whole histories, and histories
#: the daemon splits per key (its rollback must drop the sub-histories)
FAULT_CASES = {
    "cas-register": (lambda: models.cas_register(0),
                     lambda: ref_models.cas_register(0),
                     lambda seed, n: cas_corpus(seed=seed, n=n)),
    "multi-register": (lambda: models.multi_register({0: 0, 1: 0, 2: 0}),
                       lambda: ref_models.multi_register({0: 0, 1: 0, 2: 0}),
                       _keyed_corpus),
}


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_a_device_fault_fails_the_delta_and_its_retry_dispatches_again(
        daemons, case):
    """The fault is answered as an error naming it and counted; the
    session stays open with nothing of the delta committed, so the retry
    of the same seq (ops included) dispatches again and the close equals
    the reference."""
    model, ref_model, make = FAULT_CASES[case]
    hists = make(11, 3)
    streamed = make(12, 1)[0]
    kw = ROUTES["dense"]
    d = daemons()
    client = ServiceClient(port=d.port)
    session = client.open_feed(model(), kw)
    ops = streamed.to_dicts()
    session.append(histories=hists[:1], ops=ops[:10])

    def exploding(pb):
        raise RuntimeError("injected device fault")

    d._executor.submit = exploding
    with pytest.raises(ServiceError, match="device fault.*injected"):
        session.append(histories=hists[1:], ops=ops[10:])
    assert session.seq == 1
    st = d.status()
    assert st["device_faults"] == 1 and st["feed_open"] == 1
    del d._executor.submit
    session.append(histories=hists[1:], ops=ops[10:])
    results = session.close()
    assert canon(results) == canon(ref_check(ref_model(), hists, **kw)
                                   + ref_check(ref_model(), [streamed],
                                               **kw))
    assert session.last_diag["ops"] == len(ops)


def test_the_row_bound_counts_the_delta_and_a_refused_delta_commits_nothing(
        daemons):
    kw = ROUTES["dense"]
    batch = cas_corpus(seed=23, n=6)
    d = daemons(max_queue_rows=3)
    session = ServiceClient(port=d.port).open_feed(models.cas_register(0),
                                                   kw)
    # the session grows past the bound three rows at a time
    session.append(histories=batch[:3])
    session.append(histories=batch[3:])
    streamed = cas_corpus(seed=24, n=1)[0].to_dicts()
    with pytest.raises(ServiceError, match="backlogged"):
        session.append(histories=batch[:3], ops=streamed[:8])
    assert session.seq == 2
    session.append(ops=streamed)
    results = session.close()
    ref_model = ref_models.cas_register(0)
    want = ref_check(ref_model, batch, **kw) + ref_check(
        ref_model, [History.from_dicts(streamed)], **kw)
    assert canon(results) == canon(want)
    assert session.last_diag["ops"] == len(streamed)
    assert d.status()["rejected"] == 1


def test_status_and_metrics_carry_the_feed_and_watch_counters(daemons,
                                                              tmp_path):
    obs.enable(reset=True)
    d = daemons(wal_path=str(tmp_path / "wal.jsonl"))
    client = ServiceClient(port=d.port)
    session = client.open_feed(models.cas_register(0), ROUTES["dense"])
    for h in cas_corpus(seed=31, n=3):
        session.append(histories=[h], t_inv=time.time() - 1.0)
    st = d.status()
    assert st["feed_open"] == 1 and st["feed_deltas"] == 3
    assert st["live"]["feed_lag_mean_s"] >= 1.0
    assert st["live"]["feed_deltas_per_s"] > 0
    rows = list(client.watch(timeout=1.0))
    session.close()
    assert len(rows) == 3 == d.status()["watch_events"]
    text = client.metrics_text()
    for name in ("jepsen_feed_sessions_total", "jepsen_feed_open_sessions",
                 "jepsen_feed_deltas_total", "jepsen_feed_histories_total",
                 "jepsen_feed_ingest_lag_seconds", "jepsen_watch_subscribers",
                 "jepsen_watch_events_total",
                 "jepsen_watch_replay_rows_total"):
        assert name in text, name
    spans = {r.name for r in obs.tracer().finished()}
    assert {"serve/feed", "serve/feed-plan"} <= spans
    obs.enable(reset=True)


# ---------------------------------------------------------------------------
# resuming across daemon lives
# ---------------------------------------------------------------------------


def test_a_session_resumes_across_daemon_lives_from_the_wal(daemons,
                                                            tmp_path):
    model = models.cas_register(0)
    batch = cas_corpus(seed=33)
    kw = ROUTES["dense"]
    wal = str(tmp_path / "wal.jsonl")
    sid = "feed-resume-1"
    d1 = daemons(wal_path=wal)
    session = ServiceClient(port=d1.port).open_feed(model, kw, req=sid)
    for h in batch[:3]:
        session.append(histories=[h], t_inv=time.time())
    d1.stop()  # the session dies open; the WAL survives
    d2 = daemons(wal_path=wal)
    results, replayed = feed_all(ServiceClient(port=d2.port), model, kw,
                                 batch, seed=9, req=sid)
    assert replayed >= 3
    assert canon(results) == canon(ref_check(ref_models.cas_register(0),
                                             batch, **kw))
    assert d2.status()["replayed"] >= 3


def test_a_killed_daemon_process_resumes_the_feed_with_equal_results(
        tmp_path):
    """A real daemon process, SIGKILLed mid-feed with its WAL's last line
    torn, then restarted on the same port and WAL: the resumed session
    replays what the first life settled and closes equal to the
    reference."""
    model = models.cas_register(0)
    batch = cas_corpus(seed=77)
    kw = ROUTES["dense"]
    wal = str(tmp_path / "verdict-wal.jsonl")
    sid = "feed-kill9-1"
    port = serve_client.free_port()
    procs = []
    try:
        client = serve_client.spawn_daemon(
            port, device="cpu", wal=wal, wait_s=JOIN_S,
            log_path=str(tmp_path / "a.log"))
        procs.append(client.spawned)
        session = client.open_feed(model, kw, req=sid)
        for h in batch[:3]:
            session.append(histories=[h], t_inv=time.time())
        os.kill(client.spawned.pid, signal.SIGKILL)
        assert client.spawned.wait(timeout=JOIN_S) == -signal.SIGKILL
        with open(wal, "a") as f:
            f.write('{"v": 1, "ts": 1.0, "req": "torn')  # a kill mid-append
        serve_client.reset_breakers()
        client2 = serve_client.spawn_daemon(
            port, device="cpu", wal=wal, wait_s=JOIN_S,
            log_path=str(tmp_path / "b.log"))
        procs.append(client2.spawned)
        results, replayed = feed_all(client2, model, kw, batch, seed=11,
                                     req=sid)
        assert replayed >= 3
        assert canon(results) == canon(ref_check(ref_models.cas_register(0),
                                                 batch, **kw))
        assert client2.shutdown()["ok"]
        assert client2.spawned.wait(timeout=JOIN_S) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                serve_client._reap(p, grace_s=5)


# ---------------------------------------------------------------------------
# the /watch channel
# ---------------------------------------------------------------------------


def _watch_into(client, out, last_id=-1):
    t = threading.Thread(target=lambda: out.extend(
        client.watch(last_id=last_id, timeout=JOIN_S)), daemon=True)
    t.start()
    return t


def test_watch_offsets_equal_the_wal_tails_and_resume_without_duplicates(
        daemons, tmp_path):
    wal = str(tmp_path / "wal.jsonl")
    d = daemons(wal_path=wal)
    client = ServiceClient(port=d.port)
    client.check_batch(models.cas_register(0), cas_corpus(seed=41, n=4),
                       slot_cap=32)
    seen = []
    t = _watch_into(client, seen)
    session = client.open_feed(models.cas_register(0), ROUTES["dense"])
    session.append(histories=cas_corpus(seed=42, n=3))
    deadline = time.monotonic() + JOIN_S
    while len(seen) < 7 and time.monotonic() < deadline:
        time.sleep(0.05)
    # a second subscriber resumes after the fifth row
    resumed = []
    t2 = _watch_into(client, resumed, last_id=seen[4][0])
    session.append(histories=cas_corpus(seed=43, n=2))
    session.close()
    deadline = time.monotonic() + JOIN_S
    while (len(seen) < 9 or len(resumed) < 4) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert d.status()["watch_subscribers"] == 2
    d.stop()  # the channel ends with the daemon
    t.join(JOIN_S)
    t2.join(JOIN_S)
    assert not t.is_alive() and not t2.is_alive()
    want = ref_journal.WalTail(wal).poll()
    assert [(off, row) for off, row in seen] == want
    assert journal.WalTail(wal).poll() == want
    assert resumed == want[5:]


def test_watch_without_a_wal_is_a_404(daemons):
    d = daemons()
    with pytest.raises(ServiceError, match="404"):
        list(ServiceClient(port=d.port).watch(timeout=5))


# ---------------------------------------------------------------------------
# the reference's client and live shipper against the port's daemon
# ---------------------------------------------------------------------------


def test_the_reference_client_feeds_and_watches_the_port_daemon(daemons,
                                                                tmp_path):
    ref_model = ref_models.cas_register(0)
    batch = [ref_history.History.from_dicts(h.to_dicts())
             for h in cas_corpus(seed=51)]
    kw = ROUTES["dense"]
    wal = str(tmp_path / "wal.jsonl")
    d = daemons(wal_path=wal)
    client = ref_client.ServiceClient(port=d.port)
    seen = []
    t = threading.Thread(target=lambda: seen.extend(
        client.watch(timeout=JOIN_S)), daemon=True)
    t.start()
    session = client.open_feed(ref_model, kw)
    for h in batch:
        session.append(histories=[h], t_inv=time.time())
    results = session.close()
    assert canon(results) == canon(ref_wgl.check_batch(ref_model, batch,
                                                       **kw))
    deadline = time.monotonic() + JOIN_S
    while len(seen) < len(batch) and time.monotonic() < deadline:
        time.sleep(0.05)
    d.stop()
    t.join(JOIN_S)
    assert seen == ref_journal.WalTail(wal).poll()
    assert [row["result"]["valid?"] for _off, row in seen] == \
        [r["valid?"] for r in results]


def test_the_reference_live_shipper_closes_with_the_reference_verdict(
        daemons, monkeypatch):
    from jepsen_tpu import interpreter

    rng = random.Random(3)
    h = synth.generate_history(rng, n_procs=3, n_ops=16, crash_p=0.0,
                               corrupt=True)
    ref_model = ref_models.cas_register(0)
    d = daemons()
    monkeypatch.setenv("JEPSEN_TPU_SERVE_PORT", str(d.port))
    shipper = interpreter._LiveShipper(ref_model)
    shipper.offer({"process": "nemesis", "type": "info", "f": "start",
                   "value": None})
    for op in h.to_dicts():
        shipper.offer(op)
    shipper.close(wait_s=JOIN_S)
    assert shipper.final_results is not None
    assert canon(shipper.final_results[-1:]) == canon(
        ref_check(ref_model, [h]))
    assert shipper.final_results[-1]["valid?"] is False
    assert d.status()["feed_sessions"] == 1


def test_feed_bodies_of_the_reference_protocol_get_the_reference_results(
        daemons):
    """Bodies built by the reference's protocol, POSTed by hand."""
    ref_model = ref_models.cas_register(0)
    batch = [ref_history.History.from_dicts(h.to_dicts())
             for h in cas_corpus(seed=61, n=4)]
    d = daemons()
    client = ServiceClient(port=d.port)
    code, resp = client._resilient_post("/feed", ref_protocol.
                                        feed_open_request(ref_model, {},
                                                          req="ref-1"))
    assert code == 200 and json.loads(resp)["session"] == "ref-1"
    for seq, h in enumerate(batch):
        code, _ = client._resilient_post("/feed", ref_protocol.
                                         feed_append_request("ref-1", seq,
                                                             [h]))
        assert code == 200
    code, resp = client._resilient_post("/feed", ref_protocol.
                                        feed_close_request("ref-1",
                                                           len(batch)))
    assert code == 200
    assert canon(ref_protocol.decode_body(resp)["results"]) == canon(
        ref_wgl.check_batch(ref_model, batch))
