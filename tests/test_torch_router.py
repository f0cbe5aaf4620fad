"""The port's fleet tier (``jepsen_tpu_torch.serve.router`` and the
supervisor in ``serve.daemon``) against the JAX package's.

- The routing functions equal the reference's on seeded random members,
  keys, weights and wire bodies: a request routed by either package's
  router lands on the same member.
- The forwarding behaviours of ``tests/test_router.py``, on scripted sends
  and on the port's CPU daemons: the winner, a reroute past a dead member,
  a tripped breaker skipped without a connection, member answers passed
  on unchanged, 503 when every member is dead, members marked down tried
  last, a retry through a reroute staying idempotent, pinned feed
  sessions, ``/status`` and ``/healthz``, and the fleet table.
- The supervisor restarts a CPU daemon killed with SIGKILL on the same
  port and WAL, returns 0 after ``/shutdown`` and the child's exit code
  once its restart budget is spent; ``--supervise --fleet 2`` runs two
  members on their own ports and WALs; ``--fleet`` alone exits non-zero.

Every daemon, router and process is stopped by a fixture or a ``finally``.
"""

import os
import random
import signal
import subprocess
import socket
import sys
import time

import pytest
import torch

from jepsen_tpu.serve import protocol as ref_protocol
from jepsen_tpu.serve import router as ref_router
from jepsen_tpu_torch import models, synth
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.serve import (CheckerDaemon, Router, ServiceClient,
                                    protocol)
from jepsen_tpu_torch.serve import client as serve_client
from jepsen_tpu_torch.serve import daemon as daemon_mod
from jepsen_tpu_torch.serve import router as router_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 60


@pytest.fixture(autouse=True)
def _fresh_breakers():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    serve_client.reset_breakers()
    yield
    torch.set_num_threads(n)
    serve_client.reset_breakers()


@pytest.fixture
def fleet():
    """``daemon(**kw)`` starts a CPU daemon, ``router(members, **kw)`` a
    router; all are stopped at teardown."""
    daemons, routers = [], []

    class Fleet:
        @staticmethod
        def daemon(**kw):
            kw.setdefault("device", "cpu")
            d = CheckerDaemon(port=0, **kw)
            daemons.append(d)
            return d.start(block=False)

        @staticmethod
        def router(members, **kw):
            kw.setdefault("probe_interval_s", 600.0)
            rt = Router(members, port=0, **kw)
            routers.append(rt)
            return rt.start(block=False)

    yield Fleet
    for rt in routers:
        rt.stop()
    for d in daemons:
        d.stop()


def _addr(d) -> str:
    return f"127.0.0.1:{d.port}"


def _keys(n, seed):
    rng = random.Random(seed)
    return [f"key-{rng.getrandbits(48):012x}" for _ in range(n)]


def _corpus(seed=991, n=4):
    rng = random.Random(seed)
    return [synth.generate_history(rng, n_procs=3, n_ops=10, crash_p=0.02,
                                   corrupt=i == 0) for i in range(n)]


# ---------------------------------------------------------------------------
# the routing functions equal the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rendezvous_order_equals_the_reference(seed):
    rng = random.Random(seed)
    members = [f"10.0.{rng.randrange(256)}.{rng.randrange(256)}:"
               f"{rng.randrange(1024, 65536)}" for _ in range(rng.randint(1, 7))]
    for key in _keys(200, seed):
        weights = {m: rng.choice([None, 0.0, rng.random(), 1.0, 3.0])
                   for m in members}
        weights = {m: w for m, w in weights.items() if w is not None}
        assert router_mod.rendezvous_order(members, key) == \
            ref_router.rendezvous_order(members, key)
        assert router_mod.rendezvous_order(members, key, weights) == \
            ref_router.rendezvous_order(members, key, weights)


def test_weight_from_busy_equals_the_reference():
    rng = random.Random(5)
    for busy in [None, 0.0, 1.0, -3.0, 7.5, 0.25] + \
            [rng.uniform(-1, 2) for _ in range(200)]:
        assert router_mod.weight_from_busy(busy) == \
            ref_router.weight_from_busy(busy)
    assert router_mod.MIN_ROUTE_WEIGHT == ref_router.MIN_ROUTE_WEIGHT


def test_route_keys_of_wire_bodies_equal_the_reference():
    rng = random.Random(9)
    for i in range(12):
        n_ops = rng.choice([4, 10, 30, 70])
        hs = [synth.generate_history(rng, n_procs=3, n_ops=n_ops)
              for _ in range(rng.randint(0, 5))]
        opts = rng.choice([{}, {"slot_cap": 16}, {"slot_cap": 8,
                                                  "frontier": 64,
                                                  "escalation": (2, 8)}])
        model = rng.choice([models.cas_register(0),
                            models.multi_register({0: 0, 1: 5})])
        body = protocol.decode_body(protocol.check_request(model, hs, opts))
        ref_body = ref_protocol.decode_body(protocol.check_request(model, hs,
                                                                   opts))
        assert router_mod.check_route_key(body) == \
            ref_router.check_route_key(ref_body)
        graphs = [{"rel": [[0] * n] * n, "masks": [], "nonadj": []}
                  for n in (rng.randint(1, 600) for _ in range(i % 5))]
        assert router_mod.elle_route_key({"graphs": graphs}) == \
            ref_router.elle_route_key({"graphs": graphs})
    base = {"model": {"type": "cas-register", "value": 0},
            "opts": {"slot_cap": 32}, "histories": [[0] * 5, [0] * 11]}
    assert router_mod.check_route_key(base) == router_mod.check_route_key(
        dict(base, histories=[[0] * 7, [0] * 9]))
    assert router_mod.check_route_key(base) == router_mod.check_route_key(
        dict(base, opts={"slot_cap": 32, "window": 9}))
    assert router_mod.check_route_key(base) != router_mod.check_route_key(
        dict(base, opts={"slot_cap": 64}))


def test_removing_a_member_moves_only_its_keys():
    members = ["a:1", "b:2", "c:3"]
    keys = _keys(1000, 7)
    before = {k: router_mod.rendezvous_order(members, k)[0] for k in keys}
    after = {k: router_mod.rendezvous_order(members[:2], k)[0] for k in keys}
    assert all(after[k] == before[k] for k in keys if before[k] != "c:3")
    # down-weighting one member moves only keys that member was winning
    weighted = {k: router_mod.rendezvous_order(members, k, {"c:3": 0.3})[0]
                for k in keys}
    assert all(weighted[k] == before[k] for k in keys if before[k] != "c:3")
    assert 0 < sum(w == "c:3" for w in weighted.values()) < \
        sum(b == "c:3" for b in before.values())


# ---------------------------------------------------------------------------
# forwarding, on scripted sends
# ---------------------------------------------------------------------------


def _stub_router(monkeypatch, members, behaviour):
    """A router whose sends follow ``behaviour[member]``: ``("ok", code,
    body)`` or ``"dead"`` (a connection failure)."""
    rt = Router(members, port=0, breaker_failures=2,
                breaker_cooldown_s=600.0)
    sent = []

    def fake_send(member, path, body):
        sent.append(member)
        b = behaviour[member]
        if b == "dead":
            raise router_mod.RouteError(f"{member}: down")
        return b[1], b[2]

    monkeypatch.setattr(rt, "_send", fake_send)
    return rt, sent


MEMBERS = ["h1:1", "h2:2", "h3:3"]


def test_forward_reaches_the_rendezvous_winner(monkeypatch):
    rt, sent = _stub_router(monkeypatch, MEMBERS,
                            {m: ("ok", 200, b"{}") for m in MEMBERS})
    assert rt.forward("/check", b"{}", "some-key")[0] == 200
    assert sent == [router_mod.rendezvous_order(MEMBERS, "some-key")[0]]


def test_forward_reroutes_past_a_dead_member_in_rendezvous_order(
        monkeypatch):
    from jepsen_tpu_torch import obs

    obs.enable(reset=True)
    order = router_mod.rendezvous_order(MEMBERS, "k")
    behaviour = {m: ("ok", 200, b"{}") for m in MEMBERS}
    behaviour[order[0]] = "dead"
    rt, sent = _stub_router(monkeypatch, MEMBERS, behaviour)
    assert rt.forward("/check", b"{}", "k")[0] == 200
    assert sent == order[:2]
    assert obs.registry().value("jepsen_route_reroutes_total",
                                member=order[0]) == 1
    assert rt._candidates("k")[-1] == order[0]  # now marked down
    obs.enable(reset=True)


def test_forward_skips_an_open_breaker_without_a_connection(monkeypatch):
    order = router_mod.rendezvous_order(MEMBERS, "k")
    rt, sent = _stub_router(monkeypatch, MEMBERS,
                            {m: ("ok", 200, b"{}") for m in MEMBERS})
    br = rt._breaker(order[0])
    br.record_failure()
    br.record_failure()
    assert br.state() == "open"
    assert rt.forward("/check", b"{}", "k")[0] == 200
    assert sent == [order[1]]


def test_forward_passes_member_http_errors_on_unchanged(monkeypatch):
    order = router_mod.rendezvous_order(MEMBERS[:2], "k")
    body_503 = protocol.encode_body({"error": "backlogged"})
    behaviour = {m: ("ok", 200, b"{}") for m in MEMBERS[:2]}
    behaviour[order[0]] = ("ok", 503, body_503)
    rt, sent = _stub_router(monkeypatch, MEMBERS[:2], behaviour)
    assert rt.forward("/check", b"{}", "k") == (503, body_503)
    assert sent == [order[0]]


def test_forward_answers_503_when_every_member_is_dead(monkeypatch):
    rt, sent = _stub_router(monkeypatch, MEMBERS[:2],
                            {m: "dead" for m in MEMBERS[:2]})
    code, resp = rt.forward("/check", b"{}", "k")
    assert code == 503
    assert protocol.decode_body(resp)["error"] == "no live fleet member"
    assert sent == router_mod.rendezvous_order(MEMBERS[:2], "k")


def test_forward_tries_members_marked_down_last(monkeypatch):
    order = router_mod.rendezvous_order(MEMBERS, "k")
    rt, sent = _stub_router(monkeypatch, MEMBERS,
                            {m: ("ok", 200, b"{}") for m in MEMBERS})
    rt._up[order[0]] = False
    assert rt.forward("/check", b"{}", "k")[0] == 200
    assert sent == [order[1]]
    assert rt._candidates("k") == order[1:] + order[:1]


def test_probe_weights_follow_busy_ratios(monkeypatch):
    rt = Router(MEMBERS, port=0, probe_interval_s=600.0)
    monkeypatch.setattr(router_mod, "probe_healthz",
                        lambda m, timeout=None: m != "h3:3")
    busy = {"h1:1": 0.9, "h2:2": None, "h3:3": 0.4}
    monkeypatch.setattr(rt, "_member_busy_ratio", lambda m: busy[m])
    assert rt.probe_once() == 2
    assert rt._weights["h1:1"] == pytest.approx(0.1)
    assert rt._weights["h2:2"] == rt._weights["h3:3"] == 1.0
    for key in _keys(50, 41):
        order = router_mod.rendezvous_order(MEMBERS, key, rt._weights)
        assert rt._candidates(key) == [m for m in order if m != "h3:3"] + \
            ["h3:3"]
    assert Router(["127.0.0.1:9"], port=0)._member_busy_ratio(
        "127.0.0.1:9") is None


# ---------------------------------------------------------------------------
# forwarding to the port's CPU daemons
# ---------------------------------------------------------------------------


def test_routed_checks_reach_the_ranked_member_and_equal_in_process(fleet):
    model = models.cas_register(0)
    ds = [fleet.daemon() for _ in range(2)]
    rt = fleet.router([_addr(d) for d in ds])
    assert rt.probe_once() == 2
    client = ServiceClient(port=rt.port)
    for seed in (1, 2, 3):
        hs = _corpus(seed, n=2 + seed)
        key = router_mod.check_route_key(protocol.decode_body(
            protocol.check_request(model, hs, {"slot_cap": 32})))
        winner = rt._candidates(key)[0]
        before = {_addr(d): d.status()["requests"] for d in ds}
        got = client.check_batch(model, hs, slot_cap=32)
        assert got == wgl.check_batch(model, hs, device="cpu", slot_cap=32)
        moved = {_addr(d): d.status()["requests"] - before[_addr(d)]
                 for d in ds}
        assert moved == {a: int(a == winner) for a in moved}


def test_a_retry_through_a_reroute_stays_idempotent(fleet):
    model = models.cas_register(0)
    hs = _corpus()
    expected = wgl.check_batch(model, hs, device="cpu", slot_cap=32)
    ds = [fleet.daemon(coalesce_wait_s=0.1) for _ in range(2)]
    rt = fleet.router([_addr(d) for d in ds])
    assert rt.probe_once() == 2
    body = protocol.check_request(model, hs, {"slot_cap": 32},
                                  req="router-dedup-rid")
    client = ServiceClient(port=rt.port)

    def post():
        code, resp = client._resilient_post("/check", body)
        assert code == 200
        return protocol.decode_body(resp)["results"]

    assert post() == expected
    owner = max(ds, key=lambda d: d.status()["requests"])
    sibling = next(d for d in ds if d is not owner)
    deduped = owner.status()["deduped"]
    assert post() == expected
    assert owner.status()["deduped"] == deduped + 1
    owner.stop()
    before = sibling.status()["requests"]
    assert post() == expected  # the sibling computes it afresh
    assert sibling.status()["requests"] == before + 1


def test_feed_sessions_are_pinned_through_the_router(fleet):
    model = models.cas_register(0)
    hs = _corpus(seed=7, n=6)
    ds = [fleet.daemon() for _ in range(2)]
    rt = fleet.router([_addr(d) for d in ds])
    session = ServiceClient(port=rt.port).open_feed(model, {"slot_cap": 32})
    assert rt.status()["feed_pins"] == 1
    for h in hs:
        session.append(histories=[h])
    assert session.close() == wgl.check_batch(model, hs, device="cpu",
                                              slot_cap=32)
    deltas = {_addr(d): d.status()["feed_deltas"] for d in ds}
    assert sorted(deltas.values()) == [0, len(hs)]
    assert rt.status()["feed_pins"] == 0


def test_router_status_healthz_metrics_and_shutdown(fleet):
    d = fleet.daemon()
    rt = fleet.router([_addr(d), "127.0.0.1:9"])
    rt.probe_once()
    st = ServiceClient(port=rt.port).status()
    assert st["role"] == "router" and st["ok"]
    assert {m["member"]: m["up"] for m in st["members"]} == {
        _addr(d): True, "127.0.0.1:9": False}
    client = ServiceClient(port=rt.port)
    assert client.healthy()
    text = client.metrics_text()
    assert "jepsen_route_members_up" in text
    assert "jepsen_route_probe_failures_total" in text
    assert client.shutdown()["role"] == "router"
    deadline = time.monotonic() + JOIN_S
    while client.healthy(timeout=0.2) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not client.healthy(timeout=0.2)
    assert d.status()["ok"]  # the members keep serving


def test_the_fleet_table_shows_the_routing_weight():
    out = serve_client.format_fleet_status([
        ("h1:7001", {"n_devices": 1, "device": "cpu",
                     "live": {"device_busy_ratio": 0.9}}),
        ("h2:7002", {"n_devices": 1, "device": "cpu", "live": {}}),
        ("h3:7003", None),
    ])
    lines = out.splitlines()
    assert lines[1].split()[-2:] == ["busy", "weight"]
    rows = {ln.split()[0]: ln.split() for ln in lines[3:]}
    assert rows["h1:7001"][-2:] == ["90%", "0.10"]
    assert rows["h2:7002"][-2:] == ["n/a", "1.00"]
    assert rows["h3:7003"][-1] == "-"


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------


def _status(port):
    return ServiceClient(port=port, timeout=5).status()


def _wait_healthy(port, not_pid=None, wait_s=JOIN_S):
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        if serve_client.probe_healthz(f"127.0.0.1:{port}", timeout=0.5):
            st = _status(port)
            if st["pid"] != not_pid:
                return st
        time.sleep(0.1)
    raise AssertionError(f"no healthy daemon on port {port}")


def _free_pair():
    for _ in range(50):
        p = serve_client.free_port()
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", p + 1))
            return p
        except OSError:
            continue
    raise AssertionError("no two free ports in a row")


def _command(*args, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.serve", *args], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        start_new_session=True, **kw)


def _reap_group(proc):
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=JOIN_S)


def test_the_supervisor_restarts_a_killed_daemon_and_exits_zero(tmp_path):
    model = models.cas_register(0)
    hs = _corpus(seed=17)
    wal = str(tmp_path / "wal.jsonl")
    port = serve_client.free_port()
    proc = _command("--supervise", "--device", "cpu", "--port", str(port),
                    "--wal", wal)
    try:
        st = _wait_healthy(port)
        client = ServiceClient(port=port)
        assert client.check_batch(model, hs, slot_cap=32) == \
            wgl.check_batch(model, hs, device="cpu", slot_cap=32)
        os.kill(st["pid"], signal.SIGKILL)
        serve_client.reset_breakers()
        st2 = _wait_healthy(port, not_pid=st["pid"])
        assert st2["wal_path"] == wal and st2["requests"] == 0
        assert client.check_batch(model, hs, slot_cap=32) == \
            wgl.check_batch(model, hs, device="cpu", slot_cap=32)
        assert client.shutdown()["ok"]
        assert proc.wait(timeout=JOIN_S) == 0
        assert b"child exited rc=-9; restart 1/16" in proc.stderr.read()
    finally:
        _reap_group(proc)


def test_the_supervisor_returns_the_exit_code_once_its_budget_is_spent():
    t0 = time.monotonic()
    rc = daemon_mod.supervise(["--no-such-flag"], max_restarts=2,
                              backoff_s=0.05, max_backoff_s=0.1,
                              _signals=False)
    assert rc == 2  # argparse's exit code, after three tries
    assert time.monotonic() - t0 < JOIN_S


def test_a_supervised_fleet_runs_members_on_their_own_ports_and_wals(
        tmp_path):
    wal = str(tmp_path / "wal.jsonl")
    port = _free_pair()
    proc = _command("--supervise", "--fleet", "2", "--device", "cpu",
                    "--port", str(port), "--wal", wal)
    try:
        sts = [_wait_healthy(port + i) for i in range(2)]
        assert [st["wal_path"] for st in sts] == [
            str(tmp_path / f"wal-{i}.jsonl") for i in range(2)]
        assert sts[0]["pid"] != sts[1]["pid"]
        for i in range(2):
            ServiceClient(port=port + i).shutdown()
        assert proc.wait(timeout=JOIN_S) == 0
    finally:
        _reap_group(proc)


def test_fleet_member_args_give_each_member_its_port_and_wal():
    args = ["--device", "cpu", "--port", "9000", "--wal", "/x/wal.jsonl",
            "--window", "4"]
    assert daemon_mod.fleet_member_args(0, args) == [
        "--device", "cpu", "--window", "4", "--port", "9000",
        "--wal", "/x/wal-0.jsonl"]
    assert daemon_mod.fleet_member_args(3, ["--port=9000", "--wal=w"]) == [
        "--port", "9003", "--wal", "w-3"]
    assert daemon_mod.fleet_member_args(1, ["--wal", "off"]) == [
        "--wal", "off", "--port", str(protocol.DEFAULT_PORT + 1)]


def test_fleet_without_supervise_exits_non_zero():
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.serve", "--fleet", "2",
         "--device", "cpu", "--port", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=JOIN_S)
    assert out.returncode != 0
    assert "--fleet requires --supervise" in out.stderr


def test_the_router_command_runs_and_stops_on_shutdown(fleet):
    d = fleet.daemon()
    port = serve_client.free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.serve.router", "--member",
         _addr(d), "--port", str(port), "--probe-interval", "0.2",
         "--probe-timeout", "0.5"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        deadline = time.monotonic() + JOIN_S
        client = ServiceClient(port=port)
        while not client.healthy() and time.monotonic() < deadline:
            time.sleep(0.1)
        hs = _corpus(seed=29)
        model = models.cas_register(0)
        assert client.check_batch(model, hs, slot_cap=32) == \
            wgl.check_batch(model, hs, device="cpu", slot_cap=32)
        assert client.shutdown()["ok"]
        assert proc.wait(timeout=JOIN_S) == 0
        assert b"fleet router on" in proc.stdout.read()
    finally:
        _reap_group(proc)
