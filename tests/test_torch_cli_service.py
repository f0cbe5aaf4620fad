"""The port's CLI service and tuner commands (``jepsen_tpu_torch.cli``:
``serve --checker``, ``status``, ``shutdown``, ``route``, ``top``,
``profile``, ``tune``) and the formatters they print
(``serve.client.format_top``, ``format_verdicts``, ``format_drift``,
``format_live``), on the CPU.

- The formatters give the reference's bytes on the same ``/status`` dicts
  (hand-made ones covering every branch, and a live CPU daemon's).
- Each command runs against CPU daemons: in-process ones, one started by
  ``serve --checker`` and a supervised fleet of two started by ``serve
  --checker --supervise --fleet 2``; ``route`` fronts a daemon and stops
  on ``/shutdown``.  ``serve`` without ``--checker`` is the web UI, and a
  ``--service`` address that is not ``HOST:PORT`` is a usage error.
- No command reads an environment variable: the port has none.

Every daemon, router and process is stopped by a fixture or a
``finally``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from jepsen_tpu.serve import client as ref_client
from jepsen_tpu_torch import cli, models, synth
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.serve import CheckerDaemon, ServiceClient
from jepsen_tpu_torch.serve import client as serve_client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 60
MODEL = models.cas_register(0)


@pytest.fixture(autouse=True)
def _fresh_breakers():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    serve_client.reset_breakers()
    yield
    torch.set_num_threads(n)
    serve_client.reset_breakers()


@pytest.fixture
def daemons(tmp_path):
    """``start(**kw)`` starts an in-process CPU daemon with a WAL; all
    are stopped at teardown."""
    started = []

    def start(**kw):
        kw.setdefault("device", "cpu")
        kw.setdefault("wal_path", str(tmp_path / f"wal-{len(started)}.jsonl"))
        d = CheckerDaemon(port=0, **kw)
        started.append(d)
        return d.start(block=False)

    yield start
    for d in started:
        d.stop()


def _corpus(seed=991, n=4):
    import random

    rng = random.Random(seed)
    return [synth.generate_history(rng, n_procs=3, n_ops=10, crash_p=0.02,
                                   corrupt=i == 0) for i in range(n)]


def _run(argv, capsys):
    """One CLI command in-process: (exit code, stdout, stderr)."""
    capsys.readouterr()
    rc = cli.run_cli(cli.default_commands(), argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _wait_healthy(port, wait_s=JOIN_S):
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        if serve_client.probe_healthz(f"127.0.0.1:{port}", timeout=0.5):
            return ServiceClient(port=port).status()
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


def _cli_process(*args):
    return subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)


def _reap_group(proc):
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=JOIN_S)


# ---------------------------------------------------------------------------
# the formatters give the reference's bytes
# ---------------------------------------------------------------------------

FULL = {
    "pid": 4242, "n_devices": 2, "mesh_shape": [2], "uptime_s": 93.6,
    "stopping": True, "queue_depth": 3, "max_queue_runs": 32,
    "in_flight": 2, "coalesced": 7, "feed_open": 2, "watch_subscribers": 1,
    "journal_path": "/tmp/j.jsonl", "journal_rows": 88,
    "quarantine": [{"route": "dense", "error": "x"}],
    "live": {"requests_per_s": 1.25, "histories_per_s": 40.0,
             "elle_graphs_per_s": 0, "dispatches_per_s": 3.5,
             "feed_deltas_per_s": 0.5, "watch_events_per_s": 2,
             "queue_wait_mean_s": 0.0123, "device_busy_ratio": 0.456},
    "drift": {"score": 3.14159, "threshold": 2.0, "shapes": 4,
              "rows_scored": 120, "retune_recommended": True,
              "stale": [{"kernel": "dense", "E": 64, "C": 8, "F": 0,
                         "ratio": 3.2},
                        {"kernel": "frontier", "E": 128, "C": 12,
                         "F": 128, "ratio": 2.5}]},
}
STATUSES = {
    "empty": {},
    "full": FULL,
    "quiet drift": {**FULL, "stopping": False, "mesh_shape": None,
                    "drift": {"score": 0.9, "threshold": 2.0,
                              "retune_recommended": False},
                    "live": {"queue_wait_mean_s": None}},
    "retune without stale": {"drift": {"score": "x",
                                       "retune_recommended": True}},
}


@pytest.mark.parametrize("name", sorted(STATUSES))
def test_status_formatters_equal_the_reference(name):
    st = STATUSES[name]
    assert serve_client.format_top("127.0.0.1", 8519, st) == \
        ref_client.format_top("127.0.0.1", 8519, st)
    assert serve_client.format_live(st.get("live") or {}) == \
        ref_client.format_live(st.get("live") or {})
    assert serve_client.format_drift(st.get("drift") or {}) == \
        ref_client.format_drift(st.get("drift") or {})


VERDICTS = [
    ("127.0.0.1:1", 0, {"req": "abcdef0123", "stream": "check", "idx": 3,
                        "ts": 990.0, "result": {"valid?": True}}),
    ("127.0.0.1:2", 5, {"req": None, "stream": "feed", "idx": 0,
                        "ts": 1001.5, "result": {"valid?": False,
                                                 "anomaly-types": ["G1c"]}}),
    ("127.0.0.1:2", 6, {"req": "r", "stream": "feed", "idx": 1,
                        "result": {"valid?": "unknown"}}),
    ("127.0.0.1:1", 9, {"req": "q", "stream": "check", "idx": 2,
                        "ts": 999, "result": {"valid?": False,
                                              "anomalies": {"a": 1}}}),
]


@pytest.mark.parametrize("limit", [8, 2])
@pytest.mark.parametrize("n", [0, 1, 4])
def test_format_verdicts_equals_the_reference(monkeypatch, n, limit):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    rows = VERDICTS[:n]
    assert serve_client.format_verdicts(rows, limit=limit) == \
        ref_client.format_verdicts(rows, limit=limit)


def test_a_live_daemons_status_formats_as_the_reference(daemons):
    d = daemons()
    client = ServiceClient(port=d.port)
    hs = _corpus()
    assert client.check_batch(MODEL, hs, slot_cap=32) == \
        wgl.check_batch(MODEL, hs, device="cpu", slot_cap=32)
    st = client.status()
    assert st["live"] and st["requests"] == 1
    for fmt in ("format_live",):
        assert getattr(serve_client, fmt)(st["live"]) == \
            getattr(ref_client, fmt)(st["live"])
    assert serve_client.format_top("h", d.port, st) == \
        ref_client.format_top("h", d.port, st)
    text = serve_client.format_status(st)
    assert serve_client.format_live(st["live"]) in text


# ---------------------------------------------------------------------------
# the commands against CPU daemons
# ---------------------------------------------------------------------------


def test_status_profile_top_and_shutdown_of_one_daemon(daemons, tmp_path,
                                                       capsys):
    d = daemons()
    client = ServiceClient(port=d.port)
    client.check_batch(MODEL, _corpus(), slot_cap=32)
    port = str(d.port)

    rc, out, _ = _run(["status", "--port", port], capsys)
    assert rc == cli.EXIT_VALID
    assert out.startswith("── checker service")
    assert f"pid {os.getpid()} on cpu" in out
    assert "requests: 1" in out and "last 60s:" in out

    rc, out, _ = _run(["top", "--once", "--port", port], capsys)
    assert rc == cli.EXIT_VALID
    assert out.startswith(f"● 127.0.0.1:{port}  pid {os.getpid()}")
    assert "── verdicts" in out and "✓" in out and " main[" in out

    prof = tmp_path / "prof"
    rc, out, err = _run(["profile", "--port", port, "--seconds", "0.2",
                         "--label", "cli", "--dir", str(prof)], capsys)
    assert rc == cli.EXIT_VALID, err
    assert out.startswith(f"profile capture → {prof}")
    assert "device memory peak:" in out
    assert (prof / "profile.json").exists()

    rc, out, _ = _run(["shutdown", "--port", port], capsys)
    assert rc == cli.EXIT_VALID
    assert out.startswith(f"checker service at 127.0.0.1:{port} draining")
    deadline = time.monotonic() + JOIN_S
    while client.healthy() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not client.healthy()

    # nothing answers now: every command says so and exits UNKNOWN
    for argv in (["status"], ["top", "--once"], ["profile"], ["shutdown"]):
        rc, _, err = _run(argv + ["--port", port], capsys)
        assert rc == cli.EXIT_UNKNOWN, argv
        assert f"127.0.0.1:{port}" in err


def test_status_and_top_of_a_fleet_tolerate_a_dead_member(daemons, capsys):
    a, b = daemons(), daemons()
    ServiceClient(port=b.port).check_batch(MODEL, _corpus(seed=5),
                                           slot_cap=32)
    dead = serve_client.free_port()
    rc, out, _ = _run(["status", "--port", str(a.port), "--daemon",
                       f"127.0.0.1:{b.port}", "--daemon",
                       f"127.0.0.1:{dead}"], capsys)
    assert rc == cli.EXIT_VALID
    assert out.startswith("── fleet")
    assert f"127.0.0.1:{dead}" in out and "unreachable" in out
    assert out.count("defaults") == 2

    rc, out, _ = _run(["top", "--once", "--port", str(a.port), "--daemon",
                       f"127.0.0.1:{b.port}", "--daemon",
                       f"127.0.0.1:{dead}"], capsys)
    assert rc == cli.EXIT_VALID
    assert out.count("● 127.0.0.1:") == 2
    assert f"○ 127.0.0.1:{dead}  (unreachable)" in out
    assert f"✓ 127.0.0.1:{b.port} #" in out

    rc, _, err = _run(["status", "--port", str(dead), "--daemon",
                       f"127.0.0.1:{dead}"], capsys)
    assert rc == cli.EXIT_UNKNOWN
    rc, _, err = _run(["top", "--once", "--port", str(dead)], capsys)
    assert rc == cli.EXIT_UNKNOWN and f"top: 127.0.0.1:{dead}:" in err
    for cmd in ("status", "shutdown", "top"):
        rc, _, err = _run([cmd, "--daemon", "no-port"], capsys)
        assert rc == cli.EXIT_USAGE and "bad --daemon address" in err


def test_route_fronts_a_daemon_and_stops_on_shutdown(daemons, capsys):
    d = daemons()
    port = serve_client.free_port()
    box = {}

    def route():
        box["rc"] = cli.run_cli(cli.default_commands(), [
            "route", "--member", f"127.0.0.1:{d.port}", "--port", str(port),
            "--probe-interval", "0.2"])

    t = threading.Thread(target=route)
    t.start()
    try:
        _wait_healthy_router(port)
        hs = _corpus(seed=29)
        client = ServiceClient(port=port)
        assert client.check_batch(MODEL, hs, slot_cap=32) == \
            wgl.check_batch(MODEL, hs, device="cpu", slot_cap=32)
        assert client.status()["role"] == "router"
        assert client.shutdown()["ok"]
    finally:
        t.join(JOIN_S)
        if t.is_alive():
            ServiceClient(port=port).shutdown()
            t.join(JOIN_S)
    assert not t.is_alive() and box["rc"] == cli.EXIT_VALID
    assert "fleet router on" in capsys.readouterr().out
    rc, _, err = _run(["route", "--member", "nohost"], capsys)
    assert rc == cli.EXIT_USAGE and "bad --member address" in err


def _wait_healthy_router(port):
    deadline = time.monotonic() + JOIN_S
    while not serve_client.probe_healthz(f"127.0.0.1:{port}", timeout=0.5):
        assert time.monotonic() < deadline, "the router never answered"
        time.sleep(0.05)


def test_serve_checker_runs_a_daemon_until_shutdown(tmp_path, capsys):
    port = serve_client.free_port()
    wal = str(tmp_path / "wal.jsonl")
    proc = _cli_process("serve", "--checker", "--device", "cpu", "--port",
                        str(port), "--wal", wal, "--max-queue", "5",
                        "--engine-window", "2")
    try:
        st = _wait_healthy(port)
        assert st["wal_path"] == wal and st["max_queue_runs"] == 5
        assert st["window"] == 2 and st["platform"] == "cpu"
        rc, out, _ = _run(["shutdown", "--port", str(port)], capsys)
        assert rc == cli.EXIT_VALID
        assert proc.wait(timeout=JOIN_S) == 0
    finally:
        _reap_group(proc)


def test_serve_checker_supervises_a_fleet_of_two(tmp_path, capsys):
    port = _free_pair()
    wal = str(tmp_path / "wal.jsonl")
    proc = _cli_process("serve", "--checker", "--supervise", "--fleet", "2",
                        "--device", "cpu", "--port", str(port), "--wal", wal)
    try:
        sts = [_wait_healthy(port + i) for i in range(2)]
        assert [st["wal_path"] for st in sts] == [
            str(tmp_path / f"wal-{i}.jsonl") for i in range(2)]
        members = ["--port", str(port), "--daemon", f"127.0.0.1:{port + 1}"]
        rc, out, _ = _run(["status", *members], capsys)
        assert rc == cli.EXIT_VALID
        assert f"127.0.0.1:{port}" in out and f"127.0.0.1:{port + 1}" in out
        rc, out, _ = _run(["shutdown", *members], capsys)
        assert rc == cli.EXIT_VALID and out.count("draining") == 2
        assert proc.wait(timeout=JOIN_S) == 0
    finally:
        _reap_group(proc)


def test_serve_usage_errors(capsys):
    rc, _, err = _run(["serve", "--service", "127.0.0.1:http"], capsys)
    assert rc == cli.EXIT_USAGE and "--service" in err
    rc, _, err = _run(["serve", "--checker", "--fleet", "2"], capsys)
    assert rc == cli.EXIT_USAGE and "--fleet requires --supervise" in err


def test_tune_writes_an_artifact_on_the_cpu(tmp_path, capsys):
    out_path = tmp_path / "cal.json"
    rc, out, _ = _run(["tune", "--device", "cpu", "--profile", "smoke",
                       "--out", str(out_path)], capsys)
    assert rc == cli.EXIT_VALID
    line = json.loads(out.strip().splitlines()[-1])
    assert line["path"] == str(out_path) and line["device_kind"] == "cpu"
    assert json.load(open(out_path))["calibration_id"] == \
        line["calibration"]


def test_a_malformed_healthz_answer_is_down():
    """An answer that is no HTTP status line — such as the probe's own
    request, read back through a socket connected to itself — is a down
    member, not an exception."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def echo_request_line():
        conn, _ = srv.accept()
        with conn:
            conn.sendall(conn.recv(4096).split(b"\r\n")[0] + b"\r\n")

    t = threading.Thread(target=echo_request_line)
    t.start()
    try:
        assert serve_client.probe_healthz(
            f"127.0.0.1:{srv.getsockname()[1]}", timeout=5) is False
    finally:
        t.join(JOIN_S)
        srv.close()
    assert not t.is_alive()


def test_the_port_reads_no_environment_variable():
    hits = subprocess.run(
        ["grep", "-rn", "os.environ", "jepsen_tpu_torch"], cwd=REPO,
        capture_output=True, text=True)
    assert hits.returncode == 1 and not hits.stdout, hits.stdout
