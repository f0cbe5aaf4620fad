"""The port's store web UI (``web.py``, ``cli serve`` without
``--checker``) against the JAX package's, which imports no JAX: the home
page, the directory pages, the zip download and every HTTP route give the
same bytes on the same store.

The one difference by design: the live checker-service panel reads the
daemon at the address it is given (no environment variable) and adds the
daemon's device to the reference's rows.  Every server a test starts is
shut down, closed and its thread joined; the ``serve`` process is killed
and reaped.
"""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from jepsen_tpu import web as ref_web
from jepsen_tpu_torch import store as port_store
from jepsen_tpu_torch import web as port_web
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.util import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 10


@pytest.fixture
def store_base(tmp_path):
    """Three runs of two tests: one with results.json, a trace and a
    profile; one whose verdict is read from test.jtpu alone; one invalid
    with plots and a nested directory."""
    base = tmp_path / "store"
    runs = [("bank", "20261018T101010.000", True),
            ("bank", "20261018T111111.000", False),
            ("list-append", "20261018T090909.000", "unknown")]
    for name, t, valid in runs:
        d = base / name / t
        d.mkdir(parents=True)
        (d / "results.json").write_text(json.dumps({"valid?": valid}))
        (d / "history.jsonl").write_text('{"index": 0}\n')
    first = base / "bank" / runs[0][1]
    (first / "trace.json").write_text('{"traceEvents": []}')
    (first / "profile").mkdir()
    (first / "profile" / "profile.json").write_text("{}")
    (first / "metrics.prom").write_text("jepsen_x 1\n")
    second = base / "bank" / runs[1][1]
    (second / "bank.svg").write_text("<svg/>")
    (second / "n1").mkdir()
    (second / "n1" / "db.log").write_text("hello <b>\n")
    (second / "odd name & more.edn").write_text("{:a 1}")
    # a run whose verdict only its test.jtpu holds
    t = {"name": "rw-register", "start-time": "20261018T121212.000",
         "store-base": str(base), "nodes": ["n1"]}
    with port_store.with_writer(t) as t2:
        t2 = port_store.save_0(t2)
        t2 = port_store.save_1({**t2, "history": History()})
        port_store.save_2({**t2, "results": {"valid?": False}})
    os.remove(base / "rw-register" / t["start-time"] / "results.json")
    return str(base)


@pytest.fixture
def no_daemon(monkeypatch):
    """A free port where no checker daemon listens, for both packages."""
    port = free_port()
    monkeypatch.setenv("JEPSEN_TPU_SERVE_PORT", str(port))
    return ("127.0.0.1", port)


def test_pages_equal_the_references(store_base, no_daemon):
    assert port_web.home_page(store_base, no_daemon) == \
        ref_web.home_page(store_base)
    page = port_web.home_page(store_base, no_daemon)
    assert "Checker service" not in page
    assert page.count("<tr class=") == 4 and "trace</a>" in page
    for rel in ("", "bank", "bank/20261018T111111.000",
                "bank/20261018T111111.000/n1"):
        assert port_web.dir_page(store_base, rel) == \
            ref_web.dir_page(store_base, rel), rel
    for name, t in (("bank", "20261018T101010.000"),
                    ("rw-register", "20261018T121212.000")):
        d = os.path.join(store_base, name, t)
        assert port_web.test_row(store_base, name, t) == \
            ref_web.test_row(store_base, name, t)
        assert port_web.zip_bytes(d) == ref_web.zip_bytes(d)
    assert port_web.test_row(store_base, "rw-register",
                             "20261018T121212.000")["valid"] is False


def _get(port, path):
    url = f"http://127.0.0.1:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _stop(server):
    server.shutdown()
    server.server_close()


def test_http_routes_equal_the_references(store_base, no_daemon, capsys):
    ports = {"ref": free_port(), "port": free_port()}
    servers = {
        "ref": ref_web.serve("127.0.0.1", ports["ref"], store_base,
                             block=False),
        "port": port_web.serve("127.0.0.1", ports["port"], store_base,
                               block=False, service=no_daemon),
    }
    try:
        paths = ["/", "/files/", "/files/bank/", "/files/bank/20261018T101010"
                 ".000/trace.json", "/files/bank/20261018T101010.000/"
                 "metrics.prom", "/files/bank/20261018T111111.000/bank.svg",
                 "/files/bank/20261018T111111.000/odd%20name%20%26%20more"
                 ".edn", "/files/bank/20261018T111111.000/n1/db.log",
                 "/files/../../etc/passwd", "/files/nope",
                 "/zip/bank/20261018T101010.000", "/zip/nope",
                 "/zip/../outside", "/elsewhere"]
        for path in paths:
            got = {p: _get(ports[p], path) for p in ports}
            assert got["port"] == got["ref"], path
        codes = [_get(ports["port"], p)[0] for p in paths]
        assert codes == [200] * 8 + [403, 404, 200, 404, 404, 404]
    finally:
        for server in servers.values():
            _stop(server)
    servers["port"].thread.join(JOIN_S)
    assert not servers["port"].thread.is_alive()
    out = capsys.readouterr().out
    assert f"http://127.0.0.1:{ports['port']}/" in out


class _FakeClient:
    """A daemon's ``/status`` and ``/watch`` without a daemon."""

    host, port = "127.0.0.1", 8519

    def __init__(self, status, events=()):
        self._status = status
        self._events = list(events)

    def status(self):
        return self._status

    def watch(self, last_id=-1, timeout=None):
        yield from self._events


STATUS = {
    "platform": "gpu", "device": "cuda:0", "uptime_s": 12.6, "requests": 7,
    "histories": 300, "queue_depth": 1, "max_queue_runs": 32,
    "stopping": True, "coalesced": 2, "warm_hit_ratio": 0.75,
    "live": {"requests_per_s": 0.5, "histories_per_s": 12.25,
             "dispatches_per_s": 1.0, "queue_wait_mean_s": 0.0123,
             "device_busy_ratio": 0.002, "feed_deltas_per_s": 3.0},
    "feed_open": 1, "feed_sessions": 2, "feed_deltas": 9,
    "watch_subscribers": 1, "watch_events": 4,
    "journal_path": "/tmp/j.jsonl", "journal_rows": 17,
    "drift": {"score": 1.5, "shapes": 3, "retune_recommended": True},
    "wal_rows": 3,
}

EVENTS = [(0, {"req": "abcdef0123456789", "stream": 0, "idx": 1,
               "result": {"valid?": True, "engine": "gpu"}}),
          (1, {"req": "r2", "stream": "k<1>", "idx": 0,
               "result": {"valid?": False, "engine": "gpu"}}),
          (2, {"req": "r3", "stream": 1, "idx": 2, "result": {}})]


@pytest.mark.parametrize("status, events", [
    (STATUS, EVENTS),
    ({**STATUS, "live": {}, "feed_open": 0, "feed_sessions": 0,
      "watch_subscribers": 0, "watch_events": 0, "journal_path": None,
      "drift": None, "wal_rows": 0, "warm_hit_ratio": None,
      "stopping": False}, []),
    ({"platform": "cpu", "device": "cpu"}, []),
])
def test_service_section_is_the_references_with_the_device(
        monkeypatch, status, events):
    import jepsen_tpu.serve as ref_serve

    client = _FakeClient(status, events)
    monkeypatch.setattr(ref_serve, "ServiceClient",
                        lambda *a, **kw: client)
    ref = ref_web.service_section()
    port = port_web.service_section(client=client)
    row = (f"<tr><td>device</td><td>{status['device']}</td></tr>")
    assert row in port
    assert port.replace(row, "", 1) == ref
    assert ref.startswith("<h2>Checker service")


def test_service_section_reads_a_live_cpu_daemon():
    """The panel against a real CPU daemon of the port, then gone when the
    daemon is."""
    from jepsen_tpu_torch.serve import daemon as daemon_mod

    d = daemon_mod.CheckerDaemon(port=0, device="cpu").start(block=False)
    try:
        page = port_web.service_section(service=("127.0.0.1", d.port))
        assert "Checker service" in page and "<td>cpu</td>" in page
        assert f"http://127.0.0.1:{d.port}/metrics" in page
    finally:
        d.stop()  # drains, stops and joins its threads
    assert port_web.service_section(service=("127.0.0.1", d.port)) == ""


def test_cli_serve_runs_the_web_ui(store_base, tmp_path):
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "serve", "--host",
         "127.0.0.1", "--port", str(port), "--store-base", store_base,
         "--service", f"127.0.0.1:{free_port()}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                status, ctype, body = _get(port, "/")
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.monotonic() < deadline
                time.sleep(0.2)
        assert status == 200 and ctype == "text/html"
        assert b"20261018T121212.000" in body
    finally:
        proc.kill()
        proc.wait(JOIN_S)
        proc.stdout.close()
