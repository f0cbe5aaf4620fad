"""Self-chaos drills: ``python -m jepsen_tpu_torch.serve.chaos [--device cpu]
[--drills 1,2,3,4,5]``.

The port of ``jepsen_tpu/serve/chaos.py``: the nemesis turned on the
checker service itself.  A checker that dies with its run, or drops a
violation it had found, is not fit to judge crash-prone systems, so the
service must survive the faults it is built to detect.  Five drills, each
with the reference's gates, against real daemon processes
(:func:`..client.spawn_daemon`: flags, no environment):

1. **kill -9 and WAL resume.**  A daemon is SIGKILLed once mid-request,
   once after settling two full batches (the dense and the frontier
   route), and its WAL's last line is torn.  The restarted daemon replays
   the WAL into the retried request ids: the fully journaled request
   re-dispatches nothing (``replayed == settled``), the torn one re-runs
   exactly one row, every result equals the in-process engine's as
   canonical JSON, and the client that was mid-request never hangs.
2. **Stalled socket and breaker.**  A TCP proxy on the HTTP seam stalls:
   every stalled call returns within its deadline budget, the breaker
   trips, calls fall back in-process with the same verdicts (tagged
   ``"service-fallback"``), and a half-open ``/healthz`` probe closes the
   breaker again.
3. **Dropped response and idempotent retry.**  The proxy forwards a
   request and drops the answer: the retry with the same request id is
   served from the daemon's completed-response cache (``deduped`` + 1)
   and the request counters advance by exactly one.
4. **WAL auto-compaction and a crash during it.**  A daemon with
   ``--wal-compact-bytes 1`` compacts on its first idle turn (counted,
   no ``.tmp`` left, only the completed request's rows kept); a SIGKILL
   beside a half-written ``<wal>.tmp`` does not confuse the restart,
   whose replay re-dispatches nothing.
5. **Fleet member SIGKILL and rejoin.**  Two members behind an
   in-process :class:`..router.Router`: the member owning a key is
   killed with a request in flight, which spills to the sibling with the
   same verdicts; the next request takes the counted connection-error
   reroute; one probe sweep marks the member down, and after its revival
   one sweep marks it up and its key's traffic returns.  The reference's
   gate of zero cold dispatches through a shared AOT cache has no
   counterpart (a first dispatch on CUDA compiles nothing): on the card
   the revived member starts no ``nvcc``, since every kernel library is
   built already, and its first request's cold and warm dispatch counts
   are reported.

Every injected fault is accounted for in metrics: client retries, breaker
trips and probes, router reroutes (this process's registry, as deltas),
WAL replays and dedups (the daemon's ``/metrics``).  Exit 0 when every
gate passes, 1 otherwise.  :func:`run` is the same harness for a caller
(``chip_smoke.py`` phase 27 runs it on the card with full-width traffic
in drills 1 and 5).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import signal
import socket
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

#: the reference's two route configurations (``chaos.py:290-296``): the
#: explicit closure cap forces the frontier search
CONFIGS = {
    "dense": dict(slot_cap=32, max_dispatch=4),
    "frontier": dict(slot_cap=32, max_dispatch=4, max_closure=9),
}

#: bounded waits (seconds): a daemon's start, a request, a thread's join
START_S, REQUEST_S, JOIN_S = 180.0, 600.0, 600.0


def canon(results) -> str:
    """Canonical JSON of a result list (the byte-equality the gates use)."""
    from . import protocol

    return json.dumps(protocol.sanitize_results(results), sort_keys=True)


def metric_value(text: str, name: str) -> Optional[float]:
    """The sum of every sample of ``name`` in Prometheus text."""
    total = None
    for line in text.splitlines():
        if line.startswith(name) and not line.startswith("#"):
            head = line.split(" ", 1)[0]
            if head == name or head.startswith(name + "{"):
                try:
                    total = (total or 0.0) + float(line.rsplit(" ", 1)[1])
                except ValueError:
                    return None
    return total


# -- corpora (the reference's smoke corpora, from the port's synth) ----------------


def corpus_a():
    """``jepsen_tpu/engine/smoke.py``'s batch (seed 45100): two event
    buckets × two concurrency buckets, ~1/3 corrupted, plus one history
    past the slot cap (an oracle row)."""
    from ..history import History, invoke_op
    from ..synth import generate_history

    rng = random.Random(45100)
    hists = []
    for i in range(5):  # short, low concurrency → (E=64, C=4)
        hists.append(generate_history(rng, n_procs=3, n_ops=10, crash_p=0.02,
                                      corrupt=i % 3 == 0))
    for i in range(5):  # long → (E=128, C=4)
        hists.append(generate_history(rng, n_procs=3, n_ops=80, crash_p=0.01,
                                      corrupt=i % 3 == 0))
    for i in range(4):  # high concurrency → (E=64, C=8)
        hists.append(generate_history(rng, n_procs=8, n_ops=14, crash_p=0.02,
                                      corrupt=i % 2 == 0))
    wide = History([invoke_op(p, "write", 1) for p in range(40)])
    wide.index_ops()  # 40 concurrently open ops > slot_cap: oracle row
    hists.append(wide)
    return hists


def corpus_b():
    """``jepsen_tpu/serve/smoke.py``'s second batch (seed 977)."""
    from ..synth import generate_history

    rng = random.Random(977)
    hists = []
    for i in range(6):
        hists.append(generate_history(rng, n_procs=3, n_ops=12, crash_p=0.02,
                                      corrupt=i % 2 == 0))
    for i in range(4):
        hists.append(generate_history(rng, n_procs=6, n_ops=60, crash_p=0.01,
                                      corrupt=i == 1))
    return hists


# -- daemon processes ---------------------------------------------------------------


def sigkill(client) -> None:
    """SIGKILL the daemon process behind ``client`` and reap it."""
    proc = client.spawned
    try:
        os.kill(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass  # already dead: the gates say why
    proc.wait(timeout=30)


def stop(client) -> None:
    """``/shutdown`` (drains), else SIGKILL; never raises."""
    if client is None or client.spawned is None:
        return
    try:
        client.shutdown()
        client.spawned.wait(timeout=60)
    except Exception:  # noqa: BLE001 — fall back to the hard kill
        sigkill(client)


def tear_tail(path: str) -> None:
    """A crash mid-append: drop any torn tail, then cut the last complete
    line in half (no newline); the read-back must skip it and keep every
    row before it."""
    with open(path, "rb") as f:
        data = f.read()
    complete, _, _ = data.rpartition(b"\n")
    head, _, last = complete.rpartition(b"\n")
    with open(path, "wb") as f:
        if head:
            f.write(head + b"\n")
        f.write(last[: max(1, len(last) // 2)])


def post_check(client, model, histories, opts, rid):
    """``POST /check`` with a caller-chosen request id (the crash drills
    retry one id across daemon lives); ``(code, payload)``."""
    from . import protocol

    body = protocol.check_request(model, histories, opts, req=rid)
    code, resp = client._resilient_post("/check", body)
    return code, protocol.decode_body(resp)


def wait_for(cond, wait_s: float, every: float = 0.05) -> bool:
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(every)
    return bool(cond())


# -- the fault-injecting proxy (the local HTTP seam) ----------------------------------


def _recv_http(conn) -> bytes:
    """One Content-Length-framed HTTP message off a socket."""
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = conn.recv(65536)
        if not chunk:
            return buf
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    n = 0
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"content-length:"):
            n = int(line.split(b":", 1)[1].strip())
    while len(rest) < n:
        chunk = conn.recv(65536)
        if not chunk:
            break
        rest += chunk
    return head + b"\r\n\r\n" + rest


class FaultProxy:
    """TCP proxy between a client and a daemon with three modes:
    ``forward`` (pass-through), ``stall`` (accept and never answer: a
    frozen daemon) and ``drop_response`` (forward the request, swallow
    the answer: a lost reply that forces an idempotent retry)."""

    def __init__(self, upstream_port: int, hold_s: float = 30.0):
        self.upstream = upstream_port
        self.hold_s = hold_s
        self.mode = "forward"
        self.drop_remaining = 0
        self.stalled = 0
        self.dropped = 0
        self._lock = threading.Lock()
        self._release = threading.Event()
        self._stop = threading.Event()
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(16)
        self._srv.settimeout(0.2)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn) -> None:
        up = None
        try:
            conn.settimeout(self.hold_s)
            with self._lock:
                mode = self.mode
                if mode == "stall":
                    self.stalled += 1
            if mode == "stall":
                # hold the client's socket, answer nothing: its deadline
                # budget, not this proxy, must end the wait
                self._release.wait(timeout=self.hold_s)
                return
            data = _recv_http(conn)
            if not data:
                return
            up = socket.create_connection(("127.0.0.1", self.upstream),
                                          timeout=10)
            up.settimeout(REQUEST_S)
            up.sendall(data)
            resp = _recv_http(up)
            with self._lock:
                drop = mode == "drop_response" and self.drop_remaining > 0
                if drop:
                    self.drop_remaining -= 1
                    self.dropped += 1
            if drop:
                return  # the daemon did the work; the client sees EOF
            conn.sendall(resp)
        except OSError:
            pass
        finally:
            for s in (conn, up):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass

    def release(self) -> None:
        """End every stalled connection's hold."""
        self._release.set()

    def close(self) -> None:
        self._stop.set()
        self._release.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self._thread.join(timeout=5)


# -- the harness ------------------------------------------------------------------------


def launches_of(client) -> Dict[str, int]:
    """The daemon's kernel launch counters (``/status``); empty for a
    dead daemon."""
    try:
        launches = client.status().get("kernel_launches") or {}
    except Exception:  # noqa: BLE001 — a dead daemon reports nothing
        return {}
    return {k: int(v) for k, v in launches.items()}


class _Drill:
    """One drill's gates, counters, seconds and final results."""

    def __init__(self, number: int, name: str):
        self.number, self.name = number, name
        self.failures: List[str] = []
        self.gates = 0
        self.counters: Dict[str, float] = {}
        self.launches: Dict[str, int] = {}
        self.results: Dict[str, list] = {}
        self.t0 = time.perf_counter()
        self.seconds = 0.0

    def check(self, cond, msg: str) -> None:
        self.gates += 1
        if not cond:
            self.failures.append(msg)

    def add_launches(self, client, since: Optional[dict] = None) -> None:
        """Add the daemon's own kernel launches (``/status``), less
        ``since`` (its counts when the drill began, for a daemon an
        earlier drill used)."""
        launches = launches_of(client)
        for k, v in launches.items():
            self.launches[k] = (self.launches.get(k, 0) + v
                                - (since or {}).get(k, 0))

    def report(self) -> dict:
        return {"drill": self.number, "name": self.name,
                "ok": not self.failures, "gates": self.gates,
                "failures": list(self.failures),
                "counters": dict(self.counters),
                "launches": {k: v for k, v in sorted(self.launches.items())
                             if v},
                "seconds": self.seconds}


class Harness:
    """The drills' shared state: the device, the corpora and their
    in-process results, the scratch directory."""

    def __init__(self, device: Optional[str], tmp: str,
                 heavy: Optional[dict] = None):
        self.device, self.tmp = device, tmp
        self.light = corpus_a()
        #: drill 1's two routes (full width on the card)
        self.batch = {"dense": (heavy or {}).get("dense", self.light),
                      "frontier": (heavy or {}).get("frontier", self.light)}
        #: the mid-request victim's and the fleet's traffic
        self.victim = (heavy or {}).get("dense") or corpus_b()
        self.batch_v = corpus_b()
        self.engine_opts = {} if device is None else {"device": device}

    def expect(self) -> None:
        """The in-process engine's results on the same device."""
        from .. import models as m
        from ..ops import wgl

        self.model = m.cas_register(0)

        done: Dict[tuple, str] = {}

        def check(hs, route):
            key = (id(hs), route)  # a corpus two drills share runs once
            if key not in done:
                done[key] = canon(wgl.check_batch(
                    self.model, hs, **CONFIGS[route], **self.engine_opts))
            return done[key]

        self.expected = {route: check(self.batch[route], route)
                         for route in CONFIGS}
        self.expected_light = check(self.light, "dense")
        self.expected_victim = check(self.victim, "dense")
        self.expected_v = check(self.batch_v, "dense")

    def spawn(self, port: Optional[int], wal: Optional[str], tag: str,
              wait: bool = True, **kw):
        from . import client as client_mod

        return client_mod.spawn_daemon(
            port, wait_s=START_S, device=self.device, wal=wal,
            log_path=os.path.join(self.tmp, f"daemon-{tag}.log"), wait=wait,
            timeout=REQUEST_S, **kw)


def _drill_kill(h: Harness, d: _Drill, state: dict) -> None:
    """Drill 1: kill -9 mid-request and after settled batches, torn WAL."""
    from . import client as client_mod

    wal = state["wal"]
    client = state["main"]
    victim: dict = {}
    st0 = client.status()

    def post_victim():
        try:
            victim["out"] = post_check(client, h.model, h.victim,
                                       CONFIGS["dense"], "chaos-victim")
        except Exception as e:  # noqa: BLE001 — the gate's subject
            victim["err"] = e

    t0 = time.monotonic()
    t = threading.Thread(target=post_victim, daemon=True)
    t.start()
    # the nemesis: kill -9 once the daemon holds the request
    wait_for(lambda: "out" in victim or "err" in victim
             or client.status().get("requests", 0) > st0.get("requests", 0),
             REQUEST_S, every=0.02)
    time.sleep(0.05)
    d.add_launches(client)
    sigkill(client)
    t.join(timeout=JOIN_S)
    d.check(not t.is_alive(),
            "the client hung after its daemon was SIGKILLed mid-request")
    d.check(time.monotonic() - t0 < JOIN_S,
            "the mid-request kill was not bounded by the client's deadline")
    d.counters["victim_outcome"] = ("completed" if "out" in victim
                                    else "failed bounded")
    # the victim's retries at a dead daemon legitimately trip the breaker
    # (drill 2 holds that); here it would mask the WAL path
    client_mod.reset_breakers()

    # a fresh life settles both routes completely
    client = h.spawn(client.port, wal, "A2")
    settled = {}
    for route, kw in CONFIGS.items():
        code, payload = post_check(client, h.model, h.batch[route], kw,
                                   f"chaos-{route}")
        d.check(code == 200, f"{route}: the first pass returned {code}")
        d.check(canon(payload.get("results") or []) == h.expected[route],
                f"{route}: pre-crash verdicts differ from in-process")
        diag = payload.get("diag") or {}
        settled[route] = diag.get("settled", 0)
        d.check(settled[route] > 0, f"{route}: no settled count in diag")
        d.check(diag.get("replayed") == 0,
                f"{route}: a fresh request claims WAL replays ({diag})")
    d.add_launches(client)
    sigkill(client)  # kill -9 again, now with a fully written WAL
    d.check(os.path.exists(wal), "the verdict WAL was never written")
    tear_tail(wal)

    # restart: retried ids replay the WAL, re-running only the torn row
    client = h.spawn(client.port, wal, "B")
    for route, kw in CONFIGS.items():
        code, payload = post_check(client, h.model, h.batch[route], kw,
                                   f"chaos-{route}")
        d.check(code == 200, f"{route}: the replay pass returned {code}")
        results = payload.get("results") or []
        d.check(canon(results) == h.expected[route],
                f"{route}: post-crash verdicts differ from in-process")
        d.results[route] = results
        diag = payload.get("diag") or {}
        want = settled[route] - (1 if route == "frontier" else 0)
        d.check(diag.get("replayed") == want,
                f"{route}: replayed {diag.get('replayed')} of "
                f"{settled[route]} settled rows, wanted {want}")
        if route == "dense":
            d.check(diag.get("cold_dispatches", 0) == 0
                    and diag.get("warm_dispatches", 0) == 0,
                    f"{route}: the fully replayed request re-dispatched "
                    f"({diag})")
    code, payload = post_check(client, h.model, h.victim, CONFIGS["dense"],
                               "chaos-victim")
    d.check(code == 200 and canon(payload.get("results") or [])
            == h.expected_victim,
            "the victim's retry after kill -9 differs from in-process")
    d.results["victim"] = payload.get("results") or []
    st = client.status()
    want_replayed = (settled["dense"] + settled["frontier"] - 1
                     + (payload.get("diag") or {}).get("replayed", 0))
    d.check(st.get("replayed") == want_replayed,
            f"/status replayed {st.get('replayed')} != {want_replayed}")
    d.check(metric_value(client.metrics_text(),
                         "jepsen_serve_wal_replayed_total") == want_replayed,
            "jepsen_serve_wal_replayed_total does not account the replays")
    d.check(st.get("wal_path") == wal and st.get("wal_rows", 0) > 0,
            f"/status does not advertise the WAL ({st.get('wal_path')}, "
            f"{st.get('wal_rows')})")
    d.counters.update(settled_dense=settled["dense"],
                      settled_frontier=settled["frontier"],
                      replayed=st.get("replayed", 0))
    d.add_launches(client)
    state["main"] = client


def _drill_stall(h: Harness, d: _Drill, state: dict) -> None:
    """Drill 2: a stalled socket, the deadline, the breaker, recovery."""
    from . import ServiceClient, ServiceError
    from . import client as client_mod

    client = state["main"]
    base = launches_of(client)
    client_mod.reset_breakers()
    proxy = state["proxy"] = FaultProxy(client.port)
    proxy.mode = "stall"
    stalled = ServiceClient(port=proxy.port, deadline_s=2.0, backoff_s=0.05,
                            breaker_failures=3, breaker_cooldown_s=1.0)
    br = stalled.breaker
    walls = []
    for i in range(3):
        t0 = time.monotonic()
        try:
            post_check(stalled, h.model, h.batch_v, CONFIGS["dense"],
                       f"chaos-stall-{i}")
            d.check(False, f"stalled call {i} unexpectedly succeeded")
        except ServiceError:
            pass
        walls.append(time.monotonic() - t0)
        d.check(walls[-1] <= 3.5, f"stalled call {i} took {walls[-1]:.1f} s,"
                " past its 2.0 s deadline budget")
    d.check(br.state() == "open",
            f"the breaker did not trip after 3 stalled calls ({br.state()})")
    # a tripped breaker fast-fails ...
    t0 = time.monotonic()
    try:
        post_check(stalled, h.model, h.batch_v, CONFIGS["dense"],
                   "chaos-open")
        d.check(False, "a call through the open breaker went out")
    except ServiceError:
        pass
    fast = time.monotonic() - t0
    d.check(fast <= 0.75, f"the open breaker did not fast-fail ({fast:.2f} s)")
    # ... and the seam falls back in-process, counted and tagged
    res = client_mod.check_batch(h.model, h.batch_v, client=stalled,
                                 **CONFIGS["dense"], **h.engine_opts)
    tags = {r.pop("service-fallback", None) for r in res}
    d.check(tags == {"unavailable"},
            f"fallback results are not tagged as such ({tags})")
    d.check(canon(res) == h.expected_v,
            "open-breaker fallback verdicts differ from in-process")
    d.check(stalled.fallbacks.get("unavailable") == 1,
            f"the fallback was not counted ({stalled.fallbacks})")
    # recovery: un-stall, wait out the cooldown, the half-open probe
    with proxy._lock:
        proxy.mode = "forward"
    proxy.release()
    time.sleep(1.1)
    req0 = client.status().get("requests", 0)
    res = client_mod.check_batch(h.model, h.batch_v, client=stalled,
                                 **CONFIGS["dense"], **h.engine_opts)
    d.check(canon(res) == h.expected_v,
            "post-recovery verdicts differ from in-process")
    d.results["recovered"] = res
    d.check(br.state() == "closed",
            f"the breaker did not close after its half-open probe "
            f"({br.state()})")
    d.check(br.probes >= 1, "recovery never probed /healthz")
    d.check(client.status().get("requests", 0) > req0,
            "the post-recovery request did not reach the daemon")
    d.counters.update(stalled=proxy.stalled, max_stall_s=max(walls),
                      open_fail_s=fast, trips=br.trips, probes=br.probes)
    d.add_launches(client, base)


def _drill_drop(h: Harness, d: _Drill, state: dict) -> None:
    """Drill 3: a dropped response, an idempotent retry, one count."""
    from . import ServiceClient

    client = state["main"]
    proxy = state.get("proxy") or FaultProxy(client.port)
    state["proxy"] = proxy
    dropper = ServiceClient(port=proxy.port, deadline_s=REQUEST_S,
                            backoff_s=0.05)
    base = launches_of(client)
    st0 = client.status()
    with proxy._lock:
        proxy.mode = "drop_response"
        proxy.drop_remaining = 1
    code, payload = post_check(dropper, h.model, h.batch_v, CONFIGS["dense"],
                               "chaos-dedup")
    with proxy._lock:
        proxy.mode = "forward"
    d.check(code == 200 and canon(payload.get("results") or [])
            == h.expected_v,
            "retried-after-drop verdicts differ from in-process")
    d.results["deduped"] = payload.get("results") or []
    st1 = client.status()
    d.check(proxy.dropped == 1, "the proxy never dropped a response")
    d.check(st1.get("requests", 0) - st0.get("requests", 0) == 1,
            f"the duplicate request was counted twice "
            f"({st0.get('requests')} → {st1.get('requests')})")
    d.check(st1.get("deduped", 0) - st0.get("deduped", 0) == 1,
            f"the daemon did not dedupe the retried id "
            f"({st0.get('deduped')} → {st1.get('deduped')})")
    d.check((metric_value(client.metrics_text(),
                          "jepsen_serve_request_dedup_total") or 0) >= 1,
            "jepsen_serve_request_dedup_total does not account the dedup")
    d.counters.update(dropped=proxy.dropped,
                      deduped=st1.get("deduped", 0) - st0.get("deduped", 0))
    d.add_launches(client, base)


def _drill_compact(h: Harness, d: _Drill, state: dict) -> None:
    """Drill 4: WAL auto-compaction, and a crash during compaction."""
    from ..obs import journal

    client = state["compact"]
    wal = state["compact_wal"]
    code, payload = post_check(client, h.model, h.light,
                               CONFIGS["dense"], "chaos-compact")
    d.check(code == 200, f"the compaction prep returned {code}")
    settled = (payload.get("diag") or {}).get("settled", 0)
    d.check(settled > 0, "the compaction prep settled nothing")
    # the device thread compacts on its next idle turn
    st: dict = {}

    def compacted():
        st.update(client.status())
        return st.get("wal_compactions", 0) >= 1

    d.check(wait_for(compacted, 60.0, every=0.2),
            "an idle daemon never compacted a WAL past 1 byte")
    d.check((metric_value(client.metrics_text(),
                          "jepsen_serve_wal_compactions_total") or 0) >= 1,
            "jepsen_serve_wal_compactions_total does not account it")
    d.check(not os.path.exists(wal + ".tmp"), "compaction left its .tmp")
    kept = journal.read_verdict_rows(wal)
    d.check(len(kept) == settled
            and all(r.get("req") == "chaos-compact" for r in kept),
            f"the compacted WAL holds {len(kept)} rows, wanted {settled} "
            "of chaos-compact")
    d.add_launches(client)
    # a crash "mid-compaction": the half-written .tmp a real crash would
    # leave beside the intact WAL; the restart must ignore it
    sigkill(client)
    with open(wal + ".tmp", "w") as f:
        f.write('{"v": 1, "req": "chaos-compact", "stream": "ma')
    client = state["compact"] = h.spawn(client.port, wal, "C2",
                                        wal_compact_bytes=1)
    code, payload = post_check(client, h.model, h.light,
                               CONFIGS["dense"], "chaos-compact")
    diag = payload.get("diag") or {}
    d.check(code == 200 and canon(payload.get("results") or [])
            == h.expected_light,
            "the post-compaction replay differs from in-process")
    d.results["compacted"] = payload.get("results") or []
    d.check(diag.get("replayed") == settled,
            f"the compacted WAL replayed {diag.get('replayed')} of "
            f"{settled} settled rows")
    d.check(diag.get("cold_dispatches", 0) == 0
            and diag.get("warm_dispatches", 0) == 0,
            "the compacted and replayed request re-dispatched")
    d.counters.update(settled=settled, kept_rows=len(kept),
                      compactions=st.get("wal_compactions", 0))


def _drill_fleet(h: Harness, d: _Drill, state: dict) -> None:
    """Drill 5: a fleet member SIGKILLed with a request in flight."""
    from .. import obs
    from . import ServiceClient
    from . import client as client_mod
    from . import router as router_mod

    client_mod.reset_breakers()
    members = state["members"]
    rt = router_mod.Router([f"127.0.0.1:{c.port}" for c in members],
                           port=0, probe_interval_s=3600.0)
    # the prober is parked: every membership change below is this
    # harness's own probe_once() sweep, so the reroute path (a connection
    # error on a member still marked up) runs on purpose, not by luck
    rt.start(block=False)
    try:
        d.check(rt.probe_once() == 2, "the prober missed a live member")
        rclient = ServiceClient(port=rt.port, timeout=REQUEST_S)
        traffic, want = h.victim, h.expected_victim
        req0 = [c.status().get("requests", 0) for c in members]
        res = rclient.check_batch(h.model, traffic, **CONFIGS["dense"])
        d.check(canon(res) == want, "routed verdicts differ from in-process")
        deltas = [c.status().get("requests", 0) - r0
                  for c, r0 in zip(members, req0)]
        owner = max(range(2), key=lambda i: deltas[i])
        sibling = members[1 - owner]

        # kill -9 the key's owner with the routed request in flight
        spill: dict = {}
        own0 = members[owner].status().get("requests", 0)

        def post_spill():
            try:
                c = ServiceClient(port=rt.port, timeout=REQUEST_S)
                spill["res"] = c.check_batch(h.model, traffic,
                                             **CONFIGS["dense"])
            except Exception as e:  # noqa: BLE001 — the gate's subject
                spill["err"] = e

        prom0 = obs.render_prom()
        reroutes0 = metric_value(prom0, "jepsen_route_reroutes_total") or 0
        t0 = time.monotonic()
        t = threading.Thread(target=post_spill, daemon=True)
        t.start()
        wait_for(lambda: "res" in spill or "err" in spill
                 or members[owner].status().get("requests", 0) > own0,
                 REQUEST_S, every=0.02)
        time.sleep(0.05)
        d.add_launches(members[owner])
        sigkill(members[owner])
        t.join(timeout=JOIN_S)
        d.check(not t.is_alive(), "the routed request hung after the kill")
        d.check(canon(spill.get("res") or []) == want,
                f"the member kill lost verdicts "
                f"({spill.get('err') or 'results differ'})")
        d.results["spilled"] = spill.get("res") or []
        d.counters["spill_s"] = time.monotonic() - t0
        # the router still thinks the owner is up: the next request takes
        # the connection-error reroute to the sibling
        res = rclient.check_batch(h.model, traffic, **CONFIGS["dense"])
        d.check(canon(res) == want, "rerouted verdicts differ from in-process")
        reroutes = (metric_value(obs.render_prom(),
                                 "jepsen_route_reroutes_total") or 0)
        d.check(reroutes > reroutes0,
                "the router never counted a reroute for the killed member")
        d.check(rt.probe_once() == 1,
                "a probe sweep still counts the killed member as up")

        # revival on the same port and WAL; on the card every kernel
        # library is built already, so the member starts no nvcc
        if h.device is None:
            from ..ops import _build

            missing = [n for n in _build.SOURCES
                       if not _build.library_path(n).exists()]
            d.check(not missing, f"the revived member would build {missing}")
        t0 = time.monotonic()
        members[owner] = h.spawn(members[owner].port, state["member_wals"][
            owner], f"M{owner}-revived")
        d.counters["revive_s"] = time.monotonic() - t0
        d.check(rt.probe_once() == 2,
                "a probe sweep did not mark the revived member up")
        own0 = members[owner].status().get("requests", 0)
        res = rclient.check_batch(h.model, traffic, **CONFIGS["dense"])
        d.check(canon(res) == want,
                "post-revival routed verdicts differ from in-process")
        d.results["revived"] = res
        st = members[owner].status()
        d.check(st.get("requests", 0) > own0,
                "traffic did not return to the revived key owner")
        d.counters.update(reroutes=reroutes - reroutes0,
                          revived_cold_dispatches=st.get("cold_dispatches",
                                                         0),
                          revived_warm_dispatches=st.get("warm_dispatches",
                                                         0))
        for c in (members[owner], sibling):
            d.add_launches(c)
    finally:
        rt.stop()


DRILLS = {1: ("kill -9 and WAL resume", _drill_kill),
          2: ("stalled socket and breaker", _drill_stall),
          3: ("dropped response and idempotent retry", _drill_drop),
          4: ("WAL auto-compaction and a crash during it", _drill_compact),
          5: ("fleet member SIGKILL and rejoin", _drill_fleet)}

#: this process's fault accounting, read as deltas over the run
CLIENT_METRICS = {
    2: ("jepsen_client_breaker_trips_total",
        "jepsen_client_breaker_probes_total"),
    3: ("jepsen_client_retries_total",),
    5: ("jepsen_route_requests_total", "jepsen_route_reroutes_total"),
}


def run(device: Optional[str] = None, drills: Sequence[int] = (1, 2, 3, 4, 5),
        heavy: Optional[dict] = None, tmp: Optional[str] = None,
        log=print) -> dict:
    """Run the drills; returns ``{"ok", "drills": [report, …],
    "results": {drill: {name: results}}, "seconds"}``.  ``device`` is the
    daemons' and the in-process engine's: None, the default, is the
    current CUDA device and raises ``RuntimeError`` when none executes
    (``platform.ensure_usable_backend``); ``"cpu"`` runs the plain versions;
    ``heavy`` (``{"dense": histories, "frontier": histories}``) replaces
    the reference's small corpora in drills 1 and 5.  Every daemon the
    drills need starts at once, and every process and proxy is stopped
    before it returns."""
    from .. import obs
    from . import client as client_mod

    drills = sorted(set(drills))
    unknown = [n for n in drills if n not in DRILLS]
    if unknown:
        raise ValueError(f"no drill {unknown}: drills are 1-5")
    if device is None:
        from ..platform import ensure_usable_backend

        ensure_usable_backend()
    t_run = time.perf_counter()
    own_tmp = tmp is None
    tmp = tmp or tempfile.mkdtemp(prefix="jepsen-chaos-")
    os.makedirs(tmp, exist_ok=True)
    obs.enable()
    client_mod.reset_breakers()
    h = Harness(device, tmp, heavy)
    state: dict = {"wal": os.path.join(tmp, "verdict-wal.jsonl"),
                   "compact_wal": os.path.join(tmp, "compact",
                                               "verdict-wal.jsonl"),
                   "member_wals": [os.path.join(tmp, f"m{i}",
                                                "verdict-wal.jsonl")
                                   for i in range(2)]}
    reports: List[dict] = []
    results: Dict[int, dict] = {}
    spawned = []
    try:
        # every daemon the drills need starts together
        if set(drills) & {1, 2, 3}:
            state["main"] = h.spawn(None, state["wal"], "A", wait=False)
            spawned.append("main")
        if 4 in drills:
            os.makedirs(os.path.dirname(state["compact_wal"]), exist_ok=True)
            state["compact"] = h.spawn(None, state["compact_wal"], "C",
                                       wait=False, wal_compact_bytes=1)
            spawned.append("compact")
        if 5 in drills:
            state["members"] = []
            for i, w in enumerate(state["member_wals"]):
                os.makedirs(os.path.dirname(w), exist_ok=True)
                state["members"].append(h.spawn(None, w, f"M{i}",
                                                wait=False))
        h.expect()  # the in-process results, while the daemons start
        for c in ([state[k] for k in spawned]
                  + list(state.get("members", ()))):
            client_mod.wait_healthy(c, START_S)
        for n in drills:
            name, fn = DRILLS[n]
            d = _Drill(n, name)
            prom0 = obs.render_prom()
            try:
                fn(h, d, state)
            except Exception as e:  # noqa: BLE001 — a gate, not a crash
                d.failures.append(f"raised {type(e).__name__}: {e}")
            prom = obs.render_prom()
            for metric in CLIENT_METRICS.get(n, ()):
                delta = ((metric_value(prom, metric) or 0)
                         - (metric_value(prom0, metric) or 0))
                d.counters[metric] = delta
                d.check(delta >= 1, f"this process never counted {metric}")
            d.seconds = time.perf_counter() - d.t0
            reports.append(d.report())
            results[n] = d.results
            log(json.dumps(reports[-1], sort_keys=True, default=str))
    finally:
        if state.get("proxy") is not None:
            state["proxy"].close()
        for c in ([state.get("main"), state.get("compact")]
                  + list(state.get("members", ()))):
            stop(c)
        if own_tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    return {"ok": all(r["ok"] for r in reports), "drills": reports,
            "results": results, "seconds": time.perf_counter() - t_run}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.serve.chaos",
        description="the service's self-chaos drills: kill -9 with a torn "
        "WAL, a stalled socket and the breaker, a dropped response, WAL "
        "compaction under a crash, a fleet member's death")
    p.add_argument("--device", default=None,
                   help="the daemons' and the in-process engine's device "
                   "(default: the current CUDA device; 'cpu' runs the "
                   "plain versions)")
    p.add_argument("--drills", default="1,2,3,4,5",
                   help="comma-separated drill numbers (default all five)")
    args = p.parse_args(argv)
    try:
        drills = [int(x) for x in args.drills.split(",") if x.strip()]
    except ValueError:
        p.error(f"--drills takes numbers, got {args.drills!r}")
    try:
        out = run(device=args.device, drills=drills)
    except ValueError as e:
        p.error(str(e))
    except RuntimeError as e:
        print(f"python -m jepsen_tpu_torch.serve.chaos: {e}", file=sys.stderr)
        return 1
    for r in out["drills"]:
        for f in r["failures"]:
            print(f"chaos: drill {r['drill']} FAIL — {f}", file=sys.stderr)
    print(f"chaos: {'ok' if out['ok'] else 'FAILED'} "
          f"({sum(r['gates'] for r in out['drills'])} gates over "
          f"{len(out['drills'])} drills in {out['seconds']:.1f} s)")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
