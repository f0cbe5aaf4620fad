"""The fleet's routing front — the port of :mod:`jepsen_tpu.serve.router`:
one process that holds no device, only the map from a request's shape key
to the daemon of the fleet that serves it.

It **rendezvous-hashes** each request's shape key (the wire model, the
planning options and the power-of-two history-length buckets for
``/check``; the graphs' vertex buckets for ``/elle``), so same-shape
traffic of different clients lands on one member and coalesces there,
while different shapes spread.  Removing or adding a member moves only
that member's share of keys.  Each member's weight is ``1 − busy`` from
its ``/status`` (:func:`weight_from_busy`), read by a background prober
with its ``/healthz``.

In a key's rendezvous order:

- a member whose breaker is open (:class:`~.client.CircuitBreaker`) is
  skipped without a connection attempt
  (``jepsen_route_spillover_total``);
- a connection failure records on the breaker, marks the member down and
  reroutes the same request to the next member
  (``jepsen_route_reroutes_total``): clients send idempotent request
  ids, so a request half-run on a dying member is recomputed (or replayed
  from the WAL) by its sibling, never counted twice;
- members the prober marked down are tried last;
- a member's HTTP answers (a 503 included) pass through unchanged, and
  the router answers 503 itself only when every member failed;
- ``/feed`` sessions are pinned to the member that opened them: a
  session's state lives there.

Bodies pass through as bytes both ways; a body is decoded once, read
only, for its key.  Every setting is an argument or a flag of ``python -m
jepsen_tpu_torch.serve.router``; nothing is read from the environment.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import math
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from .. import obs
from . import protocol
from .client import (DEFAULT_BREAKER_COOLDOWN_S, DEFAULT_BREAKER_FAILURES,
                     DEFAULT_CLIENT_TIMEOUT_S, breaker_for, probe_healthz)

#: how often the prober reads every member's /healthz and /status
DEFAULT_PROBE_INTERVAL_S = 1.0
#: one probe's timeout (a local liveness check, not device work)
DEFAULT_PROBE_TIMEOUT_S = 0.5

#: the weight floor: a fully busy member still wins some keys (starving
#: it would move its whole share at once)
MIN_ROUTE_WEIGHT = 0.05

#: sha1 digests span [0, 2^160); +1 and +2 keep the fraction inside (0, 1)
_HASH_SPAN = float(1 << 160)


def weight_from_busy(busy: Optional[float]) -> float:
    """A member's routing weight for its reported device-busy ratio:
    ``max(MIN_ROUTE_WEIGHT, 1 − clamp(busy, 0, 1))``; no report (None) is
    neutral, 1.0."""
    if busy is None:
        return 1.0
    return max(MIN_ROUTE_WEIGHT, 1.0 - min(1.0, max(0.0, busy)))


def rendezvous_order(members: List[str], key: str,
                     weights: Optional[Dict[str, float]] = None
                     ) -> List[str]:
    """Members by descending weighted rendezvous score for ``key``:
    ``-w / ln(u)`` with ``u`` the sha1 of ``member|key`` as a fraction of
    (0, 1), so a member's expected share of keys is proportional to its
    weight (missing weights are 1.0, floored at
    :data:`MIN_ROUTE_WEIGHT`).  With equal weights this is the digests'
    descending order."""
    def score(m: str):
        h = int(hashlib.sha1(f"{m}|{key}".encode()).hexdigest(), 16)
        w = 1.0
        if weights:
            w = max(MIN_ROUTE_WEIGHT, float(weights.get(m, 1.0)))
        u = (h + 1.0) / (_HASH_SPAN + 2.0)
        return (-w / math.log(u), h)

    return sorted(members, key=score, reverse=True)


def _pow2_bucket(n: int) -> int:
    return 1 << (max(1, int(n)) - 1).bit_length()


def check_route_key(payload: dict) -> str:
    """A ``/check`` body's shape key: the wire model, the serviceable
    options and the sorted power-of-two buckets of the history lengths —
    what decides the planner's shape buckets, without encoding."""
    opts = payload.get("opts") or {}
    buckets = sorted(_pow2_bucket(len(h))
                     for h in (payload.get("histories") or []))
    return json.dumps(
        ["check", payload.get("model"),
         {k: opts.get(k) for k in protocol.CHECK_OPTS if k in opts},
         buckets],
        sort_keys=True, default=repr)


def elle_route_key(payload: dict) -> str:
    """An ``/elle`` body's shape key: the sorted power-of-two buckets of
    its graphs' vertex counts."""
    buckets = sorted(_pow2_bucket(len(g.get("rel") or ()))
                     for g in (payload.get("graphs") or []))
    return json.dumps(["elle", buckets], sort_keys=True)


class RouteError(Exception):
    """A connection-level forward failure (an HTTP error status is an
    answer, not this)."""


class Router:
    """The routing front over ``members`` (``HOST:PORT`` each).
    ``start(block=False)`` returns once the listener and the prober run;
    ``port`` then holds the bound port.  ``breaker_failures`` and
    ``breaker_cooldown_s`` make each member's breaker (shared by address
    with every client of this process)."""

    def __init__(self, members: List[str],
                 host: str = protocol.DEFAULT_HOST, port: int = 0, *,
                 probe_interval_s: float = DEFAULT_PROBE_INTERVAL_S,
                 probe_timeout_s: float = DEFAULT_PROBE_TIMEOUT_S,
                 forward_timeout_s: float = DEFAULT_CLIENT_TIMEOUT_S,
                 breaker_failures: int = DEFAULT_BREAKER_FAILURES,
                 breaker_cooldown_s: float = DEFAULT_BREAKER_COOLDOWN_S):
        if not members:
            raise ValueError("a router needs at least one member")
        self.members = list(dict.fromkeys(members))
        self.host = host
        self.port = port
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.forward_timeout_s = forward_timeout_s
        self.breaker_failures = breaker_failures
        self.breaker_cooldown_s = breaker_cooldown_s
        self.t_start = time.time()
        self._lock = threading.Lock()
        #: liveness by member; optimistic until the first probe
        self._up: Dict[str, bool] = {m: True for m in self.members}
        #: routing weights by member (neutral until a status says busy)
        self._weights: Dict[str, float] = {m: 1.0 for m in self.members}
        #: feed session id → the member holding its state
        self._pins: Dict[str, str] = {}
        self._stopping = threading.Event()
        self._server: Optional[ThreadingHTTPServer] = None
        self._prober: Optional[threading.Thread] = None

    # -- membership (the prober thread) ------------------------------------

    def _probe_loop(self) -> None:
        while not self._stopping.is_set():
            self.probe_once()
            self._stopping.wait(self.probe_interval_s)

    def probe_once(self) -> int:
        """One sweep: each member's ``/healthz`` and, for a live one, its
        busy ratio from ``/status`` (its weight; an unreadable status is
        neutral).  Returns the members up."""
        n_up = 0
        for m in self.members:
            ok = probe_healthz(m, timeout=self.probe_timeout_s)
            if ok:
                n_up += 1
            else:
                obs.count("jepsen_route_probe_failures_total", member=m)
            weight = weight_from_busy(self._member_busy_ratio(m)) if ok \
                else 1.0
            obs.gauge_set("jepsen_route_weight", weight, member=m)
            with self._lock:
                self._up[m] = ok
                self._weights[m] = weight
        obs.gauge_set("jepsen_route_members_up", n_up)
        return n_up

    def _member_busy_ratio(self, member: str) -> Optional[float]:
        """``live.device_busy_ratio`` from a member's ``/status``, or None
        (no answer, no number); never raises."""
        try:
            with urllib.request.urlopen(
                    f"http://{member}/status",
                    timeout=self.probe_timeout_s) as resp:
                payload = json.loads(resp.read().decode("utf-8"))
            busy = (payload.get("live") or {}).get("device_busy_ratio")
            return float(busy) if isinstance(busy, (int, float)) else None
        except Exception:  # noqa: BLE001 — any failure reads as neutral
            return None

    def _candidates(self, key: str) -> List[str]:
        """Every member in the order ``key`` tries them: live members by
        weighted rendezvous rank, then members marked down (the prober may
        lag a revived member)."""
        with self._lock:
            up = dict(self._up)
            weights = dict(self._weights)
        order = rendezvous_order(self.members, key, weights)
        return ([m for m in order if up.get(m)]
                + [m for m in order if not up.get(m)])

    # -- forwarding (handler threads) --------------------------------------

    def _send(self, member: str, path: str,
              body: bytes) -> Tuple[int, bytes]:
        """POST raw bytes to one member: an HTTP status is returned as
        the answer, a connection failure raises :class:`RouteError`."""
        req = urllib.request.Request(
            f"http://{member}{path}", data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.forward_timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except (urllib.error.URLError, OSError,
                http.client.HTTPException) as e:
            raise RouteError(f"{member}: {e!r}") from e

    def _breaker(self, member: str):
        host, _, port = member.rpartition(":")
        return breaker_for(host, int(port), self.breaker_failures,
                           self.breaker_cooldown_s)

    def forward(self, path: str, body: bytes, key: Optional[str],
                pinned: Optional[str] = None) -> Tuple[int, bytes]:
        """Route one request through ``key``'s candidates (or only the
        ``pinned`` member); returns the answering member's status and
        bytes, or a 503 of the router's own when every member failed."""
        code, resp, _ = self._forward(path, body, key, pinned)
        return code, resp

    def _forward(self, path: str, body: bytes, key: Optional[str],
                 pinned: Optional[str] = None
                 ) -> Tuple[int, bytes, Optional[str]]:
        cands = [pinned] if pinned is not None else self._candidates(key)
        errors = []
        for member in cands:
            br = self._breaker(member)
            if not br.allow(lambda m=member: probe_healthz(
                    m, timeout=self.probe_timeout_s)):
                obs.count("jepsen_route_spillover_total", member=member)
                errors.append(f"{member}: breaker open")
                continue
            try:
                code, resp = self._send(member, path, body)
            except RouteError as e:
                br.record_failure()
                with self._lock:
                    self._up[member] = False
                obs.count("jepsen_route_reroutes_total", member=member)
                errors.append(str(e))
                continue
            br.record_success()
            obs.count("jepsen_route_requests_total", member=member)
            return code, resp, member
        return 503, protocol.encode_body({
            "error": "no live fleet member",
            "members": list(self.members),
            "detail": errors[-3:],
        }), None

    # -- per endpoint ------------------------------------------------------

    def route_check(self, body: bytes) -> Tuple[int, bytes]:
        try:
            key = check_route_key(protocol.decode_body(body))
        except Exception:  # noqa: BLE001 — a malformed body still goes
            # to one member, whose 400 answers it
            key = "check|malformed"
        return self.forward("/check", body, key)

    def route_elle(self, body: bytes) -> Tuple[int, bytes]:
        try:
            key = elle_route_key(protocol.decode_body(body))
        except Exception:  # noqa: BLE001 — as in route_check
            key = "elle|malformed"
        return self.forward("/elle", body, key)

    def route_feed(self, body: bytes) -> Tuple[int, bytes]:
        """``open`` hashes its (model, options) key and pins the session
        id to the member that answered; ``append`` and ``close`` follow
        the pin (without one, the session id's own key: a restarted
        router derives the same member)."""
        try:
            payload = protocol.decode_body(body)
            fop = payload.get("op")
        except Exception:  # noqa: BLE001 — as in route_check
            return self.forward("/feed", body, "feed|malformed")
        if fop == "open":
            key = json.dumps(["feed", payload.get("model"),
                              payload.get("opts")],
                             sort_keys=True, default=repr)
            code, resp, member = self._forward("/feed", body, key)
            if code == 200 and member is not None:
                try:
                    sid = protocol.decode_body(resp).get("session")
                except Exception:  # noqa: BLE001 — not a session answer
                    sid = None
                if sid:
                    with self._lock:
                        self._pins[sid] = member
            return code, resp
        sid = payload.get("session")
        with self._lock:
            pinned = self._pins.get(sid)
        if pinned is not None:
            code, resp = self.forward("/feed", body, None, pinned=pinned)
        else:
            code, resp = self.forward("/feed", body, f"feed-session|{sid}")
        if fop == "close" and code == 200:
            with self._lock:
                self._pins.pop(sid, None)
        return code, resp

    # -- status --------------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            up = dict(self._up)
            weights = dict(self._weights)
            pins = len(self._pins)
        return {
            "role": "router",
            "ok": any(up.values()),
            "pid": os.getpid(),
            "uptime_s": round(time.time() - self.t_start, 1),
            "members": [{"member": m, "up": bool(up.get(m)),
                         "weight": weights.get(m, 1.0),
                         "breaker": self._breaker(m).state()}
                        for m in self.members],
            "feed_pins": pins,
            "probe_interval_s": self.probe_interval_s,
        }

    # -- lifecycle -------------------------------------------------------------

    def start(self, block: bool = True) -> "Router":
        obs.enable()  # the live /metrics needs the registry recording
        self._server = ThreadingHTTPServer((self.host, self.port),
                                           _make_handler(self))
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._prober = threading.Thread(target=self._probe_loop,
                                        name="jepsen-route-probe",
                                        daemon=True)
        self._prober.start()
        if block:
            print(f"jepsen_tpu_torch fleet router on "
                  f"http://{self.host}:{self.port}/ -> "
                  f"{', '.join(self.members)} (pid {os.getpid()})",
                  flush=True)
            try:
                self._server.serve_forever()
            finally:
                self.stop()
        else:
            threading.Thread(target=self._server.serve_forever,
                             daemon=True).start()
        return self

    def request_shutdown(self) -> dict:
        """Stop the router from a helper thread (the calling handler still
        writes its answer).  The members keep serving: each stops on its
        own ``POST /shutdown``."""
        already = self._stopping.is_set()
        self._stopping.set()
        if not already and self._server is not None:
            threading.Thread(target=self._finish_stop, daemon=True).start()
        return {"ok": True, "role": "router"}

    def _finish_stop(self) -> None:
        time.sleep(0.05)
        self._server.shutdown()

    def stop(self) -> None:
        self._stopping.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._prober is not None:
            self._prober.join(timeout=5)


def _make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, payload: dict):
            self._reply(code, protocol.encode_body(payload))

        def do_GET(self):  # noqa: N802 — http.server API
            try:
                if self.path == "/healthz":
                    st = router.status()
                    self._reply_json(200 if st["ok"] else 500, {
                        "ok": st["ok"], "role": "router",
                        "uptime_s": st["uptime_s"]})
                elif self.path == "/status":
                    self._reply_json(200, router.status())
                elif self.path == "/metrics":
                    self._reply(200, obs.render_prom().encode(),
                                "text/plain; version=0.0.4")
                else:
                    self._reply_json(404, {"error": "not found"})
            except BrokenPipeError:
                pass

        def do_POST(self):  # noqa: N802 — http.server API
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                if self.path == "/check":
                    self._reply(*router.route_check(body))
                elif self.path == "/elle":
                    self._reply(*router.route_elle(body))
                elif self.path == "/feed":
                    self._reply(*router.route_feed(body))
                elif self.path == "/shutdown":
                    self._reply_json(200, router.request_shutdown())
                else:
                    self._reply_json(404, {"error": "not found"})
            except BrokenPipeError:
                pass

        def log_message(self, fmt, *args):
            pass  # the router's metrics are its log

    return Handler


def main(argv=None) -> int:
    """``python -m jepsen_tpu_torch.serve.router --member HOST:PORT …``."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.serve.router",
        description="the fleet's routing front: /check, /elle and /feed "
        "spread over the members by rendezvous hashing")
    p.add_argument("--member", action="append", required=True,
                   metavar="HOST:PORT", help="a fleet daemon (repeatable)")
    p.add_argument("--host", default=protocol.DEFAULT_HOST,
                   help="bind address (default 127.0.0.1)")
    p.add_argument("--port", type=int, default=protocol.DEFAULT_PORT,
                   help=f"TCP port (default {protocol.DEFAULT_PORT}: "
                   "clients reach the fleet where they reach one daemon)")
    p.add_argument("--probe-interval", type=float,
                   default=DEFAULT_PROBE_INTERVAL_S, metavar="S",
                   help="seconds between probes of every member's /healthz "
                   f"and /status (default {DEFAULT_PROBE_INTERVAL_S})")
    p.add_argument("--probe-timeout", type=float,
                   default=DEFAULT_PROBE_TIMEOUT_S, metavar="S",
                   help="one probe's timeout in seconds (default "
                   f"{DEFAULT_PROBE_TIMEOUT_S})")
    args = p.parse_args(argv)
    Router(args.member, host=args.host, port=args.port,
           probe_interval_s=args.probe_interval,
           probe_timeout_s=args.probe_timeout).start(block=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
