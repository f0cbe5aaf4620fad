"""Client side of the resident checker service — the port of
:mod:`jepsen_tpu.serve.client`, with its online sessions
(:meth:`ServiceClient.open_feed`, :class:`FeedSession`), the verdict
channel (:meth:`ServiceClient.watch`) and the fleet table
(:func:`format_fleet_status`).

:class:`ServiceClient` is the HTTP client of one daemon address, and
:func:`check_batch` the seam: the daemon when the client reaches it, the
in-process engine otherwise.  The in-process engine is the port's CUDA
engine on the caller's device, the same ``wgl.check_batch`` the daemon
runs, so a verdict cannot depend on which side computed it.  A fallback
is never silent: the client counts it by reason
(:attr:`ServiceClient.fallbacks`, ``jepsen_client_fallback_total``) and
each result it produced carries ``"service-fallback": <reason>``.

Resilience: every ``/check`` and ``/elle`` POST carries an idempotent
request id and runs through bounded exponential backoff with jitter
under one deadline, behind a per-address :class:`CircuitBreaker` (after
``failures`` consecutive connection failures it opens; after its
cooldown one ``/healthz`` probe decides).  An open breaker fails fast
with :class:`ServiceUnavailable`.  Every knob is an argument; nothing is
read from the environment.
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .. import obs
from ..obs import propagate
from . import protocol
from .protocol import UnsupportedModel  # noqa: F401 (re-export)

#: per-attempt socket timeout: a little above the daemon's own request
#: timeout, so a healthy daemon's answer comes first and a frozen one
#: still bounds the run
DEFAULT_CLIENT_TIMEOUT_S = 630.0
DEFAULT_CLIENT_RETRIES = 2
DEFAULT_CLIENT_BACKOFF_S = 0.1
DEFAULT_BREAKER_FAILURES = 3
DEFAULT_BREAKER_COOLDOWN_S = 5.0

#: the repository root: a spawned daemon runs ``python -m
#: jepsen_tpu_torch.serve`` from here
_ROOT = Path(__file__).resolve().parents[2]


class ServiceError(Exception):
    """The daemon was reachable but did not serve the request."""


class ServiceUnavailable(ServiceError):
    """No healthy daemon at the address."""


class CircuitBreaker:
    """Per-address breaker: closed → open after ``failures`` consecutive
    connection failures → half-open after ``cooldown_s``, where one probe
    decides (success closes, failure re-opens).  Shared by every client
    of one address (:func:`breaker_for`)."""

    def __init__(self, failures: int = DEFAULT_BREAKER_FAILURES,
                 cooldown_s: float = DEFAULT_BREAKER_COOLDOWN_S):
        self.failures = max(1, failures)
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self.trips = 0  #: times the breaker opened
        self.probes = 0  #: half-open probes run

    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if time.monotonic() - self._opened_at >= self.cooldown_s:
                return "half-open"
            return "open"

    def allow(self, probe=None) -> bool:
        """Whether a request may go: closed yes, open within the cooldown
        no (the probe is not run), half-open as ``probe()`` says."""
        with self._lock:
            if self._opened_at is None:
                return True
            if time.monotonic() - self._opened_at < self.cooldown_s:
                return False
        ok = bool(probe()) if probe is not None else False  # I/O unlocked
        with self._lock:
            self.probes += 1
            if ok:
                self._opened_at = None
                self._consecutive = 0
                return True
            self._opened_at = time.monotonic()
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            self._opened_at = None

    def record_failure(self) -> bool:
        """Count one connection failure; True when it opened the
        breaker."""
        with self._lock:
            self._consecutive += 1
            if self._opened_at is None and self._consecutive >= self.failures:
                self._opened_at = time.monotonic()
                self.trips += 1
                return True
            return False


_BREAKERS: Dict[Tuple[str, int], CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(host: str, port: int,
                failures: int = DEFAULT_BREAKER_FAILURES,
                cooldown_s: float = DEFAULT_BREAKER_COOLDOWN_S
                ) -> CircuitBreaker:
    """The process-wide breaker of one address (made with ``failures``
    and ``cooldown_s`` by its first caller)."""
    with _breakers_lock:
        br = _BREAKERS.get((host, port))
        if br is None:
            br = _BREAKERS[(host, port)] = CircuitBreaker(failures,
                                                          cooldown_s)
        return br


def reset_breakers() -> None:
    """Forget every breaker's state."""
    with _breakers_lock:
        _BREAKERS.clear()


def probe_healthz(addr: str, timeout: float = 0.5) -> bool:
    """The ``/healthz`` probe of ``HOST:PORT``: a connection failure, a
    malformed answer and a malformed body all mean down.  A malformed
    answer includes the probe's own request read back: polling a free
    loopback port in the ephemeral range before its daemon binds it can
    connect the probe's socket to itself.  Counted in
    ``jepsen_probe_healthz_total`` by outcome; never raises."""
    req = urllib.request.Request(f"http://{addr}/healthz", method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            ok = (resp.status == 200
                  and bool(protocol.decode_body(resp.read()).get("ok")))
    except (urllib.error.URLError, http.client.HTTPException,
            ConnectionError, OSError, ValueError, AttributeError):
        ok = False
    obs.count("jepsen_probe_healthz_total", outcome="up" if ok else "down")
    return ok


class ServiceClient:
    """HTTP client of one daemon address.  ``timeout`` bounds each
    attempt, ``deadline_s`` the whole call with its retries and backoff
    sleeps; ``retries`` and ``backoff_s`` shape the retries of connection
    failures; ``breaker_failures`` and ``breaker_cooldown_s`` make the
    address's breaker."""

    def __init__(self, host: str = protocol.DEFAULT_HOST,
                 port: int = protocol.DEFAULT_PORT, *,
                 timeout: Optional[float] = None,
                 deadline_s: float = DEFAULT_CLIENT_TIMEOUT_S,
                 retries: int = DEFAULT_CLIENT_RETRIES,
                 backoff_s: float = DEFAULT_CLIENT_BACKOFF_S,
                 breaker_failures: int = DEFAULT_BREAKER_FAILURES,
                 breaker_cooldown_s: float = DEFAULT_BREAKER_COOLDOWN_S):
        self.host = host
        self.port = int(port)
        self.timeout = timeout
        self.deadline_s = deadline_s
        self.retries = max(0, int(retries))
        self.backoff_s = backoff_s
        self.breaker = breaker_for(self.host, self.port, breaker_failures,
                                   breaker_cooldown_s)
        self.last_diag: dict = {}
        #: the process :func:`spawn_daemon` started for this client
        self.spawned = None
        self._lock = threading.Lock()
        #: batches this client's seam ran in-process, by reason
        self.fallbacks: Dict[str, int] = {}

    def _url(self, path: str) -> str:
        return f"http://{self.host}:{self.port}{path}"

    def count_fallback(self, reason: str) -> None:
        with self._lock:
            self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
        obs.count("jepsen_client_fallback_total", reason=reason)

    def _request(self, path: str, body: Optional[bytes] = None,
                 timeout: Optional[float] = None):
        req = urllib.request.Request(
            self._url(path), data=body,
            method="POST" if body is not None else "GET",
            headers={"Content-Type": "application/json"}
            if body is not None else {},
        )
        try:
            with urllib.request.urlopen(
                    req, timeout=timeout or self.timeout
                    or DEFAULT_CLIENT_TIMEOUT_S) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise ServiceUnavailable(f"no daemon at {self._url('')}: {e}")

    def _resilient_post(self, path: str, body: bytes):
        """POST with retries, backoff and one deadline through the
        address's breaker.  The body (and its request id) is the same on
        every attempt, so the daemon can deduplicate.  Only connection
        failures retry: an HTTP answer (503, 500) is the daemon's."""
        br = self.breaker
        if not br.allow(self._probe):
            raise ServiceUnavailable(
                f"circuit open for {self.host}:{self.port} "
                f"(state {br.state()})")
        attempt_timeout = self.timeout or DEFAULT_CLIENT_TIMEOUT_S
        budget = min(self.deadline_s,
                     attempt_timeout if self.timeout else float("inf"))
        deadline = time.monotonic() + budget
        attempt = 0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                obs.count("jepsen_client_deadline_exhausted_total")
                raise ServiceUnavailable(
                    f"deadline budget ({budget:.1f}s) exhausted for "
                    f"{self._url(path)}")
            try:
                code, resp = self._request(
                    path, body=body, timeout=min(attempt_timeout, remaining))
            except ServiceUnavailable:
                if br.record_failure():
                    obs.count("jepsen_client_breaker_trips_total")
                attempt += 1
                remaining = deadline - time.monotonic()
                delay = min(self.backoff_s * (2 ** (attempt - 1)), remaining)
                delay *= 0.5 + random.random() / 2  # jitter
                if attempt > self.retries or remaining <= delay:
                    raise
                obs.count("jepsen_client_retries_total")
                time.sleep(delay)
                continue
            br.record_success()
            return code, resp

    def _probe(self) -> bool:
        """The half-open probe (cheap, hard-bounded)."""
        obs.count("jepsen_client_breaker_probes_total")
        return self.healthy(timeout=0.5)

    def healthy(self, timeout: float = 0.5) -> bool:
        return probe_healthz(f"{self.host}:{self.port}", timeout=timeout)

    def _get(self, path: str, what: str):
        code, body = self._request(path, timeout=self.timeout or 5)
        if code != 200:
            raise ServiceError(f"{what} returned {code}")
        return body

    def status(self) -> dict:
        return protocol.decode_body(self._get("/status", "status"))

    def metrics_text(self) -> str:
        return self._get("/metrics", "metrics").decode()

    def shutdown(self) -> dict:
        code, body = self._request("/shutdown", body=b"{}",
                                   timeout=self.timeout or 5)
        if code != 200:
            raise ServiceError(f"shutdown returned {code}")
        return protocol.decode_body(body)

    def profile(self, seconds: float = 1.0, label: str = "",
                out_dir: Optional[str] = None) -> dict:
        """``POST /profile``: one bounded profiling window on the daemon;
        returns ``{dir, manifest}``."""
        req: dict = {"seconds": float(seconds)}
        if label:
            req["label"] = str(label)
        if out_dir:
            req["dir"] = out_dir
        code, body = self._request(
            "/profile", body=protocol.encode_body(req),
            timeout=max(self.timeout or 0.0, float(seconds) + 30.0))
        if code != 200:
            raise ServiceError(f"profile returned {code}")
        return protocol.decode_body(body)

    def _trace_ctx(self, span) -> Optional[dict]:
        """The wire ``trace_ctx`` of a client span; None when tracing is
        off (an untraced run sends the plain body)."""
        sid = getattr(span, "sid", None)
        if not obs.enabled() or sid is None:
            return None
        ctx = propagate.make_ctx(parent_sid=sid)
        span.set(propagate.ATTR_TRACE_ID, ctx["trace_id"])
        span.set(propagate.ATTR_ROLE, "client")
        return ctx

    def fetch_trace(self, trace_id: str) -> int:
        """Adopt the daemon's spans of ``trace_id`` (``GET /trace?ctx=``)
        into the local tracer; telemetry never fails a run."""
        try:
            code, body = self._request(f"/trace?ctx={trace_id}",
                                       timeout=self.timeout or 5)
            if code != 200:
                return 0
            payload = protocol.decode_body(body)
            return propagate.adopt(
                payload.get("spans") or [], pid=payload.get("pid"),
                wall_origin=payload.get("wall_origin"),
                origin_ns=payload.get("origin_ns"))
        except (ServiceError, ValueError, KeyError, TypeError):
            return 0

    def _post_checked(self, path: str, body: bytes, n: int) -> list:
        code, resp = self._resilient_post(path, body)
        payload = protocol.decode_body(resp)
        if code == 503:
            raise ServiceError(f"daemon backlogged: {payload.get('error')}")
        if code != 200:
            raise ServiceError(f"{path} returned {code}: "
                               f"{payload.get('error')}")
        results = payload["results"]
        if len(results) != n:
            raise ServiceError(f"result count {len(results)} != batch {n}")
        self.last_diag = payload.get("diag") or {}
        return results

    def screen_graphs(self, encs) -> list:
        """Screen encoded dependency graphs on the daemon (``POST
        /elle``): the ``ScreenResult`` list ``ops.cycles.screen_graphs``
        returns.  Raises like :meth:`check_batch`."""
        with obs.span("client/elle", cat="serve", graphs=len(encs)) as sp:
            ctx = self._trace_ctx(sp)
            body = protocol.elle_request(encs, trace_ctx=ctx,
                                         req=protocol.request_id())
            out = protocol.elle_results_from_wire(
                self._post_checked("/elle", body, len(encs)), encs)
        if ctx:
            self.fetch_trace(ctx["trace_id"])
        return out

    def check_batch(self, model, histories, **opts) -> List[dict]:
        """Check a batch on the daemon; raises :class:`UnsupportedModel`
        (no wire form, or an opt the wire does not carry),
        :class:`ServiceUnavailable` or :class:`ServiceError`."""
        with obs.span("client/check", cat="serve",
                      histories=len(histories)) as sp:
            ctx = self._trace_ctx(sp)
            body = protocol.check_request(model, histories, opts,
                                          trace_ctx=ctx,
                                          req=protocol.request_id())
            results = self._post_checked("/check", body, len(histories))
        if ctx:
            self.fetch_trace(ctx["trace_id"])
        return results

    def open_feed(self, model, opts: Optional[dict] = None,
                  req: Optional[str] = None) -> "FeedSession":
        """Open an online session (``POST /feed``, op ``open``).  ``req``
        is the session id and the WAL run id: reopening with the same id
        after a daemon restart resumes against the replayed verdicts."""
        return FeedSession(self, model, opts=opts, req=req).open()

    def watch(self, last_id: int = -1, timeout: Optional[float] = None):
        """Subscribe to the verdict channel (``GET /watch``) and yield
        ``(offset, row)`` as verdicts settle.  One generator is one
        connection; ``last_id`` ≥ 0 resumes after that WAL row.  The
        generator ends when the connection closes or the read
        ``timeout`` passes with the daemon quiet (reconnect with the last
        offset seen).  Raises :class:`ServiceError` on an HTTP error (404
        without a WAL) and :class:`ServiceUnavailable` when the first
        connection fails."""
        headers = {"Last-Event-ID": str(last_id)} if last_id >= 0 else {}
        request = urllib.request.Request(self._url("/watch"),
                                         headers=headers)
        try:
            resp = urllib.request.urlopen(
                request, timeout=timeout or self.timeout or 30.0)
        except urllib.error.HTTPError as e:
            raise ServiceError(f"/watch returned {e.code}")
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise ServiceUnavailable(
                f"no daemon at {self._url('/watch')}: {e}")
        try:
            event_id = data = None
            for raw in resp:
                line = raw.decode("utf-8", "replace").rstrip("\r\n")
                if not line:  # a blank line ends one event
                    if data is not None:
                        try:
                            row = json.loads(data)
                        except ValueError:
                            row = None
                        if isinstance(row, dict):
                            try:
                                off = int(event_id)
                            except (TypeError, ValueError):
                                off = -1
                            yield off, row
                    event_id = data = None
                elif line.startswith(":"):
                    pass  # keep-alive comment
                elif line.startswith("id:"):
                    event_id = line[3:].strip()
                elif line.startswith("data:"):
                    chunk = line[5:].strip()
                    data = chunk if data is None else data + chunk
        except OSError:
            return  # the connection closed: end of stream
        finally:
            resp.close()


class FeedSession:
    """The client half of one online session.  Each append carries a
    ``seq`` that advances only on a 200, so retrying a failed append is
    safe: the daemon acknowledges a ``seq`` it already ingested without
    ingesting it again."""

    def __init__(self, client: ServiceClient, model,
                 opts: Optional[dict] = None, req: Optional[str] = None):
        self.client = client
        self.model = model
        self.opts = dict(opts or {})
        self.req = req or protocol.request_id()
        self.sid: Optional[str] = None
        self.seq = 0
        self.resumed = False
        self.closed = False
        self.last_diag: dict = {}

    def _post(self, body: bytes, what: str) -> dict:
        code, resp = self.client._resilient_post("/feed", body)
        payload = protocol.decode_body(resp)
        if code == 503:
            raise ServiceError(f"daemon backlogged: {payload.get('error')}")
        if code != 200:
            raise ServiceError(f"/feed {what} returned {code}: "
                               f"{payload.get('error')}")
        return payload

    def open(self) -> "FeedSession":
        payload = self._post(protocol.feed_open_request(
            self.model, self.opts, req=self.req), "open")
        self.sid = payload["session"]
        self.resumed = bool(payload.get("resumed"))
        return self

    def append(self, histories=None, ops=None,
               t_inv: Optional[float] = None) -> dict:
        """Send one delta: whole histories and/or raw op events (the
        invocations and the completions, in the order they were
        appended); ``t_inv`` is the wall-clock time of its oldest
        invocation.  Returns the daemon's acknowledgement."""
        if self.sid is None:
            raise ServiceError("feed session not open")
        payload = self._post(protocol.feed_append_request(
            self.sid, self.seq, histories=histories, ops=ops, t_inv=t_inv),
            "append")
        self.seq += 1
        self.last_diag = payload.get("diag") or {}
        return payload

    def close(self) -> List[dict]:
        """End the session: the results of the client's histories in feed
        order, then the assembled op history's when ops were sent — equal
        to one ``/check`` of the same histories."""
        if self.sid is None:
            raise ServiceError("feed session not open")
        payload = self._post(protocol.feed_close_request(
            self.sid, self.seq, req=self.req + ":close"), "close")
        self.closed = True
        self.last_diag = payload.get("diag") or {}
        return payload["results"]


def _reap(proc, grace_s: float = 10.0) -> None:
    """Stop a child without leaking it: SIGTERM, a bounded wait, SIGKILL,
    a bounded wait.  A child that outlives even SIGKILL's wait is left to
    the kernel; the caller never sees ``TimeoutExpired``."""
    proc.terminate()
    try:
        proc.wait(timeout=grace_s)
        return
    except subprocess.TimeoutExpired:
        pass
    proc.kill()
    try:
        proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        pass


def free_port(host: str = protocol.DEFAULT_HOST) -> int:
    """A TCP port nothing listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def spawn_daemon(port: Optional[int] = None, wait_s: float = 120.0, *,
                 host: str = protocol.DEFAULT_HOST,
                 device: Optional[str] = None,
                 window: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 wal: Optional[str] = None,
                 coalesce_wait: Optional[float] = None,
                 wal_compact_bytes: Optional[int] = None,
                 log_path: Optional[str] = None,
                 wait: bool = True,
                 **client_kw) -> ServiceClient:
    """Start ``python -m jepsen_tpu_torch.serve`` as a child process (on a
    free port unless ``port`` is given) and wait until ``/healthz``
    answers; returns a client whose ``spawned`` holds the process (stop
    it with ``client.shutdown()`` or :func:`_reap`).  The child's output
    goes to ``log_path`` (default: discarded).  Raises
    :class:`ServiceUnavailable` when it exits or stays unhealthy for
    ``wait_s`` (it is then reaped).  ``wait=False`` returns at once, so
    several daemons can start together (:func:`wait_healthy`)."""
    port = free_port(host) if port is None else port
    client = ServiceClient(host, port, **client_kw)
    argv = [sys.executable, "-m", "jepsen_tpu_torch.serve",
            "--host", host, "--port", str(port)]
    for flag, value in (("--device", device), ("--window", window),
                        ("--max-queue", max_queue), ("--wal", wal),
                        ("--coalesce-wait", coalesce_wait),
                        ("--wal-compact-bytes", wal_compact_bytes)):
        if value is not None:
            argv += [flag, str(value)]
    out = open(log_path, "ab") if log_path else subprocess.DEVNULL
    try:
        proc = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT,
                                cwd=str(_ROOT), start_new_session=True)
    finally:
        if log_path:
            out.close()
    client.spawned = proc
    if wait:
        wait_healthy(client, wait_s)
    return client


def wait_healthy(client: ServiceClient, wait_s: float = 120.0) -> None:
    """Wait until the daemon :func:`spawn_daemon` started for ``client``
    answers ``/healthz``; raises :class:`ServiceUnavailable` (and reaps
    it) when it exits or stays unhealthy for ``wait_s``."""
    proc = client.spawned
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        if client.healthy():
            return
        if proc.poll() is not None:
            raise ServiceUnavailable(
                f"spawned daemon exited with {proc.returncode}")
        time.sleep(0.1)
    _reap(proc)
    raise ServiceUnavailable(f"daemon not healthy within {wait_s}s")


def resolve_client(host: str = protocol.DEFAULT_HOST,
                   port: int = protocol.DEFAULT_PORT, *,
                   auto_start: bool = False, **spawn_kw
                   ) -> Optional[ServiceClient]:
    """A healthy client of ``host:port``, or (with ``auto_start``) of a
    daemon spawned there; None when there is neither."""
    client = ServiceClient(host, port)
    if client.healthy():
        return client
    if auto_start:
        try:
            return spawn_daemon(port, host=host, **spawn_kw)
        except ServiceUnavailable:
            return None
    return None


def tag_fallback(results: List[dict], reason: Optional[str]) -> List[dict]:
    """Mark results the daemon did not compute: ``"service-fallback"``
    names why the seam ran them in-process (nothing when ``reason`` is
    None)."""
    if reason is not None:
        for r in results:
            r["service-fallback"] = reason
    return results


def check_batch(model, histories, *, client: Optional[ServiceClient] = None,
                **opts) -> List[dict]:
    """The seam: ``client``'s daemon when it serves the batch, else the
    in-process ``wgl.check_batch`` (on ``device`` and the other engine
    options in ``opts``).  Options only the in-process engine has
    (``oracle_budget_s``, ``window``, ``bucketed=False``, an explicit
    ``decomposed``, ``mesh``, ``stats``) keep the batch in-process, as an
    unsupported model, a refusal or a daemon failure do; each such
    fallback is counted on the client by reason and tags its results
    with ``"service-fallback"``.  Without a client the batch runs
    in-process and nothing is counted."""
    from ..ops import wgl

    if client is None:
        return wgl.check_batch(model, histories, **opts)
    local_only = [k for k in ("oracle_budget_s", "window", "decomposed",
                              "mesh", "stats") if opts.get(k) is not None]
    if opts.get("bucketed") is False:
        local_only.append("bucketed")
    if local_only:
        reason = "local-option"
    else:
        wire_opts = {k: v for k, v in opts.items()
                     if k in protocol.CHECK_OPTS and v is not None}
        try:
            return client.check_batch(model, histories, **wire_opts)
        except UnsupportedModel:
            reason = "unsupported"
        except ServiceUnavailable:
            reason = "unavailable"
        except ServiceError as e:
            reason = "backlogged" if "backlogged" in str(e) else "error"
    client.count_fallback(reason)
    return tag_fallback(wgl.check_batch(model, histories, **opts), reason)


def analysis(model, history, **kw) -> dict:
    """Single-history :func:`check_batch` (the checker seam's shape)."""
    return check_batch(model, [history], **kw)[0]


def screen_graphs(encs, *, client: ServiceClient,
                  fallbacks: Optional[list] = None) -> Optional[list]:
    """The Elle screens' seam: screen on ``client``'s daemon, or return
    None so the caller screens in-process.  Such a fallback is counted on
    the client and its reason appended to ``fallbacks``, from which the
    caller tags its results (:func:`tag_fallback`)."""
    try:
        return client.screen_graphs(encs)
    except ServiceUnavailable:
        reason = "unavailable"
    except ServiceError as e:
        reason = "backlogged" if "backlogged" in str(e) else "error"
    client.count_fallback(reason)
    if fallbacks is not None:
        fallbacks.append(reason)
    return None


def ServiceChecker(model, client: ServiceClient, pure_fs=("read",),
                   oracle_budget_s=None, device=None):
    """``checker.linearizable(model, algorithm="service", client=client)``:
    the linearizable checker whose analysis runs on the daemon (witness
    rendering and truncation shared with every algorithm)."""
    from ..checker import linearizable

    return linearizable(model, algorithm="service", pure_fs=pure_fs,
                        oracle_budget_s=oracle_budget_s, device=device,
                        client=client)


def format_status(st: dict) -> str:
    """A ``/status`` dict as a short table."""
    devices = f"{st.get('n_devices') or 1} device"
    lines = [
        "── checker service " + "─" * 29,
        f"  pid {st.get('pid')} on {st.get('platform')} ({st.get('device')})"
        f" · {devices} · up {st.get('uptime_s', 0):.0f}s"
        + (" · DRAINING" if st.get("stopping") else ""),
        f"  requests: {st.get('requests', 0)}"
        f" ({st.get('histories', 0)} histories,"
        f" {st.get('rejected', 0)} rejected,"
        f" {st.get('errors', 0)} errors,"
        f" {st.get('device_faults', 0)} device faults)",
        f"  queue: {st.get('queue_depth', 0)}/{st.get('max_queue_runs')}"
        f" · coalesced: {st.get('coalesced', 0)} requests,"
        f" {st.get('coalesced_dispatches', 0)} dispatches"
        f" · window: {st.get('window')}"
        f" · calibration: {st.get('calibration') or 'defaults'}",
    ]
    ratio = st.get("warm_hit_ratio")
    warm = f"{ratio:.0%}" if isinstance(ratio, (int, float)) else "n/a"
    lines.append(f"  dispatches: {st.get('cold_dispatches', 0)} cold"
                 f" + {st.get('warm_dispatches', 0)} warm"
                 f" (warm-hit ratio {warm})")
    launches = {k: v for k, v in (st.get("kernel_launches") or {}).items()
                if v}
    if launches:
        rpl = st.get("rows_per_launch") or {}
        lines.append("  launches: " + ", ".join(
            f"{k} {v}" for k, v in sorted(launches.items()))
            + (" · rows/launch " + ", ".join(
                f"{k} {v}" for k, v in sorted(rpl.items())) if rpl else ""))
    live = st.get("live")
    if live:
        lines.append("  " + format_live(live))
    jp = st.get("journal_path")
    if jp:
        lines.append(f"  journal: {st.get('journal_rows', 0)} rows → {jp}")
    drift = st.get("drift")
    if drift:
        lines.append("  " + format_drift(drift))
    return "\n".join(lines)


def format_fleet_status(rows) -> str:
    """The fleet table: one row per member of ``rows``, a sequence of
    ``(addr, status or None)`` (None: the member did not answer
    ``/status``), with its devices, calibration, drift score, busy share
    and the routing weight the router derives from it
    (:func:`~jepsen_tpu_torch.serve.router.weight_from_busy`, the number
    ``jepsen_route_weight`` exports)."""
    from .router import weight_from_busy

    cols = ["member", "devices", "device", "calibration", "drift", "busy",
            "weight"]
    table = [cols]
    for addr, st in rows:
        if st is None:
            table.append([addr, "-", "-", "unreachable", "-", "-", "-"])
            continue
        drift = st.get("drift") or {}
        score = drift.get("score")
        busy = (st.get("live") or {}).get("device_busy_ratio")
        busy = busy if isinstance(busy, (int, float)) else None
        table.append([
            addr,
            str(st.get("n_devices") or 1),
            str(st.get("device") or st.get("platform") or "-"),
            str(st.get("calibration") or "defaults"),
            (f"{score:.2f}×" + ("!" if drift.get("retune_recommended")
                                else "")
             if isinstance(score, (int, float)) else "n/a"),
            f"{busy:.0%}" if busy is not None else "n/a",
            f"{weight_from_busy(busy):.2f}",
        ])
    widths = [max(len(r[i]) for r in table) for i in range(len(cols))]
    lines = ["── fleet " + "─" * 39]
    for i, r in enumerate(table):
        lines.append("  " + "  ".join(
            c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            lines.append("  " + "  ".join("─" * w for w in widths))
    return "\n".join(lines)


def format_drift(drift: dict) -> str:
    """One-line drift-sentinel view of a /status ``drift`` block
    (obs.drift): aggregate score vs threshold, shape census, and —
    when the sentinel recommends one — the retune call-out naming the
    stale shapes."""
    score = drift.get("score")
    score_s = (f"{score:.2f}×" if isinstance(score, (int, float))
               else "n/a")
    line = (
        f"drift: score {score_s}"
        f" (threshold {drift.get('threshold')}×)"
        f" · {drift.get('shapes', 0)} shape(s)"
        f" · {drift.get('rows_scored', 0)} rows scored"
    )
    stale = drift.get("stale") or []
    if drift.get("retune_recommended"):
        shapes = ", ".join(
            f"{s.get('kernel')}(E={s.get('E')},C={s.get('C')},"
            f"F={s.get('F')})@{s.get('ratio')}×"
            for s in stale
        )
        line += f" · RETUNE RECOMMENDED: {shapes or 'aggregate'}"
    return line


def _rate(live: dict, key: str) -> str:
    v = live.get(key)
    return f"{v:.2f}/s" if isinstance(v, (int, float)) else "n/a"


def format_live(live: dict) -> str:
    """One-line last-60 s view of a /status ``live`` dict (the
    sliding-window rates)."""
    qw = live.get("queue_wait_mean_s")
    busy = live.get("device_busy_ratio")
    return (
        f"last 60s: req {_rate(live, 'requests_per_s')}"
        f" · hist {_rate(live, 'histories_per_s')}"
        f" · elle {_rate(live, 'elle_graphs_per_s')}"
        f" · disp {_rate(live, 'dispatches_per_s')}"
        f" · feed {_rate(live, 'feed_deltas_per_s')}"
        f" · watch {_rate(live, 'watch_events_per_s')}"
        f" · wait "
        + (f"{qw * 1e3:.1f}ms" if isinstance(qw, (int, float)) else "n/a")
        + " · busy "
        + (f"{busy:.0%}" if isinstance(busy, (int, float)) else "n/a")
    )


def format_top(host: str, port, st: dict) -> str:
    """One daemon's fleet-view block for ``top``: identity line, last-60 s
    rates, queue/journal line."""
    mesh = st.get("mesh_shape")
    live = st.get("live") or {}
    head = (
        f"● {host}:{port}  pid {st.get('pid')}"
        f" · {st.get('n_devices') or 1} device(s)"
        + (f" · mesh {mesh}" if mesh else "")
        + f" · up {st.get('uptime_s', 0):.0f}s"
        + (" · DRAINING" if st.get("stopping") else "")
    )
    jp = st.get("journal_path")
    # quarantined routes + drift score ride the same summary line:
    # the two "this daemon needs an operator" signals the fleet view
    # previously never showed
    quarantined = len(st.get("quarantine") or [])
    drift = st.get("drift") or {}
    score = drift.get("score")
    tail = (
        f"  queue {st.get('queue_depth', 0)}/{st.get('max_queue_runs')}"
        f" · in-flight {st.get('in_flight', 0)}"
        f" · coalesced {st.get('coalesced', 0)}"
        + (f" · feeds {st.get('feed_open', 0)}"
           if st.get("feed_open") else "")
        + (f" · watchers {st.get('watch_subscribers', 0)}"
           if st.get("watch_subscribers") else "")
        + (f" · journal {st.get('journal_rows', 0)} rows" if jp else "")
        + f" · quarantined {quarantined}"
        + (f" · drift {score:.2f}×"
           + ("!" if drift.get("retune_recommended") else "")
           if isinstance(score, (int, float)) else "")
    )
    return "\n".join([head, "  " + format_live(live), tail])


def format_verdicts(events, limit: int = 8) -> str:
    """Render the newest settled verdicts as ``top``'s verdicts pane.  ``events`` is a sequence of ``(addr, offset, row)``
    tuples collected off one or more ``/watch`` channels (newest
    last); only the trailing ``limit`` rows are shown."""
    lines = ["── verdicts " + "─" * 36]
    rows = list(events)[-limit:]
    if not rows:
        lines.append("  (no settled verdicts yet)")
        return "\n".join(lines)
    now = time.time()
    for addr, off, row in rows:
        res = row.get("result") or {}
        valid = res.get("valid?")
        mark = "✗" if valid is False else ("✓" if valid is True else "?")
        ts = row.get("ts")
        age = (f"{max(0.0, now - float(ts)):.0f}s ago"
               if isinstance(ts, (int, float)) else "t?")
        extra = ""
        if valid is False:
            anom = res.get("anomaly-types") or res.get("anomalies")
            if anom:
                extra = f" · {anom}"
        lines.append(
            f"  {mark} {addr} #{off}"
            f" req {str(row.get('req'))[:8]}"
            f" {row.get('stream')}[{row.get('idx')}]"
            f" · {age}{extra}"
        )
    return "\n".join(lines)
