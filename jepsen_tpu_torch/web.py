"""Web UI over the store: test table, directory browser, zip download —
the port's copy of :mod:`jepsen_tpu.web`.

The live checker-service panel reads the port's
:class:`~jepsen_tpu_torch.serve.client.ServiceClient` of the daemon at
``service`` (``(host, port)``; default the daemon's own default,
``127.0.0.1:8519``; no environment variable names it), and adds the
daemon's device to the reference's rows.

(reference: jepsen/src/jepsen/web.clj — home:146, dir:235, zip:305,
files:349 with its scope check:328, serve!:385; http.server instead of
http-kit, same routes)
"""

from __future__ import annotations

import html
import io
import json
import os
import threading
import urllib.parse
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple

from . import store as store_mod

PAGE_STYLE = """\
body { font-family: sans-serif; margin: 2em; }
table { border-collapse: collapse; }
th, td { padding: 4px 10px; border-bottom: 1px solid #ddd; text-align: left; }
.valid-true { background: #c8f0c8; }
.valid-false { background: #f0c8c8; }
.valid-unknown { background: #f0e8c0; }
a { text-decoration: none; }
.live { color: #2a2; font-size: 0.8em; }
.first-violation { outline: 2px solid #c33; font-weight: bold; }
"""


def test_row(base: str, name: str, t: str) -> dict:
    """Cheap header info for one run: the valid? field via the partial
    map head (no full deserialize — the point of the block format)."""
    d = os.path.join(base, name, t)
    valid: Any = "unknown"
    try:
        res_path = os.path.join(d, "results.json")
        if os.path.exists(res_path):
            with open(res_path) as f:
                valid = json.load(f).get("valid?", "unknown")
        else:
            loaded = store_mod.load(
                {"name": name, "start-time": t, "store-base": base}
            )
            valid = (loaded.get("results") or {}).get("valid?", "unknown")
    except (OSError, ValueError):
        valid = "unknown"
    return {
        "name": name,
        "time": t,
        "valid": valid,
        "dir": d,
        # per-run trace artifact (jepsen_tpu.obs export): linked from
        # the home table when the run recorded one
        "trace": os.path.exists(os.path.join(d, "trace.json")),
        # per-run device-profiling capture (obs.profiling, cli test
        # --profile): a profile/ dir with the loadable manifest
        "profile": os.path.exists(
            os.path.join(d, "profile", "profile.json")),
    }


def _valid_class(v: Any) -> str:
    if v is True:
        return "valid-true"
    if v is False:
        return "valid-false"
    return "valid-unknown"


def service_section(client=None,
                    service: Optional[Tuple[str, int]] = None) -> str:
    """Live checker-service panel: when a resident daemon
    (jepsen_tpu_torch.serve) answers at ``service`` (or ``client``, a
    :class:`~jepsen_tpu_torch.serve.client.ServiceClient`), the web UI is
    a thin client of it — live queue/warm-cache numbers and a link to
    its /metrics scrape; with no daemon it degrades silently to the
    store-only view this module always served."""
    try:
        if client is None:
            from .serve import ServiceClient

            # one probe, not healthz-then-status: a failed/absent daemon
            # lands in the except either way, and home-page renders
            # should pay a single short round-trip
            client = ServiceClient(*(service or ()), timeout=0.5)
        st = client.status()
    except Exception:  # noqa: BLE001 — store-only mode is the fallback
        return ""
    ratio = st.get("warm_hit_ratio")
    warm = f"{ratio:.0%}" if isinstance(ratio, (int, float)) else "n/a"
    murl = f"http://{client.host}:{client.port}/metrics"
    rows = [
        ("platform", st.get("platform")),
        ("device", st.get("device")),
        ("uptime", f"{st.get('uptime_s', 0):.0f} s"),
        ("requests", f"{st.get('requests', 0)} "
         f"({st.get('histories', 0)} histories)"),
        ("queue", f"{st.get('queue_depth', 0)}/{st.get('max_queue_runs')}"
         + (" — draining" if st.get("stopping") else "")),
        ("coalesced", st.get("coalesced", 0)),
        ("warm-hit ratio", warm),
    ]
    live = st.get("live") or {}

    def _rate(k):
        v = live.get(k)
        return f"{v:.2f}/s" if isinstance(v, (int, float)) else "n/a"

    if live:
        qw = live.get("queue_wait_mean_s")
        busy = live.get("device_busy_ratio")
        rows.append((
            "last 60 s",
            f"req {_rate('requests_per_s')}"
            f" · hist {_rate('histories_per_s')}"
            f" · disp {_rate('dispatches_per_s')}",
        ))
        rows.append((
            "queue wait / busy",
            (f"{qw * 1e3:.1f} ms"
             if isinstance(qw, (int, float)) else "n/a")
            + " / "
            + (f"{busy:.0%}" if isinstance(busy, (int, float)) else "n/a"),
        ))
    if st.get("feed_open") or st.get("feed_sessions"):
        rows.append((
            "online feeds",
            f"{st.get('feed_open', 0)} open"
            f" ({st.get('feed_sessions', 0)} sessions,"
            f" {st.get('feed_deltas', 0)} deltas)"
            + (f" · feed {_rate('feed_deltas_per_s')}" if live else ""),
        ))
    if st.get("watch_subscribers") or st.get("watch_events"):
        rows.append((
            "watchers",
            f"{st.get('watch_subscribers', 0)}"
            f" ({st.get('watch_events', 0)} events streamed)",
        ))
    if st.get("journal_path"):
        rows.append((
            "dispatch journal",
            f"{st.get('journal_rows', 0)} rows → {st.get('journal_path')}",
        ))
    drift = st.get("drift")
    if drift:
        score = drift.get("score")
        rows.append((
            "cost-model drift",
            (f"{score:.2f}×" if isinstance(score, (int, float))
             else "n/a")
            + f" over {drift.get('shapes', 0)} shape(s)"
            + (" — RETUNE RECOMMENDED"
               if drift.get("retune_recommended") else ""),
        ))
    cells = "".join(
        f"<tr><td>{html.escape(str(k))}</td>"
        f"<td>{html.escape(str(v))}</td></tr>"
        for k, v in rows
    )
    return (
        '<h2>Checker service <span class="live">●&nbsp;live</span></h2>'
        f"<table>{cells}</table>"
        f'<p><a href="{html.escape(murl)}">live metrics</a> '
        "(Prometheus text)</p>"
        + _verdict_panel(client, st)
    )


def _verdict_panel(client, st: dict, limit: int = 10) -> str:
    """Live-verdict panel: a bounded tail of the daemon's ``/watch``
    channel (replay only the last ``limit`` WAL rows, via
    ``Last-Event-ID``).  The earliest violation in view is highlighted
    — the first thing an operator wants off an online monitor."""
    wal_rows = st.get("wal_rows") or 0
    if not wal_rows:
        return ""
    events = []
    try:
        for off, row in client.watch(last_id=max(-1, wal_rows - limit - 1),
                                     timeout=1.0):
            events.append((off, row))
            if off >= wal_rows - 1 or len(events) >= limit:
                break
    except Exception:  # noqa: BLE001 — the panel is best-effort
        return ""
    if not events:
        return ""
    first_violation = min(
        (off for off, row in events
         if (row.get("result") or {}).get("valid?") is False),
        default=None,
    )
    cells = []
    for off, row in events:
        res = row.get("result") or {}
        valid = res.get("valid?")
        cls = _valid_class(valid)
        if off == first_violation:
            cls += " first-violation"
        cells.append(
            f'<tr class="{cls}">'
            f"<td>#{off}</td>"
            f"<td>{html.escape(str(row.get('req'))[:12])}</td>"
            f"<td>{html.escape(str(row.get('stream')))}"
            f"[{html.escape(str(row.get('idx')))}]</td>"
            f"<td>{html.escape(str(valid))}</td>"
            f"<td>{html.escape(str(res.get('engine', '')))}</td></tr>"
        )
    return (
        '<h3>Settled verdicts <span class="live">●&nbsp;watch</span></h3>'
        "<table><tr><th>wal row</th><th>run</th><th>partition</th>"
        "<th>valid?</th><th>engine</th></tr>"
        + "".join(cells)
        + "</table>"
    )


def home_page(base: str, service: Optional[Tuple[str, int]] = None) -> str:
    rows = []
    for name, runs in sorted(store_mod.tests(base).items()):
        for t in reversed(runs):
            rows.append(test_row(base, name, t))
    rows.sort(key=lambda r: r["time"], reverse=True)
    body = [
        service_section(service=service),
        "<h1>Tests</h1>",
        "<table><tr><th>name</th><th>time</th><th>valid?</th>"
        "<th></th><th></th><th></th></tr>",
    ]
    for r in rows:
        link = urllib.parse.quote(f"/files/{r['name']}/{r['time']}/")
        zlink = urllib.parse.quote(f"/zip/{r['name']}/{r['time']}")
        tlink = urllib.parse.quote(
            f"/files/{r['name']}/{r['time']}/trace.json"
        )
        trace_cell = (
            f'<td><a href="{tlink}">trace</a></td>'
            if r.get("trace")
            else "<td></td>"
        )
        plink = urllib.parse.quote(
            f"/files/{r['name']}/{r['time']}/profile/"
        )
        profile_cell = (
            f'<td><a href="{plink}">profile</a></td>'
            if r.get("profile")
            else "<td></td>"
        )
        body.append(
            f'<tr class="{_valid_class(r["valid"])}">'
            f'<td><a href="{link}">{html.escape(r["name"])}</a></td>'
            f'<td><a href="{link}">{html.escape(r["time"])}</a></td>'
            f"<td>{html.escape(str(r['valid']))}</td>"
            f'<td><a href="{zlink}">zip</a></td>'
            f"{trace_cell}{profile_cell}</tr>"
        )
    body.append("</table>")
    return _page("Jepsen-TPU", "\n".join(body))


def dir_page(base: str, rel: str) -> str:
    d = os.path.join(base, rel) if rel else base
    entries = sorted(os.listdir(d))
    body = [f"<h1>{html.escape('/' + rel)}</h1>", "<ul>"]
    if rel:
        parent = os.path.dirname(rel.rstrip("/"))
        body.append(
            f'<li><a href="/files/{urllib.parse.quote(parent)}/">..</a></li>'
            if parent
            else '<li><a href="/files/">..</a></li>'
        )
    for e in entries:
        p = os.path.join(d, e)
        suffix = "/" if os.path.isdir(p) else ""
        link = urllib.parse.quote(f"/files/{rel}/{e}".replace("//", "/"))
        body.append(f'<li><a href="{link}{suffix}">{html.escape(e)}{suffix}</a></li>')
    body.append("</ul>")
    return _page(rel or "store", "\n".join(body))


def _page(title: str, body: str) -> str:
    return (
        f"<html><head><title>{html.escape(title)}</title>"
        f"<style>{PAGE_STYLE}</style></head><body>{body}</body></html>"
    )


def zip_bytes(d: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, _dirs, files in os.walk(d):
            for f in files:
                full = os.path.join(root, f)
                z.write(full, os.path.relpath(full, os.path.dirname(d)))
    return buf.getvalue()


CONTENT_TYPES = {
    ".html": "text/html", ".svg": "image/svg+xml", ".json": "application/json",
    ".txt": "text/plain", ".log": "text/plain", ".jsonl": "text/plain",
    ".edn": "text/plain", ".prom": "text/plain",
}


class Handler(BaseHTTPRequestHandler):
    base = "store"
    service: Optional[Tuple[str, int]] = None

    def _ok(self, content: bytes, ctype: str = "text/html",
            extra: Optional[dict] = None):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(content)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(content)

    def _err(self, code: int, msg: str):
        self.send_response(code)
        self.send_header("Content-Type", "text/plain")
        self.end_headers()
        self.wfile.write(msg.encode())

    def _resolve(self, rel: str) -> Optional[str]:
        """Path-traversal scope check: everything must stay under base.
        (reference: web.clj:328-347)"""
        base_abs = os.path.abspath(self.base)
        target = os.path.abspath(os.path.join(base_abs, rel))
        if target != base_abs and not target.startswith(base_abs + os.sep):
            return None
        return target

    def do_GET(self):  # noqa: N802 — http.server API
        try:
            path = urllib.parse.unquote(urllib.parse.urlparse(self.path).path)
            if path in ("/", ""):
                self._ok(home_page(self.base, self.service).encode())
                return
            if path.startswith("/files"):
                rel = path[len("/files"):].strip("/")
                target = self._resolve(rel)
                if target is None:
                    self._err(403, "out of scope")
                    return
                if os.path.isdir(target):
                    self._ok(dir_page(self.base, rel).encode())
                elif os.path.isfile(target):
                    ext = os.path.splitext(target)[1]
                    with open(target, "rb") as f:
                        self._ok(
                            f.read(),
                            CONTENT_TYPES.get(ext, "application/octet-stream"),
                        )
                else:
                    self._err(404, "not found")
                return
            if path.startswith("/zip/"):
                rel = path[len("/zip/"):].strip("/")
                target = self._resolve(rel)
                if target is None or not os.path.isdir(target):
                    self._err(404, "not found")
                    return
                name = rel.replace("/", "-") + ".zip"
                self._ok(
                    zip_bytes(target),
                    "application/zip",
                    {"Content-Disposition": f'attachment; filename="{name}"'},
                )
                return
            self._err(404, "not found")
        except BrokenPipeError:
            pass

    def log_message(self, fmt, *args):
        pass  # quiet; the store's jepsen.log is the log of record


def serve(host: str = "0.0.0.0", port: int = 8080, base: str = "store",
          block: bool = True,
          service: Optional[Tuple[str, int]] = None) -> ThreadingHTTPServer:
    """Start the web UI; ``service`` is the checker daemon whose panel the
    home page shows.  With ``block`` False the server runs on a daemon
    thread, ``server.thread``: stop it with ``shutdown()`` and
    ``server_close()``, then join the thread.
    (reference: web.clj:385-390)"""
    handler = type("BoundHandler", (Handler,),
                   {"base": base, "service": service})
    server = ThreadingHTTPServer((host, port), handler)
    print(f"Serving {base!r} on http://{host}:{port}/")
    if block:
        server.serve_forever()
    else:
        # kept on the server so a caller can join it after shutdown()
        server.thread = threading.Thread(target=server.serve_forever,
                                         daemon=True)
        server.thread.start()
    return server
