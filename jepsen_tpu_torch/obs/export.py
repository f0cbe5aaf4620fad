"""Exporters for the observability layer: Chrome trace, span JSONL,
Prometheus text dump, and the run-summary dict/table — a copy of
:mod:`jepsen_tpu.obs.export`.

Spans adopted from a checker daemon in another process
(:mod:`.propagate`) merge into the Chrome trace on this process's wall
clock, and request spans tagged with one trace id are joined across the
process boundary by Chrome flow events (``ph`` "s", "t", "f").

File inventory (written by :func:`export_all` into one directory):

- ``trace.json`` — Chrome ``trace_event`` format (the
  ``{"traceEvents": [...]}`` JSON object of complete-``"X"`` events).
  Open with ``chrome://tracing`` or https://ui.perfetto.dev.
- ``trace-spans.jsonl`` — one raw span record per line (monotonic-ns
  timestamps + attrs), for programmatic consumers.
- ``metrics.prom`` — Prometheus text exposition dump of every counter,
  gauge, and histogram recorded during the run.

``summary`` distills both into the dict embedded under
``results["obs"]`` and rendered by :func:`format_summary` as the CLI's
phase/engine breakdown table.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from .metrics import MetricsRegistry
from .tracer import SpanRecord, Tracer

TRACE_JSON = "trace.json"
SPANS_JSONL = "trace-spans.jsonl"
METRICS_PROM = "metrics.prom"


def chrome_trace(tracer: Tracer,
                 remote_spans: Optional[List[dict]] = None) -> dict:
    """Finished spans as a Chrome ``trace_event`` document.  Timestamps
    are microseconds from the tracer origin (complete events, ph="X").
    Remote spans (default: :func:`.propagate.adopted`) merge in on the
    local wall clock, and trace_ctx-tagged spans gain flow events."""
    events: List[dict] = []
    origin = tracer.origin_ns
    for rec in tracer.finished():
        if rec.t1 is None:
            continue
        ev = {
            "name": rec.name,
            "cat": rec.cat or "span",
            "ph": "X",
            "ts": (rec.t0 - origin) / 1e3,
            "dur": (rec.t1 - rec.t0) / 1e3,
            "pid": rec.pid,
            "tid": rec.tid,
        }
        if rec.attrs:
            ev["args"] = dict(rec.attrs)
        events.append(ev)
    if remote_spans is None:
        from . import propagate

        remote_spans = propagate.adopted()
    for rec in remote_spans:
        ev = _remote_event(rec, tracer.wall_origin)
        if ev is not None:
            events.append(ev)
    events.extend(_flow_events(events))
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "jepsen_tpu_torch.obs",
            "wall_origin": tracer.wall_origin,
            "dropped_spans": tracer.dropped,
        },
    }
    if tracer.run_anchor_ns is not None:
        doc["otherData"]["run_anchor_us"] = (
            (tracer.run_anchor_ns - origin) / 1e3
        )
    return doc


def _remote_event(rec: dict, wall_origin: float) -> Optional[dict]:
    """One adopted daemon span → a local event on this process's clock:
    a remote span sits at its own ``wall_origin + (t0 - origin_ns)``, so
    rebasing is one wall-clock delta.  A span without its alignment
    metadata is dropped, not guessed."""
    t0, t1 = rec.get("t0"), rec.get("t1")
    r_origin = rec.get("_remote_origin_ns")
    r_wall = rec.get("_remote_wall_origin")
    if None in (t0, t1, r_origin, r_wall):
        return None
    ev = {
        "name": rec.get("name", "?"),
        "cat": rec.get("cat") or "span",
        "ph": "X",
        "ts": (r_wall - wall_origin) * 1e6 + (t0 - r_origin) / 1e3,
        "dur": (t1 - t0) / 1e3,
        "pid": rec.get("pid", rec.get("_remote_pid", 0)),
        "tid": rec.get("tid", 0),
    }
    if rec.get("attrs"):
        ev["args"] = dict(rec["attrs"])
    return ev


def _flow_events(events: List[dict]) -> List[dict]:
    """Flow events joining trace_ctx-tagged spans: ph="s" at the client
    span, ph="t" through the daemon's intermediate spans, ph="f" (bp="e")
    at its last, all under the trace id."""
    starts: Dict[str, dict] = {}
    finishes: Dict[str, List[dict]] = {}
    for ev in events:
        args = ev.get("args") or {}
        trace_id, role = args.get("trace_id"), args.get("ctx_role")
        if not trace_id or not role:
            continue
        if role == "client":
            starts.setdefault(trace_id, ev)
        elif role == "daemon":
            finishes.setdefault(trace_id, []).append(ev)
    flows: List[dict] = []
    for trace_id in sorted(starts):
        sev = starts[trace_id]
        fevs = sorted(finishes.get(trace_id, []), key=lambda e: e["ts"])
        if not fevs:
            continue
        base = {"name": "trace_ctx", "cat": "trace_ctx", "id": trace_id}
        flows.append({**base, "ph": "s", "ts": sev["ts"],
                      "pid": sev["pid"], "tid": sev["tid"]})
        for fev in fevs[:-1]:
            flows.append({**base, "ph": "t", "ts": fev["ts"],
                          "pid": fev["pid"], "tid": fev["tid"]})
        last = fevs[-1]
        flows.append({**base, "ph": "f", "bp": "e", "ts": last["ts"],
                      "pid": last["pid"], "tid": last["tid"]})
    return flows


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f)
    return path


def write_spans_jsonl(tracer: Tracer, path: str) -> str:
    with open(path, "w") as f:
        for rec in tracer.finished():
            f.write(json.dumps(rec.to_dict()) + "\n")
    return path


def render_prom(registry: Optional[MetricsRegistry] = None) -> str:
    """Incremental registry → Prometheus text exposition, no file I/O.
    The one formatter behind the ``metrics.prom`` file and any live
    scrape, so the two can never disagree about the same registry.
    Defaults to the process registry."""
    if registry is None:
        from . import registry as _live_registry

        registry = _live_registry()
    return registry.prometheus_text()


def write_prometheus(registry: MetricsRegistry, path: str) -> str:
    with open(path, "w") as f:
        f.write(render_prom(registry))
    return path


def export_all(tracer: Tracer, registry: MetricsRegistry,
               directory: str) -> Dict[str, str]:
    """Write all three artifacts into ``directory``; returns the paths."""
    os.makedirs(directory, exist_ok=True)
    return {
        "trace": write_chrome_trace(
            tracer, os.path.join(directory, TRACE_JSON)),
        "spans": write_spans_jsonl(
            tracer, os.path.join(directory, SPANS_JSONL)),
        "metrics": write_prometheus(
            registry, os.path.join(directory, METRICS_PROM)),
    }


# ---------------------------------------------------------------------------
# Summary
# ---------------------------------------------------------------------------


def _phase_rows(tracer: Tracer) -> List[dict]:
    rows = []
    for rec in tracer.finished(cat="phase"):
        if rec.t1 is None:
            continue
        rows.append({
            "name": rec.name,
            "wall_s": round(rec.duration_s(), 4),
            "start_ns": rec.t0,
            "end_ns": rec.t1,
        })
    rows.sort(key=lambda r: r["start_ns"])
    return rows


def _engine_rows(snapshot: List[dict]) -> Dict[str, dict]:
    """Fold the kernel/engine metric families into one row per engine:
    rows checked, compile (first-dispatch) and execute seconds, dispatch
    counts, oracle timings."""
    engines: Dict[str, dict] = {}

    def row(engine: str) -> dict:
        # escalation rungs ARE frontier work: fold their timings into
        # the frontier row (their histories are counted there too);
        # jepsen_engine_escalations_total keeps the rung detail
        if engine == "frontier-escalated":
            engine = "frontier"
        return engines.setdefault(engine, {"rows": 0})

    for d in snapshot:
        name, labels = d["name"], d["labels"]
        if name == "jepsen_engine_rows_total":
            row(labels.get("engine", "?"))["rows"] = (
                row(labels.get("engine", "?")).get("rows", 0) + d["value"]
            )
        elif name == "jepsen_kernel_compile_seconds":
            r = row(labels.get("engine", "?"))
            r["compile_s"] = round(r.get("compile_s", 0.0) + d["sum"], 4)
            r["compile_dispatches"] = (
                r.get("compile_dispatches", 0) + d["count"]
            )
        elif name == "jepsen_kernel_execute_seconds":
            r = row(labels.get("engine", "?"))
            r["execute_s"] = round(r.get("execute_s", 0.0) + d["sum"], 4)
            r["execute_dispatches"] = (
                r.get("execute_dispatches", 0) + d["count"]
            )
        elif name == "jepsen_oracle_seconds":
            r = row("oracle")
            r["execute_s"] = round(r.get("execute_s", 0.0) + d["sum"], 4)
            r["analyses"] = r.get("analyses", 0) + d["count"]
    return engines


def summary(tracer: Tracer, registry: MetricsRegistry) -> dict:
    """The run-summary dict embedded in ``results["obs"]``: phase wall
    times, per-engine rows + compile/execute seconds, op counters,
    frontier telemetry, and span accounting."""
    snapshot = registry.snapshot()
    ops: Dict[str, int] = {}
    nemesis_ops = 0
    retries = 0
    for d in snapshot:
        if d["name"] == "jepsen_interpreter_ops_total":
            t = d["labels"].get("type", "?")
            ops[t] = ops.get(t, 0) + d["value"]
        elif d["name"] == "jepsen_nemesis_ops_total":
            nemesis_ops += d["value"]
        elif d["name"] == "jepsen_remote_retries_total":
            retries += d["value"]
    out = {
        "phases": _phase_rows(tracer),
        "engines": _engine_rows(snapshot),
        "ops": ops,
        "nemesis-ops": nemesis_ops,
        "remote-retries": retries,
        "spans": len(tracer),
        "spans-dropped": tracer.dropped,
    }
    hw = registry.value("jepsen_frontier_high_water")
    if hw is not None:
        out["frontier-high-water"] = hw
    budget = registry.value("jepsen_frontier_dispatch_budget_used_ratio")
    if budget is not None:
        out["frontier-dispatch-budget-used"] = round(budget, 4)
    # pipelined-engine occupancy (jepsen_tpu_torch.engine): peak in-flight
    # dispatch depth (>1 proves overlap happened), peak shape-bucket
    # count, and the last run's 1 − bubble/wall occupancy ratio
    depth = registry.value("jepsen_engine_inflight_depth")
    if depth is not None:
        out["engine-inflight-depth"] = int(depth)
    nb = registry.value("jepsen_engine_bucket_count")
    if nb is not None:
        out["engine-buckets"] = int(nb)
    occ = registry.value("jepsen_engine_occupancy_ratio")
    if occ is not None:
        out["engine-occupancy"] = round(occ, 4)
    # online-checking latency: seconds from the run's wall origin to
    # the first settled verdict / first violation verdict (the gauges
    # set once by engine.planning as partitions settle)
    ttfv = registry.value("jepsen_run_first_verdict_seconds")
    if ttfv is not None:
        out["time-to-first-verdict"] = round(ttfv, 4)
    ttv = registry.value("jepsen_run_first_violation_seconds")
    if ttv is not None:
        out["time-to-violation"] = round(ttv, 4)
    # cost-model drift sentinel (obs.drift): the aggregate residual
    # score and the retune recommendation become durable in
    # results.json["obs"], so a stored run records that its estimates
    # had gone stale — not just the live /status view
    ds = registry.value("jepsen_drift_score")
    if ds is not None:
        out["drift-score"] = round(ds, 4)
    stale = registry.value("jepsen_drift_stale_shapes")
    if stale is not None:
        out["drift-stale-shapes"] = int(stale)
    rec = registry.value("jepsen_drift_retune_recommended")
    if rec is not None:
        out["retune-recommended"] = bool(rec)
    return out


def format_summary(s: dict) -> str:
    """Render the summary as the CLI's breakdown table."""
    lines: List[str] = []
    phases = s.get("phases") or []
    if phases:
        lines.append("── run phases " + "─" * 34)
        for p in phases:
            lines.append(f"  {p['name']:<28} {p['wall_s']:>10.3f} s")
    engines = s.get("engines") or {}
    if engines:
        lines.append("── checker engines " + "─" * 29)
        lines.append(
            f"  {'engine':<18}{'rows':>8}{'compile s':>12}{'execute s':>12}"
        )
        for name in sorted(engines):
            e = engines[name]
            comp = e.get("compile_s")
            exe = e.get("execute_s")
            lines.append(
                f"  {name:<18}{int(e.get('rows', 0)):>8}"
                f"{comp if comp is not None else '—':>12}"
                f"{exe if exe is not None else '—':>12}"
            )
    ops = s.get("ops") or {}
    if ops:
        opline = ", ".join(f"{v} {k}" for k, v in sorted(ops.items()))
        lines.append(f"  ops: {opline}")
    extras = []
    if s.get("nemesis-ops"):
        extras.append(f"nemesis ops: {s['nemesis-ops']}")
    if s.get("remote-retries"):
        extras.append(f"remote retries: {s['remote-retries']}")
    if s.get("frontier-high-water") is not None:
        extras.append(f"frontier high-water: {int(s['frontier-high-water'])}")
    if s.get("engine-inflight-depth") is not None:
        pipe = f"pipeline depth: {s['engine-inflight-depth']}"
        if s.get("engine-occupancy") is not None:
            pipe += f", occupancy: {s['engine-occupancy']:.0%}"
        extras.append(pipe)
    if s.get("time-to-first-verdict") is not None:
        online = f"first verdict: {s['time-to-first-verdict']:.3f}s"
        if s.get("time-to-violation") is not None:
            online += f", first violation: {s['time-to-violation']:.3f}s"
        extras.append(online)
    if s.get("spans-dropped"):
        extras.append(f"spans dropped: {s['spans-dropped']}")
    if extras:
        lines.append("  " + "; ".join(extras))
    lines.append(f"  spans recorded: {s.get('spans', 0)}")
    return "\n".join(lines)


def validate_chrome_trace(path: str) -> Optional[str]:
    """Sanity-check a trace.json: returns None when valid, else a
    human-readable reason (used by the trace-smoke make target)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return f"unreadable trace file: {e!r}"
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return "traceEvents missing or empty"
    for ev in events:
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in ev:
                return f"event missing {k!r}: {ev!r}"
        if ev["ph"] == "X" and "dur" not in ev:
            return f"complete event missing dur: {ev!r}"
    return None


def validate_prometheus(path: str) -> Optional[str]:
    """Sanity-check a metrics.prom dump: None when valid, else reason."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        return f"unreadable metrics file: {e!r}"
    return validate_prometheus_text(text)


def validate_prometheus_text(text: str) -> Optional[str]:
    """Sanity-check Prometheus exposition text (a ``render_prom``
    result or a live ``/metrics`` scrape body): None when valid, else
    a human-readable reason.  Shared by the trace-smoke file check and
    the serve-smoke endpoint check."""
    samples = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.rsplit(" ", 1)
        if len(parts) != 2:
            return f"malformed sample line: {line!r}"
        try:
            float(parts[1])
        except ValueError:
            return f"non-numeric sample value: {line!r}"
        samples += 1
    if not samples:
        return "no metric samples recorded"
    return None
