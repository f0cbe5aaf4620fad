"""Latency and throughput plots with nemesis-interval shading — the
port's copy of :mod:`jepsen_tpu.checker.perf`.

Native SVG renderings of the reference's gnuplot graphs
(jepsen/src/jepsen/checker/perf.clj: latencies->quantiles:63,
nemesis-regions:240, point-graph!:484, quantiles-graph!:513,
rate-graph!:559).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import store as store_mod
from ..history import History, OK, INVOKE
from ..util import history_latencies, nemesis_intervals
from . import svg

#: Standard latency quantiles.  (reference: perf.clj quantiles-graph!)
QUANTILES = (0.5, 0.95, 0.99, 1.0)


def nanos_to_secs(ns: int) -> float:
    return ns / 1e9


def nemesis_regions(test: dict, history: History) -> List[svg.Region]:
    """Shaded bands for nemesis activity intervals.
    (reference: perf.clj:240-283)"""
    plot = (test or {}).get("plot", {}) or {}
    specs = plot.get("nemeses") or [
        {"name": "nemesis", "start": ("start",), "stop": ("stop",)}
    ]
    regions = []
    end_time = nanos_to_secs(history[-1].time) if len(history) else 0.0
    palette = ["#bbbbbb", "#cc6666", "#6666cc", "#66aa66", "#aa66aa"]
    for i, spec in enumerate(specs):
        ivals = nemesis_intervals(
            history,
            fs_start=spec.get("start", ("start",)),
            fs_stop=spec.get("stop", ("stop",)),
        )
        color = spec.get("color") or palette[i % len(palette)]
        for start, stop in ivals:
            regions.append(
                svg.Region(
                    nanos_to_secs(start.time),
                    nanos_to_secs(stop.time) if stop is not None else end_time,
                    color=color,
                    opacity=0.15,
                    label=str(spec.get("name", "")),
                )
            )
    return regions


#: run-phase overlay shade (deliberately fainter than nemesis bands —
#: phases are context, faults are the story)
PHASE_COLOR = "#4477aa"


def phase_regions(test: dict, history: History) -> List[svg.Region]:
    """Shaded bands for run lifecycle phases (jepsen_tpu.obs spans of
    category "phase"), aligned with history time via the run anchor.
    Only phases intersecting the plotted axis [0, last-op-time] appear:
    setup/db phases straddling t=0 are clamped to it, and phases lying
    entirely after the history (save-history, analyze — which hasn't
    even finished when these graphs render) can't be drawn on this
    axis at all; the full set lives in the exported trace.json."""
    from .. import obs

    intervals = obs.phase_intervals()
    if not intervals or not len(history):
        return []
    end_time = nanos_to_secs(history[-1].time)
    regions = []
    for name, x0, x1 in intervals:
        if x1 <= 0 or x0 >= end_time:
            continue  # outside the plotted axis entirely
        regions.append(
            svg.Region(
                max(x0, 0.0), min(x1, end_time),
                color=PHASE_COLOR, opacity=0.05, label=str(name),
            )
        )
    return regions


def graph_regions(test: dict, history: History) -> List[svg.Region]:
    """Nemesis bands + the obs phase overlay — what every perf graph
    shades behind its series."""
    return nemesis_regions(test, history) + phase_regions(test, history)


def latencies_to_quantiles(
    dt: float, qs: Sequence[float], points: List[Tuple[float, float]]
) -> Dict[float, List[Tuple[float, float]]]:
    """Partition [t, latency] points into dt-second windows and take each
    quantile per window.  (reference: perf.clj:63-90)"""
    if not points:
        return {q: [] for q in qs}
    buckets: Dict[int, List[float]] = {}
    for t, lat in points:
        buckets.setdefault(int(t // dt), []).append(lat)
    out: Dict[float, List[Tuple[float, float]]] = {q: [] for q in qs}
    for b in sorted(buckets):
        lats = sorted(buckets[b])
        mid_t = (b + 0.5) * dt
        for q in qs:
            idx = min(len(lats) - 1, int(math.ceil(q * len(lats))) - 1)
            out[q].append((mid_t, lats[max(idx, 0)]))
    return out


def invokes_by_f(history: History) -> Dict[Any, List]:
    by_f: Dict[Any, List] = {}
    for op in history_latencies(history):
        if op.type != INVOKE or not isinstance(op.process, int):
            continue
        by_f.setdefault(op.f, []).append(op)
    return by_f


def point_graph(test: dict, history: History, opts: dict) -> Optional[str]:
    """Raw latency scatter, one series per (f, completion type).
    (reference: perf.clj:484-511)"""
    by_f = invokes_by_f(history)
    series = []
    for f, ops in sorted(by_f.items(), key=lambda kv: str(kv[0])):
        by_type: Dict[str, List[Tuple[float, float]]] = {}
        for op in ops:
            lat = op.get("latency")
            if lat is None:
                continue
            by_type.setdefault(op.get("completion_type", "info"), []).append(
                (nanos_to_secs(op.time), max(lat / 1e6, 1e-3))
            )
        for typ, pts in sorted(by_type.items()):
            series.append(
                svg.Series(
                    f"{f} {typ}",
                    pts,
                    color=svg.TYPE_COLORS.get(typ),
                    mode="points",
                )
            )
    return svg.render(
        store_mod.path_(
            test, *opts.get("subdirectory", []), "latency-raw.svg"
        ),
        series,
        title=f"{test.get('name', 'test')} latency (raw)",
        ylabel="Latency (ms)",
        log_y=True,
        regions=graph_regions(test, history),
    )


def quantiles_graph(test: dict, history: History, opts: dict) -> Optional[str]:
    """Latency quantiles over time, one series per (f, quantile).
    (reference: perf.clj:513-557)"""
    by_f = invokes_by_f(history)
    dt = opts.get("dt", 10.0)
    series = []
    for f, ops in sorted(by_f.items(), key=lambda kv: str(kv[0])):
        pts = [
            (nanos_to_secs(op.time), max(op["latency"] / 1e6, 1e-3))
            for op in ops
            if op.get("latency") is not None
        ]
        for q, qpts in latencies_to_quantiles(dt, QUANTILES, pts).items():
            if qpts:
                series.append(svg.Series(f"{f} p{q}", qpts, mode="line"))
    return svg.render(
        store_mod.path_(
            test, *opts.get("subdirectory", []), "latency-quantiles.svg"
        ),
        series,
        title=f"{test.get('name', 'test')} latency (quantiles)",
        ylabel="Latency (ms)",
        log_y=True,
        regions=graph_regions(test, history),
    )


def rate_graph(test: dict, history: History, opts: dict) -> Optional[str]:
    """Throughput (ops/sec in dt windows) per (f, completion type).
    (reference: perf.clj:559-599)"""
    dt = opts.get("dt", 10.0)
    counts: Dict[Tuple[Any, str], Dict[int, int]] = {}
    for op in history:
        if op.type == INVOKE or not isinstance(op.process, int):
            continue
        key = (op.f, op.type)
        counts.setdefault(key, {}).setdefault(int(nanos_to_secs(op.time) // dt), 0)
        counts[key][int(nanos_to_secs(op.time) // dt)] += 1
    series = []
    for (f, typ), buckets in sorted(counts.items(), key=lambda kv: str(kv[0])):
        pts = [((b + 0.5) * dt, c / dt) for b, c in sorted(buckets.items())]
        series.append(
            svg.Series(f"{f} {typ}", pts, color=svg.TYPE_COLORS.get(typ), mode="line")
        )
    return svg.render(
        store_mod.path_(test, *opts.get("subdirectory", []), "rate.svg"),
        series,
        title=f"{test.get('name', 'test')} rate",
        ylabel="Throughput (hz)",
        regions=graph_regions(test, history),
    )


def scatter_plot(
    test: dict,
    series_map: Dict[Any, List[Tuple[float, float]]],
    path_components: List[Any],
    title: str = "",
    ylabel: str = "",
    history: Optional[History] = None,
) -> Optional[str]:
    """General named-series scatter (used by e.g. the bank plotter)."""
    series = [
        svg.Series(str(k), pts, mode="points")
        for k, pts in sorted(series_map.items(), key=lambda kv: str(kv[0]))
    ]
    regions = (
        graph_regions(test, history) if history is not None and len(history) else []
    )
    return svg.render(
        store_mod.path_(test, *path_components),
        series,
        title=title,
        ylabel=ylabel,
        regions=regions,
    )
