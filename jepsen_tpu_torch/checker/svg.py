"""A tiny self-contained SVG plot engine — the port's copy of
:mod:`jepsen_tpu.checker.svg`.

The reference shells out to gnuplot for latency/rate/clock plots
(jepsen/src/jepsen/checker/perf.clj via gnuplot.core); we render SVG
directly — no external binaries, works anywhere the framework runs.

A plot is: axes with ticks, optional log-y, shaded background regions
(nemesis activity), and a list of series, each drawn as points, a line,
or steps, with a legend.
"""

from __future__ import annotations

import math
import os
from typing import Any, List, Optional, Sequence, Tuple

#: Default categorical palette (dark-on-light friendly).
PALETTE = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]

#: Colors for op completion types (timeline + latency plots share these).
TYPE_COLORS = {"ok": "#6DB6FE", "info": "#FFAA26", "fail": "#FEB5DA"}

WIDTH, HEIGHT = 900, 400
MARGIN_L, MARGIN_R, MARGIN_T, MARGIN_B = 70, 160, 40, 50


class Series:
    def __init__(
        self,
        title: str,
        points: Sequence[Tuple[float, float]],
        color: Optional[str] = None,
        mode: str = "line",  # line | points | steps
    ):
        self.title = title
        self.points = [(float(x), float(y)) for x, y in points]
        self.color = color
        self.mode = mode


class Region:
    """A shaded vertical band [x0, x1] with an optional label."""

    def __init__(self, x0: float, x1: float, color: str = "#000000", opacity: float = 0.07, label: str = ""):
        self.x0 = x0
        self.x1 = x1
        self.color = color
        self.opacity = opacity
        self.label = label


def _nice_ticks(lo: float, hi: float, n: int = 6) -> List[float]:
    if hi <= lo:
        hi = lo + 1.0
    span = hi - lo
    step = 10 ** math.floor(math.log10(span / max(n, 1)))
    for mult in (1, 2, 5, 10):
        if span / (step * mult) <= n:
            step *= mult
            break
    first = math.ceil(lo / step) * step
    ticks = []
    t = first
    while t <= hi + 1e-12:
        ticks.append(round(t, 10))
        t += step
    return ticks


def _log_ticks(lo: float, hi: float) -> List[float]:
    lo = max(lo, 1e-12)
    ticks = []
    e = math.floor(math.log10(lo))
    while 10**e <= hi * 1.0001:
        if 10**e >= lo * 0.9999:
            ticks.append(10**e)
        e += 1
    return ticks or [lo, hi]


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    a = abs(v)
    if a >= 1e6 or a < 1e-3:
        return f"{v:.0e}"
    if a >= 100:
        return f"{v:.0f}"
    if a >= 1:
        return f"{v:g}"
    return f"{v:g}"


def _esc(s: Any) -> str:
    return (
        str(s)
        .replace("&", "&amp;")
        .replace("<", "&lt;")
        .replace(">", "&gt;")
        .replace('"', "&quot;")
    )


def render(
    path: str,
    series: List[Series],
    title: str = "",
    xlabel: str = "Time (s)",
    ylabel: str = "",
    regions: Optional[List[Region]] = None,
    log_y: bool = False,
    x_range: Optional[Tuple[float, float]] = None,
    y_range: Optional[Tuple[float, float]] = None,
) -> Optional[str]:
    """Render series to an SVG file.  Returns the path, or None if there
    was nothing to draw."""
    pts = [p for s in series for p in s.points]
    if not pts:
        return None

    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x_lo, x_hi = x_range or (min(xs + [0.0]), max(xs) or 1.0)
    if log_y:
        pos = [y for y in ys if y > 0]
        y_lo, y_hi = y_range or (min(pos) if pos else 1e-3, max(pos) if pos else 1.0)
        y_lo = max(y_lo, 1e-12)
    else:
        y_lo, y_hi = y_range or (min(ys + [0.0]), max(ys) or 1.0)
    if x_hi <= x_lo:
        x_hi = x_lo + 1.0
    if y_hi <= y_lo:
        y_hi = y_lo + 1.0

    plot_w = WIDTH - MARGIN_L - MARGIN_R
    plot_h = HEIGHT - MARGIN_T - MARGIN_B

    def sx(x: float) -> float:
        return MARGIN_L + (x - x_lo) / (x_hi - x_lo) * plot_w

    def sy(y: float) -> float:
        if log_y:
            y = max(y, y_lo)
            f = (math.log10(y) - math.log10(y_lo)) / (
                math.log10(y_hi) - math.log10(y_lo)
            )
        else:
            f = (y - y_lo) / (y_hi - y_lo)
        return MARGIN_T + plot_h * (1 - f)

    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{WIDTH}" height="{HEIGHT}" '
        f'viewBox="0 0 {WIDTH} {HEIGHT}" font-family="sans-serif" font-size="11">',
        f'<rect width="{WIDTH}" height="{HEIGHT}" fill="white"/>',
    ]

    # shaded regions (clipped to the plot area)
    for rg in regions or []:
        rx0, rx1 = max(x_lo, rg.x0), min(x_hi, rg.x1)
        if rx1 <= rx0:
            continue
        out.append(
            f'<rect x="{sx(rx0):.1f}" y="{MARGIN_T}" '
            f'width="{max(sx(rx1) - sx(rx0), 1):.1f}" height="{plot_h}" '
            f'fill="{rg.color}" opacity="{rg.opacity}"/>'
        )
        if rg.label:
            out.append(
                f'<text x="{sx(rx0) + 2:.1f}" y="{MARGIN_T + 10}" '
                f'font-size="9" fill="#555">{_esc(rg.label)}</text>'
            )

    # axes + ticks
    out.append(
        f'<rect x="{MARGIN_L}" y="{MARGIN_T}" width="{plot_w}" height="{plot_h}" '
        f'fill="none" stroke="#999"/>'
    )
    for t in _nice_ticks(x_lo, x_hi):
        if t < x_lo or t > x_hi:
            continue
        out.append(
            f'<line x1="{sx(t):.1f}" y1="{MARGIN_T + plot_h}" x2="{sx(t):.1f}" '
            f'y2="{MARGIN_T + plot_h + 4}" stroke="#999"/>'
            f'<text x="{sx(t):.1f}" y="{MARGIN_T + plot_h + 16}" '
            f'text-anchor="middle">{_fmt(t)}</text>'
        )
    yticks = _log_ticks(y_lo, y_hi) if log_y else _nice_ticks(y_lo, y_hi)
    for t in yticks:
        if t < y_lo * 0.999 or t > y_hi * 1.001:
            continue
        out.append(
            f'<line x1="{MARGIN_L - 4}" y1="{sy(t):.1f}" x2="{MARGIN_L}" '
            f'y2="{sy(t):.1f}" stroke="#999"/>'
            f'<line x1="{MARGIN_L}" y1="{sy(t):.1f}" x2="{MARGIN_L + plot_w}" '
            f'y2="{sy(t):.1f}" stroke="#eee"/>'
            f'<text x="{MARGIN_L - 7}" y="{sy(t) + 3:.1f}" '
            f'text-anchor="end">{_fmt(t)}</text>'
        )

    # series
    for i, s in enumerate(series):
        color = s.color or PALETTE[i % len(PALETTE)]
        if s.mode == "points":
            for x, y in s.points:
                out.append(
                    f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="1.6" '
                    f'fill="{color}" fill-opacity="0.65"/>'
                )
        else:
            coords = []
            prev = None
            for x, y in sorted(s.points):
                if s.mode == "steps" and prev is not None:
                    coords.append(f"{sx(x):.1f},{sy(prev):.1f}")
                coords.append(f"{sx(x):.1f},{sy(y):.1f}")
                prev = y
            out.append(
                f'<polyline points="{" ".join(coords)}" fill="none" '
                f'stroke="{color}" stroke-width="1.3"/>'
            )

    # labels + legend
    if title:
        out.append(
            f'<text x="{WIDTH / 2:.0f}" y="20" text-anchor="middle" '
            f'font-size="14">{_esc(title)}</text>'
        )
    out.append(
        f'<text x="{MARGIN_L + plot_w / 2:.0f}" y="{HEIGHT - 8}" '
        f'text-anchor="middle">{_esc(xlabel)}</text>'
    )
    if ylabel:
        out.append(
            f'<text x="14" y="{MARGIN_T + plot_h / 2:.0f}" text-anchor="middle" '
            f'transform="rotate(-90 14 {MARGIN_T + plot_h / 2:.0f})">'
            f"{_esc(ylabel)}</text>"
        )
    ly = MARGIN_T + 6
    for i, s in enumerate(series):
        color = s.color or PALETTE[i % len(PALETTE)]
        out.append(
            f'<rect x="{WIDTH - MARGIN_R + 10}" y="{ly - 8}" width="10" '
            f'height="10" fill="{color}"/>'
            f'<text x="{WIDTH - MARGIN_R + 24}" y="{ly + 1}">{_esc(s.title)}</text>'
        )
        ly += 16

    out.append("</svg>")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(out))
    return path
