"""Transactional-cycle workloads: the checker half of
:mod:`jepsen_tpu.workloads.cycle` over the port's Elle
(:mod:`jepsen_tpu_torch.elle`), with the reference's anomaly artifacts
(one text file per anomaly type and an SVG of its first witness cycle
under ``<store>/<name>/<start-time>/elle/``).  The transaction generator
drives the test harness and is not ported.

(reference: jepsen/src/jepsen/tests/cycle.clj — the generic adapter —
plus cycle/append.clj and cycle/wr.clj)
"""

from __future__ import annotations

from typing import Any, List, Optional

from ...checker import Checker


def _fmt_anomaly_item(item: Any) -> str:
    """One anomaly instance as readable text: witness cycles render as
    step chains, everything else as indented JSON."""
    import json

    if isinstance(item, dict) and "steps" in item:
        lines = ["Cycle:"]
        for s in item["steps"]:
            rels = ",".join(s.get("rels", []))
            lines.append(f"  {s.get('from')} -[{rels}]-> {s.get('to')}")
        return "\n".join(lines)
    return json.dumps(item, indent=2, default=repr)


def _esc(s: Any) -> str:
    import html

    return html.escape(str(s), quote=True)


#: edge colors per dependency type (write-write, write-read, read-write,
#: process, realtime) — matching the conventional elle rendering
_REL_COLORS = {
    "ww": "#1f6feb", "wr": "#2da44e", "rw": "#cf222e",
    "process": "#8250df", "realtime": "#bf8700",
}


def cycle_svg(item: dict) -> Optional[str]:
    """One witness cycle as a standalone SVG: transactions on a circle,
    directed edges labeled and colored by dependency type — the
    graphviz-style anomaly rendering the reference ecosystem gets from
    Elle's plot-analysis, self-rendered like the rest of this
    framework's graphics (checker/svg.py replaces gnuplot the same
    way)."""
    import math

    steps = item.get("steps") or []
    if not steps:
        return None
    nodes = [s.get("from") for s in steps]
    n = len(nodes)
    R, pad = 150, 120
    cx = cy = R + pad
    size = 2 * (R + pad)
    pos = {}
    for i, node in enumerate(nodes):
        ang = -math.pi / 2 + 2 * math.pi * i / n
        pos[i] = (cx + R * math.cos(ang), cy + R * math.sin(ang))
    # one arrowhead marker per edge color (context-stroke would be
    # neater but isn't supported by Chromium-family viewers)
    colors_used = sorted(
        {
            _REL_COLORS.get((s.get("rels") or [""])[0], "#57606a")
            for s in steps
        }
    )
    markers = "".join(
        f'<marker id="arr{c.lstrip("#")}" viewBox="0 0 10 10" refX="9" '
        'refY="5" markerWidth="7" markerHeight="7" '
        f'orient="auto-start-reverse">'
        f'<path d="M 0 0 L 10 5 L 0 10 z" fill="{c}"/></marker>'
        for c in colors_used
    )
    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
        f'height="{size}" viewBox="0 0 {size} {size}" '
        'font-family="monospace" font-size="11">',
        f"<defs>{markers}</defs>",
        f'<rect width="{size}" height="{size}" fill="white"/>',
    ]
    node_r = 26
    for i, s in enumerate(steps):
        j = (i + 1) % n
        (x1, y1), (x2, y2) = pos[i], pos[j]
        # shorten the segment so the arrowhead lands on the node rim
        dx, dy = x2 - x1, y2 - y1
        d = math.hypot(dx, dy) or 1.0
        x1s, y1s = x1 + dx / d * node_r, y1 + dy / d * node_r
        x2s, y2s = x2 - dx / d * (node_r + 4), y2 - dy / d * (node_r + 4)
        rels = s.get("rels") or []
        color = _REL_COLORS.get(rels[0] if rels else "", "#57606a")
        out.append(
            f'<line x1="{x1s:.1f}" y1="{y1s:.1f}" x2="{x2s:.1f}" '
            f'y2="{y2s:.1f}" stroke="{color}" stroke-width="1.6" '
            f'marker-end="url(#arr{color.lstrip("#")})"/>'
        )
        mx, my = (x1s + x2s) / 2, (y1s + y2s) / 2
        out.append(
            f'<text x="{mx:.1f}" y="{my - 4:.1f}" fill="{color}" '
            f'text-anchor="middle">{_esc(",".join(rels))}</text>'
        )
    for i, node in enumerate(nodes):
        x, y = pos[i]
        label = str(node)
        short = label if len(label) <= 24 else label[:21] + "…"
        out.append(
            f'<g><circle cx="{x:.1f}" cy="{y:.1f}" r="{node_r}" '
            'fill="#f6f8fa" stroke="#57606a"/>'
            f"<title>{_esc(label)}</title>"
            f'<text x="{x:.1f}" y="{y + 4:.1f}" text-anchor="middle">'
            f"{_esc(short)}</text></g>"
        )
    out.append("</svg>")
    return "\n".join(out)


def write_anomaly_artifacts(test, result: dict, opts=None) -> None:
    """Persist one explanation file per anomaly type under
    ``<store>/<test>/<time>/elle/`` so the web UI's directory browser
    surfaces them next to results.json — the artifact the reference
    gets from Elle's :directory option (consumed at
    jepsen/src/jepsen/tests/cycle.clj:10-16).  Only runs when the test
    has a real store identity; adds the written paths to the result as
    "anomaly-files"."""
    if not (test and test.get("name") and test.get("start-time")):
        return
    anomalies = {
        **(result.get("anomalies") or {}),
        **(result.get("also-anomalies") or {}),
    }
    if not anomalies:
        return
    from ... import store as store_mod

    paths: List[str] = []
    try:
        for name, items in sorted(anomalies.items()):
            p = store_mod.path_(
                test,
                *(opts or {}).get("subdirectory", []),
                "elle",
                f"{name}.txt",
            )
            with open(p, "w") as f:
                f.write(f"{name}: {len(items)} instance(s)\n\n")
                for i, item in enumerate(items):
                    f.write(f"--- instance {i} ---\n")
                    f.write(_fmt_anomaly_item(item))
                    f.write("\n\n")
            paths.append(p)
            # first witness cycle per type also renders as an SVG next
            # to the text file (reference ecosystem: elle plot-analysis)
            for item in items:
                svg = cycle_svg(item) if isinstance(item, dict) else None
                if svg:
                    sp = store_mod.path_(
                        test,
                        *(opts or {}).get("subdirectory", []),
                        "elle",
                        f"{name}.svg",
                    )
                    with open(sp, "w") as f:
                        f.write(svg)
                    paths.append(sp)
                    break
        result["anomaly-files"] = paths
    except Exception as e:  # noqa: BLE001 — never mask the verdict
        result["anomaly-files-error"] = repr(e)


class _ElleChecker(Checker):
    def __init__(self, workload: str, opts: Optional[dict], device=None,
                 client=None):
        self.workload = workload
        self.opts = dict(opts or {})
        self.device = device
        self.client = client

    def check(self, test, history, opts=None):
        from ... import elle

        out = elle.check(
            {**self.opts, "workload": self.workload}, history, self.device,
            self.client,
        )
        write_anomaly_artifacts(test, out, opts)
        return out


def checker(workload: str, opts: Optional[dict] = None,
            device=None, client=None) -> Checker:
    """A checker running the elle analysis for a txn workload; its screens
    run on ``device`` (None: the current CUDA device; the ``"cpu"``
    screen route needs none), or on the checker daemon behind ``client``
    (a :class:`~jepsen_tpu_torch.serve.client.ServiceClient`).
    (reference: cycle.clj:9-16)"""
    return _ElleChecker(workload, opts, device, client)
