"""Failure-witness rendering for the linearizable checker — a copy of
:mod:`jepsen_tpu.checker.linear_svg` on the port's own oracle and models,
so the same failing history renders the same bytes.

When an analysis comes back invalid, render ``linear.svg``: a timeline
of the operations concurrent with the failure, plus every surviving
configuration's linearization path (state → op → state …) and the
reason the completing op could not be linearized from it.  This is the
role knossos.linear.report/render-analysis! plays for the reference
(jepsen/src/jepsen/checker.clj:206-210 writes it to
``<store>/linear.svg`` whenever the linearizable checker fails).

The layout is two stacked panels:

- **timeline**: one row per process, a bar per op spanning its
  invoke→complete events (index-compressed time), the failing op in red,
  still-open (info) ops ragged on the right.
- **paths**: one lane per final config — the chain of model states and
  linearized pending ops since the last completed op, ending in a red
  annotation explaining why stepping the failing op from that state is
  inconsistent.
"""

from __future__ import annotations

import html
from typing import Any, Dict, List, Optional

from ..history import History
from ..models import Model

FONT = "font-family='Helvetica,Arial,sans-serif'"
BAR_H = 22
ROW_GAP = 10
CHAR_W = 7.2


def _esc(s: Any) -> str:
    return html.escape(str(s), quote=True)


def _op_label(op: dict) -> str:
    v = op.get("value")
    return f"{op.get('f')} {v}" if v is not None else str(op.get("f"))


def _text(x, y, s, size=12, fill="#222", anchor="start", weight="normal"):
    return (
        f"<text x='{x:.1f}' y='{y:.1f}' font-size='{size}' fill='{fill}' "
        f"text-anchor='{anchor}' font-weight='{weight}' {FONT}>{_esc(s)}</text>"
    )


def render_witness(
    model: Model,
    history: History,
    result: dict,
    path: str,
    pure_fs=(),
    budget_s=None,
) -> Optional[str]:
    """Render the failure witness for an invalid analysis to ``path``.
    Reruns the CPU oracle with witness tracking when ``result`` lacks
    path data (the device kernels report verdicts only) — under
    ``budget_s`` when given, so a kernel-found failure on an
    exponential-class history can't hang witness rendering.  Returns
    the path, or None when the analysis isn't a definite failure (or
    the budgeted rerun came back unknown)."""
    from . import linear

    if result.get("valid?") is not False:
        return None
    if "final-paths" not in result or "ops" not in result:
        result = linear.analysis(
            model, history, pure_fs=pure_fs, witness=True,
            budget_s=budget_s,
        )
        if result.get("valid?") is not False:
            return None  # oracle disagrees or budget blown — no witness

    ops: List[dict] = result["ops"]
    failed_id: int = result["failed-op-id"]
    paths: List[dict] = result.get("final-paths", [])[:10]
    open_ids = set(result.get("open-ops", []))

    # ---- timeline panel: ops overlapping the failing op -------------
    failed = ops[failed_id]
    # ops relevant to the shown paths come first; then a bounded sample
    # of the remaining open ops (a long run can hold thousands of
    # crashed-open ops — an uncapped window renders an unusably wide SVG)
    path_ids = {
        s["op-id"]
        for p in paths
        for s in p["steps"]
        if isinstance(s.get("op-id"), int)
    } | {i for p in paths for i in p.get("pending", []) if isinstance(i, int)}
    window_ids = {failed_id} | path_ids
    open_extra = sorted(open_ids - window_ids)
    n_hidden = max(0, len(open_extra) - 12)
    window_ids = sorted(window_ids | set(open_extra[:12]))
    # index-compressed x axis over the window's op order
    window_ids = [i for i in window_ids if 0 <= i < len(ops)][:24]
    procs = sorted({ops[i].get("process") for i in window_ids}, key=str)
    xw = max(160, 120 * len(window_ids))
    label_w = 70
    width = label_w + xw + 260
    y = 48

    body = [_text(12, 24, "Linearizability failure witness", 16, weight="bold")]
    body.append(
        _text(
            12,
            40,
            f"op {_op_label(failed)} (process {failed.get('process')}) "
            "could not be linearized",
            12,
            fill="#b91c1c",
        )
    )

    xs = {op_id: label_w + 20 + k * 120 for k, op_id in enumerate(window_ids)}
    rows = {p: y + i * (BAR_H + ROW_GAP) for i, p in enumerate(procs)}
    for op_id in window_ids:
        op = ops[op_id]
        ry = rows[op.get("process")]
        x0 = xs[op_id]
        is_failed = op_id == failed_id
        is_open = op_id in open_ids and not is_failed
        w = 108
        fill = "#fecaca" if is_failed else ("#fde68a" if is_open else "#bfdbfe")
        stroke = "#b91c1c" if is_failed else "#64748b"
        dash = " stroke-dasharray='4,3'" if is_open else ""
        body.append(
            f"<rect x='{x0}' y='{ry}' width='{w}' height='{BAR_H}' rx='4' "
            f"fill='{fill}' stroke='{stroke}'{dash}/>"
        )
        body.append(
            _text(x0 + w / 2, ry + BAR_H - 7, _op_label(op), 11, anchor="middle")
        )
    for p, ry in rows.items():
        body.append(_text(8, ry + BAR_H - 6, f"p{p}", 12, fill="#475569"))
    if n_hidden:
        body.append(
            _text(
                label_w + 20,
                y + len(procs) * (BAR_H + ROW_GAP) + 8,
                f"(+{n_hidden} more open ops not shown)",
                11,
                fill="#94a3b8",
            )
        )

    # ---- paths panel ------------------------------------------------
    py = y + len(procs) * (BAR_H + ROW_GAP) + 30
    body.append(
        _text(12, py, f"final configs ({len(paths)} shown)", 13, weight="bold")
    )
    py += 10
    max_x = width
    for p in paths:
        py += BAR_H + ROW_GAP
        x = 16
        chain = [("state", p["init"])]
        for s in p["steps"]:
            chain.append(("op", _op_label(s["op"])))
            chain.append(("state", s["model"]))
        for kind, label in chain:
            w = max(40, len(str(label)) * CHAR_W + 14)
            if kind == "state":
                body.append(
                    f"<rect x='{x}' y='{py - BAR_H + 6}' width='{w:.0f}' "
                    f"height='{BAR_H}' rx='10' fill='#e2e8f0' stroke='#64748b'/>"
                )
            else:
                body.append(
                    f"<rect x='{x}' y='{py - BAR_H + 6}' width='{w:.0f}' "
                    f"height='{BAR_H}' fill='#dbeafe' stroke='#2563eb'/>"
                )
            body.append(
                _text(x + w / 2, py, label, 11, anchor="middle")
            )
            x += w + 26
            body.append(
                f"<line x1='{x - 24:.0f}' y1='{py - 5}' x2='{x - 4:.0f}' "
                f"y2='{py - 5}' stroke='#94a3b8' marker-end='url(#arr)'/>"
            )
        # the failing step, annotated with the model's complaint
        # (computed by the oracle from the real config state)
        why = p.get("why", "inconsistent")
        lbl = f"✗ {_op_label(failed)}: {why}"
        w = len(lbl) * CHAR_W + 14
        body.append(
            f"<rect x='{x}' y='{py - BAR_H + 6}' width='{w:.0f}' "
            f"height='{BAR_H}' fill='#fee2e2' stroke='#b91c1c' "
            "stroke-dasharray='4,3'/>"
        )
        body.append(_text(x + w / 2, py, lbl, 11, "#b91c1c", anchor="middle"))
        max_x = max(max_x, x + w + 20)

    height = py + BAR_H + 20
    svg = (
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{max_x:.0f}' "
        f"height='{height:.0f}' viewBox='0 0 {max_x:.0f} {height:.0f}'>"
        "<defs><marker id='arr' markerWidth='8' markerHeight='8' refX='7' "
        "refY='3' orient='auto'><path d='M0,0 L7,3 L0,6 z' fill='#94a3b8'/>"
        "</marker></defs>"
        f"<rect width='100%' height='100%' fill='white'/>{''.join(body)}</svg>"
    )
    with open(path, "w") as f:
        f.write(svg)
    return path


