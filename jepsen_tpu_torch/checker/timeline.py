"""HTML gantt timeline of operations per process.

(reference: jepsen/src/jepsen/checker/timeline.clj — op-limit 10000:12-14,
timescale 1e6 ns/px:23, pairs:37, html:180)
"""

from __future__ import annotations

import html as html_mod
from typing import Any, Dict, List, Tuple

from .. import store as store_mod
from ..history import History, INVOKE, OK, FAIL, INFO
from . import Checker

#: Maximum operations to render.  (reference: timeline.clj:12-14)
OP_LIMIT = 10_000

TIMESCALE = 1e6  # nanoseconds per pixel (reference: timeline.clj:23)
COL_WIDTH = 100  # pixels
GUTTER_WIDTH = 106
HEIGHT = 16

STYLESHEET = """\
.ops        { position: absolute; }
.op         { position: absolute; padding: 2px; border-radius: 2px;
              box-shadow: 0 1px 3px rgba(0,0,0,0.2); overflow: hidden; }
.op.invoke  { background: #eeeeee; }
.op.ok      { background: #6DB6FE; }
.op.info    { background: #FFAA26; }
.op.fail    { background: #FEB5DA; }
"""


def pairs(history: History) -> List[Tuple]:
    """[invoke, completion] / [op] pairs in completion order.
    (reference: timeline.clj:37-58)"""
    invocations: Dict[Any, Any] = {}
    out: List[Tuple] = []
    for op in history:
        if op.type == INVOKE:
            invocations[op.process] = op
        elif op.type == INFO and op.process not in invocations:
            out.append((op,))  # unmatched info (e.g. nemesis)
        else:
            inv = invocations.pop(op.process, None)
            if inv is not None:
                out.append((inv, op))
            else:
                out.append((op,))
    # still-open invocations render as half-pairs
    for inv in invocations.values():
        out.append((inv,))
    return out


def process_index(history: History) -> Dict[Any, int]:
    """Process -> render column, in order of first appearance."""
    index: Dict[Any, int] = {}
    for op in history:
        if op.process not in index:
            index[op.process] = len(index)
    return index


def _title(op, comp=None) -> str:
    lines = [f"{op.process} {op.f} {op.value!r}"]
    if comp is not None:
        lines.append(f"-> {comp.type} {comp.value!r}")
        if comp.error:
            lines.append(f"error: {comp.error}")
    return "\n".join(lines)


def pair_div(pair: Tuple, pindex: Dict[Any, int], t_end: int) -> str:
    op = pair[0]
    comp = pair[1] if len(pair) > 1 else None
    final = comp or op
    t0 = op.time
    t1 = comp.time if comp is not None else t_end
    left = GUTTER_WIDTH + pindex.get(op.process, 0) * (COL_WIDTH + 10)
    top = t0 / TIMESCALE
    height = max((t1 - t0) / TIMESCALE, HEIGHT)
    cls = final.type if final.type in (OK, FAIL, INFO) else "invoke"
    label = f"{op.f} {op.value!r}" if op.value is not None else f"{op.f}"
    return (
        f'<div class="op {cls}" id="op-{op.index}" '
        f'style="left:{left}px; top:{top:.0f}px; width:{COL_WIDTH}px; '
        f'height:{height:.0f}px" '
        f'title="{html_mod.escape(_title(op, comp))}">'
        f"{html_mod.escape(label)}</div>"
    )


class _TimelineHtml(Checker):
    def check(self, test, history, opts=None):
        opts = opts or {}
        if not test.get("store?", True):
            return {"valid?": True}
        ps = pairs(history)
        total_pairs = len(ps)
        truncated = total_pairs > OP_LIMIT
        ps = ps[:OP_LIMIT]
        pindex = process_index(history)
        t_end = history[-1].time if len(history) else 0
        key = opts.get("history-key")
        title = f"{test.get('name', 'test')}" + (
            f" key {key}" if key is not None else ""
        )
        body = [f"<h1>{html_mod.escape(title)}</h1>"]
        if truncated:
            body.append(
                f'<div class="truncation-warning">Showing only {OP_LIMIT} '
                f"of {total_pairs} operations in this history.</div>"
            )
        # column headers: process names
        for p, i in pindex.items():
            left = GUTTER_WIDTH + i * (COL_WIDTH + 10)
            body.append(
                f'<div style="position:absolute; left:{left}px; top:40px; '
                f'font-weight:bold">{html_mod.escape(str(p))}</div>'
            )
        body.append(
            '<div class="ops" style="top:60px; position:relative">'
            + "\n".join(pair_div(p, pindex, t_end) for p in ps)
            + "</div>"
        )
        doc = (
            "<html><head><style>"
            + STYLESHEET
            + "</style></head><body>"
            + "\n".join(body)
            + "</body></html>"
        )
        path = store_mod.path_(
            test, *opts.get("subdirectory", []), "timeline.html"
        )
        with open(path, "w") as f:
            f.write(doc)
        return {"valid?": True}


def html() -> Checker:
    """(reference: timeline.clj:180-209)"""
    return _TimelineHtml()
