"""Clock-skew-over-time plot — the port's copy of
:mod:`jepsen_tpu.checker.clock`.

Any op carrying a ``clock-offsets`` map (node -> offset seconds, emitted
by the clock nemesis) contributes points; offsets render as step series
per node.  (reference: jepsen/src/jepsen/checker/clock.clj)
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from .. import store as store_mod
from ..history import History
from . import Checker, perf, svg


def history_to_datasets(history: History) -> Dict[Any, List[Tuple[float, float]]]:
    """node -> [t, offset] series, extended to the end of the history.
    (reference: clock.clj:13-34)"""
    series: Dict[Any, List[Tuple[float, float]]] = {}
    if not len(history):
        return series
    final_t = perf.nanos_to_secs(history[-1].time)
    for op in history:
        offsets = op.get("clock-offsets")
        if not offsets:
            continue
        t = perf.nanos_to_secs(op.time)
        for node, offset in offsets.items():
            series.setdefault(node, []).append((t, offset))
    for pts in series.values():
        pts.append((final_t, pts[-1][1]))
    return series


def short_node_names(nodes: List[str]) -> List[str]:
    """Strip a common domain suffix from node names.
    (reference: clock.clj:36-45)"""
    if not nodes:
        return []
    split = [str(n).split(".") for n in nodes]
    # find the longest common proper suffix
    min_len = min(len(s) for s in split)
    common = 0
    while common < min_len - 1 and len({tuple(s[len(s) - common - 1 :]) for s in split}) == 1:
        common += 1
    return [".".join(s[: len(s) - common]) for s in split]


def plot(test: dict, history: History, opts: dict) -> dict:
    """(reference: clock.clj:47-80)"""
    datasets = history_to_datasets(history)
    if datasets:
        nodes = sorted(datasets.keys(), key=str)
        names = short_node_names([str(n) for n in nodes])
        series = [
            svg.Series(name, datasets[node], mode="steps")
            for node, name in zip(nodes, names)
        ]
        svg.render(
            store_mod.path_(
                test, *opts.get("subdirectory", []), "clock-skew.svg"
            ),
            series,
            title=f"{test.get('name', 'test')} clock skew",
            ylabel="Skew (s)",
            regions=perf.nemesis_regions(test, history),
        )
    return {"valid?": True}


class _ClockPlot(Checker):
    def check(self, test, history, opts=None):
        if not test.get("store?", True):
            return {"valid?": True}
        return plot(test, history, opts or {})


def plotter() -> Checker:
    return _ClockPlot()
