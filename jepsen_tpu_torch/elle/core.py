"""Transaction extraction plus process/realtime dependency graphs.

The realtime construction uses the interval-order frontier reduction:
edges are added from every frontier member at each invocation, and a
completion evicts frontier members it fully supersedes — the transitive
closure equals the true precedes-in-realtime relation without O(n²)
edges.  The port's copy of :mod:`jepsen_tpu.elle.core`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..history import History, Op, INVOKE, OK, FAIL, INFO
from .graph import Graph, PROCESS, REALTIME


class Txn:
    """One committed (or attempted) transaction: the invoke/completion
    pair, value = list of micro-ops."""

    __slots__ = ("invoke", "complete", "index")

    def __init__(self, invoke: Op, complete: Optional[Op], index: int):
        self.invoke = invoke
        self.complete = complete
        self.index = index  # position among txns; stable vertex id

    @property
    def ok(self) -> bool:
        return self.complete is not None and self.complete.type == OK

    @property
    def failed(self) -> bool:
        return self.complete is not None and self.complete.type == FAIL

    @property
    def value(self) -> list:
        """The committed mops when ok (completion value), else the
        attempted mops."""
        if self.ok and self.complete.value is not None:
            return self.complete.value
        return self.invoke.value or []

    @property
    def process(self) -> Any:
        return self.invoke.process

    def __repr__(self) -> str:
        t = self.complete.type if self.complete else "?"
        return f"T{self.index}({t} {self.value!r})"

    def __hash__(self) -> int:
        return self.index

    def __eq__(self, other) -> bool:
        return isinstance(other, Txn) and other.index == self.index


def transactions(history: History) -> List[Txn]:
    """Pair invocations with completions, in invocation order."""
    txns: List[Txn] = []
    open_by_process: Dict[Any, Txn] = {}
    for op in history:
        if not isinstance(op.process, int):
            continue
        if op.type == INVOKE:
            t = Txn(op, None, len(txns))
            txns.append(t)
            open_by_process[op.process] = t
        else:
            t = open_by_process.pop(op.process, None)
            if t is not None:
                t.complete = op
    return txns


def process_graph(txns: List[Txn]) -> Graph:
    """Successive ok txns of one process, in order."""
    g = Graph()
    last: Dict[Any, Txn] = {}
    for t in txns:
        if not t.ok:
            continue
        g.add_vertex(t)
        prev = last.get(t.process)
        if prev is not None:
            g.add_edge(prev, t, PROCESS)
        last[t.process] = t
    return g


def realtime_graph(txns: List[Txn]) -> Graph:
    """T1 → T2 when T1's completion precedes T2's invocation, reduced to
    a frontier relation whose transitive closure is the full interval
    order."""
    g = Graph()
    events: List[Tuple[int, int, str, Txn]] = []
    for t in txns:
        if not t.ok:
            continue
        g.add_vertex(t)
        events.append((t.invoke.time, t.index, "invoke", t))
        events.append((t.complete.time, t.index, "complete", t))
    events.sort(key=lambda e: (e[0], e[1]))
    frontier: List[Txn] = []
    for _, _, kind, t in events:
        if kind == "invoke":
            for f in frontier:
                g.add_edge(f, t, REALTIME)
        else:
            frontier = [f for f in frontier if f.complete.time >= t.invoke.time]
            frontier.append(t)
    return g
