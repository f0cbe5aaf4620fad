"""List-append transactional anomaly analysis.

Transactions are lists of micro-ops ``["append", k, v]`` /
``["r", k, [v1 v2 …]]`` with globally unique appended values per key.
Reads observe the full list, so every read of a key is a *version*: the
prefix relation over observed lists recovers the version order exactly,
and write-write / write-read / read-write dependencies follow without
guesswork.  That soundness argument is the reason the reference's Elle
treats list-append as its strongest mode (consumed at
jepsen/src/jepsen/tests/cycle/append.clj:12-21).

Anomalies detected: internal, G1a (aborted read), G1b (intermediate
read), dirty-update, duplicate-elements, incompatible-order, plus the
cycle anomalies G0 / G1c / G-single / G2-item (with -realtime /
-process variants when those graphs are enabled).  The port of
:mod:`jepsen_tpu.elle.list_append`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Set, Tuple

from ..history import History
from ..txn import APPEND, R
from . import core
from .core import Txn
from .graph import Graph, WW, WR, RW, PROCESS, REALTIME
from . import cycles as cycles_mod


def mops(t: Txn):
    return t.value or []


def internal_cases(txns: List[Txn]) -> List[dict]:
    """Reads inconsistent with the txn's *own* prior reads/appends: after
    reading k as L then appending x, a later read of k must be exactly
    L+[x…]; after appending without a prior read, a later read must end
    with the appended suffix."""
    cases = []
    for t in txns:
        if not t.ok:
            continue
        # key -> ("exact", list) after a read, ("suffix", list) append-only
        state: Dict[Any, Tuple[str, List[Any]]] = {}
        for f, k, v in mops(t):
            if f == APPEND:
                kind, lst = state.get(k, ("suffix", []))
                state[k] = (kind, lst + [v])
            elif f == R:
                v = list(v or [])
                if k in state:
                    kind, lst = state[k]
                    bad = (
                        v != lst
                        if kind == "exact"
                        else (len(v) < len(lst) or v[len(v) - len(lst) :] != lst)
                    )
                    if bad:
                        cases.append(
                            {
                                "op": t.complete.to_dict(),
                                "mop": [f, k, v],
                                "expected": {"kind": kind, "value": lst},
                            }
                        )
                state[k] = ("exact", v)
    return cases


def g1a_cases(txns: List[Txn]) -> List[dict]:
    """Reads of values appended by failed txns."""
    failed: Set[Tuple[Any, Any]] = {
        (k, v)
        for t in txns
        if t.failed
        for f, k, v in mops(t)
        if f == APPEND
    }
    cases = []
    for t in txns:
        if not t.ok:
            continue
        for f, k, v in mops(t):
            if f != R:
                continue
            for element in v or []:
                if (k, element) in failed:
                    cases.append(
                        {
                            "op": t.complete.to_dict(),
                            "mop": [f, k, list(v)],
                            "element": element,
                        }
                    )
    return cases


def g1b_cases(
    txns: List[Txn], appends_by_txn: Dict[Txn, Dict[Any, List[Any]]]
) -> List[dict]:
    """Reads observing an *intermediate* state of some txn: the read's
    list ends inside a txn's appends to that key (sees some but not the
    final one)."""
    # (k, element) -> (txn, position among txn's appends to k, total)
    pos: Dict[Tuple[Any, Any], Tuple[Txn, int, int]] = {}
    for t, per_key in appends_by_txn.items():
        for k, els in per_key.items():
            for i, el in enumerate(els):
                pos[(k, el)] = (t, i, len(els))
    cases = []
    for t in txns:
        if not t.ok:
            continue
        for f, k, v in mops(t):
            if f != R or not v:
                continue
            last = v[-1]
            hit = pos.get((k, last))
            if hit is not None:
                writer, i, total = hit
                if i < total - 1 and writer is not t:
                    cases.append(
                        {
                            "op": t.complete.to_dict(),
                            "mop": [f, k, list(v)],
                            "element": last,
                        }
                    )
    return cases


def duplicate_cases(txns: List[Txn]) -> List[dict]:
    """A read observing the same element twice."""
    cases = []
    for t in txns:
        if not t.ok:
            continue
        for f, k, v in mops(t):
            if f != R or not v:
                continue
            seen: Set[Any] = set()
            dups = []
            for el in v:
                if el in seen:
                    dups.append(el)
                seen.add(el)
            if dups:
                cases.append(
                    {"op": t.complete.to_dict(), "mop": [f, k, list(v)],
                     "duplicates": dups}
                )
    return cases


def version_orders(
    txns: List[Txn],
) -> Tuple[Dict[Any, List[Any]], List[dict]]:
    """Per-key total order of elements from read prefixes.

    All reads of a key must be prefix-comparable; the longest read is the
    order.  Returns (orders, incompatible-order cases)."""
    longest: Dict[Any, List[Any]] = {}
    incompatible: List[dict] = []
    seen_reads: Dict[Any, List[Tuple[Txn, List[Any]]]] = defaultdict(list)
    for t in txns:
        if not t.ok:
            continue
        for f, k, v in mops(t):
            if f != R or v is None:
                continue
            v = list(v)
            seen_reads[k].append((t, v))
            cur = longest.get(k)
            if cur is None or len(v) > len(cur):
                longest[k] = v
    for k, reads in seen_reads.items():
        order = longest.get(k) or []
        for t, v in reads:
            if v != order[: len(v)]:
                incompatible.append(
                    {"key": k, "read": v, "longest": order,
                     "op": t.complete.to_dict()}
                )
    return longest, incompatible


def graph_and_anomalies(
    history: History,
    extra_graphs: Tuple[str, ...] = (),
) -> Tuple[Graph, List[Txn], Dict[str, list]]:
    """Build the dependency graph and collect non-cycle anomalies."""
    txns = core.transactions(history)
    anomalies: Dict[str, list] = {}

    appends_by_txn: Dict[Txn, Dict[Any, List[Any]]] = {}
    writer_of: Dict[Tuple[Any, Any], Txn] = {}
    for t in txns:
        if t.failed:
            continue  # failed appends never took effect (except G1a checks)
        per_key: Dict[Any, List[Any]] = defaultdict(list)
        for f, k, v in mops(t):
            if f == APPEND:
                per_key[k].append(v)
                writer_of[(k, v)] = t
        if per_key:
            appends_by_txn[t] = dict(per_key)

    internal = internal_cases(txns)
    if internal:
        anomalies["internal"] = internal
    g1a = g1a_cases(txns)
    if g1a:
        anomalies["G1a"] = g1a
    g1b = g1b_cases(txns, appends_by_txn)
    if g1b:
        anomalies["G1b"] = g1b
    dups = duplicate_cases(txns)
    if dups:
        anomalies["duplicate-elements"] = dups

    orders, incompatible = version_orders(txns)
    if incompatible:
        anomalies["incompatible-order"] = incompatible

    g = Graph()
    for t in txns:
        if t.ok:
            g.add_vertex(t)

    # Elements appended but never observed extend the version order only
    # when a single txn appended them (order within a txn is known).
    for k, order in orders.items():
        # ww: consecutive elements in the version order
        for a, b in zip(order, order[1:]):
            wa, wb = writer_of.get((k, a)), writer_of.get((k, b))
            if wa is not None and wb is not None and wa.ok and wb.ok:
                g.add_edge(wa, wb, WW)

    for t in txns:
        if not t.ok:
            continue
        own = appends_by_txn.get(t, {})
        for f, k, v in mops(t):
            if f != R:
                continue
            v = list(v or [])
            # strip our own appended suffix: deps are external
            own_els = own.get(k, [])
            while v and own_els and v[-1] in own_els:
                v.pop()
            if v:
                w = writer_of.get((k, v[-1]))
                if w is not None and w.ok and w is not t:
                    g.add_edge(w, t, WR)  # we read w's final visible append
            # rw: we did not observe the next element in the order
            order = orders.get(k, [])
            nxt_idx = len(v)  # we saw order[:len(v)]
            if v == order[: len(v)] and nxt_idx < len(order):
                w2 = writer_of.get((k, order[nxt_idx]))
                if w2 is not None and w2.ok and w2 is not t:
                    g.add_edge(t, w2, RW)

    # dirty-update: a failed append that lands in the version order ahead
    # of committed ones (observed in some read)
    dirty = []
    for k, order in orders.items():
        for el in order:
            w = writer_of.get((k, el))
            if w is None:
                # element read but not appended by any ok/info txn
                failed_writers = [
                    t
                    for t in txns
                    if t.failed
                    and any(
                        f == APPEND and kk == k and vv == el
                        for f, kk, vv in mops(t)
                    )
                ]
                if failed_writers:
                    dirty.append({"key": k, "element": el})
    if dirty:
        anomalies["dirty-update"] = dirty

    if PROCESS in extra_graphs:
        g = g.union(core.process_graph(txns))
    if REALTIME in extra_graphs:
        g = g.union(core.realtime_graph(txns))

    return g, txns, anomalies


def cycle_anomalies(g: Graph) -> Dict[str, list]:
    """Classify cycles in the dependency graph by edge profile."""
    return cycles_mod.classify(g)


def prepare(history: History, opts: Optional[dict] = None, device=None):
    """The host half of a check, ahead of cycle classification: parse
    opts, build the dependency graph, and collect the non-cycle
    anomalies.  Returns ``(g, txns, anomalies, wanted)`` — the batch
    entry (``elle.check_batch``) prepares every history first so all
    the graphs screen in ONE engine pass.  ``device`` is taken for the
    entry points' sake: list-append reads its version order off the
    reads and screens nothing here."""
    from . import consistency

    opts = opts or {}
    wanted = consistency.proscribed(opts)
    extra: Tuple[str, ...] = ()
    if any(a.endswith("-realtime") for a in wanted):
        extra += (REALTIME,)
    if any(a.endswith("-process") for a in wanted):
        extra += (PROCESS,)

    g, txns, anomalies = graph_and_anomalies(history, extra_graphs=extra)
    return g, txns, anomalies, wanted


def finish(prep, cyc_anomalies: Dict[str, list]) -> dict:
    """Fold classified cycle anomalies into a prepared analysis."""
    from . import consistency

    g, txns, anomalies, wanted = prep
    anomalies.update(cyc_anomalies)
    return consistency.result(anomalies, wanted, txn_count=len(txns))


def check(history: History, opts: Optional[dict] = None,
          device=None, client=None) -> dict:
    """Full list-append analysis.  opts: consistency-models (list of
    model names, default ["strict-serializable"]), or anomalies (explicit
    list to look for); ``screen-route`` forces the cycle screens'
    device/cpu routing (default: self-calibrating auto) on ``device``."""
    prep = prepare(history, opts, device)
    fell: list = []
    cyc = cycles_mod.classify_graphs(
        [prep[0]], route=(opts or {}).get("screen-route"), device=device,
        client=client, fallbacks=fell,
    )[0]
    return cycles_mod.tag_fallback([finish(prep, cyc)], fell)[0]
