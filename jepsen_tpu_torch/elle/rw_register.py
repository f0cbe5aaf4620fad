"""Read-write register transactional anomaly analysis.

Transactions are lists of ``["w", k, v]`` / ``["r", k, v]`` micro-ops
with distinct written values per key.  Unlike list-append, reads reveal
only a point version, so the per-key version order must be *inferred*
from sound sources:

- initial: ``None`` precedes every written value of the key
- intra-txn: two writes of one key in one txn are ordered
- read→write: a txn reading u then writing v orders u before v
- realtime/process (optional, per the consistency model sought):
  a committed write of u completing before a write of v begins orders
  u before v

The union forms a per-key version DAG; a cycle there is reported as
``cyclic-versions`` (verdict unknown, like Elle).  Dependencies follow:
wr (writer → reader of the same version), ww (writer u → writer v for
u < v), rw (reader of u → writer of any v > u).
(reference consumer: jepsen/src/jepsen/tests/cycle/wr.clj)

The port of :mod:`jepsen_tpu.elle.rw_register`.  One change: the
per-key version-graph screen follows the entry point's
``screen-route`` (``"cpu"`` keeps it on the host, ``"device"`` forces
the has-cycle kernel, otherwise it self-calibrates), where the
reference always self-calibrates it; the graphs it flags are the same.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Set, Tuple

from ..history import History
from ..txn import R, W
from . import core
from .core import Txn
from .graph import Graph, WW, WR, RW, PROCESS, REALTIME
from . import cycles as cycles_mod

INIT = ("init",)  # sentinel for the unwritten initial version


def mops(t: Txn):
    return t.value or []


def internal_cases(txns: List[Txn]) -> List[dict]:
    """A read must agree with the txn's own latest prior write/read of
    that key."""
    cases = []
    for t in txns:
        if not t.ok:
            continue
        state: Dict[Any, Any] = {}
        for f, k, v in mops(t):
            if f == W:
                state[k] = v
            else:
                if k in state and state[k] != v:
                    cases.append(
                        {"op": t.complete.to_dict(), "mop": [f, k, v],
                         "expected": state[k]}
                    )
                state[k] = v
    return cases


def g1a_cases(txns: List[Txn]) -> List[dict]:
    """Reads of values written by failed txns."""
    failed = {
        (k, v): t
        for t in txns
        if t.failed
        for f, k, v in mops(t)
        if f == W
    }
    cases = []
    for t in txns:
        if not t.ok:
            continue
        for f, k, v in mops(t):
            if f == R and v is not None and (k, v) in failed:
                cases.append({"op": t.complete.to_dict(), "mop": [f, k, v]})
    return cases


def g1b_cases(txns: List[Txn]) -> List[dict]:
    """Reads of a txn's non-final (intermediate) write of a key."""
    intermediate: Dict[Tuple[Any, Any], Txn] = {}
    for t in txns:
        if not t.ok:
            continue
        last_write: Dict[Any, Any] = {}
        writes_in_order: Dict[Any, List[Any]] = defaultdict(list)
        for f, k, v in mops(t):
            if f == W:
                writes_in_order[k].append(v)
                last_write[k] = v
        for k, vs in writes_in_order.items():
            for v in vs[:-1]:
                intermediate[(k, v)] = t
    cases = []
    for t in txns:
        if not t.ok:
            continue
        for f, k, v in mops(t):
            if f == R and (k, v) in intermediate and intermediate[(k, v)] is not t:
                cases.append({"op": t.complete.to_dict(), "mop": [f, k, v]})
    return cases


def lost_update_cases(txns: List[Txn]) -> List[dict]:
    """Two (or more) committed txns that both externally read version v
    of key k and both externally wrote k: only one of those updates can
    have seen the other, so an update was lost.  (Elle's
    elle.txn/lost-update-cases; proscribed from cursor stability /
    snapshot isolation upward.)"""
    groups: Dict[Tuple[Any, Any], List[Txn]] = defaultdict(list)
    for t in txns:
        if not t.ok:
            continue
        written = {k for f, k, _v in mops(t) if f == W}
        seen: Set[Any] = set()
        for f, k, v in mops(t):
            if f == W:
                seen.add(k)
            elif f == R and k not in seen:
                seen.add(k)
                if k in written:  # external read + external write of k
                    groups[(k, v)].append(t)
    return [
        {
            "key": k,
            "value": v,
            "txns": [t.complete.to_dict() for t in ts],
        }
        for (k, v), ts in sorted(groups.items(), key=lambda kv: str(kv[0]))
        if len(ts) > 1
    ]


def _ext_write(t: Txn, k: Any) -> Optional[Any]:
    """The txn's final (externally visible) write of k, or None."""
    out = None
    for f, kk, v in mops(t):
        if f == W and kk == k:
            out = v
    return out


def version_graphs(
    txns: List[Txn], extra: Tuple[str, ...] = (),
    use_device: Optional[bool] = None, device=None,
) -> Tuple[Dict[Any, Graph], List[dict]]:
    """Per-key version DAGs from the sound order sources.  Returns
    (key → graph over values, cyclic-versions cases).  ``use_device`` and
    ``device`` steer the cycle screen (:func:`cycles.cyclic_graph_mask`)."""
    graphs: Dict[Any, Graph] = defaultdict(Graph)

    writers: Dict[Tuple[Any, Any], Txn] = {}
    for t in txns:
        if not t.ok:
            continue
        for f, k, v in mops(t):
            if f == W:
                writers[(k, v)] = t
                graphs[k].add_edge(INIT, v, "version")

    for t in txns:
        if not t.ok:
            continue
        last_seen: Dict[Any, Any] = {}
        for f, k, v in mops(t):
            if f == W:
                prev = last_seen.get(k)
                if prev is not None and prev != v:
                    graphs[k].add_edge(prev, v, "version")
                last_seen[k] = v
            elif f == R:
                vv = v if v is not None else INIT
                prev = last_seen.get(k)
                if prev is None:
                    last_seen[k] = vv

    if REALTIME in extra or PROCESS in extra:
        # committed write of u completes before write of v begins
        writes: List[Tuple[Txn, Any, Any]] = []
        for t in txns:
            if not t.ok:
                continue
            for k in {kk for f, kk, _ in mops(t) if f == W}:
                writes.append((t, k, _ext_write(t, k)))
        for t1, k1, u in writes:
            for t2, k2, v in writes:
                if k1 != k2 or u == v:
                    continue
                if REALTIME in extra and t1.complete.time < t2.invoke.time:
                    graphs[k1].add_edge(u, v, "version")
                elif (
                    PROCESS in extra
                    and t1.process == t2.process
                    and t1.complete.time <= t2.invoke.time
                ):
                    graphs[k1].add_edge(u, v, "version")

    # Batched cycle screen over every per-key version graph at once —
    # the device closure kernel (or per-graph SCC, whichever the
    # self-calibrating router picks for this backend and size); only
    # keys the screen flags pay the detailed SCC extraction (cyclic
    # keys are anomalies, so the double pass is the rare case).  This
    # is the Elle-on-GPU seam running inside the production pipeline.
    # Batches the
    # screen can't win (few graphs, or any graph past the device
    # vertex cap) keep the direct per-graph SCC pass — routing through
    # the mask there would compute SCCs and throw them away.
    cyclic = []
    items = list(graphs.items())
    use_screen = len(items) >= 16 and all(
        len(g.vertices) <= cycles_mod.DEVICE_SCREEN_MAX_VERTICES
        for _k, g in items
    )
    if use_screen:
        mask = cycles_mod.cyclic_graph_mask(
            [g for _k, g in items], use_device=use_device, device=device)
    else:
        mask = [
            bool(cycles_mod.strongly_connected_components(g))
            for _k, g in items
        ]
    for (k, g), has_cycle in zip(items, mask):
        if has_cycle:
            sccs = cycles_mod.strongly_connected_components(g)
            cyclic.append(
                {"key": k, "sccs": [[repr(v) for v in c] for c in sccs]}
            )
    return graphs, cyclic


def _closure(g: Graph) -> Dict[Any, Set[Any]]:
    """value → set of values strictly after it.  Iterative post-order
    DFS (version chains can be thousands deep; recursion would blow the
    stack); back-edges (cycles) contribute nothing here and are reported
    separately as cyclic-versions."""
    memo: Dict[Any, Set[Any]] = {}
    visiting: Set[Any] = set()
    for root in g.vertices:
        if root in memo:
            continue
        stack: List[Tuple[Any, bool]] = [(root, False)]
        while stack:
            v, expanded = stack.pop()
            if expanded:
                out: Set[Any] = set()
                for w in g.successors(v):
                    out.add(w)
                    out |= memo.get(w, set())
                memo[v] = out
                visiting.discard(v)
                continue
            if v in memo or v in visiting:
                continue
            visiting.add(v)
            stack.append((v, True))
            for w in g.successors(v):
                if w not in memo and w not in visiting:
                    stack.append((w, False))
    return memo


def graph_and_anomalies(
    history: History, extra_graphs: Tuple[str, ...] = (),
    use_device: Optional[bool] = None, device=None,
) -> Tuple[Graph, List[Txn], Dict[str, list]]:
    txns = core.transactions(history)
    anomalies: Dict[str, list] = {}

    internal = internal_cases(txns)
    if internal:
        anomalies["internal"] = internal
    g1a = g1a_cases(txns)
    if g1a:
        anomalies["G1a"] = g1a
    g1b = g1b_cases(txns)
    if g1b:
        anomalies["G1b"] = g1b
    lost = lost_update_cases(txns)
    if lost:
        anomalies["lost-update"] = lost

    vgraphs, cyclic = version_graphs(txns, extra_graphs, use_device,
                                     device)
    if cyclic:
        anomalies["cyclic-versions"] = cyclic

    writers: Dict[Tuple[Any, Any], Txn] = {}
    for t in txns:
        if not t.ok:
            continue
        for f, k, v in mops(t):
            if f == W:
                writers[(k, v)] = t

    g = Graph()
    for t in txns:
        if t.ok:
            g.add_vertex(t)

    closures = {k: _closure(vg) for k, vg in vgraphs.items()}

    for k, vg in vgraphs.items():
        after = closures[k]
        # ww: writer of u → writer of each later version v
        for u, vs in after.items():
            wu = writers.get((k, u))
            if u is not INIT and wu is None:
                continue
            for v in vs:
                wv = writers.get((k, v))
                if wu is not None and wv is not None and wu is not wv:
                    g.add_edge(wu, wv, WW)

    for t in txns:
        if not t.ok:
            continue
        # external reads: first read of k before any write in this txn
        written: Set[Any] = set()
        seen_keys: Set[Any] = set()
        for f, k, v in mops(t):
            if f == W:
                written.add(k)
            elif f == R and k not in written and k not in seen_keys:
                seen_keys.add(k)
                vv = v if v is not None else INIT
                w = writers.get((k, vv))
                if w is not None and w is not t:
                    g.add_edge(w, t, WR)
                # rw: t read vv; any later version's writer overwrote it
                for v2 in closures.get(k, {}).get(vv, ()):
                    w2 = writers.get((k, v2))
                    if w2 is not None and w2 is not t:
                        g.add_edge(t, w2, RW)

    if PROCESS in extra_graphs:
        g = g.union(core.process_graph(txns))
    if REALTIME in extra_graphs:
        g = g.union(core.realtime_graph(txns))

    return g, txns, anomalies


#: screen-route → version-graph screen (None: self-calibrating)
_VERSION_SCREEN = {"cpu": False, "device": True}


def prepare(history: History, opts: Optional[dict] = None, device=None):
    """The host half of a check, ahead of cycle classification (see
    ``list_append.prepare``); the version-graph screen runs here, routed
    by ``opts["screen-route"]`` on ``device``.  Returns ``(g, txns,
    anomalies, wanted)``."""
    from . import consistency

    opts = opts or {}
    wanted = consistency.proscribed(opts)
    extra: Tuple[str, ...] = ()
    if any(a.endswith("-realtime") for a in wanted):
        extra += (REALTIME,)
    if any(a.endswith("-process") for a in wanted):
        extra += (PROCESS,)

    route = (opts.get("screen-route") or "auto").lower()
    g, txns, anomalies = graph_and_anomalies(
        history, extra_graphs=extra, use_device=_VERSION_SCREEN.get(route),
        device=device)
    return g, txns, anomalies, wanted


def finish(prep, cyc_anomalies) -> dict:
    """Fold classified cycle anomalies into a prepared analysis."""
    from . import consistency

    g, txns, anomalies, wanted = prep
    anomalies.update(cyc_anomalies)
    out = consistency.result(anomalies, wanted, txn_count=len(txns))
    # A cyclic version order makes a clean verdict unreachable — but never
    # masks a definite anomaly already found.
    if "cyclic-versions" in anomalies and out["valid?"] is True:
        out["valid?"] = "unknown"
    return out


def check(history: History, opts: Optional[dict] = None,
          device=None, client=None) -> dict:
    """Full rw-register analysis; same opts as list_append.check."""
    prep = prepare(history, opts, device)
    fell: list = []
    cyc = cycles_mod.classify_graphs(
        [prep[0]], route=(opts or {}).get("screen-route"), device=device,
        client=client, fallbacks=fell,
    )[0]
    return cycles_mod.tag_fallback([finish(prep, cyc)], fell)[0]
