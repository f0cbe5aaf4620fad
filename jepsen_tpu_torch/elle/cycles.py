"""Cycle classification: SCCs → anomaly-typed witness cycles.

Adya's phenomena as edge-type profiles over the dependency graph:

- G0            cycle of only ww edges
- G1c           cycle of ww/wr edges (not G0)
- G-single      cycle with exactly one rw edge, rest ww/wr
- G-nonadjacent cycle with ≥2 rw edges, no two cyclically adjacent —
                still impossible under snapshot isolation
- G2-item       cycle with ≥1 rw edges (≥2, some adjacent, once the
                previous two are excluded)

With realtime/process graphs unioned in, the same profiles allowing
those edges yield the -realtime / -process variants (e.g. a cycle of ww
+ realtime edges is G0-realtime, proscribed by strict serializability
but not plain serializability).

The port of :mod:`jepsen_tpu.elle.cycles`: :func:`classify` is the
reference's, and the routing half (:func:`classify_graphs`,
:func:`cyclic_graph_mask`) keeps its self-calibrating ``auto`` route
with one change — a device error or a device/CPU mismatch raises instead
of pinning the bucket to the CPU.  The route comes from an argument
(``opts["screen-route"]`` at the entry points), never the environment.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Set

import numpy as np

from .. import device as device_mod
from .. import obs
from .graph import (
    Graph,
    INDETERMINATE,
    WW,
    WR,
    RW,
    PROCESS,
    REALTIME,
    cycle_rels,
    find_cycle,
    find_cycle_with,
    find_nonadjacent_cycle,
    strongly_connected_components,
)

_ORDER = [PROCESS, REALTIME]


def _fmt_cycle(g: Graph, cyc: List[Any]) -> dict:
    steps = []
    for a, b in zip(cyc, cyc[1:]):
        steps.append(
            {"from": repr(a), "rels": sorted(g.edge_rels(a, b)), "to": repr(b)}
        )
    return {"cycle": [repr(v) for v in cyc], "steps": steps}


def _suffix(rels_used: Set[str]) -> str:
    if REALTIME in rels_used:
        return "-realtime"
    if PROCESS in rels_used:
        return "-process"
    return ""


def classify(g: Graph, screen: Optional["GraphScreen"] = None
             ) -> Dict[str, list]:
    """Find one witness cycle per anomaly type per SCC.

    With a ``screen`` (the device's per-relation-filter SCC membership
    masks and nonadjacent-rw walk masks — :func:`screen_for_graphs`),
    every ladder rung the device has proven empty *under that rung's
    relation filter* is skipped outright: a skipped search is one the
    CPU would provably have answered None, so the output is
    byte-identical to the unscreened run (the fuzz corpus pins it) —
    Tarjan and the BFS witness searches only run on graphs, and
    rungs, already proven cyclic."""
    from . import encode as encode_mod

    anomalies: Dict[str, list] = {}

    def record(name: str, cyc: List[Any]) -> None:
        anomalies.setdefault(name, []).append(_fmt_cycle(g, cyc))

    if screen is not None:
        full = screen.members(encode_mod.ALL_MASK)
        if full is not None and not full:
            # no vertex sits on any cycle at all: no nontrivial SCCs,
            # so the whole classify pass (Tarjan included) is free
            return anomalies

    for scc in strongly_connected_components(g):
        def rung_empty(mask: int) -> bool:
            """Device-proven: this SCC has no cycle in the subgraph of
            edges carrying a relation in ``mask``."""
            if screen is None:
                return False
            mem = screen.members(mask)
            return mem is not None and not any(v in mem for v in scc)

        def walk_empty(rest_mask: int) -> bool:
            """Device-proven: no nonadjacent-rw closed walk through
            any vertex of this SCC (⇒ find_nonadjacent_cycle's walk
            BFS would see nothing and answer None)."""
            if screen is None:
                return False
            w = screen.nonadj(encode_mod.RW_BIT, rest_mask)
            return w is not None and not any(v in w for v in scc)

        # Most-severe-first: G0, then G1c, then G-single, then G2-item.
        ww_only = lambda rels: rels <= {WW}  # noqa: E731
        ww_wr = lambda rels: bool(rels & {WW, WR}) and not (rels & {RW})  # noqa: E731
        has_rw = lambda rels: RW in rels  # noqa: E731

        if rung_empty(encode_mod.WW_BIT):
            cyc = None
        else:
            sub = g.filtered(lambda rels: bool(rels & {WW}))
            cyc = find_cycle(sub, [v for v in scc if v in sub.vertices])
        if cyc is not None:
            record("G0", cyc)
            continue

        if rung_empty(encode_mod.WW_BIT | encode_mod.WR_BIT):
            cyc = None
        else:
            sub = g.filtered(lambda rels: bool(rels & {WW, WR}))
            cyc = find_cycle(sub, [v for v in scc if v in sub.vertices])
        if cyc is not None:
            record("G1c", cyc)
            continue

        # every remaining plain rung needs a cycle inside the
        # ww|wr|rw subgraph; one device mask screens all three
        rw_rungs_empty = rung_empty(
            encode_mod.WW_BIT | encode_mod.WR_BIT | encode_mod.RW_BIT
        )

        cyc = None if rw_rungs_empty else find_cycle_with(
            g,
            scc,
            want=has_rw,
            rest=lambda rels: bool(rels & {WW, WR}),
            want_count=1,
        )
        if cyc is not None:
            record("G-single", cyc)
            continue

        # G-nonadjacent: ≥2 rw edges, none cyclically adjacent — still a
        # snapshot-isolation violation (SI cycles need two adjacent rws)
        if rw_rungs_empty or walk_empty(
            encode_mod.WW_BIT | encode_mod.WR_BIT
        ):
            cyc = None
        else:
            cyc = find_nonadjacent_cycle(
                g,
                scc,
                want=has_rw,
                rest=lambda rels: bool(rels & {WW, WR}),
            )
        if cyc is INDETERMINATE:
            # simple-cycle search budget exhausted: a G-nonadjacent may
            # exist in this SCC.  Record the uncertainty (result() turns
            # it into valid?=unknown for models that proscribe the
            # anomaly) and fall through to the definite G2-item witness.
            anomalies.setdefault("G-nonadjacent-indeterminate", []).append(
                {
                    "scc-size": len(scc),
                    "reason": "simple-cycle search budget exhausted",
                }
            )
        elif cyc is not None:
            record("G-nonadjacent", cyc)
            continue

        if rw_rungs_empty:
            cyc = None
        else:
            sub = g.filtered(lambda rels: bool(rels & {WW, WR, RW}))
            cyc = find_cycle(sub, [v for v in scc if v in sub.vertices])
        if cyc is not None:
            record("G2-item", cyc)
            continue

        # Cycle requires process/realtime edges: -realtime/-process
        # variants of the same ladder.
        pr = encode_mod.PR_MASK
        for want_rels, name in (
            ({WW}, "G0"),
            ({WW, WR}, "G1c"),
            (None, "G-single"),
            ("nonadjacent", "G-nonadjacent"),
            ({WW, WR, RW}, "G2-item"),
        ):
            if name == "G-single":
                cyc = None if rung_empty(encode_mod.ALL_MASK) else (
                    find_cycle_with(
                        g,
                        scc,
                        want=has_rw,
                        rest=lambda rels: bool(
                            rels & {WW, WR, PROCESS, REALTIME}
                        ),
                        want_count=1,
                    )
                )
            elif name == "G-nonadjacent":
                cyc = (
                    None
                    if walk_empty(encode_mod.WW_BIT | encode_mod.WR_BIT | pr)
                    else find_nonadjacent_cycle(
                        g,
                        scc,
                        want=has_rw,
                        rest=lambda rels: bool(
                            rels & {WW, WR, PROCESS, REALTIME}
                        ),
                    )
                )
                if cyc is INDETERMINATE:
                    # this rung's hypothetical cycle needs process or
                    # realtime edges (the plain rung already answered
                    # definitively or recorded its own marker), so only
                    # the suffixed variants are uncertain — the plain
                    # marker would wrongly degrade serializable/SI
                    # verdicts that are provably clean
                    for suffixed in (
                        "G-nonadjacent-process-indeterminate",
                        "G-nonadjacent-realtime-indeterminate",
                    ):
                        anomalies.setdefault(suffixed, []).append(
                            {
                                "scc-size": len(scc),
                                "reason": (
                                    "simple-cycle search budget exhausted"
                                ),
                            }
                        )
                    cyc = None
            else:
                mask = encode_mod.rel_mask(want_rels) | pr
                if rung_empty(mask):
                    cyc = None
                else:
                    sub = g.filtered(
                        lambda rels, wr=want_rels: bool(
                            rels & (wr | {PROCESS, REALTIME})
                        )
                    )
                    cyc = find_cycle(
                        sub, [v for v in scc if v in sub.vertices]
                    )
            if cyc is not None:
                used: Set[str] = set()
                for rels in cycle_rels(g, cyc):
                    used |= rels
                record(name + _suffix(used), cyc)
                break
    return anomalies


#: the self-calibrating routers' winners, keyed by (device, vertex
#: bucket, batch-size bucket): one calibration per key per process.  The
#: device is part of the key because one process may screen on the CPU
#: and on the card.
_SCREEN_CHOICE: Dict[tuple, str] = {}
_CLASSIFY_CHOICE: Dict[tuple, str] = {}

#: never calibrate the closure screens past this many vertices; graphs
#: above it classify on the CPU.  A TPU-era routing constant, kept so
#: that the routes compare one to one with the reference's.
DEVICE_SCREEN_MAX_VERTICES = 512

#: below this many screenable graphs the auto route stays on the CPU;
#: kept from the reference, like DEVICE_SCREEN_MAX_VERTICES
ELLE_SCREEN_MIN_BATCH = 16

ROUTES = ("auto", "cpu", "device")


def _screen_bucket(n: int) -> int:
    return 1 << max(4, int(n - 1).bit_length())


def _cpu_screen(graphs):
    return np.array(
        [bool(strongly_connected_components(g)) for g in graphs]
    )


def _device_screen(graphs, device):
    from ..ops import cycles as ops_cycles

    return ops_cycles.has_cycle_batch([g.adjacency()[1] for g in graphs],
                                      device=device)


def _calibrate(cache: dict, key: tuple, cpu_fn, dev_fn, what: str):
    """Run both engines on one batch — the device twice, the first run
    warming it — pin the faster one under ``key``, and return the CPU
    answer.  A device error propagates; answers that differ raise: the
    screens never trade correctness for speed, and a quiet pin to the CPU
    would hide a faulty kernel."""
    t0 = time.perf_counter()
    cpu_out = cpu_fn()
    t_cpu = time.perf_counter() - t0
    dev_fn()
    t0 = time.perf_counter()
    dev_out = dev_fn()
    t_dev = time.perf_counter() - t0
    same = (np.array_equal(np.asarray(dev_out), cpu_out)
            if isinstance(cpu_out, np.ndarray) else dev_out == cpu_out)
    if not same:
        raise RuntimeError(f"elle {what}: the device and CPU answers differ "
                           f"at bucket {key}")
    cache[key] = "device" if t_dev < t_cpu else "cpu"
    return cpu_out


def cyclic_graph_mask(graphs: List[Graph], use_device: Optional[bool] = None,
                      device=None):
    """Batched cycle screening: which of these graphs contain a cycle at
    all?  ``use_device`` True runs the has-cycle kernel
    (:func:`jepsen_tpu_torch.ops.cycles.has_cycle_batch`) on ``device``,
    False per-graph Tarjan on the host.  ``None`` self-calibrates: the
    first batch at each (device, vertex bucket, batch bucket) runs both
    and pins the faster; graphs past :data:`DEVICE_SCREEN_MAX_VERTICES`
    stay on the host."""
    if not graphs:
        return np.zeros((0,), dtype=bool)
    if use_device is not None:
        return (_device_screen(graphs, device) if use_device
                else _cpu_screen(graphs))
    biggest = max(len(g.vertices) for g in graphs)
    if biggest > DEVICE_SCREEN_MAX_VERTICES:
        return _cpu_screen(graphs)
    dev = device_mod.resolve(device)
    key = (str(dev), _screen_bucket(biggest), _screen_bucket(len(graphs)))
    choice = _SCREEN_CHOICE.get(key)
    if choice == "device":
        return _device_screen(graphs, dev)
    if choice == "cpu":
        return _cpu_screen(graphs)
    return _calibrate(_SCREEN_CHOICE, key, lambda: _cpu_screen(graphs),
                      lambda: _device_screen(graphs, dev), "cycle screen")


# ---------------------------------------------------------------------------
# Device-screened classify: batched SCC/relation-filter screens through
# the engine (ops.cycles → engine.execution.Executor)
# ---------------------------------------------------------------------------


class GraphScreen:
    """One graph's device screens, decoded back into vertex space:
    ``members(mask)`` — the vertices on some cycle of the subgraph of
    edges carrying a relation in ``mask`` — and ``nonadj(want, rest)``
    — the vertices with a nonadjacent-want closed walk.  Queries
    canonicalize masks to the relation bits the graph actually has, so
    a graph with no process/realtime edges answers its suffixed-ladder
    rungs from the identical plain-relation closure.  Returns a set
    (possibly empty — a *definitive* no) or ``None`` for a filter the
    screen never computed (callers must then search, never skip)."""

    __slots__ = ("order", "present", "_members", "_walks", "_sets",
                 "_wsets")

    def __init__(self, enc, res):
        self.order = enc.order
        self.present = enc.present
        self._members = res.members
        self._walks = res.walks
        self._sets: dict = {}
        self._wsets: dict = {}

    def _vertex_set(self, arr):
        return frozenset(
            v for i, v in enumerate(self.order) if arr[i]
        )

    def members(self, mask: int):
        key = mask & self.present
        if key == 0:
            return frozenset()
        got = self._sets.get(key)
        if got is None:
            arr = self._members.get(key)
            if arr is None:
                return None
            got = self._sets[key] = self._vertex_set(arr)
        return got

    def nonadj(self, want: int, rest: int):
        if not (self.present & want):
            return frozenset()  # no want edge anywhere: trivially none
        key = (want, rest & self.present)
        got = self._wsets.get(key)
        if got is None:
            arr = self._walks.get(key)
            if arr is None:
                return None
            got = self._wsets[key] = self._vertex_set(arr)
        return got


def screen_for_graphs(graphs: List[Graph], executor=None, device=None):
    """Encode and screen a batch of dependency graphs through the
    engine's :class:`~jepsen_tpu_torch.engine.execution.Executor`
    (``executor=``, else a local one on ``device``): one
    :class:`GraphScreen` (or ``None`` — that graph stays on the CPU) per
    input."""
    from . import encode as encode_mod
    from ..ops import cycles as ops_cycles

    encs = [encode_mod.encode_graph(g) for g in graphs]
    results = ops_cycles.screen_graphs(encs, executor=executor,
                                       device=device)
    return [GraphScreen(enc, res) if res is not None else None
            for enc, res in zip(encs, results)]


def _count_route(route: str, n: int) -> None:
    """``jepsen_elle_screen_route_total``: graphs served by each route."""
    if n and obs.enabled():
        obs.count("jepsen_elle_screen_route_total", n, route=route)


def _classify_screened(graphs: List[Graph], executor=None, device=None,
                       count: bool = True) -> List[Dict[str, list]]:
    """Classify with device screens; graphs the screens could not take
    classify unscreened.  ``count=False`` for a calibration probe (its
    caller is served the CPU answers, and counts them so)."""
    from . import encode as encode_mod

    screens = screen_for_graphs(graphs, executor=executor, device=device)
    out = [classify(g, s) for g, s in zip(graphs, screens)]
    if count and obs.enabled():
        n_cpu = sum(1 for s in screens if s is None)
        _count_route("device", len(screens) - n_cpu)
        _count_route("cpu", n_cpu)
        # the screen proved a cycle: Tarjan and the witness search still
        # run for this graph
        n_fallback = sum(1 for s in screens
                         if s is not None and s.members(encode_mod.ALL_MASK))
        if n_fallback:
            obs.count("jepsen_elle_witness_fallback_total", n_fallback)
    return out


def classify_graphs(
    graphs: List[Graph],
    route: Optional[str] = None,
    executor=None,
    device=None,
) -> List[Dict[str, list]]:
    """Batched :func:`classify`: screen every graph's relation-filter
    cycle structure on the device in shared engine dispatches, then pay
    CPU Tarjan + witness search only where the screens proved cycles
    exist.  ``route``: ``"cpu"`` (the pure host path, needs no device),
    ``"device"`` (screens forced), or ``None``/``"auto"``:
    self-calibrating per (device, vertex bucket, batch bucket) — the
    first batch at each key runs both paths, requires equal anomalies
    (else raises) and pins the faster.  Graphs past
    :data:`DEVICE_SCREEN_MAX_VERTICES` (or below 2 vertices) always
    classify on the CPU; with no ``device`` and no CUDA, any route that
    would screen raises."""
    route = (route or "auto").lower()
    if route not in ROUTES:
        raise ValueError(f"screen route {route!r} is not one of {ROUTES}")
    n = len(graphs)
    if n == 0:
        return []
    if route == "cpu":
        _count_route("cpu", n)
        return [classify(g) for g in graphs]

    screenable = [
        i for i, g in enumerate(graphs)
        if 2 <= len(g.vertices) <= DEVICE_SCREEN_MAX_VERTICES
    ]
    out: List[Optional[Dict[str, list]]] = [None] * n
    rest = sorted(set(range(n)) - set(screenable))
    for i in rest:
        out[i] = classify(graphs[i])
    _count_route("cpu", len(rest))
    sub = [graphs[i] for i in screenable]

    if route == "device":
        screened = _classify_screened(sub, executor=executor, device=device)
    elif len(sub) < ELLE_SCREEN_MIN_BATCH:
        screened = [classify(g) for g in sub]
        _count_route("cpu", len(sub))
    else:
        dev = (executor.device if executor is not None
               else device_mod.resolve(device))
        biggest = max(len(g.vertices) for g in sub)
        key = (str(dev), _screen_bucket(biggest), _screen_bucket(len(sub)))
        choice = _CLASSIFY_CHOICE.get(key)
        if choice == "device":
            screened = _classify_screened(sub, executor=executor,
                                          device=dev)
        elif choice == "cpu":
            screened = [classify(g) for g in sub]
            _count_route("cpu", len(sub))
        else:
            screened = _calibrate(
                _CLASSIFY_CHOICE, key, lambda: [classify(g) for g in sub],
                lambda: _classify_screened(sub, executor=executor,
                                           device=dev, count=False),
                "classify screens")
            # the calibration batch is served the CPU answers
            _count_route("cpu", len(sub))
    for i, r in zip(screenable, screened):
        out[i] = r
    return out  # type: ignore[return-value]
