"""Nemesis protocol — fault injection into the system under test.

(reference: jepsen/src/jepsen/nemesis.clj:11-90 for the protocol and
validation; grudges :108-281, composition :285-428, clock, process and
file faults :430-539.)

The ``Partitioner`` family (nemesis.clj:157-281) plans cuts with the
grudge functions and makes them through :mod:`jepsen_tpu_torch.net`.
"""

from __future__ import annotations

from typing import Any, Iterable


class Nemesis:
    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass

    #: Optional reflection: the set of :f values this nemesis handles
    #: (reference: nemesis.clj:18-47 Reflection/fs)
    def fs(self) -> Iterable[Any]:
        return ()


class NoopNemesis(Nemesis):
    """(reference: nemesis.clj noop)"""

    def invoke(self, test, op):
        return {**op, "type": "info"}


def noop() -> Nemesis:
    return NoopNemesis()


class ValidationError(Exception):
    pass


class Validate(Nemesis):
    """(reference: nemesis.clj:49-90)"""

    def __init__(self, nemesis: Nemesis):
        self.nemesis = nemesis

    def setup(self, test):
        inner = self.nemesis.setup(test)
        if inner is None:
            raise ValidationError(
                f"Expected nemesis setup to return a nemesis, got None from "
                f"{self.nemesis!r}"
            )
        return Validate(inner)

    def invoke(self, test, op):
        # every nemesis in a run passes through validate (core.run_case),
        # so this one seam gives fault start/stop spans to all of them
        from .. import obs

        with obs.span(f"nemesis/{op.get('f')}", cat="nemesis") as sp:
            res = self.nemesis.invoke(test, op)
            sp.set("type", res.get("type") if isinstance(res, dict) else "?")
        if not isinstance(res, dict):
            raise ValidationError(
                f"Nemesis {self.nemesis!r} returned {res!r} for {op!r}"
            )
        # counted only for valid completions — an invalid result raises
        # above and must not inflate the completed-fault count
        obs.count("jepsen_nemesis_ops_total", f=str(op.get("f")))
        return res

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return self.nemesis.fs()


def validate(nemesis: Nemesis) -> Nemesis:
    return Validate(nemesis)


class Timeout(Nemesis):
    """Bound a flaky nemesis's ops; timed-out ops get :value "timeout".
    (reference: nemesis.clj:92-106)"""

    def __init__(self, timeout_ms: float, nemesis: Nemesis):
        self.timeout_ms = timeout_ms
        self.nemesis = nemesis

    def setup(self, test):
        return Timeout(self.timeout_ms, self.nemesis.setup(test))

    def invoke(self, test, op):
        from ..util import timeout as timeout_fn

        return timeout_fn(
            self.timeout_ms,
            lambda: self.nemesis.invoke(test, op),
            default={**op, "value": "timeout"},
        )

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return self.nemesis.fs()


def timeout(timeout_ms: float, nemesis: Nemesis) -> Nemesis:
    return Timeout(timeout_ms, nemesis)


# ---------------------------------------------------------------------------
# Grudges: maps of node → set of nodes to drop traffic from
# (reference: nemesis.clj:108-281)
# ---------------------------------------------------------------------------


def _rng():
    from .. import generator as gen

    return gen.rng


def bisect(coll):
    """Cut a sequence in half; smaller half first.
    (reference: nemesis.clj:108-111)"""
    coll = list(coll)
    mid = len(coll) // 2
    return [coll[:mid], coll[mid:]]


def split_one(coll, loner=None):
    """Split one node off from the rest.  (reference: nemesis.clj:113-118)"""
    coll = list(coll)
    if loner is None:
        loner = _rng().choice(coll)
    return [[loner], [x for x in coll if x != loner]]


def complete_grudge(components):
    """No node may talk to nodes outside its component.
    (reference: nemesis.clj:120-132)"""
    components = [set(c) for c in components]
    universe = set().union(*components) if components else set()
    grudge = {}
    for component in components:
        for node in component:
            grudge[node] = universe - component
    return grudge


def invert_grudge(nodes, conns):
    """From a connectivity map to a drop map.
    (reference: nemesis.clj:134-142)"""
    universe = set(nodes)
    return {a: universe - set(conns.get(a, set())) for a in sorted(universe, key=str)}


def bridge(nodes):
    """Cut the network in half but keep one bridge node connected to
    both sides.  (reference: nemesis.clj:144-155)"""
    components = bisect(nodes)
    bridge_node = components[1][0]
    grudge = complete_grudge(components)
    grudge.pop(bridge_node, None)
    return {node: others - {bridge_node} for node, others in grudge.items()}


def majorities_ring_perfect(nodes):
    """Exact ring for ≤5-node clusters.  (reference: nemesis.clj:202-216)"""
    from ..util import majority

    nodes = list(nodes)
    universe = set(nodes)
    n = len(nodes)
    m = majority(n)
    shuffled = list(nodes)
    _rng().shuffle(shuffled)
    ring = shuffled * 2  # cycle
    grudge = {}
    for i in range(n):
        maj = ring[i : i + m]
        center = maj[len(maj) // 2]
        grudge[center] = universe - set(maj)
    return grudge


def majorities_ring_stochastic(nodes):
    """Greedy construction for larger clusters.
    (reference: nemesis.clj:218-258)"""
    from ..util import majority

    nodes = list(nodes)
    m = majority(len(nodes))
    conns = {a: {a} for a in nodes}
    while True:
        by_degree = sorted(
            nodes, key=lambda a: (len(conns[a]), _rng().random())
        )
        a = by_degree[0]
        if len(conns[a]) >= m:
            return invert_grudge(nodes, conns)
        candidates = [b for b in by_degree if b != a and b not in conns[a]]
        if not candidates:
            return invert_grudge(nodes, conns)
        b = candidates[0]
        conns[a].add(b)
        conns[b].add(a)


def majorities_ring(nodes):
    """Every node sees a majority, but no two nodes see the same one.
    (reference: nemesis.clj:260-275)"""
    nodes = list(nodes)
    if len(nodes) <= 5:
        return majorities_ring_perfect(nodes)
    return majorities_ring_stochastic(nodes)


# ---------------------------------------------------------------------------
# Partitioners (reference: nemesis.clj:157-281)
# ---------------------------------------------------------------------------


class Partitioner(Nemesis):
    """:start cuts links per (grudge nodes); :stop heals.
    (reference: nemesis.clj:157-183)"""

    def __init__(self, grudge_fn=None):
        self.grudge_fn = grudge_fn

    def setup(self, test):
        from .. import net

        net.heal(test)
        return self

    def invoke(self, test, op):
        from .. import net

        f = op.get("f")
        if f == "start":
            grudge = op.get("value")
            if grudge is None:
                if self.grudge_fn is None:
                    raise ValueError(
                        f"Expected op {op!r} to have a grudge for a value"
                    )
                grudge = self.grudge_fn(test["nodes"])
            net.drop_all(test, grudge)
            return {
                **op,
                "type": "info",
                "value": ["isolated", {str(k): sorted(map(str, v)) for k, v in grudge.items()}],
            }
        elif f == "stop":
            net.heal(test)
            return {**op, "type": "info", "value": "network-healed"}
        raise ValueError(f"partitioner cannot handle f={f!r}")

    def teardown(self, test):
        from .. import net

        net.heal(test)

    def fs(self):
        return {"start", "stop"}


def partitioner(grudge_fn=None) -> Nemesis:
    return Partitioner(grudge_fn)


def partition_halves() -> Nemesis:
    """(reference: nemesis.clj:185-190)"""
    return partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves() -> Nemesis:
    """(reference: nemesis.clj:192-195)"""

    def grudge(nodes):
        nodes = list(nodes)
        _rng().shuffle(nodes)
        return complete_grudge(bisect(nodes))

    return partitioner(grudge)


def partition_random_node() -> Nemesis:
    """(reference: nemesis.clj:197-200)"""
    return partitioner(lambda nodes: complete_grudge(split_one(nodes)))


def partition_majorities_ring() -> Nemesis:
    """(reference: nemesis.clj:277-281)"""
    return partitioner(majorities_ring)


# ---------------------------------------------------------------------------
# Composition (reference: nemesis.clj:285-428)
# ---------------------------------------------------------------------------


class FMap(Nemesis):
    """Remap the :f values a nemesis accepts.
    (reference: nemesis.clj:285-327)"""

    def __init__(self, lift, unlift, nemesis):
        self.lift = lift
        self.unlift = unlift
        self.nemesis = nemesis

    def setup(self, test):
        return f_map(self.lift, self.nemesis.setup(test))

    def invoke(self, test, op):
        inner = {**op, "f": self.unlift[op.get("f")]}
        res = self.nemesis.invoke(test, inner)
        return {**res, "f": self.lift(res.get("f"))}

    def teardown(self, test):
        self.nemesis.teardown(test)

    def fs(self):
        return {self.lift(f) for f in self.nemesis.fs()}


def f_map(lift, nemesis: Nemesis) -> Nemesis:
    fs = set(nemesis.fs())
    unlift = {lift(f): f for f in fs}
    return FMap(lift, unlift, nemesis)


class ReflCompose(Nemesis):
    """Compose nemeses, routing by their declared fs.
    (reference: nemesis.clj:334-351)"""

    def __init__(self, fmap, nemeses):
        self.fmap = fmap  # f -> index
        self.nemeses = list(nemeses)

    def setup(self, test):
        return compose([n.setup(test) for n in self.nemeses])

    def invoke(self, test, op):
        i = self.fmap.get(op.get("f"))
        if i is None:
            raise ValueError(
                f"No nemesis can handle f={op.get('f')!r} "
                f"(expected one of {sorted(map(str, self.fmap))})"
            )
        return self.nemeses[i].invoke(test, op)

    def teardown(self, test):
        for n in self.nemeses:
            n.teardown(test)

    def fs(self):
        out = set()
        for n in self.nemeses:
            out |= set(n.fs())
        return out


class MapCompose(Nemesis):
    """Compose with explicit {f-mapping: nemesis} routing; an f-mapping
    is a dict (rewrites f) or set (passes f through).
    (reference: nemesis.clj:354-382)"""

    def __init__(self, nemeses: dict):
        self.nemeses = dict(nemeses)

    @staticmethod
    def _route(fmapping, f):
        if isinstance(fmapping, dict):
            return fmapping.get(f)
        if isinstance(fmapping, (set, frozenset)):
            return f if f in fmapping else None
        raise TypeError(f"bad f mapping: {fmapping!r}")

    def setup(self, test):
        return MapCompose(
            {fm: n.setup(test) for fm, n in self.nemeses.items()}
        )

    def invoke(self, test, op):
        f = op.get("f")
        for fmapping, nemesis in self.nemeses.items():
            f2 = self._route(fmapping, f)
            if f2 is not None:
                res = nemesis.invoke(test, {**op, "f": f2})
                return {**res, "f": f}
        raise ValueError(f"no nemesis can handle {f!r}")

    def teardown(self, test):
        for n in self.nemeses.values():
            n.teardown(test)

    def fs(self):
        out = set()
        for fmapping in self.nemeses:
            if isinstance(fmapping, dict):
                out |= set(fmapping.keys())
            elif isinstance(fmapping, (set, frozenset)):
                out |= set(fmapping)
            else:
                raise TypeError(
                    "can only infer fs from dict/set mappings"
                )
        return out


def compose(nemeses) -> Nemesis:
    """Compose nemeses.  Accepts: a dict of f-mappings→nemeses (f-mapping
    = a set passing fs through, or — via the pair-list form, since dicts
    aren't hashable keys — a dict rewriting fs); a list of
    (f-mapping, nemesis) pairs; or a collection of Reflection-supporting
    nemeses routed by their declared fs.  (reference: nemesis.clj:384-428)"""
    if isinstance(nemeses, dict):
        nemeses = list(nemeses.items())
    nemeses = list(nemeses)
    if nemeses and isinstance(nemeses[0], tuple) and len(nemeses[0]) == 2 and isinstance(nemeses[0][0], (dict, set, frozenset)):
        frozen = {}
        for fmapping, n in nemeses:
            if isinstance(fmapping, (set, frozenset)):
                frozen[frozenset(fmapping)] = n
            elif isinstance(fmapping, dict):
                frozen[_FrozenDict(fmapping)] = n
            else:
                raise TypeError(f"bad f mapping: {fmapping!r}")
        return MapCompose(frozen)
    fmap = {}
    for i, n in enumerate(nemeses):
        for f in n.fs():
            if f in fmap:
                raise ValueError(
                    f"Nemeses {n!r} and {nemeses[fmap[f]]!r} are mutually "
                    f"incompatible; both use f {f!r}"
                )
            fmap[f] = i
    return ReflCompose(fmap, nemeses)


class _FrozenDict(dict):
    def __hash__(self):
        return hash(frozenset(self.items()))

    def get(self, k, default=None):  # routing uses .get
        return dict.get(self, k, default)


# ---------------------------------------------------------------------------
# Clock + process + file faults (reference: nemesis.clj:430-539)
# ---------------------------------------------------------------------------


def set_time(t: float) -> None:
    """Set the node's wall clock (POSIX seconds).
    (reference: nemesis.clj:430-433)"""
    from .. import control

    with control.su():
        control.execute("date", "+%s", "-s", f"@{int(t)}")


class ClockScrambler(Nemesis):
    """Randomize node clocks within ±dt seconds.
    (reference: nemesis.clj:435-450)"""

    def __init__(self, dt: float):
        self.dt = dt

    def invoke(self, test, op):
        import time as _time

        from .. import control

        def thunk():
            dt = int(self.dt)
            offset = _rng().randint(-dt, dt)
            set_time(_time.time() + offset)
            return offset

        value = control.with_test_nodes(test, thunk)
        return {**op, "type": "info", "value": value}

    def teardown(self, test):
        import time as _time

        from .. import control

        control.with_test_nodes(test, lambda: set_time(_time.time()))

    def fs(self):
        return {"scramble-clock"}


def clock_scrambler(dt: float) -> Nemesis:
    return ClockScrambler(dt)


class NodeStartStopper(Nemesis):
    """:start runs start_fn on targeted nodes; :stop undoes it.
    (reference: nemesis.clj:452-495)"""

    def __init__(self, targeter, start_fn, stop_fn):
        import threading

        self.targeter = targeter
        self.start_fn = start_fn
        self.stop_fn = stop_fn
        self.nodes = None
        self.lock = threading.Lock()

    @staticmethod
    def _target(targeter, test, nodes):
        """Call (targeter test nodes) or (targeter nodes) based on its
        actual arity — not exception probing, which would mask real
        TypeErrors inside the targeter."""
        import inspect

        try:
            sig = inspect.signature(targeter)
            required = [
                p
                for p in sig.parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty
            ]
            two_arg = len(required) >= 2
        except (ValueError, TypeError):
            two_arg = False
        return targeter(test, nodes) if two_arg else targeter(nodes)

    def invoke(self, test, op):
        from .. import control

        with self.lock:
            f = op.get("f")
            if f == "start":
                ns = self._target(self.targeter, test, test["nodes"])
                if ns is None:
                    value = "no-target"
                elif self.nodes is not None:
                    value = f"nemesis already disrupting {self.nodes!r}"
                else:
                    ns = list(ns) if isinstance(ns, (list, tuple, set)) else [ns]
                    self.nodes = ns
                    value = control.on_many(
                        ns,
                        lambda: self.start_fn(test, control.current_node()),
                    )
            elif f == "stop":
                if self.nodes is None:
                    value = "not-started"
                else:
                    value = control.on_many(
                        self.nodes,
                        lambda: self.stop_fn(test, control.current_node()),
                    )
                    self.nodes = None
            else:
                raise ValueError(f"unknown f {f!r}")
            return {**op, "type": "info", "value": value}

    def fs(self):
        return {"start", "stop"}


def node_start_stopper(targeter, start_fn, stop_fn) -> Nemesis:
    return NodeStartStopper(targeter, start_fn, stop_fn)


def hammer_time(process: str, targeter=None) -> Nemesis:
    """SIGSTOP/SIGCONT a process on targeted nodes.
    (reference: nemesis.clj:497-511)"""
    from .. import control

    if targeter is None:
        targeter = lambda nodes: _rng().choice(list(nodes))  # noqa: E731

    def start(test, node):
        with control.su():
            control.execute("killall", "-s", "STOP", process)
        return ["paused", process]

    def stop(test, node):
        with control.su():
            control.execute("killall", "-s", "CONT", process)
        return ["resumed", process]

    return node_start_stopper(targeter, start, stop)


class TruncateFile(Nemesis):
    """Drop the last :drop bytes of files on nodes.
    (reference: nemesis.clj:513-539)"""

    def invoke(self, test, op):
        from .. import control

        assert op.get("f") == "truncate"
        plan = op.get("value") or {}

        def doit(test_, node):
            spec = plan[node]
            path, drop = spec["file"], spec["drop"]
            assert isinstance(path, str) and isinstance(drop, int)
            with control.su():
                control.execute("truncate", "-c", "-s", f"-{drop}", path)

        control.on_nodes(test, list(plan.keys()), doit)
        return {**op, "type": "info"}

    def fs(self):
        return {"truncate"}


def truncate_file() -> Nemesis:
    return TruncateFile()
