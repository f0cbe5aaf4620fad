"""CockroachDB fault menu: a *named-bundle* nemesis algebra.

The port's copy of :mod:`jepsen_tpu.suites.crdb_nemesis`.

Reference: cockroachdb/src/jepsen/cockroach/nemesis.clj — each nemesis
is a named bundle {name, during-gen, final-gen, client, clocks}
(:26-59 single/double schedules over 5 s delay + 5 s duration), and
``compose`` merges bundles by tagging every op's :f with [name, inner-f]
and routing on the tag (:61-106).  The menu (:108-316): parts (random
halves), startstop/startkill over n nodes, majring, strobe-skews,
a clock-skew ladder (small 100 ms → huge 5 s, the big ones paired with
netem slowdowns via the ``slowing`` wrapper :151-172), the
``restarting`` wrapper that restarts dead cockroach daemons after every
:stop (:174-194), and the range-``split`` nemesis driving
``ALTER TABLE … SPLIT AT`` below the most recently written key
(:270-316).

The double schedule overlaps two *instances* of a fault family
(start1/start2 interleaved), exactly the shape the reference uses for
compound runs.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .. import control
from .. import generator as gen
from .. import net as net_mod
from ..nemesis import (
    Nemesis,
    hammer_time,
    node_start_stopper,
    noop,
    partition_random_halves,
    partition_majorities_ring,
)
from ..nemesis import time as nt

#: seconds between interruptions / duration of one (reference: :19-23)
NEMESIS_DELAY = 5
NEMESIS_DURATION = 5


def no_gen() -> dict:
    return {"during": None, "final": None}


def single_gen() -> dict:
    """delay → start → duration → stop, forever (reference: :31-37)."""
    return {
        "during": gen.cycle([
            gen.sleep(NEMESIS_DELAY),
            {"type": "info", "f": "start"},
            gen.sleep(NEMESIS_DURATION),
            {"type": "info", "f": "stop"},
        ]),
        "final": [{"type": "info", "f": "stop"}],
    }


def double_gen() -> dict:
    """Two overlapping fault instances, alternating which leads
    (reference: :39-59)."""
    half = NEMESIS_DURATION / 2
    return {
        "during": gen.cycle([
            gen.sleep(NEMESIS_DELAY),
            {"type": "info", "f": "start1"},
            gen.sleep(half),
            {"type": "info", "f": "start2"},
            gen.sleep(half),
            {"type": "info", "f": "stop1"},
            gen.sleep(half),
            {"type": "info", "f": "stop2"},
            gen.sleep(NEMESIS_DELAY),
            {"type": "info", "f": "start2"},
            gen.sleep(half),
            {"type": "info", "f": "start1"},
            gen.sleep(half),
            {"type": "info", "f": "stop2"},
            gen.sleep(half),
            {"type": "info", "f": "stop1"},
        ]),
        "final": [{"type": "info", "f": "stop1"},
                  {"type": "info", "f": "stop2"}],
    }


# ---------------------------------------------------------------------
# Wrappers (reference: slowing :151-172, restarting :174-194)
# ---------------------------------------------------------------------


class Slowing(Nemesis):
    """Slow the network by ``dt`` seconds around the wrapped nemesis's
    start/stop window."""

    def __init__(self, nem: Nemesis, dt_s: float):
        self.nem = nem
        self.dt_s = dt_s

    def setup(self, test):
        net_mod_fast(test)
        self.nem = self.nem.setup(test) or self.nem
        return self

    def invoke(self, test, op):
        f = op.get("f")
        if _inner_f(f) == "start":
            net_mod_slow(test, {"mean": self.dt_s * 1000, "variance": 1})
            return self.nem.invoke(test, op)
        if _inner_f(f) == "stop":
            try:
                return self.nem.invoke(test, op)
            finally:
                net_mod_fast(test)
        return self.nem.invoke(test, op)

    def teardown(self, test):
        net_mod_fast(test)
        self.nem.teardown(test)

    def fs(self):
        return self.nem.fs()


class Restarting(Nemesis):
    """After the wrapped nemesis completes a :stop, restart the DB on
    every node (clock faults can wedge cockroach; reference restarts
    via auto/start! :174-194)."""

    def __init__(self, nem: Nemesis, db):
        self.nem = nem
        self.db = db

    def setup(self, test):
        self.nem = self.nem.setup(test) or self.nem
        return self

    def invoke(self, test, op):
        out = self.nem.invoke(test, op)
        if _inner_f(op.get("f")) != "stop":
            return out

        def restart(test, node):
            try:
                self.db.start(test, node)
                return "started"
            except Exception as e:  # noqa: BLE001
                return repr(e)[:120]

        res = control.on_nodes(test, list(test["nodes"]), restart)
        return {**out,
                "value": [out.get("value"),
                          {str(k): str(v) for k, v in res.items()}]}

    def teardown(self, test):
        self.nem.teardown(test)

    def fs(self):
        return self.nem.fs()


def _inner_f(f):
    """A tagged f is (name, inner); untagged is inner."""
    if isinstance(f, (tuple, list)) and len(f) == 2:
        return f[1]
    return f


def net_mod_slow(test, opts):
    net = test.get("net", net_mod.iptables)
    net.slow(test, opts)


def net_mod_fast(test):
    net = test.get("net", net_mod.iptables)
    net.fast(test)


# ---------------------------------------------------------------------
# Clock-fault clients (reference: strobe-time :196-227, bump-time
# :229-255)
# ---------------------------------------------------------------------


class StrobeTime(Nemesis):
    """On :start, strobe the clock between now and delta ms ahead,
    flipping every period ms, for duration s, on every node."""

    def __init__(self, delta_ms, period_ms, duration_s):
        self.delta_ms = delta_ms
        self.period_ms = period_ms
        self.duration_s = duration_s

    def setup(self, test):
        control.on_nodes(test, list(test["nodes"]),
                         lambda t, n: nt.reset_time())
        return self

    def invoke(self, test, op):
        if _inner_f(op.get("f")) != "start":
            return {**op, "type": "info", "value": None}
        res = control.on_nodes(
            test, list(test["nodes"]),
            lambda t, n: nt.strobe_time(
                self.delta_ms, self.period_ms, self.duration_s
            ),
        )
        return {**op, "type": "info",
                "value": {str(k): str(v) for k, v in res.items()}}

    def teardown(self, test):
        control.on_nodes(test, list(test["nodes"]),
                         lambda t, n: nt.reset_time())

    def fs(self):
        return frozenset({"start", "stop"})


class BumpTime(Nemesis):
    """On :start, bump the clock by dt seconds on a random half of the
    nodes (``gen.rng`` drawn once a node, in node order); on :stop, reset
    every clock."""

    def __init__(self, dt_s: float):
        self.dt_s = dt_s

    def setup(self, test):
        control.on_nodes(test, list(test["nodes"]),
                         lambda t, n: nt.reset_time())
        return self

    def invoke(self, test, op):
        f = _inner_f(op.get("f"))
        if f == "start":
            dt_ms = self.dt_s * 1000
            nodes = list(test["nodes"])
            # one draw a node, in node order, before the nodes' threads
            # start (the reference draws on those threads, in the order
            # they happen to run)
            bumped = {n: gen.rng.random() < 0.5 for n in nodes}

            def act(t, n):
                if bumped[n]:
                    nt.bump_time(dt_ms)
                    return self.dt_s
                return 0

            res = control.on_nodes(test, nodes, act)
        else:
            res = control.on_nodes(test, list(test["nodes"]),
                                   lambda t, n: nt.reset_time())
        return {**op, "type": "info",
                "value": {str(k): str(v) for k, v in res.items()}}

    def teardown(self, test):
        control.on_nodes(test, list(test["nodes"]),
                         lambda t, n: nt.reset_time())

    def fs(self):
        return frozenset({"start", "stop"})


# ---------------------------------------------------------------------
# Range-split nemesis (reference: split-nemesis :270-316)
# ---------------------------------------------------------------------


#: (table, key column) the split probe targets per workload — the
#: shared SQL clients' schemas (suites/sql.py)
SPLIT_TABLES = {
    "register": ("registers", "id"),
    "bank": ("accounts", "id"),
    "set": ("sets", "val"),
    "sets": ("sets", "val"),
    "list-append": ("lists", "id"),
}


class SplitNemesis(Nemesis):
    """Perform ``ALTER TABLE … SPLIT AT`` at the most recently written
    key.  Key sources, in order: an optional test-supplied ``keyrange``
    map ({table: set-of-keys} — the shape of the reference's atom,
    cockroach clients there maintain it); else a live ``SELECT max``
    probe on the running workload's table (SPLIT_TABLES maps
    opts["workload"] to its schema).  Splitting a key twice is
    recorded, not raised."""

    def __init__(self, opts: Optional[dict] = None):
        self.opts = dict(opts or {})
        self.table, self.column = SPLIT_TABLES.get(
            self.opts.get("workload", "register"), ("registers", "id")
        )
        self.already: dict = {}
        self.client = None

    def setup(self, test):
        from . import sql

        opts = {**self.opts, "host": self.opts.get(
            "host", str(test["nodes"][0]))}
        opts.setdefault("dialect", "cockroach")
        try:
            c = sql.RegisterClient(opts)
            self.client = c.open(test, test["nodes"][0])
        except Exception:  # noqa: BLE001 - probe-only client
            self.client = None
        return self

    def _pick_key(self, test):
        keyrange = test.get("keyrange")
        if keyrange is None:
            return self._probe_key(test)
        if not keyrange:
            return None, "nothing-to-split"
        table = gen.rng.choice(sorted(keyrange))
        ks = set(keyrange[table]) - self.already.get(table, set())
        if not ks:
            return None, "nothing-to-split"
        # the newest unsplit key: splits chase the active write
        # frontier, not cold historical ranges
        return (table, max(ks)), None

    def _probe_key(self, test):
        if self.client is None:
            return None, "no-keyrange"
        try:
            res = self.client.conn.query(
                f"SELECT max({self.column}) FROM {self.table}"
            )
            k = res.rows[0][0] if res.rows else None
        except Exception:  # noqa: BLE001
            return None, "no-keyrange"
        if k is None:
            return None, "nothing-to-split"
        k = int(k)
        if k in self.already.get(self.table, set()):
            return None, "nothing-to-split"
        return (self.table, k), None

    def invoke(self, test, op):
        picked, why = self._pick_key(test)
        if picked is None:
            return {**op, "type": "info", "value": why}
        table, k = picked
        try:
            self.client.conn.query(
                f"ALTER TABLE {table} SPLIT AT VALUES ({int(k)})"
            )
            self.already.setdefault(table, set()).add(k)
            value = ["split", table, k]
        except Exception as e:  # noqa: BLE001
            if "already split" in str(e):
                self.already.setdefault(table, set()).add(k)
                value = ["already-split", table, k]
            else:
                value = ["split-failed", table, k, repr(e)[:120]]
        return {**op, "type": "info", "value": value}

    def teardown(self, test):
        if self.client is not None:
            try:
                self.client.close(test)
            except Exception:  # noqa: BLE001
                pass

    def fs(self):
        return frozenset({"split"})


# ---------------------------------------------------------------------
# The named menu (reference: :108-316)
# ---------------------------------------------------------------------


def none() -> dict:
    return {**no_gen(), "name": "blank", "client": noop(), "clocks": False}


def parts() -> dict:
    return {**single_gen(), "name": "parts",
            "client": partition_random_halves(), "clocks": False}


def _take_n_shuffled(n: int) -> Callable:
    def targeter(nodes):
        nodes = list(nodes)
        gen.rng.shuffle(nodes)
        return nodes[:n]
    return targeter


def startstop(n: int = 1, db=None) -> dict:
    """SIGSTOP/CONT the cockroach process on n random nodes."""
    return {**single_gen(),
            "name": f"startstop{n if n > 1 else ''}",
            "client": hammer_time("cockroach", _take_n_shuffled(n)),
            "clocks": False}


def startkill(n: int = 1, db=None) -> dict:
    """Kill + restart the DB on n random nodes."""
    assert db is not None, "startkill needs the suite DB"
    return {**single_gen(),
            "name": f"startkill{n if n > 1 else ''}",
            "client": node_start_stopper(
                _take_n_shuffled(n),
                lambda test, node: db.kill(test, node),
                lambda test, node: db.start(test, node),
            ),
            "clocks": False}


def majring() -> dict:
    return {**single_gen(), "name": "majring",
            "client": partition_majorities_ring(), "clocks": False}


def strobe_skews(db=None) -> dict:
    # no sleeps: the start op itself takes `duration` to run (:229-236)
    return {
        "during": gen.cycle([{"type": "info", "f": "start"},
                             {"type": "info", "f": "stop"}]),
        "final": [{"type": "info", "f": "stop"}],
        "name": "strobe-skews",
        "client": Restarting(StrobeTime(200, 10, 10), db),
        "clocks": True,
    }


def _skew(name: str, offset_s: float, db=None) -> dict:
    return {**single_gen(), "name": name,
            "client": Restarting(BumpTime(offset_s), db), "clocks": True}


def small_skews(db=None) -> dict:
    return _skew("small-skews", 0.100, db)


def subcritical_skews(db=None) -> dict:
    return _skew("subcritical-skews", 0.200, db)


def critical_skews(db=None) -> dict:
    return _skew("critical-skews", 0.250, db)


def big_skews(db=None) -> dict:
    b = _skew("big-skews", 0.5, db)
    b["client"] = Slowing(b["client"], 0.5)
    return b


def huge_skews(db=None) -> dict:
    b = _skew("huge-skews", 5, db)
    b["client"] = Slowing(b["client"], 5)
    return b


def split(opts: Optional[dict] = None) -> dict:
    return {
        "during": gen.delay(2, gen.repeat({"type": "info", "f": "split"})),
        "final": None,
        "name": "splits",
        "client": SplitNemesis(opts),
        "clocks": False,
    }


#: name → constructor(db, opts); the runner's --nemesis vocabulary
MENU: dict = {
    "none": lambda db, opts: none(),
    "parts": lambda db, opts: parts(),
    "majority-ring": lambda db, opts: majring(),
    "start-stop": lambda db, opts: startstop(1, db),
    "start-stop-2": lambda db, opts: startstop(2, db),
    "start-kill": lambda db, opts: startkill(1, db),
    "start-kill-2": lambda db, opts: startkill(2, db),
    "strobe-skews": lambda db, opts: strobe_skews(db),
    "small-skews": lambda db, opts: small_skews(db),
    "subcritical-skews": lambda db, opts: subcritical_skews(db),
    "critical-skews": lambda db, opts: critical_skews(db),
    "big-skews": lambda db, opts: big_skews(db),
    "huge-skews": lambda db, opts: huge_skews(db),
    "split": lambda db, opts: split(opts),
}


# ---------------------------------------------------------------------
# Tagged composition (reference: compose :61-106)
# ---------------------------------------------------------------------


class TaggedCompose(Nemesis):
    """Routes ops whose f is (name, inner-f) to the named client,
    invoking it with the inner f and re-tagging the result."""

    def __init__(self, clients: dict):
        self.clients = dict(clients)

    def setup(self, test):
        self.clients = {
            name: (c.setup(test) or c) for name, c in self.clients.items()
        }
        return self

    def invoke(self, test, op):
        f = op.get("f")
        if not (isinstance(f, (tuple, list)) and len(f) == 2):
            raise ValueError(f"untagged nemesis op f {f!r}")
        name, inner = f
        if name not in self.clients:
            raise ValueError(f"no nemesis bundle named {name!r}")
        out = self.clients[name].invoke(test, {**op, "f": inner})
        return {**out, "f": (name, out.get("f", inner))}

    def teardown(self, test):
        for c in self.clients.values():
            c.teardown(test)

    def fs(self):
        return frozenset(
            (name, f)
            for name, c in self.clients.items()
            for f in (c.fs() or ())
        )


def _tag(name: str, g):
    """Rewrite every op's f to (name, f).  Special ops (sleep/log)
    carry no f and pass through untouched."""
    if g is None:
        return None

    def retag(op):
        if op.get("type") in ("sleep", "log") or "f" not in op:
            return op
        return {**op, "f": (name, op["f"])}

    return gen.map(retag, g)


#: shading colors for named bundles, cycled by position
_PERF_COLORS = ("#E9A4A0", "#A0B1E9", "#A0E9DB", "#E9D3A0", "#C9A0E9")


def _bundle_perf(bundles):
    """One plot-shading spec per bundle: its (name, start/stop) tagged
    fs and a stable color."""
    return {
        (b["name"], frozenset({(b["name"], "start")}),
         frozenset({(b["name"], "stop")}),
         _PERF_COLORS[i % len(_PERF_COLORS)])
        for i, b in enumerate(bundles)
    }


def _f_map_ops(fmap: dict, g):
    """f_map that leaves special (sleep/log) ops untouched."""
    if g is None:
        return None

    def rf(op):
        if op.get("type") in ("sleep", "log") or "f" not in op:
            return op
        return {**op, "f": fmap.get(op["f"], op["f"])}

    return gen.map(rf, g)


def compose_double(bundles: List[dict]) -> dict:
    """Run exactly two bundles on the overlapping double schedule:
    instance 1 and 2 start/stop interleaved, alternating which leads
    (reference: nemesis-double-gen :39-59 — its start1/stop1 fs are
    this composition's routing keys)."""
    assert len(bundles) == 2, "the double schedule takes exactly 2"
    n1, n2 = bundles[0]["name"], bundles[1]["name"]
    assert n1 != n2, f"duplicate name {n1!r}"
    fmap = {"start1": (n1, "start"), "stop1": (n1, "stop"),
            "start2": (n2, "start"), "stop2": (n2, "stop")}
    sched = double_gen()
    return {
        "name": f"{n1}~{n2}",
        "nemesis": TaggedCompose({b["name"]: b["client"]
                                  for b in bundles}),
        "generator": _f_map_ops(fmap, sched["during"]),
        "final_generator": _f_map_ops(fmap, sched["final"]),
        "clocks": any(b.get("clocks") for b in bundles),
        "perf": _bundle_perf(bundles),
    }


def compose_named(bundles: List[dict]) -> dict:
    """Merge named bundles into one {name, nemesis, generator,
    final_generator, clocks} package."""
    bundles = [b for b in bundles if b is not None]
    names = [b["name"] for b in bundles]
    assert len(set(names)) == len(names), f"duplicate names in {names}"
    durings = [_tag(b["name"], b.get("during")) for b in bundles]
    durings = [d for d in durings if d is not None]
    finals = [_tag(b["name"], b.get("final")) for b in bundles]
    finals = [f for f in finals if f is not None]
    return {
        "name": "+".join(names),
        "nemesis": TaggedCompose({b["name"]: b["client"] for b in bundles}),
        "generator": gen.mix(durings) if durings else None,
        "final_generator": finals or None,
        "clocks": any(b.get("clocks") for b in bundles),
        "perf": _bundle_perf(bundles),
    }


def package(opts: dict, db) -> dict:
    """Build the composed package from opts["nemesis"] — one name or a
    list from MENU (reference: runner.clj parses --nemesis /
    --nemesis2 into exactly this composition)."""
    spec = opts.get("nemesis", "none")
    if isinstance(spec, str):
        spec = [spec]
    unknown = [s for s in spec if s not in MENU]
    if unknown:
        raise ValueError(
            f"unknown cockroach nemesis {unknown}; menu: {sorted(MENU)}"
        )
    bundles = [MENU[s](db, opts) for s in spec]
    if opts.get("nemesis-schedule") == "double":
        if len(bundles) != 2:
            raise ValueError(
                "nemesis-schedule=double needs exactly two nemeses, "
                f"got {spec}"
            )
        return compose_double(bundles)
    return compose_named(bundles)
