"""Nemesis "packages": composable {nemesis, generator, final_generator,
perf} bundles for partitions, clock skew, and process kill/pause — the
port's copy of :mod:`jepsen_tpu.nemesis.combined`.

(reference: jepsen/src/jepsen/nemesis/combined.clj — default-interval
:27-29, db-nodes node specs :38-61, db-nemesis :70-98, db-package
:141-160, grudge partition specs :162-188, partition-nemesis :196-224,
partition-package :226-246, clock-package :248-280, f-map :294-303,
compose-packages :305-316, nemesis-package :328-374.)

Not ported yet: the clock nemesis (``nemesis/time.py``, which builds
``native/bump-time.c`` on each node) and the disk faults (``faultfs.py``).
A package that asks for the ``clock`` or ``disk`` fault raises
``NotImplementedError`` naming them; idle, both sub-packages are what the
reference's are (the idle clock package routes the clock fs to a nemesis
that raises the same error when set up or invoked).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Set

from .. import control
from .. import db as db_mod
from .. import generator as gen
from ..util import majority, random_nonempty_subset
from . import (
    Nemesis,
    bisect,
    complete_grudge,
    compose,
    majorities_ring,
    noop as noop_nemesis,
    partitioner,
    split_one,
)
from . import f_map as nemesis_f_map

#: Seconds between nemesis operations (reference: combined.clj:27-29)
DEFAULT_INTERVAL = 10

NOOP_PACKAGE = {
    "generator": None,
    "final_generator": None,
    "nemesis": noop_nemesis(),
    "perf": set(),
}


def _rng():
    return gen.rng


def minority_third(n: int) -> int:
    """Up to, but not including, 1/3rd of nodes (reference:
    util.clj minority-third)."""
    return max(0, (n - 1) // 3)


def db_nodes(test: dict, db, node_spec) -> List[Any]:
    """Resolve a node spec to actual nodes.
    (reference: combined.clj:38-61)"""
    nodes = list(test["nodes"])
    rng = _rng()
    if node_spec is None:
        return random_nonempty_subset(nodes, rng)
    if node_spec == "one":
        return [rng.choice(nodes)]
    if node_spec == "minority":
        shuffled = list(nodes)
        rng.shuffle(shuffled)
        return shuffled[: majority(len(nodes)) - 1]
    if node_spec == "majority":
        shuffled = list(nodes)
        rng.shuffle(shuffled)
        return shuffled[: majority(len(nodes))]
    if node_spec == "minority-third":
        shuffled = list(nodes)
        rng.shuffle(shuffled)
        return shuffled[: minority_third(len(nodes))]
    if node_spec == "primaries":
        return random_nonempty_subset(db.primaries(test), rng)
    if node_spec == "all":
        return nodes
    return list(node_spec)


def node_specs(db) -> List[Any]:
    """(reference: combined.clj:63-68)"""
    specs: List[Any] = [None, "one", "minority-third", "minority", "majority", "all"]
    if isinstance(db, db_mod.Primary):
        specs.append("primaries")
    return specs


class DBNemesis(Nemesis):
    """start/kill/pause/resume a DB's processes on spec'd nodes.
    (reference: combined.clj:70-98)"""

    def __init__(self, db):
        self.db = db

    def invoke(self, test, op):
        f = op.get("f")
        fn = {
            "start": lambda t, n: self.db.start(t, n),
            "kill": lambda t, n: self.db.kill(t, n),
            "pause": lambda t, n: self.db.pause(t, n),
            "resume": lambda t, n: self.db.resume(t, n),
        }.get(f)
        if fn is None:
            raise ValueError(f"db nemesis cannot handle f={f!r}")
        nodes = db_nodes(test, self.db, op.get("value"))
        res = control.on_nodes(test, nodes, fn)
        return {**op, "type": "info", "value": {str(k): str(v) for k, v in res.items()}}

    def fs(self):
        return {"start", "kill", "pause", "resume"}


def db_package(opts: dict) -> dict:
    """(reference: combined.clj:100-160)"""
    db = opts["db"]
    faults = set(opts.get("faults", ()))
    kill = isinstance(db, db_mod.Process) and "kill" in faults
    pause = isinstance(db, db_mod.Pause) and "pause" in faults
    needed = kill or pause

    kill_targets = opts.get("kill", {}).get("targets", node_specs(db))
    pause_targets = opts.get("pause", {}).get("targets", node_specs(db))

    start = {"type": "info", "f": "start", "value": "all"}
    resume = {"type": "info", "f": "resume", "value": "all"}

    def kill_op(test, ctx):
        return {"type": "info", "f": "kill", "value": _rng().choice(kill_targets)}

    def pause_op(test, ctx):
        return {"type": "info", "f": "pause", "value": _rng().choice(pause_targets)}

    modes = []
    final = []
    if pause:
        modes.append(gen.flip_flop(pause_op, gen.repeat(resume)))
        final.append(resume)
    if kill:
        modes.append(gen.flip_flop(kill_op, gen.repeat(start)))
        final.append(start)

    generator = gen.stagger(
        opts.get("interval", DEFAULT_INTERVAL), gen.mix(modes)
    ) if modes else None
    return {
        "generator": generator if needed else None,
        "final_generator": final if needed else None,
        "nemesis": DBNemesis(db),
        "perf": {
            ("kill", frozenset({"kill"}), frozenset({"start"}), "#E9A4A0"),
            ("pause", frozenset({"pause"}), frozenset({"resume"}), "#A0B1E9"),
        },
    }


def grudge(test: dict, db, part_spec) -> Dict[Any, Set[Any]]:
    """Compute a grudge from a partition spec.
    (reference: combined.clj:162-188)"""
    nodes = list(test["nodes"])
    rng = _rng()
    if part_spec == "one":
        return complete_grudge(split_one(nodes))
    if part_spec == "majority":
        shuffled = list(nodes)
        rng.shuffle(shuffled)
        return complete_grudge(bisect(shuffled))
    if part_spec == "majorities-ring":
        return majorities_ring(nodes)
    if part_spec == "minority-third":
        shuffled = list(nodes)
        rng.shuffle(shuffled)
        k = minority_third(len(nodes))
        return complete_grudge([shuffled[:k], shuffled[k:]])
    if part_spec == "primaries":
        primaries = random_nonempty_subset(db.primaries(test), rng)
        components = [[n for n in nodes if n not in set(primaries)]] + [
            [p] for p in primaries
        ]
        return complete_grudge(components)
    return part_spec  # already a grudge


def partition_specs(db) -> List[Any]:
    """(reference: combined.clj:190-194)"""
    specs: List[Any] = ["one", "minority-third", "majority", "majorities-ring"]
    if isinstance(db, db_mod.Primary):
        specs.append("primaries")
    return specs


class PartitionNemesis(Nemesis):
    """start-partition/stop-partition with spec values.
    (reference: combined.clj:196-224)"""

    def __init__(self, db, p=None):
        self.db = db
        self.p = p or partitioner()

    def setup(self, test):
        return PartitionNemesis(self.db, self.p.setup(test))

    def invoke(self, test, op):
        f = op.get("f")
        if f == "start-partition":
            g = grudge(test, self.db, op.get("value"))
            res = self.p.invoke(test, {**op, "f": "start", "value": g})
        elif f == "stop-partition":
            res = self.p.invoke(test, {**op, "f": "stop", "value": None})
        else:
            raise ValueError(f"partition nemesis cannot handle f={f!r}")
        return {**res, "f": f}

    def teardown(self, test):
        self.p.teardown(test)

    def fs(self):
        return {"start-partition", "stop-partition"}


def partition_package(opts: dict) -> dict:
    """(reference: combined.clj:226-246)"""
    needed = "partition" in set(opts.get("faults", ()))
    db = opts["db"]
    targets = opts.get("partition", {}).get("targets", partition_specs(db))

    def start(test, ctx):
        return {
            "type": "info",
            "f": "start-partition",
            "value": _rng().choice(targets),
        }

    stop = {"type": "info", "f": "stop-partition", "value": None}
    g = gen.stagger(
        opts.get("interval", DEFAULT_INTERVAL),
        gen.flip_flop(start, gen.repeat(stop)),
    )
    return {
        "generator": g if needed else None,
        "final_generator": stop if needed else None,
        "nemesis": PartitionNemesis(db),
        "perf": {
            (
                "partition",
                frozenset({"start-partition"}),
                frozenset({"stop-partition"}),
                "#E9DCA0",
            )
        },
    }


class _UnportedClockNemesis(Nemesis):
    """The idle clock package's nemesis: the reference's clock nemesis
    (``nemesis/time.py``) takes the same fs, and this one raises naming
    it when set up or invoked."""

    def _unported(self):
        raise NotImplementedError(
            "the clock nemesis (the reference's nemesis/time.py, with "
            "native/bump-time.c) is not ported to jepsen_tpu_torch yet")

    def setup(self, test):
        self._unported()

    def invoke(self, test, op):
        self._unported()

    def fs(self):
        return {"reset", "bump", "strobe", "check-offsets"}


def clock_package(opts: dict) -> dict:
    """(reference: combined.clj:248-280)  Raises ``NotImplementedError``
    when the ``clock`` fault is asked for: its nemesis
    (``nemesis/time.py``) is not ported."""
    needed = "clock" in set(opts.get("faults", ()))
    if needed:
        _UnportedClockNemesis()._unported()
    nemesis = compose(
        [
            (
                {
                    "reset-clock": "reset",
                    "strobe-clock": "strobe",
                    "bump-clock": "bump",
                },
                _UnportedClockNemesis(),
            )
        ]
    )
    return {
        "generator": None,
        "final_generator": None,
        "nemesis": nemesis,
        "perf": {
            (
                "clock",
                frozenset({"bump-clock"}),
                frozenset({"reset-clock"}),
                "#A0E9E3",
            )
        },
    }


def f_map(lift: Callable[[Any], Any], pkg: dict) -> dict:
    """Lift a whole package's fs.  (reference: combined.clj:294-303)"""
    return {
        **pkg,
        "generator": gen.map(
            lambda op: {**op, "f": lift(op.get("f"))}, pkg["generator"]
        )
        if pkg.get("generator") is not None
        else None,
        "final_generator": gen.map(
            lambda op: {**op, "f": lift(op.get("f"))}, pkg["final_generator"]
        )
        if pkg.get("final_generator") is not None
        else None,
        "nemesis": nemesis_f_map(lift, pkg["nemesis"]),
        "perf": {
            (lift(name), frozenset(map(lift, start)), frozenset(map(lift, stop)), color)
            for (name, start, stop, color) in pkg.get("perf", set())
        },
    }


def compose_packages(packages: Iterable[dict]) -> dict:
    """any() over generators, sequence of final generators, composed
    nemeses, union of perf specs.  (reference: combined.clj:305-316)"""
    packages = list(packages)
    if not packages:
        return dict(NOOP_PACKAGE)
    if len(packages) == 1:
        return packages[0]
    perf: Set = set()
    for p in packages:
        perf |= set(p.get("perf", set()))
    return {
        "generator": gen.any(
            *[p["generator"] for p in packages if p.get("generator") is not None]
        ),
        "final_generator": [
            p["final_generator"]
            for p in packages
            if p.get("final_generator") is not None
        ],
        "nemesis": compose([p["nemesis"] for p in packages]),
        "perf": perf,
    }


def disk_package(opts: dict) -> dict:
    """Disk faults via the faultfs FUSE filesystem (no reference analogue
    in combined.clj).  Idle, the no-op package; asked for, it raises
    ``NotImplementedError``: ``faultfs.py`` (``native/faultfs.cc``) is not
    ported."""
    faults = set(opts.get("faults", ()))
    if "disk" not in faults:
        return dict(NOOP_PACKAGE)
    raise NotImplementedError(
        "the disk fault's nemesis (the reference's faultfs.py, with "
        "native/faultfs.cc) is not ported to jepsen_tpu_torch yet")


def nemesis_packages(opts: dict) -> List[dict]:
    """(reference: combined.clj:318-326)"""
    faults = set(opts.get("faults", ["partition", "kill", "pause", "clock"]))
    opts = {**opts, "faults": faults}
    return [
        partition_package(opts),
        clock_package(opts),
        db_package(opts),
        disk_package(opts),
    ]


def nemesis_package(opts: dict, only_active: bool = False) -> dict:
    """The standard broad-spectrum fault package.  With ``only_active``,
    drop sub-packages whose faults weren't requested (their generators
    are None) — needed when composing with a suite's own fault menu,
    whose op names would otherwise collide with the idle sub-nemeses.
    (reference: combined.clj:328-374)"""
    pkgs = nemesis_packages(opts)
    if only_active:
        pkgs = [p for p in pkgs if p.get("generator") is not None]
    return compose_packages(pkgs)
