"""Dgraph fault menu — the port's copy of
:mod:`jepsen_tpu.suites.dgraph_nemesis`: alpha/zero-targeted process
faults, speculative alpha repair, tablet (predicate) moves, partitions,
and clock skew.

Reference: dgraph/src/jepsen/dgraph/nemesis.clj — alpha-killer (:17-23,
targeting every node), alpha-fixer (:25-41, speculative restarts of
alphas that fell over while zero was away), zero-killer (:43-49),
tablet-mover (:51-101, shuffling predicates between groups through the
zero leader's HTTP API), bump-time clock skew with NTP-reset setup and
tiny…huge presets (:100-139), full-nemesis composition (:141-156), the
per-flag cycle generator (:158-186), and the delayed recovery final
generator (:187-202).  Tablet moves run under tracing spans exactly as
the reference wraps them (trace.clj via nemesis.clj:55-60).
"""

from __future__ import annotations

import re
from typing import Optional

from .. import control
from .. import generator as gen
from .. import trace
from ..nemesis import (
    Nemesis,
    bisect,
    complete_grudge,
    compose,
    majorities_ring,
    partitioner,
)
from ..nemesis import time as nt
from ..util import random_nonempty_subset

#: skew presets, milliseconds (reference: nemesis.clj:131-139)
SKEWS = {"tiny": 100, "small": 250, "big": 2000, "huge": 7500}


class AlphaKiller(Nemesis):
    """kill-alpha stops alphas on every node; restart-alpha brings them
    all back (reference: nemesis.clj:17-23 — its targeter is
    `identity`, i.e. the whole node list)."""

    def __init__(self, db):
        self.db = db

    def setup(self, test):
        return self

    def invoke(self, test, op):
        nodes = list(test["nodes"])
        if op["f"] == "kill-alpha":
            res = control.on_nodes(test, nodes, self.db.stop_alpha)
        else:
            res = control.on_nodes(test, nodes, self.db.start_alpha)
        return {**op, "type": "info",
                "value": {str(k): str(v) for k, v in res.items()}}

    def teardown(self, test):
        pass

    def fs(self):
        return frozenset({"kill-alpha", "restart-alpha"})


class AlphaFixer(Nemesis):
    """Speculative alpha restarts: alphas fall over when zero
    disappears, so fix-alpha restarts any that aren't running on a
    random node subset (reference: nemesis.clj:25-41)."""

    def __init__(self, db):
        self.db = db

    def setup(self, test):
        return self

    def invoke(self, test, op):
        db = self.db

        def fix(test, node):
            if db.alpha_running(test, node):
                return "already-running"
            db.start_alpha(test, node)
            return "restarted"

        targets = random_nonempty_subset(list(test["nodes"]), gen.rng)
        res = control.on_nodes(test, targets, fix)
        return {**op, "type": "info",
                "value": {str(k): str(v) for k, v in res.items()}}

    def teardown(self, test):
        pass

    def fs(self):
        return frozenset({"fix-alpha"})


class ZeroKiller(Nemesis):
    """kill/restart zero on (a random subset of) the zero nodes
    (reference: nemesis.clj:43-49)."""

    def __init__(self, db):
        self.db = db

    def setup(self, test):
        return self

    def invoke(self, test, op):
        zeros = self.db.zero_nodes(test)
        if op["f"] == "kill-zero":
            targets = random_nonempty_subset(zeros, gen.rng)
            res = control.on_nodes(test, targets, self.db.stop_zero)
        else:
            res = control.on_nodes(test, zeros, self.db.start_zero)
        return {**op, "type": "info",
                "value": {str(k): str(v) for k, v in res.items()}}

    def teardown(self, test):
        pass

    def fs(self):
        return frozenset({"kill-zero", "restart-zero"})


class TabletMover(Nemesis):
    """Shuffles predicates (tablets) between Raft groups through the
    zero leader (reference: nemesis.clj:51-101).  Reserved predicates
    and not-the-leader refusals are recorded, not raised — the point is
    to exercise dgraph's rebalancing under load, not to crash the
    harness on its answers."""

    def __init__(self, db):
        self.db = db

    def setup(self, test):
        with trace.with_trace("nemesis.tablet-mover.setup"):
            return self

    def invoke(self, test, op):
        with trace.with_trace("nemesis.tablet-mover.invoke"):
            # the zero HTTP API lives on the zero nodes only
            node = gen.rng.choice(self.db.zero_nodes(test))
            state = self.db.zero_state(test, node)
            if not isinstance(state, dict):
                return {**op, "type": "info", "value": "timeout"}
            groups = list((state.get("groups") or {}).keys())
            moves = {}
            refused = {}
            tablets = [
                t
                for g in (state.get("groups") or {}).values()
                for t in (g.get("tablets") or {}).values()
            ]
            gen.rng.shuffle(tablets)
            for tablet in tablets:
                pred = tablet.get("predicate")
                group = str(tablet.get("groupId"))
                group2 = gen.rng.choice(groups) if groups else group
                if group2 == group:
                    continue
                trace.annotate(f"moving {pred} {group}->{group2}")
                status, body = self.db.move_tablet(test, node, pred, group2)
                if status == 200:
                    moves[pred] = [group, group2]
                elif status == 500 and re.search(
                    "Unable to move reserved|not leader", str(body)
                ):
                    refused[pred] = str(body)[:120]
                else:
                    # zero died / unexpected answer: record and stop —
                    # the remaining moves would hit the same wall
                    refused[pred] = str(body)[:120]
                    break
            value: dict = {"moved": moves}
            if refused:
                value["refused"] = refused
            return {**op, "type": "info", "value": value}

    def teardown(self, test):
        pass

    def fs(self):
        return frozenset({"move-tablet"})


class BumpTime(Nemesis):
    """start-skew bumps the clock by dt ms on a random half of the
    nodes (``gen.rng`` drawn once a node, in node order); stop-skew
    resets everyone.  Setup resets clocks up front
    (reference: nemesis.clj:100-129)."""

    def __init__(self, dt_ms: int):
        self.dt_ms = dt_ms

    def setup(self, test):
        control.on_nodes(test, list(test["nodes"]),
                         lambda t, n: nt.reset_time())
        return self

    def invoke(self, test, op):
        nodes = list(test["nodes"])
        if op["f"] == "start-skew":
            dt = self.dt_ms
            # one draw a node, in node order, before the nodes' threads
            # start (the reference draws on those threads, in the order
            # they happen to run)
            bumped = {n: gen.rng.random() < 0.5 for n in nodes}

            def act(t, n):
                if bumped[n]:
                    nt.bump_time(dt)
                    return dt
                return 0

            res = control.on_nodes(test, nodes, act)
        else:
            res = control.on_nodes(
                test, nodes, lambda t, n: nt.reset_time()
            )
        return {**op, "type": "info",
                "value": {str(k): str(v) for k, v in res.items()}}

    def teardown(self, test):
        control.on_nodes(test, list(test["nodes"]),
                         lambda t, n: nt.reset_time())

    def fs(self):
        return frozenset({"start-skew", "stop-skew"})


def skew_nemesis(opts: dict) -> BumpTime:
    """(reference: nemesis.clj:131-139)"""
    return BumpTime(SKEWS.get(opts.get("skew"), 0))


def full_nemesis(db, opts: Optional[dict] = None) -> Nemesis:
    """(reference: nemesis.clj:141-156 full-nemesis)"""
    opts = opts or {}
    return compose([
        (frozenset({"fix-alpha"}), AlphaFixer(db)),
        (frozenset({"kill-alpha", "restart-alpha"}), AlphaKiller(db)),
        (frozenset({"kill-zero", "restart-zero"}), ZeroKiller(db)),
        (frozenset({"move-tablet"}), TabletMover(db)),
        ({"start-partition-halves": "start",
          "stop-partition-halves": "stop",
          "start-partition-ring": "start",
          "stop-partition-ring": "stop"}, partitioner()),
        (frozenset({"start-skew", "stop-skew"}), skew_nemesis(opts)),
    ])


def _op(f, value=None, **extra):
    return {"type": "info", "f": f, "value": value, **extra}


def _partition_halves_gen(test, ctx):
    nodes = list(test["nodes"])
    gen.rng.shuffle(nodes)
    return _op("start-partition-halves", complete_grudge(bisect(nodes)))


def _partition_ring_gen(test, ctx):
    return _op("start-partition-ring",
               majorities_ring(list(test["nodes"])))


def full_generator(opts: dict):
    """Cycle each enabled fault family, mixed and staggered by the
    interval (reference: nemesis.clj:158-186 full-generator)."""
    modes = []
    if opts.get("kill-alpha?"):
        modes.append(gen.cycle([_op("kill-alpha"), _op("restart-alpha")]))
    if opts.get("kill-zero?"):
        modes.append(gen.cycle([_op("kill-zero"), _op("restart-zero")]))
    if opts.get("fix-alpha?"):
        modes.append(gen.repeat(_op("fix-alpha")))
    if opts.get("partition-halves?"):
        modes.append(gen.flip_flop(
            _partition_halves_gen,
            gen.repeat(_op("stop-partition-halves"))))
    if opts.get("partition-ring?"):
        modes.append(gen.flip_flop(
            _partition_ring_gen,
            gen.repeat(_op("stop-partition-ring"))))
    if opts.get("skew-clock?"):
        modes.append(gen.cycle([_op("start-skew"), _op("stop-skew")]))
    if opts.get("move-tablet?"):
        modes.append(gen.repeat(_op("move-tablet")))
    if not modes:
        return None
    return gen.stagger(opts.get("interval", 10), gen.mix(modes))


def final_generator(opts: dict):
    """The recovery ops for everything the enabled faults may have
    broken, in heal-before-restart order (reference: nemesis.clj
    :187-202; package() adds the reference's 5 s spacing)."""
    fs = []
    if opts.get("partition-halves?"):
        fs.append("stop-partition-halves")
    if opts.get("partition-ring?"):
        fs.append("stop-partition-ring")
    if opts.get("skew-clock?"):
        fs.append("stop-skew")
    if opts.get("kill-zero?"):
        fs.append("restart-zero")
    if opts.get("kill-alpha?"):
        fs.append("restart-alpha")
    return [_op(f) for f in fs]


#: faults the menu claims; anything else rides the generic packages
KNOWN_FAULTS = frozenset({
    "kill-alpha", "kill-zero", "fix-alpha", "move-tablet",
    "partition-halves", "partition-ring", "skew-clock",
})


def _flags(opts: dict) -> dict:
    faults = set(opts.get("faults", ()))
    return {
        "kill-alpha?": "kill-alpha" in faults,
        "kill-zero?": "kill-zero" in faults,
        "fix-alpha?": "fix-alpha" in faults,
        "move-tablet?": "move-tablet" in faults,
        "partition-halves?": "partition-halves" in faults,
        "partition-ring?": "partition-ring" in faults,
        "skew-clock?": "skew-clock" in faults,
        "interval": opts.get("interval", 10),
        # a requested skew fault must actually skew: default to the
        # small preset rather than silently bumping clocks by 0 ms
        "skew": opts.get("skew")
        or ("small" if "skew-clock" in faults else None),
    }


def package(opts: dict, db) -> dict:
    """{nemesis, generator, final_generator} bundle for build_test
    (reference: nemesis.clj:188-202 nemesis/0)."""
    flags = _flags(opts)
    final = final_generator(flags)
    return {
        "nemesis": full_nemesis(db, flags),
        "generator": full_generator(flags),
        # 5 s between recovery steps (reference: gen/delay-til 5)
        "final_generator": gen.delay(5, final) if final else None,
        "perf": set(),
    }
