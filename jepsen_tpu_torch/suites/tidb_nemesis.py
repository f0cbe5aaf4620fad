"""TiDB fault menu — the port's copy of
:mod:`jepsen_tpu.suites.tidb_nemesis`: per-component (pd / tikv / tidb)
process faults, PD scheduler stress, slow isolated PD primaries,
partitions, and clock skew, with flip-flop fault/recovery scheduling.

Reference: tidb/src/tidb/nemesis.clj — process-nemesis (:19-53:
kill/start/pause/resume each of pd, tikv, and tidb independently;
resume/start target every node, faults a random nonempty subset, and an
op :value overrides the targets), schedule-nemesis (:55-87: pd-ctl
shuffle-leader / shuffle-region / random-merge schedulers added and
removed on one node), slow-primary-nemesis (:89-147: run the PD
leader's clock slow via faketime, transfer leadership to it, then
isolate it in a minority), full-nemesis composition (:149-166),
partition generators for single-node / pd-leader / half / ring grudges
(:170-207), the clock mix with tidb's f names (:209-216), opt-mix +
flip-flop mixed-generator (:218-283), final-generator recovery
(:285-306), the restart-kv-without-pd and slow-primary special
schedules (:308-340), full-generator dispatch (:342-359), and the
:kill/:stop/:pause/:schedules/:partition shorthand expansion (:361-380).
"""

from __future__ import annotations

import time as _time

from .. import control
from .. import faketime
from .. import generator as gen
from .. import net as net_mod
from ..nemesis import (
    Nemesis,
    bisect,
    complete_grudge,
    compose,
    majorities_ring,
    partitioner,
    split_one,
)
from ..nemesis import time as nt
from ..util import random_nonempty_subset

#: every f the process nemesis owns
PROCESS_FS = frozenset({
    "start-pd", "start-kv", "start-db",
    "kill-pd", "kill-kv", "kill-db",
    "pause-pd", "pause-kv", "pause-db",
    "resume-pd", "resume-kv", "resume-db",
})

#: fs that recover rather than break — these target every node
RECOVERY_FS = frozenset({
    "start-pd", "start-kv", "start-db",
    "resume-pd", "resume-kv", "resume-db",
})

SCHEDULE_FS = frozenset({
    "shuffle-leader", "del-shuffle-leader",
    "shuffle-region", "del-shuffle-region",
    "random-merge", "del-random-merge",
})

#: pd-ctl scheduler commands per f (reference: nemesis.clj:74-85 —
#: the reference pipes `sched add …`, but pd-ctl's actual command
#: table spells it `scheduler`; `sched` is rejected, which the
#: reference's own swallow-the-error handler hides)
_SCHEDULERS = {
    "shuffle-leader": ("scheduler", "add", "shuffle-leader-scheduler"),
    "del-shuffle-leader":
        ("scheduler", "remove", "shuffle-leader-scheduler"),
    "shuffle-region": ("scheduler", "add", "shuffle-region-scheduler"),
    "del-shuffle-region":
        ("scheduler", "remove", "shuffle-region-scheduler"),
    "random-merge": ("scheduler", "add", "random-merge-scheduler"),
    "del-random-merge": ("scheduler", "remove", "random-merge-scheduler"),
}


class TidbProcessNemesis(Nemesis):
    """Kill, start, pause, and resume pd-server, tikv-server, and
    tidb-server independently (reference: nemesis.clj:19-53
    process-nemesis)."""

    def __init__(self, db):
        self.db = db

    def setup(self, test):
        return self

    def invoke(self, test, op):
        f = op["f"]
        nodes = list(test["nodes"])
        if f not in RECOVERY_FS:
            nodes = random_nonempty_subset(nodes, gen.rng)
        # "If the op wants to give us nodes, that's great"
        nodes = op.get("value") or nodes
        db = self.db
        actions = {
            "start-pd": db.start_pd, "start-kv": db.start_kv,
            "start-db": db.start_db,
            "kill-pd": db.stop_pd, "kill-kv": db.stop_kv,
            "kill-db": db.stop_db,
            "pause-pd": db.pause_pd, "pause-kv": db.pause_kv,
            "pause-db": db.pause_db,
            "resume-pd": db.resume_pd, "resume-kv": db.resume_kv,
            "resume-db": db.resume_db,
        }
        res = control.on_nodes(test, nodes, actions[f])
        return {**op, "type": "info",
                "value": {str(k): str(v) for k, v in res.items()}}

    def teardown(self, test):
        pass

    def fs(self):
        return PROCESS_FS


class ScheduleNemesis(Nemesis):
    """Add/remove PD stress-test schedulers (shuffle-leader,
    shuffle-region, random-merge) through pd-ctl on one node
    (reference: nemesis.clj:55-87 schedule-nemesis; a failed pd-ctl is
    recorded, not raised — :66-68 swallows it too)."""

    def __init__(self, db):
        self.db = db

    def setup(self, test):
        return self

    def invoke(self, test, op):
        node = gen.rng.choice(list(test["nodes"]))

        def act(test, node):
            try:
                self.db.pd_ctl(test, node, *_SCHEDULERS[op["f"]])
                return "ok"
            except Exception as e:  # noqa: BLE001
                return f"failed: {e!r}"[:120]

        res = control.on_nodes(test, [node], act)
        return {**op, "type": "info",
                "value": {str(k): str(v) for k, v in res.items()}}

    def teardown(self, test):
        pass

    def fs(self):
        return SCHEDULE_FS


class SlowPrimaryNemesis(Nemesis):
    """Create a slow, isolated PD primary: pick a random PD member,
    restart every pd-server under faketime (rate 0.1 on the victim,
    1.0 elsewhere), transfer PD leadership onto the slow node, then cut
    it off in a minority partition.  Because its clock runs slow it may
    fail to step down before the majority elects a faster leader —
    two primaries issuing timestamps concurrently (reference:
    nemesis.clj:89-147 slow-primary-nemesis; the partition is healed by
    the shared partitioner's :stop-partition, as the reference's
    slow-primary-generator does)."""

    def __init__(self, db):
        self.db = db

    def setup(self, test):
        return self

    def invoke(self, test, op):
        db = self.db
        nodes = list(test["nodes"])
        contact = nodes[0]
        members = db.pd_members(test, contact)
        if not isinstance(members, dict) or not members.get("members"):
            return {**op, "type": "info", "value": "failed",
                    "error": "pd-members-unreachable"}
        slow_leader = gen.rng.choice(members["members"])
        name = slow_leader.get("name")
        slow_node = next(
            (n for n in nodes if db._pd_name(test, n) == name), None
        )
        if slow_node is None:
            return {**op, "type": "info", "value": "failed",
                    "error": f"member {name!r} not in node list"}

        def reclock(test, node):
            rate = 0.1 if node == slow_node else 1.0
            try:
                faketime.wrap(f"{db.dir}/bin/pd-server", rate=rate)
            except Exception as e:  # noqa: BLE001
                return f"faketime-failed: {e!r}"[:120]
            db.stop_pd(test, node)
            db.start_pd(test, node)
            return f"rate={rate}"

        reclocked = control.on_nodes(test, nodes, reclock)
        # a full PD restart has no leader for a while — transferring
        # into the void silently degrades the scenario to partitioning
        # a random member (reference awaits db/pd-leader first,
        # nemesis.clj:119-121)
        deadline = _time.monotonic() + 60
        while (
            not isinstance(db.pd_leader(test, contact), dict)
            and _time.monotonic() < deadline
        ):
            _time.sleep(1)
        transfer = db.pd_transfer_leader(test, contact, name)

        # isolate the slow leader in a minority, through the same net
        # selection the shared partitioner uses (test["net"] when a
        # test supplies one, iptables otherwise)
        fast = [n for n in nodes if n != slow_node]
        gen.rng.shuffle(fast)
        grudge = complete_grudge(bisect([slow_node] + fast))
        net_mod.drop_all(test, grudge)
        return {**op, "type": "info",
                "value": {
                    "slow-node": str(slow_node),
                    "reclocked": {str(k): str(v)
                                  for k, v in reclocked.items()},
                    "transfer-status": transfer[0],
                    "isolated": True,
                }}

    def teardown(self, test):
        pass

    def fs(self):
        return frozenset({"slow-primary"})


def full_nemesis(db) -> Nemesis:
    """(reference: nemesis.clj:149-166 full-nemesis)"""
    return compose([
        (PROCESS_FS, TidbProcessNemesis(db)),
        (SCHEDULE_FS, ScheduleNemesis(db)),
        (frozenset({"slow-primary"}), SlowPrimaryNemesis(db)),
        ({"start-partition": "start", "stop-partition": "stop"},
         partitioner()),
        ({"reset-clock": "reset", "strobe-clock": "strobe",
          "check-clock-offsets": "check-offsets", "bump-clock": "bump"},
         nt.clock_nemesis()),
    ])


def _op(f, value=None, **extra):
    return {"type": "info", "f": f, "value": value, **extra}


def partition_one_gen(test, ctx):
    """Isolate one random node (reference: nemesis.clj:170-176)."""
    return _op("start-partition",
               complete_grudge(split_one(list(test["nodes"]))),
               partition_type="single-node")


def partition_pd_leader_gen(test, ctx):
    """Isolate the current PD leader in a minority (reference:
    nemesis.clj:178-188).  Falls back to a random loner when PD is
    unreachable — a dead PD mustn't park the fault schedule."""
    nodes = list(test["nodes"])
    db = test.get("db")
    leader = None
    if db is not None and hasattr(db, "pd_leader_node"):
        leader = db.pd_leader_node(test, gen.rng.choice(nodes))
    if leader is None:
        leader = gen.rng.choice(nodes)
    followers = [n for n in nodes if n != leader]
    gen.rng.shuffle(followers)
    grudge = complete_grudge([[leader], followers])
    return _op("start-partition", grudge, partition_type="pd-leader")


def partition_half_gen(test, ctx):
    """(reference: nemesis.clj:190-195)"""
    nodes = list(test["nodes"])
    gen.rng.shuffle(nodes)
    return _op("start-partition", complete_grudge(bisect(nodes)),
               partition_type="half")


def partition_ring_gen(test, ctx):
    """(reference: nemesis.clj:197-202)"""
    return _op("start-partition", majorities_ring(list(test["nodes"])),
               partition_type="ring")


def clock_gen():
    """The standard clock mix with tidb's f names (reference:
    nemesis.clj:209-216 clock-gen)."""
    return gen.f_map(
        {"check-offsets": "check-clock-offsets", "reset": "reset-clock",
         "strobe": "strobe-clock", "bump": "bump-clock"},
        nt.clock_gen(),
    )


def expand_options(n: dict) -> dict:
    """:kill → all three components, etc. (reference: nemesis.clj
    :361-380 expand-options)."""
    n = dict(n)
    if n.get("kill"):
        n["kill-pd"] = n["kill-kv"] = n["kill-db"] = True
    if n.get("pause"):
        n["pause-pd"] = n["pause-kv"] = n["pause-db"] = True
    if n.get("schedules"):
        n["shuffle-leader"] = n["shuffle-region"] = True
        n["random-merge"] = True
    if n.get("partition"):
        n["partition-one"] = n["partition-pd-leader"] = True
        n["partition-half"] = n["partition-ring"] = True
    return n


def _opt_mix(n: dict, possible: dict):
    gens = [g for opt, g in possible.items() if n.get(opt)]
    return gen.mix(gens) if gens else None


def mixed_generator(n: dict):
    """Flip-flops between each enabled fault family and its single
    recovery, staggered by the interval (reference: nemesis.clj
    :218-283 mixed-generator)."""
    def o(possible, recovery):
        m = _opt_mix(n, possible)
        return gen.flip_flop(m, gen.repeat(recovery)) if m else None

    modes = [
        o({"kill-pd": lambda t, c: _op("kill-pd")}, _op("start-pd")),
        o({"kill-kv": lambda t, c: _op("kill-kv")}, _op("start-kv")),
        o({"kill-db": lambda t, c: _op("kill-db")}, _op("start-db")),
        o({"pause-pd": lambda t, c: _op("pause-pd")}, _op("resume-pd")),
        o({"pause-kv": lambda t, c: _op("pause-kv")}, _op("resume-kv")),
        o({"pause-db": lambda t, c: _op("pause-db")}, _op("resume-db")),
        o({"shuffle-leader": lambda t, c: _op("shuffle-leader")},
          _op("del-shuffle-leader")),
        o({"shuffle-region": lambda t, c: _op("shuffle-region")},
          _op("del-shuffle-region")),
        o({"random-merge": lambda t, c: _op("random-merge")},
          _op("del-random-merge")),
        o({"partition-one": partition_one_gen,
           "partition-pd-leader": partition_pd_leader_gen,
           "partition-half": partition_half_gen,
           "partition-ring": partition_ring_gen},
          _op("stop-partition")),
        _opt_mix(n, {"clock-skew": clock_gen()}),
    ]
    modes = [m for m in modes if m is not None]
    if not modes:
        return None
    interval = n.get("interval", 10)
    if n.get("schedule") == "fixed":
        return gen.delay(interval, gen.mix(modes))
    return gen.stagger(interval, gen.mix(modes))


def final_generator(n: dict):
    """Recover everything the enabled faults may have broken
    (reference: nemesis.clj:285-306 final-generator)."""
    fs = []
    if n.get("clock-skew"):
        fs.append("reset-clock")
    for comp in ("pd", "kv", "db"):
        if n.get(f"pause-{comp}"):
            fs.append(f"resume-{comp}")
    for comp in ("pd", "kv", "db"):
        if n.get(f"kill-{comp}"):
            fs.append(f"start-{comp}")
    if n.get("shuffle-leader"):
        fs.append("del-shuffle-leader")
    if n.get("shuffle-region"):
        fs.append("del-shuffle-region")
    if n.get("random-merge"):
        fs.append("del-random-merge")
    if any(n.get(k) for k in
           ("partition-one", "partition-pd-leader", "partition-half",
            "partition-ring", "slow-primary")):
        fs.append("stop-partition")
    return [_op(f) for f in fs] or None


def restart_kv_without_pd_generator():
    """Pause all PDs, restart all KVs, wait, unpause: the cluster
    should recover, but a finite KV retry loop makes it fail
    (reference: nemesis.clj:308-320)."""
    def all_nodes(f):
        return lambda test, ctx: _op(f, list(test["nodes"]))

    return gen.phases(
        gen.sleep(10),
        gen.once(all_nodes("kill-kv")),
        gen.once(all_nodes("pause-pd")),
        [_op("start-kv")],
        gen.sleep(70),
        [_op("resume-pd")],
    )


def slow_primary_generator():
    """Alternate slow-primary windows with partition heals (reference:
    nemesis.clj:322-340 slow-primary-generator)."""
    return gen.cycle([
        _op("slow-primary"),
        gen.sleep(30),
        _op("stop-partition"),
        gen.sleep(30),
    ])


def full_generator(n: dict):
    """Special-case schedules take the whole generator; :long-recovery
    alternates 120 s fault windows with recovery + 60 s calm; else the
    plain mix (reference: nemesis.clj:342-359 full-generator)."""
    special = [f for f in ("restart-kv-without-pd", "slow-primary")
               if n.get(f)]
    if special:
        # a special schedule takes the whole generator; silently
        # dropping other requested faults would report scenarios never
        # exercised (the same contract suite_nemesis_package enforces)
        others = sorted(
            f for f in KNOWN_FAULTS
            if n.get(f) and f not in special
        )
        if others or len(special) > 1:
            raise ValueError(
                f"special schedule {special[0]!r} owns the whole fault "
                f"schedule; run {sorted(set(others) | set(special[1:]))} "
                "in a separate test"
            )
        if special[0] == "restart-kv-without-pd":
            return restart_kv_without_pd_generator()
        return slow_primary_generator()
    mixed = mixed_generator(n)
    if mixed is None:
        return None
    if n.get("long-recovery"):
        final = final_generator(n) or []
        window = gen.phases(
            gen.time_limit(120, mixed),
            list(final),
            gen.sleep(60),
        )
        return gen.cycle(window)
    return mixed


def package(opts: dict, db) -> dict:
    """The {nemesis, generator, final_generator} bundle build_test
    consumes, from a fault-name list (e.g. ["kill-kv",
    "partition-pd-leader", "clock-skew"]) or shorthands ("kill",
    "pause", "schedules", "partition") (reference: nemesis.clj:382-389
    nemesis)."""
    n = expand_options(
        {f: True for f in opts.get("faults", ())}
        | {"interval": opts.get("interval", 10),
           "long-recovery": bool(opts.get("long-recovery")),
           "schedule": opts.get("schedule")}
    )
    return {
        "nemesis": full_nemesis(db),
        "generator": full_generator(n),
        "final_generator": final_generator(n),
        "perf": {
            ("kill", frozenset({"kill-pd", "kill-kv", "kill-db"}),
             frozenset({"start-pd", "start-kv", "start-db"}), "#E9A4A0"),
            ("pause", frozenset({"pause-pd", "pause-kv", "pause-db"}),
             frozenset({"resume-pd", "resume-kv", "resume-db"}),
             "#A0B1E9"),
            ("partition", frozenset({"start-partition", "slow-primary"}),
             frozenset({"stop-partition"}), "#A0E9DB"),
        },
    }


#: fault names this module understands; tidb.test() routes to this
#: package when any appears in opts["faults"]
KNOWN_FAULTS = (
    (PROCESS_FS - RECOVERY_FS)
    | {f for f in SCHEDULE_FS if not f.startswith("del-")}
    | {
        "kill", "pause", "schedules", "partition",
        "partition-one", "partition-pd-leader", "partition-half",
        "partition-ring", "clock-skew", "slow-primary",
        "restart-kv-without-pd",
    }
)
