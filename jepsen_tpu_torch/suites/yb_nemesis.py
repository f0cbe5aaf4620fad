"""YugabyteDB fault menu — the port's copy of
:mod:`jepsen_tpu.suites.yb_nemesis`: master/tserver-targeted process
faults, partitions, and clock skew, with flip-flop fault/recovery
scheduling.

Reference: yugabyte/src/yugabyte/nemesis.clj — process-nemesis
(:12-46: kill/stop/pause/resume target random node subsets, with master
ops restricted to the master nodes), clock-nemesis-wrapper (:48-67:
also stops the ntp service), full-nemesis composition (:69-84),
partition generators (:86-116), mixed-generator's
flip-flop-per-fault-family shape (:155-191), final-generator recovery
(:193-209), long-recovery alternation (:211-223), and the
:kill/:stop/:pause/:partition shorthand expansion (:225-238).
"""

from __future__ import annotations

from .. import control
from .. import generator as gen
from ..control import util as cu
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
    "start-master", "start-tserver",
    "stop-master", "stop-tserver",
    "kill-master", "kill-tserver",
    "pause-master", "pause-tserver",
    "resume-master", "resume-tserver",
})


class YbProcessNemesis(Nemesis):
    """start/stop/kill/pause/resume masters and tservers independently.
    (reference: nemesis.clj:12-46 process-nemesis)"""

    def __init__(self, db):
        self.db = db

    def setup(self, test):
        return self

    def invoke(self, test, op):
        f = op["f"]
        nodes = list(test["nodes"])
        masters = self.db.master_nodes(test)
        if f in ("resume-tserver", "start-tserver"):
            targets = nodes
        elif f in ("resume-master", "start-master"):
            targets = masters
        elif f.endswith("-tserver"):
            targets = random_nonempty_subset(nodes, gen.rng)
        else:
            targets = random_nonempty_subset(masters, gen.rng)

        db = self.db

        def act(test, node):
            return {
                "start-master": db.start_master,
                "start-tserver": db.start_tserver,
                "stop-master": db.stop_master,
                "stop-tserver": db.stop_tserver,
                "kill-master": db.kill_master,
                "kill-tserver": db.kill_tserver,
                "pause-master": lambda t, n: cu.signal(
                    "yb-master", "STOP"),
                "pause-tserver": lambda t, n: cu.signal(
                    "yb-tserver", "STOP"),
                "resume-master": lambda t, n: cu.signal(
                    "yb-master", "CONT"),
                "resume-tserver": lambda t, n: cu.signal(
                    "yb-tserver", "CONT"),
            }[f](test, node)

        res = control.on_nodes(test, targets, act)
        return {**op, "type": "info",
                "value": {str(k): str(v) for k, v in res.items()}}

    def teardown(self, test):
        pass

    def fs(self):
        return PROCESS_FS


def full_nemesis(db) -> Nemesis:
    """(reference: nemesis.clj:69-84 full-nemesis — its
    clock-nemesis-wrapper existed only to stop the ntp service, which
    this framework's ClockNemesis.setup already does for
    ntp/ntpd/systemd-timesyncd, nemesis/time.py)"""
    return compose([
        (PROCESS_FS, YbProcessNemesis(db)),
        ({"start-partition": "start", "stop-partition": "stop"},
         partitioner()),
        ({"reset-clock": "reset", "strobe-clock": "strobe",
          "check-clock-offsets": "check-offsets", "bump-clock": "bump"},
         nt.clock_nemesis()),
    ])


def _op(f, value=None, **extra):
    return {"type": "info", "f": f, "value": value, **extra}


def partition_one_gen(test, ctx):
    """(reference: nemesis.clj:96-101)"""
    return _op("start-partition",
               complete_grudge(split_one(list(test["nodes"]))),
               partition_type="single-node")


def partition_half_gen(test, ctx):
    """(reference: nemesis.clj:103-108)"""
    nodes = list(test["nodes"])
    gen.rng.shuffle(nodes)
    return _op("start-partition", complete_grudge(bisect(nodes)),
               partition_type="half")


def partition_ring_gen(test, ctx):
    """(reference: nemesis.clj:110-115)"""
    return _op("start-partition", majorities_ring(list(test["nodes"])),
               partition_type="ring")


def clock_gen():
    """The standard clock mix with yugabyte's f names.
    (reference: nemesis.clj:127-134)"""
    return gen.f_map(
        {"check-offsets": "check-clock-offsets", "reset": "reset-clock",
         "strobe": "strobe-clock", "bump": "bump-clock"},
        nt.clock_gen(),
    )


def expand_options(n: dict) -> dict:
    """:kill → kill both components, etc.
    (reference: nemesis.clj:225-238 expand-options)"""
    n = dict(n)
    if n.get("kill"):
        n["kill-tserver"] = n["kill-master"] = True
    if n.get("stop"):
        n["stop-tserver"] = n["stop-master"] = True
    if n.get("pause"):
        n["pause-tserver"] = n["pause-master"] = True
    if n.get("partition"):
        n["partition-one"] = n["partition-half"] = n["partition-ring"] = True
    return n


def _opt_mix(n: dict, possible: dict):
    gens = [g for opt, g in possible.items() if n.get(opt)]
    return gen.mix(gens) if gens else None


def mixed_generator(n: dict):
    """Flip-flops between each enabled fault family and its recovery,
    staggered by the interval.  (reference: nemesis.clj:155-191)"""
    def o(possible, recovery):
        m = _opt_mix(n, possible)
        return gen.flip_flop(m, gen.repeat(recovery)) if m else None

    modes = [
        o({"kill-tserver": lambda t, c: _op("kill-tserver"),
           "stop-tserver": lambda t, c: _op("stop-tserver")},
          _op("start-tserver")),
        o({"kill-master": lambda t, c: _op("kill-master"),
           "stop-master": lambda t, c: _op("stop-master")},
          _op("start-master")),
        o({"pause-tserver": lambda t, c: _op("pause-tserver")},
          _op("resume-tserver")),
        o({"pause-master": lambda t, c: _op("pause-master")},
          _op("resume-master")),
        o({"partition-one": partition_one_gen,
           "partition-half": partition_half_gen,
           "partition-ring": partition_ring_gen},
          _op("stop-partition")),
        _opt_mix(n, {"clock-skew": clock_gen()}),
    ]
    modes = [m for m in modes if m is not None]
    if not modes:
        return None
    return gen.stagger(n.get("interval", 10), gen.mix(modes))


def final_generator(n: dict):
    """Recover everything the enabled faults may have broken.
    (reference: nemesis.clj:193-209)"""
    fs = []
    if n.get("clock-skew"):
        fs.append("reset-clock")
    if n.get("pause-master"):
        fs.append("resume-master")
    if n.get("pause-tserver"):
        fs.append("resume-tserver")
    if n.get("kill-tserver") or n.get("stop-tserver"):
        fs.append("start-tserver")
    if n.get("kill-master") or n.get("stop-master"):
        fs.append("start-master")
    if any(n.get(k) for k in
           ("partition-one", "partition-half", "partition-ring")):
        fs.append("stop-partition")
    return [_op(f) for f in fs] or None


def full_generator(n: dict):
    """With :long-recovery, alternate 120 s fault windows with recovery
    + 60 s calm; else just the mixed faults.
    (reference: nemesis.clj:211-223 full-generator)"""
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
    consumes, from a fault-name list (e.g. ["kill-master",
    "partition-ring", "clock-skew"]) or shorthands ("kill", "stop",
    "pause", "partition").  (reference: nemesis.clj:240-247 nemesis)"""
    n = expand_options(
        {f: True for f in opts.get("faults", ())}
        | {"interval": opts.get("interval", 10),
           "long-recovery": bool(opts.get("long-recovery"))}
    )
    return {
        "nemesis": full_nemesis(db),
        "generator": full_generator(n),
        "final_generator": final_generator(n),
        "perf": {
            ("kill", frozenset({"kill-master", "kill-tserver",
                                "stop-master", "stop-tserver"}),
             frozenset({"start-master", "start-tserver"}), "#E9A4A0"),
            ("pause", frozenset({"pause-master", "pause-tserver"}),
             frozenset({"resume-master", "resume-tserver"}), "#A0B1E9"),
            ("partition", frozenset({"start-partition"}),
             frozenset({"stop-partition"}), "#A0E9DB"),
        },
    }


#: fault names this module understands; test() routes to this package
#: when any appears in opts["faults"] (recovery ops are not faults a
#: user requests, so they're excluded)
KNOWN_FAULTS = (
    PROCESS_FS
    | {
        "kill", "stop", "pause", "partition",
        "partition-one", "partition-half", "partition-ring", "clock-skew",
    }
) - {"start-master", "start-tserver", "resume-master", "resume-tserver"}
