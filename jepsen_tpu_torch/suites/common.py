"""Shared scaffolding for the per-database test suites — the port's copy
of :mod:`jepsen_tpu.suites.common`.

Every reference suite repeats the same skeleton: a ``db/DB`` reification
that installs a tarball/deb, writes a config, and runs the server under
``start-daemon!``; a client over the DB's wire protocol; a workload
table; and a runner merging CLI opts into a test map (e.g.
consul/src/jepsen/consul/db.clj:23-95, tidb/src/tidb/db.clj,
doc/tutorial/02-db.md).  This module factors that skeleton once.

Suites provide:

- a :class:`DaemonDB` subclass (install/config/start hooks), and
- workload builders composed from :mod:`jepsen_tpu_torch.workloads` plus
  the generic set/counter/queue/register builders below, and
- :func:`build_test` merges it all into a runnable test map with the
  standard nemesis packages of ``opts["faults"]`` (or the suite's own,
  through :func:`suite_nemesis_package`) and the perf checker's latency
  and rate plots.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Optional

from .. import checker as checker_mod
from .. import client as client_mod
from .. import db as db_mod
from .. import generator as gen
from ..control import util as cu
from ..nemesis import combined
from ..workloads import noop_test


class DaemonDB(db_mod.DB, db_mod.Process, db_mod.Pause, db_mod.LogFiles):
    """A DB whose server runs as a single daemon per node.

    Subclasses set ``dir``, ``binary``, ``logfile``, ``pidfile`` and
    implement :meth:`install` and :meth:`start_args`; the base class
    wires setup/teardown/start/kill/pause/resume through the control
    DSL's daemon helpers, exactly as reference suites do with
    ``cu/start-daemon!``/``stop-daemon!``/``grepkill!``
    (jepsen/src/jepsen/control/util.clj:286-399).
    """

    dir: str = "/opt/db"
    binary: str = "db"
    logfile: str = "/opt/db/db.log"
    pidfile: str = "/opt/db/db.pid"

    def __init__(self, opts: Optional[dict] = None):
        self.opts = dict(opts or {})

    # -- hooks ---------------------------------------------------------
    def install(self, test: dict, node: Any) -> None:
        """Fetch + unpack the server onto the node."""
        raise NotImplementedError

    def configure(self, test: dict, node: Any) -> None:
        """Write config files (optional hook)."""

    def start_args(self, test: dict, node: Any) -> List[Any]:
        """argv tail after the binary."""
        return []

    def start_env(self, test: dict, node: Any) -> Dict[str, str]:
        return {}

    def await_ready(self, test: dict, node: Any) -> None:
        """Block until the server answers (optional hook)."""

    def wipe(self, test: dict, node: Any) -> None:
        """Remove data directories on teardown (optional hook)."""

    # -- DB ------------------------------------------------------------
    def setup(self, test: dict, node: Any) -> None:
        self.install(test, node)
        self.configure(test, node)
        self.start(test, node)
        self.await_ready(test, node)

    def teardown(self, test: dict, node: Any) -> None:
        cu.meh(lambda: self.kill(test, node))
        self.wipe(test, node)

    @property
    def proc_name(self) -> str:
        """Process comm name for killall/pkill — the binary's basename
        (``binary`` may be a path like ``bin/crate``)."""
        return os.path.basename(self.binary)

    # -- Process -------------------------------------------------------
    def start(self, test: dict, node: Any) -> None:
        cu.start_daemon(
            {
                "logfile": self.logfile,
                "pidfile": self.pidfile,
                "chdir": self.dir,
                "env": self.start_env(test, node),
            },
            f"{self.dir}/{self.binary}",
            *self.start_args(test, node),
        )

    def kill(self, test: dict, node: Any) -> None:
        cu.stop_daemon(pidfile=self.pidfile, cmd=self.proc_name)

    # -- Pause ---------------------------------------------------------
    def pause(self, test: dict, node: Any) -> None:
        cu.signal(self.proc_name, "STOP")

    def resume(self, test: dict, node: Any) -> None:
        cu.signal(self.proc_name, "CONT")

    # -- LogFiles ------------------------------------------------------
    def log_files(self, test: dict, node: Any) -> Iterable[str]:
        return [self.logfile]


# ---------------------------------------------------------------------
# Generic workloads shared by many suites
# ---------------------------------------------------------------------


def set_workload(opts: Optional[dict] = None) -> dict:
    """Unique-element set: clients add distinct integers, then a final
    read checks for lost/duplicated elements.  The shape every suite's
    "set"/"sets" workload follows (e.g. elasticsearch/src/jepsen/
    elasticsearch/sets.clj, yugabyte set.clj, tidb sets.clj).
    """
    opts = opts or {}
    counter = {"n": 0}

    def add(test, ctx):
        v = counter["n"]
        counter["n"] += 1
        return {"type": "invoke", "f": "add", "value": v}

    final = gen.clients(
        gen.each_thread(gen.once({"type": "invoke", "f": "read", "value": None}))
    )
    return {
        "generator": add,
        "final-generator": final,
        "checker": checker_mod.set_full(
            linearizable=bool(opts.get("linearizable?", False))
        ),
    }


def counter_workload(opts: Optional[dict] = None) -> dict:
    """Eventually-consistent counter: increments (and optionally
    decrements) mixed with reads, verified by the bounds-interval
    counter checker (reference: checker.clj:737-795; e.g.
    aerospike/src/aerospike/counter.clj, yugabyte counter.clj)."""
    opts = opts or {}

    def inc(test, ctx):
        return {"type": "invoke", "f": "add", "value": 1}

    def dec(test, ctx):
        return {"type": "invoke", "f": "add", "value": -1}

    def read(test, ctx):
        return {"type": "invoke", "f": "read", "value": None}

    mixed = [inc, read] if not opts.get("decrements?") else [inc, dec, read]
    return {
        "generator": gen.mix(mixed),
        "checker": checker_mod.counter(),
    }


def _queue_ops():
    """Unique-value enqueue + unknown-value dequeue op fns — the op
    shape both queue workloads share."""
    counter = {"n": 0}

    def enq(test, ctx):
        counter["n"] += 1
        return {"type": "invoke", "f": "enqueue", "value": counter["n"]}

    def deq(test, ctx):
        return {"type": "invoke", "f": "dequeue", "value": None}

    return enq, deq


def queue_workload(opts: Optional[dict] = None) -> dict:
    """Total-queue: enqueues/dequeues raced with faults, then every
    thread drains (reference: e.g. rabbitmq.clj queue workload +
    checker.clj:628 total-queue).  Shared by the rabbitmq, disque, and
    hazelcast suites."""
    enq, deq = _queue_ops()
    final = gen.clients(
        gen.each_thread(gen.once({"type": "invoke", "f": "drain",
                                  "value": None}))
    )
    return {
        "generator": gen.mix([enq, deq]),
        "final-generator": final,
        "checker": checker_mod.total_queue(),
    }


def linearizable_queue_workload(opts: Optional[dict] = None) -> dict:
    """Queue ops checked for full linearizability against the
    unordered-queue model (the knossos model the reference's checker
    consumes, jepsen/src/jepsen/checker.clj:19-26,218-239).  Unique
    elements keep the history inside the queue's direct checker
    (``check_batch`` routes the model there, as the reference does);
    total-queue (queue_workload) remains the O(n) default for unbounded
    runs.  The check runs where ``opts["device"]`` says."""
    from .. import models

    opts = opts or {}
    enq, deq = _queue_ops()
    g = gen.mix([enq, deq])
    limit = opts.get("op-limit", opts.get("per-key-limit", 40))
    if limit:
        g = gen.limit(int(limit), g)
    return {
        "generator": g,
        "checker": checker_mod.linearizable(
            models.unordered_queue(), pure_fs=(), device=opts.get("device")
        ),
    }


class UnreadOkSetChecker(checker_mod.Checker):
    """The per-key set checker, except a key whose final read was never
    even *invoked* (the time limit cut the key's schedule before its
    read phase) is vacuously valid with a marker instead of poisoning
    the whole run with "unknown".  A key whose reads were invoked but
    all FAILED keeps its unknown verdict — that's real evidence of an
    unreachable key, not a scheduling artifact."""

    def __init__(self):
        self.inner = checker_mod.set_checker()

    def check(self, test, history, opts=None):
        out = self.inner.check(test, history, opts)
        if out.get("valid?") == "unknown":
            read_invoked = any(op.f == "read" for op in history)
            if not read_invoked:
                return {"valid?": True, "unread?": True}
        return out


def unread_ok_set_checker() -> checker_mod.Checker:
    return UnreadOkSetChecker()


def independent_set_workload(opts: Optional[dict] = None) -> dict:
    """Per-key unique adds then a final read per thread, lifted over
    independent keys with the unread-tolerant set checker — the shape
    crate's lost-updates and aerospike's set share (reference:
    crate/lost_updates.clj:106-160, aerospike/set.clj:43-66)."""
    opts = dict(opts or {})
    n = max(1, len(opts.get("nodes", ["n1"])))
    counter = {"n": 0}

    def fgen(k):
        def add(test, ctx):
            counter["n"] += 1
            return {"type": "invoke", "f": "add", "value": counter["n"]}

        return gen.phases(
            gen.limit(
                int(opts.get("per-key-limit", 20)),
                gen.stagger(1 / 50, add),
            ),
            gen.each_thread(
                gen.once({"type": "invoke", "f": "read", "value": None})
            ),
        )

    from .. import independent

    return {
        "generator": independent.concurrent_generator(
            2 * n, range(100_000), fgen
        ),
        "checker": independent.checker(unread_ok_set_checker()),
        "concurrency": 2 * n,
    }


def register_workload(opts: Optional[dict] = None) -> dict:
    """Per-key linearizable CAS registers (the flagship workload);
    delegates to workloads.linearizable_register, which checks on
    ``opts["device"]``.  Declares the 2n concurrency its per-key thread
    groups need (reference: linearizable_register.clj:40-43)."""
    from ..workloads import linearizable_register

    return linearizable_register.test(opts or {})


def generic_workload(name: str, opts: Optional[dict] = None) -> dict:
    """Look up a workload by name across the generic + core tables."""
    from .. import workloads as w

    opts = opts or {}
    table = {
        "set": set_workload,
        "counter": counter_workload,
        "register": register_workload,
        "linearizable-register": register_workload,
    }
    if name in table:
        return table[name](opts)
    return w.workload(name, opts)




def suite_nemesis_package(
    opts: dict, db, suite_pkg: dict, known: set
) -> dict:
    """Combine a suite's own fault menu with the generic packages for
    any requested faults the menu doesn't cover.  Silently dropping the
    leftovers would report results for fault scenarios never exercised;
    if the two packages' op namespaces collide, this raises instead.
    """
    faults = set(opts.get("faults", ()))
    claimed = faults & known
    if opts.get("partition-targets") and claimed & {
        "partition", "partition-one", "partition-half", "partition-ring"
    }:
        raise ValueError(
            "partition-targets is not supported by this suite's fault "
            "menu; use the generic partition fault without the suite's "
            "partition names"
        )
    leftover = sorted(faults - known)
    if not leftover:
        return suite_pkg
    rest_opts = {
        **{k: v for k, v in opts.items() if k != "faults"},
        "db": db,
        "faults": leftover,
        "interval": opts.get("interval", combined.DEFAULT_INTERVAL),
    }
    if opts.get("partition-targets"):
        # same translation build_test's default path performs —
        # combined.partition_package reads opts["partition"]["targets"]
        rest_opts["partition"] = {"targets": opts["partition-targets"]}
    rest = combined.nemesis_package(rest_opts, only_active=True)
    try:
        return combined.compose_packages([suite_pkg, rest])
    except ValueError as e:
        raise ValueError(
            f"faults {leftover} cannot run alongside this suite's fault "
            f"menu ({sorted(claimed)}): {e}"
        ) from e


def build_test(
    name: str,
    opts: Optional[dict],
    *,
    db: db_mod.DB,
    client: client_mod.Client,
    workload: dict,
    nemesis_package: Optional[dict] = None,
) -> dict:
    """Merge a suite's db + client + workload (+ standard nemesis
    packages from opts["faults"]) into a full runnable test map — the
    per-suite runner every reference suite ends with (e.g.
    cockroachdb/src/jepsen/cockroach/runner.clj,
    yugabyte/src/yugabyte/runner.clj).

    opts keys honoured: nodes, time-limit, concurrency, faults (list of
    fault keywords for nemesis/combined), interval, rate.
    """
    opts = dict(opts or {})
    test = noop_test()
    test.update(
        {
            "name": name,
            "db": db,
            "client": client,
            "store?": opts.get("store?", False),
        }
    )
    # standard harness opts must flow through, or suite runs lose their
    # store location / logging flags (the CLI merges these into opts;
    # reference: cli.clj test-opt-fn feeding every suite's test map)
    for k in ("store-base", "leave-db-running?", "logging-json?", "ssh",
              "remote", "time-limit", "mesh", "mesh-fn",
              # where the analysis runs and how (the port's flags; the
              # reference's run_test read these from the environment)
              "device", "engine-window", "obs?", "profile?",
              # persisted so `analyze` can rebuild THIS suite's checker
              # from the stored map (without them a resumed analysis
              # would silently run the default workload's checker over
              # a foreign history; reference: cli.clj:402-431 analyze
              # re-invokes the same test-fn with the stored opts)
              "suite", "workload"):
        if k in opts:
            test[k] = opts[k]
    if "nodes" in opts:
        test["nodes"] = list(opts["nodes"])
    test.update({k: v for k, v in workload.items() if k not in ("generator", "final-generator", "checker")})
    if opts.get("concurrency") is not None:
        test["concurrency"] = opts["concurrency"]

    checker = workload.get("checker") or checker_mod.unbridled_optimism()
    test["checker"] = checker_mod.compose(
        {
            "workload": checker,
            "stats": checker_mod.stats(),
            "exceptions": checker_mod.unhandled_exceptions(),
            # latency/rate SVGs with fault-window shading — the
            # reference's runners compose (checker/perf) into every
            # run (e.g. cockroach/runner.clj, galera dirty_reads.clj
            # :117-120)
            "perf": checker_mod.perf_checker(),
        }
    )

    # Nemesis package from fault spec (reference: nemesis/combined.clj:328);
    # suites with their own fault menus (e.g. yugabyte's master/tserver
    # targeting) pass a pre-built package instead
    if nemesis_package is not None:
        pkg = nemesis_package
    else:
        pkg_opts = {
            "db": db,
            "faults": opts.get("faults", []),
            "interval": opts.get("interval", combined.DEFAULT_INTERVAL),
        }
        if opts.get("partition-targets"):
            pkg_opts["partition"] = {"targets": opts["partition-targets"]}
        pkg = combined.nemesis_package(pkg_opts)
    test["nemesis"] = pkg.get("nemesis") or test["nemesis"]

    # Fault-window shading for the latency/rate plots: the package's
    # perf entries (name, start-fs, stop-fs, color) become the plot
    # specs checker.perf.nemesis_regions consumes (reference:
    # nemesis/combined.clj perf sets feeding checker/perf.clj:240-283)
    perf_specs = [
        {"name": n, "start": tuple(starts), "stop": tuple(stops),
         "color": color}
        for (n, starts, stops, color) in sorted(
            pkg.get("perf") or (), key=lambda e: str(e[0])
        )
    ]
    if perf_specs:
        test.setdefault("plot", {})["nemeses"] = perf_specs

    # Generator: rate-staggered client ops raced with the nemesis
    # schedule, bounded by time-limit, then nemesis final + workload
    # final reads (reference runner shape: e.g. tidb/src/tidb/run.clj).
    body = gen.clients(workload.get("generator"))
    rate = opts.get("rate")
    if rate:
        body = gen.stagger(1.0 / rate, body)
    if pkg.get("generator") is not None:
        body = gen.any(body, gen.nemesis(pkg["generator"]))
    body = gen.time_limit(opts.get("time-limit", 60), body)

    parts: List[Any] = [body]
    if pkg.get("final_generator"):
        parts.append(gen.nemesis(pkg["final_generator"]))
    if workload.get("final-generator") is not None:
        parts.append(workload["final-generator"])
    test["generator"] = gen.phases(*parts) if len(parts) > 1 else body

    # --tracing ENDPOINT: span every client call, exported to the
    # endpoint (a JSONL spans file; reference: dgraph/core.clj:118,175
    # builds its tracer from the --tracing URL and client.clj wraps
    # each client call in a span)
    from .. import trace

    return trace.wire(test, opts.get("tracing"))
