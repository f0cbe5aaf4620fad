"""Shared scaffolding for the per-database test suites — the part of
:mod:`jepsen_tpu.suites.common` the port's suites use.

:func:`build_test` merges a suite's db, client and workload, with the
standard nemesis packages of ``opts["faults"]`` (or the suite's own) and
the perf checker's latency and rate plots, into a runnable test map (the
per-suite runner every reference suite ends with);
:func:`suite_nemesis_package` adds the generic packages to a suite's own
fault menu.

The reference's ``DaemonDB`` base and its generic set, counter and
register workloads serve the suites that are not ported yet.
"""

from __future__ import annotations

from typing import Any, List, Optional

from .. import checker as checker_mod
from .. import client as client_mod
from .. import db as db_mod
from .. import generator as gen
from ..nemesis import combined
from ..workloads import noop_test


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
