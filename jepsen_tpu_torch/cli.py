"""Command-line runner: ``test`` / ``analyze`` — the port's copy of
:mod:`jepsen_tpu.cli`.

(reference: jepsen/src/jepsen/cli.clj — run! dispatcher:258, standard
test opt spec:64-111 incl. the "3n" concurrency convention:150-168,
single-test-cmd:355 providing both `test` and `analyze`:389-431,
exit codes:129-138)

Exit codes: 0 valid, 1 invalid, 2 unknown/errors, 254 usage error,
255 crash.

    python -m jepsen_tpu_torch.cli test --workload linearizable-register
    python -m jepsen_tpu_torch.cli test --workload linearizable-register \
        --device cpu --time-limit 3
    python -m jepsen_tpu_torch.cli analyze --test-name linearizable-register

The analysis runs on the current CUDA device unless ``--device cpu``
asks for the plain PyTorch versions; without CUDA and without
``--device cpu`` a run raises before it starts, never falling back to
the CPU.  ``--engine-window`` is the test map's ``engine-window``, which
the checkers pass to the engine; no environment variable is set.  The
reference's ``serve``, ``tune`` and ``test-all`` commands are not here:
the checker daemon and the tuner keep their own entry points (``python
-m jepsen_tpu_torch.serve``, ``python -m jepsen_tpu_torch.tune``), and
``--suite`` waits for the port of the DB suites.

A DB suite builds its CLI by passing its test-constructor to
:func:`single_test_cmd` and calling :func:`run_cli` with the command map.
"""

from __future__ import annotations

import argparse
import logging
import sys
import traceback
from typing import Any, Callable, Dict, List, Optional

EXIT_VALID = 0
EXIT_INVALID = 1
EXIT_UNKNOWN = 2
EXIT_USAGE = 254
EXIT_CRASH = 255

DEFAULT_NODES = ["n1", "n2", "n3", "n4", "n5"]


def parse_concurrency(s: str, node_count: int) -> int:
    """"30" → 30; "3n" → 3 × node count.  (reference: cli.clj:150-168)"""
    s = str(s).strip()
    if s.endswith("n"):
        return int(s[:-1] or 1) * node_count
    return int(s)


def _engine_window_arg(s: str) -> int:
    """--engine-window validator: ≥ 1 (1 IS the serial mode; a 0
    "disable" would otherwise be silently dropped by truthiness and
    run the default window instead — worse than an error)."""
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(
            "must be >= 1 (1 = strictly serial; pipelining has no "
            "setting below serial)"
        )
    return v


def parse_nodes(args: argparse.Namespace) -> List[str]:
    """--nodes a,b,c / repeated --node / --nodes-file, last wins per
    source precedence (file > node > nodes).  (reference: cli.clj:68-84)"""
    nodes: List[str] = list(DEFAULT_NODES)
    if getattr(args, "nodes", None):
        nodes = [n.strip() for n in args.nodes.split(",") if n.strip()]
    if getattr(args, "node", None):
        nodes = list(args.node)
    if getattr(args, "nodes_file", None):
        with open(args.nodes_file) as f:
            nodes = [line.strip() for line in f if line.strip()]
    return nodes


def add_test_opts(p: argparse.ArgumentParser) -> None:
    """The standard test option spec.  (reference: cli.clj:64-111)"""
    p.add_argument("--nodes", help="comma-separated node hostnames")
    p.add_argument("--node", action="append", help="node hostname (repeatable)")
    p.add_argument("--nodes-file", help="file with one node per line")
    p.add_argument(
        "--concurrency",
        default=None,
        help='number of workers, or "<k>n" for k × node count '
        "(default 1n, unless the workload needs more)",
    )
    p.add_argument(
        "--time-limit",
        type=float,
        default=60,
        help="run the workload this many seconds (default 60)",
    )
    p.add_argument(
        "--test-count",
        type=int,
        default=1,
        help="run the whole test suite this many times",
    )
    p.add_argument("--username", default="root", help="ssh username")
    p.add_argument("--password", help="ssh password")
    p.add_argument("--ssh-private-key", help="path to an ssh identity file")
    p.add_argument(
        "--dummy",
        action="store_true",
        help="use the no-IO dummy remote (in-process runs)",
    )
    p.add_argument(
        "--leave-db-running",
        action="store_true",
        help="don't tear the DB down after the test",
    )
    p.add_argument(
        "--logging-json", action="store_true", help="JSON-structured logs"
    )
    p.add_argument("--store-base", default="store", help="artifact directory")
    p.add_argument(
        "--tracing",
        help="per-client span tracing to this JSONL file (the "
        "reference's trace.py): not ported yet, so a run that asks for "
        "it fails naming it",
    )
    p.add_argument(
        "--no-obs",
        action="store_true",
        help="disable the run-wide observability layer (phase/op/engine "
        "spans + metrics, trace.json/metrics.prom store artifacts, the "
        "post-run breakdown table).  Default on.",
    )
    p.add_argument(
        "--mesh",
        dest="mesh_sharding",  # "mesh" is the test-map key for the
        action="store_true",   # built Mesh object itself
        help="explicitly shard the analysis batch over every CUDA "
        "device (parallel.mesh.Mesh on the history axis); single-device "
        "runs are unaffected.  The engine adopts such a mesh by itself "
        "whenever two or more CUDA devices are present.",
    )
    p.add_argument(
        "--profile",
        action="store_true",
        help="wrap the whole run in a torch.profiler capture window "
        "plus device memory sampling; the artifact lands in the store "
        "dir beside trace.json (profile/profile.json)",
    )
    p.add_argument(
        "--engine-window",
        type=_engine_window_arg,
        help="max in-flight device dispatches in the pipelined checker "
        "engine (jepsen_tpu_torch.engine).  1 = strictly serial "
        "dispatch-sync-dispatch (there is no value below serial, so 0 "
        "is rejected, not a disable switch); default: the calibration's "
        "or the engine's own.  Verdicts never depend on it.",
    )
    p.add_argument(
        "--device",
        help="where the analysis runs: a CUDA device (default: the "
        "current one) or 'cpu' for the plain PyTorch versions.  Without "
        "CUDA a run needs --device cpu; it never falls back by itself.",
    )


def test_opts_to_map(args: argparse.Namespace) -> dict:
    """Build the base test map from parsed standard options.
    (reference: cli.clj:245-254 test-opt-fn)"""
    nodes = parse_nodes(args)
    test = {
        "nodes": nodes,
        "time-limit": args.time_limit,
        "store-base": args.store_base,
        # CLI runs always persist (the reference's `lein run test`
        # writes store/<name>/<time>/ unconditionally); suite modules
        # default store? off only for library/in-process use
        "store?": True,
        "leave-db-running?": args.leave_db_running,
        "logging-json?": args.logging_json,
        "ssh": {
            "username": args.username,
            "password": args.password,
            "private-key-path": args.ssh_private_key,
        },
    }
    if args.concurrency is not None:
        test["concurrency"] = parse_concurrency(args.concurrency, len(nodes))
    if getattr(args, "tracing", None):
        test["tracing"] = args.tracing
    if getattr(args, "no_obs", False):
        test["obs?"] = False
    if getattr(args, "profile", False):
        test["profile?"] = True
    if getattr(args, "engine_window", None) is not None:
        # consumed by the linearizability checkers (checker.linearizable,
        # independent.batched_linearizable) on their way into
        # wgl.check_batch(window=...)
        test["engine-window"] = args.engine_window
    if getattr(args, "device", None) is not None:
        test["device"] = args.device
    if getattr(args, "mesh_sharding", False):
        # build lazily at analyze time: the checker seam
        # (batched_linearizable → check_batch(mesh=...)) only reads
        # test["mesh"] once histories exist
        def _mesh():
            from .parallel import mesh as mesh_mod

            if test.get("device") == "cpu":
                return None
            return mesh_mod.engine_default_mesh()

        test["mesh-fn"] = _mesh
    if args.dummy:
        from .control.core import DummyRemote

        test["remote"] = DummyRemote()
    return test


def _exit_code(results: dict) -> int:
    v = (results or {}).get("valid?")
    if v is True:
        return EXIT_VALID
    if v is False:
        return EXIT_INVALID
    return EXIT_UNKNOWN


def given_opts(args: argparse.Namespace) -> dict:
    """vars(args) minus the not-given options: argparse leaves those as
    None, and merging them verbatim into the test map would shadow the
    downstream setdefaults (e.g. core.run's concurrency = 1×nodes)."""
    return {k: v for k, v in vars(args).items() if v is not None}


def _run_profiled(test: dict) -> dict:
    """``--profile``: run the test inside one obs.profiling capture
    window (torch.profiler trace + device memory), then move the
    artifact into the store dir beside trace.json.  The store dir
    only exists once the run has a start-time, so the capture lands in
    a temp dir first."""
    import shutil
    import tempfile

    from . import core
    from .obs import profiling as obs_profiling

    box: dict = {}

    def _work():
        box["result"] = core.run(test)

    tmp = tempfile.mkdtemp(prefix="jepsen-tpu-profile-")
    try:
        obs_profiling.capture(tmp, label=str(test.get("name", "")),
                              work=_work, device=test.get("device"))
        result = box["result"]
        if result.get("store?", True) and result.get("start-time"):
            from . import store as store_mod

            dest = store_mod.path(result, "profile")
            shutil.rmtree(dest, ignore_errors=True)
            shutil.move(tmp, dest)
            tmp = None
            print(f"device profile → {dest}")
        return result
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def ensure_device(test: dict) -> None:
    """Raise unless the test's analysis device is usable: ``"cpu"``
    always is; any other device (None: the current CUDA device) needs
    CUDA, and the card must pass the CUDA probe (memoised per process)
    before the run starts — never a silent CPU run."""
    device = test.get("device")
    if device is not None and str(device) == "cpu":
        return
    from . import device as device_mod
    from .platform import ensure_usable_backend

    device_mod.resolve(device)  # raises without CUDA
    ensure_usable_backend()


def run_test(test: dict) -> int:
    """Run one prepared test map; returns its exit code."""
    from . import core

    # check the device ONCE, before the run and the checker's worker
    # threads exist: a test must not run for its time limit and then
    # find no card to check it on
    ensure_device(test)
    if test.get("profile?"):
        result = _run_profiled(test)
    else:
        result = core.run(test)
    summary = result.get("obs-summary")
    if summary:
        # phase/engine breakdown (doc/observability.md); the same dict
        # is durable under results.json → "obs"
        from . import obs

        print(obs.format_summary(summary))
    return _exit_code(result.get("results", {}))


def single_test_cmd(
    test_fn: Callable[[dict], dict],
    opt_fn: Optional[Callable[[argparse.ArgumentParser], None]] = None,
) -> Dict[str, dict]:
    """Commands for running/re-analyzing one test family:

    - ``test``: build the test from CLI opts via test_fn and run it
    - ``analyze``: re-run checkers over a stored history without
      re-running the test (analysis resume)

    (reference: cli.clj:355-431)"""

    def add_opts(p):
        add_test_opts(p)
        if opt_fn is not None:
            opt_fn(p)

    def run(args) -> int:
        worst = EXIT_VALID
        for _ in range(args.test_count):
            test = test_fn({**given_opts(args), **test_opts_to_map(args)})
            code = run_test(test)
            worst = max(worst, code)
            if code != EXIT_VALID:
                return code
        return worst

    def analyze(args) -> int:
        from . import checker as checker_mod
        from . import store as store_mod

        if args.test_name:
            # --test-name without --test-time means the test's most
            # recent run (reference: `lein run analyze` defaults to
            # the latest run the same way)
            start = args.test_time or store_mod.latest_time(
                args.store_base, args.test_name
            )
            stored = (
                store_mod.load(
                    {
                        "name": args.test_name,
                        "start-time": start,
                        "store-base": args.store_base,
                    }
                )
                if start is not None
                else None
            )
        else:
            stored = store_mod.latest(args.store_base)
        if stored is None:
            print("no stored test found", file=sys.stderr)
            return EXIT_USAGE
        if stored.get("recovered"):
            print(
                "note: test.jtpu was torn; analyzing the recovered "
                "valid prefix (the newest durable save phase)",
                file=sys.stderr,
            )
        # the command line decides where the analysis runs: the stored
        # map's device is where the run was checked then
        stored = {k: v for k, v in stored.items() if k != "device"}
        test = test_fn({**given_opts(args), **test_opts_to_map(args), **stored})
        ensure_device(test)
        results = checker_mod.check_safe(
            test["checker"], test, stored.get("history"), {})
        print_results = {
            k: v for k, v in results.items() if k != "history"
        }
        print(logging_safe_repr(print_results))
        return _exit_code(results)

    def add_analyze_opts(p):
        add_opts(p)
        p.add_argument("--test-name", help="stored test name")
        p.add_argument("--test-time", help="stored test start-time")

    return {
        "test": {
            "help": "run a test",
            "add_opts": add_opts,
            "run": run,
        },
        "analyze": {
            "help": "re-run the checker over a stored history",
            "add_opts": add_analyze_opts,
            "run": analyze,
        },
    }


def logging_safe_repr(obj: Any) -> str:
    import json

    return json.dumps(obj, indent=2, default=repr)


def run_cli(commands: Dict[str, dict], argv: Optional[List[str]] = None) -> int:
    """Parse argv against the command map and dispatch.
    (reference: cli.clj:258-334 run!)"""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s",
    )
    parser = argparse.ArgumentParser(
        prog="jepsen-tpu", description="TPU-native distributed-systems tester"
    )
    sub = parser.add_subparsers(dest="command")
    for name, spec in commands.items():
        p = sub.add_parser(name, help=spec.get("help"))
        spec.get("add_opts", lambda _p: None)(p)
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return EXIT_USAGE
    try:
        return commands[args.command]["run"](args)
    except SystemExit as e:
        return int(e.code or 0)
    except KeyboardInterrupt:
        return EXIT_CRASH
    except Exception:
        traceback.print_exc()
        return EXIT_CRASH


def default_commands() -> Dict[str, dict]:
    """The built-in command set: run a registered workload in-process
    against the in-memory fake client (dummy remote), or re-analyze a
    stored run.  (The reference's map also has ``--suite``, ``test-all``,
    ``serve`` and ``tune``.)"""

    def add_workload_opt(p):
        p.add_argument(
            "--workload",
            default=None,
            help="workload name (see jepsen_tpu_torch.workloads.names; "
            "default linearizable-register)",
        )
        p.add_argument(
            "--per-key-limit",
            type=int,
            default=32,
            help="ops per independent key before rotating to a fresh one",
        )
        p.add_argument(
            "-o",
            "--opt",
            action="append",
            default=[],
            metavar="KEY=VALUE",
            help="extra workload option (repeatable); ints parse as ints",
        )

    def make_test(opts: dict) -> dict:
        from . import core
        from . import generator as gen
        from . import workloads
        from .fake import KeyedAtomClient

        core.check_tracing(opts)
        opts = dict(opts)
        if "per_key_limit" in opts:
            opts.setdefault("per-key-limit", opts.pop("per_key_limit"))

        for kv in opts.pop("opt", []) or []:
            k, _, v = kv.partition("=")
            try:
                opts[k] = int(v)
            except ValueError:
                opts[k] = v

        opts.setdefault("workload", "linearizable-register")
        wl = workloads.workload(opts["workload"], opts)
        g = wl.get("generator")
        if opts.get("time-limit"):
            g = gen.time_limit(opts["time-limit"], g)
        test = {
            # strip stray callables from opts — except the lazy mesh
            # builder, which the checker seam resolves at analyze time
            **{k: v for k, v in opts.items()
               if not callable(v) or k == "mesh-fn"},
            # workload defaults flow into the test map — generators and
            # checkers read them from there; explicit opts still win
            **{k: v for k, v in wl.items()
               if k not in ("generator", "final-generator", "checker",
                            "concurrency") and k not in opts},
            "name": opts["workload"],
            # the keyed CAS-register fake: the one client the registered
            # workloads need (the reference picks per workload)
            "client": KeyedAtomClient(),
            "generator": g,
            "checker": wl.get("checker"),
        }
        # a workload that needs more workers than the 1n default says so
        # (e.g. linearizable-register's 2n-thread key groups); an
        # explicit --concurrency still wins
        if "concurrency" in wl and "concurrency" not in opts:
            test["concurrency"] = wl["concurrency"]
        return test

    return single_test_cmd(make_test, add_workload_opt)


def main(argv: Optional[List[str]] = None) -> None:
    sys.exit(run_cli(default_commands(), argv))


if __name__ == "__main__":
    main()
