"""Command-line runner — the port's copy of :mod:`jepsen_tpu.cli`:
``test`` / ``analyze`` (in-process workloads, or a DB suite with
``--suite``), ``test-all`` (every in-process workload, or every workload
of ``--suite``), ``serve`` (the store's web UI, or with ``--checker`` the
checker daemon), the checker service's ``status`` / ``shutdown`` /
``route`` / ``top`` / ``profile``, and ``tune``.

(reference: jepsen/src/jepsen/cli.clj — run! dispatcher:258, standard
test opt spec:64-111 incl. the "3n" concurrency convention:150-168,
single-test-cmd:355 providing both `test` and `analyze`:389-431,
serve-cmd:336, exit codes:129-138)

Exit codes: 0 valid, 1 invalid, 2 unknown/errors, 254 usage error,
255 crash.

    python -m jepsen_tpu_torch.cli test --workload linearizable-register
    python -m jepsen_tpu_torch.cli test --workload linearizable-register \
        --device cpu --time-limit 3
    python -m jepsen_tpu_torch.cli test --suite localkv \
        --faults partition,kill --time-limit 10 --concurrency 6 --rate 40 \
        -o interval=2
    python -m jepsen_tpu_torch.cli analyze --test-name localkv
    python -m jepsen_tpu_torch.cli test --suite tidb \
        --nodes n1,n2,n3,n4,n5 --ssh-transport ssh --faults kill,partition
    python -m jepsen_tpu_torch.cli test-all --dummy --time-limit 5
    python -m jepsen_tpu_torch.cli serve --store-base store --port 8080
    python -m jepsen_tpu_torch.cli serve --checker --supervise --fleet 2 \
        --port 8519
    python -m jepsen_tpu_torch.cli status --port 8519 --daemon 127.0.0.1:8520

The analysis runs on the current CUDA device unless ``--device cpu``
asks for the plain PyTorch versions; without CUDA and without
``--device cpu`` a run raises before it starts, never falling back to
the CPU.  ``--engine-window`` is the test map's ``engine-window``, which
the checkers pass to the engine.  Flags stand in for the reference's
environment variables: the service commands' daemon is ``--host`` and
``--port`` (default ``127.0.0.1:8519``), the daemon's WAL is
``serve --wal``; no environment variable is read or set.  Each
in-process workload runs against the fake client whose semantics it
needs (the reference's table, ``jepsen_tpu/cli.py:1021-1033``).

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
        "--ssh-transport",
        choices=("ssh", "agent-ssh"),
        help="use a real SSH transport: 'ssh' (key-only, ControlMaster"
        " multiplexed) or 'agent-ssh' (sshj-style auth ladder: key,"
        " agent, default identities, password)",
    )
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
        help="enable span tracing and append each client call's span "
        "to this JSONL file (jepsen_tpu_torch.trace)",
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
    elif getattr(args, "ssh_transport", None) == "agent-ssh":
        from .control.agent_ssh import AgentSSHRemote

        test["remote"] = AgentSSHRemote.from_test(test)
    elif getattr(args, "ssh_transport", None) == "ssh":
        from .control.ssh import SSHRemote

        test["remote"] = SSHRemote.from_test(test)
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


def test_all_cmd(
    tests_fn: Callable[[dict], List[Callable[[], dict]]],
    opt_fn: Optional[Callable[[argparse.ArgumentParser], None]] = None,
) -> Dict[str, dict]:
    """Run every test a suite defines; worst exit code wins.
    ``tests_fn`` returns zero-arg BUILDERS, one per test, so a single
    test's construction error (like its run-time crash) folds into the
    worst-wins aggregate instead of aborting the whole sweep.
    (reference: cli.clj:491-519)"""

    def add_opts(p):
        add_test_opts(p)
        if opt_fn is not None:
            opt_fn(p)

    def run(args) -> int:
        worst = EXIT_VALID
        for _ in range(getattr(args, "test_count", 1) or 1):
            for build in tests_fn(
                {**given_opts(args), **test_opts_to_map(args)}
            ):
                try:
                    code = run_test(build())
                except Exception:  # noqa: BLE001 — one crash (building
                    # OR running) must not swallow the remaining tests'
                    # results; it folds into the worst-wins aggregate
                    # (reference: cli.clj test-all catches per-test
                    # throwables and continues)
                    traceback.print_exc()
                    code = EXIT_CRASH
                worst = max(worst, code)
        return worst

    return {"test-all": {"help": "run every defined test",
                         "add_opts": add_opts, "run": run}}


def _daemon_client(host: Optional[str], port: Optional[int], **kw):
    """A :class:`~jepsen_tpu_torch.serve.client.ServiceClient` of a daemon
    address given on the command line (``--host``/``--port``; the
    defaults are the daemon's, ``127.0.0.1:8519``)."""
    from .serve import ServiceClient, protocol

    return ServiceClient(host or protocol.DEFAULT_HOST,
                         protocol.DEFAULT_PORT if port is None else port,
                         **kw)


def _parse_addr(addr: str):
    """``HOST:PORT`` → ``(host or None, port)``; ValueError when the port
    is not an integer."""
    host, _, port = str(addr).rpartition(":")
    return host or None, int(port)


def serve_cmd() -> Dict[str, dict]:
    """``serve --checker`` (the resident checker daemon, optionally
    supervised, or a supervised fleet), ``status``/``shutdown`` of one or
    more daemons, ``route`` (the fleet's front), ``top`` (the live fleet
    view) and ``profile`` (a bounded profiling window on a daemon).
    (reference: cli.clj:336-354; jepsen_tpu/cli.py:410-862)

    Each command is thin over a ported part: :func:`..serve.daemon.serve`
    and :func:`~..serve.daemon.supervise`/:func:`~..serve.daemon.
    supervise_fleet` (through ``python -m jepsen_tpu_torch.serve``'s
    entry), :class:`~..serve.client.ServiceClient`'s ``status``,
    ``shutdown``, ``profile`` and ``watch``, and :class:`~..serve.router.
    Router`.  Flags replace the reference's environment variables.
    ``serve`` without ``--checker`` is the store's web UI (:mod:`.web`)
    over ``--store-base``, on ``--host``/``--port`` (default
    ``0.0.0.0:8080``); its checker-service panel shows the daemon at
    ``--service HOST:PORT`` (default ``127.0.0.1:8519``)."""

    def add_opts(p):
        p.add_argument("--host", default=None,
                       help="bind address (default 127.0.0.1)")
        p.add_argument("--port", "-b", type=int, default=None,
                       help="TCP port (default 8080 for the web UI, 8519 "
                       "for --checker; with --fleet N the members take "
                       "PORT … PORT+N-1)")
        p.add_argument("--store-base", default="store",
                       help="the store directory the web UI serves")
        p.add_argument("--service", default=None, metavar="HOST:PORT",
                       help="the checker daemon whose live panel the web "
                       "UI shows (default 127.0.0.1:8519)")
        p.add_argument(
            "--checker",
            action="store_true",
            help="serve the resident checker daemon (the card, its "
            "kernels and the oracle pool stay warm across runs) instead "
            "of the store web UI",
        )
        p.add_argument("--device", default=None,
                       help="(--checker) the daemon's device (default: the "
                       "current CUDA device, required to exist; 'cpu' runs "
                       "the plain versions)")
        p.add_argument(
            "--engine-window",
            type=_engine_window_arg,
            help="(--checker) the resident dispatch-window bound",
        )
        p.add_argument(
            "--max-queue",
            type=int,
            help="(--checker) queued client runs before /check "
            "answers 503 backlogged (default 32)",
        )
        p.add_argument("--wal", default=None,
                       help="(--checker) verdict write-ahead log path "
                       "(default off); a fleet's member i writes "
                       "ROOT-i.EXT")
        p.add_argument(
            "--supervise",
            action="store_true",
            help="(--checker) run the daemon as a supervised child "
            "and restart it on abnormal exit, on the same port and WAL",
        )
        p.add_argument(
            "--fleet",
            type=int,
            default=1,
            metavar="N",
            help="(--checker --supervise) run N daemons on ports "
            "PORT..PORT+N-1 with one WAL each; front them with "
            "`route`",
        )

    def run(args) -> int:
        if not args.checker:
            from . import web

            service = None
            if args.service:
                try:
                    service = _parse_addr(args.service)
                except ValueError:
                    print(f"serve: --service {args.service!r} is not "
                          "HOST:PORT", file=sys.stderr)
                    return EXIT_USAGE
                service = (service[0] or "127.0.0.1", service[1])
            web.serve(host=args.host or "0.0.0.0",
                      port=args.port if args.port is not None else 8080,
                      base=args.store_base, service=service)
            return EXIT_VALID
        if args.fleet > 1 and not args.supervise:
            print("--fleet requires --supervise", file=sys.stderr)
            return EXIT_USAGE
        from .serve import __main__ as serve_main

        argv: List[str] = []
        for flag, value in (("--host", args.host), ("--port", args.port),
                            ("--device", args.device),
                            ("--window", args.engine_window),
                            ("--max-queue", args.max_queue),
                            ("--wal", args.wal)):
            if value is not None:
                argv += [flag, str(value)]
        if args.supervise:
            argv.append("--supervise")
            if args.fleet > 1:
                argv += ["--fleet", str(args.fleet)]
        return serve_main.main(argv)

    def add_daemon_opts(p):
        p.add_argument("--host", default=None,
                       help="daemon host (default 127.0.0.1)")
        p.add_argument("--port", "-b", type=int, default=None,
                       help="daemon port (default 8519)")

    def add_fleet_daemon_opts(p):
        add_daemon_opts(p)
        p.add_argument(
            "--daemon",
            action="append",
            default=[],
            metavar="HOST:PORT",
            help="additional daemon address (repeatable) — address "
            "the whole fleet in one command, like `top`",
        )

    def fleet_clients(args, timeout=None):
        """The primary ``--host``/``--port`` client plus one per
        repeatable ``--daemon HOST:PORT``; ``None`` on a malformed
        address (after printing the usage error)."""
        clients = [_daemon_client(args.host, args.port, timeout=timeout)]
        for addr in getattr(args, "daemon", []):
            try:
                host, port = _parse_addr(addr)
            except ValueError:
                print(f"bad --daemon address {addr!r} (want HOST:PORT)",
                      file=sys.stderr)
                return None
            clients.append(_daemon_client(host, port, timeout=timeout))
        return clients

    def status(args) -> int:
        from .serve import ServiceError, ServiceUnavailable, client

        clients = fleet_clients(args)
        if clients is None:
            return EXIT_USAGE
        if len(clients) == 1:
            c = clients[0]
            try:
                print(client.format_status(c.status()))
            except ServiceUnavailable:
                print(
                    f"no checker service at http://{c.host}:{c.port}/ "
                    "(start one: serve --checker)",
                    file=sys.stderr,
                )
                return EXIT_UNKNOWN
            return EXIT_VALID
        rows, unreachable = [], 0
        for c in clients:
            try:
                rows.append((f"{c.host}:{c.port}", c.status()))
            except (ServiceError, ServiceUnavailable):
                rows.append((f"{c.host}:{c.port}", None))
                unreachable += 1
        print(client.format_fleet_status(rows))
        return EXIT_UNKNOWN if unreachable == len(clients) else EXIT_VALID

    def shutdown(args) -> int:
        from .serve import ServiceUnavailable

        clients = fleet_clients(args)
        if clients is None:
            return EXIT_USAGE
        unreachable = 0
        for c in clients:
            try:
                out = c.shutdown()
            except ServiceUnavailable:
                print(
                    f"no checker service at http://{c.host}:{c.port}/",
                    file=sys.stderr,
                )
                unreachable += 1
                continue
            print(
                f"checker service at {c.host}:{c.port} draining "
                f"({out.get('draining', 0)} queued runs), then stopping"
            )
        return EXIT_UNKNOWN if unreachable == len(clients) else EXIT_VALID

    def add_profile_opts(p):
        add_daemon_opts(p)
        p.add_argument(
            "--seconds", type=float, default=1.0,
            help="capture window length in seconds (clamped to 30)",
        )
        p.add_argument(
            "--label", default="",
            help="label recorded in the capture manifest (and the "
            "capture directory name)",
        )
        p.add_argument(
            "--dir", dest="out_dir", default=None,
            help="capture directory (default: a timestamped subdir of "
            "the daemon's profiles/ dir)",
        )

    def profile(args) -> int:
        from .serve import ServiceError, ServiceUnavailable

        c = _daemon_client(args.host, args.port)
        try:
            out = c.profile(seconds=args.seconds, label=args.label,
                            out_dir=args.out_dir)
        except ServiceUnavailable:
            print(
                f"no checker service at http://{c.host}:{c.port}/ "
                "(start one: serve --checker)",
                file=sys.stderr,
            )
            return EXIT_UNKNOWN
        except ServiceError as e:
            print(f"profile failed: {e}", file=sys.stderr)
            return EXIT_UNKNOWN
        man = out.get("manifest") or {}
        peaks = ", ".join(
            f"{d.get('device')} "
            + (f"{d['peak_bytes_in_use'] / 1e6:.1f}MB"
               if isinstance(d.get("peak_bytes_in_use"), (int, float))
               else "n/a")
            for d in (man.get("memory") or [])
        ) or "no devices"
        print(
            f"profile capture → {out.get('dir')}"
            f" ({man.get('wall_seconds', 0)}s, "
            + ("trace collected" if man.get("trace") else "no trace")
            + ")"
        )
        print(f"  device memory peak: {peaks}")
        return EXIT_VALID

    def add_route_opts(p):
        p.add_argument(
            "--member",
            action="append",
            required=True,
            metavar="HOST:PORT",
            help="fleet member daemon address (repeatable)",
        )
        p.add_argument("--host", default=None,
                       help="router bind host (default 127.0.0.1)")
        p.add_argument(
            "--port", "-b", type=int, default=None,
            help="router bind port (default 8519 — clients point at the "
            "router unchanged; 0 picks a free one)",
        )
        p.add_argument("--probe-interval", type=float, default=None,
                       metavar="S",
                       help="seconds between probes of every member's "
                       "/healthz and /status")

    def route(args) -> int:
        from .serve import protocol, router

        for m in args.member:
            try:
                _parse_addr(m)
            except ValueError:
                print(f"bad --member address {m!r} (want HOST:PORT)",
                      file=sys.stderr)
                return EXIT_USAGE
        kw = {}
        if args.probe_interval is not None:
            kw["probe_interval_s"] = args.probe_interval
        router.Router(
            args.member,
            host=args.host or protocol.DEFAULT_HOST,
            port=protocol.DEFAULT_PORT if args.port is None else args.port,
            **kw,
        ).start(block=True)
        return EXIT_VALID

    def add_top_opts(p):
        add_daemon_opts(p)
        p.add_argument(
            "--daemon",
            action="append",
            default=[],
            metavar="HOST:PORT",
            help="additional daemon address (repeatable) — one block "
            "per daemon in the fleet view",
        )
        p.add_argument(
            "--once",
            action="store_true",
            help="render a single frame and exit (scripts/CI)",
        )
        p.add_argument(
            "--interval",
            type=float,
            default=2.0,
            help="refresh period in seconds (default 2)",
        )

    def top(args) -> int:
        import time as time_mod

        from .serve import ServiceError, ServiceUnavailable, \
            client as client_mod

        clients = fleet_clients(args, timeout=2.0)
        if clients is None:
            return EXIT_USAGE

        def tail_verdicts(c, st, limit: int = 8) -> list:
            """Bounded tail of one daemon's verdict channel: replay
            only the last ``limit`` WAL rows via ``Last-Event-ID``,
            stop as soon as they've arrived (or the read times out)."""
            rows: list = []
            wal_rows = st.get("wal_rows") or 0
            if not wal_rows:
                return rows
            try:
                for off, row in c.watch(
                        last_id=max(-1, wal_rows - limit - 1),
                        timeout=1.0):
                    rows.append((f"{c.host}:{c.port}", off, row))
                    if off >= wal_rows - 1 or len(rows) >= limit:
                        break
            except (ServiceError, ServiceUnavailable, OSError):
                pass
            return rows

        def frame():
            """One rendered fleet frame + the per-address errors (an
            entry per daemon that did not answer /status)."""
            blocks, verdicts, errors = [], [], []
            for c in clients:
                try:
                    st = c.status()
                except (ServiceError, ServiceUnavailable) as e:
                    blocks.append(f"○ {c.host}:{c.port}  (unreachable)")
                    errors.append((f"{c.host}:{c.port}", str(e)))
                    continue
                blocks.append(client_mod.format_top(c.host, c.port, st))
                verdicts.extend(tail_verdicts(c, st))
            verdicts.sort(key=lambda e: (e[2].get("ts") or 0, e[1]))
            blocks.append(client_mod.format_verdicts(verdicts))
            return "\n".join(blocks), errors

        if args.once:
            text, errors = frame()
            print(text)
            if len(errors) == len(clients):
                # every daemon unreachable: a monitoring script must
                # see a nonzero exit, with the reason per address
                for addr, err in errors:
                    print(f"top: {addr}: {err}", file=sys.stderr)
                return EXIT_UNKNOWN
            return EXIT_VALID
        try:
            while True:
                # clear + home, then the frame: a refreshing view
                # without curses
                print("\\x1b[2J\\x1b[H" + frame()[0], flush=True)
                time_mod.sleep(max(0.1, args.interval))
        except KeyboardInterrupt:
            return EXIT_VALID

    return {
        "serve": {
            "help": "serve the store web UI, or the resident checker "
            "daemon (--checker)",
            "add_opts": add_opts,
            "run": run,
        },
        "status": {
            "help": "show the resident checker service's status "
            "(repeatable --daemon: one fleet table row per member)",
            "add_opts": add_fleet_daemon_opts,
            "run": status,
        },
        "shutdown": {
            "help": "drain and stop the resident checker service "
            "(repeatable --daemon: every addressed member)",
            "add_opts": add_fleet_daemon_opts,
            "run": shutdown,
        },
        "route": {
            "help": "run the fleet routing front: rendezvous-hash "
            "request shapes over --member daemons so same-shape "
            "traffic coalesces on one resident executor, with "
            "breaker-driven spillover",
            "add_opts": add_route_opts,
            "run": route,
        },
        "top": {
            "help": "live fleet view of one or more checker daemons "
            "(last-60s rates, queue wait, journal, drift, settled "
            "verdicts; --once for one frame, nonzero exit when no "
            "daemon answers)",
            "add_opts": add_top_opts,
            "run": top,
        },
        "profile": {
            "help": "capture a bounded torch.profiler window and the "
            "device memory peak on the resident checker daemon "
            "(POST /profile)",
            "add_opts": add_profile_opts,
            "run": profile,
        },
    }


def tune_cmd() -> Dict[str, dict]:
    """``tune``: the offline tune pass (``python -m jepsen_tpu_torch.tune``)
    — measure the attached device and persist a calibration artifact
    the engine loads at its first lookup."""

    def add_opts(p):
        p.add_argument(
            "--out",
            default=None,
            help="artifact path (default calibration.json in the working "
            "directory: the path the engine loads by default)",
        )
        p.add_argument(
            "--profile",
            default="default",
            help="sweep profile: 'default' (the full sweep) or 'smoke' "
            "(the tiny gate)",
        )
        p.add_argument(
            "--budget-s",
            type=float,
            default=None,
            help="wall-clock budget for the sweep; a truncated sweep "
            "still persists every config it measured",
        )
        p.add_argument(
            "--device",
            default=None,
            help="where to measure (default cuda; cpu runs the plain "
            "versions, for tests only)",
        )

    def run(args) -> int:
        from .tune import __main__ as tune_main

        argv = []
        if args.out:
            argv += ["--out", args.out]
        argv += ["--profile", args.profile]
        if args.budget_s is not None:
            argv += ["--budget-s", str(args.budget_s)]
        if args.device is not None:
            argv += ["--device", args.device]
        return tune_main.main(argv)

    return {
        "tune": {
            "help": "measure the attached device and persist a "
            "calibration artifact (the engine's dispatch knobs)",
            "add_opts": add_opts,
            "run": run,
        }
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
    against its fake client (dummy remote) or a DB suite (``--suite``),
    one run or every workload (``test-all``), re-analyze a stored run,
    the store's web UI, the checker service's commands and the tuner."""

    def add_workload_opt(p):
        p.add_argument(
            "--suite",
            help="DB suite to run against real nodes (see "
            "jepsen_tpu_torch.suites.SUITES: localkv, etcd, consul, "
            "zookeeper, raftis, disque, postgres-rds, stolon, cockroachdb, "
            "galera, percona, mysql-cluster, tidb, yugabyte, dgraph).  "
            "Without --suite, "
            "the workload runs in-process against the in-memory fake "
            "client.",
        )
        p.add_argument(
            "--workload",
            default=None,
            help="workload name (suite-specific with --suite; see "
            "jepsen_tpu_torch.workloads.names otherwise; default "
            "linearizable-register)",
        )
        p.add_argument(
            "--faults",
            help="comma-separated nemesis faults for --suite runs "
            "(partition,kill,pause,clock)",
        )
        p.add_argument(
            "--rate",
            type=float,
            help="target ops/sec for --suite runs",
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
            help="extra workload or suite option (repeatable), e.g. -o "
            "interval=2; ints parse as ints",
        )

    def make_test(opts: dict) -> dict:
        from . import fake as fake_mod
        from . import generator as gen
        from . import trace
        from . import workloads

        opts = dict(opts)
        if "per_key_limit" in opts:
            opts.setdefault("per-key-limit", opts.pop("per_key_limit"))

        for kv in opts.pop("opt", []) or []:
            k, _, v = kv.partition("=")
            try:
                opts[k] = int(v)
            except ValueError:
                opts[k] = v

        if opts.get("suite"):
            from . import suites

            if opts.get("faults"):
                opts["faults"] = [
                    f for f in str(opts["faults"]).split(",") if f
                ]
            else:
                opts["faults"] = []
            if not opts.get("workload"):
                opts.pop("workload", None)  # let the suite pick its default
            return suites.suite(opts["suite"]).test(opts)

        opts.setdefault("workload", "linearizable-register")
        wl = workloads.workload(opts["workload"], opts)
        g = wl.get("generator")
        if opts.get("time-limit"):
            g = gen.time_limit(opts["time-limit"], g)
        # per-workload fake client: the CAS-register fake fits the keyed
        # register probes, but bank needs transfer/balance semantics, the
        # txn probes a transactional store, adya-g2 insert-once rows and
        # the causal/sequential probes reads that return the SET of
        # observed writes (reference: jepsen_tpu/cli.py:1021-1033)
        fake_client = {
            "bank": fake_mod.BankAtomClient,
            "causal": fake_mod.CausalAtomClient,
            "causal-reverse": fake_mod.KeyedAtomSetClient,
            "long-fork": fake_mod.TxnAtomClient,
            "list-append": fake_mod.TxnAtomClient,
            "rw-register": fake_mod.TxnAtomClient,
            "adya-g2": fake_mod.InsertOnceAtomClient,
        }.get(opts["workload"], fake_mod.KeyedAtomClient)()
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
            "client": fake_client,
            "generator": g,
            "checker": wl.get("checker"),
        }
        # a workload that needs more workers than the 1n default says so
        # (e.g. linearizable-register's 2n-thread key groups); an
        # explicit --concurrency still wins
        if "concurrency" in wl and "concurrency" not in opts:
            test["concurrency"] = wl["concurrency"]
        return trace.wire(test, opts.get("tracing"))

    def make_tests(opts: dict) -> List[Callable[[], dict]]:
        """One test BUILDER per workload: every workload of --suite,
        or every in-process workload without one.  (reference:
        cli.clj:491-519 test-all-cmd)"""
        if opts.get("suite"):
            from . import suites

            names = sorted(
                suites.suite(opts["suite"]).workloads(
                    {k: v for k, v in opts.items() if k != "workload"}
                )
            )
        else:
            from . import workloads as workloads_mod

            names = workloads_mod.names()
        return [
            (lambda w=w: make_test({**opts, "workload": w}))
            for w in names
        ]

    cmds: Dict[str, dict] = {}
    cmds.update(single_test_cmd(make_test, add_workload_opt))
    cmds.update(test_all_cmd(make_tests, add_workload_opt))
    cmds.update(serve_cmd())
    cmds.update(tune_cmd())
    return cmds


def main(argv: Optional[List[str]] = None) -> None:
    sys.exit(run_cli(default_commands(), argv))


if __name__ == "__main__":
    main()
