"""``python -m jepsen_tpu_torch.serve`` — run the resident checker daemon.

It runs on the current CUDA device and exits non-zero, with the probe's
error, when there is none; ``--device cpu`` runs the plain PyTorch
versions instead.  ``POST /shutdown`` drains the queue and exits 0.  The
daemon's other settings (row bound, request timeout, dispatch journal,
drift sentinel) are arguments of
:func:`jepsen_tpu_torch.serve.daemon.serve`.

``--supervise`` runs the daemon as a child process and restarts it when
it dies abnormally; ``--supervise --fleet N`` runs N such daemons on
ports ``--port`` … ``--port + N - 1``, each with its own WAL
(``PATH-<i>``), all on the same ``--device``.  The supervising process
holds no device: only its children touch the card.  Put
``python -m jepsen_tpu_torch.serve.router`` in front of a fleet.
"""

from __future__ import annotations

import argparse
import sys


def _off(value: str):
    """None for a flag value that switches a file off."""
    return None if value.lower() in ("0", "false", "off", "no", "") \
        else value


def _card_bound(argv) -> bool:
    """Whether this command line runs a daemon on the card (no
    ``--supervise``, no ``--device cpu``)."""
    if "--supervise" in argv:
        return False
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            return argv[i + 1] != "cpu"
        if a.startswith("--device="):
            return a.split("=", 1)[1] != "cpu"
    return True


def main(argv=None) -> int:
    if _card_bound(list(sys.argv[1:] if argv is None else argv)):
        # the CUDA probe runs while torch imports (it imports nothing)
        from ..platform import start_probe

        start_probe()
    from . import daemon, protocol

    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.serve",
        description="resident checker service: /check, /elle, /feed, "
        "/watch, /healthz, /status, /metrics, /trace, /profile, /shutdown")
    p.add_argument("--host", default=protocol.DEFAULT_HOST,
                   help="bind address (default 127.0.0.1: the seam is "
                   "local)")
    p.add_argument("--port", type=int, default=protocol.DEFAULT_PORT,
                   help=f"TCP port (default {protocol.DEFAULT_PORT}; 0 "
                   "picks a free one)")
    p.add_argument("--device", default=None,
                   help="device to run on (default: the current CUDA "
                   "device, required to exist; 'cpu' runs the plain "
                   "versions)")
    p.add_argument("--window", type=int, default=None,
                   help="in-flight dispatch window (default: the "
                   "calibration's, else 4)")
    p.add_argument("--max-queue", type=int, default=None,
                   help="queued requests before /check answers 503 "
                   f"(default {daemon.DEFAULT_MAX_QUEUE_RUNS})")
    p.add_argument("--coalesce-wait", type=float, default=0.0,
                   help="seconds the device thread waits after a request "
                   "arrives for others to share its dispatches (default 0)")
    p.add_argument("--wal", default="off",
                   help="verdict write-ahead log path (default off): a "
                   "restarted daemon replays it into retried request ids "
                   "and feed sessions, and GET /watch tails it")
    p.add_argument("--wal-compact-bytes", type=int,
                   default=daemon.DEFAULT_WAL_COMPACT_BYTES, metavar="N",
                   help="compact the WAL on an idle turn once it passes N "
                   "bytes (default %(default)s; 0 never)")
    p.add_argument("--supervise", action="store_true",
                   help="run the daemon as a child process and restart it "
                   "when it dies abnormally")
    p.add_argument("--fleet", type=int, default=1, metavar="N",
                   help="with --supervise: N daemons on ports --port … "
                   "--port+N-1, one WAL each (PATH-<i>)")
    args = p.parse_args(argv)
    if args.fleet > 1 and not args.supervise:
        print("python -m jepsen_tpu_torch.serve: --fleet requires "
              "--supervise", file=sys.stderr)
        return 2
    if args.supervise:
        # the children get these arguments minus the supervisor's own
        raw = list(sys.argv[1:] if argv is None else argv)
        child = [a for a in daemon._with_flag(raw, "--fleet", None)
                 if a != "--supervise"]
        if args.fleet > 1:
            return daemon.supervise_fleet(args.fleet, child)
        return daemon.supervise(child)
    try:
        daemon.serve(
            host=args.host, port=args.port, device=args.device,
            window=args.window, max_queue_runs=args.max_queue,
            coalesce_wait_s=args.coalesce_wait, wal_path=_off(args.wal),
            wal_compact_bytes=args.wal_compact_bytes, block=True)
    except RuntimeError as e:
        print(f"python -m jepsen_tpu_torch.serve: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
