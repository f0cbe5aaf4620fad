"""``python -m jepsen_tpu_torch.serve`` — run the resident checker daemon.

It runs on the current CUDA device and exits non-zero, with the probe's
error, when there is none; ``--device cpu`` runs the plain PyTorch
versions instead.  ``POST /shutdown`` drains the queue and exits 0.  The
daemon's other settings (row bound, request timeout, dispatch journal,
drift sentinel, WAL compaction) are arguments of
:func:`jepsen_tpu_torch.serve.daemon.serve`.
"""

from __future__ import annotations

import argparse
import sys


def _off(value: str):
    """None for a flag value that switches a file off."""
    return None if value.lower() in ("0", "false", "off", "no", "") \
        else value


def main(argv=None) -> int:
    from . import daemon, protocol

    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.serve",
        description="resident checker service: /check, /elle, /healthz, "
        "/status, /metrics, /trace, /profile, /shutdown")
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
                   "restarted daemon replays it into retried request ids")
    args = p.parse_args(argv)
    try:
        daemon.serve(
            host=args.host, port=args.port, device=args.device,
            window=args.window, max_queue_runs=args.max_queue,
            coalesce_wait_s=args.coalesce_wait, wal_path=_off(args.wal),
            block=True)
    except RuntimeError as e:
        print(f"python -m jepsen_tpu_torch.serve: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
