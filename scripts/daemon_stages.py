"""Where one checker daemon's start-up goes, stage by stage, on the card.

    python3 scripts/daemon_stages.py [--reps N] [--out PATH]

A daemon life (``python -m jepsen_tpu_torch.serve``) runs, in order: the
interpreter's start, the imports (torch and the package), the CUDA probe
(``platform.probe_accelerator``: a subprocess that initialises CUDA and
runs one operation), CUDA's initialisation in the daemon itself, the
resident :class:`~jepsen_tpu_torch.engine.execution.Executor`, and the
HTTP server up to its first ``/healthz``.

The script times those stages in a child process that takes the same
steps in the same order, with a timestamp at each boundary (the child's
``CheckerDaemon`` then finds the probe memoised and CUDA initialised, so
its own start is the executor and the server), and beside it the whole
life of real daemons, spawn to first ``/healthz``.  It prints one JSON
line per repetition and one ``summary`` line with the medians; with
``--out`` it appends them to that file as well.  It needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, sys, time
t = {"start": time.time()}
import torch
from jepsen_tpu_torch.serve import daemon as daemon_mod
from jepsen_tpu_torch.serve.client import ServiceClient
t["import"] = time.time()
from jepsen_tpu_torch import platform
ok, err = platform.probe_accelerator()
t["probe"] = time.time()
assert ok, err
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.zeros(1, device=dev)
torch.cuda.synchronize()
t["cuda"] = time.time()
from jepsen_tpu_torch.engine import execution
execution.Executor(None, device=dev)
t["executor"] = time.time()
d = daemon_mod.CheckerDaemon(port=0)
d.start(block=False)
assert ServiceClient(port=d.port).healthy(timeout=5.0)
t["healthz"] = time.time()
d.stop()
print(json.dumps(t))
"""

STAGES = ("python", "import", "probe", "cuda", "executor", "healthz")


def staged_life() -> dict:
    """One child process through the daemon's start-up stages."""
    t_spawn = time.time()
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-2000:])
    t = json.loads(out.stdout.strip().splitlines()[-1])
    marks = [t_spawn, t["start"], t["import"], t["probe"], t["cuda"],
             t["executor"], t["healthz"]]
    return {f"{name}_s": b - a
            for name, a, b in zip(STAGES, marks, marks[1:])}


def real_life() -> float:
    """Seconds from spawning ``python -m jepsen_tpu_torch.serve`` to its
    first ``/healthz``."""
    sys.path.insert(0, ROOT)
    from jepsen_tpu_torch.serve import client as client_mod

    t0 = time.perf_counter()
    client = client_mod.spawn_daemon(wait_s=300.0)
    seconds = time.perf_counter() - t0
    try:
        client.shutdown()
        client.spawned.wait(timeout=60)
    finally:
        if client.spawned.poll() is None:
            client_mod._reap(client.spawned)
    return seconds


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rows = []
    card = card_line()
    for rep in range(args.reps):
        row = {"rep": rep, **staged_life(), "real_life_s": real_life(),
               "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"summary": True, "reps": args.reps, "card": card}
    for key in rows[0]:
        if key.endswith("_s"):
            summary[key] = statistics.median(r[key] for r in rows)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
