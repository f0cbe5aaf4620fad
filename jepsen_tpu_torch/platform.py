"""The accelerator probe — the port of :mod:`jepsen_tpu.platform`'s
probe half.

:func:`probe_accelerator` asks a fresh interpreter whether a CUDA device
is present AND executes: it imports ``torch``, allocates on ``cuda:0``,
runs one operation and synchronises.  A subprocess, because a wedged
driver can hang the first CUDA call, and a hung probe must not wedge the
caller.  The verdict is memoised process-wide under a lock
(:func:`forget_probe` drops it).

The reference's ``JEPSEN_TPU_PROBE_RETRIES``, ``_PROBE_TIMEOUT`` and
``_PROBE_TRAIL`` variables are the ``retries``, ``timeout_s`` and
``trail`` arguments here.

:func:`ensure_usable_backend` raises when the probe fails.  The
reference's ``force_cpu_platform`` fallback is not ported: the port never
moves a run to the CPU unless its caller asks for the CPU by name
(:mod:`.device`).
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import threading
import time
from typing import Optional, Tuple

#: the probe EXECUTES an operation, not just a device query: a driver
#: that lists the card but hangs at the first launch reports healthy to a
#: query while every dispatch blocks.  Exit 3 means "no CUDA device", a
#: clean answer that is not retried.
_PROBE_SRC = (
    "import sys, torch; "
    "sys.exit(3) if not (torch.cuda.is_available() "
    "and torch.cuda.device_count() > 0) else None; "
    "x = torch.ones((8, 8), device='cuda:0'); "
    "s = float((x + 1).sum().item()); "
    "torch.cuda.synchronize(); "
    "sys.exit(0 if s == 128.0 else 4)"
)

#: the exit code of a probe that found no CUDA device
NO_DEVICE_EXIT = 3

#: memoised probe verdict (None = not probed yet)
_accelerator_ok: Optional[bool] = None
_accelerator_error: Optional[str] = None
_probe_lock = threading.Lock()


def forget_probe() -> None:
    """Drop the memoised verdict so the next :func:`probe_accelerator`
    probes afresh (a process that waits for a card to come back asks
    every time)."""
    global _accelerator_ok, _accelerator_error
    with _probe_lock:
        _accelerator_ok, _accelerator_error = None, None


def probe_accelerator(retries: int = 3, timeout_s: float = 90.0,
                      backoff_s: float = 5.0,
                      trail: Optional[str] = None
                      ) -> Tuple[bool, Optional[str]]:
    """Probe, in a subprocess, whether a CUDA device initialises AND
    executes.  Returns ``(ok, error_message)``; memoised process-wide,
    and concurrent callers share one probe.

    A crash or a hang retries up to ``retries`` times, ``backoff_s`` ×
    the attempt apart; "no CUDA device" (exit 3) is deterministic and
    returns at once.  ``trail``, when given, is a JSONL file that gains
    one line per attempt."""
    global _accelerator_ok, _accelerator_error
    if _accelerator_ok is not None:  # written once, under the lock
        return _accelerator_ok, _accelerator_error
    with _probe_lock:
        if _accelerator_ok is not None:
            return _accelerator_ok, _accelerator_error
        err = None
        for attempt in range(max(1, int(retries))):
            t0 = time.time()
            try:
                r = subprocess.run(
                    [sys.executable, "-c", _PROBE_SRC],
                    timeout=timeout_s, capture_output=True, text=True,
                )
                if r.returncode == 0:
                    _trail(trail, attempt, "ok", time.time() - t0)
                    _accelerator_ok, _accelerator_error = True, None
                    return True, None
                if r.returncode == NO_DEVICE_EXIT:
                    _trail(trail, attempt, "no-accelerator",
                           time.time() - t0)
                    _accelerator_ok = False
                    _accelerator_error = "no CUDA device present"
                    return False, _accelerator_error
                tail = (r.stderr or "").strip().splitlines()
                err = tail[-1][:300] if tail else f"probe exit {r.returncode}"
            except subprocess.TimeoutExpired:
                err = f"CUDA init timed out after {timeout_s:g}s"
            except Exception as e:  # noqa: BLE001 — a probe never raises
                err = repr(e)[:300]
            _trail(trail, attempt, err, time.time() - t0)
            if attempt < retries - 1:
                time.sleep(backoff_s * (attempt + 1))
        _accelerator_ok, _accelerator_error = False, err or "probe never ran"
        return False, _accelerator_error


def _trail(path: Optional[str], attempt: int, outcome: str,
           elapsed_s: float) -> None:
    """Append one probe attempt to the JSONL trail at ``path`` (none when
    ``path`` is None): every attempt of a failed probe leaves evidence,
    not one terse error string."""
    if not path:
        return
    try:
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps({
                "ts": datetime.datetime.now(
                    datetime.timezone.utc).isoformat(timespec="seconds"),
                "attempt": attempt,
                "outcome": str(outcome)[:300],
                "elapsed_s": round(elapsed_s, 1),
                "pid": os.getpid(),
            }) + "\n")
    except OSError:
        pass


def accelerator_usable(timeout_s: float = 90.0) -> bool:
    """Boolean view of :func:`probe_accelerator`."""
    return probe_accelerator(timeout_s=timeout_s)[0]


def ensure_usable_backend(**probe_kw) -> None:
    """Raise unless :func:`probe_accelerator` (given ``probe_kw``) finds
    a CUDA device that executes.  Safe to call repeatedly: the verdict is
    memoised.  Unlike the reference, it never pins the CPU: a caller that
    wants the CPU passes ``device="cpu"`` to the entry point instead."""
    ok, err = probe_accelerator(**probe_kw)
    if not ok:
        raise RuntimeError(f"no usable CUDA device: {err}")
