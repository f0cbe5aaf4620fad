"""The accelerator probe — the port of :mod:`jepsen_tpu.platform`'s
probe half.

:func:`probe_accelerator` asks a fresh interpreter whether a CUDA device
is present AND executes: through ``libcuda`` alone (no ``torch``
import), it allocates on device 0, launches one kernel and synchronises.
A subprocess, because a wedged card can hang the first CUDA call, and a
hung probe must not wedge the caller.  The verdict is memoised
process-wide under a lock (:func:`forget_probe` drops it).

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
#: query while every dispatch blocks.  It speaks to CUDA's low-level API
#: (``libcuda``) through ctypes and imports nothing else: device 0's
#: primary context, an allocation, a memset, a kernel JIT-compiled from
#: the PTX below and launched on 64 threads, a synchronise and a copy
#: back, which must hold the memset's words plus one.  A fresh interpreter
#: that imported torch to do the same took 12 s of a daemon's 25 s start
#: on an H100 host (``scripts/daemon_stages.py``), most of it the import.
#: Exit 3 means "no CUDA device" (no ``libcuda``, CUDA_ERROR_NO_DEVICE
#: or no device counted), a clean answer that is not retried; exit 4 a
#: failed step, named on stderr.
_PROBE_PTX = r"""
.version 7.0
.target sm_50
.address_size 64
.visible .entry probe(.param .u64 words)
{
    .reg .b32 %r<4>;
    .reg .b64 %rd<5>;
    ld.param.u64 %rd1, [words];
    cvta.to.global.u64 %rd2, %rd1;
    mov.u32 %r1, %tid.x;
    mul.wide.u32 %rd3, %r1, 4;
    add.s64 %rd4, %rd2, %rd3;
    ld.global.u32 %r2, [%rd4];
    add.s32 %r3, %r2, 1;
    st.global.u32 [%rd4], %r3;
    ret;
}
"""

_PROBE_SRC = r"""
import ctypes, sys
from ctypes import POINTER, byref, c_char_p, c_int, c_size_t, c_uint, \
    c_uint32, c_uint64, c_void_p
try:
    cu = ctypes.CDLL("libcuda.so.1")
except OSError:
    sys.exit(3)
for name, args in (
        ("cuGetErrorName", [c_int, POINTER(c_char_p)]),
        ("cuInit", [c_uint]),
        ("cuDeviceGetCount", [POINTER(c_int)]),
        ("cuDeviceGet", [POINTER(c_int), c_int]),
        ("cuDevicePrimaryCtxRetain", [POINTER(c_void_p), c_int]),
        ("cuCtxSetCurrent", [c_void_p]),
        ("cuMemAlloc_v2", [POINTER(c_uint64), c_size_t]),
        ("cuMemsetD32_v2", [c_uint64, c_uint, c_size_t]),
        ("cuModuleLoadData", [POINTER(c_void_p), c_char_p]),
        ("cuModuleGetFunction", [POINTER(c_void_p), c_void_p, c_char_p]),
        ("cuLaunchKernel", [c_void_p, c_uint, c_uint, c_uint, c_uint, c_uint,
                            c_uint, c_uint, c_void_p, POINTER(c_void_p),
                            POINTER(c_void_p)]),
        ("cuCtxSynchronize", []),
        ("cuMemcpyDtoH_v2", [c_void_p, c_uint64, c_size_t]),
        ("cuMemFree_v2", [c_uint64])):
    fn = getattr(cu, name)
    fn.argtypes, fn.restype = args, c_int

def check(rc, what):
    if rc != 0:
        name = c_char_p()
        cu.cuGetErrorName(rc, byref(name))
        sys.stderr.write(f"{what}: {(name.value or b'?').decode()} ({rc})\n")
        sys.exit(4)

rc = cu.cuInit(0)
if rc == 100:  # CUDA_ERROR_NO_DEVICE
    sys.exit(3)
check(rc, "cuInit")
n = c_int(0)
check(cu.cuDeviceGetCount(byref(n)), "cuDeviceGetCount")
if n.value < 1:
    sys.exit(3)
dev, ctx = c_int(0), c_void_p()
check(cu.cuDeviceGet(byref(dev), 0), "cuDeviceGet")
check(cu.cuDevicePrimaryCtxRetain(byref(ctx), dev), "cuDevicePrimaryCtxRetain")
check(cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
words = c_uint64()
check(cu.cuMemAlloc_v2(byref(words), 256), "cuMemAlloc")
check(cu.cuMemsetD32_v2(words.value, 0x2A2A2A2A, 64), "cuMemsetD32")
module, fn = c_void_p(), c_void_p()
check(cu.cuModuleLoadData(byref(module), PTX), "cuModuleLoadData")
check(cu.cuModuleGetFunction(byref(fn), module, b"probe"),
      "cuModuleGetFunction")
params = (c_void_p * 1)(ctypes.cast(byref(words), c_void_p))
check(cu.cuLaunchKernel(fn, 1, 1, 1, 64, 1, 1, 0, None, params, None),
      "cuLaunchKernel")
check(cu.cuCtxSynchronize(), "cuCtxSynchronize")
out = (c_uint32 * 64)()
check(cu.cuMemcpyDtoH_v2(out, words.value, 256), "cuMemcpyDtoH")
check(cu.cuMemFree_v2(words.value), "cuMemFree")
sys.exit(0 if all(v == 0x2A2A2A2B for v in out) else 4)
""".replace("PTX", repr(_PROBE_PTX.encode()), 1)

#: the exit code of a probe that found no CUDA device
NO_DEVICE_EXIT = 3

#: memoised probe verdict (None = not probed yet)
_accelerator_ok: Optional[bool] = None
_accelerator_error: Optional[str] = None
_probe_lock = threading.Lock()
#: a first probe attempt started ahead of time by :func:`start_probe`
_early: Optional[subprocess.Popen] = None


def start_probe() -> None:
    """Start the first probe attempt now, in the background, so that it
    runs while the caller imports torch (a daemon's start spends most of
    its time there); :func:`probe_accelerator` takes its answer.  A no-op
    once a probe ran or started."""
    global _early
    with _probe_lock:
        if _accelerator_ok is None and _early is None:
            _early = subprocess.Popen(
                [sys.executable, "-c", _PROBE_SRC], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)


def _probe_once(timeout_s: float) -> Tuple[int, str]:
    """One probe attempt: ``(exit code, stderr)``; the early attempt's when
    :func:`start_probe` began one.  Raises ``subprocess.TimeoutExpired``
    after ``timeout_s``, the probe killed."""
    global _early
    proc, _early = _early, None
    if proc is None:
        r = subprocess.run([sys.executable, "-c", _PROBE_SRC],
                           timeout=timeout_s, capture_output=True, text=True)
        return r.returncode, r.stderr
    try:
        _out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    return proc.returncode, err


def forget_probe() -> None:
    """Drop the memoised verdict so the next :func:`probe_accelerator`
    probes afresh (a process that waits for a card to come back asks
    every time)."""
    global _accelerator_ok, _accelerator_error, _early
    with _probe_lock:
        _accelerator_ok, _accelerator_error = None, None
        if _early is not None:  # an early attempt nobody asked for
            _early.kill()
            _early.communicate()
            _early = None


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
                code, stderr = _probe_once(timeout_s)
                if code == 0:
                    _trail(trail, attempt, "ok", time.time() - t0)
                    _accelerator_ok, _accelerator_error = True, None
                    return True, None
                if code == NO_DEVICE_EXIT:
                    _trail(trail, attempt, "no-accelerator",
                           time.time() - t0)
                    _accelerator_ok = False
                    _accelerator_error = "no CUDA device present"
                    return False, _accelerator_error
                tail = (stderr or "").strip().splitlines()
                err = tail[-1][:300] if tail else f"probe exit {code}"
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
