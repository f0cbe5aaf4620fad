"""Build the port's hand-written CUDA kernels at first use.

Each kernel source under ``ops/csrc/`` has a plain C entry point and is
compiled by ``nvcc`` into its own shared library under ``build/kernels/``
at the repository root, then loaded with :mod:`ctypes`.  The source does
not include PyTorch's headers, so a build takes seconds, not minutes.
Library names carry a hash of the source and the flags: an edited source
builds anew, and an unchanged one is reused within a checkout.

:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for all of them; :func:`load` builds (if needed) and opens one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: every kernel source of the port, by library name
SOURCES: Dict[str, Path] = {
    "dense_automaton": CSRC / "dense_automaton.cu",
    "frontier_search": CSRC / "frontier_search.cu",
    "cycles_closure": CSRC / "cycles_closure.cu",
    "verdict_stats": CSRC / "verdict_stats.cu",
}

#: sm_90a keeps Hopper-only instructions (wgmma, setmaxnreg) available;
#: -Xptxas=-v reports registers, shared memory and spills per kernel
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(
        src.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process each, all started together.  Returns per name
    ``{"path", "seconds", "ptxas"}`` (seconds 0.0 and no ptxas report for
    a library that was already built).  Raises with the compiler's
    output when any build fails; every started process is waited for."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    procs = {}
    failed = []
    t0 = time.perf_counter()
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                report[name] = {"path": str(out), "seconds": 0.0, "ptxas": ""}
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (out, tmp, subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        for name, (out, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, out)
            report[name] = {
                "path": str(out),
                "seconds": time.perf_counter() - t0,
                "ptxas": log.strip(),
            }
    finally:
        for _out, tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
