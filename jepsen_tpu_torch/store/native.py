"""ctypes bindings for the C++ block-file writer (``native/blockfile.cc``)
— the port's copy of :mod:`jepsen_tpu.store.native`.

The library is compiled with ``g++`` at first use into ``build/native/``
at the repository root (git-ignored; never into ``native/``), under a
name that carries a hash of the source, so an edited source builds anew.
The build writes a temporary file and renames it, so processes that build
at once never load a half-written library.  Without a compiler or the
source, :func:`lib` returns None and the pure-Python path of
:mod:`.format` takes over: both write the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_REPO_ROOT = Path(__file__).resolve().parents[2]
SRC = _REPO_ROOT / "native" / "blockfile.cc"
BUILD_DIR = _REPO_ROOT / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")


def library_path() -> Path:
    """Where the library of the current source is built."""
    digest = hashlib.sha256(
        SRC.read_bytes() + "\0".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libblockfile-{digest}.so"


def _build() -> Optional[Path]:
    so = library_path()
    if so.exists():
        return so
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", *CXX_FLAGS, "-o", tmp, str(SRC)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return so
    except (OSError, subprocess.SubprocessError):
        return None


def lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if the
    toolchain or sources are unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not SRC.exists():
            return None
        so = _build()
        if so is None:
            return None
        try:
            l = ctypes.CDLL(str(so))
        except OSError:
            return None
        l.bf_create.restype = ctypes.c_void_p
        l.bf_create.argtypes = [ctypes.c_char_p]
        l.bf_open_append.restype = ctypes.c_void_p
        l.bf_open_append.argtypes = [ctypes.c_char_p]
        l.bf_append_block.restype = ctypes.c_uint64
        l.bf_append_block.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint16,
            ctypes.c_char_p,
            ctypes.c_uint64,
        ]
        l.bf_set_index_offset.restype = ctypes.c_int
        l.bf_set_index_offset.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        l.bf_tell.restype = ctypes.c_uint64
        l.bf_tell.argtypes = [ctypes.c_void_p]
        l.bf_flush.restype = ctypes.c_int
        l.bf_flush.argtypes = [ctypes.c_void_p]
        l.bf_close.restype = None
        l.bf_close.argtypes = [ctypes.c_void_p]
        l.bf_check_block.restype = ctypes.c_int64
        l.bf_check_block.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint16),
        ]
        _lib = l
        return _lib


def available() -> bool:
    return lib() is not None
