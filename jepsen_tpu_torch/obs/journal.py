"""Dispatch journal: one JSONL line per Executor dispatch, size-rotated —
the dispatch-journal half of :mod:`jepsen_tpu.obs.journal`.

The in-memory metric histograms die with the process; this journal is
the durable per-dispatch stream: a caller configures a path, the
Executor emits one row per settled chunk, and
``tune.calibrate.journal_rows()`` reads the rows back as cost-table
evidence, and the drift sentinel (:mod:`.drift`) scores them.

Schema v1, byte-compatible with the reference's (``validate_row`` rejects
drift, so each package reads the other's files):

    v            schema version (1)
    ts           wall-clock seconds (time.time) at settle
    kernel       engine kernel name ("dense", "frontier", "cycles", ...)
    E, C, F      bucket shape: events, concurrency, frontier cap
    rows         histories in the chunk
    n_devices    mesh size at dispatch
    mesh_shape   mesh axis sizes, list
    window       dispatch-window depth
    compile_s    seconds when this dispatch compiled (first use), else 0
    execute_s    seconds when it ran warm, else 0
    coalesced    number of runs sharing the dispatch (1 = unshared)
    cache        "hit" | "miss"
    closure_mode closure mode of an Elle screen ("" when n/a)
    union        always "": the port has one dense union lowering
    calibration  active calibration id ("" when untuned)
    trace_id     comma-joined trace ids of the runs sharing it ("" if none)

Rotation: when the current file exceeds ``max_bytes`` the writer renames
it to ``<path>.1`` (replacing any previous ``.1``) and starts afresh —
bounded disk, and readers see at most two files.  The rename is followed
by a directory fsync so a crash right after rotation cannot lose the
directory entry.

The module-level journal (``configure``/``emit``/``path``) is a no-op
until configured, so library use never writes to the working directory.
The reference's verdict write-ahead log (``VerdictWAL``, ``WalTail``,
``replay_index``) belongs to the resident service and is not ported.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

SCHEMA_VERSION = 1
DEFAULT_MAX_BYTES = 8 * 1024 * 1024
DEFAULT_FILENAME = "dispatch-journal.jsonl"

#: required fields -> acceptable types (schema pin)
_SCHEMA: Dict[str, tuple] = {
    "v": (int,),
    "ts": (int, float),
    "kernel": (str,),
    "E": (int,),
    "C": (int,),
    "F": (int,),
    "rows": (int,),
    "n_devices": (int,),
    "mesh_shape": (list,),
    "window": (int,),
    "compile_s": (int, float),
    "execute_s": (int, float),
    "coalesced": (int,),
    "cache": (str,),
    "closure_mode": (str,),
    "union": (str,),
    "calibration": (str,),
    "trace_id": (str,),
}


def _fsync_dir(path: str) -> None:
    """fsync the directory containing ``path`` so a rename survives a
    crash; best-effort (some filesystems refuse directory fds)."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def validate_row(row: Any) -> bool:
    """True iff ``row`` matches the pinned v1 schema exactly."""
    if not isinstance(row, dict):
        return False
    if row.get("v") != SCHEMA_VERSION:
        return False
    if set(row) != set(_SCHEMA):
        # extras are drift too: v1 means exactly these fields
        return False
    for key, types in _SCHEMA.items():
        if not isinstance(row[key], types):
            return False
        if types == (int,) and isinstance(row[key], bool):
            # bool is an int subclass; reject it for int fields
            return False
    if row["cache"] not in ("hit", "miss"):
        return False
    return True


class DispatchJournal:
    """Thread-safe append-only JSONL writer with single-step rotation."""

    def __init__(self, path: str, max_bytes: int = DEFAULT_MAX_BYTES):
        self.path = path
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self.written = 0  #: rows appended by this writer
        self.dropped = 0  #: rows lost to validation or write errors

    def emit(self, **fields: Any) -> Optional[Dict[str, Any]]:
        """Append one row; fills ``v``/``ts``, validates, rotates.

        Returns the row dict on success, None when dropped — a journal
        failure never fails a dispatch."""
        row = dict(fields)
        row.setdefault("v", SCHEMA_VERSION)
        row.setdefault("ts", time.time())
        if not validate_row(row):
            with self._lock:
                self.dropped += 1
            return None
        line = json.dumps(row, sort_keys=True) + "\n"
        with self._lock:
            try:
                self._rotate_locked()
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
                self.written += 1
            except OSError:
                self.dropped += 1
                return None
        return row

    def _rotate_locked(self) -> None:
        try:
            if os.path.getsize(self.path) < self.max_bytes:
                return
        except OSError:
            return  # no file yet
        os.replace(self.path, self.path + ".1")
        # persist the rename's directory entry before any new-file write
        _fsync_dir(self.path)

    def files(self) -> List[str]:
        """Rotated-then-current paths that exist, oldest first."""
        return [p for p in (self.path + ".1", self.path)
                if os.path.exists(p)]


def read_rows(path: str, *, strict: bool = False) -> Iterator[Dict[str, Any]]:
    """Yield valid rows from a journal path (rotated ``.1`` first).
    Damaged lines — a half-written tail from a crashed writer, a row of
    another schema — are skipped, or raise ValueError under ``strict``;
    blank lines are skipped either way."""
    for p in (path + ".1", path):
        if not os.path.exists(p):
            continue
        with open(p, "r", encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    if strict:
                        raise ValueError(f"{p}:{lineno}: bad JSON")
                    continue
                if not validate_row(row):
                    if strict:
                        raise ValueError(f"{p}:{lineno}: schema violation")
                    continue
                yield row


# -- the process journal ----------------------------------------------------

_active: Optional[DispatchJournal] = None
_lock = threading.Lock()


def configure(path: Optional[str],
              max_bytes: int = DEFAULT_MAX_BYTES) -> Optional[DispatchJournal]:
    """Install (or with ``path=None`` remove) the process journal."""
    global _active
    with _lock:
        _active = DispatchJournal(path, max_bytes) if path else None
        return _active


def active() -> Optional[DispatchJournal]:
    # a snapshot of an atomic reference; readers tolerate either side of
    # a configure() swap
    return _active


def path() -> Optional[str]:
    j = _active
    return j.path if j else None


def emit(**fields: Any) -> Optional[Dict[str, Any]]:
    """Append to the process journal; a no-op when unconfigured."""
    j = _active
    if j is None:
        return None
    return j.emit(**fields)
