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

The second half is the resident service's verdict write-ahead log, in the
reference's v1 format (each package reads the other's files):
:class:`VerdictWAL` appends one row ``{v, ts, req, stream, idx, result}``
per settled slot, seals a torn tail before its first append and rewrites
itself crash-consistently in :meth:`VerdictWAL.compact`;
:func:`read_verdict_rows` / :func:`replay_index` read it back for a
restarted daemon, and :class:`WalTail` follows it incrementally.  Every
reader shares one damage-skip rule (:func:`_decode_line`): a half-written
line from a killed writer is skipped, never fatal.
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


def _decode_line(line, validate) -> tuple:
    """One JSONL line → ``(row, why)``: the validated dict or None, and
    ``"ok" | "blank" | "json" | "schema"`` — the one damage-skip rule of
    every reader here."""
    if isinstance(line, bytes):
        try:
            line = line.decode("utf-8")
        except UnicodeDecodeError:
            return None, "json"
    line = line.strip()
    if not line:
        return None, "blank"
    try:
        row = json.loads(line)
    except ValueError:
        return None, "json"
    if not validate(row):
        return None, "schema"
    return row, "ok"


def follow_rows(paths, validate, *,
                strict: bool = False) -> Iterator[tuple]:
    """Yield ``(offset, row)`` for every valid row across ``paths`` in
    order.  Offsets number valid rows from 0 (a damaged line consumes
    none); ``strict`` raises on the first damaged line instead."""
    offset = 0
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p, "r", encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                row, why = _decode_line(line, validate)
                if row is None:
                    if strict and why == "json":
                        raise ValueError(f"{p}:{lineno}: bad JSON")
                    if strict and why == "schema":
                        raise ValueError(f"{p}:{lineno}: schema violation")
                    continue
                yield offset, row
                offset += 1


def read_rows(path: str, *, strict: bool = False) -> Iterator[Dict[str, Any]]:
    """Yield valid rows from a journal path (rotated ``.1`` first).
    Damaged lines — a half-written tail from a crashed writer, a row of
    another schema — are skipped, or raise ValueError under ``strict``;
    blank lines are skipped either way."""
    for _offset, row in follow_rows((path + ".1", path), validate_row,
                                    strict=strict):
        yield row


# -- the verdict write-ahead log --------------------------------------------

WAL_SCHEMA_VERSION = 1
DEFAULT_WAL_FILENAME = "verdict-wal.jsonl"

#: required fields -> acceptable types: ``req`` is the client's request id,
#: ``stream`` the decomposition stream tag ("main"/"sub"), ``idx`` the slot
#: in that stream, ``result`` the settled verdict dict
_WAL_SCHEMA: Dict[str, tuple] = {
    "v": (int,),
    "ts": (int, float),
    "req": (str,),
    "stream": (str,),
    "idx": (int,),
    "result": (dict,),
}


def validate_verdict_row(row: Any) -> bool:
    """True iff ``row`` matches the verdict-WAL v1 schema exactly."""
    if not isinstance(row, dict) or row.get("v") != WAL_SCHEMA_VERSION:
        return False
    if set(row) != set(_WAL_SCHEMA):
        return False
    for key, types in _WAL_SCHEMA.items():
        if not isinstance(row[key], types):
            return False
        if types == (int,) and isinstance(row[key], bool):
            return False
    return True


class VerdictWAL:
    """Append-only log of settled verdicts, one JSONL row per (request,
    stream, slot).  A slot settles once, so replay is a plain union.
    Appends ride the page cache (a killed process loses nothing it has
    written); :meth:`compact` pays a temp file, an fsync, an atomic
    rename and a directory fsync."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        #: rows appended by this writer, and rows lost to write errors
        self.written = 0
        self.dropped = 0
        self._repair_tail()

    def _repair_tail(self) -> None:
        """Seal a torn tail left by a crash mid-append, so the first new
        row does not join the fragment and both get lost on read."""
        try:
            with open(self.path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() == 0:
                    return
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
        except OSError:
            pass  # no file yet: the first append creates it

    def append(self, req: str, stream: str, idx: int,
               result: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Append one settled verdict; returns the row, or None when it
        was dropped (a WAL failure never fails a check)."""
        row = {"v": WAL_SCHEMA_VERSION, "ts": time.time(), "req": req,
               "stream": stream, "idx": idx, "result": result}
        if not validate_verdict_row(row):
            with self._lock:
                self.dropped += 1
            return None
        line = json.dumps(row, sort_keys=True, default=str) + "\n"
        with self._lock:
            try:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
                self.written += 1
            except OSError:
                self.dropped += 1
                return None
        return row

    def sink_for(self, req: str):
        """A ``(stream, idx, result)`` settle sink bound to one request id
        (what ``DecomposedRun.attach_wal`` takes)."""
        def _sink(stream: str, idx: int, result: Dict[str, Any]) -> None:
            self.append(req, stream, idx, result)
        return _sink

    def compact(self, keep_reqs=None) -> int:
        """Rewrite the log keeping the rows whose ``req`` is in
        ``keep_reqs`` (None keeps all).  A crash at any point leaves the
        old file or the new one, never a torn one.  Returns rows kept."""
        with self._lock:
            rows = [r for r in read_verdict_rows(self.path)
                    if keep_reqs is None or r["req"] in keep_reqs]
            tmp = self.path + ".tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    for r in rows:
                        f.write(json.dumps(r, sort_keys=True) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
                _fsync_dir(self.path)
            except OSError:
                self.dropped += 1
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            return len(rows)


def read_verdict_rows(path: str) -> List[Dict[str, Any]]:
    """Every valid verdict row of a WAL, in file order (damaged lines,
    such as a killed writer's torn tail, are skipped)."""
    return [row for _offset, row in follow_rows((path,),
                                                validate_verdict_row)]


def replay_index(path: str) -> Dict[str, Dict[tuple, Dict[str, Any]]]:
    """WAL rows grouped for replay: ``{req: {(stream, idx): result}}``
    (a later row wins)."""
    index: Dict[str, Dict[tuple, Dict[str, Any]]] = {}
    for row in read_verdict_rows(path):
        index.setdefault(row["req"], {})[(row["stream"], row["idx"])] = \
            row["result"]
    return index


class WalTail:
    """Incremental follower of a verdict WAL: :meth:`poll` returns the
    ``(offset, row)`` pairs appended since the last poll, with
    :func:`follow_rows`'s offsets and damage rule.  A line still missing
    its newline waits for the next poll; a rewrite of the file (a
    compaction's rename, seen as a new inode or a shrink) restarts the
    follower at offset 0 of the new file.  ``start`` skips offsets already
    consumed."""

    def __init__(self, path: str, *, start: int = 0):
        self.path = path
        self._skip = max(0, int(start))
        self._pos = 0      # byte offset after the last complete line
        self._count = 0    # valid rows consumed (the next offset)
        self._sig = None   # (st_dev, st_ino) of the followed file

    def poll(self) -> List[tuple]:
        try:
            st = os.stat(self.path)
        except OSError:
            return []
        sig = (st.st_dev, st.st_ino)
        if self._sig is not None and (sig != self._sig
                                      or st.st_size < self._pos):
            self._pos = self._count = self._skip = 0
        self._sig = sig
        if st.st_size <= self._pos:
            return []
        out: List[tuple] = []
        try:
            with open(self.path, "rb") as f:
                f.seek(self._pos)
                while True:
                    line = f.readline()
                    if not line or not line.endswith(b"\n"):
                        break  # a torn tail: wait for its newline
                    self._pos = f.tell()
                    row, _why = _decode_line(line, validate_verdict_row)
                    if row is None:
                        continue
                    offset = self._count
                    self._count += 1
                    if offset >= self._skip:
                        out.append((offset, row))
        except OSError:
            pass
        return out


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
