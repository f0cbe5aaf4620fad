"""The incremental binary test file: ``test.jtpu``.

Same architecture as the reference's custom block format
(jepsen/src/jepsen/store/format.clj:1-200): a magic header pointing at
the most recent *index block*, then append-only CRC-framed blocks.
Partial writes survive crashes — the index is only repointed after its
block is durable, and stale blocks are simply unreferenced.

Layout (little-endian):

    "JTPU" | u32 version | u64 index-offset | block | block | …

Block frame: ``u64 length(incl. frame) | u32 crc32 | u16 type | data``.
CRC is over data, then the frame with the crc field zeroed.

Block types:

- INDEX (1): JSON ``{"root": id, "blocks": {id: offset}}``
- JSON (2): a JSON document; large values may be ``{"$block-ref": id}``
- PARTIAL_MAP (3): ``u32 rest-block-id | JSON map`` — a cons cell so the
  cheap keys (e.g. results["valid?"]) decode without the huge rest
- HISTORY (4): ``u32 json_len | history JSONL | packed tensor section``
  — the packed section is the device-ready int encoding (npz of the
  structured op arrays), so analysis reloads feed the accelerator with
  no re-parse.  This is the device-ready twist on the reference's lazy
  Fressian history block.

Byte-level writes go through the C++ writer (native/blockfile.cc, built
by :mod:`.native`) when it is available, else through the pure-Python
path here; both write the same bytes, so a file either package writes
loads in the other.  Reads verify CRCs in Python.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

from . import native

MAGIC = b"JTPU"
VERSION = 1
HEADER_SIZE = 4 + 4 + 8
FRAME_SIZE = 8 + 4 + 2

INDEX = 1
JSON_BLOCK = 2
PARTIAL_MAP = 3
HISTORY = 4
HISTORY_CHUNK = 5
CHUNKED_HISTORY = 6

BLOCK_TYPES = {INDEX: "index", JSON_BLOCK: "json", PARTIAL_MAP: "partial-map",
               HISTORY: "history", HISTORY_CHUNK: "history-chunk",
               CHUNKED_HISTORY: "chunked-history"}

#: ops per chunk when a history is large enough to split — the lazy-load
#: granularity (reference: store/format.clj's chunked BigVector history,
#: whose incremental loading is what makes multi-GB histories workable)
HISTORY_CHUNK_SIZE = 8192


def _frame(type_: int, data: bytes) -> bytes:
    frame_len = FRAME_SIZE + len(data)
    head = struct.pack("<QIH", frame_len, 0, type_)
    crc = zlib.crc32(head, zlib.crc32(data))
    return struct.pack("<QIH", frame_len, crc, type_) + data


def block_ref(block_id: int) -> dict:
    return {"$block-ref": block_id}


def is_block_ref(v: Any) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"$block-ref"}


def _dumps(obj: Any) -> bytes:
    return json.dumps(obj, default=repr).encode()


class Writer:
    """Append-only block writer over the native lib (or pure Python).

    Logical block ids are assigned sequentially from 1 (0 = nil
    sentinel, reference format.clj:95-97); save_index() appends an
    index block and atomically repoints the header at it.
    """

    def __init__(self, path: str):
        self.path = path
        self.blocks: Dict[int, int] = {}  # id -> offset
        self.next_id = 1
        self.root: int = 0
        self._native = None
        self._f = None
        lib = native.lib()
        if lib is not None:
            h = lib.bf_create(path.encode())
            if h:
                self._native = (lib, h)
        if self._native is None:
            self._f = open(path, "wb+")
            self._f.write(MAGIC + struct.pack("<IQ", VERSION, 0))
            self._f.flush()

    # -- low level ---------------------------------------------------------

    def _append(self, type_: int, data: bytes) -> int:
        """Append one framed block; returns its offset."""
        if self._native is not None:
            lib, h = self._native
            off = lib.bf_append_block(h, type_, data, len(data))
            if off == 0:
                raise IOError(f"native append failed at {self.path}")
            return off
        f = self._f
        f.seek(0, os.SEEK_END)
        off = f.tell()
        f.write(_frame(type_, data))
        return off

    def _set_index_offset(self, offset: int) -> None:
        if self._native is not None:
            lib, h = self._native
            if lib.bf_set_index_offset(h, offset) != 0:
                raise IOError(f"native index update failed at {self.path}")
            return
        f = self._f
        f.seek(8)
        f.write(struct.pack("<Q", offset))
        f.flush()

    # -- blocks ------------------------------------------------------------

    def write_block(self, type_: int, data: bytes) -> int:
        """Append a block; returns its logical id."""
        bid = self.next_id
        self.next_id += 1
        self.blocks[bid] = self._append(type_, data)
        return bid

    def write_json(self, obj: Any) -> int:
        return self.write_block(JSON_BLOCK, _dumps(obj))

    def write_partial_map(self, head: dict, rest_id: int = 0) -> int:
        data = struct.pack("<I", rest_id) + _dumps(head)
        return self.write_block(PARTIAL_MAP, data)

    def write_history(
        self,
        history,
        jsonl: Optional[bytes] = None,
        chunk_size: int = HISTORY_CHUNK_SIZE,
    ) -> int:
        """History block: JSONL + the packed device encoding.  Callers
        that already serialized the history (store.save_1 shares one
        pass with history.jsonl) pass the bytes in.

        Histories longer than ``chunk_size`` ops split into
        HISTORY_CHUNK blocks under one CHUNKED_HISTORY root, so readers
        can load (and iterate) them incrementally instead of decoding
        the whole run at once."""
        if jsonl is None:
            jsonl = "\n".join(
                json.dumps(op.to_dict(), default=repr) for op in history
            ).encode()
        else:
            # normalize caller-supplied bytes BEFORE either branch: blank
            # lines (trailing newline, interior gaps) would inflate the
            # chunk table's op counts AND the non-chunked
            # history_len()'s newline count, both of which readers treat
            # as authoritative
            lines = [ln for ln in jsonl.splitlines() if ln]
            if len(lines) != len(history):
                raise ValueError(
                    f"jsonl has {len(lines)} non-empty lines for "
                    f"{len(history)} ops — refusing to write a history "
                    "block with wrong op counts"
                )
            jsonl = b"\n".join(lines)
        if len(history) > chunk_size > 0:
            lines = jsonl.splitlines()
            chunks = []
            for i in range(0, len(lines), chunk_size):
                part = lines[i : i + chunk_size]
                cid = self.write_block(HISTORY_CHUNK, b"\n".join(part))
                chunks.append((cid, len(part)))
            packed = _pack_history(history)
            head = struct.pack("<I", len(chunks)) + b"".join(
                struct.pack("<II", cid, n) for cid, n in chunks
            )
            return self.write_block(CHUNKED_HISTORY, head + packed)
        packed = _pack_history(history)
        data = struct.pack("<I", len(jsonl)) + jsonl + packed
        return self.write_block(HISTORY, data)

    def set_root(self, block_id: int) -> None:
        self.root = block_id

    def save_index(self) -> None:
        """Append a fresh index block and commit it in the header."""
        payload = _dumps({"root": self.root, "blocks": self.blocks})
        off = self._append(INDEX, payload)
        self._set_index_offset(off)

    def flush(self) -> None:
        if self._native is not None:
            self._native[0].bf_flush(self._native[1])
        elif self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._native is not None:
            self._native[0].bf_close(self._native[1])
            self._native = None
        elif self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _pack_history(history) -> bytes:
    """The device-feed section: structured numpy arrays of the hot op
    fields (type/process/f/value codes + time), via np.savez."""
    import numpy as np

    from ..history import TYPE_CODES

    n = len(history)
    type_codes = np.zeros(n, dtype=np.int8)
    processes = np.zeros(n, dtype=np.int32)
    times = np.zeros(n, dtype=np.int64)
    f_ids = np.zeros(n, dtype=np.int32)
    value_ids = np.zeros(n, dtype=np.int32)
    f_table: Dict[Any, int] = {}
    value_table: Dict[Any, int] = {}

    def intern(table, v):
        key = repr(v)
        if key not in table:
            table[key] = len(table)
        return table[key]

    for i, op in enumerate(history):
        type_codes[i] = TYPE_CODES.get(op.type, 3)
        processes[i] = op.process if isinstance(op.process, int) else -1
        times[i] = op.time
        f_ids[i] = intern(f_table, op.f)
        value_ids[i] = intern(value_table, op.value)
    buf = io.BytesIO()
    np.savez(
        buf,
        type=type_codes,
        process=processes,
        time=times,
        f=f_ids,
        value=value_ids,
    )
    tables = _dumps({"f": list(f_table), "value": list(value_table)})
    npz = buf.getvalue()
    return struct.pack("<II", len(npz), len(tables)) + npz + tables


def scan_valid_prefix(path: str) -> Tuple[List[Tuple[int, int]], int]:
    """Forward-scan the block stream, returning ``([(offset, type), …],
    prefix_end)`` for the longest prefix of intact CRC-framed blocks.

    This is the torn-write recovery primitive (reference: the
    append-only design rationale of store/format.clj:1-120 — partial
    writes must survive crashes): a frame whose length field runs past
    EOF, whose bytes are truncated, or whose CRC fails ends the scan;
    everything before it is trustworthy."""
    size = os.path.getsize(path)
    frames: List[Tuple[int, int]] = []
    off = HEADER_SIZE
    with open(path, "rb") as f:
        while off + FRAME_SIZE <= size:
            f.seek(off)
            head = f.read(FRAME_SIZE)
            frame_len, want_crc, type_ = struct.unpack("<QIH", head)
            if frame_len < FRAME_SIZE or off + frame_len > size:
                break
            data = f.read(frame_len - FRAME_SIZE)
            if len(data) != frame_len - FRAME_SIZE:
                break
            zeroed = struct.pack("<QIH", frame_len, 0, type_)
            if zlib.crc32(zeroed, zlib.crc32(data)) != want_crc:
                break
            frames.append((off, type_))
            off += frame_len
    return frames, off


class Reader:
    """Lazy reader over a block file.

    With ``recover=True`` a file whose tail was torn off (crash mid
    write, disk full, truncated copy) is opened from its longest valid
    block prefix instead of raising: the newest intact index block wins;
    failing that, the id→offset map is rebuilt from append order (data
    block ids are assigned sequentially, index blocks carry no id) and
    the newest partial-map block whose reference chain fully resolves
    becomes the root.  ``reader.recovered`` reports that recovery ran
    and ``reader.valid_prefix_end`` where the intact prefix stops."""

    def __init__(self, path: str, recover: bool = False):
        self.path = path
        self.recovered = False
        self.valid_prefix_end: Optional[int] = None
        with open(path, "rb") as f:
            header = f.read(HEADER_SIZE)
        # Wrong-format errors are never recoverable-from: a different
        # magic or version must not be reinterpreted under v1 block
        # semantics by the recovery scan.
        if header[:4] != MAGIC:
            raise IOError(f"{path}: not a JTPU block file")
        if len(header) < HEADER_SIZE:
            if not recover:
                raise IOError(f"{path}: truncated header")
            self._recover()
            return
        version, index_off = struct.unpack("<IQ", header[4:])
        if version != VERSION:
            raise IOError(f"{path}: unsupported version {version}")
        try:
            if index_off == 0:
                raise IOError(
                    f"{path}: no committed index (crashed before save?)"
                )
            type_, data = self.read_block_at(index_off)
            if type_ != INDEX:
                raise IOError(f"{path}: index offset points at type {type_}")
            idx = json.loads(data)
            self.root = idx["root"]
            self.blocks = {int(k): v for k, v in idx["blocks"].items()}
        except Exception as e:
            if not recover:
                if isinstance(e, OSError):
                    raise
                raise IOError(f"{path}: corrupt index ({e!r})") from e
            self._recover()

    # -- torn-write recovery ----------------------------------------------

    def _recover(self) -> None:
        frames, prefix_end = scan_valid_prefix(self.path)
        self.recovered = True
        self.valid_prefix_end = prefix_end
        valid_offs = {off for off, _ in frames}
        # Newest intact index block first: it is the last committed
        # (or in-flight) view and its offsets are all behind it.
        for ioff in (off for off, t in reversed(frames) if t == INDEX):
            try:
                _, data = self.read_block_at(ioff)
                idx = json.loads(data)
                blocks = {
                    int(k): v
                    for k, v in idx["blocks"].items()
                    if v in valid_offs
                }
                root = idx.get("root", 0)
            except Exception:
                continue
            if root and root in blocks:
                self.root, self.blocks = root, blocks
                if self._root_resolves():
                    return
        # No usable index survived: data-block ids are append order
        # (write_block assigns sequentially; save_index appends the
        # index frame without consuming an id), so the map is implied
        # by the scan.  The newest partial-map whose chain resolves is
        # the best root — exactly the newest completed save phase.
        data_blocks = [(off, t) for off, t in frames if t != INDEX]
        self.blocks = {i + 1: off for i, (off, _t) in enumerate(data_blocks)}
        for bid in range(len(data_blocks), 0, -1):
            if data_blocks[bid - 1][1] != PARTIAL_MAP:
                continue
            self.root = bid
            if self._root_resolves():
                return
        raise IOError(
            f"{self.path}: no recoverable root in the valid block prefix "
            f"(0..{prefix_end})"
        )

    def _root_resolves(self) -> bool:
        """True when the candidate root decodes and every block ref in
        its top-level values points into the recovered block map — the
        recovered view must not hand out dangling references.  Membership
        is enough: every offset in ``self.blocks`` came from the CRC
        verified scan, so referenced blocks need not be re-decoded here
        (a multi-GB history stays lazy through recovery)."""
        try:
            out = self.root_value()
            if not isinstance(out, dict):
                return False
            return all(
                v["$block-ref"] in self.blocks
                for v in out.values()
                if is_block_ref(v)
            )
        except Exception:
            return False

    def read_block_at(self, offset: int, verify: bool = True) -> Tuple[int, bytes]:
        with open(self.path, "rb") as f:
            f.seek(offset)
            frame = f.read(FRAME_SIZE)
            if len(frame) < FRAME_SIZE:
                raise IOError(f"{self.path}: truncated frame at {offset}")
            frame_len, want_crc, type_ = struct.unpack("<QIH", frame)
            data = f.read(frame_len - FRAME_SIZE)
        if len(data) != frame_len - FRAME_SIZE:
            raise IOError(f"{self.path}: truncated block at {offset}")
        if verify:
            head = struct.pack("<QIH", frame_len, 0, type_)
            if zlib.crc32(head, zlib.crc32(data)) != want_crc:
                raise IOError(f"{self.path}: CRC mismatch at {offset}")
        return type_, data

    def read_id(self, block_id: int) -> Tuple[int, bytes]:
        return self.read_block_at(self.blocks[block_id])

    def read_value(self, block_id: int) -> Any:
        """Decode a block to its logical value, resolving partial maps."""
        type_, data = self.read_id(block_id)
        if type_ == JSON_BLOCK:
            return json.loads(data)
        if type_ == PARTIAL_MAP:
            (rest_id,) = struct.unpack("<I", data[:4])
            head = json.loads(data[4:])
            if rest_id:
                rest = self.read_value(rest_id)
                return {**rest, **head}
            return head
        if type_ in (HISTORY, CHUNKED_HISTORY):
            return self.read_history(block_id)
        raise IOError(f"cannot decode block type {type_}")

    def _chunk_table(self, data: bytes):
        """Parse a CHUNKED_HISTORY head: [(chunk-id, op-count)…], and
        the offset where the packed section starts."""
        (n,) = struct.unpack("<I", data[:4])
        chunks = [
            struct.unpack("<II", data[4 + 8 * i : 12 + 8 * i])
            for i in range(n)
        ]
        return chunks, 4 + 8 * n

    def history_len(self, block_id: int) -> int:
        """Op count without decoding any chunk."""
        type_, data = self.read_id(block_id)
        if type_ == CHUNKED_HISTORY:
            chunks, _ = self._chunk_table(data)
            return sum(n for _cid, n in chunks)
        if type_ == HISTORY:
            (jsonl_len,) = struct.unpack("<I", data[:4])
            return data[4 : 4 + jsonl_len].count(b"\n") + (
                1 if jsonl_len else 0
            )
        raise IOError(f"block {block_id} is {type_}, not history")

    def iter_history(self, block_id: int):
        """Yield Ops lazily, one chunk in memory at a time — the
        incremental path for multi-GB histories (reference:
        store/format.clj's chunked history loading)."""
        from ..history import Op

        type_, data = self.read_id(block_id)
        if type_ == CHUNKED_HISTORY:
            chunks, _ = self._chunk_table(data)
            del data
            for cid, _n in chunks:
                ctype, cdata = self.read_id(cid)
                if ctype != HISTORY_CHUNK:
                    raise IOError(f"chunk {cid} has type {ctype}")
                for line in cdata.decode().splitlines():
                    if line:
                        yield Op.from_dict(json.loads(line))
        elif type_ == HISTORY:
            (jsonl_len,) = struct.unpack("<I", data[:4])
            for line in data[4 : 4 + jsonl_len].decode().splitlines():
                if line:
                    yield Op.from_dict(json.loads(line))
        else:
            raise IOError(f"block {block_id} is {type_}, not history")

    def read_history(self, block_id: int):
        from ..history import History

        return History(self.iter_history(block_id))

    def read_packed_history(self, block_id: int) -> dict:
        """The device-feed arrays without touching the JSONL section."""
        import numpy as np

        type_, data = self.read_id(block_id)
        if type_ == CHUNKED_HISTORY:
            _chunks, off = self._chunk_table(data)
            rest = data[off:]
        elif type_ == HISTORY:
            (jsonl_len,) = struct.unpack("<I", data[:4])
            rest = data[4 + jsonl_len :]
        else:
            raise IOError(f"block {block_id} is {type_}, not history")
        npz_len, tables_len = struct.unpack("<II", rest[:8])
        npz = np.load(io.BytesIO(rest[8 : 8 + npz_len]))
        tables = json.loads(rest[8 + npz_len : 8 + npz_len + tables_len])
        return {
            "arrays": {k: npz[k] for k in npz.files},
            "tables": tables,
        }

    def root_value(self) -> Any:
        return self.read_value(self.root)
