"""Test persistence: directory layout, 3-phase save, logging, symlinks —
the port's copy of :mod:`jepsen_tpu.store`.

Tests save in three phases so crashes lose as little as possible
(reference: jepsen/src/jepsen/store.clj:404-456, called from
core.clj:386,402,236):

- :func:`save_0` — at test start: the initial test map
- :func:`save_1` — after the run: the history is durable (binary block
  + history.txt + history.jsonl), symlinks update
- :func:`save_2` — after analysis: results (valid? split out for cheap
  reads) + the final test map

Artifacts live in ``<base>/<name>/<start-time>/``: ``test.jtpu`` (the
incremental block file, :mod:`.format`), ``history.txt``,
``history.jsonl``, ``results.json``, ``jepsen.log``, plus whatever
checkers write.  ``latest``/``current`` symlinks mirror the reference
(store.clj:344-358).  The checkers' per-key artifacts land under the same
directory (:func:`path_`).  Both packages write the same block format,
so either one loads the other's ``test.jtpu``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from ..util import real_pmap

BASE = "store"

#: Test-map keys holding live objects that cannot serialize.
#: (reference: store.clj:91-99)
DEFAULT_NONSERIALIZABLE_KEYS = {
    "barrier", "db", "os", "net", "client", "checker", "nemesis",
    "generator", "model", "remote", "mesh", "mesh-fn", "writer",
    # the port's online-checking client (interpreter._make_shipper)
    "live-client",
}


def base_dir(test: dict) -> str:
    return test.get("store-base", BASE)


def test_dir(test: dict) -> str:
    """store/<name>/<start-time> for this test run."""
    name = test.get("name", "noname")
    start = str(test.get("start-time", "unknown"))
    return os.path.join(base_dir(test), name, start)


def path(test: dict, *components: Any) -> str:
    """Path to an artifact within the test's store directory.
    (reference: store.clj:40-56)"""
    parts = [str(c) for c in components if c is not None and str(c) != ""]
    return os.path.join(test_dir(test), *parts)


def path_(test: dict, *components: Any) -> str:
    """Like path, but ensures the parent directory exists.
    (reference: store.clj `path!`)"""
    p = path(test, *components)
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    return p


def nonserializable_keys(test: dict) -> set:
    """(reference: store.clj:96-100)"""
    return DEFAULT_NONSERIALIZABLE_KEYS | set(
        test.get("nonserializable-keys", ())
    )


def serializable_test(test: dict) -> dict:
    """The test without live objects (and without the huge history —
    the block format stores that separately)."""
    drop = nonserializable_keys(test) | {"history", "results"}
    return {k: v for k, v in test.items() if k not in drop}


def jtpu_file(test: dict) -> str:
    return path(test, "test.jtpu")


# ---------------------------------------------------------------------------
# Writer lifecycle + 3-phase save
# ---------------------------------------------------------------------------


@contextmanager
def with_writer(test: dict):
    """Open the block-file writer for a test run; the same writer spans
    all three save phases.  (reference: store.clj:404-411)"""
    from . import format as fmt

    os.makedirs(test_dir(test), exist_ok=True)
    w = fmt.Writer(jtpu_file(test))
    test = {**test, "writer": w}
    try:
        yield test
    finally:
        w.close()


def save_0(test: dict) -> dict:
    """Initial test map on disk.  (reference: store.clj:413-420)"""
    w = test.get("writer")
    if w is not None:
        base_id = w.write_partial_map(serializable_test(test))
        test = {**test, "base-block": base_id}
        w.set_root(base_id)
        w.save_index()
    return test


def save_1(test: dict) -> dict:
    """History durable: block + text artifacts, symlinks.
    (reference: store.clj:422-437)"""
    from ..history import History

    history: History = test.get("history") or History()
    w = test.get("writer")

    # One JSON pass serves both the block and the history.jsonl artifact.
    jsonl = "\n".join(
        json.dumps(op.to_dict(), default=repr) for op in history
    )

    def write_block():
        if w is None:
            return None
        h_id = w.write_history(history, jsonl=jsonl.encode())
        head_id = w.write_partial_map(
            {"history": {"$block-ref": h_id}}, rest_id=test.get("base-block", 0)
        )
        w.set_root(head_id)
        w.save_index()
        return head_id

    def write_txt():
        with open(path_(test, "history.txt"), "w") as f:
            for op in history:
                f.write(
                    f"{op.index}\t{op.process}\t{op.type}\t{op.f}\t"
                    f"{op.value!r}\n"
                )

    def write_jsonl():
        with open(path_(test, "history.jsonl"), "w") as f:
            f.write(jsonl)
            if jsonl:
                f.write("\n")

    head_id, _, _ = real_pmap(lambda fn: fn(), [write_block, write_txt, write_jsonl])
    if head_id is not None:
        test = {**test, "history-block": head_id}
    update_symlinks(test)
    return test


def save_2(test: dict) -> dict:
    """Results durable; final test map.  (reference: store.clj:439-456)"""
    results = test.get("results") or {}
    w = test.get("writer")

    def write_block():
        if w is None:
            return
        rest = {k: v for k, v in results.items() if k != "valid?"}
        rest_id = w.write_json(rest) if rest else 0
        res_id = w.write_partial_map(
            {"valid?": results.get("valid?")}, rest_id=rest_id
        )
        final_id = w.write_partial_map(
            {"results": {"$block-ref": res_id}},
            rest_id=test.get("history-block", test.get("base-block", 0)),
        )
        w.set_root(final_id)
        w.save_index()

    def write_json():
        with open(path_(test, "results.json"), "w") as f:
            json.dump(results, f, indent=2, default=repr)

    real_pmap(lambda fn: fn(), [write_block, write_json])
    return test


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def _open_reader(path: str):
    """Open a block file, falling back to torn-write recovery: a file
    whose tail was lost to a crash still loads from its longest valid
    block prefix (format.Reader(recover=True)), with a log line so the
    caller knows the view may predate the crash."""
    from . import format as fmt

    r = fmt.Reader(path, recover=True)
    if r.recovered:
        logging.getLogger(__name__).warning(
            "%s: torn write detected; recovered from the valid block "
            "prefix ending at byte %s",
            path,
            r.valid_prefix_end,
        )
    return r


def load(name_or_test, start_time: Optional[str] = None) -> dict:
    """Load a stored test by {name, start-time} map or by name + time.
    Resolves block refs for history and results.
    (reference: store.clj:122-137)"""
    from . import format as fmt
    from ..history import History

    if isinstance(name_or_test, dict):
        test = name_or_test
    else:
        test = {"name": name_or_test, "start-time": start_time}
    r = _open_reader(jtpu_file(test))
    out = r.root_value()
    for key in ("history", "results"):
        v = out.get(key)
        if fmt.is_block_ref(v):
            out[key] = r.read_value(v["$block-ref"])
    if r.recovered:
        out["recovered"] = True
    return out


def load_packed_history(name_or_test, start_time: Optional[str] = None) -> dict:
    """The device-feed arrays of a stored history — no JSON parse."""
    from . import format as fmt

    if isinstance(name_or_test, dict):
        test = name_or_test
    else:
        test = {"name": name_or_test, "start-time": start_time}
    r = _open_reader(jtpu_file(test))
    root = r.root_value()
    v = root.get("history")
    if not fmt.is_block_ref(v):
        raise IOError("no history block saved")
    out = r.read_packed_history(v["$block-ref"])
    if r.recovered:
        # same flag load() sets: the arrays may predate a torn tail
        out["recovered"] = True
    return out


def tests(base: str = BASE, name: Optional[str] = None) -> Dict[str, List[str]]:
    """Map of test name → sorted run timestamps.
    (reference: store.clj tests listing used by web.clj:48-95)"""
    out: Dict[str, List[str]] = {}
    if not os.path.isdir(base):
        return out
    names = [name] if name else sorted(os.listdir(base))
    for n in names:
        d = os.path.join(base, n)
        if not os.path.isdir(d) or n in ("latest", "current"):
            continue
        runs = sorted(
            t
            for t in os.listdir(d)
            if t != "latest" and os.path.isdir(os.path.join(d, t))
        )
        if runs:
            out[n] = runs
    return out


def latest_time(base: str, name: str) -> Optional[str]:
    """The most recent start-time recorded for a named test — via the
    per-test "latest" symlink when present AND still pointing at a run
    dir (a dangling link falls back to the listing, like latest()),
    else the newest surviving run dir.  (start-times are ISO-ish
    timestamps, so lexicographic max = newest)"""
    link = os.path.join(base, name, "latest")
    if os.path.islink(link):
        target = os.path.realpath(link)
        start = os.path.basename(target)
        if start and start != "latest" and os.path.isdir(target):
            return start
    runs = tests(base, name).get(name, ())
    return max(runs) if runs else None


def latest(base: str = BASE) -> Optional[dict]:
    """The most recently saved test, via the latest symlink or listing.
    (reference: repl.clj:6-15)"""
    link = os.path.join(base, "latest")
    if os.path.islink(link):
        target = os.path.realpath(link)
        name = os.path.basename(os.path.dirname(target))
        start = os.path.basename(target)
        try:
            return load({"name": name, "start-time": start,
                         "store-base": base})
        except OSError:
            pass  # dangling symlink: fall back to the listing
    all_tests = tests(base)
    best = None
    for n, runs in all_tests.items():
        for t in runs:
            if best is None or t > best[1]:
                best = (n, t)
    if best is None:
        return None
    try:
        return load({"name": best[0], "start-time": best[1],
                     "store-base": base})
    except OSError:
        return None


# ---------------------------------------------------------------------------
# Symlinks, logging, deletion
# ---------------------------------------------------------------------------


def _update_symlink(target_dir: str, link_path: str) -> None:
    try:
        os.makedirs(os.path.dirname(link_path), exist_ok=True)
        if os.path.islink(link_path) or os.path.exists(link_path):
            os.unlink(link_path)
        os.symlink(
            os.path.relpath(target_dir, os.path.dirname(link_path)), link_path
        )
    except OSError:
        pass  # symlinks are conveniences; never fail a save over one


def update_symlinks(test: dict) -> None:
    """current, latest, and <name>/latest point here.
    (reference: store.clj:344-358)"""
    d = test_dir(test)
    if not os.path.isdir(d):
        return
    base = base_dir(test)
    for link in (
        os.path.join(base, "current"),
        os.path.join(base, "latest"),
        os.path.join(base, test.get("name", "noname"), "latest"),
    ):
        _update_symlink(d, link)


_log_handlers: Dict[str, tuple] = {}  # path -> (handler, prior root level)


def start_logging(test: dict, json_logging: bool = False) -> None:
    """Attach a jepsen.log file handler for this test run.
    (reference: store.clj:474-502 via unilog)"""
    p = path_(test, "jepsen.log")
    if p in _log_handlers:
        return
    handler = logging.FileHandler(p)
    if json_logging:
        class JsonFormatter(logging.Formatter):
            def format(self, record):
                return json.dumps(
                    {
                        "ts": self.formatTime(record),
                        "level": record.levelname,
                        "logger": record.name,
                        "msg": record.getMessage(),
                    }
                )

        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s")
        )
    root = logging.getLogger()
    prior_level = root.level
    root.addHandler(handler)
    if root.level > logging.INFO or root.level == 0:
        root.setLevel(logging.INFO)
    _log_handlers[p] = (handler, prior_level)


def stop_logging(test: dict) -> None:
    p = path(test, "jepsen.log")
    entry = _log_handlers.pop(p, None)
    if entry is not None:
        handler, prior_level = entry
        root = logging.getLogger()
        root.removeHandler(handler)
        root.setLevel(prior_level)
        handler.close()


def delete(base: str = BASE, name: Optional[str] = None) -> None:
    """Delete stored tests (all, or one name's runs).
    (reference: store.clj:513-521)"""
    if name:
        shutil.rmtree(os.path.join(base, name), ignore_errors=True)
    else:
        shutil.rmtree(base, ignore_errors=True)
