"""Kitchen-sink utilities of the port — its copy of :mod:`jepsen_tpu.util`
(reference: jepsen/src/jepsen/util.clj).

Hot pieces: the test-relative monotonic clock (util.clj:337-353), bounded
parallel maps (util.clj:65-83), retry/timeout helpers (util.clj:370-466),
interval-set rendering (util.clj:629-668), latency extraction
(util.clj:700-760).

The parallel maps run each worker on the caller's current CUDA device
(:func:`jepsen_tpu_torch.device.carry_current`), so an entry point given
no device resolves it on a worker thread as it would on the caller's.
"""

from __future__ import annotations

import concurrent.futures
import random
import threading
import time as _time
from contextlib import contextmanager
from typing import Any, Callable, Iterable, List, Optional, Sequence, TypeVar

from .device import carry_current

T = TypeVar("T")
U = TypeVar("U")

#: :func:`bounded_pmap`'s default number of concurrent workers
DEFAULT_PMAP_LIMIT = 16

# ---------------------------------------------------------------------------
# Relative time
# ---------------------------------------------------------------------------

_global_origin: Optional[int] = None


def monotonic_nanos() -> int:
    return _time.monotonic_ns()


@contextmanager
def with_relative_time():
    """Establish t=0 for this test run; relative_time_nanos() measures from
    here.  (reference: util.clj:337-353)"""
    global _global_origin
    prev = _global_origin
    _global_origin = _time.monotonic_ns()
    try:
        yield
    finally:
        _global_origin = prev


def relative_time_nanos() -> int:
    origin = _global_origin
    if origin is None:
        raise RuntimeError("relative_time_nanos called outside with_relative_time")
    return _time.monotonic_ns() - origin


# ---------------------------------------------------------------------------
# Parallelism
# ---------------------------------------------------------------------------


def real_pmap(fn: Callable[[T], U], coll: Sequence[T]) -> List[U]:
    """Map fn over coll, one thread per element, re-raising the first
    exception.  (reference: util.clj:65-83 real-pmap)"""
    coll = list(coll)
    if not coll:
        return []
    if len(coll) == 1:
        return [fn(coll[0])]
    fn = carry_current(fn)
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(coll)) as ex:
        futures = [ex.submit(fn, x) for x in coll]
        return [f.result() for f in futures]


def bounded_pmap(fn: Callable[[T], U], coll: Sequence[T],
                 limit: int = DEFAULT_PMAP_LIMIT) -> List[U]:
    """Parallel map with at most `limit` concurrent workers.
    (reference: util.clj bounded-pmap)"""
    coll = list(coll)
    if not coll:
        return []
    fn = carry_current(fn)
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, min(limit, len(coll)))) as ex:
        return list(ex.map(fn, coll))


# ---------------------------------------------------------------------------
# Retry / timeout
# ---------------------------------------------------------------------------


class TimeoutError_(Exception):
    pass


def timeout(ms: float, fn: Callable[[], T], default: Any = TimeoutError_) -> Any:
    """Run fn in a thread; if it doesn't finish in `ms` milliseconds return
    `default` (or raise if default is the TimeoutError_ class).  The thread
    is abandoned, not killed — like the reference's future-based timeout
    (util.clj:370-390)."""
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(fn)
    try:
        return fut.result(timeout=ms / 1000.0)
    except concurrent.futures.TimeoutError:
        fut.cancel()
        if default is TimeoutError_:
            raise TimeoutError_(f"timed out after {ms} ms")
        return default
    finally:
        ex.shutdown(wait=False)


def retry(delay_seconds: float, fn: Callable[[], T], tries: Optional[int] = None) -> T:
    """Retry fn until it succeeds, sleeping delay_seconds between attempts.
    (reference: util.clj:425-440)"""
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except Exception:
            if tries is not None and attempt >= tries:
                raise
            _time.sleep(delay_seconds)


# ---------------------------------------------------------------------------
# Collections / math
# ---------------------------------------------------------------------------


def free_port() -> int:
    """An ephemeral localhost TCP port (bind to 0, read, release).
    The one shared copy — the localkv suite and the tests allocate
    scratch ports this way."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def majority(n: int) -> int:
    """Smallest integer strictly greater than half of n; majority(0) = 1.
    (reference: util.clj:84-90)"""
    return n // 2 + 1


def minority(n: int) -> int:
    """Largest number of nodes that is NOT a majority."""
    return (n - 1) // 2


def random_nonempty_subset(coll: Sequence[T], rng: Optional[random.Random] = None) -> List[T]:
    """A random nonempty subset of coll, in shuffled order.
    (reference: util.clj:45-52)"""
    rng = rng or random
    coll = list(coll)
    if not coll:
        return []
    n = rng.randint(1, len(coll))
    return rng.sample(coll, n)


def integer_interval_set_str(xs: Iterable[int]) -> str:
    """Compact string for a set of integers as intervals:
    ``#{1 3..5 7}``.  (reference: util.clj:629-668)"""
    xs = sorted(set(xs))
    parts = []
    i = 0
    while i < len(xs):
        j = i
        while j + 1 < len(xs) and xs[j + 1] == xs[j] + 1:
            j += 1
        if j == i:
            parts.append(str(xs[i]))
        elif j == i + 1:
            parts.append(str(xs[i]))
            parts.append(str(xs[j]))
        else:
            parts.append(f"{xs[i]}..{xs[j]}")
        i = j + 1
    return "#{" + " ".join(parts) + "}"


def chunked(seq: Sequence[T], n: int) -> List[List[T]]:
    return [list(seq[i : i + n]) for i in range(0, len(seq), n)]


# ---------------------------------------------------------------------------
# History-derived metrics
# ---------------------------------------------------------------------------


def history_latencies(history) -> list:
    """Attach :latency (completion.time - invoke.time, ns) to each invoke;
    returns the invokes.  (reference: util.clj:700-735)"""
    out = []
    for inv, comp in history.pairs():
        if comp is not None:
            inv = inv.copy(latency=comp.time - inv.time, completion_type=comp.type)
        out.append(inv)
    return out


def nemesis_intervals(history, fs_start=("start",), fs_stop=("stop",)) -> list:
    """[(start-op, stop-op-or-None)] intervals of nemesis activity, pairing
    ops whose :f starts/stops a fault.  Overlapping faults of different
    kinds are matched by fault name (the :f with its start/stop prefix
    removed), so ``stop-clock-skew`` closes ``start-clock-skew`` even if a
    partition opened in between.  (reference: util.clj:736-760)"""

    def fault_key(name: str, prefixes) -> Optional[str]:
        for p in prefixes:
            p = str(p)
            if name == p or name.startswith(p):
                return name[len(p) :]
        return None

    intervals = []
    open_by_fault: dict = {}
    for op in history:
        if isinstance(op.process, int):
            continue
        if op.type != "info":
            continue
        name = str(op.f)
        start_key = fault_key(name, fs_start)
        stop_key = fault_key(name, fs_stop)
        if start_key is not None:
            open_by_fault.setdefault(start_key, []).append(op)
        elif stop_key is not None:
            opened = open_by_fault.get(stop_key)
            if opened:
                intervals.append((opened.pop(0), op))
    for opened in open_by_fault.values():
        for op in opened:
            intervals.append((op, None))
    intervals.sort(key=lambda pair: pair[0].time)
    return intervals


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


class NamedLocks:
    """A family of locks addressed by arbitrary keys.
    (reference: util.clj:860-880)"""

    def __init__(self):
        self._guard = threading.Lock()
        self._locks: dict = {}

    def get(self, name: Any) -> threading.Lock:
        with self._guard:
            lock = self._locks.get(name)
            if lock is None:
                lock = threading.Lock()
                self._locks[name] = lock
            return lock

    @contextmanager
    def hold(self, name: Any):
        lock = self.get(name)
        with lock:
            yield


def coll_str(x: Any, limit: int = 8) -> str:
    """Abbreviated collection printing for log lines."""
    if isinstance(x, (list, tuple, set, frozenset)):
        xs = list(x)
        if len(xs) > limit:
            return f"[{', '.join(map(str, xs[:limit]))}, … ({len(xs)} total)]"
    return str(x)


def log_op(op) -> str:
    """One-line rendering of an op for logs.  (reference: util.clj:239-243)"""
    err = op.extra.get("error")
    err_s = f"\t{err}" if err else ""
    return f"{op.process}\t{op.type}\t{op.f}\t{coll_str(op.value)}{err_s}"


def fraction(a: float, b: float) -> float:
    """a/b, but 0 when b is 0."""
    return a / b if b else 0.0


def drop_common_proper_prefix(colls):
    """Drop the longest common *proper* prefix from each collection: at
    least one element of every collection is always kept.
    (reference: util.clj drop-common-proper-prefix, used by snarf-logs!)"""
    colls = [list(c) for c in colls]
    if not colls:
        return []
    limit = min(len(c) for c in colls) - 1
    k = 0
    while k < limit and all(c[k] == colls[0][k] for c in colls):
        k += 1
    return [c[k:] for c in colls]
