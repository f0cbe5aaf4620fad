"""Parallel maps for the checker seam — the port's copies of
:func:`jepsen_tpu.util.real_pmap` and :func:`jepsen_tpu.util.bounded_pmap`.

Each worker runs on the caller's current CUDA device
(:func:`jepsen_tpu_torch.device.carry_current`), so an entry point given
no device resolves it on a worker thread as it would on the caller's.
"""

from __future__ import annotations

import concurrent.futures
from typing import Callable, List, Sequence, TypeVar

from .device import carry_current

T = TypeVar("T")
U = TypeVar("U")

#: :func:`bounded_pmap`'s default number of concurrent workers
DEFAULT_PMAP_LIMIT = 16


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
