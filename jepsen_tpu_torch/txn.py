"""Transaction micro-op helpers — the port's copy of :mod:`jepsen_tpu.txn`
(reference: txn/src/jepsen/txn.clj:5-55).

A transactional op's :value is a list of micro-ops ("mops"), each a
``[f, k, v]`` triple: ``("r", key, value-read)``, ``("w", key, value)``,
or ``("append", key, element)``.  These helpers extract externally visible
reads/writes — the first read of a key before any write ("external read")
and the last write of a key ("external write").
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Sequence, Tuple

Mop = Sequence  # (f, k, v)

R = "r"
W = "w"
APPEND = "append"


def reduce_mops(fn: Callable[[Any, Mop], Any], init: Any, txn: Iterable[Mop]) -> Any:
    """Fold fn over every micro-op in a transaction.
    (reference: txn.clj reduce-mops)"""
    acc = init
    for mop in txn:
        acc = fn(acc, mop)
    return acc


def ext_reads(txn: Iterable[Mop]) -> Dict[Any, Any]:
    """Externally-visible reads: key → value for each key read *before*
    being written in this txn.  (reference: txn.clj ext-reads)"""
    reads: Dict[Any, Any] = {}
    ignore = set()
    for f, k, v in txn:
        if f == R:
            if k not in ignore and k not in reads:
                reads[k] = v
        else:
            ignore.add(k)
    return reads


def ext_writes(txn: Iterable[Mop]) -> Dict[Any, Any]:
    """Externally-visible writes: key → final written value.
    (reference: txn.clj ext-writes)"""
    writes: Dict[Any, Any] = {}
    for f, k, v in txn:
        if f != R:
            writes[k] = v
    return writes


def ext_appends(txn: Iterable[Mop]) -> Dict[Any, List[Any]]:
    """key → list of appended elements, in order, for list-append txns."""
    appends: Dict[Any, List[Any]] = {}
    for f, k, v in txn:
        if f == APPEND:
            appends.setdefault(k, []).append(v)
    return appends


def reads_of_key(txn: Iterable[Mop], key: Any) -> List[Any]:
    return [v for f, k, v in txn if f == R and k == key]


def writes_of_key(txn: Iterable[Mop], key: Any) -> List[Any]:
    return [v for f, k, v in txn if f != R and k == key]


def op_mops(op) -> List[Tuple[Any, Mop]]:
    """[(op, mop)] pairs for a history op whose value is a txn."""
    return [(op, mop) for mop in (op.value or [])]


# ---------------------------------------------------------------------
# Micro-op accessors (reference: txn/src/jepsen/txn/micro_op.clj:1-35)
# ---------------------------------------------------------------------


def mop_f(mop: Mop) -> Any:
    """The function a micro-op executes."""
    return mop[0]


def mop_key(mop: Mop) -> Any:
    """The key a micro-op affects."""
    return mop[1]


def mop_value(mop: Mop) -> Any:
    """The value a micro-op used."""
    return mop[2]


def is_read(mop: Mop) -> bool:
    return mop_f(mop) == R


def is_write(mop: Mop) -> bool:
    return mop_f(mop) == W


def is_mop(mop: Any) -> bool:
    """Is this a legal [f k v] micro-op?"""
    try:
        return len(mop) == 3 and mop_f(mop) in (R, W)
    except TypeError:
        return False
