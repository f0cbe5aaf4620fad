"""Long-fork anomaly detection (parallel snapshot isolation) — the
port's copy of :mod:`jepsen_tpu.workloads.long_fork`.

Concurrent write transactions observed in conflicting orders:

    T1: (write x 1)      T3: (read x nil) (read y 1)
    T2: (write y 1)      T4: (read x 1)   (read y nil)

T3 implies T2 < T1 but T4 implies T1 < T2.  Each key is written exactly
once, so reads of a key group must admit a total order where identical
values are contiguous; mutually incomparable reads are a fork.
(reference: jepsen/src/jepsen/tests/long_fork.clj:1-90 — the algorithm
documentation there derives the dominance-comparison approach used here.)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .. import generator as gen
from ..checker import Checker, UNKNOWN
from ..history import INVOKE, OK
from ..txn import R, W


class IllegalHistory(Exception):
    def __init__(self, info: dict):
        super().__init__(str(info))
        self.info = info


def group_for(n: int, k: int) -> range:
    """The n keys in k's group (lower inclusive, upper exclusive).
    (reference: long_fork.clj:98-105)"""
    lower = k - (k % n)
    return range(lower, lower + n)


def read_txn_for(n: int, k: int) -> List[list]:
    """A txn reading k's whole group, in shuffled order.
    (reference: long_fork.clj:107-113)"""
    ks = list(group_for(n, k))
    gen.rng.shuffle(ks)
    return [[R, k2, None] for k2 in ks]


class _LongForkGen(gen.Generator):
    """Single inserts followed by group reads, mixed with reads of other
    in-flight groups.  (reference: long_fork.clj:115-160)"""

    def __init__(self, n: int, next_key: int, workers: Dict[Any, Any]):
        self.n = n
        self.next_key = next_key
        self.workers = workers  # worker thread -> last written key | None

    def op(self, test, ctx):
        process = gen.some_free_process(ctx)
        worker = gen.process_to_thread(ctx, process)
        if worker is None:
            return (gen.PENDING, self)
        k = self.workers.get(worker)
        if k is not None:
            # We wrote a key: follow with a read of its group.
            o = gen.fill_in_op(
                {"process": process, "f": "read", "value": read_txn_for(self.n, k)},
                ctx,
            )
            return (o, _LongForkGen(self.n, self.next_key, {**self.workers, worker: None}))
        active = [v for v in self.workers.values() if v is not None]
        if active and gen.rng.random() < 0.5:
            # Read some other active group.
            k2 = active[gen.rng.randrange(len(active))]
            o = gen.fill_in_op(
                {"process": process, "f": "read", "value": read_txn_for(self.n, k2)},
                ctx,
            )
            return (o, self)
        # Write a fresh key.
        o = gen.fill_in_op(
            {"process": process, "f": "write", "value": [[W, self.next_key, 1]]},
            ctx,
        )
        return (
            o,
            _LongForkGen(
                self.n, self.next_key + 1, {**self.workers, worker: self.next_key}
            ),
        )

    def update(self, test, ctx, event):
        return self


def generator(n: int) -> gen.Generator:
    """(reference: long_fork.clj:162-166)"""
    return _LongForkGen(n, 0, {})


def read_compare(a: Dict[Any, Any], b: Dict[Any, Any]) -> Optional[int]:
    """-1 if a dominates, 0 if equal, 1 if b dominates, None if
    incomparable.  (reference: long_fork.clj:168-206)"""
    if len(a) != len(b):
        raise IllegalHistory(
            {"reads": [a, b], "msg": "reads queried different keys"}
        )
    res = 0
    for k, va in a.items():
        if k not in b:
            raise IllegalHistory(
                {"reads": [a, b], "key": k, "msg": "reads queried different keys"}
            )
        vb = b[k]
        if va == vb:
            continue
        if vb is None:
            if res > 0:
                return None
            res = -1
        elif va is None:
            if res < 0:
                return None
            res = 1
        else:
            raise IllegalHistory(
                {
                    "key": k,
                    "reads": [a, b],
                    "msg": "distinct non-nil values for one key; "
                    "this checker assumes one write per key",
                }
            )
    return res


def read_op_value_map(op) -> Dict[Any, Any]:
    """A read op's txn as {key: value}.  (reference: long_fork.clj:208-217)"""
    return {k: v for _, k, v in (op.value or [])}


def find_forks(ops: List[Any]) -> List[Tuple[Any, Any]]:
    """Pairs of mutually incomparable reads.
    (reference: long_fork.clj:219-234)"""
    forks = []
    for i in range(len(ops)):
        ma = read_op_value_map(ops[i])
        for j in range(i + 1, len(ops)):
            if read_compare(ma, read_op_value_map(ops[j])) is None:
                forks.append((ops[i], ops[j]))
    return forks


def is_read_txn(txn) -> bool:
    return all(m[0] == R for m in (txn or []))


def is_write_txn(txn) -> bool:
    return bool(txn) and len(txn) == 1 and txn[0][0] != R


def op_read_keys(op) -> frozenset:
    return frozenset(m[1] for m in (op.value or []))


def groups(n: int, read_ops: List[Any]) -> List[List[Any]]:
    """Partition reads by key-group; throw if a group is mis-sized.
    (reference: long_fork.clj:240-255)"""
    by_group: Dict[frozenset, List[Any]] = {}
    for op in read_ops:
        by_group.setdefault(op_read_keys(op), []).append(op)
    out = []
    for group, ops in by_group.items():
        if len(group) != n:
            raise IllegalHistory(
                {
                    "op": ops[0],
                    "msg": f"every read should observe exactly {n} keys, "
                    f"but this read observed {len(group)}: {sorted(group)}",
                }
            )
        out.append(ops)
    return out


class _LongForkChecker(Checker):
    def __init__(self, n: int):
        self.n = n

    def check(self, test, history, opts=None):
        reads = [
            op
            for op in history
            if op.type == OK and is_read_txn(op.value)
        ]
        early = [
            op.value
            for op in reads
            if not any(m[2] is not None for m in op.value)
        ]
        late = [
            op.value
            for op in reads
            if all(m[2] is not None for m in op.value)
        ]
        out = {
            "reads-count": len(reads),
            "early-read-count": len(early),
            "late-read-count": len(late),
        }
        try:
            # Multiple writes to one key make the analysis unsound.
            seen = set()
            for op in history:
                if op.type == INVOKE and is_write_txn(op.value):
                    k = op.value[0][1]
                    if k in seen:
                        out.update(
                            {"valid?": UNKNOWN, "error": ["multiple-writes", k]}
                        )
                        return out
                    seen.add(k)
            forks = []
            for group_ops in groups(self.n, reads):
                forks.extend(find_forks(group_ops))
            if forks:
                out.update(
                    {
                        "valid?": False,
                        "forks": [
                            [a.to_dict(), b.to_dict()] for a, b in forks
                        ],
                    }
                )
            else:
                out["valid?"] = True
        except IllegalHistory as e:
            out.update({"valid?": UNKNOWN, "error": e.info})
        return out


def checker(n: int) -> Checker:
    """No key written twice; no mutually incomparable group reads.
    (reference: long_fork.clj:283-300)"""
    return _LongForkChecker(n)


def workload(n: int = 2) -> dict:
    """(reference: long_fork.clj:302-308)"""
    return {"checker": checker(n), "generator": generator(n)}
