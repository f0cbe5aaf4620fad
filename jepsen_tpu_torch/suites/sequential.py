"""Sequential-consistency workload for the SQL suites.

The port's copy of :mod:`jepsen_tpu.suites.sequential`.

A writer inserts a key's subkeys one per transaction, in order; a reader
later queries them in *reverse* order.  Under sequential consistency a
reader that observes subkey i must observe every subkey written before
it — so the reversed read list may contain nils only as a prefix.  Keys
shard over several tables so they land in different ranges.

Reference: cockroachdb/src/jepsen/cockroach/sequential.clj:1-185 — the
Client writes subkeys ``k_0..k_{n-1}`` in separate txns and reads them
reversed; ``trailing-nil?`` detects a nil after a non-nil, the checker
counts all/some/none/bad reads; the generator reserves n writer threads
emitting sequential keys and readers sampling recently-written keys.
"""

from __future__ import annotations

import random
from collections import deque
from typing import List, Optional

from .. import generator as gen
from ..checker import Checker
from ..history import OK
from . import sql

TABLE_PREFIX = "seq_"
TABLE_COUNT = 3
KEY_COUNT = 5


def table_for(subkey: str, table_count: int = TABLE_COUNT) -> str:
    # stable shard assignment (python's str hash is salted per process)
    return f"{TABLE_PREFIX}{sum(subkey.encode()) % table_count}"


def subkeys(key_count: int, k) -> List[str]:
    return [f"{k}_{i}" for i in range(key_count)]


class SequentialClient(sql._Base):
    """(reference: sequential.clj:52-105)"""

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.table_count = int(self.opts.get("table-count", TABLE_COUNT))
        self.key_count = int(self.opts.get("key-count", KEY_COUNT))

    def setup(self, test):
        self._exec_ddl(
            *(
                f"CREATE TABLE IF NOT EXISTS {TABLE_PREFIX}{i} "
                # "sk", not "key": KEY is reserved in MySQL/TiDB, and a
                # dialect-neutral name beats per-dialect quoting
                "(sk VARCHAR(255) PRIMARY KEY)"
                for i in range(self.table_count)
            )
        )

    def invoke(self, test, op):
        k = op["value"]
        ks = subkeys(self.key_count, k)
        try:
            if op["f"] == "write":
                # one transaction per subkey, in client order
                for sk in ks:
                    self.conn.query(
                        f"INSERT INTO {table_for(sk, self.table_count)} "
                        f"(sk) VALUES ('{sk}')"
                    )
                return {**op, "type": "ok"}
            if op["f"] == "read":
                out = []
                for sk in reversed(ks):
                    res = self.conn.query(
                        f"SELECT sk FROM {table_for(sk, self.table_count)} "
                        f"WHERE sk = '{sk}'"
                    )
                    out.append(str(res.rows[0][0]) if res.rows else None)
                return {**op, "type": "ok", "value": [k, out]}
            raise ValueError(f"unknown f {op['f']!r}")
        except sql.IndeterminateError as e:
            return self._info(op, e)
        except (sql.PgError, sql.MysqlError) as e:
            return self._fail(op, e)


def trailing_nil(coll) -> bool:
    """A nil after a non-nil element.  (reference: sequential.clj:137-140)"""
    it = iter(coll)
    for x in it:
        if x is not None:
            break
    return any(x is None for x in it)


class SequentialChecker(Checker):
    """(reference: sequential.clj:142-162)"""

    def __init__(self, key_count: int = KEY_COUNT):
        self.key_count = key_count

    def check(self, test, history, opts=None):
        reads = [
            op.value
            for op in history
            if op.type == OK and op.f == "read" and isinstance(op.value, (list, tuple))
        ]
        none = [r for r in reads if all(x is None for x in r[1])]
        some = [r for r in reads if any(x is None for x in r[1])]
        bad = [r for r in reads if trailing_nil(r[1])]
        all_ = [
            r
            for r in reads
            if list(r[1]) == list(reversed(subkeys(self.key_count, r[0])))
        ]
        return {
            "valid?": not bad,
            "all-count": len(all_),
            "some-count": len(some),
            "none-count": len(none),
            "bad-count": len(bad),
            "bad": bad,
        }


def workload(opts: Optional[dict] = None) -> dict:
    """n reserved writer threads emit sequential keys; the rest read a
    recently-written key.  (reference: sequential.clj:107-133,164-185)"""
    opts = dict(opts or {})
    n = int(opts.get("writer-threads", 5))
    key_count = int(opts.get("key-count", KEY_COUNT))
    last_written: deque = deque([None] * (2 * n), maxlen=2 * n)
    counter = {"k": 0}

    def write(test, ctx):
        k = counter["k"]
        counter["k"] += 1
        last_written.append(k)
        return {"type": "invoke", "f": "write", "value": k}

    def read(test, ctx):
        k = random.choice([x for x in last_written if x is not None] or [0])
        return {"type": "invoke", "f": "read", "value": k}

    return {
        "generator": gen.reserve(n, write, read),
        "checker": SequentialChecker(key_count),
        "key-count": key_count,
    }
