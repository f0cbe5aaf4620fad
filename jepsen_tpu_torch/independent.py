"""Lifting a single-key checker to a *map* of independent keys — the
analysis half of :mod:`jepsen_tpu.independent`.

Many independent single-key tests run concurrently; each key's
subhistory is checked separately (reference:
jepsen/src/jepsen/independent.clj:1-15).  :func:`checker` lifts any
checker per key with bounded host parallelism;
:func:`batched_linearizable` instead gathers every key's subhistory into
one ``check_batch`` run — the per-key independence as the device's batch
axis.

The batched lift splits the history into every key's subhistory in one
pass (:func:`split_by_key`), where the reference scans the whole history
once per key (:func:`subhistory`, kept for single-key callers): on the
flagship keyspace — 1024 keys of 1000-op histories — that is one pass
over two million ops instead of two billion steps.  The subhistories
are the same.

The keyed generators (``tuple_gen``, ``concurrent_generator``, …) drive
the test harness and are not ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

from . import store as store_mod
from .checker import Checker, check_safe, merge_valid
from .history import History, Op
from .util import bounded_pmap

#: Directory (within the test's store dir) for per-key results.
#: (reference: independent.clj:17-19)
DIR = "independent"


class KV(tuple):
    """A [key, value] tuple marking a value as belonging to an independent
    keyed sub-test.  (reference: independent.clj:21-29 MapEntry)"""

    __slots__ = ()

    def __new__(cls, k, v):
        return tuple.__new__(cls, (k, v))

    @property
    def key(self):
        return self[0]

    @property
    def value(self):
        return self[1]

    def __repr__(self):
        return f"[{self[0]!r} {self[1]!r}]"


def kv(k, v) -> KV:
    """Construct a kv tuple.  (reference: independent.clj:21-24)"""
    return KV(k, v)


def is_tuple(value: Any) -> bool:
    """Was this value generated by an independent generator?
    (reference: independent.clj:26-29)"""
    return isinstance(value, KV)


# ---------------------------------------------------------------------------
# History partitioning
# ---------------------------------------------------------------------------


def history_keys(history: History) -> set:
    """The set of keys present in a history's tuple values.
    (reference: independent.clj:240-250)"""
    return {op.value.key for op in history if is_tuple(op.value)}


def subhistory(k, history: History) -> History:
    """Ops without a *differing* key, tuples unwrapped to their values.
    Un-keyed ops (e.g. nemesis events) appear in every subhistory.
    (reference: independent.clj:252-264)"""
    out = History()
    for op in history:
        v = op.value
        if not is_tuple(v):
            out.append(op)
        elif v.key == k:
            out.append(op.copy(value=v.value))
    return out


def _unwrapped(op: Op, value) -> Op:
    """``op.copy(value=value)``, its slots set directly: the split's hot
    path, without the keyword dispatch of :meth:`Op.copy`."""
    out = Op.__new__(Op)
    out.type, out.process, out.f, out.value = op.type, op.process, op.f, value
    out.time, out.index, out.extra = op.time, op.index, dict(op.extra)
    return out


def split_by_key(history: History) -> Dict[Any, History]:
    """Every key's :func:`subhistory` in one pass: key → its ops in
    order, tuples unwrapped, with each un-keyed op (a nemesis event) in
    every subhistory at its place.  Equal, key by key, to
    ``subhistory(k, history)``; an un-keyed op enters each subhistory as
    its own copy, so indexing one subhistory never renumbers another."""
    keyed: Dict[Any, list] = {}
    # per key: how many un-keyed ops it has taken so far; an un-keyed op
    # reaches a key lazily, when the key's next op arrives or at the end
    seen: Dict[Any, int] = {}
    unkeyed: List[Op] = []
    for op in history:
        v = op.value
        if not isinstance(v, KV):
            unkeyed.append(op)
            continue
        k = v[0]
        ops = keyed.get(k)
        if ops is None:
            ops = keyed[k] = []
            seen[k] = 0
        if seen[k] < len(unkeyed):
            ops.extend(u.copy() for u in unkeyed[seen[k]:])
            seen[k] = len(unkeyed)
        ops.append(_unwrapped(op, v[1]))
    for k, ops in keyed.items():
        if seen[k] < len(unkeyed):
            ops.extend(u.copy() for u in unkeyed[seen[k]:])
    return {k: History(ops) for k, ops in keyed.items()}


def _write_key_artifacts(test: dict, subdir: list, result: dict,
                         h: History) -> None:
    """Persist per-key results + history under the test's store dir.
    (reference: independent.clj:295-303)"""
    try:
        base = store_mod.path_(test, *subdir, "results.json")
        with open(base, "w") as f:
            json.dump(result, f, indent=2, default=repr)
        with open(os.path.join(os.path.dirname(base), "history.jsonl"),
                  "w") as f:
            for op in h:
                f.write(json.dumps(op.to_dict(), default=repr) + "\n")
    except OSError:
        pass  # persistence is best-effort; the verdict is what matters


class _IndependentChecker(Checker):
    def __init__(self, chk: Checker):
        self.chk = chk

    def check(self, test, history, opts=None):
        opts = opts or {}
        subs = split_by_key(history)
        ks = sorted(subs, key=str)

        def check_key(k):
            h = subs[k].index_ops()
            subdir = list(opts.get("subdirectory", [])) + [DIR, str(k)]
            result = check_safe(
                self.chk, test, h,
                {**opts, "subdirectory": subdir, "history-key": k},
            )
            if test.get("store?", True):
                _write_key_artifacts(test, subdir, result, h)
            return k, result

        results = dict(bounded_pmap(check_key, ks))
        failures = [k for k in ks if results[k].get("valid?") is not True]
        return {
            "valid?": merge_valid(r.get("valid?") for r in results.values())
            if results
            else True,
            "results": results,
            "failures": failures,
        }


def checker(chk: Checker) -> Checker:
    """Lift a checker over values to a checker over [k, v] histories:
    valid iff every key's subhistory is valid.  Keys are checked on up to
    16 worker threads, each on the caller's CUDA device.
    (reference: independent.clj:266-317)"""
    return _IndependentChecker(chk)


class _BatchedLinearizable(Checker):
    def __init__(self, model, frontier: int, slot_cap: int, device=None):
        self.model = model
        self.frontier = frontier
        self.slot_cap = slot_cap
        self.device = device

    def check(self, test, history, opts=None):
        from .ops import wgl
        from .parallel import mesh as mesh_mod

        by_key = split_by_key(history)
        ks = sorted(by_key, key=str)
        subs = [by_key[k].client_ops().index_ops() for k in ks]
        per_key = wgl.check_batch(
            self.model,
            subs,
            frontier=self.frontier,
            slot_cap=self.slot_cap,
            mesh=mesh_mod.resolve_mesh(test),
            # the engine's in-flight bound; per-key subhistories are the
            # mixed-length batch its shape buckets exist for
            window=test.get("engine-window"),
            device=self.device,
        )
        results = dict(zip(ks, per_key))
        if test.get("store?", True):
            base_subdir = list((opts or {}).get("subdirectory", []))
            for k, h in zip(ks, subs):
                _write_key_artifacts(
                    test, base_subdir + [DIR, str(k)], results[k], h
                )
        failures = [k for k in ks if results[k].get("valid?") is not True]
        return {
            "valid?": merge_valid(r.get("valid?") for r in results.values())
            if results
            else True,
            "results": results,
            "failures": failures,
            # engine/kernel breakdown: a keyspace drifting off the dense
            # kernel or onto the oracle shows up here, not just per key
            "batch-stats": wgl.batch_stats(per_key),
        }


def batched_linearizable(model, frontier: int = 128, slot_cap: int = 16,
                         device=None) -> Checker:
    """The device lift of the linearizable checker: every key's
    subhistory goes into one ``check_batch`` run (sharded over
    ``test["mesh"]`` when present) — the per-key independence of
    independent.clj:266-317 as the device's batch axis instead of a
    thread pool.  ``device`` as for ``check_batch`` (None: the current
    CUDA device)."""
    return _BatchedLinearizable(model, frontier, slot_cap, device)
