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

The keyed generators (:func:`tuple_gen`, :func:`sequential_generator`,
:func:`concurrent_generator`) are the reference's, drawing from the
port's :mod:`.generator` in the reference's order, so a seed gives the
same operations in both packages.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterable, List, Sequence

from . import generator as gen
from . import obs
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


def tuple_gen(k, g):
    """Wrap a generator so invoke ops carry ``[k, v]`` values.
    (reference: independent.clj:94-101)"""

    def wrap(op):
        if op.get("type", "invoke") == "invoke":
            out = dict(op)
            out["value"] = KV(k, op.get("value"))
            return out
        return op

    return gen.map(wrap, g)


def sequential_generator(keys: Sequence[Any], fgen: Callable[[Any], Any]):
    """One key at a time: exhaust fgen(k1), move to k2, …  Values are
    wrapped in [k, v] tuples.  fgen must be pure.
    (reference: independent.clj:31-47)"""
    return [tuple_gen(k, fgen(k)) for k in keys]


def group_threads(n: int, ctx: dict) -> List[List[Any]]:
    """Partition the context's threads into groups of n.
    (reference: independent.clj:49-76)"""
    threads = sorted(
        gen.all_threads(ctx),
        key=lambda t: (1, str(t)) if isinstance(t, str) else (0, t),
    )
    thread_count = len(threads)
    group_count = thread_count // n
    if n > thread_count:
        raise ValueError(
            f"With {thread_count} worker threads, this concurrent-generator "
            f"cannot run a key with {n} threads concurrently. Consider "
            f"raising the test's concurrency to at least {n}."
        )
    if thread_count != n * group_count:
        raise ValueError(
            f"This concurrent-generator has {thread_count} threads but can "
            f"only use {n * group_count} of them to run {group_count} "
            f"concurrent keys with {n} threads apiece. Consider raising or "
            f"lowering the test's concurrency to a multiple of {n}."
        )
    return [threads[i * n : (i + 1) * n] for i in range(group_count)]


class _LazyKeys:
    """Memoizing view over a (possibly infinite) key iterable.  The
    reference's concurrent-generator takes lazy seqs like ``(range)``
    (generator_test.clj independent-deadlock-case); materializing with
    ``list()`` would hang forever on those.  Generator states hold
    (lazy-keys, position) pairs — the cache only ever appends, so every
    persistent-generator branch reading a position sees the same key."""

    def __init__(self, iterable):
        self._it = iter(iterable)
        self._cache: list = []

    def get(self, i: int):
        """Key at position ``i``; IndexError once the sequence ends."""
        while len(self._cache) <= i:
            try:
                self._cache.append(next(self._it))
            except StopIteration:
                raise IndexError(i) from None
        return self._cache[i]


class ConcurrentGenerator(gen.Generator):
    """Splits client threads into groups of n; each group works one key
    via fgen(k), drawing a fresh key when its generator is exhausted.
    Updates route to the group of the event's thread.
    (reference: independent.clj:103-211)
    """

    def __init__(self, n, fgen, group_to_threads, thread_to_group, keys, gens):
        self.n = n
        self.fgen = fgen
        self.group_to_threads = group_to_threads  # list[set], lazy
        self.thread_to_group = thread_to_group  # dict, lazy
        self.keys = keys  # (_LazyKeys, next-position)
        self.gens = gens  # per-group generators, lazy

    def _init(self, ctx):
        """Resolve lazy thread-mapping + per-group generator state."""
        g2t = self.group_to_threads
        t2g = self.thread_to_group
        if g2t is None:
            groups = group_threads(self.n, ctx)
            g2t = [set(g) for g in groups]
            t2g = {t: i for i, g in enumerate(groups) for t in g}
        lazy, pos = self.keys
        if self.gens is None:
            gens = []
            for _ in range(len(g2t)):
                try:
                    k = lazy.get(pos)
                except IndexError:
                    gens.append(None)
                    continue
                pos += 1
                gens.append(tuple_gen(k, self.fgen(k)))
        else:
            gens = list(self.gens)
        return g2t, t2g, (lazy, pos), gens

    def op(self, test, ctx):
        g2t, t2g, keys, gens = self._init(ctx)
        free_groups = {t2g[t] for t in gen.free_threads(ctx) if t in t2g}

        soonest = None
        for group in free_groups:
            while True:
                g = gens[group]
                if g is None:
                    break
                group_ctx = gen.on_threads_context(
                    lambda t, s=g2t[group]: t in s, ctx
                )
                res = gen.op(g, test, group_ctx)
                if res is not None:
                    o, g2 = res
                    soonest = gen.soonest_op_map(
                        soonest,
                        {
                            "op": o,
                            "group": group,
                            "gen": g2,
                            "weight": len(g2t[group]),
                        },
                    )
                    break
                # exhausted: replace with a generator for the next key
                lazy, pos = keys
                try:
                    k = lazy.get(pos)
                except IndexError:
                    gens[group] = None
                else:
                    keys = (lazy, pos + 1)
                    gens[group] = tuple_gen(k, self.fgen(k))

        if soonest is not None and soonest["op"] != gen.PENDING:
            gens2 = list(gens)
            gens2[soonest["group"]] = soonest["gen"]
            return (
                soonest["op"],
                ConcurrentGenerator(self.n, self.fgen, g2t, t2g, keys, gens2),
            )
        if soonest is not None or any(g is not None for g in gens):
            # Pending: a group may free up later.
            return (
                gen.PENDING,
                ConcurrentGenerator(self.n, self.fgen, g2t, t2g, keys, gens),
            )
        return None

    def update(self, test, ctx, event):
        if self.thread_to_group is None or self.gens is None:
            return self
        thread = gen.process_to_thread(ctx, event.get("process"))
        group = self.thread_to_group.get(thread)
        if group is None or self.gens[group] is None:
            return self
        gens = list(self.gens)
        gens[group] = gen.update(gens[group], test, ctx, event)
        return ConcurrentGenerator(
            self.n, self.fgen, self.group_to_threads, self.thread_to_group,
            self.keys, gens,
        )


def concurrent_generator(n: int, keys: Iterable[Any], fgen: Callable[[Any], Any]):
    """n threads per key, keys drawn in order as groups free up; excludes
    the nemesis.  (reference: independent.clj:213-238)"""
    if not (isinstance(n, int) and n > 0):
        raise ValueError(f"group size must be a positive integer: {n!r}")
    return gen.clients(
        ConcurrentGenerator(n, fgen, None, None, (_LazyKeys(keys), 0), None)
    )


# ---------------------------------------------------------------------------
# History partitioning
# ---------------------------------------------------------------------------


def _unkeyed_pair(op: Op) -> bool:
    """A client op (integer process) whose value is a bare two-element
    list or tuple: a ``[k, v]`` that lost its :class:`KV` on the way
    through JSON."""
    v = op.value
    return (isinstance(op.process, int) and not isinstance(v, KV)
            and isinstance(v, (list, tuple)) and len(v) == 2)


def rekey(history: History) -> History:
    """A keyed history with its ``[k, v]`` values as :class:`KV` again: a
    history read back from JSON (``store.load``) carries plain lists,
    which :func:`split_by_key` would take for un-keyed values.  Only a
    history in which no op carries a :class:`KV` is rewrapped, and only
    its client ops; a nemesis value of two elements stays as it is.  A
    live run's history (one with a :class:`KV`) is returned as it is, so
    an un-keyed client op there lands unwrapped in every key's
    subhistory, as the reference's :func:`subhistory` puts it.  The lifts
    below call it on their input."""
    if any(isinstance(op.value, KV) for op in history) \
            or not any(_unkeyed_pair(op) for op in history):
        return history
    return History(op.copy(value=KV(op.value[0], op.value[1]))
                   if _unkeyed_pair(op) else op for op in history)


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
        subs = split_by_key(rekey(history))
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

        by_key = split_by_key(rekey(history))
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
            # two files a key: thousands on a wide keyspace, so the span
            # shows what persisting them costs beside the check itself
            with obs.span("independent/artifacts", cat="checker",
                          keys=len(ks)):
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
