"""Consistency models: pure state machines checked against histories.

A copy of :mod:`jepsen_tpu.models` (the knossos.model equivalents the
reference's linearizable checker runs, jepsen/src/jepsen/checker.clj:19-26):
register, cas-register, mutex, multi-register, the FIFO and unordered
queues, the multi-mutex and no-op models here, the owner-aware,
reentrant and fenced locks and the permit semaphore in :mod:`.locks`
(re-exported).  The port keeps its own copy so it never imports the JAX
package; ``repr``, equality and hashing are identical, so oracle results
(which embed model reprs) compare equal across the two packages.

A model is an immutable value with ``step(op) -> Model``; an invalid
transition returns an :class:`Inconsistent` model.  Models must be hashable
and comparable so searches can deduplicate configurations.  Models whose
histories factor per key, lock name or value declare the partition
protocol on :class:`Model`, which :mod:`jepsen_tpu_torch.engine.decompose`
and the oracle's per-key search read.
"""

from __future__ import annotations

from collections.abc import Hashable
from typing import Any, Tuple


class Model:
    """Base class. Subclasses implement step(op) returning a new model.

    **Partition protocol (P-compositionality).**  Models whose
    linearizability provably factors into independent per-partition
    sub-histories — "Faster linearizability checking via
    P-compositionality", arXiv:1504.00204 — additionally override:

    - ``partition_key(op)``: the partition one op touches (a hashable
      key), or ``None`` when the op spans partitions / carries no key —
      the whole history then passes through undecomposed.  The base
      class pins the name to ``None`` (not a method), the "no declared
      partition" marker every decomposition pass checks.
    - ``subhistory_model(key)``: the independent sub-model one
      partition's sub-history is checked against (seeded from this
      model's state for that partition).
    - ``partition_op(op, key)``: the op as the sub-model consumes it
      (default: unchanged — every current partitioner keeps the
      parent vocabulary; the hook exists for sub-models that speak a
      different one).

    Soundness contract: the model must be (isomorphic to) a product of
    the per-key sub-models with every partitionable op acting on
    exactly one factor — then a history is linearizable iff every
    per-partition sub-history is, and the decomposition passes
    (``engine/decompose.py`` ahead of device dispatch,
    ``checker.linear._partition_by_key`` inside the CPU oracle) may
    AND the sub-verdicts.  See doc/checker-engines.md "Decomposition
    front-end".
    """

    #: None = no declared partition (see the class docstring); models
    #: implementing the protocol override this with a method
    partition_key = None

    def step(self, op) -> "Model":  # pragma: no cover - interface
        raise NotImplementedError

    def subhistory_model(self, key) -> "Model":  # pragma: no cover - interface
        raise NotImplementedError(
            f"{type(self).__name__} declares no partition protocol"
        )

    def partition_op(self, op, key):
        """The op as the partition's sub-model consumes it (default:
        unchanged — sound whenever the sub-model shares this model's op
        vocabulary, e.g. per-lock Mutex or per-value UnorderedQueue)."""
        return op

    @property
    def is_inconsistent(self) -> bool:
        return False


class Inconsistent(Model):
    __slots__ = ("msg",)

    def __init__(self, msg: str):
        self.msg = msg

    def step(self, op) -> "Model":
        return self

    @property
    def is_inconsistent(self) -> bool:
        return True

    def __eq__(self, other):
        return isinstance(other, Inconsistent)

    def __hash__(self):
        return hash("inconsistent")

    def __repr__(self):
        return f"Inconsistent({self.msg!r})"


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


class Register(Model):
    """A read/write register.  fs: "write" (value v), "read" (observed v;
    a read of None — unknown value — always passes)."""

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value

    def step(self, op) -> Model:
        if op.f == "write":
            return Register(op.value)
        elif op.f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(f"read {op.value!r}, expected {self.value!r}")
        return inconsistent(f"unknown op f={op.f!r}")

    def __eq__(self, other):
        return isinstance(other, Register) and other.value == self.value

    def __hash__(self):
        return hash(("register", self.value))

    def __repr__(self):
        return f"Register({self.value!r})"


class CASRegister(Model):
    """A register with read / write / compare-and-set.

    fs: "read" (observed v), "write" (v), "cas" ((old, new)).
    """

    __slots__ = ("value",)

    def __init__(self, value: Any = None):
        self.value = value

    def step(self, op) -> Model:
        f = op.f
        if f == "write":
            return CASRegister(op.value)
        elif f == "cas":
            if op.value is None:
                return inconsistent("cas with nil value")
            old, new = op.value
            if old == self.value:
                return CASRegister(new)
            return inconsistent(f"cas expected {old!r}, had {self.value!r}")
        elif f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(f"read {op.value!r}, expected {self.value!r}")
        return inconsistent(f"unknown op f={f!r}")

    def __eq__(self, other):
        return isinstance(other, CASRegister) and other.value == self.value

    def __hash__(self):
        return hash(("cas-register", self.value))

    def __repr__(self):
        return f"CASRegister({self.value!r})"


class Mutex(Model):
    """A lock. fs: "acquire", "release"."""

    __slots__ = ("locked",)

    def __init__(self, locked: bool = False):
        self.locked = locked

    def step(self, op) -> Model:
        if op.f == "acquire":
            if self.locked:
                return inconsistent("cannot acquire a held lock")
            return Mutex(True)
        elif op.f == "release":
            if not self.locked:
                return inconsistent("cannot release a free lock")
            return Mutex(False)
        return inconsistent(f"unknown op f={op.f!r}")

    def __eq__(self, other):
        return isinstance(other, Mutex) and other.locked == self.locked

    def __hash__(self):
        return hash(("mutex", self.locked))

    def __repr__(self):
        return f"Mutex({'locked' if self.locked else 'free'})"


class MultiRegister(Model):
    """A map of independent registers; op value is [(f, k, v), ...] mops."""

    __slots__ = ("values",)

    def __init__(self, values: Any = None):
        self.values = frozenset((values or {}).items()) if isinstance(values, dict) else (values or frozenset())

    def _as_dict(self):
        return dict(self.values)

    def step(self, op) -> Model:
        vals = self._as_dict()
        for f, k, v in op.value or []:
            if f in ("w", "write"):
                vals[k] = v
            elif f in ("r", "read"):
                if v is not None and vals.get(k) != v:
                    return inconsistent(f"read {v!r} of {k!r}, expected {vals.get(k)!r}")
            else:
                return inconsistent(f"unknown mop f={f!r}")
        return MultiRegister(vals)

    # -- partition protocol: one single-key register per key ----------------
    # A txn whose mops all touch ONE key acts on exactly one factor of
    # the product state, so such histories decompose per key into
    # single-key MultiRegister sub-histories — the register-family
    # sub-model in this codebase's vocabulary (its dense automaton at
    # K=1 IS the register automaton), and an atomic multi-mop
    # same-key txn stays expressible (a plain Register op could not
    # say read-then-write).  Cross-key txns return None and keep the
    # history undecomposed.

    def partition_key(self, op):
        v = op.value
        if not isinstance(v, (list, tuple)) or not v:
            return None
        keys = set()
        for mop in v:
            if not (
                isinstance(mop, (list, tuple))
                and len(mop) == 3
                and mop[0] in ("r", "read", "w", "write")
                and isinstance(mop[1], Hashable)
            ):
                return None
            keys.add(mop[1])
        if len(keys) != 1:
            return None
        k = keys.pop()
        return None if k is None else k

    def subhistory_model(self, key) -> "MultiRegister":
        return MultiRegister({key: self._as_dict().get(key)})

    def __eq__(self, other):
        return isinstance(other, MultiRegister) and other.values == self.values

    def __hash__(self):
        return hash(("multi-register", self.values))

    def __repr__(self):
        return f"MultiRegister({dict(self.values)!r})"


class FIFOQueue(Model):
    """A FIFO queue. fs: "enqueue" (v), "dequeue" (observed v)."""

    __slots__ = ("items",)

    def __init__(self, items: Tuple = ()):
        self.items = tuple(items)

    def step(self, op) -> Model:
        if op.f == "enqueue":
            return FIFOQueue(self.items + (op.value,))
        elif op.f == "dequeue":
            if not self.items:
                return inconsistent("dequeue from empty queue")
            head, rest = self.items[0], self.items[1:]
            if op.value is not None and op.value != head:
                return inconsistent(f"dequeued {op.value!r}, expected {head!r}")
            return FIFOQueue(rest)
        return inconsistent(f"unknown op f={op.f!r}")

    def __eq__(self, other):
        return isinstance(other, FIFOQueue) and other.items == self.items

    def __hash__(self):
        return hash(("fifo-queue", self.items))

    def __repr__(self):
        return f"FIFOQueue({list(self.items)!r})"


class UnorderedQueue(Model):
    """A bag: enqueue/dequeue with no ordering constraint."""

    __slots__ = ("items",)

    def __init__(self, items=frozenset()):
        # multiset as frozenset of (value, count)
        if isinstance(items, frozenset):
            self.items = items
        else:
            counts: dict = {}
            for x in items:
                counts[x] = counts.get(x, 0) + 1
            self.items = frozenset(counts.items())

    def _counts(self):
        return dict(self.items)

    def step(self, op) -> Model:
        counts = self._counts()
        if op.f == "enqueue":
            counts[op.value] = counts.get(op.value, 0) + 1
            return UnorderedQueue(frozenset(counts.items()))
        elif op.f == "dequeue":
            v = op.value
            if v is None:
                return inconsistent("dequeue with unknown value")
            if counts.get(v, 0) <= 0:
                return inconsistent(f"dequeued {v!r} not in queue")
            counts[v] -= 1
            if counts[v] == 0:
                del counts[v]
            return UnorderedQueue(frozenset(counts.items()))
        return inconsistent(f"unknown op f={op.f!r}")

    # -- partition protocol: one queue per enqueued value -------------------
    # The bag is a product of per-value counters (enqueue/dequeue of v
    # touch only v's count — the same factoring the direct checker's
    # per-value matching exploits), so histories decompose per value.
    # A dequeue whose value never resolved (None) keeps the history
    # undecomposed: the full model owns the inconsistency verdict.

    def partition_key(self, op):
        if (
            op.f in ("enqueue", "dequeue")
            and op.value is not None
            and isinstance(op.value, Hashable)
        ):
            return op.value
        return None

    def subhistory_model(self, key) -> "UnorderedQueue":
        n = dict(self.items).get(key, 0)
        return UnorderedQueue(frozenset({(key, n)}) if n else frozenset())

    def __eq__(self, other):
        return isinstance(other, UnorderedQueue) and other.items == self.items

    def __hash__(self):
        return hash(("unordered-queue", self.items))

    def __repr__(self):
        return f"UnorderedQueue({dict(self.items)!r})"


class MultiMutex(Model):
    """A map of named locks: fs "acquire"/"release" with ``op.value`` =
    the lock name.  Semantically the product of one :class:`Mutex` per
    name — which is exactly its point: the model has no device kernel
    of its own (the undecomposed path is the generic oracle search),
    but the partition protocol splits its histories per lock name into
    plain Mutex sub-histories, which the direct mutex checker decides
    in O(n log n) — the P-compositionality win in its purest form."""

    __slots__ = ("held",)

    def __init__(self, held=frozenset()):
        self.held = frozenset(held)

    def step(self, op) -> Model:
        name = op.value
        if name is None:
            return inconsistent("lock op with nil lock name")
        if op.f == "acquire":
            if name in self.held:
                return inconsistent(f"cannot acquire held lock {name!r}")
            return MultiMutex(self.held | {name})
        elif op.f == "release":
            if name not in self.held:
                return inconsistent(f"cannot release free lock {name!r}")
            return MultiMutex(self.held - {name})
        return inconsistent(f"unknown op f={op.f!r}")

    # -- partition protocol: one Mutex per lock name ------------------------
    # Mutex.step ignores op.value, so the identity partition_op is
    # sound; the sub-model seeds from this model's held-set.

    def partition_key(self, op):
        if (
            op.f in ("acquire", "release")
            and op.value is not None
            and isinstance(op.value, Hashable)
        ):
            return op.value
        return None

    def subhistory_model(self, key) -> "Mutex":
        return Mutex(key in self.held)

    def __eq__(self, other):
        return isinstance(other, MultiMutex) and other.held == self.held

    def __hash__(self):
        return hash(("multi-mutex", self.held))

    def __repr__(self):
        return f"MultiMutex({sorted(self.held, key=repr)!r})"


class NoOp(Model):
    """A model that accepts everything."""

    def step(self, op) -> Model:
        return self

    def __eq__(self, other):
        return isinstance(other, NoOp)

    def __hash__(self):
        return hash("noop-model")

    def __repr__(self):
        return "NoOp()"


def register(value: Any = None) -> Register:
    return Register(value)


def cas_register(value: Any = None) -> CASRegister:
    return CASRegister(value)


def mutex() -> Mutex:
    return Mutex()


def multi_register(values: Any = None) -> MultiRegister:
    return MultiRegister(values)


def multi_mutex(held=()) -> MultiMutex:
    return MultiMutex(frozenset(held))


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


# owner-aware / reentrant / fenced locks and permits (hazelcast CP
# probes) — re-exported so `models.owner_mutex()` etc. work; imported
# at the bottom because locks.py imports Model/inconsistent from here
from .locks import (  # noqa: E402
    AcquiredPermits,
    FencedMutex,
    OwnerMutex,
    ReentrantFencedMutex,
    ReentrantMutex,
    acquired_permits,
    fenced_mutex,
    owner_mutex,
    reentrant_fenced_mutex,
    reentrant_mutex,
)
