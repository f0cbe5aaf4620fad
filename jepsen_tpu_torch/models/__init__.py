"""Consistency models: pure state machines checked against histories.

A copy of the register-family models of :mod:`jepsen_tpu.models` (the
knossos.model equivalents the reference's linearizable checker runs,
jepsen/src/jepsen/checker.clj:19-26).  The port keeps its own copy so it
never imports the JAX package; ``repr``, equality and hashing are
identical, so oracle results (which embed model reprs) compare equal
across the two packages.

A model is an immutable value with ``step(op) -> Model``; an invalid
transition returns an :class:`Inconsistent` model.  Models must be hashable
and comparable so searches can deduplicate configurations.

The owner-aware/reentrant/fenced lock and permit models, the
multi-register, the queues and the multi-mutex belong to later slices of
the port (ROADMAP.md, queue A).
"""

from __future__ import annotations

from typing import Any


class Model:
    """Base class. Subclasses implement step(op) returning a new model.

    ``partition_key = None`` marks a model with no declared partition
    (the P-compositionality protocol of the reference); every model of
    this slice is such a model, so histories are never decomposed."""

    partition_key = None

    def step(self, op) -> "Model":  # pragma: no cover - interface
        raise NotImplementedError

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


def register(value: Any = None) -> Register:
    return Register(value)


def cas_register(value: Any = None) -> CASRegister:
    return CASRegister(value)


def mutex() -> Mutex:
    return Mutex()
