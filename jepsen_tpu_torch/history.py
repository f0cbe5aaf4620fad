"""Op and history data model.

The history is the interchange format of the whole framework: the
interpreter produces one, the store persists one, and every checker consumes
one.  A history is a flat, time-ordered list of :class:`Op` events; each
logical operation appears as an ``invoke`` event followed (usually) by a
completion event (``ok``, ``fail``, or ``info``).

Semantics mirror the reference's knossos.op / jepsen history conventions
(reference: jepsen/src/jepsen/core.clj:228 assigns indices via
knossos.history/index; jepsen/src/jepsen/generator/interpreter.clj:142-157
turns worker crashes into ``info`` ops):

- ``invoke``: a process began an operation.
- ``ok``:     it completed successfully (reads carry the observed value
              on the *completion* event).
- ``fail``:   it definitely did NOT take effect.
- ``info``:   indeterminate — it may or may not have taken effect, at any
              later time ("open forever" for linearizability checking).

Processes are logically single-threaded: a process has at most one
outstanding operation, and a crashed process id is never reused.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional, Union

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

TYPES = (INVOKE, OK, FAIL, INFO)

#: Integer codes for the device encoding (see jepsen_tpu_torch.ops.encode).
TYPE_CODES = {INVOKE: 0, OK: 1, FAIL: 2, INFO: 3}

NEMESIS = "nemesis"

Process = Union[int, str]


#: the fields every op carries outside its ``extra`` dict
_CORE_KEYS = frozenset(("index", "type", "process", "f", "value", "time"))


class Op:
    """One history event.

    Cheap, mutable-by-convention record with a small fixed set of hot
    fields plus an ``extra`` dict for workload-specific keys (e.g.
    ``:error``, ``:link``, ``:clock-offsets``).
    """

    __slots__ = ("index", "type", "process", "f", "value", "time", "extra")

    def __init__(
        self,
        type: str,
        process: Process,
        f: Any,
        value: Any = None,
        time: int = 0,
        index: int = -1,
        **extra: Any,
    ):
        self.type = type
        self.process = process
        self.f = f
        self.value = value
        self.time = time
        self.index = index
        self.extra = extra or {}

    # -- dict-ish access so workloads can stash arbitrary keys -------------

    def get(self, key: str, default: Any = None) -> Any:
        if key in Op.__slots__ and key != "extra":
            return getattr(self, key)
        return self.extra.get(key, default)

    def __getitem__(self, key: str) -> Any:
        if key in Op.__slots__ and key != "extra":
            return getattr(self, key)
        return self.extra[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if key in Op.__slots__ and key != "extra":
            setattr(self, key, value)
        else:
            self.extra[key] = value

    def __contains__(self, key: str) -> bool:
        if key in ("index", "type", "process", "f", "value", "time"):
            return True
        return key in self.extra

    @property
    def error(self) -> Any:
        return self.extra.get("error")

    # -- predicates --------------------------------------------------------

    @property
    def is_invoke(self) -> bool:
        return self.type == INVOKE

    @property
    def is_ok(self) -> bool:
        return self.type == OK

    @property
    def is_fail(self) -> bool:
        return self.type == FAIL

    @property
    def is_info(self) -> bool:
        return self.type == INFO

    def copy(self, **updates: Any) -> "Op":
        op = Op(
            self.type,
            self.process,
            self.f,
            self.value,
            self.time,
            self.index,
            **dict(self.extra),
        )
        for k, v in updates.items():
            op[k] = v
        return op

    def to_dict(self) -> dict:
        d = {
            "index": self.index,
            "type": self.type,
            "process": self.process,
            "f": self.f,
            "value": self.value,
            "time": self.time,
        }
        d.update(self.extra)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Op":
        op = Op.__new__(Op)
        op.type = d["type"]
        op.process = d["process"]
        op.f = d.get("f")
        op.value = d.get("value")
        op.time = d.get("time", 0)
        op.index = d.get("index", -1)
        # the set test runs in C: a plain op dict makes no extra dict scan
        op.extra = ({} if d.keys() <= _CORE_KEYS else
                    {k: v for k, v in d.items() if k not in _CORE_KEYS})
        return op

    def __repr__(self) -> str:
        extra = f" {self.extra}" if self.extra else ""
        return (
            f"Op({self.index} {self.type} p={self.process} f={self.f!r}"
            f" v={self.value!r} t={self.time}{extra})"
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Op):
            return NotImplemented
        return (
            self.type == other.type
            and self.process == other.process
            and self.f == other.f
            and self.value == other.value
            and self.time == other.time
            and self.index == other.index
            and self.extra == other.extra
        )

    def __hash__(self) -> int:
        return hash((self.type, self.process, self.f, self.index))


def invoke_op(process: Process, f: Any, value: Any = None, **kw: Any) -> Op:
    return Op(INVOKE, process, f, value, **kw)


def ok_op(process: Process, f: Any, value: Any = None, **kw: Any) -> Op:
    return Op(OK, process, f, value, **kw)


def fail_op(process: Process, f: Any, value: Any = None, **kw: Any) -> Op:
    return Op(FAIL, process, f, value, **kw)


def info_op(process: Process, f: Any, value: Any = None, **kw: Any) -> Op:
    return Op(INFO, process, f, value, **kw)


class History(list):
    """A list of Ops with indexing and pairing helpers.

    Subclasses list so all the single-pass checkers can iterate it
    directly; adds the pairing structure (invoke ↔ completion) every
    analysis needs.
    """

    def __init__(self, ops: Iterable[Op] = ()):
        super().__init__(ops)

    # -- index assignment (knossos.history/index equivalent) ---------------

    def index_ops(self) -> "History":
        """Assign a monotone :index to every op, in place. Returns self."""
        for i, op in enumerate(self):
            op.index = i
        return self

    # -- views -------------------------------------------------------------

    def invocations(self) -> Iterator[Op]:
        return (op for op in self if op.type == INVOKE)

    def completions(self) -> Iterator[Op]:
        return (op for op in self if op.type != INVOKE)

    def oks(self) -> Iterator[Op]:
        return (op for op in self if op.type == OK)

    def client_ops(self) -> "History":
        return History(op for op in self if isinstance(op.process, int))

    def nemesis_ops(self) -> "History":
        return History(op for op in self if not isinstance(op.process, int))

    def filter_f(self, f: Any) -> "History":
        return History(op for op in self if op.f == f)

    # -- pairing -----------------------------------------------------------

    def pair_index(self) -> list:
        """For each position i, the position of the other half of the
        operation (invoke↔completion), or -1 if unpaired.

        Processes are logically single-threaded, so the completion of an
        invoke is the next event from the same process.
        """
        pairs = [-1] * len(self)
        open_by_process: dict = {}
        for i, op in enumerate(self):
            if op.type == INVOKE:
                open_by_process[op.process] = i
            else:
                j = open_by_process.pop(op.process, None)
                if j is not None:
                    pairs[i] = j
                    pairs[j] = i
        return pairs

    def pairs(self) -> Iterator[tuple]:
        """Yield (invoke, completion-or-None) tuples in invocation order."""
        pair = self.pair_index()
        for i, op in enumerate(self):
            if op.type == INVOKE:
                j = pair[i]
                yield (op, self[j] if j >= 0 else None)

    def completion_of(self, invoke: Op) -> Optional[Op]:
        """The next event from invoke's process after invoke's position in
        THIS history (located by identity, so it works on unindexed or
        filtered histories whose :index fields are stale)."""
        seen_invoke = False
        for op in self:
            if op is invoke:
                seen_invoke = True
                continue
            if seen_invoke and op.process == invoke.process:
                return op
        return None

    # -- transformations ---------------------------------------------------

    def complete(self) -> "History":
        """Propagate completion values back onto invocations (and invoke
        values forward onto completions that lack one).  Knossos-style
        'complete': an ok read's observed value appears on both events.
        """
        h = History(op.copy() for op in self)
        pair = self.pair_index()
        for i, op in enumerate(h):
            if op.type != INVOKE:
                continue
            j = pair[i]
            if j < 0:
                continue
            comp = h[j]
            if comp.type == OK:
                if comp.value is None:
                    comp.value = op.value
                else:
                    op.value = comp.value
        return h

    def map(self, fn: Callable[[Op], Op]) -> "History":
        return History(fn(op) for op in self)

    def without_failures(self) -> "History":
        """Drop fail completions and their invocations (a failed op never
        took effect — reference semantics)."""
        pair = self.pair_index()
        dropped = set()
        for i, op in enumerate(self):
            if op.type == FAIL:
                dropped.add(i)
                if pair[i] >= 0:
                    dropped.add(pair[i])
        return History(op for i, op in enumerate(self) if i not in dropped)

    def to_dicts(self) -> list:
        return [op.to_dict() for op in self]

    @staticmethod
    def from_dicts(dicts: Iterable[dict]) -> "History":
        return History(Op.from_dict(d) for d in dicts)


def strip_indeterminate_reads(history: History, pure_fs: Iterable[Any]) -> History:
    """Drop ``info`` (indeterminate) ops whose :f is a pure read — a crashed
    read can always linearize (it observed *some* value) and never changes
    state, so removing it shrinks the search space without changing the
    verdict.  Standard Knossos-style preprocessing optimization.
    """
    pure = set(pure_fs)
    pair = history.pair_index()
    dropped = set()
    for i, op in enumerate(history):
        if op.type == INFO and op.f in pure:
            dropped.add(i)
            if pair[i] >= 0:
                dropped.add(pair[i])
    return History(op for i, op in enumerate(history) if i not in dropped)
