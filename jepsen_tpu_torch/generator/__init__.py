"""Pure-functional operation-scheduling DSL.

A *generator* is an immutable value that produces operations for worker
threads on demand (reference: jepsen/src/jepsen/generator.clj:382-390):

- ``op(gen, test, ctx)``   → ``(op, gen')`` | ``(PENDING, gen)`` | ``None``
- ``update(gen, test, ctx, event)`` → ``gen'`` — the generator's view of an
  event (invocation or completion) having happened.

Operations inside the DSL are plain dicts (``{"f": "write", "value": 1}``);
``fill_in_op`` assigns :type/:process/:time from the context.  Special op
types "sleep" and "log" instruct the worker rather than the client.  The
interpreter converts dicts to history Ops at the recording boundary.

Plain values lift into generators: ``None`` (exhausted), a dict (emit once,
filled from context), a callable (called — with (test, ctx) if it accepts
args — until it returns None), a list/tuple (run each element in turn).

Randomness goes through this module's ``rng`` so tests and the simulator
can pin seeds (the reference pins 45100, generator/test.clj:44-48).

Combinator inventory mirrors generator.clj:775-1593.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..history import NEMESIS

PENDING = "pending"

#: Module RNG; reseedable for deterministic tests.
rng = random.Random()


def set_seed(seed: Optional[int]) -> None:
    global rng
    rng = random.Random(seed)


def secs_to_nanos(s: float) -> int:
    return int(s * 1_000_000_000)


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


def context(test: dict) -> dict:
    """Initial context: nemesis + `concurrency` numeric worker threads,
    each thread running the process of the same name.
    (reference: generator.clj:453-464)"""
    threads = [NEMESIS] + list(range(test.get("concurrency", 1)))
    return {
        "time": 0,
        "free_threads": tuple(threads),
        "workers": {t: t for t in threads},
    }


def free_processes(ctx: dict) -> List[Any]:
    w = ctx["workers"]
    return [w[t] for t in ctx["free_threads"]]


def some_free_process(ctx: dict) -> Optional[Any]:
    """A uniformly random free process (fair scheduling — see the
    reference's bifurcan-Set discussion, generator.clj:438-449)."""
    free = ctx["free_threads"]
    if not free:
        return None
    return ctx["workers"][free[rng.randrange(len(free))]]


def all_processes(ctx: dict) -> List[Any]:
    return list(ctx["workers"].values())


def free_threads(ctx: dict) -> Tuple:
    return ctx["free_threads"]


def all_threads(ctx: dict) -> List[Any]:
    return list(ctx["workers"].keys())


def process_to_thread(ctx: dict, process: Any) -> Optional[Any]:
    for t, p in ctx["workers"].items():
        if p == process:
            return t
    return None


def thread_to_process(ctx: dict, thread: Any) -> Any:
    return ctx["workers"].get(thread)


def next_process(ctx: dict, thread: Any) -> Any:
    """The replacement process id for a crashed thread (global context
    only).  (reference: generator.clj:519-527)"""
    if isinstance(thread, int):
        return ctx["workers"][thread] + len(
            [p for p in all_processes(ctx) if isinstance(p, int)]
        )
    return thread


def on_threads_context(pred: Callable[[Any], bool], ctx: dict) -> dict:
    """Restrict a context to threads satisfying pred.
    (reference: generator.clj:844-862)"""
    return {
        "time": ctx["time"],
        "free_threads": tuple(t for t in ctx["free_threads"] if pred(t)),
        "workers": {t: p for t, p in ctx["workers"].items() if pred(t)},
    }


# ---------------------------------------------------------------------------
# Protocol dispatch
# ---------------------------------------------------------------------------


class Generator:
    """Base class for combinator generators."""

    def op(self, test: dict, ctx: dict):
        raise NotImplementedError

    def update(self, test: dict, ctx: dict, event: dict) -> "Generator":
        return self


def _fn_arity_accepts_args(f: Callable) -> bool:
    try:
        import inspect

        sig = inspect.signature(f)
        required = [
            p
            for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.default is p.empty
        ]
        return len(required) == 2
    except (ValueError, TypeError):
        return False


def op(gen: Any, test: dict, ctx: dict):
    """Ask a (possibly-lifted) generator for an operation.
    (reference: generator.clj:545-590 base impls)"""
    while True:
        if gen is None:
            return None
        if isinstance(gen, Generator):
            return gen.op(test, ctx)
        if isinstance(gen, dict):
            filled = fill_in_op(gen, ctx)
            return (filled, gen if filled == PENDING else None)
        if callable(gen):
            x = gen(test, ctx) if _fn_arity_accepts_args(gen) else gen()
            if x is None:
                return None
            return op([x, gen], test, ctx)
        if isinstance(gen, (list, tuple)):
            if not gen:
                return None
            head, rest = gen[0], list(gen[1:])
            res = op(head, test, ctx)
            if res is None:
                gen = rest
                continue
            o, g2 = res
            return (o, ([g2] + rest) if rest else g2)
        raise TypeError(f"not a generator: {gen!r}")


def update(gen: Any, test: dict, ctx: dict, event: dict):
    """Inform a generator of an event.  (reference: generator.clj base
    impls; sequences pass updates to their first element)"""
    if gen is None:
        return None
    if isinstance(gen, Generator):
        return gen.update(test, ctx, event)
    if isinstance(gen, dict) or callable(gen):
        return gen
    if isinstance(gen, (list, tuple)):
        if not gen:
            return None
        return [update(gen[0], test, ctx, event)] + list(gen[1:])
    raise TypeError(f"not a generator: {gen!r}")


def fill_in_op(o: dict, ctx: dict):
    """Fill :type/:process/:time from context; PENDING if no process is
    free.  (reference: generator.clj:531-543)"""
    p = some_free_process(ctx)
    if p is None:
        return PENDING
    out = dict(o)
    out.setdefault("time", ctx["time"])
    out.setdefault("process", p)
    out.setdefault("type", "invoke")
    return out


# ---------------------------------------------------------------------------
# Validation / debugging wrappers
# ---------------------------------------------------------------------------


class InvalidOp(Exception):
    def __init__(self, problems, res, gen, ctx):
        super().__init__(
            "Generator produced an invalid [op, gen'] tuple: "
            + "; ".join(problems)
            + f"\nresult: {res!r}\ncontext: {ctx!r}"
        )
        self.problems = problems


class Validate(Generator):
    """(reference: generator.clj:622-676)"""

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        problems = []
        if not (isinstance(res, tuple) and len(res) == 2):
            problems.append("should return a tuple of two elements")
        else:
            o, _ = res
            if o != PENDING:
                if not isinstance(o, dict):
                    problems.append("should be either PENDING or a dict")
                else:
                    if o.get("type") not in ("invoke", "info", "sleep", "log"):
                        problems.append(
                            ":type should be invoke, info, sleep, or log"
                        )
                    if not isinstance(o.get("time"), (int, float)):
                        problems.append(":time should be a number")
                    if o.get("process") is None:
                        problems.append("no :process")
                    elif o["process"] not in free_processes(ctx):
                        problems.append(
                            f"process {o['process']!r} is not free"
                        )
        if problems:
            raise InvalidOp(problems, res, self.gen, ctx)
        return (res[0], Validate(res[1]))

    def update(self, test, ctx, event):
        return Validate(update(self.gen, test, ctx, event))


def validate(gen):
    return Validate(gen)


class FriendlyExceptions(Generator):
    """(reference: generator.clj:678-718)"""

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        try:
            res = op(self.gen, test, ctx)
        except Exception as e:
            raise RuntimeError(
                f"Generator raised {type(e).__name__} when asked for an "
                f"operation.\nGenerator: {self.gen!r}\nContext: {ctx!r}"
            ) from e
        if res is None:
            return None
        return (res[0], FriendlyExceptions(res[1]))

    def update(self, test, ctx, event):
        try:
            g2 = update(self.gen, test, ctx, event)
        except Exception as e:
            raise RuntimeError(
                f"Generator raised {type(e).__name__} when updated with "
                f"{event!r}.\nGenerator: {self.gen!r}\nContext: {ctx!r}"
            ) from e
        return FriendlyExceptions(g2) if g2 is not None else None


def friendly_exceptions(gen):
    return FriendlyExceptions(gen)


class Trace(Generator):
    """Log every op/update through this generator.
    (reference: generator.clj:720-763)"""

    def __init__(self, k, gen, logger=None):
        import logging

        self.k = k
        self.gen = gen
        self.logger = logger or logging.getLogger(__name__)

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        self.logger.info("%s op ctx=%r -> %r", self.k, ctx, res and res[0])
        if res is None:
            return None
        return (res[0], Trace(self.k, res[1], self.logger))

    def update(self, test, ctx, event):
        self.logger.info("%s update event=%r", self.k, event)
        g2 = update(self.gen, test, ctx, event)
        return Trace(self.k, g2, self.logger) if g2 is not None else None


def trace(k, gen):
    return Trace(k, gen)


# ---------------------------------------------------------------------------
# Transformations
# ---------------------------------------------------------------------------


def concat(*gens):
    """Run each generator to exhaustion, in order.
    (reference: generator.clj:775-780)"""
    return list(gens)


class Map(Generator):
    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        return (o if o == PENDING else self.f(o), Map(self.f, g2))

    def update(self, test, ctx, event):
        return Map(self.f, update(self.gen, test, ctx, event))


def map(f, gen):  # noqa: A001 — mirrors gen/map
    """Transform every op with f.  (reference: generator.clj:782-788)"""
    return Map(f, gen)


def f_map(fm: Dict[Any, Any], gen):
    """Rewrite op :f values through the mapping fm (for composed
    nemeses).  (reference: generator.clj:790-796)"""
    return Map(lambda o: {**o, "f": fm.get(o.get("f"), o.get("f"))}, gen)


class Filter(Generator):
    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        gen = self.gen
        while True:
            res = op(gen, test, ctx)
            if res is None:
                return None
            o, g2 = res
            if o == PENDING or self.f(o):
                return (o, Filter(self.f, g2))
            gen = g2

    def update(self, test, ctx, event):
        return Filter(self.f, update(self.gen, test, ctx, event))


def filter(f, gen):  # noqa: A001 — mirrors gen/filter
    """Pass through only ops satisfying f.
    (reference: generator.clj:798-817)"""
    return Filter(f, gen)


class IgnoreUpdates(Generator):
    """Note: unlike the reference's (internal, unconstructed) record of
    the same name, this preserves itself across op calls so updates stay
    blocked for the generator's whole lifetime."""

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        return (res[0], IgnoreUpdates(res[1]))

    def update(self, test, ctx, event):
        return self


def ignore_updates(gen):
    return IgnoreUpdates(gen)


class OnUpdate(Generator):
    """(reference: generator.clj:827-842)"""

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        return (res[0], OnUpdate(self.f, res[1]))

    def update(self, test, ctx, event):
        return self.f(self, test, ctx, event)


def on_update(f, gen):
    return OnUpdate(f, gen)


class OnThreads(Generator):
    """(reference: generator.clj:864-881)"""

    def __init__(self, pred, gen):
        self.pred = pred
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, on_threads_context(self.pred, ctx))
        if res is None:
            return None
        return (res[0], OnThreads(self.pred, res[1]))

    def update(self, test, ctx, event):
        if self.pred(process_to_thread(ctx, event.get("process"))):
            g2 = update(
                self.gen, test, on_threads_context(self.pred, ctx), event
            )
            return OnThreads(self.pred, g2)
        return self


def on_threads(pred, gen):
    return OnThreads(pred, gen)


on = on_threads


def soonest_op_map(m1: Optional[dict], m2: Optional[dict]) -> Optional[dict]:
    """Pick whichever wrapped op occurs sooner; ties resolve randomly in
    proportion to :weight.  (reference: generator.clj:885-927)"""
    if m1 is None:
        return m2
    if m2 is None:
        return m1
    op1, op2 = m1["op"], m2["op"]
    if op1 == PENDING:
        return m2
    if op2 == PENDING:
        return m1
    t1, t2 = op1["time"], op2["time"]
    if t1 == t2:
        w1 = m1.get("weight", 1)
        w2 = m2.get("weight", 1)
        w = w1 + w2
        chosen = m1 if rng.randrange(w) < w1 else m2
        return {**chosen, "weight": w}
    return m1 if t1 < t2 else m2


class Any(Generator):
    """(reference: generator.clj:929-944)"""

    def __init__(self, gens):
        self.gens = list(gens)

    def op(self, test, ctx):
        soonest = None
        for i, g in enumerate(self.gens):
            res = op(g, test, ctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1], "i": i}
                )
        if soonest is None:
            return None
        gens = list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return (soonest["op"], Any(gens))

    def update(self, test, ctx, event):
        return Any([update(g, test, ctx, event) for g in self.gens])


def any(*gens):  # noqa: A001 — mirrors gen/any
    if len(gens) == 0:
        return None
    if len(gens) == 1:
        return gens[0]
    return Any(gens)


class EachThread(Generator):
    """Independent copy of the generator per thread.
    (reference: generator.clj:955-1007)"""

    def __init__(self, fresh_gen, gens: Dict[Any, Any]):
        self.fresh_gen = fresh_gen
        self.gens = gens

    def op(self, test, ctx):
        free = free_threads(ctx)
        all_t = all_threads(ctx)
        soonest = None
        for thread in free:
            g = self.gens.get(thread, self.fresh_gen)
            process = ctx["workers"][thread]
            sub_ctx = {
                "time": ctx["time"],
                "free_threads": (thread,),
                "workers": {thread: process},
            }
            res = op(g, test, sub_ctx)
            if res is not None:
                soonest = soonest_op_map(
                    soonest, {"op": res[0], "gen": res[1], "thread": thread}
                )
        if soonest is not None:
            gens = dict(self.gens)
            gens[soonest["thread"]] = soonest["gen"]
            return (soonest["op"], EachThread(self.fresh_gen, gens))
        if len(free) != len(all_t):
            return (PENDING, self)
        return None  # every thread exhausted

    def update(self, test, ctx, event):
        thread = process_to_thread(ctx, event.get("process"))
        if thread is None:
            return self
        g = self.gens.get(thread, self.fresh_gen)
        sub_ctx = {
            "time": ctx["time"],
            "free_threads": tuple(
                t for t in ctx["free_threads"] if t == thread
            ),
            "workers": {thread: event.get("process")},
        }
        g2 = update(g, test, sub_ctx, event)
        gens = dict(self.gens)
        gens[thread] = g2
        return EachThread(self.fresh_gen, gens)


def each_thread(gen):
    return EachThread(gen, {})


class Reserve(Generator):
    """(reference: generator.clj:1009-1089)"""

    def __init__(self, ranges: List[set], gens: List[Any]):
        self.ranges = ranges  # list of thread-sets; gens has one extra
        self.all_ranges = set().union(*ranges) if ranges else set()
        self.gens = gens

    def op(self, test, ctx):
        soonest = None
        for i, threads in enumerate(self.ranges):
            sub = on_threads_context(lambda t, s=threads: t in s, ctx)
            res = op(self.gens[i], test, sub)
            if res is not None:
                soonest = soonest_op_map(
                    soonest,
                    {
                        "op": res[0],
                        "gen": res[1],
                        "weight": len(threads),
                        "i": i,
                    },
                )
        default_ctx = on_threads_context(
            lambda t: t not in self.all_ranges, ctx
        )
        res = op(self.gens[-1], test, default_ctx)
        if res is not None:
            soonest = soonest_op_map(
                soonest,
                {
                    "op": res[0],
                    "gen": res[1],
                    "weight": len(default_ctx["workers"]),
                    "i": len(self.ranges),
                },
            )
        if soonest is None:
            return None
        gens = list(self.gens)
        gens[soonest["i"]] = soonest["gen"]
        return (soonest["op"], Reserve(self.ranges, gens))

    def update(self, test, ctx, event):
        thread = process_to_thread(ctx, event.get("process"))
        i = len(self.ranges)
        for j, r in enumerate(self.ranges):
            if thread in r:
                i = j
                break
        gens = list(self.gens)
        gens[i] = update(gens[i], test, ctx, event)
        return Reserve(self.ranges, gens)


def reserve(*args):
    """(reserve 5, write_gen, 10, cas_gen, default_gen): thread ranges per
    generator plus a default for the rest."""
    if not args:
        raise ValueError("reserve needs a default generator")
    *pairs, default = args
    if len(pairs) % 2 != 0:
        raise ValueError("reserve takes count/generator pairs + default")
    ranges = []
    gens = []
    n = 0
    for i in range(0, len(pairs), 2):
        count, gen = pairs[i], pairs[i + 1]
        ranges.append(set(range(n, n + count)))
        gens.append(gen)
        n += count
    gens.append(default)
    return Reserve(ranges, gens)


def clients(client_gen, nemesis_gen=None):
    """Restrict to client threads; two-arity combines client + nemesis
    generators.  (reference: generator.clj:1093-1103)"""
    if nemesis_gen is None:
        return on_threads(lambda t: t != NEMESIS, client_gen)
    return any(clients(client_gen), nemesis(nemesis_gen))


def nemesis(nemesis_gen, client_gen=None):
    """(reference: generator.clj:1105-1115)"""
    if client_gen is None:
        return on_threads(lambda t: t == NEMESIS, nemesis_gen)
    return any(nemesis(nemesis_gen), clients(client_gen))


class Mix(Generator):
    """The next-index draw happens lazily at op time (not construction)
    so seeding the module rng after building a test still yields
    deterministic schedules.  (reference: generator.clj:1124-1154)"""

    def __init__(self, i, gens):
        self.i = i  # None = not yet drawn
        self.gens = list(gens)

    def op(self, test, ctx):
        if not self.gens:
            return None
        i = self.i if self.i is not None else rng.randrange(len(self.gens))
        res = op(self.gens[i], test, ctx)
        if res is not None:
            gens = list(self.gens)
            gens[i] = res[1]
            return (res[0], Mix(rng.randrange(len(gens)), gens))
        gens = list(self.gens)
        del gens[i]
        if not gens:
            return None
        return Mix(None, gens).op(test, ctx)

    def update(self, test, ctx, event):
        return self


def mix(gens):
    gens = list(gens)
    if not gens:
        return None
    return Mix(None, gens)


class Limit(Generator):
    def __init__(self, remaining, gen):
        self.remaining = remaining
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining <= 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o == PENDING:
            return (o, Limit(self.remaining, g2))
        return (o, Limit(self.remaining - 1, g2))

    def update(self, test, ctx, event):
        return Limit(self.remaining, update(self.gen, test, ctx, event))


def limit(remaining, gen):
    """At most `remaining` operations.  (reference: generator.clj:1156-1170)"""
    return Limit(remaining, gen)


def once(gen):
    return limit(1, gen)


def log(msg):
    """A one-shot op instructing the worker to log a message.
    (reference: generator.clj:1177-1181)"""
    return {"type": "log", "value": msg}


class Repeat(Generator):
    """Emit ops from an unchanging generator forever (or `remaining`
    times).  (reference: generator.clj:1183-1210)"""

    def __init__(self, remaining, gen):
        self.remaining = remaining  # -1 = infinite
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining == 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, _ = res
        if o == PENDING:
            return (o, self)
        return (o, Repeat(self.remaining - 1, self.gen))

    def update(self, test, ctx, event):
        return Repeat(self.remaining, update(self.gen, test, ctx, event))


def repeat(*args):
    if len(args) == 1:
        return Repeat(-1, args[0])
    n, gen = args
    if n < 0:
        raise ValueError("repeat limit must be non-negative")
    return Repeat(n, gen)


class Cycle(Generator):
    """Re-run a finite generator when it exhausts.
    (reference: generator.clj:1212-1238)"""

    def __init__(self, remaining, original_gen, gen):
        self.remaining = remaining
        self.original_gen = original_gen
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining == 0:
            return None
        res = op(self.gen, test, ctx)
        if res is not None:
            return (res[0], Cycle(self.remaining, self.original_gen, res[1]))
        return Cycle(
            self.remaining - 1, self.original_gen, self.original_gen
        ).op(test, ctx)

    def update(self, test, ctx, event):
        return Cycle(
            self.remaining,
            self.original_gen,
            update(self.gen, test, ctx, event),
        )


def cycle(*args):
    if len(args) == 1:
        return Cycle(-1, args[0], args[0])
    n, gen = args
    return Cycle(n, gen, gen)


class ProcessLimit(Generator):
    """(reference: generator.clj:1240-1265)"""

    def __init__(self, n, procs: frozenset, gen):
        self.n = n
        self.procs = procs
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o == PENDING:
            return (o, ProcessLimit(self.n, self.procs, g2))
        procs = self.procs | frozenset(all_processes(ctx))
        if len(procs) <= self.n:
            return (o, ProcessLimit(self.n, procs, g2))
        return None

    def update(self, test, ctx, event):
        return ProcessLimit(
            self.n, self.procs, update(self.gen, test, ctx, event)
        )


def process_limit(n, gen):
    return ProcessLimit(n, frozenset(), gen)


class TimeLimit(Generator):
    """(reference: generator.clj:1267-1291)"""

    def __init__(self, limit_nanos, cutoff, gen):
        self.limit = limit_nanos
        self.cutoff = cutoff
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o == PENDING:
            return (o, TimeLimit(self.limit, self.cutoff, g2))
        cutoff = self.cutoff if self.cutoff is not None else o["time"] + self.limit
        if o["time"] < cutoff:
            return (o, TimeLimit(self.limit, cutoff, g2))
        return None

    def update(self, test, ctx, event):
        return TimeLimit(
            self.limit, self.cutoff, update(self.gen, test, ctx, event)
        )


def time_limit(dt_seconds, gen):
    return TimeLimit(secs_to_nanos(dt_seconds), None, gen)


class Stagger(Generator):
    """Uniformly-random inter-op delays, global across threads.
    (reference: generator.clj:1293-1330)"""

    def __init__(self, dt, next_time, gen):
        self.dt = dt
        self.next_time = next_time
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o == PENDING:
            return (o, self)
        next_time = self.next_time if self.next_time is not None else ctx["time"]
        jitter = int(rng.random() * self.dt)
        if next_time <= o["time"]:
            return (o, Stagger(self.dt, o["time"] + jitter, g2))
        o = {**o, "time": next_time}
        return (o, Stagger(self.dt, next_time + jitter, g2))

    def update(self, test, ctx, event):
        return Stagger(
            self.dt, self.next_time, update(self.gen, test, ctx, event)
        )


def stagger(dt_seconds, gen):
    """Ops roughly every dt seconds (delays uniform in [0, 2dt)), across
    all threads together."""
    return Stagger(secs_to_nanos(2 * dt_seconds), None, gen)


class Delay(Generator):
    """Ops exactly dt apart (catching up if behind).
    (reference: generator.clj:1369-1395)"""

    def __init__(self, dt, next_time, gen):
        self.dt = dt
        self.next_time = next_time
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o == PENDING:
            return (o, Delay(self.dt, self.next_time, g2))
        next_time = self.next_time if self.next_time is not None else o["time"]
        o = {**o, "time": max(o["time"], next_time)}
        return (o, Delay(self.dt, o["time"] + self.dt, g2))

    def update(self, test, ctx, event):
        return Delay(self.dt, self.next_time, update(self.gen, test, ctx, event))


def delay(dt_seconds, gen):
    return Delay(secs_to_nanos(dt_seconds), None, gen)


def sleep(dt_seconds):
    """One special op making its process do nothing for dt seconds.
    (reference: generator.clj:1397-1401)"""
    return {"type": "sleep", "value": dt_seconds}


class Synchronize(Generator):
    """Wait for all workers to be free, then become the inner generator.
    (reference: generator.clj:1403-1423)"""

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        free = free_threads(ctx)
        allt = all_threads(ctx)
        if len(free) == len(allt) and set(free) == set(allt):
            return op(self.gen, test, ctx)
        return (PENDING, self)

    def update(self, test, ctx, event):
        return Synchronize(update(self.gen, test, ctx, event))


def synchronize(gen):
    return Synchronize(gen)


def phases(*gens):
    """Each generator runs to completion, with a barrier between.
    (reference: generator.clj:1425-1430)"""
    return [synchronize(g) for g in gens]


def then(a, b):
    """b, then (synchronize a). Argument order reads well in pipelines.
    (reference: generator.clj:1432-1441)"""
    return [b, synchronize(a)]


class UntilOk(Generator):
    """(reference: generator.clj:1443-1473)"""

    def __init__(self, gen, done, active_processes: frozenset):
        self.gen = gen
        self.done = done
        self.active = active_processes

    def op(self, test, ctx):
        if self.done:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o == PENDING:
            return (o, UntilOk(g2, self.done, self.active))
        return (o, UntilOk(g2, self.done, self.active | {o.get("process")}))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        p = event.get("process")
        if p in self.active:
            t = event.get("type")
            if t == "ok":
                return UntilOk(g2, True, self.active - {p})
            if t in ("info", "fail"):
                return UntilOk(g2, self.done, self.active - {p})
        return UntilOk(g2, self.done, self.active)


def until_ok(gen):
    return UntilOk(gen, False, frozenset())


class FlipFlop(Generator):
    """(reference: generator.clj:1475-1489)"""

    def __init__(self, gens, i):
        self.gens = list(gens)
        self.i = i

    def op(self, test, ctx):
        res = op(self.gens[self.i], test, ctx)
        if res is None:
            return None
        gens = list(self.gens)
        gens[self.i] = res[1]
        return (res[0], FlipFlop(gens, (self.i + 1) % len(gens)))

    def update(self, test, ctx, event):
        return self


def flip_flop(a, b):
    return FlipFlop([a, b], 0)


class CycleTimes(Generator):
    """Rotate between generators on a time schedule.
    (reference: generator.clj:1491-1581)"""

    def __init__(self, period, t0, intervals, cutoffs, gens):
        self.period = period
        self.t0 = t0
        self.intervals = intervals
        self.cutoffs = cutoffs
        self.gens = list(gens)

    def op(self, test, ctx):
        now = ctx["time"]
        t0 = self.t0 if self.t0 is not None else now
        in_period = (now - t0) % self.period
        cycle_start = now - in_period
        i = 0
        while i < len(self.cutoffs) and in_period >= self.cutoffs[i]:
            i += 1
        if i == len(self.gens):
            i = 0
        t = cycle_start + sum(self.intervals[:i])
        for _ in range(100_000):  # guard against pathological inner gens
            gen = self.gens[i]
            interval = self.intervals[i]
            t_end = t + interval
            res = op(gen, test, {**ctx, "time": max(now, t)})
            if res is None:
                return None
            o, g2 = res
            gens = list(self.gens)
            gens[i] = g2
            nxt = CycleTimes(self.period, t0, self.intervals, self.cutoffs, gens)
            if o == PENDING:
                return (PENDING, nxt)
            if o["time"] < t_end:
                return (o, nxt)
            # op falls after this window; try the next generator's window
            i = (i + 1) % len(self.gens)
            t = t_end
        raise RuntimeError("cycle_times could not place an op in any window")

    def update(self, test, ctx, event):
        return CycleTimes(
            self.period,
            self.t0,
            self.intervals,
            self.cutoffs,
            [update(g, test, ctx, event) for g in self.gens],
        )


def cycle_times(*specs):
    """cycle_times(5, gen_a, 10, gen_b): a for 5s, b for 10s, repeat."""
    if not specs:
        return None
    if len(specs) % 2 != 0:
        raise ValueError("cycle_times takes duration/generator pairs")
    intervals = [secs_to_nanos(specs[i]) for i in range(0, len(specs), 2)]
    gens = [specs[i] for i in range(1, len(specs), 2)]
    period = sum(intervals)
    cutoffs = []
    acc = 0
    for iv in intervals:
        acc += iv
        cutoffs.append(acc)
    return CycleTimes(period, None, intervals, cutoffs[:-1], gens)
