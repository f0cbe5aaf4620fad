"""Deterministic generator simulation — the fake scheduler used to unit
test generators without threads or wall clocks.

(reference: jepsen/src/jepsen/generator/test.clj:50-182; fixed seed 45100
per :44-48)
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..history import NEMESIS
from . import (
    PENDING,
    context as make_context,
    next_process,
    op as gen_op,
    process_to_thread,
    set_seed,
    update as gen_update,
    validate,
)

RAND_SEED = 45100

DEFAULT_TEST: dict = {}

PERFECT_LATENCY = 10  # nanoseconds


def n_plus_nemesis_context(n: int) -> dict:
    return make_context({"concurrency": n})


def default_context() -> dict:
    return n_plus_nemesis_context(2)


def simulate(
    gen,
    complete_fn: Callable[[dict, dict], dict],
    ctx: Optional[dict] = None,
    test: Optional[dict] = None,
    seed: int = RAND_SEED,
) -> List[dict]:
    """Run a generator against a virtual-time scheduler; complete_fn maps
    (ctx, invocation) to its completion op.  Returns the full history of
    op dicts.  (reference: generator/test.clj:50-108)"""
    set_seed(seed)
    ctx = dict(ctx or default_context())
    test = test if test is not None else DEFAULT_TEST
    ops: List[dict] = []
    in_flight: List[dict] = []  # sorted by time
    gen = validate(gen)

    while True:
        res = gen_op(gen, test, ctx)
        if res is None:
            return ops + in_flight
        invoke, gen2 = res

        if invoke != PENDING and (
            not in_flight or invoke["time"] <= in_flight[0]["time"]
        ):
            # invocation happens before every in-flight completion
            thread = process_to_thread(ctx, invoke["process"])
            ctx = {
                **ctx,
                "time": max(ctx["time"], invoke["time"]),
                "free_threads": tuple(
                    t for t in ctx["free_threads"] if t != thread
                ),
            }
            gen2 = gen_update(gen2, test, ctx, invoke)
            complete = complete_fn(ctx, invoke)
            in_flight = sorted(in_flight + [complete], key=lambda o: o["time"])
            ops.append(invoke)
            gen = gen2
        else:
            # must complete something first
            if not in_flight:
                raise AssertionError(
                    "generator pending and nothing in flight???"
                )
            done = in_flight[0]
            thread = process_to_thread(ctx, done["process"])
            ctx = {
                **ctx,
                "time": max(ctx["time"], done["time"]),
                "free_threads": tuple(ctx["free_threads"]) + (thread,),
            }
            # NOTE: gen (not gen2) — a pending op result doesn't advance
            # the generator (reference: generator/test.clj:102 updates
            # `gen`, the pre-op generator)
            gen = gen_update(gen, test, ctx, done)
            if thread != NEMESIS and done.get("type") == "info":
                workers = dict(ctx["workers"])
                workers[thread] = next_process(ctx, thread)
                ctx = {**ctx, "workers": workers}
            ops.append(done)
            in_flight = in_flight[1:]


def invocations(history: List[dict]) -> List[dict]:
    return [o for o in history if o.get("type") == "invoke"]


def quick_ops(gen, ctx=None, test=None) -> List[dict]:
    """Every op completes perfectly, instantly, zero latency.
    (reference: generator/test.clj:110-117)"""
    return simulate(
        gen, lambda ctx, inv: {**inv, "type": "ok"}, ctx=ctx, test=test
    )


def quick(gen, ctx=None, test=None) -> List[dict]:
    return invocations(quick_ops(gen, ctx, test))


def perfect_star(gen, ctx=None, test=None) -> List[dict]:
    """Ops succeed after 10ns; full history.
    (reference: generator/test.clj:130-141)"""
    return simulate(
        gen,
        lambda ctx, inv: {
            **inv,
            "type": "ok",
            "time": inv["time"] + PERFECT_LATENCY,
        },
        ctx=ctx,
        test=test,
    )


def perfect(gen, ctx=None, test=None) -> List[dict]:
    return invocations(perfect_star(gen, ctx, test))


def perfect_info(gen, ctx=None, test=None) -> List[dict]:
    """Every op crashes after 10ns; invocations only.
    (reference: generator/test.clj:152-163)"""
    return invocations(
        simulate(
            gen,
            lambda ctx, inv: {
                **inv,
                "type": "info",
                "time": inv["time"] + PERFECT_LATENCY,
            },
            ctx=ctx,
            test=test,
        )
    )


def imperfect(gen, ctx=None, test=None) -> List[dict]:
    """Threads cycle fail → info → ok; full history.
    (reference: generator/test.clj:165-182)"""
    state: dict = {}
    transitions = {None: "fail", "fail": "info", "info": "ok", "ok": "fail"}

    def complete(ctx, inv):
        t = process_to_thread(ctx, inv["process"])
        state[t] = transitions[state.get(t)]
        return {**inv, "type": state[t], "time": inv["time"] + PERFECT_LATENCY}

    return simulate(gen, complete, ctx=ctx, test=test)
