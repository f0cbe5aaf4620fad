"""Linearizability over a set of independent CAS registers — the flagship
workload of the TPU analysis plane.

Clients understand three functions over ``[k, v]`` tuple values:

    {"type": "invoke", "f": "write", "value": [k, v]}
    {"type": "invoke", "f": "read",  "value": [k, None]}
    {"type": "invoke", "f": "cas",   "value": [k, [v, v2]]}

(reference: jepsen/src/jepsen/tests/linearizable_register.clj)

Two checker lifts are offered: the classic per-key lift
(independent.checker over checker.linearizable, which itself dispatches to
the device per history) and — by default — the batched lift
(independent.batched_linearizable), which checks the entire keyspace in
one ``check_batch`` run: every key within the dense envelope on the dense
subset automaton, the rest on the frontier search.  ``opts["device"]``
goes to both lifts (None: the current CUDA device; ``"cpu"``: the plain
PyTorch versions).
"""

from __future__ import annotations

from typing import Optional

from .. import checker as checker_mod
from .. import generator as gen
from .. import independent
from .. import models
from ..checker import timeline


def w(test, ctx):
    return {"type": "invoke", "f": "write", "value": gen.rng.randrange(5)}


def r(test, ctx):
    return {"type": "invoke", "f": "read"}


def cas(test, ctx):
    return {
        "type": "invoke",
        "f": "cas",
        "value": [gen.rng.randrange(5), gen.rng.randrange(5)],
    }


def _steer_group_size(threads: int, nodes: int, max_c: int):
    """(group, threads): the largest per-key thread-group size ≤
    min(2·nodes, the dense kernel's slot envelope) that divides the
    worker count — shrinking the worker count itself when no
    non-trivial divisor fits (prime concurrency), because degrading to
    1-thread groups would make every per-key history sequential and the
    linearizability check vacuous.

    This is the dense-envelope steering: the reference keeps per-key
    histories tractable for knossos by bounding threads-per-key and the
    per-key process budget (linearizable_register.clj:40-52); here the
    same levers keep per-key peak open-op slots ≤ dense.MAX_C so the
    whole keyspace rides the overflow-free dense subset-automaton
    kernel instead of drifting onto the capacity-bound frontier
    kernel."""
    cap = max(1, min(2 * nodes, max_c))
    for g in range(min(cap, threads), 1, -1):
        if threads % g == 0:
            return g, threads
    g = min(cap, threads)
    return g, g * max(1, threads // g)


def test(opts: Optional[dict] = None) -> dict:
    """A partial test (generator, model, checker); bring a client.
    Options: ``nodes``, ``model``, ``per-key-limit``, ``process-limit``,
    ``concurrency`` (int or "3n"-style), ``batched?`` (default True —
    one device dispatch for all keys), ``steer?`` (default True).

    With ``steer?`` the workload sizes its per-key thread groups and
    the default process budget to the dense kernel's envelope
    (ops.dense.MAX_C): every retired (crashed) process can leave one
    permanently-open op, and group size bounds concurrently-live ops,
    so process-limit ≤ MAX_C guarantees per-key open-op slots ≤ MAX_C —
    the batch then reports kernel=dense in wgl.batch_stats regardless
    of "3n"-scale total concurrency.  The device analogue of the
    reference's per-key tractability design
    (linearizable_register.clj:40-52).  ``device`` picks where the
    check runs, as above."""
    opts = opts or {}
    n = len(opts.get("nodes", ["n1"]))
    model = opts.get("model", models.cas_register())

    device = opts.get("device")
    if opts.get("batched?", True):
        lin = independent.batched_linearizable(model, device=device)
    else:
        lin = independent.checker(
            checker_mod.linearizable(model, device=device))

    conc = opts.get("concurrency")
    if conc is None:
        threads = 2 * n
    else:
        from ..cli import parse_concurrency

        threads = parse_concurrency(str(conc), n)
    if opts.get("steer?", True):
        from ..ops import dense as dense_mod

        group, threads = _steer_group_size(threads, n, dense_mod.MAX_C)
        default_process_limit = dense_mod.MAX_C
    else:
        group = min(threads, 2 * n)
        if threads % group:
            raise ValueError(
                f"concurrency {threads} is not a multiple of the "
                f"{group}-thread key groups; pass a multiple of {group} "
                "or leave steer? on"
            )
        default_process_limit = 20

    def fgen(k):
        # cas? False for systems exposing only get/set (e.g. raftis)
        mixed = [w, cas, cas] if opts.get("cas?", True) else [w]
        # half the group reads, half mutates (the reference reserves n
        # of its 2n-thread groups for reads); a 1-thread group mixes
        # reads in instead of starving mutations
        readers = group // 2
        if readers:
            g = gen.reserve(readers, r, gen.mix(mixed))
        else:
            g = gen.mix(mixed + [r])
        pkl = opts.get("per-key-limit")
        if pkl:
            # Jitter the limit so keys drift off Significant Event
            # Boundaries over time.  (reference: :45-49)
            g = gen.limit(int((0.9 + gen.rng.random() * 0.1) * pkl) or 1, g)
        return gen.process_limit(
            opts.get("process-limit", default_process_limit), g
        )

    return {
        "checker": checker_mod.compose(
            {"linearizable": lin, "timeline": timeline.html()}
        ),
        "generator": independent.concurrent_generator(
            group, list(range(100_000)), fgen
        ),
        # concurrent-generator runs each key on a `group`-thread group;
        # the test needs at least that many workers (reference:
        # linearizable_register.clj:40-43 via independent.clj:103-121)
        "concurrency": threads,
        "steered-group-size": group,
    }
