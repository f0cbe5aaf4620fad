"""The port's generator DSL against the JAX package's (which does not
import JAX): every combinator ``tests/test_generator.py`` covers, the
keyed generators of ``independent`` and the linearizable-register
workload's generator, each built in both packages and run through each
package's deterministic simulator (``generator.sim``) from the same seed.
The op lists must be equal: every ``rng`` draw comes in the reference's
order."""

import pytest

from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_ind
from jepsen_tpu.generator import sim as ref_sim
from jepsen_tpu.workloads import linearizable_register as ref_lr
from jepsen_tpu_torch import generator as port_gen
from jepsen_tpu_torch import independent as port_ind
from jepsen_tpu_torch.generator import sim as port_sim
from jepsen_tpu_torch.workloads import linearizable_register as port_lr

PACKAGES = {
    "ref": (ref_gen, ref_ind, ref_sim, ref_lr),
    "port": (port_gen, port_ind, port_sim, port_lr),
}


def _fn_gen(gen):
    """A stateful function generator: values 0, 1, 2, … then None."""
    box = {"n": 0}

    def f():
        box["n"] += 1
        return {"f": "w", "value": box["n"]} if box["n"] <= 4 else None

    return f


def _fn_with_args(gen):
    def f(test, ctx):
        return {"f": "read", "value": ctx["time"]}

    return gen.limit(3, f)


def _random_fn(gen):
    # draws from the package's rng inside the op, like the workloads do
    def f(test, ctx):
        return {"f": "w", "value": gen.rng.randrange(100)}

    return gen.limit(12, f)


def _on_update(gen):
    seen = []

    def f(this, test, ctx, event):
        seen.append(event.get("type"))
        return gen.on_update(f, gen.update(this.gen, test, ctx, event))

    return gen.clients(gen.on_update(f, gen.limit(8, gen.until_ok(
        gen.repeat({"f": "w"})))))


#: name → (simulator, context size, builder(gen, ind, lr))
CASES = {
    "nil": ("quick", 2, lambda g, i, lr: None),
    "map-once": ("quick", 2, lambda g, i, lr: {"f": "write", "value": 2}),
    "repeat-saturates": ("perfect", 2,
                         lambda g, i, lr: g.repeat(6, {"f": "write"})),
    "seq-vectors": ("quick", 2, lambda g, i, lr: [
        {"value": 1}, {"value": 2}, {"value": 3}]),
    "seq-nested": ("quick", 2, lambda g, i, lr: [
        [{"value": 1}, {"value": 2}], [[{"value": 3}], {"value": 4}]]),
    "fn": ("quick", 2, lambda g, i, lr: _fn_gen(g)),
    "fn-with-args": ("perfect", 2, lambda g, i, lr: _fn_with_args(g)),
    "fn-random": ("quick", 3, lambda g, i, lr: _random_fn(g)),
    "limit": ("quick", 2, lambda g, i, lr: g.limit(
        2, g.repeat({"f": "write", "value": 1}))),
    "once": ("quick", 2, lambda g, i, lr: g.once(g.repeat({"f": "w"}))),
    "repeat-inner": ("perfect", 2, lambda g, i, lr: g.repeat(
        3, [{"value": 0}, {"value": 1}])),
    "cycle": ("quick", 2, lambda g, i, lr: g.cycle(
        2, [{"value": 1}, {"value": 2}])),
    "delay": ("perfect", 2, lambda g, i, lr: g.limit(
        5, g.delay(3e-9, g.repeat({"f": "write"})))),
    "stagger": ("perfect", 2, lambda g, i, lr: g.limit(
        10, g.stagger(5e-9, g.repeat({"f": "w"})))),
    "phases": ("perfect", 2, lambda g, i, lr: g.phases(
        g.limit(2, g.repeat({"f": "a"})), g.limit(2, g.repeat({"f": "b"})))),
    "then": ("perfect", 2, lambda g, i, lr: g.then(
        g.once({"f": "read"}), g.limit(3, g.repeat({"f": "w"})))),
    "map": ("quick", 2, lambda g, i, lr: g.map(
        lambda o: {**o, "value": 7}, g.limit(2, g.repeat({"f": "w"})))),
    "f-map": ("quick", 2, lambda g, i, lr: g.f_map(
        {"start": "start-partition"}, g.once({"f": "start"}))),
    "filter": ("quick", 2, lambda g, i, lr: g.filter(
        lambda o: o["value"] % 2 == 0,
        [{"value": v} for v in range(8)])),
    "any": ("perfect", 2, lambda g, i, lr: g.limit(6, g.any(
        g.delay(100e-9, g.repeat({"f": "slow"})), g.repeat({"f": "fast"})))),
    "mix": ("quick", 3, lambda g, i, lr: g.limit(40, g.mix(
        [g.repeat({"f": "a"}), g.repeat({"f": "b"}), g.repeat({"f": "c"})]))),
    "mix-exhaustion": ("quick", 2, lambda g, i, lr: g.mix(
        [g.limit(2, g.repeat({"f": "a"})), g.limit(2, g.repeat({"f": "b"}))])),
    "clients-nemesis": ("perfect", 2, lambda g, i, lr: g.limit(6, g.clients(
        g.repeat({"f": "read"}), g.repeat({"f": "break"})))),
    "nemesis": ("perfect", 2, lambda g, i, lr: g.limit(6, g.nemesis(
        g.repeat({"f": "break"}), g.repeat({"f": "read"})))),
    "on-threads": ("perfect", 2, lambda g, i, lr: g.limit(4, g.on_threads(
        lambda t: t == 0, g.repeat({"f": "w"})))),
    "each-thread": ("perfect", 2, lambda g, i, lr: g.each_thread(
        {"f": "meow"})),
    "each-thread-limit": ("perfect", 3, lambda g, i, lr: g.each_thread(
        g.limit(2, g.repeat({"f": "m"})))),
    "reserve": ("perfect", 3, lambda g, i, lr: g.limit(20, g.reserve(
        1, g.repeat({"f": "write"}), g.repeat({"f": "read"})))),
    "reserve-updates": ("perfect_star", 2, lambda g, i, lr: g.limit(
        6, g.reserve(1, g.until_ok(g.repeat({"f": "w"})),
                     g.repeat({"f": "r"})))),
    "process-limit": ("imperfect", 2, lambda g, i, lr: g.process_limit(
        4, g.repeat({"f": "w"}))),
    "time-limit": ("perfect", 2, lambda g, i, lr: g.time_limit(
        25e-9, g.delay(10e-9, g.repeat({"f": "w"})))),
    "until-ok": ("imperfect", 2, lambda g, i, lr: g.clients(
        g.until_ok(g.repeat({"f": "r"})))),
    "flip-flop": ("perfect", 2, lambda g, i, lr: g.limit(6, g.flip_flop(
        g.repeat({"f": "a"}), g.repeat({"f": "b"})))),
    "flip-flop-exhaustion": ("quick", 2, lambda g, i, lr: g.flip_flop(
        g.limit(2, g.repeat({"f": "a"})), g.limit(9, g.repeat({"f": "b"})))),
    "synchronize": ("perfect", 3, lambda g, i, lr: g.phases(
        g.limit(2, g.repeat({"f": "a"})), g.synchronize(g.once({"f": "b"})))),
    "cycle-times": ("perfect", 2, lambda g, i, lr: g.time_limit(100e-9, (
        g.cycle_times(20e-9, g.repeat({"f": "quiet"}),
                      10e-9, g.repeat({"f": "loud"}))))),
    "log-sleep": ("quick_ops", 2, lambda g, i, lr: [
        g.log("hi"), g.sleep(1e-9), g.once({"f": "r"})]),
    "on-update": ("imperfect", 2, lambda g, i, lr: _on_update(g)),
    "ignore-updates": ("perfect", 2, lambda g, i, lr: g.limit(5, (
        g.ignore_updates(g.until_ok(g.repeat({"f": "w"})))))),
    "any-stagger": ("perfect", 3, lambda g, i, lr: g.clients(g.limit(20, (
        g.any(g.stagger(3, g.repeat({"f": "a"})),
              g.stagger(5, g.repeat({"f": "b"}))))))),
    "trace": ("quick", 2, lambda g, i, lr: g.trace(
        "t", g.limit(3, g.repeat({"f": "w"})))),
    # independent's keyed generators
    "tuple-gen": ("quick", 2, lambda g, i, lr: i.tuple_gen(
        "k", g.limit(3, g.repeat({"f": "w", "value": 1})))),
    "sequential-generator": ("quick", 2, lambda g, i, lr: (
        i.sequential_generator([1, 2, 3], lambda k: g.limit(
            2, g.repeat({"f": "w", "value": k}))))),
    "concurrent-generator": ("perfect", 6, lambda g, i, lr: g.limit(
        60, i.concurrent_generator(2, range(100), lambda k: g.limit(
            5, g.mix([g.repeat({"f": "r"}),
                      g.repeat({"f": "w", "value": k})]))))),
    "concurrent-generator-infinite-keys": (
        "perfect", 4, lambda g, i, lr: g.limit(30, i.concurrent_generator(
            2, iter(range(10 ** 9)), lambda k: g.limit(
                3, g.repeat({"f": "w", "value": k}))))),
    "concurrent-generator-imperfect": (
        "imperfect", 6, lambda g, i, lr: g.limit(80, i.concurrent_generator(
            3, range(50), lambda k: g.process_limit(4, g.limit(
                6, g.repeat({"f": "w", "value": k})))))),
    # the flagship workload's generator, at the CLI's defaults: 5 nodes,
    # 3n workers steered into groups of 5, per-key limit 32
    "linearizable-register": ("imperfect", 15, lambda g, i, lr: g.limit(
        600, lr.test({"nodes": ["n1", "n2", "n3", "n4", "n5"],
                      "concurrency": "3n",
                      "per-key-limit": 32})["generator"])),
    "linearizable-register-unsteered": ("perfect", 4, lambda g, i, lr: (
        g.limit(200, lr.test({"nodes": ["n1", "n2"], "steer?": False,
                              "per-key-limit": 10})["generator"]))),
}


def _completer(sim, mode):
    """The completion function of ``sim.<mode>`` (generator/test.clj's
    quick, perfect and imperfect schedulers), so a case can run through
    ``sim.simulate`` with a seed of its own."""
    if mode in ("quick", "quick_ops"):
        return lambda ctx, inv: {**inv, "type": "ok"}
    if mode in ("perfect", "perfect_star"):
        return lambda ctx, inv: {**inv, "type": "ok",
                                 "time": inv["time"] + sim.PERFECT_LATENCY}
    state = {}
    transitions = {None: "fail", "fail": "info", "info": "ok", "ok": "fail"}

    def complete(ctx, inv):
        t = sim.process_to_thread(ctx, inv["process"])
        state[t] = transitions[state.get(t)]
        return {**inv, "type": state[t],
                "time": inv["time"] + sim.PERFECT_LATENCY}

    return complete


def _run(package: str, case: str, seed: int):
    g, ind, sim, lr = PACKAGES[package]
    mode, n, build = CASES[case]
    # the builders may draw from the rng (the workload's jitter), so seed
    # before building; the simulator seeds again before its first op
    g.set_seed(seed)
    ops = sim.simulate(build(g, ind, lr), _completer(sim, mode),
                       ctx=sim.n_plus_nemesis_context(n), seed=seed)
    return sim.invocations(ops) if mode in ("quick", "perfect") else ops


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_seed_same_ops(case):
    for seed in (45100, 7):  # the reference's pinned seed, and another
        ref = _run("ref", case, seed)
        port = _run("port", case, seed)
        assert port == ref, (case, seed)


def test_cases_draw_randomness():
    """The parity above has teeth: a different seed changes the ops of
    the random cases."""
    for case in ("mix", "stagger", "fn-random", "linearizable-register",
                 "concurrent-generator"):
        assert _run("port", case, 1) != _run("port", case, 2), case


def test_linearizable_register_generator_shape():
    """At the CLI's defaults the workload runs 15 workers in key groups
    of 5 within the dense envelope, in both packages."""
    nodes = ["n1", "n2", "n3", "n4", "n5"]
    for lr in (ref_lr, port_lr):
        t = lr.test({"nodes": nodes, "concurrency": "3n",
                     "per-key-limit": 32})
        assert t["concurrency"] == 15
        assert t["steered-group-size"] == 5
    ops = _run("port", "linearizable-register", 45100)
    invokes = [o for o in ops if o["type"] == "invoke"]
    assert {o["f"] for o in invokes} == {"read", "write", "cas"}
    assert all(isinstance(o["value"], port_ind.KV) for o in invokes)


def test_validate_and_friendly_exceptions_match():
    for pkg in ("ref", "port"):
        g, _i, sim, _lr = PACKAGES[pkg]

        class Boom(g.Generator):
            def op(self, test, ctx):
                raise ValueError("boom")

        with pytest.raises(RuntimeError, match="ValueError"):
            g.op(g.friendly_exceptions(Boom()), {}, sim.default_context())

        class Bad(g.Generator):
            def op(self, test, ctx):
                return ({"type": "invoke", "f": "w"}, None)

        with pytest.raises(Exception):
            g.op(g.validate(Bad()), {}, sim.default_context())


@pytest.mark.parametrize("n,threads", [(2, 5), (7, 5), (3, 6), (2, 4)])
def test_group_threads_match(n, threads):
    """Same groups, or the same refusal, in both packages."""
    out = {}
    for pkg in ("ref", "port"):
        g, ind, sim, _lr = PACKAGES[pkg]
        ctx = g.on_threads_context(lambda t: t != "nemesis",
                                   sim.n_plus_nemesis_context(threads))
        try:
            out[pkg] = ind.group_threads(n, ctx)
        except ValueError as e:
            out[pkg] = ("refused", str(e))
    assert out["port"] == out["ref"]
