"""The port's direct lock checkers (``checker/locks_direct.py``) and its
CPU oracle (``checker/linear.py``) against the JAX package's, on the same
histories.

Every lock model (plain, owner-aware, reentrant, fenced and reentrant
fenced mutexes), the permit semaphore and the unordered queue, on
generator-shaped histories (valid and corrupted) and on adversarial op
soups (crashes, failures, clients shared across processes).  Tolerance:
exact — the result dicts (verdicts, algorithms, witness ops, sample
configs with their model reprs) must be equal, and so must the cases
where the direct checker declines (``None``).
"""

import random

import pytest

from jepsen_tpu import history as ref_history
from jepsen_tpu import models as ref_models
from jepsen_tpu import synth as ref_synth
from jepsen_tpu.checker import linear as ref_linear
from jepsen_tpu.checker import locks_direct as ref_direct
from jepsen_tpu.models import locks as ref_locks
from jepsen_tpu_torch import history, models, synth
from jepsen_tpu_torch.checker import linear, locks_direct
from jepsen_tpu_torch.models import locks

#: model name -> (port constructor, reference constructor)
MODELS = {
    "mutex": (models.mutex, ref_models.mutex),
    "owner-mutex": (models.owner_mutex, ref_models.owner_mutex),
    "reentrant-mutex": (models.reentrant_mutex, ref_models.reentrant_mutex),
    "fenced-mutex": (locks.FencedMutex, ref_locks.FencedMutex),
    "reentrant-fenced-mutex": (locks.ReentrantFencedMutex,
                               ref_locks.ReentrantFencedMutex),
    "acquired-permits": (lambda: models.acquired_permits(2),
                         lambda: ref_models.acquired_permits(2)),
    "unordered-queue": (models.unordered_queue, ref_models.unordered_queue),
}


def _pair(dicts):
    """One op-dict history as the port's and the reference's History."""
    return (history.History.from_dicts(dicts),
            ref_history.History.from_dicts(dicts))


def _soup(name, rng):
    """One adversarial history as op dicts: random op kinds, crashes
    anywhere, failures, and client names shared across processes."""
    queue = name == "unordered-queue"
    fenced = "fenced" in name
    n_procs = rng.choice([2, 3, 4])
    n_clients = rng.choice([n_procs, n_procs, max(1, n_procs - 1)])
    ops, open_f = [], {}
    for _ in range(rng.randrange(4, 22)):
        p = rng.randrange(n_procs)
        if p in open_f:
            kind = rng.choice(["ok", "ok", "info", "fail"])
            f, v = open_f.pop(p)
            if queue and f == "dequeue" and kind == "ok":
                v = rng.randrange(3)
        else:
            kind = "invoke"
            if queue:
                f = rng.choice(["enqueue", "dequeue"])
                v = rng.randrange(3) if f == "enqueue" else None
            else:
                f = rng.choice(["acquire", "release"])
                c = f"c{rng.randrange(n_clients)}"
                if name == "mutex":
                    v = c
                elif fenced:
                    v = {"client": c,
                         "fence": rng.choice([0, 0, rng.randrange(1, 6)])}
                else:
                    v = {"client": c}
            open_f[p] = (f, v)
        ops.append({"type": kind, "f": f, "value": v, "process": p})
    return ops


def _generated(name, seed, n=12):
    """Generator-shaped histories (half corrupted) as op dicts, from the
    port's synth (the reference's gives the same, see
    test_torch_encode.py)."""
    rng = random.Random(seed)
    if name == "acquired-permits":
        hs = [synth.generate_permits_history(rng, n_procs=4, n_ops=40,
                                             corrupt=i % 2 == 0)
              for i in range(n)]
    elif name == "unordered-queue":
        return [_soup(name, rng) for _ in range(n)]
    else:
        hs = [synth.generate_lock_history(
            rng, n_procs=4, n_ops=40, reentrant="reentrant" in name,
            corrupt=i % 2 == 0) for i in range(n)]
        if name == "mutex":
            hs = [h.map(lambda op: op.copy(value=(op.value or {}).get(
                "client") if isinstance(op.value, dict) else op.value))
                  for h in hs]
        elif "fenced" in name:
            hs = [_stamp_fences(rng, h, corrupt=i % 2 == 0)
                  for i, h in enumerate(hs)]
    return [h.to_dicts() for h in hs]


def _stamp_fences(rng, h, corrupt):
    """Fencing tokens on a lock history: fresh holds get increasing
    tokens (sometimes none), re-acquires reuse the hold's token
    (sometimes none); ``corrupt`` hands one fresh hold a stale token."""
    next_fence, hold, out, corrupted = 1, {}, [], False
    for op in h:
        v = op.value if isinstance(op.value, dict) else {"client": op.value}
        client = v.get("client")
        fence = 0
        if op.f == "acquire" and op.type in ("ok", "info"):
            if client not in hold:
                if corrupt and not corrupted and next_fence > 2:
                    fence = rng.randrange(1, next_fence)
                    corrupted = True
                elif rng.random() < 0.75:
                    fence, next_fence = next_fence, next_fence + 1
                hold[client] = fence
            else:
                fence = hold[client] if rng.random() < 0.6 else 0
        elif op.f == "release" and op.type in ("ok", "info"):
            hold.pop(client, None)
        out.append(op.copy(value={"client": client, "fence": fence}))
    return history.History(out)


def _assert_same(name, dicts):
    ours_m, ref_m = (f() for f in MODELS[name])
    ours_h, ref_h = _pair(dicts)
    direct = locks_direct.analysis(ours_m, ours_h)
    assert direct == ref_direct.analysis(ref_m, ref_h)
    full = linear.analysis(ours_m, ours_h)
    assert full == ref_linear.analysis(ref_m, ref_h)
    return direct, full


@pytest.mark.parametrize("name", sorted(MODELS))
def test_direct_checker_and_oracle_equal_reference_on_op_soups(name):
    rng = random.Random(sum(map(ord, name)))
    verdicts = {}
    answered = 0
    for _ in range(150):
        direct, full = _assert_same(name, _soup(name, rng))
        answered += direct is not None
        verdicts[full["valid?"]] = verdicts.get(full["valid?"], 0) + 1
    assert answered >= 20  # the direct argument covers a share of soups
    assert verdicts.get(True) and verdicts.get(False)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_direct_checker_and_oracle_equal_reference_on_generated(name):
    verdicts = set()
    for dicts in _generated(name, seed=len(name)):
        _, full = _assert_same(name, dicts)
        verdicts.add(full["valid?"])
    assert True in verdicts and False in verdicts


def test_direct_results_carry_an_algorithm_and_no_configs():
    rng = random.Random(3)
    h = synth.generate_lock_history(rng, n_procs=3, n_ops=20)
    r = linear.analysis(models.owner_mutex(), h)
    assert r["algorithm"] == "direct-owner-mutex" and "configs" not in r


def test_permit_and_lock_generators_equal_reference():
    for seed in range(3):
        ours = synth.generate_permits_history(random.Random(seed), n_procs=5,
                                              n_ops=50, corrupt=True)
        ref = ref_synth.generate_permits_history(random.Random(seed),
                                                 n_procs=5, n_ops=50,
                                                 corrupt=True)
        assert ours.to_dicts() == ref.to_dicts()


def test_model_reprs_equal_reference():
    for name, (ours, ref) in MODELS.items():
        assert repr(ours()) == repr(ref()), name
    assert repr(models.multi_mutex(["a"])) == repr(ref_models.multi_mutex(
        ["a"]))
    assert repr(models.fifo_queue()) == repr(ref_models.fifo_queue())
    assert repr(models.multi_register({0: 1})) == repr(
        ref_models.multi_register({0: 1}))
