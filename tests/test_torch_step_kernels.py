"""The port's branchless model steps (kernel K3, plain PyTorch) against
the JAX package's step functions on the same seeded numpy inputs.

Tolerance: exact.  ``state'`` (int32) and ``ok`` (bool) are compared
element for element, on inputs that reach XLA's edge semantics: int32
states across the whole range, int16 ``a``/``b`` at their extremes (the
reentrant mutex's ``2a - 1`` wraps in int16), and unordered-queue value
ids whose shift ``a - 1`` falls outside [0, 31].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.ops import step_kernels as ref_steps
from jepsen_tpu_torch import models
from jepsen_tpu_torch.ops import step_kernels

STEP_NAMES = ("register_step", "cas_register_step", "mutex_step",
              "reentrant_mutex_step", "multi_register_step",
              "unordered_queue_step")


def _inputs(seed: int, n: int = 4096):
    r = np.random.default_rng(seed)
    state = r.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    state[: n // 2] = r.integers(-3, 70, n // 2)  # mostly small value ids
    f = r.integers(0, 12, n).astype(np.int8)
    a = r.integers(-3, 70, n).astype(np.int16)
    b = r.integers(-3, 70, n).astype(np.int16)
    edges = np.array([-2**15, -1, 0, 1, 31, 32, 33, 2**14, 2**15 - 1],
                     np.int16)
    a[: len(edges)] = edges
    b[len(edges): 2 * len(edges)] = edges
    # states the steps can reach from the edges (2a - 1 wrapped, bit 31)
    state[2 * len(edges): 3 * len(edges)] = [
        -1, 2**31 - 1, -2**31, 0, 61, 63, 65, -32768, 32767]
    return state, f, a, b


@pytest.mark.parametrize("name", STEP_NAMES)
def test_step_equals_reference(name):
    for seed in range(3):
        arrays = _inputs(seed)
        ref_state, ref_ok = getattr(ref_steps, name)(
            *(jnp.asarray(x) for x in arrays))
        state, ok = getattr(step_kernels, name)(
            *(torch.from_numpy(x) for x in arrays))
        assert state.dtype == torch.int32 and ok.dtype == torch.bool
        np.testing.assert_array_equal(
            state.numpy(), np.asarray(ref_state).astype(np.int32))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))


def test_unordered_queue_shift_edges():
    """``1 << (a - 1)`` is 0 outside [0, 31] (enqueueing no bit is
    accepted and changes nothing) and INT_MIN at 31."""
    a = torch.tensor([0, 1, 32, 33, -5], dtype=torch.int16)
    state = torch.zeros(5, dtype=torch.int32)
    f = torch.full((5,), step_kernels.F_ENQUEUE, dtype=torch.int8)
    out, ok = step_kernels.unordered_queue_step(state, f, a, a)
    assert out.tolist() == [0, 1, -2**31, 0, 0]
    assert ok.tolist() == [True] * 5


def test_steps_table_matches_the_reference_specs():
    ref = {s.name: s.step.__name__ for s in ref_steps.SPECS.values()
           if not s.dense_only}
    ours = {k: v.__name__ for k, v in step_kernels.STEPS.items()}
    assert ours == ref
    assert set(step_kernels.STEP_IDS) == set(step_kernels.STEPS)
    # one kernel id per distinct step function
    ids = {}
    for k, v in step_kernels.STEPS.items():
        ids.setdefault(v, set()).add(step_kernels.STEP_IDS[k])
    assert all(len(s) == 1 for s in ids.values())
    assert len({next(iter(s)) for s in ids.values()}) == len(ids)


def test_port_specs_carry_their_step():
    """A spec's frontier step is its entry in the one table of steps,
    ``STEPS``; the dense-only permit spec has none."""
    sk = step_kernels
    for model, step in ((models.register(0), sk.register_step),
                        (models.cas_register(0), sk.cas_register_step),
                        (models.mutex(), sk.mutex_step),
                        (models.owner_mutex(), sk.cas_register_step),
                        (models.reentrant_mutex(), sk.reentrant_mutex_step),
                        (models.multi_register({}), sk.multi_register_step),
                        (models.unordered_queue(),
                         sk.unordered_queue_step)):
        spec = sk.spec_for(model)
        assert not spec.dense_only and sk.STEPS[spec.name] is step
    permits = sk.spec_for(models.acquired_permits(2))
    assert permits.dense_only and permits.name not in sk.STEPS
    assert set(sk.STEPS) == {s.name for s in sk.SPECS.values()
                             if not s.dense_only}
    assert not hasattr(permits, "step")
