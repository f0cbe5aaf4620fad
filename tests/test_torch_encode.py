"""The port's host half against the JAX package: synth histories, the
CPU oracle and the encoded batches must be identical for the same seed.

Each package generates and encodes its own corpus; the test compares the
results (op dicts, numpy arrays with their dtypes, fallback lists, row
order), never hands one package's objects to the other.
"""

import random

import numpy as np
import pytest

from jepsen_tpu import models as ref_models
from jepsen_tpu import synth as ref_synth
from jepsen_tpu.checker import linear as ref_linear
from jepsen_tpu.ops import encode as ref_encode
from jepsen_tpu_torch import models
from jepsen_tpu_torch import synth
from jepsen_tpu_torch.checker import linear
from jepsen_tpu_torch.ops import encode

ARRAYS = ("init_state", "ev_slot", "cand_slot", "cand_f", "cand_a", "cand_b")


def _dicts(histories):
    return [h.to_dicts() for h in histories]


@pytest.mark.parametrize("kw", [
    dict(seed=3, n_histories=6, n_procs=4, n_ops=40, crash_p=0.1,
         corrupt_fraction=0.5),
    dict(seed=45100, n_histories=2, n_procs=5, n_ops=1000, crash_p=0.002,
         corrupt_fraction=0.25),
])
def test_generate_batch_same_histories(kw):
    assert _dicts(synth.generate_batch(**kw)) == _dicts(
        ref_synth.generate_batch(**kw))


@pytest.mark.parametrize("kw", [
    dict(n_procs=3, n_ops=50, crash_p=0.2, replace_crashed=True),
    dict(n_procs=6, n_ops=60, corrupt=True, op_weights=(1, 1, 0)),
    dict(n_procs=12, n_ops=40, n_values=30),
])
def test_generate_history_same_histories(kw):
    ours = [synth.generate_history(random.Random(s), **kw) for s in range(4)]
    ref = [ref_synth.generate_history(random.Random(s), **kw)
           for s in range(4)]
    assert _dicts(ours) == _dicts(ref)


def test_generate_lock_history_same_histories():
    kw = dict(n_procs=5, n_ops=50, corrupt=True)
    ours = [synth.generate_lock_history(random.Random(s), **kw)
            for s in range(4)]
    ref = [ref_synth.generate_lock_history(random.Random(s), **kw)
           for s in range(4)]
    assert _dicts(ours) == _dicts(ref)


def _corpus(pkg, kind):
    """A corpus with invalid histories and at least one history past a
    slot cap of 8 (12 processes), generated by ``pkg``'s synth."""
    rng = random.Random(11)
    if kind in ("mutex", "owner-mutex", "reentrant-mutex"):
        reentrant = kind == "reentrant-mutex"
        hs = [pkg.generate_lock_history(rng, n_procs=4,
                                        n_ops=30 if i % 2 else 150,
                                        reentrant=reentrant,
                                        corrupt=i % 3 == 0)
              for i in range(8)]
        hs.append(pkg.generate_lock_history(rng, n_procs=12, n_ops=60,
                                            reentrant=reentrant))
        return hs
    if kind == "acquired-permits":
        hs = [pkg.generate_permits_history(rng, n_procs=4,
                                           n_ops=30 if i % 2 else 150,
                                           corrupt=i % 3 == 0)
              for i in range(8)]
        hs.append(pkg.generate_permits_history(rng, n_procs=12, n_ops=60))
        return hs
    if kind == "multi-register":
        hs = [pkg.generate_mr_history(rng, n_procs=4,
                                      n_ops=30 if i % 2 else 150,
                                      n_keys=1 + i % 4, n_values=5,
                                      crash_p=0.01, corrupt=i % 3 == 0)
              for i in range(8)]
        hs.append(pkg.generate_mr_history(rng, n_procs=12, n_ops=60,
                                          crash_p=0.0))
        hs.append(pkg.generate_mr_history(rng, n_procs=3, n_ops=30,
                                          n_keys=6))  # past 4 registers
        return hs
    weights = (1, 1, 0) if kind == "register" else None
    hs = [pkg.generate_history(rng, n_procs=p, n_ops=n, corrupt=i % 3 == 0,
                               op_weights=weights)
          for i, (p, n) in enumerate([(3, 30), (5, 120), (4, 70), (6, 200),
                                      (2, 20), (5, 90)])]
    hs.append(pkg.generate_history(rng, n_procs=12, n_ops=80,
                                   op_weights=weights))
    return hs


MODELS = {
    "register": (models.register(0), ref_models.register(0)),
    "cas-register": (models.cas_register(0), ref_models.cas_register(0)),
    "mutex": (models.mutex(), ref_models.mutex()),
    "owner-mutex": (models.owner_mutex(), ref_models.owner_mutex()),
    "reentrant-mutex": (models.reentrant_mutex(),
                        ref_models.reentrant_mutex()),
    "acquired-permits": (models.acquired_permits(2),
                         ref_models.acquired_permits(2)),
    "multi-register": (models.multi_register({0: 0, 1: 0}),
                       ref_models.multi_register({0: 0, 1: 0})),
}


def _assert_batches_equal(ours, ref):
    for name in ARRAYS:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.fallback == ref.fallback
    assert ours.row_history == ref.row_history


@pytest.mark.parametrize("kind", sorted(MODELS))
@pytest.mark.parametrize("slot_cap", [8, 32])
def test_batch_encode_equals_reference(kind, slot_cap):
    model, ref_model = MODELS[kind]
    hs = _corpus(synth, kind)
    ref_hs = _corpus(ref_synth, kind)
    ours = encode.batch_encode(hs, model, slot_cap=slot_cap)
    ref = ref_encode.batch_encode(ref_hs, ref_model, slot_cap=slot_cap)
    _assert_batches_equal(ours, ref)
    if slot_cap == 8:
        assert ours.fallback, "the 12-process history must overflow"
    ours_b = encode.batch_encode(hs, model, slot_cap=slot_cap, bucketed=True)
    ref_b = ref_encode.batch_encode(ref_hs, ref_model, slot_cap=slot_cap,
                                    bucketed=True)
    assert len(ours_b) == len(ref_b) > 1
    for a, b in zip(ours_b, ref_b):
        _assert_batches_equal(a, b)


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_encode_history_fields_equal_reference(kind):
    model, ref_model = MODELS[kind]
    for h, rh in zip(_corpus(synth, kind), _corpus(ref_synth, kind)):
        e = encode.encode_history(h, model, slot_cap=16)
        r = ref_encode.encode_history(rh, ref_model, slot_cap=16)
        assert (e is None) == (r is None)
        if e is not None:
            assert (e.init_state, e.n_ops, e.max_open) == (
                r.init_state, r.n_ops, r.max_open)
            assert encode.bucket_key(e, 16) == ref_encode.bucket_key(r, 16)


@pytest.mark.parametrize("witness", [False, True])
def test_oracle_results_equal_reference(witness):
    """The port's CPU oracle returns the reference's result dicts —
    verdicts, witness ops and sampled configs alike."""
    hs = _corpus(synth, "cas-register")
    ref_hs = _corpus(ref_synth, "cas-register")
    for h, rh in zip(hs, ref_hs):
        ours = linear.analysis(models.cas_register(0), h, pure_fs=("read",),
                               witness=witness)
        ref = ref_linear.analysis(ref_models.cas_register(0), rh,
                                  pure_fs=("read",), witness=witness)
        assert ours == ref


def test_generate_reentrant_lock_history_same_histories():
    kw = dict(n_procs=5, n_ops=50, corrupt=True, reentrant=True)
    ours = [synth.generate_lock_history(random.Random(s), **kw)
            for s in range(4)]
    ref = [ref_synth.generate_lock_history(random.Random(s), **kw)
           for s in range(4)]
    assert _dicts(ours) == _dicts(ref)


@pytest.mark.parametrize("kw", [
    dict(n_procs=4, n_ops=60, n_keys=3, n_values=4, crash_p=0.1,
         corrupt=True),
    dict(n_procs=8, n_ops=300, n_keys=64, n_values=4, crash_p=0.002),
])
def test_generate_mr_history_same_histories(kw):
    ours = [synth.generate_mr_history(random.Random(s), **kw)
            for s in range(3)]
    ref = [ref_synth.generate_mr_history(random.Random(s), **kw)
           for s in range(3)]
    assert _dicts(ours) == _dicts(ref)


@pytest.mark.parametrize("kw", [
    dict(n_procs=5, n_ops=60, n_permits=2, corrupt=True),
    dict(n_procs=10, n_ops=200, n_permits=1),
])
def test_generate_permits_history_same_histories(kw):
    ours = [synth.generate_permits_history(random.Random(s), **kw)
            for s in range(3)]
    ref = [ref_synth.generate_permits_history(random.Random(s), **kw)
           for s in range(3)]
    assert _dicts(ours) == _dicts(ref)
