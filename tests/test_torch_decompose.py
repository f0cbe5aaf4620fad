"""The port's decomposition front-end (``engine/decompose.py``) against the
JAX package's ``jepsen_tpu.engine.decompose``.

``split_history`` must give the same partitions (keys, sub-model reprs,
sub-history ops) or the same refusal (``None``), and
``merge_partition_results`` the same merged dict, with ``"gpu"`` in the
port where the reference writes ``"tpu"`` — a merged all-valid device row
keeps its ``kernel``.  Tolerance: exact.
"""

import random

import pytest

from jepsen_tpu import history as ref_history
from jepsen_tpu import models as ref_models
from jepsen_tpu import synth as ref_synth
from jepsen_tpu.engine import decompose as ref_decompose
from jepsen_tpu_torch import history, models, synth
from jepsen_tpu_torch.engine import decompose


def _split_both(model_pair, dicts):
    ours = decompose.split_history(model_pair[0],
                                   history.History.from_dicts(dicts))
    ref = ref_decompose.split_history(model_pair[1],
                                      ref_history.History.from_dicts(dicts))
    return ours, ref


def _assert_same_split(ours, ref):
    if ref is None:
        assert ours is None
        return 0
    assert [k for k, _, _ in ours] == [k for k, _, _ in ref]
    assert [repr(m) for _, m, _ in ours] == [repr(m) for _, m, _ in ref]
    assert [h.to_dicts() for _, _, h in ours] == \
        [h.to_dicts() for _, _, h in ref]
    return len(ours)


def _multi_mutex_soup(rng, n_locks=3, n_procs=4, n=24):
    ops, open_f = [], {}
    for _ in range(n):
        p = rng.randrange(n_procs)
        if p in open_f:
            f, v = open_f.pop(p)
            kind = rng.choice(["ok", "ok", "ok", "info", "fail"])
        else:
            kind, f = "invoke", rng.choice(["acquire", "release"])
            v = rng.choice([f"l{i}" for i in range(n_locks)] + [None] * (
                rng.random() < 0.05))
            open_f[p] = (f, v)
        ops.append({"type": kind, "f": f, "value": v, "process": p})
    ops.append({"type": "info", "f": "start", "value": None,
                "process": "nemesis"})
    ops.append({"type": "ok", "f": "acquire", "value": "l0", "process": 9})
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_split_multi_register_equals_reference(seed):
    keys = {k: 0 for k in range(5)}
    pair = (models.multi_register(keys), ref_models.multi_register(keys))
    parts = 0
    for i in range(6):
        dicts = synth.generate_mr_history(
            random.Random(seed * 10 + i), n_procs=4, n_ops=40, n_keys=5,
            n_values=3, crash_p=0.1, corrupt=i % 2 == 0).to_dicts()
        assert dicts == ref_synth.generate_mr_history(
            random.Random(seed * 10 + i), n_procs=4, n_ops=40, n_keys=5,
            n_values=3, crash_p=0.1, corrupt=i % 2 == 0).to_dicts()
        parts += _assert_same_split(*_split_both(pair, dicts))
    assert parts > 6


def test_split_refuses_what_the_reference_refuses():
    pair = (models.multi_register({0: 0, 1: 0}),
            ref_models.multi_register({0: 0, 1: 0}))
    cross_key = [
        {"type": "invoke", "f": "txn", "value": [["w", 0, 1], ["w", 1, 2]],
         "process": 0},
        {"type": "ok", "f": "txn", "value": [["w", 0, 1], ["w", 1, 2]],
         "process": 0},
    ]
    ours, ref = _split_both(pair, cross_key)
    assert ours is None and ref is None
    reg = (models.register(0), ref_models.register(0))
    ours, ref = _split_both(reg, cross_key)
    assert ours is None and ref is None


@pytest.mark.parametrize("seed", range(4))
def test_split_multi_mutex_equals_reference(seed):
    rng = random.Random(seed)
    held = ["l1"] if seed % 2 else []
    pair = (models.multi_mutex(held), ref_models.multi_mutex(held))
    for _ in range(8):
        _assert_same_split(*_split_both(pair, _multi_mutex_soup(rng)))


def _merge_both(parts):
    """Merge ``parts`` of port-side result dicts, and the same parts with
    the reference's ``"tpu"``, through each package."""
    ref_parts = [(k, dict(r, engine="tpu") if r.get("engine") == "gpu"
                  else r) for k, r in parts]
    ours = decompose.merge_partition_results(parts)
    ref = ref_decompose.merge_partition_results(ref_parts)
    if ref.get("engine") == "tpu":
        ref = dict(ref, engine="gpu")
    return ours, ref


MERGE_CASES = {
    "all-valid-device": [
        (0, {"valid?": True, "engine": "gpu", "kernel": "dense"}),
        (1, {"valid?": True, "engine": "gpu", "kernel": "dense"})],
    "mixed-kernels": [
        (0, {"valid?": True, "engine": "gpu", "kernel": "dense"}),
        (1, {"valid?": True, "engine": "gpu", "kernel": "frontier"})],
    "device-and-oracle": [
        (0, {"valid?": True, "engine": "gpu", "kernel": "dense"}),
        (1, {"valid?": True, "engine": "oracle-fallback", "op-count": 3})],
    "direct-algorithm": [
        ("a", {"valid?": True, "engine": "oracle-routed",
               "algorithm": "direct-mutex", "op-count": 2}),
        ("b", {"valid?": True, "engine": "oracle-routed",
               "algorithm": "direct-mutex", "op-count": 4})],
    "first-false-wins": [
        (0, {"valid?": "unknown", "engine": "overflow"}),
        (1, {"valid?": False, "engine": "gpu", "kernel": "dense",
             "failed-event": 3}),
        (2, {"valid?": False, "engine": "oracle-overflow", "op": {}})],
    "unknown": [
        (0, {"valid?": True, "engine": "gpu", "kernel": "dense"}),
        (1, {"valid?": "unknown", "engine": "unencodable"})],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_partition_results_equals_reference(case):
    ours, ref = _merge_both(MERGE_CASES[case])
    assert ours == ref


def test_merged_all_valid_device_row_keeps_its_kernel():
    ours = decompose.merge_partition_results(MERGE_CASES["all-valid-device"])
    assert ours == {"valid?": True, "engine": "gpu", "partitions": 2,
                    "kernel": "dense"}


def test_partition_routing_facts_equal_reference():
    for ours, ref in (
            (models.multi_register({0: 0}), ref_models.multi_register({0: 0})),
            (models.multi_mutex(), ref_models.multi_mutex()),
            (models.unordered_queue(), ref_models.unordered_queue()),
            (models.cas_register(0), ref_models.cas_register(0)),
            (models.owner_mutex(), ref_models.owner_mutex())):
        assert (decompose.partitioner(ours) is None) == \
            (ref_decompose.partitioner(ref) is None)
        assert decompose.routing_gain_possible(ours) == \
            ref_decompose.routing_gain_possible(ref)
