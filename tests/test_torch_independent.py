"""The port's independent lift (``jepsen_tpu_torch.independent``) against
the JAX package's ``jepsen_tpu.independent``.

Keyed histories are built as plain data: per key a history from the
port's ``synth`` (small sizes, some corrupted, one past the slot cap),
its processes offset per key, its values ``[k, v]`` lists, merged by time
with un-keyed nemesis ops between them; each package rewraps the lists
in its own ``KV``.  Tolerance: exact — the one-pass split equals the
reference's per-key ``subhistory`` op for op, and the lifted checkers'
results (per-key results, ``failures``, ``valid?``, ``batch-stats``)
equal the reference's after mapping the engine name ``"tpu"`` to
``"gpu"``.  The port runs on ``device="cpu"`` (the plain versions).
"""

import heapq
import json
import os
import random

import pytest
import torch

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import history as ref_history
from jepsen_tpu import independent as ref_ind
from jepsen_tpu import models as ref_models
from jepsen_tpu_torch import checker, history, independent, models, synth

N_PROCS = 3


@pytest.fixture(autouse=True)
def _exact_reference_and_one_thread(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gpu_names(x):
    if isinstance(x, dict):
        return {gpu_names(k): gpu_names(v) for k, v in x.items()}
    if isinstance(x, list):
        return [gpu_names(v) for v in x]
    return "gpu" if x == "tpu" else x


def keyed_dicts(n_keys=10, seed=4200, nemesis_every=0, wide_key=None):
    """One keyed history as op dicts: key k's ops are a synth history
    with processes offset by k × its process count and values [k, v],
    the keys merged by time; one un-keyed nemesis op at the head, and
    one more after every ``nemesis_every``-th op when given.  Key
    ``wide_key`` runs 16 processes (past a slot cap of 8)."""
    rng = random.Random(seed)
    per_key = []
    for k in range(n_keys):
        procs = 16 if k == wide_key else N_PROCS
        h = synth.generate_history(rng, n_procs=procs,
                                   n_ops=80 if k == wide_key else 40,
                                   crash_p=0.0 if k == wide_key else 0.05,
                                   corrupt=k % 3 == 1)
        per_key.append([{**d, "process": d["process"] + k * procs,
                         "value": [k, d["value"]]} for d in h.to_dicts()])
    merged = list(heapq.merge(*per_key, key=lambda d: d["time"]))
    out = [{"type": "info", "process": "nemesis", "f": "start",
            "value": None, "time": 0}]
    for i, d in enumerate(merged, 1):
        out.append(d)
        if nemesis_every and i % nemesis_every == 0:
            out.append({"type": "info", "process": "nemesis",
                        "f": "stop" if i % 2 else "start", "value": None,
                        "time": d["time"]})
    return [{k: v for k, v in d.items() if k != "index"} for d in out]


def _rewrap(dicts, pkg_history, kv):
    ops = []
    for d in dicts:
        d = dict(d)
        if isinstance(d["value"], list):
            d["value"] = kv(*d["value"])
        ops.append(d)
    return pkg_history.History.from_dicts(ops).index_ops()


def both(dicts):
    return (_rewrap(dicts, history, independent.KV),
            _rewrap(dicts, ref_history, ref_ind.KV))


def test_one_pass_split_equals_reference_subhistory():
    h, rh = both(keyed_dicts(n_keys=16, nemesis_every=7))
    keys = ref_ind.history_keys(rh)
    assert independent.history_keys(h) == keys == set(range(16))
    split = independent.split_by_key(h)
    assert set(split) == keys
    n_nemesis = sum(1 for op in h if op.process == "nemesis")
    assert n_nemesis > 2
    for k in keys:
        ref_sub = ref_ind.subhistory(k, rh).to_dicts()
        assert split[k].to_dicts() == ref_sub
        assert independent.subhistory(k, h).to_dicts() == ref_sub
        assert sum(1 for op in split[k] if op.process == "nemesis") \
            == n_nemesis
    # un-keyed ops are copies: indexing one subhistory leaves the others
    split[0].index_ops()
    assert [op.index for op in split[1] if op.process == "nemesis"] == \
        [op.index for op in h if op.process == "nemesis"]


def _mixed_live_dicts():
    """A live keyed history: ``KV("a", v)`` writes and reads, one
    un-keyed client ``cas`` whose value is a bare ``[1, 2]``, and an
    un-keyed nemesis op."""
    return [
        {"type": "invoke", "process": 0, "f": "write", "value": ["a", 1],
         "time": 0},
        {"type": "ok", "process": 0, "f": "write", "value": ["a", 1],
         "time": 1},
        {"type": "info", "process": "nemesis", "f": "start", "value": None,
         "time": 2},
        {"type": "invoke", "process": 1, "f": "cas", "value": [1, 2],
         "time": 3},
        {"type": "ok", "process": 1, "f": "cas", "value": [1, 2],
         "time": 4},
        {"type": "invoke", "process": 0, "f": "read", "value": ["a", None],
         "time": 5},
        {"type": "ok", "process": 0, "f": "read", "value": ["a", 1],
         "time": 6},
    ]


def _kv_keyed(dicts, pkg_history, kv):
    """Only the ops whose value is a list with a string key become KVs:
    the un-keyed ``cas [1, 2]`` stays a bare list, as a live run has it."""
    ops = []
    for d in dicts:
        d = dict(d)
        v = d["value"]
        if isinstance(v, list) and isinstance(v[0], str):
            d["value"] = kv(*v)
        ops.append(d)
    return pkg_history.History.from_dicts(ops).index_ops()


def test_live_keyed_history_keeps_unkeyed_pairs_in_every_key():
    dicts = _mixed_live_dicts()
    h = _kv_keyed(dicts, history, independent.KV)
    rh = _kv_keyed(dicts, ref_history, ref_ind.KV)
    assert independent.rekey(h) is h
    split = independent.split_by_key(independent.rekey(h))
    keys = ref_ind.history_keys(rh)
    assert set(split) == keys == {"a"}
    for k in keys:
        ref_sub = ref_ind.subhistory(k, rh).to_dicts()
        assert [1, 2] in [d["value"] for d in ref_sub]
        assert split[k].to_dicts() == ref_sub


def test_history_from_json_is_still_rekeyed():
    dicts = keyed_dicts(n_keys=6, nemesis_every=5)
    stored = history.History.from_dicts(
        json.loads(json.dumps(dicts))).index_ops()
    assert not any(isinstance(op.value, independent.KV) for op in stored)
    _, rh = both(dicts)
    split = independent.split_by_key(independent.rekey(stored))
    keys = ref_ind.history_keys(rh)
    assert set(split) == keys == set(range(6))
    for k in keys:
        # JSON gives lists where the live history had tuples (cas values)
        assert json.loads(json.dumps(split[k].to_dicts())) == json.loads(
            json.dumps(ref_ind.subhistory(k, rh).to_dicts()))


def test_kv_matches_reference():
    t = independent.kv("k", 3)
    assert independent.is_tuple(t) and not independent.is_tuple(("k", 3))
    assert (t.key, t.value) == ("k", 3) and t == ("k", 3)
    assert repr(t) == repr(ref_ind.kv("k", 3))


def _read_artifacts(base, name, key):
    d = os.path.join(base, name, "t0", independent.DIR, str(key))
    with open(os.path.join(d, "results.json")) as f:
        results = json.load(f)
    with open(os.path.join(d, "history.jsonl"), "rb") as f:
        return results, f.read()


def same_store(ref_result, ref_base, port_base):
    """The reference's result with its store paths moved to the port's."""
    if isinstance(ref_result, dict):
        return {k: same_store(v, ref_base, port_base)
                for k, v in ref_result.items()}
    if isinstance(ref_result, str):
        return ref_result.replace(str(ref_base), str(port_base))
    return ref_result


def test_independent_checker_equals_reference(tmp_path):
    h, rh = both(keyed_dicts(n_keys=8, seed=4210))
    test = {"name": "ind", "start-time": "t0"}
    ours = independent.checker(checker.linearizable(
        models.cas_register(0), device="cpu")).check(
        {**test, "store-base": str(tmp_path / "port")}, h, {})
    ref = ref_ind.checker(ref_checker.linearizable(
        ref_models.cas_register(0))).check(
        {**test, "store-base": str(tmp_path / "ref")}, rh, {})
    assert ours == gpu_names(same_store(ref, tmp_path / "ref",
                                        tmp_path / "port"))
    assert ours["valid?"] is False and ours["failures"]
    # each failing key's witness lands in its own subdirectory
    for k in ours["failures"]:
        assert ours["results"][k]["witness"] == str(
            tmp_path / "port" / "ind" / "t0" / independent.DIR / str(k)
            / "linear.svg")
    assert len(ours["results"]) == 8
    for k in range(8):
        o_res, o_hist = _read_artifacts(tmp_path / "port", "ind", k)
        r_res, r_hist = _read_artifacts(tmp_path / "ref", "ind", k)
        assert o_res == gpu_names(same_store(r_res, tmp_path / "ref",
                                             tmp_path / "port"))
        assert o_hist == r_hist


@pytest.fixture(scope="module")
def batched_pair(tmp_path_factory):
    """The batched lift on both packages over 12 keys, one past the slot
    cap, with per-key artifacts in a temporary store."""
    base = tmp_path_factory.mktemp("batched")
    h, rh = both(keyed_dicts(n_keys=12, seed=4220, nemesis_every=11,
                             wide_key=5))
    test = {"name": "batched", "start-time": "t0"}
    ours = checker.check_safe(
        independent.batched_linearizable(models.cas_register(0), slot_cap=8,
                                         device="cpu"),
        {**test, "store-base": str(base / "port")}, h, {})
    ref = ref_checker.check_safe(
        ref_ind.batched_linearizable(ref_models.cas_register(0), slot_cap=8),
        {**test, "store-base": str(base / "ref")}, rh, {})
    return ours, ref, base


def test_batched_linearizable_equals_reference(batched_pair):
    ours, ref, _ = batched_pair
    assert ours == gpu_names(ref)
    assert ours["valid?"] is False
    assert ours["failures"] == [k for k in sorted(range(12), key=str)
                                if ours["results"][k]["valid?"] is not True]
    engines = ours["batch-stats"]["engines"]
    assert engines["gpu"] == 11 and engines["oracle-fallback"] == 1
    assert ours["results"][5]["engine"] == "oracle-fallback"


def test_batched_linearizable_writes_per_key_artifacts(batched_pair):
    _, _, base = batched_pair
    for k in range(12):
        o_res, o_hist = _read_artifacts(base / "port", "batched", k)
        r_res, r_hist = _read_artifacts(base / "ref", "batched", k)
        assert o_res == gpu_names(r_res)
        assert o_hist == r_hist
        assert b"nemesis" not in o_hist  # client ops only


def _register_history(k, values_ok=True):
    """A tiny per-key linearizable (or not) register history — the
    reference's ``tests/test_independent.py`` helper, on the port."""
    return [
        history.invoke_op(0, "write", independent.kv(k, 1), time=0),
        history.ok_op(0, "write", independent.kv(k, 1), time=1),
        history.invoke_op(1, "read", independent.kv(k, None), time=2),
        history.ok_op(1, "read", independent.kv(k, 1 if values_ok else 9),
                      time=3),
    ]


def test_reference_batched_linearizable_case_on_the_port():
    """``tests/test_independent.py::test_batched_linearizable``, run on
    the port (its ``"tpu"`` engine is the port's ``"gpu"``)."""
    ops = _register_history("good") + _register_history("bad",
                                                         values_ok=False)
    h = history.History(ops).index_ops()
    chk = independent.batched_linearizable(models.cas_register(),
                                           device="cpu")
    res = chk.check({"name": "t", "store?": False}, h, {})
    assert res["results"]["good"]["valid?"] is True
    assert res["results"]["bad"]["valid?"] is False
    assert res["failures"] == ["bad"]
    assert res["valid?"] is False
    stats = res["batch-stats"]
    assert stats["engines"].get("gpu") == 2, stats
    assert stats["device-rate"] == 1.0 and stats["oracle-rate"] == 0.0


def test_empty_keyspace_is_valid():
    h = history.History([history.Op("info", "nemesis", "start")])
    assert independent.batched_linearizable(
        models.cas_register(0), device="cpu").check(
        {"store?": False}, h) == {
        "valid?": True, "results": {}, "failures": [],
        "batch-stats": {"engines": {}, "kernels": {}, "device-rate": 0.0,
                        "oracle-rate": 0.0}}
