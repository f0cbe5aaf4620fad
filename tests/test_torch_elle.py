"""The port's Elle slice (``jepsen_tpu_torch.elle``) against the JAX
package's ``jepsen_tpu.elle`` on the same histories.

Corpora come from the reference's ``bench._elle_corpus`` (its
``TxnGenerator`` against the serializable in-memory store, a committed
G1c injected into every 4th history) at a few lengths and key counts,
plus seeded corruptions of them (failed writers, stale, truncated,
duplicated and reordered reads), so every corpus holds invalid
histories of many anomaly types.  The same op dicts build both
packages' histories.  Results are compared whole (JSON with sorted
keys): the port's routes ``cpu``, ``device`` and ``auto`` on
``device="cpu"`` (the plain screens) must all equal the reference.
"""

import copy
import json
import random

import numpy as np
import pytest
import torch

import bench
from jepsen_tpu import elle as ref_elle
from jepsen_tpu.elle import encode as ref_encode
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import elle, synth
from jepsen_tpu_torch.elle import cycles as elle_cycles
from jepsen_tpu_torch.elle import encode
from jepsen_tpu_torch.engine import execution
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.ops import cycles as ops_cycles

WORKLOADS = {"list-append": "append", "rw-register": "wr"}
MODEL_SETS = (["strict-serializable"], ["serializable"],
              ["snapshot-isolation"], ["sequential"])


@pytest.fixture(autouse=True)
def _fresh_routers():
    """Each test calibrates its own auto routes."""
    elle_cycles._SCREEN_CHOICE.clear()
    elle_cycles._CLASSIFY_CHOICE.clear()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    elle_cycles._SCREEN_CHOICE.clear()
    elle_cycles._CLASSIFY_CHOICE.clear()


def _corrupt(dicts, mode, rng):
    """Seeded damage to one history's op dicts: a failed writer, and reads
    that are truncated, duplicated or reversed (list-append), or moved to
    an earlier or a later written value of their key (rw-register:
    stale and future reads, so lost updates, anti-dependency cycles and
    cyclic version orders)."""
    dicts = copy.deepcopy(dicts)
    oks = [d for d in dicts if d["type"] == "ok" and d["process"] != 91]
    written: dict = {}
    for d in oks:
        for f, k, v in d["value"]:
            if f == "w":
                written.setdefault(k, []).append(v)
    for d in rng.sample(oks, min(4, len(oks))):
        for mop in d["value"]:
            if mop[0] != "r" or mop[2] is None:
                continue
            if mode == "wr":
                vals = written.get(mop[1], [])
                i = vals.index(mop[2]) if mop[2] in vals else 0
                pool = vals[:i] if rng.random() < 0.5 else vals[i + 1:]
                if pool:
                    mop[2] = rng.choice(pool)
            elif mop[2]:
                mop[2] = rng.choice([mop[2][:-1], mop[2] + mop[2][-1:],
                                     mop[2][::-1]])
    writers = [d for d in oks if any(m[0] != "r" for m in d["value"])]
    if writers:
        rng.choice(writers)["type"] = "fail"
    return dicts


def _corpus(mode, seed=4500):
    """(reference histories, port histories): bench._elle_corpus at four
    (txns, keys) shapes, six histories each, every other one corrupted."""
    rng = random.Random(seed)
    all_dicts = []
    for n_txns, keys in ((60, 4), (80, 8), (100, 16), (120, 8)):
        for i, h in enumerate(bench._elle_corpus(mode, 6, n_txns, keys)):
            dicts = h.to_dicts()
            all_dicts.append(_corrupt(dicts, mode, rng) if i % 2 else dicts)
    ref = [RefHistory.from_dicts(copy.deepcopy(d)) for d in all_dicts]
    port = [History.from_dicts(copy.deepcopy(d)) for d in all_dicts]
    return ref, port


@pytest.fixture(scope="module")
def corpora():
    return {wl: _corpus(mode) for wl, mode in WORKLOADS.items()}


def _dumps(x):
    return json.dumps(x, sort_keys=True, default=repr)


def _opts(workload, models, route=None):
    o = {"workload": workload, "consistency-models": models}
    if route is not None:
        o["screen-route"] = route
    return o


@pytest.fixture(scope="module")
def reference_results(corpora):
    """The reference's check_batch on its pure host route, per workload
    and model set."""
    out = {}
    for wl, (ref_hs, _) in corpora.items():
        for models in MODEL_SETS:
            out[wl, models[0]] = ref_elle.check_batch(
                _opts(wl, models, "cpu"), ref_hs)
    return out


def test_corpora_hold_invalid_histories(reference_results):
    for key, results in reference_results.items():
        valid = [r["valid?"] for r in results]
        assert False in valid and True in valid, key
    kinds = {k for rs in reference_results.values() for r in rs
             for k in r.get("anomaly-types", [])}
    assert {"G1c", "G1a"} <= kinds, kinds


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("models", MODEL_SETS[:2],
                         ids=lambda m: m[0])
def test_encode_graph_matches_reference(corpora, workload, models):
    ref_hs, hs = corpora[workload]
    opts = _opts(workload, models, "cpu")
    ref_mod = ref_elle._workload_module(opts)
    mod = elle._workload_module(opts)
    for rh, h in zip(ref_hs, hs):
        r = ref_encode.encode_graph(ref_mod.prepare(rh, opts)[0])
        p = encode.encode_graph(mod.prepare(h, opts)[0])
        assert [repr(v) for v in p.order] == [repr(v) for v in r.order]
        assert p.rel.dtype == r.rel.dtype and \
            p.rel.tobytes() == r.rel.tobytes()
        assert (p.present, p.masks, p.nonadj) == \
            (r.present, r.masks, r.nonadj)
        assert encode.bucket_key(p) == ref_encode.bucket_key(r)


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("route", ["cpu", "device", "auto"])
def test_check_batch_matches_reference(corpora, reference_results, workload,
                                       route):
    _, hs = corpora[workload]
    for models in MODEL_SETS:
        want = reference_results[workload, models[0]]
        got = elle.check_batch(_opts(workload, models, route), hs,
                               device="cpu")
        assert _dumps(got) == _dumps(want), (workload, route, models)
    if route == "auto":
        # the second call at the same buckets takes the pinned winner
        assert elle_cycles._CLASSIFY_CHOICE
        got = elle.check_batch(_opts(workload, MODEL_SETS[0], route), hs,
                               device="cpu")
        assert _dumps(got) == _dumps(
            reference_results[workload, MODEL_SETS[0][0]])


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_check_matches_reference(corpora, reference_results, workload):
    ref_hs, hs = corpora[workload]
    for i in (0, 1, 9):
        for route in ("cpu", "device"):
            opts = _opts(workload, MODEL_SETS[0], route)
            want = ref_elle.check(_opts(workload, MODEL_SETS[0], "cpu"),
                                  ref_hs[i])
            got = elle.check(opts, hs[i], device="cpu")
            assert _dumps(got) == _dumps(want), (workload, i, route)


@pytest.mark.parametrize("window", [1, 4])
def test_classify_graphs_through_executor_windows(corpora, window):
    """The screened classify through an Executor of window 1 and 4 equals
    the reference's host classify."""
    from jepsen_tpu.elle import cycles as ref_cycles

    ref_hs, hs = corpora["list-append"]
    opts = _opts("list-append", MODEL_SETS[0])
    ref_graphs = [ref_elle.list_append.prepare(h, opts)[0] for h in ref_hs]
    graphs = [elle.list_append.prepare(h, opts)[0] for h in hs]
    want = ref_cycles.classify_graphs(ref_graphs, route="cpu")
    ex = execution.Executor(window, device=torch.device("cpu"))
    screens = elle_cycles.screen_for_graphs(graphs, executor=ex)
    assert all(s is not None for s in screens)
    got = [elle_cycles.classify(g, s) for g, s in zip(graphs, screens)]
    assert _dumps(got) == _dumps(want)
    got = elle_cycles.classify_graphs(graphs, route="device", executor=ex)
    assert _dumps(got) == _dumps(want)


def _flip_members(real):
    def wrong(rel, masks, nonadj, mode="fixed", work=None):
        members, walks, rounds = real(rel, masks, nonadj, mode, work)
        return ~members, walks, rounds
    return wrong


def test_auto_route_raises_on_a_device_cpu_mismatch(corpora, monkeypatch):
    """A screen that disagrees with the CPU fails the calibrating auto
    route; it is never pinned to the CPU."""
    _, hs = corpora["list-append"]
    monkeypatch.setattr(ops_cycles, "screen_reference",
                        _flip_members(ops_cycles.screen_reference))
    with pytest.raises(RuntimeError, match="differ"):
        elle.check_batch(_opts("list-append", MODEL_SETS[0], "auto"), hs,
                         device="cpu")
    assert not elle_cycles._CLASSIFY_CHOICE


def test_auto_version_screen_raises_on_a_mismatch(monkeypatch):
    """The rw-register version-graph screen under auto: a wrong has-cycle
    answer raises."""
    from jepsen_tpu_torch.elle.graph import Graph

    graphs = []
    for i in range(20):
        g = Graph()
        for v in range(4):
            g.add_edge(v, v + 1, "version")
        if i % 3 == 0:
            g.add_edge(4, 0, "version")
        graphs.append(g)
    real = ops_cycles.has_cycle_reference

    def wrong(adj, mode="fixed", work=None, closure=False):
        flags, rounds = real(adj, mode, work)
        return ~flags, rounds

    want = elle_cycles.cyclic_graph_mask(graphs, device="cpu")
    assert want.tolist() == [i % 3 == 0 for i in range(20)]
    elle_cycles._SCREEN_CHOICE.clear()
    monkeypatch.setattr(ops_cycles, "has_cycle_reference", wrong)
    with pytest.raises(RuntimeError, match="differ"):
        elle_cycles.cyclic_graph_mask(graphs, device="cpu")
    assert not elle_cycles._SCREEN_CHOICE


def test_auto_route_device_error_propagates(corpora, monkeypatch):
    _, hs = corpora["list-append"]

    def broken(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ops_cycles, "screen_reference", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        elle.check_batch(_opts("list-append", MODEL_SETS[0], "auto"), hs,
                         device="cpu")
    assert not elle_cycles._CLASSIFY_CHOICE


def test_no_device_without_cuda_raises_only_when_screening(corpora,
                                                          monkeypatch,
                                                          reference_results):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for wl in WORKLOADS:
        _, hs = corpora[wl]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            elle.check_batch(_opts(wl, MODEL_SETS[0], "device"), hs)
        got = elle.check_batch(_opts(wl, MODEL_SETS[0], "cpu"), hs)
        assert _dumps(got) == _dumps(reference_results[wl, MODEL_SETS[0][0]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops_cycles.has_cycle_batch([np.zeros((3, 3), bool)])


def test_unknown_route_raises(corpora):
    _, hs = corpora["list-append"]
    with pytest.raises(ValueError, match="route"):
        elle.check_batch(_opts("list-append", MODEL_SETS[0], "service"),
                         hs[:2], device="cpu")


@pytest.mark.parametrize("mode,workload", [("append", "list-append"),
                                           ("wr", "rw-register")])
def test_synth_txn_corpus_matches_reference(mode, workload):
    """The port's own generator (chip_smoke.py's corpus, here small):
    valid except the injected G1c, and the port's results equal the
    reference's on the same op dicts."""
    hs = synth.generate_txn_batch(77, 8, mode, n_txns=60, key_count=6)
    ref_hs = [RefHistory.from_dicts(h.to_dicts()) for h in hs]
    opts = _opts(workload, MODEL_SETS[0])
    want = ref_elle.check_batch({**opts, "screen-route": "cpu"}, ref_hs)
    got = elle.check_batch({**opts, "screen-route": "device"}, hs,
                           device="cpu")
    assert _dumps(got) == _dumps(want)
    assert [r["valid?"] for r in got] == [i % 4 != 0 for i in range(8)]
    assert all(got[i]["anomaly-types"] == ["G1c"] for i in range(0, 8, 4))
