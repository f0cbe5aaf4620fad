"""The port's ``check_batch(device="cpu")`` against the JAX package's
``jepsen_tpu.ops.wgl.check_batch`` on the same corpus.

Result dicts must be equal, with ``"engine": "gpu"`` in the port where
the reference writes ``"tpu"`` as the only mapping.  The corpus spans the
dense automaton, the frontier search (a value domain past 32) and the
oracle fallback (a history past the slot cap).  The reference runs with
its exact ``sort`` compaction (``JEPSEN_TPU_FRONTIER_COMPACTION``, its own
switch), so frontier rows overflow, escalate and settle as the port's
exact compaction does.
"""

import random

import pytest
import torch

from jepsen_tpu import models as ref_models
from jepsen_tpu import synth as ref_synth
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu_torch import models, synth
from jepsen_tpu_torch.ops import wgl

SLOT_CAP = 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain version issues many small tensor ops; one thread avoids
    oversubscribing the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(pkg):
    """Several (E, C) buckets, two 1000-op histories, a history past the
    slot cap (20 processes), and one past the dense value domain (60
    values), all from ``pkg``'s synth with fixed seeds."""
    rng = random.Random(2024)
    hs = []
    for i, (procs, ops) in enumerate([(2, 20), (3, 40), (4, 100), (5, 150),
                                      (6, 60), (3, 250), (5, 30), (4, 90)]):
        hs.append(pkg.generate_history(rng, n_procs=procs, n_ops=ops,
                                       crash_p=0.02, corrupt=i % 3 == 1))
    hs += pkg.generate_batch(seed=45100, n_histories=2, n_procs=5,
                             n_ops=1000, crash_p=0.002, corrupt_fraction=0.5)
    hs.append(pkg.generate_history(rng, n_procs=20, n_ops=60, crash_p=0.0))
    hs.append(pkg.generate_history(rng, n_procs=3, n_ops=200, n_values=60,
                                   crash_p=0.0))
    return hs


OVER_SLOT_CAP, OUT_OF_ENVELOPE = 10, 11


@pytest.fixture(scope="module")
def reference_results():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
        return ref_wgl.check_batch(ref_models.cas_register(0),
                                   _corpus(ref_synth), slot_cap=SLOT_CAP)


@pytest.fixture(scope="module")
def port_results():
    torch.set_num_threads(1)
    return {
        window: wgl.check_batch(models.cas_register(0), _corpus(synth),
                                slot_cap=SLOT_CAP, window=window,
                                device="cpu")
        for window in (1, 4)
    }


def test_corpus_spans_the_routes(reference_results):
    engines = [r["engine"] for r in reference_results]
    assert engines[OVER_SLOT_CAP] == "oracle-fallback"
    assert reference_results[OUT_OF_ENVELOPE]["kernel"] == "frontier"
    assert {r.get("kernel") for r in reference_results} >= {"dense"}
    assert any(r["valid?"] is False for r in reference_results)


def test_check_batch_equals_reference(reference_results, port_results):
    ours = port_results[4]
    assert len(ours) == len(reference_results)
    for i, (o, r) in enumerate(zip(ours, reference_results)):
        expected = dict(r)
        if expected["engine"] == "tpu":
            expected["engine"] = "gpu"
        assert o == expected, i


def test_out_of_envelope_shape_runs_the_frontier_search(port_results):
    ours = port_results[4][OUT_OF_ENVELOPE]
    assert ours["engine"] == "gpu" and ours["kernel"] == "frontier"
    stats = wgl.batch_stats(port_results[4])
    assert stats["oracle-rate"] == pytest.approx(1 / len(port_results[4]))
    assert stats["kernels"] == {"dense": len(port_results[4]) - 2,
                                "frontier": 1}


def test_window_does_not_move_a_verdict(port_results):
    assert port_results[1] == port_results[4]


def test_unbucketed_run_gives_the_same_results(port_results):
    hs = _corpus(synth)[:8]
    ours = wgl.check_batch(models.cas_register(0), hs, slot_cap=SLOT_CAP,
                           bucketed=False, device="cpu")
    assert ours == port_results[4][:8]


def test_register_model_equals_reference():
    rng, ref_rng = random.Random(5), random.Random(5)
    hs = [synth.generate_history(rng, n_procs=4, n_ops=60, corrupt=i % 2 == 0,
                                 op_weights=(1, 1, 0)) for i in range(6)]
    ref_hs = [ref_synth.generate_history(ref_rng, n_procs=4, n_ops=60,
                                         corrupt=i % 2 == 0,
                                         op_weights=(1, 1, 0))
              for i in range(6)]
    ours = wgl.check_batch(models.register(0), hs, device="cpu")
    ref = ref_wgl.check_batch(ref_models.register(0), ref_hs)
    assert ours == [dict(r, engine="gpu") for r in ref]


def test_without_oracle_fallback_rows_are_unknown():
    hs = _corpus(synth)
    ours = wgl.analysis(models.cas_register(0), hs[OVER_SLOT_CAP],
                        slot_cap=SLOT_CAP, oracle_fallback=False,
                        device="cpu")
    assert ours == {"valid?": "unknown", "engine": "unencodable"}


def test_models_outside_the_slice_are_refused():
    """No model of the reference's table is refused any more: models with
    a kernel spec check on the device, spec-less ones (the fenced
    mutexes, the FIFO queue) go to the oracle as unencodable."""
    h = synth.generate_lock_history(random.Random(1), n_procs=2, n_ops=6)
    for model in (models.mutex(), models.owner_mutex(),
                  models.reentrant_mutex(), models.acquired_permits(2),
                  models.multi_register({}), models.multi_mutex(),
                  models.unordered_queue(), models.fifo_queue(),
                  models.fenced_mutex(), models.reentrant_fenced_mutex()):
        assert wgl.check_batch(model, [], device="cpu") == []
    r = wgl.check_batch(models.fenced_mutex(), [h], device="cpu")[0]
    assert r["engine"] == "oracle-fallback"


def test_chunked_dispatch_gives_the_same_results(port_results):
    """A dispatch cap below the bucket size splits it into padded chunks
    of one shape; verdicts do not move."""
    hs = _corpus(synth)[:8]
    ours = wgl.check_batch(models.cas_register(0), hs, slot_cap=SLOT_CAP,
                           max_dispatch=2, device="cpu")
    assert ours == port_results[4][:8]


def test_dispatch_window_bounds_in_flight_work():
    from jepsen_tpu_torch.engine.execution import DispatchWindow

    events = []
    win = DispatchWindow(1, on_retire=lambda k, m: events.append(
        ("retire", k)))
    for k in range(3):
        win.submit(k, lambda k=k: events.append(("dispatch", k)) or (k,))
    win.drain()
    # window=1: every dispatch settles before the next one is issued
    assert events == [("dispatch", 0), ("retire", 0), ("dispatch", 1),
                      ("retire", 1), ("dispatch", 2), ("retire", 2)]


def test_dispatch_window_is_owner_thread_confined():
    import threading

    from jepsen_tpu_torch.engine.execution import DispatchWindow

    win = DispatchWindow(4)
    errors = []

    def foreign():
        try:
            win.submit(0, lambda: (0,))
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=foreign)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert errors and "owner-thread" in str(errors[0])


# ---------------------------------------------------------------------------
# the rest of the model table: lock family, permits, multi-register,
# multi-mutex, the queues — every route, decomposed and not
# ---------------------------------------------------------------------------


def _lock_dicts(seed, reentrant=False, permits=False):
    """Lock (or permit) histories as op dicts: dense-envelope ones (half
    corrupted), one 15-process history (C = 16: past the envelope, still
    under the slot cap) and one 20-process history (past the slot cap)."""
    rng = random.Random(seed)

    def gen(n_procs, n_ops, corrupt):
        if permits:
            return synth.generate_permits_history(rng, n_procs=n_procs,
                                                  n_ops=n_ops,
                                                  corrupt=corrupt)
        return synth.generate_lock_history(rng, n_procs=n_procs, n_ops=n_ops,
                                           reentrant=reentrant,
                                           corrupt=corrupt)

    hs = [gen(3 + i % 3, 40, i % 2 == 0) for i in range(5)]
    hs += [gen(15, 60, False), gen(20, 60, False)]
    return [h.to_dicts() for h in hs]


def _mr_dicts(seed):
    """Multi-register histories: two keys (dense), three keys of 4 values
    (216 composite states: the frontier search when undecomposed), five
    keys (more registers than the packed kernel holds: unencodable when
    undecomposed; keys 3 and 4 start unset in the model), and a cross-key
    txn (never decomposed)."""
    rng = random.Random(seed)
    hs = [synth.generate_mr_history(rng, n_procs=4, n_ops=40, n_keys=2,
                                    n_values=3, corrupt=i % 2 == 0)
          for i in range(4)]
    hs.append(synth.generate_mr_history(rng, n_procs=3, n_ops=30, n_keys=3,
                                        n_values=4, crash_p=0.0))
    hs.append(synth.generate_mr_history(rng, n_procs=4, n_ops=40, n_keys=5,
                                        n_values=2, corrupt=True))
    dicts = [h.to_dicts() for h in hs]
    txn = [["w", 0, 1], ["w", 1, 1]]
    dicts.append([
        {"type": "invoke", "f": "txn", "value": txn, "process": 0},
        {"type": "ok", "f": "txn", "value": txn, "process": 0},
        {"type": "invoke", "f": "txn", "value": [["r", 1, None]],
         "process": 1},
        {"type": "ok", "f": "txn", "value": [["r", 1, 1]], "process": 1},
    ])
    return dicts


def _multi_mutex_dicts(seed):
    """Named-lock histories: lock histories whose ops name one of three
    locks, and one 14-process single-lock history (C past the envelope
    once decomposed: the direct mutex checker takes it)."""
    rng = random.Random(seed)
    out = []
    for i in range(4):
        h = synth.generate_lock_history(rng, n_procs=4, n_ops=30,
                                        corrupt=i % 2 == 0)
        out.append([dict(d, value=f"l{d['process'] % 3}")
                    for d in h.to_dicts()])
    h = synth.generate_lock_history(rng, n_procs=14, n_ops=60)
    out.append([dict(d, value="l0") for d in h.to_dicts()])
    return out


def _queue_dicts(seed):
    """Unordered-queue histories with unique values, one past the
    bitset's 31 values, and one with a repeated value."""
    rng = random.Random(seed)
    out = []
    for n_vals in (6, 8, 40, 5):
        ops, open_q, pending, nxt = [], {}, [], 0
        for _ in range(3 * n_vals):
            p = rng.randrange(3)
            if p in open_q:
                f, v = open_q.pop(p)
                if f == "dequeue":
                    v = pending.pop(0) if pending else None
                    if v is None:
                        continue
                else:
                    pending.append(v)
                ops.append({"type": "ok", "f": f, "value": v, "process": p})
            elif nxt < n_vals and rng.random() < 0.6:
                open_q[p] = ("enqueue", nxt if n_vals != 5 else nxt % 3)
                ops.append({"type": "invoke", "f": "enqueue",
                            "value": open_q[p][1], "process": p})
                nxt += 1
            else:
                open_q[p] = ("dequeue", None)
                ops.append({"type": "invoke", "f": "dequeue", "value": None,
                            "process": p})
        out.append(ops)
    out[0][-1] = dict(out[0][-1], value=99) if out[0][-1]["f"] == \
        "dequeue" else out[0][-1]
    return out


#: model name -> (port model, reference model, op-dict corpus)
TABLE = {
    "owner-mutex": (models.owner_mutex(), ref_models.owner_mutex(),
                    _lock_dicts(31)),
    "reentrant-mutex": (models.reentrant_mutex(),
                        ref_models.reentrant_mutex(),
                        _lock_dicts(32, reentrant=True)),
    "acquired-permits": (models.acquired_permits(2),
                         ref_models.acquired_permits(2),
                         _lock_dicts(33, permits=True)),
    "multi-register": (models.multi_register({k: 0 for k in range(3)}),
                       ref_models.multi_register({k: 0 for k in range(3)}),
                       _mr_dicts(34)),
    "multi-mutex": (models.multi_mutex(["l2"]),
                    ref_models.multi_mutex(["l2"]), _multi_mutex_dicts(35)),
    "unordered-queue": (models.unordered_queue(),
                        ref_models.unordered_queue(), _queue_dicts(36)),
    "fenced-mutex": (models.fenced_mutex(), ref_models.fenced_mutex(),
                     _lock_dicts(37)[:3]),
    "reentrant-fenced-mutex": (models.reentrant_fenced_mutex(),
                               ref_models.reentrant_fenced_mutex(),
                               _lock_dicts(38, reentrant=True)[:3]),
    "fifo-queue": (models.fifo_queue(), ref_models.fifo_queue(),
                   _queue_dicts(39)[:2]),
}

TABLE_SLOT_CAP = 16


@pytest.fixture(scope="module")
def table_results():
    """{(name, decomposed): (reference results, {window: port results})}"""
    from jepsen_tpu import history as ref_history
    from jepsen_tpu_torch import history

    torch.set_num_threads(1)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
        for name, (ours, ref, dicts) in TABLE.items():
            for decomposed in (True, False):
                ref_res = ref_wgl.check_batch(
                    ref, [ref_history.History.from_dicts(d) for d in dicts],
                    slot_cap=TABLE_SLOT_CAP, decomposed=decomposed)
                port = {
                    window: wgl.check_batch(
                        ours, [history.History.from_dicts(d) for d in dicts],
                        slot_cap=TABLE_SLOT_CAP, decomposed=decomposed,
                        window=window, device="cpu")
                    for window in (1, 4)
                }
                out[name, decomposed] = (ref_res, port)
    return out


def _as_port(r):
    return dict(r, engine="gpu") if r.get("engine") == "tpu" else r


@pytest.mark.parametrize("decomposed", [True, False],
                         ids=["decomposed", "whole"])
@pytest.mark.parametrize("name", sorted(TABLE))
def test_model_table_equals_reference(table_results, name, decomposed):
    ref, port = table_results[name, decomposed]
    assert port[1] == port[4]
    assert len(port[4]) == len(ref)
    for i, (o, r) in enumerate(zip(port[4], ref)):
        assert o == _as_port(r), (name, decomposed, i)


def test_model_table_reaches_every_route(table_results):
    """Across the table: dense and frontier device rows, oracle-routed,
    oracle-overflow (a dense-only spec past its envelope) and
    oracle-fallback rows, and decomposed rows."""
    engines, kernels, partitioned = set(), set(), 0
    for (_name, _dec), (_ref, port) in table_results.items():
        for r in port[4]:
            engines.add(r["engine"])
            kernels.add(r.get("kernel"))
            partitioned += "partitions" in r
    assert {"gpu", "oracle-routed", "oracle-overflow",
            "oracle-fallback"} <= engines
    assert {"dense", "frontier"} <= kernels
    assert partitioned > 0
    mr_whole = table_results["multi-register", False][1][4]
    assert mr_whole[4]["kernel"] == "frontier"
    assert mr_whole[5]["engine"] == "oracle-fallback"
    assert "oracle-routed" in {
        r["engine"] for r in table_results["unordered-queue", True][1][4]}
    assert all(r["engine"] == "oracle-fallback"
               for r in table_results["fifo-queue", True][1][4])


def test_decomposition_does_not_move_a_verdict(table_results):
    for name in TABLE:
        dec = table_results[name, True][1][4]
        whole = table_results[name, False][1][4]
        assert [r["valid?"] for r in dec] == [r["valid?"] for r in whole], \
            name
