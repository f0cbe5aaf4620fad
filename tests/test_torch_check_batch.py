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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        wgl.check_batch(models.mutex(), [], device="cpu")


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
