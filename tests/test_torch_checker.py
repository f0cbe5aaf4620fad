"""The port's Checker seam (``jepsen_tpu_torch.checker``) and Elle's
workload checkers (``jepsen_tpu_torch.workloads.cycle``) against the JAX
package's ``jepsen_tpu.checker`` and ``jepsen_tpu.workloads.cycle``.

The same op dicts (from the port's ``synth``, small sizes, invalid
histories in every corpus) build both packages' histories.  Tolerance:
exact dict equality, after mapping the engine name ``"tpu"`` to
``"gpu"``; ``"race"`` compares ``valid?`` only, since which arm wins is a
race.  The port runs the device route with ``device="cpu"`` (the plain
PyTorch versions); the reference runs with its exact ``sort``
compaction, as ``test_torch_check_batch.py`` does.
"""

import os
import random

import pytest
import torch

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import history as ref_history
from jepsen_tpu import models as ref_models
from jepsen_tpu.models import locks as ref_locks
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.workloads.cycle import append as ref_append
from jepsen_tpu.workloads.cycle import wr as ref_wr
from jepsen_tpu_torch import checker, history, models, synth
from jepsen_tpu_torch.models import locks
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.workloads.cycle import append, wr


@pytest.fixture(autouse=True)
def _exact_reference_and_one_thread(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gpu_names(x):
    """The reference's result with its device engine named as the port's."""
    if isinstance(x, dict):
        return {gpu_names(k): gpu_names(v) for k, v in x.items()}
    if isinstance(x, list):
        return [gpu_names(v) for v in x]
    return "gpu" if x == "tpu" else x


def _cas_corpus():
    rng = random.Random(4100)
    return [synth.generate_history(rng, n_procs=p, n_ops=n, crash_p=0.05,
                                   corrupt=i % 2 == 1).to_dicts()
            for i, (p, n) in enumerate([(3, 40), (4, 60), (3, 80), (5, 50)])]


def _lock_corpus():
    rng = random.Random(4110)
    return [synth.generate_lock_history(rng, n_procs=3, n_ops=30,
                                        corrupt=i == 1).to_dicts()
            for i in range(3)]


def _mr_corpus():
    rng = random.Random(4120)
    return [synth.generate_mr_history(rng, n_procs=3, n_ops=40, n_keys=2,
                                      n_values=3, corrupt=i == 1).to_dicts()
            for i in range(3)]


CORPORA = {
    "cas-register": (_cas_corpus, lambda: models.cas_register(0),
                     lambda: ref_models.cas_register(0)),
    "owner-mutex": (_lock_corpus, locks.owner_mutex, ref_locks.owner_mutex),
    "multi-register": (_mr_corpus,
                       lambda: models.multi_register({0: 0, 1: 0}),
                       lambda: ref_models.multi_register({0: 0, 1: 0})),
}


def _both(dicts):
    return (history.History.from_dicts(dicts),
            ref_history.History.from_dicts(dicts))


def _check_both(name, algorithm, test=None, **kw):
    corpus, model, ref_model = CORPORA[name]
    out = []
    for dicts in corpus():
        h, rh = _both(dicts)
        ours = checker.linearizable(model(), algorithm=algorithm,
                                    device="cpu", **kw).check(test or {}, h)
        ref = ref_checker.linearizable(
            ref_model(), algorithm="tpu" if algorithm == "gpu" else algorithm,
            **kw).check(test or {}, rh)
        out.append((ours, gpu_names(ref)))
    return out


@pytest.mark.parametrize("name", sorted(CORPORA))
@pytest.mark.parametrize("algorithm", ["oracle", "gpu", "tpu", "auto"])
def test_linearizable_equals_reference(name, algorithm):
    pairs = _check_both(name, algorithm)
    for ours, ref in pairs:
        assert ours == ref
    assert {o["valid?"] for o, _ in pairs} == {True, False}, name
    if algorithm != "oracle":
        assert any(o.get("engine") == "gpu" for o, _ in pairs)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_race_verdicts_equal_reference(name):
    for ours, ref in _check_both(name, "race"):
        assert ours["valid?"] == ref["valid?"]
        assert ours["engine"] in ("gpu", "oracle", "direct")


def test_auto_takes_the_oracle_for_a_model_with_no_device_step():
    rng = random.Random(4130)
    dicts = synth.generate_lock_history(rng, n_procs=3, n_ops=20).to_dicts()
    h, rh = _both(dicts)
    assert not wgl.supported(locks.fenced_mutex())
    assert wgl.supported(models.cas_register(0))
    ours = checker.linearizable(locks.fenced_mutex(), device="cpu").check(
        {}, h)
    ref = ref_checker.linearizable(ref_locks.fenced_mutex()).check({}, rh)
    assert ours == gpu_names(ref)
    assert "engine" not in ours


def test_service_and_unknown_algorithms_raise():
    with pytest.raises(ValueError, match="resident checker service"):
        checker.linearizable(models.cas_register(0), algorithm="service")
    with pytest.raises(ValueError, match="unknown algorithm"):
        checker.linearizable(models.cas_register(0), algorithm="knossos")
    with pytest.raises(ValueError, match="requires a model"):
        checker.linearizable(None)


def test_device_route_without_a_device_raises_where_cuda_is_absent(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h, _ = _both(_cas_corpus()[0])
    chk = checker.linearizable(models.cas_register(0), algorithm="gpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        chk.check({}, h)
    # check_safe turns the raise into an unknown verdict that names it
    out = checker.check_safe(chk, {}, h)
    assert out["valid?"] == "unknown" and "CUDA is not available" in \
        out["error"]


def test_oracle_budget_gives_unknown_where_the_reference_does():
    rng = random.Random(4140)
    dicts = synth.generate_history(rng, n_procs=10, n_ops=300,
                                   crash_p=0.3).to_dicts()
    h, rh = _both(dicts)
    ours = checker.linearizable(models.cas_register(0), algorithm="oracle",
                                oracle_budget_s=0.0).check({}, h)
    ref = ref_checker.linearizable(ref_models.cas_register(0),
                                   algorithm="oracle",
                                   oracle_budget_s=0.0).check({}, rh)
    assert ref["valid?"] == "unknown"
    assert ours["valid?"] == "unknown"
    assert set(ours) == set(ref)
    # the same budget on check_batch: the oracle takes the over-slot-cap
    # row after the device work, serially, and runs out as the
    # reference's does
    batch = [synth.generate_history(random.Random(4141), n_procs=12,
                                    n_ops=200, crash_p=0.3)]
    ours = wgl.check_batch(models.cas_register(0), batch, slot_cap=8,
                           oracle_budget_s=0.0, device="cpu")
    ref = ref_wgl.check_batch(ref_models.cas_register(0),
                              [ref_history.History.from_dicts(
                                  batch[0].to_dicts())],
                              slot_cap=8, oracle_budget_s=0.0)
    assert ref[0]["valid?"] == "unknown"
    assert ours[0]["valid?"] == "unknown"
    assert ours[0]["engine"] == ref[0]["engine"] == "oracle-fallback"


def test_merge_valid_matches_reference():
    for vs in ([], [True], [True, False], [True, "unknown"],
               ["unknown", False], [False, True, "unknown"]):
        assert checker.merge_valid(vs) == ref_checker.merge_valid(vs)
    with pytest.raises(ValueError):
        checker.merge_valid([True, "maybe"])


def _boom(test, history, opts):
    raise RuntimeError("checker exploded")


def test_compose_and_check_safe_match_reference():
    dicts = _cas_corpus()[1]
    h, rh = _both(dicts)
    ours = checker.check_safe(checker.compose({
        "linear": checker.linearizable(models.cas_register(0),
                                       device="cpu"),
        "ok": checker.unbridled_optimism(),
        "noop": checker.noop(),
        "boom": checker.checker(_boom),
        "limited": checker.concurrency_limit(1, checker.unbridled_optimism()),
    }), {}, h)
    ref = ref_checker.check_safe(ref_checker.compose({
        "linear": ref_checker.linearizable(ref_models.cas_register(0)),
        "ok": ref_checker.unbridled_optimism(),
        "noop": ref_checker.noop(),
        "boom": ref_checker.checker(_boom),
        "limited": ref_checker.concurrency_limit(
            1, ref_checker.unbridled_optimism()),
    }), {}, rh)
    boom, ref_boom = ours.pop("boom"), ref.pop("boom")
    assert ours == gpu_names(ref)
    assert ours["valid?"] == checker.merge_valid(
        [ours["linear"]["valid?"], "unknown"])
    assert boom["valid?"] == ref_boom["valid?"] == "unknown"
    assert "RuntimeError: checker exploded" in boom["error"]
    assert checker.checker_name(checker.checker(_boom)) == "_boom"
    assert checker.checker_name(checker.compose({})) == "Compose"


def test_linear_svg_bytes_equal_reference(tmp_path):
    corpus = _cas_corpus()
    dicts = next(d for d in corpus[1::2])
    h, rh = _both(dicts)
    test = {"name": "svg", "start-time": "t0"}
    ours = checker.linearizable(models.cas_register(0), device="cpu").check(
        {**test, "store-base": str(tmp_path / "port")}, h)
    ref = ref_checker.linearizable(ref_models.cas_register(0)).check(
        {**test, "store-base": str(tmp_path / "ref")}, rh)
    assert ours["valid?"] is False
    ours_svg, ref_svg = ours.pop("witness"), ref.pop("witness")
    assert ours == gpu_names(ref)
    assert ours_svg == str(tmp_path / "port" / "svg" / "t0" / "linear.svg")
    with open(ours_svg, "rb") as f, open(ref_svg, "rb") as g:
        assert f.read() == g.read()


def _txn_corpus(mode):
    return [h.to_dicts() for h in synth.generate_txn_batch(
        4150, 4, mode=mode, n_txns=40, key_count=4, anomaly_every=2)]


@pytest.mark.parametrize("mode,ours_mod,ref_mod,elle_opts", [
    ("append", append, ref_append, {}),
    ("wr", wr, ref_wr, {}),
    # rw-register's default anomalies do not name the injected G1c
    ("wr", wr, ref_wr, {"consistency-models": ["serializable"]}),
])
def test_elle_checkers_equal_reference(tmp_path, mode, ours_mod, ref_mod,
                                       elle_opts):
    test = {"name": "elle", "start-time": "t0"}
    elle_opts = {**elle_opts, "screen-route": "cpu"}
    valid = []
    for i, dicts in enumerate(_txn_corpus(mode)):
        h, rh = _both(dicts)
        opts = {"subdirectory": [str(i)]}
        ours = ours_mod.checker(elle_opts).check(
            {**test, "store-base": str(tmp_path / "port")}, h, opts)
        ref = ref_mod.checker(elle_opts).check(
            {**test, "store-base": str(tmp_path / "ref")}, rh, opts)
        ours_files = ours.pop("anomaly-files", [])
        ref_files = ref.pop("anomaly-files", [])
        assert ours == ref
        assert [os.path.relpath(p, tmp_path / "port") for p in ours_files] \
            == [os.path.relpath(p, tmp_path / "ref") for p in ref_files]
        for p, q in zip(ours_files, ref_files):
            with open(p, "rb") as f, open(q, "rb") as g:
                assert f.read() == g.read()
        valid.append(ours["valid?"])
    assert True in valid
    if mode == "append" or elle_opts.get("consistency-models"):
        assert False in valid
