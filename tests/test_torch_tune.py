"""The port's tuner (``jepsen_tpu_torch.tune``) against the JAX package's
``jepsen_tpu.tune`` on the same inputs.

- ``Calibration.cost`` of both packages on one cost table, over a grid of
  (kernel, E, C, F, rows): exact shapes, unmeasured shapes, the
  cross-kernel scaling and rows below the first sample — equal floats.
- ``planning.estimated_cost`` with and without a table, and
  ``proposal_within_budget``'s truth table, equal to the reference's.
- ``validate`` rejects the reference's broken artifacts that apply and
  the other package's artifact (and the reference rejects the port's);
  corrupt, version-mismatched and stale artifacts fall back to the
  pinned defaults with ``jepsen_engine_calibration_fallback_total``.
- The knob ladder: argument > calibration > default, in the engine.
- ``check_batch`` and the screens give equal results tuned and untuned,
  equal to the reference's.
- ``run_tune(profile="smoke", device="cpu")`` and the CLI.

The two tuners' *picks* are wall-time measurements and are not compared.
"""

import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jepsen_tpu import models as ref_models
from jepsen_tpu import synth as ref_synth
from jepsen_tpu import tune as ref_tune
from jepsen_tpu.engine import planning as ref_planning
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.tune import artifact as ref_art
from jepsen_tpu.tune import calibrate as ref_calibrate
from jepsen_tpu_torch import models, obs, synth, tune
from jepsen_tpu_torch.engine import execution, planning
from jepsen_tpu_torch.obs import journal as obs_journal
from jepsen_tpu_torch.ops import cycles, wgl
from jepsen_tpu_torch.tune import __main__ as tune_main
from jepsen_tpu_torch.tune import artifact as art
from jepsen_tpu_torch.tune import calibrate

CREATED = "2026-10-17T00:00:00+00:00"

COST_TABLE = [
    {"kernel": "dense", "E": 64, "C": 4, "F": 64, "rows": 32,
     "seconds": 0.010},
    {"kernel": "dense", "E": 64, "C": 4, "F": 64, "rows": 128,
     "seconds": 0.040},
    {"kernel": "dense", "E": 64, "C": 4, "F": 64, "rows": 512,
     "seconds": 0.150},
    {"kernel": "frontier", "E": 64, "C": 4, "F": 64, "rows": 32,
     "seconds": 0.200},
    {"kernel": "cycles", "E": 16, "C": 0, "F": 7, "rows": 8,
     "seconds": 0.003},
    {"kernel": "cycles", "E": 16, "C": 0, "F": 7, "rows": 64,
     "seconds": 0.020},
]

PARAMS = {"window": 7, "flush_rows": 123, "row_bucket": 128,
          "closure_mode": "earlyexit"}


@pytest.fixture(autouse=True)
def _isolated_calibration(monkeypatch):
    """Both packages start with no active calibration, and none leaks."""
    monkeypatch.delenv("JEPSEN_TPU_CALIBRATION", raising=False)
    ref_tune.reset_active()
    ref_tune.set_active(None)
    tune.use(None)
    yield
    ref_tune.reset_active()
    tune.reset_active()


def port_data(cost_table=COST_TABLE, device_kind="cpu", n_devices=1,
              **params):
    return art.build_artifact({**PARAMS, **params},
                              [dict(e) for e in cost_table], device_kind,
                              n_devices, created_at=CREATED)


def ref_data(cost_table=COST_TABLE):
    return ref_art.build_artifact(
        {**PARAMS, "union_mode": "unroll", "closure_impl": "uint8"},
        [dict(e) for e in cost_table], "cpu", 1, created_at=CREATED)


def both_calibrations(cost_table=COST_TABLE):
    return (art.Calibration(port_data(cost_table)),
            ref_art.Calibration(ref_data(cost_table)))


def _grid():
    for kernel in ("dense", "frontier", "cycles", "oracle"):
        for E in (1, 16, 64, 100, 1000):
            for C in (0, 4, 8, 12):
                for F in (1, 7, 64, 128):
                    yield kernel, E, C, F


ROWS = (0, 1, 7, 8, 20, 32, 80, 128, 300, 512, 4096)


# -- the cost table -----------------------------------------------------------


@pytest.mark.parametrize("table", [
    COST_TABLE,
    COST_TABLE[:1],   # one point: through the origin everywhere
    COST_TABLE[:3],   # one kernel only: every other scales across kernels
    COST_TABLE[3:],   # no dense entry
], ids=["full", "one-point", "dense-only", "no-dense"])
def test_cost_equals_the_reference_over_a_grid(table):
    ours, theirs = both_calibrations(table)
    for kernel, E, C, F in _grid():
        for rows in ROWS:
            assert ours.cost(kernel, E, C, F, rows) == \
                theirs.cost(kernel, E, C, F, rows), (kernel, E, C, F, rows)


def test_cost_of_an_empty_table_is_none_in_both():
    ours, theirs = both_calibrations([])
    assert not ours.has_cost_table() and not theirs.has_cost_table()
    assert ours.cost("dense", 64, 4, 64, 32) is None
    assert theirs.cost("dense", 64, 4, 64, 32) is None


def test_cost_table_shapes():
    """Exact points, interpolation, extrapolation, below the first
    sample, and the cross-kernel scaling of ``test_tune.py`` keep
    seconds on both sides of a sort."""
    ours, _ = both_calibrations()
    assert ours.cost("dense", 64, 4, 64, 32) == 0.010
    assert 0.010 < ours.cost("dense", 64, 4, 64, 80) < 0.040
    assert ours.cost("dense", 64, 4, 64, 1024) > 0.150
    assert 0 < ours.cost("dense", 64, 4, 64, 8) < 0.010
    assert ours.cost("dense", 256, 4, 64, 32) > ours.cost("dense", 64, 4,
                                                          64, 32)
    dense_only, _ = both_calibrations(COST_TABLE[:1])
    d = dense_only.cost("dense", 64, 4, 64, 32)
    f = dense_only.cost("frontier", 64, 4, 64, 32)
    assert d == pytest.approx(0.01) and d < f < 10.0


def _pb(kernel="dense", E=64, C=4, F=64, rows=32, disp=1024, fn=True):
    plan = SimpleNamespace(fn=object() if fn else None, disp=disp,
                           kernel=kernel, E=E, C=C, frontier=F)
    return SimpleNamespace(plan=plan, rows=[None] * rows)


def _cost_cases():
    for kernel, E, C, F in _grid():
        for rows in (1, 32, 80, 512):
            yield _pb(kernel, E, C, F, rows)
    yield _pb(fn=False)
    yield _pb(disp=0)


@pytest.mark.parametrize("table", [None, [], COST_TABLE, COST_TABLE[3:]],
                         ids=["untuned", "empty-table", "table",
                              "no-dense"])
def test_estimated_cost_equals_the_reference(table):
    if table is not None:
        ours, theirs = both_calibrations(table)
        tune.set_active(ours)
        ref_tune.set_active(theirs)
    for pb in _cost_cases():
        assert planning.estimated_cost(pb) == \
            ref_planning.estimated_cost(pb), (vars(pb.plan), len(pb.rows))


# -- the budget gate ------------------------------------------------------


def _budget_plans():
    yield SimpleNamespace(fn=object(), disp=64, kernel="frontier", E=64,
                          C=4, frontier=64)
    yield SimpleNamespace(fn=object(), disp=2, kernel="frontier", E=64,
                          C=4, frontier=64)
    yield SimpleNamespace(fn=object(), disp=7, kernel="cycles", E=16,
                          C=0, frontier=7)
    yield SimpleNamespace(fn=object(), disp=128, kernel="dense", E=64,
                          C=4, frontier=64)
    yield SimpleNamespace(fn=None, disp=0, kernel="oracle", E=64, C=4,
                          frontier=64)
    yield SimpleNamespace(fn=object(), disp=0, kernel="frontier", E=64,
                          C=4, frontier=64)


def test_proposal_within_budget_truth_table_equals_the_reference():
    checked = 0
    for plan in _budget_plans():
        for rows in (0, 1, 2, 3, 6, 7, 8, 16, 63, 64, 65, 128, 129, 256,
                     1000):
            for window in (1, 2, 3, 4, 8):
                for n_dev in (1, 2, 4):
                    assert tune.proposal_within_budget(
                        plan, rows, window, n_dev) == \
                        ref_calibrate.proposal_within_budget(
                            plan, rows, window, n_dev), (vars(plan), rows,
                                                         window, n_dev)
                    checked += 1
    assert checked == 6 * 15 * 5 * 3
    frontier = next(_budget_plans())
    assert tune.proposal_within_budget(frontier, 64, window=4)
    assert not tune.proposal_within_budget(frontier, 65, window=4)


# -- validation and cross-loading ------------------------------------------


@pytest.mark.parametrize("breaker", [
    lambda d: d.update(version=2),
    lambda d: d.pop("params"),
    lambda d: d["params"].pop("window"),
    lambda d: d["params"].update(row_bucket=48),   # not a power of two
    lambda d: d["params"].update(union_mode="zip"),  # not a port knob
    lambda d: d["params"].update(closure_mode="adaptive"),
    lambda d: d["params"].pop("closure_mode"),
    lambda d: d["params"].update(closure_impl="uint16"),  # not a knob
    lambda d: d["params"].update(window=0),
    lambda d: d["params"].update(flush_rows=0),
    lambda d: d.pop("package"),
    lambda d: d.pop("code_fingerprint"),
    lambda d: d["cost_table"][0].pop("seconds"),
    lambda d: d["cost_table"][0].update(seconds=-1.0),
])
def test_validate_rejects_broken_artifacts(breaker):
    data = port_data()
    art.validate(data)
    breaker(data)
    with pytest.raises(ValueError):
        art.validate(data)


def test_artifact_schema_and_round_trip(tmp_path):
    data = port_data()
    assert set(data["params"]) == set(art.PARAM_KEYS)
    assert art.PARAM_KEYS == ("window", "flush_rows", "row_bucket",
                              "closure_mode")
    assert data["package"] == "jepsen_tpu_torch"
    assert data["version"] == art.SCHEMA_VERSION == ref_art.SCHEMA_VERSION
    assert data["calibration_id"].startswith("cpux1-")
    p1, p2 = tmp_path / "a.json", tmp_path / "b.json"
    art.save(data, str(p1))
    assert json.loads(p1.read_text()) == data
    art.save(json.loads(p1.read_text()), str(p2))
    assert p1.read_text() == p2.read_text()
    cal = art.load_calibration(str(p1), device="cpu")
    assert (cal.window(), cal.flush_rows(), cal.row_bucket(),
            cal.closure_mode()) == (7, 123, 128, "earlyexit")


def test_the_packages_reject_each_others_artifacts(tmp_path):
    with pytest.raises(ValueError, match="unknown param"):
        art.validate(ref_data())
    with pytest.raises(ValueError, match="missing param"):
        ref_art.validate(port_data())
    obs.enable(reset=True)
    p = tmp_path / "reference.json"
    p.write_text(json.dumps(ref_data()))
    assert art.load_calibration(str(p), device="cpu") is None
    assert obs.registry().value("jepsen_engine_calibration_fallback_total",
                                reason="invalid") == 1
    q = tmp_path / "port.json"
    q.write_text(json.dumps(port_data()))
    assert ref_art.load_calibration(str(q), check_stale=False) is None


def _stale_device(d):
    d["device_kind"] = "NVIDIA Imaginary GPU"


def _stale_code(d):
    d["code_fingerprint"] = "0" * 40


@pytest.mark.parametrize("write,reason", [
    (lambda p: p.write_text("{definitely not json"), "unreadable"),
    (lambda p: p.write_text(json.dumps({**port_data(), "version": 99})),
     "invalid"),
    (lambda p: p.write_text(json.dumps(
        (lambda d: (_stale_device(d), d)[1])(port_data()))), "stale"),
    (lambda p: p.write_text(json.dumps(
        (lambda d: (_stale_code(d), d)[1])(port_data()))), "stale"),
], ids=["corrupt", "version", "stale-device", "stale-fingerprint"])
def test_bad_artifacts_fall_back_to_the_defaults(tmp_path, caplog, write,
                                                 reason):
    p = tmp_path / "calibration.json"
    write(p)
    obs.enable(reset=True)
    with caplog.at_level("WARNING", logger="jepsen_tpu_torch.tune"):
        tune.use(str(p), device="cpu")
        assert tune.active() is None
    assert "pinned engine defaults" in caplog.text
    assert obs.registry().value("jepsen_engine_calibration_fallback_total",
                                reason=reason) == 1
    assert execution.default_window() == execution.DEFAULT_WINDOW
    assert planning.flush_rows_default() == planning.DEFAULT_FLUSH_ROWS
    assert execution.row_bucket_floor() == execution.ROW_BUCKET
    assert cycles.closure_mode() == cycles.DEFAULT_CLOSURE_MODE
    hs = synth.generate_batch(seed=5, n_histories=3, n_ops=12)
    assert wgl.check_batch(models.cas_register(0), hs, device="cpu")


def test_a_good_artifact_loads_from_use_and_from_the_working_directory(
        tmp_path, monkeypatch):
    p = tmp_path / "elsewhere.json"
    art.save(port_data(), str(p))
    tune.use(str(p), device="cpu")
    assert tune.active().window() == 7
    monkeypatch.chdir(tmp_path)
    tune.reset_active()
    assert tune.resolved_path() is None  # no calibration.json here
    assert tune.active() is None
    art.save(port_data(), str(tmp_path / "calibration.json"))
    tune.reset_active()
    assert tune.resolved_path() == "calibration.json"
    # the default source is vetted against the current CUDA device, and
    # without one it falls back rather than crash
    if not torch.cuda.is_available():
        assert tune.active() is None
    tune.use(None)
    assert tune.active() is None


# -- the knob ladder -------------------------------------------------------


def test_resolve_knob_ladder():
    assert tune.resolve_knob(None, lambda c: c.window(), 4) == 4
    tune.set_active(art.Calibration(port_data()))
    assert tune.resolve_knob(None, lambda c: c.window(), 4) == 7
    assert tune.resolve_knob(2, lambda c: c.window(), 4) == 2


def test_engine_lookups_resolve_argument_calibration_default():
    assert execution.default_window() == 4
    assert planning.flush_rows_default() == 16384
    assert execution.row_bucket_floor() == 64
    assert cycles.closure_mode() == "fixed"
    tune.set_active(art.Calibration(port_data()))
    assert execution.default_window() == 7
    assert planning.flush_rows_default() == 123
    assert execution.row_bucket_floor() == 128
    assert execution.row_bucket_target(3) == 128
    assert cycles.closure_mode() == "earlyexit"
    assert execution.default_window(2) == 2
    assert planning.flush_rows_default(999) == 999
    assert execution.row_bucket_floor(48) == 64  # rounds up to pow2
    assert cycles.closure_mode("fixed") == "fixed"
    with pytest.raises(ValueError):
        cycles.closure_mode("adaptive")
    ex = execution.Executor(device="cpu")
    assert (ex.window_size, ex.row_bucket) == (7, 128)
    assert execution.Executor(2, device="cpu", row_bucket=32).row_bucket == 32
    p = planning.Planner(models.cas_register(0), slot_cap=8, device="cpu",
                         max_dispatch=64, frontier=16, n_devices=2)
    assert p.flush_rows == 2 * 123
    assert cycles.CyclePlan(16).mode == "earlyexit"
    assert cycles.ScreenPlan(16, (1,), (), "fixed").mode == "fixed"


# -- verdicts never depend on a knob ----------------------------------------


def _cas_corpus(pkg, n=8):
    rng = random.Random(45100)
    return [pkg.generate_history(rng, n_procs=3, n_ops=12, crash_p=0.02,
                                 corrupt=(i % 3 == 0)) for i in range(n)]


def _tpu_to_gpu(results):
    return [{**r, "engine": "gpu"} if r.get("engine") == "tpu" else r
            for r in results]


@pytest.fixture(scope="module")
def reference_verdicts():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("JEPSEN_TPU_CALIBRATION", raising=False)
        mp.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
        ref_tune.reset_active()
        ref_tune.set_active(None)
        model, hs = ref_models.cas_register(0), _cas_corpus(ref_synth)
        out = (ref_wgl.check_batch(model, hs, slot_cap=32),
               ref_wgl.check_batch(model, hs, slot_cap=32, max_closure=9))
        ref_tune.reset_active()
        return tuple(_tpu_to_gpu(r) for r in out)


def test_verdicts_tuned_and_untuned_equal_the_reference(reference_verdicts):
    model, hs = models.cas_register(0), _cas_corpus(synth)

    def run():
        return (wgl.check_batch(model, hs, slot_cap=32, device="cpu"),
                wgl.check_batch(model, hs, slot_cap=32, max_closure=9,
                                device="cpu"))

    untuned = run()
    tune.set_active(art.Calibration(port_data(
        window=1, flush_rows=2, row_bucket=32, closure_mode="earlyexit")))
    tuned = run()
    assert repr(tuned) == repr(untuned)
    assert untuned == reference_verdicts
    assert {r["kernel"] for r in untuned[0]} == {"dense"}
    assert {r["kernel"] for r in untuned[1]} == {"frontier"}


def test_screens_tuned_and_untuned_are_equal():
    encs = calibrate._screen_corpus(6)
    untuned = cycles.screen_graphs(encs, device="cpu")
    tune.set_active(art.Calibration(port_data(closure_mode="earlyexit")))
    tuned = cycles.screen_graphs(encs, device="cpu")
    for a, b in zip(untuned, tuned):
        assert a.members.keys() == b.members.keys()
        for m in a.members:
            assert np.array_equal(a.members[m], b.members[m])
        for q in a.walks:
            assert np.array_equal(a.walks[q], b.walks[q])


# -- the tuner on the CPU ---------------------------------------------------


def test_tuner_smoke_profile_on_the_cpu(tmp_path):
    out = tmp_path / "calibration.json"
    path, data = tune.run_tune(out_path=str(out), profile="smoke",
                               device="cpu", activate=False)
    assert path == str(out) and out.exists()
    assert (data["device_kind"], data["n_devices"]) == ("cpu", 1)
    assert tune.device_key("cpu") == ("cpu", 1)
    sweep = data["sweep"]
    assert sweep["budget_breaches"] == 0 and sweep["budget_checks"] > 0
    assert sweep["measured_configs"] >= 2
    assert data["cost_table"]
    assert {e["kernel"] for e in data["cost_table"]} >= {"dense",
                                                         "frontier",
                                                         "cycles"}
    assert set(data["params"]) == set(art.PARAM_KEYS)
    for e in data["cost_table"]:
        if e["kernel"] == "cycles":
            # a shape the screen kernel takes on the card (n a power of
            # two in [32, 512]), as the engine buckets it
            cycles._kernel_n(e["E"], 32, cycles.MAX_PLANE // 2)
    cal = art.load_calibration(path, device="cpu")
    assert cal is not None and cal.has_cost_table()
    with pytest.raises(ValueError):
        ref_art.validate(data)
    assert tune.active() is None  # activate=False leaves it alone


def test_cost_table_points_at_every_row_count_within_budget():
    """A bucket shorter than a point repeats its rows up to it, and a
    point past the budget is dropped before any launch."""
    prof = {**calibrate.PROFILES["smoke"], "n_hists": 6, "cost_rows": (4, 16),
            "screen_ns": (16, 33)}
    runner = calibrate._Runner(torch.device("cpu"))
    corpora = calibrate._corpora(prof)
    params = {"window": 4, "flush_rows": 16384, "row_bucket": 64,
              "closure_mode": "fixed"}
    table = calibrate.measure_cost_table(runner, corpora, prof, params)
    points = {(e["kernel"], e["E"], e["rows"]) for e in table}
    dense_E = {e["E"] for e in table if e["kernel"] == "dense"}
    assert dense_E and all(("dense", E, r) in points
                           for E in dense_E for r in (4, 16))
    assert {(E, r) for k, E, r in points if k == "cycles"} == \
        {(32, 4), (32, 16), (64, 4), (64, 16)}
    assert all(e["seconds"] > 0 for e in table)
    assert not runner.budget_breaches
    tiny = SimpleNamespace(fn=object(), disp=3, kernel="frontier", E=64,
                           C=4, frontier=64)
    assert not tune.proposal_within_budget(tiny, 4, params["window"])


def test_the_cli_prints_one_json_line(tmp_path, capsys):
    out = tmp_path / "cal.json"
    assert tune_main.main(["--profile", "smoke", "--device", "cpu",
                           "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["path"] == str(out) and line["device_kind"] == "cpu"
    assert set(line["params"]) == set(art.PARAM_KEYS)


def test_the_cli_without_cuda_exits_with_the_probes_error(tmp_path, capsys,
                                                          monkeypatch):
    from jepsen_tpu_torch import platform

    monkeypatch.setattr(platform, "probe_accelerator",
                        lambda **kw: (False, "no CUDA device present"))
    assert tune_main.main(["--profile", "smoke", "--out",
                           str(tmp_path / "c.json")]) == 1
    err = capsys.readouterr()
    assert "no CUDA device present" in err.err and not err.out
    assert not (tmp_path / "c.json").exists()


def test_journal_rows_read_back_as_cost_evidence(tmp_path):
    jp = tmp_path / "journal.jsonl"
    obs_journal.configure(str(jp))
    try:
        wgl.check_batch(models.cas_register(0), _cas_corpus(synth),
                        slot_cap=32, device="cpu")
        wgl.check_batch(models.cas_register(0), _cas_corpus(synth),
                        slot_cap=32, device="cpu")
    finally:
        obs_journal.configure(None)
    rows = tune.journal_rows(str(jp))
    assert rows and all(r["corpus"] == "journal" for r in rows)
    assert {r["kernel"] for r in rows} == {"dense"}
    assert any(r["cache"] == "hit" for r in rows)
    assert tune.journal_rows(str(jp), kernel="frontier") == []
    assert tune.journal_rows(str(tmp_path / "missing.jsonl")) == []
