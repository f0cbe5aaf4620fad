"""The port's drift sentinel (``jepsen_tpu_torch.obs.drift``) against the
JAX package's ``jepsen_tpu.obs.drift``: one seeded row sequence fed to
both, with and without an equivalent calibration, gives equal
``snapshot()``s (score, stale shapes, ``retune_recommended``, skip
counters) and equal marker rows in each package's journal.
"""

import math
import random

import pytest

from jepsen_tpu import tune as ref_tune
from jepsen_tpu.obs import drift as ref_drift
from jepsen_tpu.obs import journal as ref_journal
from jepsen_tpu.tune import artifact as ref_art
from jepsen_tpu_torch import tune
from jepsen_tpu_torch.obs import drift, journal
from jepsen_tpu_torch.tune import artifact as art

COST_TABLE = [
    {"kernel": "dense", "E": 16, "C": 2, "F": 64, "rows": 32,
     "seconds": 0.0010},
    {"kernel": "dense", "E": 16, "C": 2, "F": 64, "rows": 256,
     "seconds": 0.0060},
    {"kernel": "frontier", "E": 64, "C": 4, "F": 64, "rows": 64,
     "seconds": 0.0200},
    {"kernel": "cycles", "E": 16, "C": 0, "F": 7, "rows": 16,
     "seconds": 0.0005},
]

SHAPES = [("dense", 8, 2, 64), ("dense", 16, 2, 64), ("dense", 32, 2, 64),
          ("dense", 64, 4, 64), ("frontier", 64, 4, 64),
          ("frontier", 128, 8, 128), ("cycles", 16, 0, 7),
          ("cycles", 32, 0, 7)]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_DRIFT_THRESHOLD", raising=False)
    monkeypatch.delenv("JEPSEN_TPU_CALIBRATION", raising=False)
    ref_tune.reset_active()
    ref_tune.set_active(None)
    tune.use(None)
    journal.configure(None)
    ref_journal.configure(None)
    yield
    journal.configure(None)
    ref_journal.configure(None)
    drift.disable()
    ref_tune.reset_active()
    tune.reset_active()


def _row(kernel="dense", E=8, C=2, F=64, rows=256, **over):
    base = dict(kernel=kernel, E=E, C=C, F=F, rows=rows, n_devices=1,
                mesh_shape=[1], window=4, compile_s=0.0,
                execute_s=drift.analytic_proxy(kernel, E, C, F, rows) * 1e-6,
                coalesced=1, cache="hit", closure_mode="", union="",
                calibration="", trace_id="")
    base.update(over)
    return base


def _rows(seed: int, n: int = 400):
    """A seeded row sequence: healthy shapes, one shape whose cost
    inflates (then recovers, then inflates again: two episodes), noise,
    compile rows and damaged rows."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        kernel, E, C, F = rng.choice(SHAPES)
        rows = rng.choice((16, 32, 64, 256, 1024))
        scale = rng.uniform(0.7, 1.4)
        if (kernel, E) == ("dense", 64) and (n // 4 < i < n // 2
                                             or i > 3 * n // 4):
            scale *= rng.uniform(3.0, 6.0)
        r = _row(kernel, E, C, F, rows)
        r["execute_s"] *= scale
        pick = rng.random()
        if pick < 0.05:
            r.update(cache="miss", compile_s=r["execute_s"], execute_s=0.0)
        elif pick < 0.07:
            r = {k: v for k, v in r.items() if k != "execute_s"}
        elif pick < 0.08:
            r["E"] = "wide"
        elif pick < 0.09:
            r = [r]
        out.append(r)
    return out


def _calibrations():
    port = art.Calibration(art.build_artifact(
        {"window": 4, "flush_rows": 16384, "row_bucket": 64,
         "closure_mode": "fixed"},
        [dict(e) for e in COST_TABLE], "cpu", 1, created_at="x"))
    ref = ref_art.Calibration(ref_art.build_artifact(
        {"window": 4, "flush_rows": 16384, "row_bucket": 64,
         "closure_mode": "fixed", "union_mode": "unroll",
         "closure_impl": "uint8"},
        [dict(e) for e in COST_TABLE], "cpu", 1, created_at="x"))
    return port, ref


def _strip(rows):
    """Marker rows without their time and calibration id (the two
    packages' artifacts differ in their code fingerprints)."""
    return [{k: v for k, v in r.items() if k not in ("ts", "calibration")}
            for r in rows]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["proxy", "calibration"])
@pytest.mark.parametrize("threshold,min_samples", [(2.0, 3), (1.5, 1)])
def test_snapshots_and_markers_equal_the_reference(tmp_path, seed,
                                                   calibrated, threshold,
                                                   min_samples):
    if calibrated:
        port, ref = _calibrations()
        tune.set_active(port)
        ref_tune.set_active(ref)
    journal.configure(str(tmp_path / "ours.jsonl"))
    ref_journal.configure(str(tmp_path / "theirs.jsonl"))
    ours = drift.DriftSentinel(threshold=threshold, min_samples=min_samples)
    theirs = ref_drift.DriftSentinel(threshold=threshold,
                                     min_samples=min_samples)
    for i, row in enumerate(_rows(seed)):
        assert ours.observe_row(row) == theirs.observe_row(row), i
        if i % 50 == 0:
            assert ours.snapshot() == theirs.snapshot(), i
    snap = ours.snapshot()
    assert snap == theirs.snapshot()
    assert snap["rows_scored"] > 300 and snap["shapes"] == len(SHAPES)
    assert snap["crossings"] >= 1
    assert set(snap["rows_skipped"]) <= set(drift.SKIP_REASONS)
    assert math.isfinite(snap["score"])
    markers = list(journal.read_rows(journal.path(), strict=True))
    ref_markers = list(ref_journal.read_rows(ref_journal.path(),
                                             strict=True))
    assert _strip(markers) == _strip(ref_markers)
    assert len(markers) == snap["crossings"]
    assert all(m["kernel"] == drift.MARKER_KERNEL for m in markers)
    assert all(ref_journal.validate_row(m) for m in markers)
    if calibrated:
        assert {m["calibration"] for m in markers} == {port.calibration_id}
        assert {m["calibration"] for m in ref_markers} == {ref.calibration_id}
    else:
        assert {m["calibration"] for m in markers + ref_markers} == {""}


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["proxy", "calibration"])
def test_predicted_seconds_and_proxy_equal_the_reference(calibrated):
    if calibrated:
        port, ref = _calibrations()
        tune.set_active(port)
        ref_tune.set_active(ref)
    for kernel in ("dense", "frontier", "cycles", "other"):
        for E in (0, 1, 8, 33, 64, 512):
            for C in (0, 2, 8):
                for F in (0, 1, 7, 64):
                    for rows in (0, 1, 256):
                        args = (kernel, E, C, F, rows)
                        assert drift.analytic_proxy(*args) == \
                            ref_drift.analytic_proxy(*args)
                        assert drift.predicted_seconds(*args) == \
                            ref_drift.predicted_seconds(*args), args


def test_scan_warm_start_equals_the_reference(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = journal.DispatchJournal(path)
    for row in _rows(7, 120):
        if isinstance(row, dict) and journal.validate_row(
                {**row, "v": 1, "ts": 0.0}):
            j.emit(**row)
    ours = drift.DriftSentinel(min_samples=2)
    theirs = ref_drift.DriftSentinel(min_samples=2)
    assert ours.scan(path) == theirs.scan(path) > 50
    assert ours.snapshot() == theirs.snapshot()
    assert drift.DriftSentinel().scan(str(tmp_path / "absent")) == 0


def test_malformed_rows_skip_as_in_the_reference():
    for row in ("not a dict", {}, {"kernel": "dense"},
                {"kernel": drift.MARKER_KERNEL, "rows": 0},
                _row(rows=0), _row(C=-1), _row(execute_s=0.0),
                _row(execute_s=float("nan")), _row(execute_s="fast"),
                _row(cache="miss")):
        ours, theirs = drift.DriftSentinel(), ref_drift.DriftSentinel()
        reason = ours.observe_row(row)
        assert reason == theirs.observe_row(row) and reason is not None
        assert ours.snapshot() == theirs.snapshot()


def test_the_process_sentinel_and_retune_recommended():
    assert drift.active() is None and not tune.retune_recommended()
    s = drift.configure(threshold=5.0)
    assert drift.active() is s and s.threshold == 5.0
    assert drift.DriftSentinel().threshold == drift.DEFAULT_THRESHOLD
    for E in (8, 16, 32):
        for _ in range(3):
            s.observe_row(_row(E=E))
    assert not tune.retune_recommended()
    for _ in range(3):
        row = _row(E=64)
        row["execute_s"] *= 8.0
        s.observe_row(row)
    assert tune.retune_recommended()
    drift.disable()
    assert drift.active() is None and not tune.retune_recommended()
