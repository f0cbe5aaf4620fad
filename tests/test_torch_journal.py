"""The port's dispatch journal (``jepsen_tpu_torch.obs.journal``) and the
Executor's journal rows and budget accounting, against the JAX package's
``jepsen_tpu.obs.journal``.

- Rows the port's Executor writes pass the reference's ``validate_row``,
  one per settled chunk, and the reference's ``read_rows`` reads them
  equal; rows the reference writes, the port reads equal.
- The same rows with the same ``max_bytes`` rotate into byte-equal files.
- Damage is skipped (or raises under ``strict``) as in the reference.
- No journal configured: nothing is written or built.
- ``Executor.chip_row_accounting`` keeps frontier chunks within one cap
  at any window depth, dense within cap × window.
"""

import json

import pytest
import torch

from jepsen_tpu.obs import journal as ref_journal
from jepsen_tpu_torch import models, obs, synth, tune
from jepsen_tpu_torch.engine import execution, planning
from jepsen_tpu_torch.obs import drift
from jepsen_tpu_torch.obs import journal
from jepsen_tpu_torch.ops import cycles, wgl
from jepsen_tpu_torch.tune import calibrate


def _row(**over):
    base = dict(
        kernel="dense", E=4, C=3, F=0, rows=32, n_devices=1,
        mesh_shape=[1], window=4, compile_s=0.0, execute_s=0.002,
        coalesced=1, cache="hit", closure_mode="", union="",
        calibration="", trace_id="ab12",
    )
    base.update(over)
    return base


@pytest.fixture(autouse=True)
def _no_journal():
    """No journal, sentinel or calibration before or after a test."""
    journal.configure(None)
    drift.disable()
    tune.use(None)
    yield
    journal.configure(None)
    drift.disable()
    tune.reset_active()


def _dispatches() -> float:
    reg = obs.registry()
    return sum(reg.value("jepsen_kernel_dispatches_total", engine=e,
                         phase=p) or 0
               for e in ("dense", "frontier", "cycles")
               for p in ("compile", "execute"))


# -- schema ------------------------------------------------------------------


def test_the_schema_is_the_references():
    assert journal._SCHEMA == ref_journal._SCHEMA
    assert (journal.SCHEMA_VERSION, journal.DEFAULT_MAX_BYTES,
            journal.DEFAULT_FILENAME) == (ref_journal.SCHEMA_VERSION,
                                          ref_journal.DEFAULT_MAX_BYTES,
                                          ref_journal.DEFAULT_FILENAME)


@pytest.mark.parametrize("breakage", [
    {}, {"v": 2}, {"kernel": 7}, {"rows": "32"}, {"rows": True},
    {"cache": "warm"}, {"mesh_shape": "1x1"}, {"surprise": 1},
    {"execute_s": None}, {"ts": "now"},
])
def test_validate_row_agrees_with_the_reference(breakage):
    row = {**_row(), "v": 1, "ts": 1.0, **breakage}
    assert journal.validate_row(row) == ref_journal.validate_row(row)
    assert journal.validate_row(row) is (not breakage)
    missing = dict(row)
    del missing["kernel"]
    assert journal.validate_row(missing) is False
    assert journal.validate_row([row]) is False


# -- rows the engine writes --------------------------------------------------


def test_engine_rows_are_the_references_one_per_settled_dispatch(tmp_path):
    path = str(tmp_path / "j.jsonl")
    hs = synth.generate_batch(seed=11, n_histories=40, n_procs=3, n_ops=30)
    obs.enable(reset=True)
    journal.configure(path)
    wgl.check_batch(models.cas_register(0), hs, slot_cap=32, device="cpu",
                    window=2)
    wgl.check_batch(models.cas_register(0), hs, slot_cap=32, device="cpu",
                    window=2, max_closure=9)
    encs = calibrate._screen_corpus(4)
    cycles.screen_graphs(encs, device="cpu", mode="earlyexit")
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == _dispatches() > 2
    assert all(ref_journal.validate_row(r) for r in lines)
    ours = list(journal.read_rows(path, strict=True))
    assert ours == lines == list(ref_journal.read_rows(path, strict=True))
    assert {r["kernel"] for r in lines} == {"dense", "frontier", "cycles"}
    for r in lines:
        assert r["union"] == "" and r["mesh_shape"] == [1]
        assert r["n_devices"] == 1 and r["window"] in (2, 4)
        assert r["calibration"] == "" and r["coalesced"] == 1
        hit = r["cache"] == "hit"
        assert (r["execute_s"] > 0) == hit and (r["compile_s"] > 0) != hit
        assert r["closure_mode"] == ("earlyexit" if r["kernel"] == "cycles"
                                     else "")


def test_journal_context_and_calibration_id_reach_the_row(tmp_path):
    path = str(tmp_path / "j.jsonl")
    cal = tune.Calibration(tune.build_artifact(
        {"window": 3, "flush_rows": 64, "row_bucket": 32,
         "closure_mode": "fixed"}, [], "cpu", 1, created_at="x"))
    tune.set_active(cal)
    journal.configure(path)
    ex = execution.Executor(device="cpu")
    ex.journal_context.update(coalesced=3, trace_id="t1,t2")
    cycles.screen_graphs(calibrate._screen_corpus(2), executor=ex)
    rows = list(journal.read_rows(path, strict=True))
    assert rows and all(r["coalesced"] == 3 and r["trace_id"] == "t1,t2"
                        and r["calibration"] == cal.calibration_id
                        and r["window"] == 3 and r["closure_mode"] == "fixed"
                        for r in rows)


def test_nothing_is_journalled_without_a_journal(tmp_path, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("journalled with no journal configured")

    monkeypatch.setattr(execution.Executor, "_journal_dispatch", refuse)
    monkeypatch.chdir(tmp_path)
    hs = synth.generate_batch(seed=12, n_histories=4, n_ops=20)
    assert wgl.check_batch(models.cas_register(0), hs, device="cpu")
    assert list(tmp_path.iterdir()) == []


def test_the_sentinel_scores_every_journalled_row(tmp_path):
    journal.configure(str(tmp_path / "j.jsonl"))
    sentinel = drift.configure()
    hs = synth.generate_batch(seed=13, n_histories=6, n_ops=20)
    for _ in range(3):
        wgl.check_batch(models.cas_register(0), hs, device="cpu")
    snap = sentinel.snapshot()
    n_rows = len(list(journal.read_rows(journal.path())))
    assert snap["rows_scored"] + sum(snap["rows_skipped"].values()) == n_rows
    assert snap["rows_scored"] >= 2 and snap["shapes"] >= 1
    assert set(snap["rows_skipped"]) <= {"not-hit"}


# -- both packages read each other's files -----------------------------------


def test_reference_rows_read_equal_in_the_port(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = ref_journal.DispatchJournal(path)
    written = [j.emit(**_row(rows=i, union="gather" if i % 2 else ""))
               for i in range(5)]
    assert all(written)
    assert list(journal.read_rows(path, strict=True)) == written


def test_rotation_matches_the_reference_byte_for_byte(tmp_path):
    ours = journal.DispatchJournal(str(tmp_path / "ours.jsonl"),
                                   max_bytes=600)
    theirs = ref_journal.DispatchJournal(str(tmp_path / "theirs.jsonl"),
                                         max_bytes=600)
    for i in range(12):
        row = _row(rows=i, ts=1700000000.0 + i, v=1)
        assert ours.emit(**row) == theirs.emit(**row) is not None
    assert len(ours.files()) == len(theirs.files()) == 2
    for a, b in zip(ours.files(), theirs.files()):
        assert open(a, "rb").read() == open(b, "rb").read()
    got = [r["rows"] for r in journal.read_rows(ours.path, strict=True)]
    assert got == [r["rows"] for r in ref_journal.read_rows(theirs.path)]
    assert got[-1] == 11 and len(got) < 12 and got == sorted(got)
    assert (ours.written, ours.dropped) == (theirs.written, theirs.dropped)


def test_damage_is_skipped_unless_strict(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = journal.DispatchJournal(path)
    j.emit(**_row())
    with open(path, "a") as f:
        f.write("{not json\n")
        f.write(json.dumps({"v": 1, "ts": 1.0}) + "\n")
        f.write("\n")
    j.emit(**_row(rows=99))
    assert [r["rows"] for r in journal.read_rows(path)] == [32, 99]
    assert list(journal.read_rows(path)) == list(ref_journal.read_rows(path))
    with pytest.raises(ValueError):
        list(journal.read_rows(path, strict=True))
    assert list(journal.read_rows(str(tmp_path / "absent"))) == []
    assert j.emit(**_row(cache="warm")) is None
    assert (j.written, j.dropped) == (2, 1)


def test_the_module_journal_is_a_noop_until_configured(tmp_path):
    assert journal.active() is None and journal.path() is None
    assert journal.emit(**_row()) is None
    path = str(tmp_path / "j.jsonl")
    journal.configure(path)
    assert journal.path() == path
    assert journal.emit(**_row()) is not None
    assert journal.active().written == 1


# -- budget accounting -------------------------------------------------------


@pytest.mark.parametrize("window", [1, 2, 4])
def test_chip_row_accounting_stays_within_the_caps(window):
    hs = synth.generate_batch(seed=14, n_histories=24, n_procs=3, n_ops=16)
    for max_closure, max_dispatch in ((None, 8), (9, 8), (9, 3)):
        ex = execution.Executor(window, device="cpu",
                                max_dispatch=max_dispatch, row_bucket=2)
        ctx = planning.RunContext(models.cas_register(0), hs,
                                  oracle_fallback=False)
        planner = planning.Planner(
            models.cas_register(0), slot_cap=32, device="cpu",
            max_dispatch=max_dispatch, frontier=16, max_closure=max_closure)
        stream = planner.open_stream()
        for idx in range(len(hs)):
            for pb in stream.feed(ctx, idx):
                ex.submit(pb)
        for pb in stream.finish():
            ex.submit(pb)
        ex.drain()
        assert ex.chip_row_accounting and ex.submitted > 2
        for (kernel, _E, _C, _F, cap), acct in ex.chip_row_accounting.items():
            assert acct["chip_cap"] == cap and acct["kernel"] == kernel
            limit = cap * window if kernel == "dense" else cap
            assert 0 < acct["peak_chip_rows"] <= limit
        assert all(v == 0 for v in ex._chip_rows_inflight.values())
        runner = calibrate._Runner(torch.device("cpu"))
        runner._collect_budget(ex)
        assert runner.budget_evidence and not runner.budget_breaches
