"""The port's verdict write-ahead log (``jepsen_tpu_torch.obs.journal``'s
service half) against the JAX package's ``jepsen_tpu.obs.journal``.

The file format is the reference's: rows one package writes read back
equal through the other's ``read_verdict_rows`` / ``replay_index``, torn
tails and compactions included, and the two ``WalTail`` followers see
the same ``(offset, row)`` stream.  Tolerance: exact equality.
"""

import json
import os
import random

import pytest

from jepsen_tpu.obs import journal as ref_journal
from jepsen_tpu_torch import models, synth
from jepsen_tpu_torch.engine import decompose
from jepsen_tpu_torch.obs import journal

#: verdict dicts of the shapes the engine settles
RESULTS = [
    {"valid?": True, "engine": "gpu", "kernel": "dense"},
    {"valid?": False, "engine": "gpu", "kernel": "frontier",
     "failed-event": 17},
    {"valid?": "unknown", "engine": "oracle-overflow"},
    {"valid?": True, "engine": "mixed", "partitions": 3,
     "oracle-partitions": 1},
    {"valid?": False, "op": {"process": 2, "type": "ok", "f": "read",
                             "value": 4, "index": 9},
     "configs": [{"model": "CASRegister(3)", "last-op": None}]},
]

WRITERS = {"port": journal.VerdictWAL, "reference": ref_journal.VerdictWAL}
READERS = {"port": journal, "reference": ref_journal}


def _rows(seed, n):
    rng = random.Random(seed)
    return [(f"req-{rng.randrange(3)}", rng.choice(["main", "sub"]),
             rng.randrange(50), rng.choice(RESULTS)) for _ in range(n)]


def _stable(rows):
    """Rows without their write timestamps."""
    return [{k: v for k, v in r.items() if k != "ts"} for r in rows]


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port"),
                                           ("port", "port")])
def test_rows_read_back_equal_across_packages_torn_tails_included(
        tmp_path, writer, reader):
    path = str(tmp_path / "verdict-wal.jsonl")
    first, second = _rows(1, 12), _rows(2, 9)
    wal = WRITERS[writer](path)
    for row in first:
        assert wal.append(*row) is not None
    # a killed writer's half line, then a new writer that must seal it
    with open(path, "a") as f:
        f.write('{"v": 1, "req": "torn", "stre')
    wal = WRITERS[writer](path)
    for row in second:
        wal.append(*row)
    want = [{"v": 1, "req": q, "stream": s, "idx": i, "result": r}
            for q, s, i, r in first + second]
    rows = READERS[reader].read_verdict_rows(path)
    assert _stable(rows) == want
    assert rows == ref_journal.read_verdict_rows(path) == \
        journal.read_verdict_rows(path)
    assert READERS[reader].replay_index(path) == \
        ref_journal.replay_index(path)
    index = journal.replay_index(path)
    for q, s, i, r in first + second:
        assert (s, i) in index[q]
    assert "torn" not in index


def test_a_torn_tail_with_no_new_writer_is_skipped_by_both(tmp_path):
    path = str(tmp_path / "w.jsonl")
    wal = journal.VerdictWAL(path)
    for row in _rows(3, 5):
        wal.append(*row)
    with open(path, "a") as f:
        f.write('{"v": 1, "ts": 1.0, "req": "x"')
    assert journal.read_verdict_rows(path) == \
        ref_journal.read_verdict_rows(path)
    assert len(journal.read_verdict_rows(path)) == 5


@pytest.mark.parametrize("keep", [None, {"req-0"}, set()])
def test_compaction_matches_the_reference(tmp_path, keep):
    ours, ref = str(tmp_path / "ours.jsonl"), str(tmp_path / "ref.jsonl")
    rows = _rows(4, 20)
    a, b = journal.VerdictWAL(ours), ref_journal.VerdictWAL(ref)
    for row in rows:
        a.append(*row)
        b.append(*row)
    assert a.compact(keep_reqs=keep) == b.compact(keep_reqs=keep)
    assert _stable(journal.read_verdict_rows(ours)) == \
        _stable(ref_journal.read_verdict_rows(ref))
    assert not os.path.exists(ours + ".tmp")


def test_wal_tails_follow_appends_torn_lines_and_compaction_alike(tmp_path):
    path = str(tmp_path / "w.jsonl")
    wal = journal.VerdictWAL(path)
    ours, ref = journal.WalTail(path), ref_journal.WalTail(path)
    seen_ours, seen_ref = [], []

    def poll():
        seen_ours.extend(ours.poll())
        seen_ref.extend(ref.poll())

    for row in _rows(5, 4):
        wal.append(*row)
    poll()
    with open(path, "a") as f:
        f.write('{"v": 1, "req": "r", "stream": "main"')  # in progress
    poll()
    assert len(seen_ours) == 4
    wal = journal.VerdictWAL(path)  # seals the torn line
    for row in _rows(6, 3):
        wal.append(*row)
    poll()
    wal.compact(keep_reqs={"req-1"})
    poll()
    assert seen_ours == seen_ref
    assert [off for off, _ in seen_ours[:7]] == list(range(7))
    resumed = journal.WalTail(path, start=2).poll()
    assert resumed == ref_journal.WalTail(path, start=2).poll()


def test_validate_verdict_row_matches_the_reference():
    good = {"v": 1, "ts": 1.5, "req": "a", "stream": "main", "idx": 3,
            "result": {"valid?": True}}
    cases = [good, {**good, "idx": True}, {**good, "v": 2},
             {**good, "extra": 1}, {k: v for k, v in good.items()
                                    if k != "ts"},
             {**good, "result": []}, {**good, "ts": 3}, [good], None]
    for row in cases:
        assert journal.validate_verdict_row(row) == \
            ref_journal.validate_verdict_row(row)


def test_decomposed_run_writes_its_verdicts_and_replays_them(tmp_path):
    """A run's WAL rows (through the sink ``attach_wal`` installs) read back
    through the reference's ``replay_index``; replaying them into a fresh
    run of the same histories settles every slot before encode, so no
    row dispatches again, and the results equal the first run's."""
    from jepsen_tpu_torch.engine import execution, planning
    from jepsen_tpu_torch.ops import wgl

    rng = random.Random(7)
    model = models.multi_register({k: 0 for k in range(3)})
    hs = [synth.generate_mr_history(rng, n_procs=3, n_ops=24, n_keys=3,
                                    corrupt=i % 2 == 0) for i in range(4)]
    path = str(tmp_path / "wal.jsonl")
    wal = journal.VerdictWAL(path)

    def run_once(replay=None):
        run = decompose.DecomposedRun(model, hs)
        run.attach_wal(wal.sink_for("req-a"))
        filled = run.replay(replay) if replay else 0
        ex = execution.Executor(device="cpu")
        for _tag, ctx in run.streams():
            planner = planning.Planner(
                ctx.model, spec=ctx.spec, slot_cap=16, device="cpu",
                max_dispatch=wgl.DEFAULT_MAX_DISPATCH,
                frontier=wgl.DEFAULT_FRONTIER)
            buckets, order = planner.encode_buckets(ctx)
            for key in order:
                pb = planner.plan_rows(key, *buckets[key])
                if pb is not None:
                    ex.submit(pb)
        ex.drain()
        run.drain_oracles()
        return run, filled, ex.submitted

    first, filled, chunks = run_once()
    assert filled == 0 and chunks > 0
    assert first.n_decomposed > 0
    index = ref_journal.replay_index(path)
    assert set(index) == {"req-a"}
    assert len(index["req-a"]) == first.settled_count()
    rows_before = len(journal.read_verdict_rows(path))
    second, filled, chunks = run_once(journal.replay_index(path)["req-a"])
    assert filled == first.settled_count() and chunks == 0
    assert second.results() == first.results()
    # replayed slots are not written again
    assert len(journal.read_verdict_rows(path)) == rows_before
    assert json.dumps(second.results(), sort_keys=True) == \
        json.dumps(wgl.check_batch(model, hs, slot_cap=16, device="cpu"),
                   sort_keys=True)
