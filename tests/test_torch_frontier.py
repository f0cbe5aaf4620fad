"""The port's frontier search (kernels K4 with K3 and K5, plain PyTorch)
and its escalation ladder against the JAX package.

- The plain version :func:`wgl.frontier_check_reference` against
  ``jax.jit(build_batched(..., compaction="allpairs"))`` on the same numpy
  inputs, for every step spec, at small frontiers that overflow, with
  closures cut at ``max_closure``, and with two linset words.  Tolerance:
  exact — ``ok``, ``failed_at`` and ``overflow`` are integers or bools,
  compared byte for byte on every row, overflowed rows included.
- The same inputs against ``compaction="sort"``, which compacts in
  another order: equal overflow flags everywhere, equal verdicts where no
  row overflowed.
- ``check_batch(device="cpu")`` against the reference's ``check_batch``
  run with its exact ``sort`` compaction: whole result dicts equal
  (``"tpu"`` → ``"gpu"``), on corpora that reach the base pass, the F×4
  rung, the sufficient rung, ``oracle-overflow`` and an explicit
  ``max_closure`` truncation.

The CUDA kernel is held against the same plain version on the card by
``chip_smoke.py``.  Frontiers stay at F ≤ 16 where JAX runs ``allpairs``,
whose cost is quadratic in F·(C+1).
"""

import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jepsen_tpu import models as ref_models
from jepsen_tpu import synth as ref_synth
from jepsen_tpu import history as ref_history
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu_torch import models, synth
from jepsen_tpu_torch import history as port_history
from jepsen_tpu_torch.engine.execution import Executor
from jepsen_tpu_torch.ops import encode, step_kernels, wgl
from jepsen_tpu_torch.ops.step_kernels import (
    F_ACQUIRE, F_CAS, F_DEQUEUE, F_ENQUEUE, F_RACQUIRE, F_READ, F_READ_ANY,
    F_RELEASE, F_RRELEASE, F_WRITE)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain version issues many small tensor ops; one thread avoids
    oversubscribing the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_escalation_counter():
    wgl.ESCALATIONS.clear()
    yield
    wgl.ESCALATIONS.clear()


def _synth_arrays(spec, seed, n=10, n_procs=5, n_ops=50, n_values=6,
                  slot_cap=16):
    rng = random.Random(seed)
    model = models.register(0) if spec == "register" else \
        models.cas_register(0)
    weights = (1, 1, 0) if spec == "register" else None
    hs = [synth.generate_history(rng, n_procs=n_procs, n_ops=n_ops,
                                 crash_p=0.05, n_values=n_values,
                                 corrupt=i % 3 == 0, op_weights=weights)
          for i in range(n)]
    b = encode.batch_encode(hs, model, slot_cap=slot_cap)
    arrays = [b.init_state, b.ev_slot, b.cand_slot, b.cand_f, b.cand_a,
              b.cand_b]
    # two all-padding rows: ok, never failed, never overflowed
    return tuple(np.concatenate([a, np.full((2,) + a.shape[1:], f, a.dtype)])
                 for a, f in zip(arrays, wgl._PAD_FILLS))


#: op codes and value-id bound of each spec's random arrays
_RANDOM_OPS = {
    "mutex": ([F_ACQUIRE, F_RELEASE], 2),
    "owner-mutex": ([F_READ, F_WRITE, F_CAS, F_READ_ANY], 4),
    "reentrant-mutex": ([F_RACQUIRE, F_RRELEASE], 3),
    "multi-register": ([F_READ, F_WRITE, F_READ_ANY], 5),
    "unordered-queue": ([F_ENQUEUE, F_DEQUEUE], 34),
}


def _random_arrays(spec, seed, B=8, E=32, C=6):
    """Seeded random encoded batches of ``spec``: ops with random codes
    (the spec's own) and value ids open into free slots;
    each event completes one open op, mostly one the spec's step accepts
    in a sequential run (so rows live long enough to grow the frontier),
    sometimes any op; ops left open act as crashed ones.  Padding events
    come at random and while no open op can complete.  The unordered queue's value ids pass 31, where its
    shift yields no bit."""
    r = np.random.default_rng(seed)
    step = step_kernels.STEPS[spec]
    fs, amax = _RANDOM_OPS[spec]
    codes = fs
    init = np.zeros((B,), np.int32)
    ev = np.full((B, E), -1, np.int32)
    cs = np.full((B, E, C), -1, np.int8)
    cf = np.zeros((B, E, C), np.int8)
    ca = np.zeros((B, E, C), np.int16)
    cb = np.zeros((B, E, C), np.int16)

    def run(state, op):
        s2, ok = step(*(torch.tensor([x], dtype=dt) for x, dt in zip(
            (state,) + op, (torch.int32, torch.int8, torch.int16,
                            torch.int16))))
        return int(s2[0]), bool(ok[0])

    for row in range(B):
        state, open_ops = int(init[row]), {}
        for e in range(E):
            free = [c for c in range(C) if c not in open_ops]
            while free and (not open_ops or r.random() < 0.6):
                slot = free.pop(int(r.integers(0, len(free))))
                open_ops[slot] = (int(codes[r.integers(0, len(codes))]),
                                  int(r.integers(0, amax + 1)),
                                  int(r.integers(0, 4)))
            accepted = [c for c in open_ops if run(state, open_ops[c])[1]]
            if r.random() < 0.1 or not (accepted or r.random() < 0.1):
                continue  # padding, or wait for an op that can complete
            lanes = list(open_ops)
            r.shuffle(lanes)
            for lane, slot in enumerate(lanes):
                cs[row, e, lane] = slot
                cf[row, e, lane], ca[row, e, lane], cb[row, e, lane] = \
                    open_ops[slot]
            pool = accepted if accepted and r.random() < 0.95 else lanes
            done = pool[int(r.integers(0, len(pool)))]
            state2, ok = run(state, open_ops.pop(done))
            state = state2 if ok else state
            ev[row, e] = done
    return init, ev, cs, cf, ca, cb


def _two_word_arrays():
    """The synth corpus at C = 40 with every slot id moved up by 32, so
    every linset bit lives in word 1 (as tests/test_wgl.py does)."""
    init, ev, cs, cf, ca, cb = _synth_arrays("cas-register", 4242, n=6,
                                             n_procs=4, n_ops=30)
    B, E, C = cs.shape
    C2 = 40
    cs2 = np.full((B, E, C2), -1, np.int8)
    cs2[:, :, :C] = np.where(cs >= 0, cs + 32, cs)
    wide = [np.zeros((B, E, C2), a.dtype) for a in (cf, ca, cb)]
    for w, a in zip(wide, (cf, ca, cb)):
        w[:, :, :C] = a
    return (init, np.where(ev >= 0, ev + 32, ev).astype(np.int32), cs2,
            *wide)


def _ours(arrays, spec, F, mc):
    out = wgl.frontier_check_reference(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
        spec_name=spec, F=F, max_closure=mc)
    return [x.numpy() for x in out]


def _jax(arrays, spec, F, mc, compaction):
    E, C = arrays[2].shape[1:]
    fn = jax.jit(ref_wgl.build_batched(spec, E, C, F, mc, compaction))
    return [np.asarray(x) for x in fn(*(jnp.asarray(a) for a in arrays))]


_PARITY = [
    # (case, spec, arrays, F, max_closure; None = C + 1)
    ("cas-F4", "cas-register", lambda: _synth_arrays("cas-register", 1), 4,
     None),
    ("cas-F8", "cas-register", lambda: _synth_arrays("cas-register", 1), 8,
     None),
    ("cas-F16", "cas-register", lambda: _synth_arrays("cas-register", 1),
     16, None),
    ("cas-mc1", "cas-register", lambda: _synth_arrays("cas-register", 1), 8,
     1),
    ("cas-mc2", "cas-register", lambda: _synth_arrays("cas-register", 1), 8,
     2),
    ("register-F8", "register", lambda: _synth_arrays("register", 2), 8,
     None),
    ("W2-F4", "cas-register", _two_word_arrays, 4, None),
    # a first pass that finds exactly F configs, and one that finds F + 1
    ("fill-F", "cas-register", lambda: chip_smoke.fill_rows(16, 16, 15), 16,
     None),
    ("fill-F+1", "cas-register", lambda: chip_smoke.fill_rows(16, 16, 16),
     16, None),
] + [(f"{spec}-F8", spec, lambda spec=spec: _random_arrays(spec, i), 8, None)
     for i, spec in enumerate(_RANDOM_OPS)]


@pytest.mark.parametrize("case,spec,make,F,mc", _PARITY,
                         ids=[c[0] for c in _PARITY])
def test_plain_version_equals_jax_allpairs(case, spec, make, F, mc):
    arrays = make()
    mc = arrays[2].shape[2] + 1 if mc is None else mc
    ref = _jax(arrays, spec, F, mc, "allpairs")
    ours = _ours(arrays, spec, F, mc)
    for name, o, r in zip(("ok", "failed_at", "overflow"), ours, ref):
        assert o.dtype == r.dtype and o.tobytes() == r.tobytes(), name
    if case.startswith(("cas-F4", "cas-mc1", "W2")):
        assert ref[2].any()  # the case reaches overflow/truncation
    if case == "fill-F":
        assert not ref[2].any() and (ref[1] > 0).any()
    if case == "fill-F+1":
        assert ref[2].all()


@pytest.mark.parametrize("case,spec,make,F,mc", _PARITY,
                         ids=[c[0] for c in _PARITY])
def test_closure_survivors_come_only_from_the_last_pass(case, spec, make, F,
                                                        mc):
    """The semi-naive order the CUDA kernel relies on: no closure pass
    keeps a candidate whose parent an earlier pass of the same event
    expanded, on every parity corpus (every step spec, overflowing
    frontiers, max_closure cuts, two linset words), so expanding only the
    configs the last pass appended loses nothing.  The frontier never
    holds more than F configs."""
    arrays = make()
    mc = arrays[2].shape[2] + 1 if mc is None else mc
    work: dict = {}
    plain = wgl.frontier_check_reference(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
        spec_name=spec, F=F, max_closure=mc, work=work)
    assert work["stale_survivors"] == 0
    assert 1 <= work["max_frontier"] <= F
    # the counts leave the outputs alone
    assert [x.numpy().tobytes() for x in plain] == [
        x.tobytes() for x in _ours(arrays, spec, F, mc)]


def test_frontier_design_matches_the_kernel_source():
    """``wgl.frontier_design`` mirrors the CUDA launch's switch: the warp
    design while C ≤ kWarpMaxC and F·(1 + W) + T ≤ kWarpMaxWords (T the
    table's power of two ≥ 4F and ≥ 8), the block design beyond."""
    src = (Path(wgl.__file__).parent / "csrc" / "frontier_search.cu"
           ).read_text()
    words = re.search(r"#define FRONTIER_WARP_MAX_WORDS (\d+)", src)
    max_c = re.search(r"constexpr int kWarpMaxC = (\d+);", src)
    assert words and int(words.group(1)) == wgl.FRONTIER_WARP_MAX_WORDS
    assert max_c and int(max_c.group(1)) == wgl.FRONTIER_WARP_MAX_C
    design = wgl.frontier_design
    # the slice, its first escalation rung, phase 19's mesh, the queue
    for F, C in ((128, 8), (512, 8), (512, 16), (32, 8), (256, 8)):
        assert design(F, C) == "warp"
    # F: 1024 configs of two words and a 4096-slot table take 7168 words
    assert design(1024, 32) == "warp" and design(2048, 8) == "block"
    assert design(1024, 64) == "warp" and design(1025, 8) == "block"
    # C: two linset words at most
    assert design(16, 64) == "warp" and design(16, 65) == "block"
    # the sufficient rung's large capacities
    assert design(4096, 4) == "block" and design(8192, 12) == "block"
    assert chip_smoke.frontier_switch_capacity(16) == 1024


@pytest.mark.parametrize("spec,make", [
    ("cas-register", lambda: _synth_arrays("cas-register", 3)),
    ("reentrant-mutex", lambda: _random_arrays("reentrant-mutex", 7)),
])
def test_plain_version_agrees_with_jax_sort(spec, make):
    arrays = make()
    mc = arrays[2].shape[2] + 1
    ref = _jax(arrays, spec, 8, mc, "sort")
    ours = _ours(arrays, spec, 8, mc)
    np.testing.assert_array_equal(ours[2], ref[2])
    settled = ~ref[2]
    assert settled.any() and ref[2].any()
    np.testing.assert_array_equal(ours[0][settled], ref[0][settled])
    np.testing.assert_array_equal(ours[1][settled], ref[1][settled])


def test_work_counts_the_operations_the_search_needs():
    """Semi-naive counts, by hand (W = 1, so 5 per table entry).

    One slot, a write of 1 over initial 0, then its completion.  Pass 1
    expands the starting config by its slot (4) and enters it and its
    one valid candidate in the table (2 × 5); pass 2 expands only the
    config pass 1 added (4) and finds nothing new (0); completion keeps
    3 × 2 configs: 24.  Cut at max_closure = 1: pass 1 and the
    completion, 20, and the row overflows.

    Two slots, writes of 1 and 2, completion of slot 0: pass 1 expands 1
    config by 2 slots (8) with 1 + 2 table entries (15); pass 2 the 2
    added configs (16) with 2 new candidates (10); pass 3 the 2 configs
    pass 2 added (16) with none; completion 3 × 5 configs: 80."""

    def count(slots, values, F, mc):
        C = len(slots)
        arrays = (np.array([0], np.int32), np.array([[0]], np.int32),
                  np.array([[slots]], np.int8),
                  np.full((1, 1, C), F_WRITE, np.int8),
                  np.array([[values]], np.int16), np.zeros((1, 1, C), np.int16))
        work: dict = {}
        ok, _, overflow = wgl.frontier_check_reference(
            *(torch.from_numpy(a) for a in arrays), spec_name="cas-register",
            F=F, max_closure=mc, work=work)
        assert ok.tolist() == [True]
        return work["int_ops"], bool(overflow[0])

    assert count([0], [1], F=4, mc=2) == (24, False)
    assert count([0], [1], F=4, mc=1) == (20, True)
    assert count([0, 1], [1, 2], F=8, mc=3) == (80, False)


# ---------------------------------------------------------------------------
# check_batch through the engine vs the reference's check_batch
# ---------------------------------------------------------------------------


def _ref_check(hs, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
        return ref_wgl.check_batch(ref_models.cas_register(0), hs, **kw)


def _port_check(hs, **kw):
    return wgl.check_batch(models.cas_register(0), hs, device="cpu", **kw)


def _as_port(results):
    return [dict(r, engine="gpu") if r["engine"] == "tpu" else r
            for r in results]


def _pair(seed, n, **kw):
    """The same histories from both packages' synth."""
    r1, r2 = random.Random(seed), random.Random(seed)
    ours = [synth.generate_history(r1, corrupt=i % 3 == 0, **kw)
            for i in range(n)]
    ref = [ref_synth.generate_history(r2, corrupt=i % 3 == 0, **kw)
           for i in range(n)]
    return ours, ref


def test_base_pass_equals_reference():
    """Value domains past 32 leave the dense envelope; F = 128 settles
    every row on the device."""
    ours, ref = _pair(11, 6, n_procs=3, n_ops=200, n_values=200,
                      crash_p=0.02)
    got = _port_check(ours)
    assert got == _as_port(_ref_check(ref))
    assert wgl.batch_stats(got)["kernels"] == {"frontier": 6}
    assert any(r["valid?"] is False for r in got)
    assert wgl.ESCALATIONS == {}


def test_escalation_rung_equals_reference():
    """frontier=4 overflows on every frontier row; the F×4 rung re-runs
    them at F = 16 and settles some, the oracle takes the rest."""
    ours, ref = _pair(7, 6, n_procs=4, n_ops=200, n_values=200,
                      crash_p=0.02)
    got = _port_check(ours, frontier=4, sufficient_rung=False)
    assert got == _as_port(_ref_check(ref, frontier=4,
                                      sufficient_rung=False))
    stats = wgl.batch_stats(got)
    n_frontier = (stats["kernels"].get("frontier", 0)
                  + stats["engines"].get("oracle-overflow", 0))
    assert wgl.ESCALATIONS == {16: n_frontier}
    assert stats["kernels"].get("frontier", 0) > 0
    assert stats["engines"].get("oracle-overflow", 0) > 0


def test_sufficient_rung_equals_reference():
    """With no factor rungs, overflowed rows go straight to the capacity
    that cannot overflow (n_values·2^C, a power of two ≤ 8192) and settle
    there: nothing reaches the oracle."""
    ours, ref = _pair(3, 4, n_procs=4, n_ops=150, n_values=200,
                      crash_p=0.0)
    got = _port_check(ours, frontier=16, escalation=())
    assert got == _as_port(_ref_check(ref, frontier=16, escalation=()))
    assert len(wgl.ESCALATIONS) == 1
    (capacity, rows), = wgl.ESCALATIONS.items()
    assert rows > 0 and capacity > 16
    assert capacity == wgl.sufficient_frontier(42, 4) or capacity == \
        wgl.sufficient_frontier(42, 8)
    assert wgl.batch_stats(got)["engines"] == {"gpu": 4}


def test_oracle_overflow_equals_reference():
    """Crash-heavy high concurrency (C = 16): the base pass and the F×4
    rung overflow, no sufficient capacity is affordable, and the oracle
    decides those rows."""
    ours, ref = _pair(5, 2, n_procs=10, n_ops=60, crash_p=0.3,
                      replace_crashed=True)
    got = _port_check(ours, frontier=8)
    assert got == _as_port(_ref_check(ref, frontier=8))
    assert wgl.batch_stats(got)["engines"].get("oracle-overflow", 0) > 0
    assert wgl.ESCALATIONS.get(32, 0) > 0


def _needs_two_closure_passes(history_module):
    """The reference's truncation history (tests/test_wgl.py), built with
    ``history_module`` — either package's ``history``."""
    h = history_module
    hist = h.History([
        h.invoke_op(0, "write", 1),
        h.invoke_op(1, "write", 2),
        h.invoke_op(2, "read"),
        h.ok_op(2, "read", 2),
        h.ok_op(1, "write", 2),
        h.ok_op(0, "write", 1),
    ])
    for i, op in enumerate(hist):
        op.index = i
        op.time = i
    return hist


def test_truncated_closure_equals_reference():
    """max_closure=1 forces the frontier search and cuts a closure that
    needs two passes: overflow, every rung cut the same way, the oracle
    decides (valid)."""
    kw = dict(max_closure=1)
    got = wgl.check_batch(models.register(0),
                          [_needs_two_closure_passes(port_history)],
                          device="cpu", **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
        ref = ref_wgl.check_batch(ref_models.register(0),
                                  [_needs_two_closure_passes(ref_history)],
                                  **kw)
    assert got == _as_port(ref)
    assert got[0]["engine"] == "oracle-overflow"
    assert got[0]["valid?"] is True
    assert wgl.ESCALATIONS  # the ladder ran before the oracle


def test_parked_chunks_merge_and_escalate_like_one_batch():
    """A small dispatch cap splits the bucket into many chunks; their
    overflowed rows park, merge at drain and escalate once per rung:
    results equal the one-chunk serial run."""
    ours, _ = _pair(7, 10, n_procs=4, n_ops=200, n_values=200, crash_p=0.02)
    whole = _port_check(ours, frontier=4, window=1)
    once = dict(wgl.ESCALATIONS)
    wgl.ESCALATIONS.clear()
    chunked = _port_check(ours, frontier=4, max_dispatch=3, window=4)
    assert chunked == whole
    assert wgl.ESCALATIONS == once and once[16] > 3


def test_executor_keeps_frontier_chunks_within_one_cap(monkeypatch):
    """Each frontier chunk gets 1/window of the plan's cap; a cap below
    the window dispatches serially at the full cap."""
    from jepsen_tpu_torch.engine import pipeline

    ours, _ = _pair(7, 10, n_procs=4, n_ops=200, n_values=200, crash_p=0.02)
    seen = []

    class Spy(Executor):
        def _dispatch(self, plan, chunk, rows):
            if plan.kernel == "frontier":
                seen.append((len(rows), len(self._win._inflight)))
            super()._dispatch(plan, chunk, rows)

    monkeypatch.setattr(pipeline, "Executor", Spy)
    _port_check(ours, frontier=4, max_dispatch=8, window=4)
    n_rows = sum(n for n, _ in seen)
    assert n_rows > 4 and all(n <= 2 for n, _ in seen)
    seen.clear()
    _port_check(ours, frontier=4, max_dispatch=3, window=4)
    assert sum(n for n, _ in seen) == n_rows
    assert max(n for n, _ in seen) == 3
    assert all(depth == 0 for _, depth in seen)


# ---------------------------------------------------------------------------
# routing facts, caps and the kernel's wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["cas-register", "unordered-queue"])
def test_sufficient_frontier_equals_reference(spec):
    for n_values in (1, 2, 5, 42, 200):
        for C in (1, 4, 8, 12, 16, 31):
            assert wgl.sufficient_frontier(n_values, C, spec) == \
                ref_wgl.sufficient_frontier(n_values, C, spec)


def test_ladder_constants_equal_reference():
    assert wgl.ESCALATION_FACTORS == ref_wgl.ESCALATION_FACTORS
    assert wgl.MAX_SUFFICIENT_FRONTIER == ref_wgl.MAX_SUFFICIENT_FRONTIER
    assert wgl.DEFAULT_FRONTIER == ref_wgl.DEFAULT_FRONTIER


def test_dispatch_cap_follows_the_workspace_budget():
    # the slice's shape: one 1000-op row holds ~34 KB of workspace (K =
    # 1152 lanes of state, word and table slot, a table of < 4K slots, two
    # frontiers) beside its inputs and outputs
    per_row = wgl.frontier_row_bytes(128, 704, 8)
    assert per_row == (4 * (1152 * 3 + 4 * 1152 + 2 * 128 * 2) + 16
                       + 4 + 4 * 704 + 6 * 704 * 8 + 6)
    assert wgl.frontier_max_dispatch(128, 704, 8) == min(
        wgl.DEFAULT_MAX_DISPATCH, wgl.FRONTIER_DISPATCH_BUDGET // per_row)
    assert wgl.frontier_max_dispatch(128, 704, 8, max_dispatch=5) == 5
    # a capacity whose single row exceeds the budget is never dispatched
    assert wgl.frontier_max_dispatch(1 << 24, 64, 16) == 0
    # caps shrink as the capacity grows
    caps = [wgl.frontier_max_dispatch(F, 4096, 16, 1 << 30)
            for F in (128, 512, 2048, 8192)]
    assert caps == sorted(caps, reverse=True) and caps[-1] > 0


def test_frontier_plan_and_cost():
    ours, _ = _pair(11, 2, n_procs=3, n_ops=200, n_values=200, crash_p=0.02)
    b = encode.batch_encode(ours, models.cas_register(0))
    arrays = (b.init_state, b.ev_slot, b.cand_slot, b.cand_f, b.cand_a,
              b.cand_b)
    model = models.cas_register(0)
    spec = step_kernels.spec_for(model)
    plan = wgl.plan_bucket(model, spec, arrays, device=torch.device("cpu"))
    E, C = b.ev_slot.shape[1], b.cand_slot.shape[2]
    assert plan.kernel == "frontier" and plan.mc == C + 1
    assert plan.frontier == 128 and plan.n_values > 32
    assert plan.fn is wgl.make_check_fn("cas-register", E, C, 128, C + 1,
                                        torch.device("cpu"))
    assert plan.disp == plan.fn.safe_dispatch
    forced = wgl.plan_bucket(model, spec, arrays,
                             device=torch.device("cpu"), max_closure=0)
    assert forced.kernel == "frontier" and forced.mc == 0


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    arrays = [torch.from_numpy(a) for a in _synth_arrays("cas-register", 1)]
    before = wgl.FRONTIER_SEARCH.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        wgl.FRONTIER_SEARCH(*arrays, spec_name="cas-register", F=8,
                            max_closure=9)
    checker = wgl.make_check_fn("cas-register", arrays[1].shape[1],
                                arrays[2].shape[2], 8, 9,
                                torch.device("cpu"))
    checker(*arrays)  # CPU tensors: the plain version, no launch
    assert wgl.FRONTIER_SEARCH.launches == before


def test_checker_validates_slot_ids():
    arrays = [torch.from_numpy(a.copy())
              for a in _synth_arrays("cas-register", 1)]
    C = arrays[2].shape[2]
    checker = wgl.FrontierChecker("cas-register", arrays[1].shape[1], C, 8,
                                  C + 1)
    bad = list(arrays)
    bad[2] = arrays[2].clone()
    bad[2][0, 0, 0] = C
    with pytest.raises(ValueError, match="cand_slot"):
        checker(*bad)
    bad = list(arrays)
    bad[1] = arrays[1].clone()
    bad[1][0, 0] = -2
    with pytest.raises(ValueError, match="ev_slot"):
        checker(*bad)
    bad = list(arrays)
    bad[3] = arrays[3].to(torch.int32)
    with pytest.raises(TypeError, match="cand_f"):
        checker(*bad)
    with pytest.raises(ValueError, match="no frontier step"):
        wgl.FrontierChecker("acquired-permits", 64, 4, 8, 5)
