"""The port's cycle screens (``jepsen_tpu_torch.ops.cycles``) against the
JAX package's ``jepsen_tpu.ops.cycles`` on the same inputs.

The plain has-cycle and screen versions are held against the reference's
jitted ``_cyclic_fn`` and packed ``_screen_fn_variant`` (its ``uint8``
lowering, run on the CPU as its own tests run it), in both closure modes.
Every output is a bool or an int, so the tolerance is byte equality of
the whole ``(flags, rounds)`` / ``(members, walks, rounds)`` tuple.
Inputs come from numpy seeds.  The CUDA kernel is held against the same
plain versions on the card by ``chip_smoke.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu.ops import cycles as ref_cycles
from jepsen_tpu.ops import dense as ref_dense
from jepsen_tpu_torch.engine import execution, planning
from jepsen_tpu_torch.ops import cycles, dense, wgl

MODES = ("fixed", "earlyexit")
SIZES = (16, 32, 64, 128)
FULL_MASKS = (1, 3, 7, 25, 27, 31)
FULL_NONADJ = ((4, 3), (4, 27))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions issue many small tensor ops; one thread avoids
    oversubscribing the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _ref_has_cycle(adj, mode):
    return ref_cycles._cyclic_fn(adj.shape[-1], mode, "uint8")(adj)


def _ref_screen(rel, masks, nonadj, mode):
    return ref_cycles._screen_fn_variant(rel.shape[-1], masks, nonadj, True,
                                         mode, "uint8")(rel)


def _port_has_cycle(adj, mode):
    return cycles.has_cycle_reference(torch.from_numpy(adj), mode)


def _port_screen(rel, masks, nonadj, mode):
    return cycles.screen_reference(torch.from_numpy(rel), masks, nonadj,
                                   mode)


def _assert_same(port, ref, what):
    for i, (p, r) in enumerate(zip(port, ref)):
        assert _same(p, r), (what, i, _np(p), _np(r))


# ---------------------------------------------------------------------------
# pack/unpack (K8)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 64, 100, 128])
def test_pack_words_matches_host_and_reference_layout(n):
    rng = np.random.default_rng(1000 + n)
    for bits in (np.zeros((3, n), bool), np.ones((3, n), bool),
                 rng.random((4, n)) < 0.3, rng.random((2, 5, n)) < 0.5):
        words = cycles.pack_words(torch.from_numpy(bits))
        host = dense.pack_words_np(bits)
        assert np.array_equal(words.numpy(), host.astype(np.int64))
        assert np.array_equal(host, ref_dense.pack_words_np(bits))
        assert np.array_equal(np.asarray(ref_cycles._pack_words(bits)),
                              host)
        back = cycles.unpack_words(words, n)
        assert np.array_equal(back.numpy(), bits)
        assert np.array_equal(back.numpy(),
                              np.asarray(ref_cycles._unpack_words(host, n)))
        assert np.array_equal(dense.unpack_words_np(host, n), bits)


def test_pack_words_single_bit_lands_at_word_and_bit():
    n = 100
    for j in (0, 1, 31, 32, 63, 64, 99):
        bits = np.zeros((1, n), bool)
        bits[0, j] = True
        words = cycles.pack_words(torch.from_numpy(bits)).numpy()
        want = np.zeros((1, dense.word_count(n)), np.int64)
        want[0, j // 32] = 1 << (j % 32)
        assert np.array_equal(words, want), j


# ---------------------------------------------------------------------------
# has-cycle (K6) and the screen (K7) against the reference
# ---------------------------------------------------------------------------


def _random_adj(rng, n, B=6):
    """Batches at several densities, an all-zero row among them."""
    dens = np.array([0.0, 0.5 / n, 1.0 / n, 2.0 / n, 0.05, 0.3])[:B]
    adj = (rng.random((B, n, n)) < dens[:, None, None]).astype(np.uint8)
    return adj


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_has_cycle_matches_reference_random(n, mode):
    rng = np.random.default_rng(2000 + n)
    for _ in range(3):
        adj = _random_adj(rng, n)
        _assert_same(_port_has_cycle(adj, mode), _ref_has_cycle(adj, mode),
                     (n, mode))
    zeros = np.zeros((4, n, n), np.uint8)
    _assert_same(_port_has_cycle(zeros, mode), _ref_has_cycle(zeros, mode),
                 (n, mode, "zeros"))


def _ring_and_chain(n, d):
    """Row 0: a ring through vertices 0..d-1 (a chain closing on itself);
    row 1: the acyclic chain of the same length."""
    adj = np.zeros((2, n, n), np.uint8)
    for i in range(d):
        adj[0, i, (i + 1) % d] = 1
    for i in range(min(d, n - 1)):
        adj[1, i, i + 1] = 1
    return adj


@pytest.mark.parametrize("n", SIZES)
def test_has_cycle_matches_reference_every_diameter(n):
    """Every chain and ring diameter 1..n, both modes: the early exit's
    round count is the diameter's, so it is compared per diameter."""
    for d in range(1, n + 1):
        adj = _ring_and_chain(n, d)
        for mode in MODES:
            _assert_same(_port_has_cycle(adj, mode),
                         _ref_has_cycle(adj, mode), (n, d, mode))


def _random_rel(rng, n, B=4, p=0.06):
    rel = (rng.integers(0, 32, size=(B, n, n))
           * (rng.random((B, n, n)) < p)).astype(np.uint8)
    rel[0] = 0  # an all-zero row: inert, acyclic, converged in round 1
    return rel


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_screen_matches_reference_full_profile(n, mode):
    rng = np.random.default_rng(3000 + n)
    for p in (1.0 / n, 3.0 / n, 0.1):
        rel = _random_rel(rng, n, p=p)
        _assert_same(_port_screen(rel, FULL_MASKS, FULL_NONADJ, mode),
                     _ref_screen(rel, FULL_MASKS, FULL_NONADJ, mode),
                     (n, mode, p))


@pytest.mark.parametrize("masks,nonadj", [
    ((1, 3, 7), ((4, 3),)),      # serializable, no realtime edges
    ((1, 3), ()),                # no rw edge: no lifted query
    ((), ((4, 3),)),             # lifted only
    ((5,), ((4, 1),)),
])
def test_screen_matches_reference_profiles(masks, nonadj):
    rng = np.random.default_rng(3100)
    for n in (16, 64):
        rel = _random_rel(rng, n, p=2.0 / n)
        for mode in MODES:
            _assert_same(_port_screen(rel, masks, nonadj, mode),
                         _ref_screen(rel, masks, nonadj, mode),
                         (n, masks, nonadj, mode))


def _diameter_rel(n, d):
    """Row 0: a ring of length d whose edges cycle through ww, wr, rw and
    a realtime bit (so every filter and both lifted queries see it);
    row 1: the same edges as an open chain."""
    bits = (1, 2, 4, 16 | 4, 8 | 1)
    rel = np.zeros((2, n, n), np.uint8)
    for i in range(d):
        rel[0, i, (i + 1) % d] = bits[i % len(bits)]
    for i in range(min(d, n - 1)):
        rel[1, i, i + 1] = bits[i % len(bits)]
    return rel


@pytest.mark.parametrize("n", SIZES)
def test_screen_matches_reference_every_diameter(n):
    for d in range(1, n + 1):
        rel = _diameter_rel(n, d)
        for mode in MODES:
            _assert_same(_port_screen(rel, FULL_MASKS, FULL_NONADJ, mode),
                         _ref_screen(rel, FULL_MASKS, FULL_NONADJ, mode),
                         (n, d, mode))


# ---------------------------------------------------------------------------
# the kernel's own arithmetic: the semi-naive closure and the reduced screen
# ---------------------------------------------------------------------------


def _walk_ring(n, pattern):
    """Row 0: a ring through all n vertices whose edge i carries
    ``pattern[i % len(pattern)]``; row 1: the same edges as a chain."""
    rel = np.zeros((2, n, n), np.uint8)
    for i in range(n):
        rel[0, i, (i + 1) % n] = pattern[i % len(pattern)]
    for i in range(n - 1):
        rel[1, i, i + 1] = pattern[i % len(pattern)]
    return rel


def _reduced_case(case, n):
    """(masks, nonadj, rel) of one reduced-screen case at ``n``."""
    rng = np.random.default_rng(3200 + n + sum(map(ord, case)))
    if case.startswith("density-"):
        return FULL_MASKS, FULL_NONADJ, _random_rel(
            rng, n, p=float(case.split("-")[1]) / n)
    if case == "diagonal":
        rel = _random_rel(rng, n, p=2.0 / n)
        rel[:, np.arange(n), np.arange(n)] = rng.integers(
            0, 32, size=(rel.shape[0], n)).astype(np.uint8)
        return FULL_MASKS, FULL_NONADJ, rel
    if case == "no-want":  # no rw bit anywhere: no walk
        rel = _random_rel(rng, n, p=4.0 / n) & np.uint8(0b11011)
        return (1, 3, 7), ((4, 3),), rel
    if case == "ring":  # every edge ww and rw: every vertex walks
        return FULL_MASKS, FULL_NONADJ, _walk_ring(n, (1 | 4,))
    if case == "ring-many-hops":  # want, rest, want, rest ...: n/2 hops
        return FULL_MASKS, FULL_NONADJ, _walk_ring(n, (4, 2, 4, 1))
    raise ValueError(case)


REDUCED_CASES = ("density-0.5", "density-1", "density-2", "density-4",
                 "diagonal", "no-want", "ring", "ring-many-hops")


@pytest.mark.parametrize("n", (32, 64, 128))
@pytest.mark.parametrize("case", REDUCED_CASES)
def test_reduced_screen_matches_reference(case, n):
    """The screen's arithmetic on the card (filter planes by the
    semi-naive closure, each walk query closed as the n-vertex plane
    M = Rs ∪ Wn·Rs) equals the reference's packed screen and the port's
    lifted plain version, in both modes."""
    masks, nonadj, rel = _reduced_case(case, n)
    for mode in MODES:
        got = cycles.reduced_screen(torch.from_numpy(rel), masks, nonadj,
                                    mode)
        _assert_same(got, _ref_screen(rel, masks, nonadj, mode),
                     (case, n, mode))
        _assert_same(got, _port_screen(rel, masks, nonadj, mode),
                     (case, n, mode))
    if case.startswith("ring"):  # a walk from each want edge's tail
        tails = torch.from_numpy((rel[0] & 4).any(-1))
        assert (got[1][0] == tails).all() and tails.any()
        assert not got[1][1].any()
    if case == "no-want":
        assert not got[1].any()


def _corpus_planes(corpus, n):
    """Word planes of an "every diameter" corpus at ``n``: has-cycle's
    rings and chains, or the screen's rings and chains under every filter
    mask and as reduced walk planes M."""
    planes = []
    for d in range(1, n + 1):
        if corpus == "has-cycle":
            planes.append(_ring_and_chain(n, d) > 0)
            continue
        rel = _diameter_rel(n, d)
        planes += [(rel & m) > 0 for m in FULL_MASKS]
        for want, rest in FULL_NONADJ:
            rs = cycles.pack_words(torch.from_numpy((rel & rest) > 0))
            wn = cycles.pack_words(torch.from_numpy((rel & want) > 0))
            m_plane = rs | cycles._square_sel(wn, rs, n)
            planes.append(cycles.unpack_words(m_plane, n).numpy())
    return cycles.pack_words(torch.from_numpy(np.concatenate(planes)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("corpus", ("has-cycle", "screen"))
def test_semi_naive_closure_is_the_full_jacobi_round(corpus, n):
    """Every round of the semi-naive closure gives the full Jacobi round's
    rows (``stale_rows`` = 0), so each plane closes to the same words and
    stops at the same first unchanged round as :func:`packed_closure`, in
    both modes, on every diameter."""
    words = torch.unique(_corpus_planes(corpus, n), dim=0)
    want, want_rounds = cycles.packed_closure(words, n, "earlyexit")
    work: dict = {}
    got, rounds = cycles.semi_naive_closure(words, n, "earlyexit", work)
    assert work["stale_rows"] == 0
    assert torch.equal(got, want) and rounds == want_rounds
    assert torch.equal(work["plane_rounds"],
                       _first_unchanged_rounds(words, n))
    got, rounds = cycles.semi_naive_closure(words, n, "fixed")
    assert torch.equal(got, want) and rounds == cycles.closure_rounds(n)


def _first_unchanged_rounds(words, n, chunk=64):
    """Each plane's first unchanged full Jacobi round (the ladder length
    if every round changed it)."""
    R = cycles.closure_rounds(n)
    first = torch.full((words.shape[0],), R, dtype=torch.int64)
    for lo in range(0, words.shape[0], chunk):
        rw = words[lo:lo + chunk]
        done = torch.zeros(rw.shape[0], dtype=torch.bool)
        for rnd in range(1, R + 1):
            new = rw | cycles._square(rw, n)[0]
            still = (new == rw).flatten(1).all(1) & ~done
            first[lo:lo + chunk][still] = rnd
            done |= still
            rw = new
    return first


def test_semi_naive_counts_every_round_it_runs():
    """Unlike :func:`packed_closure`, the semi-naive count includes the
    final unchanged round: an empty plane runs one round that forms each
    row's iteration set and writes every row; a ring's later rounds skip
    the rows with nothing to OR in."""
    n, W = 64, 2
    work: dict = {}
    cycles.semi_naive_closure(torch.zeros((3, n, W), dtype=torch.int64), n,
                              work=work)
    assert (work["int_ops"], work["stale_rows"]) == (3 * 3 * n * W, 0)
    assert work["plane_rounds"].tolist() == [1, 1, 1]
    ring = cycles.pack_words(torch.from_numpy(_ring_and_chain(n, n)[:1] > 0))
    semi, full = {}, {}
    cycles.semi_naive_closure(ring, n, work=semi)
    cycles.packed_closure(ring, n, work=full)
    assert semi["stale_rows"] == 0 and 0 < semi["int_ops"]


def test_reduced_screen_counts_fewer_operations_than_the_lifted_planes():
    rng = np.random.default_rng(3300)
    rel = _random_rel(rng, 64, p=2.0 / 64)
    lifted, reduced = {}, {}
    cycles.screen_reference(torch.from_numpy(rel), (), FULL_NONADJ,
                            work=lifted)
    cycles.reduced_screen(torch.from_numpy(rel), (), FULL_NONADJ,
                          work=reduced)
    assert 0 < reduced["int_ops"] < lifted["int_ops"]
    assert reduced["stale_rows"] == 0


def test_design_rules_match_the_kernel_source():
    """``has_cycle_design`` and ``screen_design`` mirror the switches of
    ``cycles_closure.cu``: the warp design up to kHasCycleWarpMaxN
    vertices, two shared copies up to kDoubleMaxN, one past it; fixed-mode
    screens reduce their walk queries while CYCLES_REDUCED_LIFTED."""
    src = (Path(cycles.__file__).parent / "csrc" / "cycles_closure.cu"
           ).read_text()
    warp = re.search(r"constexpr int kHasCycleWarpMaxN = (\d+);", src)
    double = re.search(r"constexpr int kDoubleMaxN = (\d+);", src)
    reduced = re.search(r"#define CYCLES_REDUCED_LIFTED (\d)", src)
    assert warp and int(warp.group(1)) == cycles.HAS_CYCLE_WARP_MAX_N
    assert double and int(double.group(1)) == cycles.DOUBLE_MAX_N
    assert reduced and bool(int(reduced.group(1))) == cycles.REDUCED_LIFTED
    assert [cycles.has_cycle_design(n) for n in (16, 32, 64, 512, 1024)] \
        == ["warp", "warp", "double", "double", "single"]
    for n in (32, 64, 512):
        assert cycles.screen_design("fixed", n) == "reduced"
        assert cycles.screen_design("earlyexit", n) == "lifted"
    with pytest.raises(ValueError):
        cycles.screen_design("sometimes", 64)


def test_packed_closure_counts_only_changing_rounds():
    """The work count grows with the rounds that change a plane: a ring
    needs more changing rounds than the chain's prefix, an empty plane
    none."""
    n = 32
    counts = []
    for d in (2, 8, 32):
        work: dict = {}
        cycles.has_cycle_reference(torch.from_numpy(_ring_and_chain(n, d)[:1]),
                                   work=work)
        counts.append(work["int_ops"])
    assert counts[0] < counts[1] < counts[2]
    work = {}
    cycles.has_cycle_reference(torch.zeros((3, n, n), dtype=torch.uint8),
                               work=work)
    assert work.get("int_ops", 0) == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel on CUDA tensors only; the dispatchers
    take the plain version for a CPU tensor."""
    adj = torch.zeros((2, 32, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        cycles.HAS_CYCLE(adj)
    with pytest.raises(ValueError, match="CUDA"):
        cycles.SCREEN(adj, (1,), ())
    flags, rounds = cycles.has_cycle(adj)
    assert not flags.any() and rounds.tolist() == [5, 5]
    assert cycles.HAS_CYCLE.launches == 0 and cycles.SCREEN.launches == 0


# ---------------------------------------------------------------------------
# reachability and the host paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 17, 40])
def test_reachability_matches_reference(k):
    rng = np.random.default_rng(4000 + k)
    adj = rng.random((k, k)) < 2.0 / k
    want = np.asarray(ref_cycles.reachability(adj))
    got = cycles.reachability(adj, device="cpu")
    assert got.dtype == bool and np.array_equal(got, want)
    assert np.array_equal(cycles._np_bool_closure(adj), want)


def test_host_paths_match_reference():
    rng = np.random.default_rng(4100)
    rel = _random_rel(rng, 32, B=5, p=0.08)
    adj = rel > 0
    assert np.array_equal(cycles._np_bool_closure(adj),
                          ref_cycles._np_bool_closure(adj))
    assert np.array_equal(cycles._np_has_cycle(adj),
                          ref_cycles._np_has_cycle(adj))
    assert cycles._np_has_cycle(adj[1]) == ref_cycles._np_has_cycle(adj[1])
    for a, b in zip(cycles._np_screen(rel, FULL_MASKS, FULL_NONADJ),
                    ref_cycles._np_screen(rel, FULL_MASKS, FULL_NONADJ)):
        assert np.array_equal(a, b)
    words = dense.pack_words_np(adj)
    assert np.array_equal(cycles._np_packed_closure(words, 32),
                          ref_cycles._np_packed_closure(words, 32))
    assert np.array_equal(cycles._np_packed_has_cycle(words, 32),
                          ref_cycles._np_packed_has_cycle(words, 32))
    for n in (32, 512, 1024, 2048):
        assert cycles._np_chunk_rows(n) == ref_cycles._np_chunk_rows(n)


# ---------------------------------------------------------------------------
# the dispatch cap and the engine plans
# ---------------------------------------------------------------------------


def test_cycles_max_dispatch_at_the_port_budget():
    budget = cycles.CYCLES_DISPATCH_BUDGET
    assert budget == 4 << 30
    row = cycles.cycles_row_bytes(512, 6, 2)
    assert row == 512 * 512 + 8 * (512 + 4) + 4
    assert cycles.cycles_max_dispatch(512, 6, 2) == min(
        cycles.DEFAULT_CYCLES_MAX_DISPATCH, budget // row)
    assert cycles.cycles_max_dispatch(16, 1, 0) == \
        cycles.DEFAULT_CYCLES_MAX_DISPATCH
    assert cycles.cycles_max_dispatch(16, 1, 0, max_dispatch=7) == 7
    # the kernel's largest plane: 1024 for has-cycle, 512 for screens
    assert cycles.cycles_max_dispatch(1024, 1, 0) > 0
    assert cycles.cycles_max_dispatch(2048, 1, 0) == 0
    assert cycles.cycles_max_dispatch(512, 3, 1) > 0
    assert cycles.cycles_max_dispatch(1024, 3, 1) == 0
    assert cycles.cycles_max_dispatch(1024, 3, 0) > 0


@pytest.mark.parametrize("window", [1, 4])
def test_has_cycle_batch_matches_reference(window):
    rng = np.random.default_rng(5000)
    mats = [rng.random((k, k)) < 1.5 / k
            for k in (3, 9, 16, 17, 40, 5, 64, 100, 2)]
    mats.append(np.zeros((7, 7), bool))
    want = ref_cycles.has_cycle_batch(mats, window=window)
    got = cycles.has_cycle_batch(mats, window=window, device="cpu")
    assert got.dtype == bool and np.array_equal(got, want)
    got = cycles.has_cycle_batch(mats, window=window, device="cpu",
                                 mode="earlyexit")
    assert np.array_equal(got, want)


def test_has_cycle_batch_over_the_cap_goes_to_the_host(monkeypatch):
    """A bucket whose cap is 0 is decided by the host closure and never
    reaches the Executor."""
    rng = np.random.default_rng(5100)
    mats = [rng.random((40, 40)) < 0.04 for _ in range(6)]
    want = ref_cycles.has_cycle_batch(mats)
    monkeypatch.setattr(cycles, "CYCLES_DISPATCH_BUDGET", 1000)
    monkeypatch.setattr(execution.Executor, "submit", _never_submitted)
    assert np.array_equal(cycles.has_cycle_batch(mats, device="cpu"), want)


def _never_submitted(self, pb):
    raise AssertionError("a bucket over the cap reached the Executor")


def _chunk_counter(monkeypatch):
    launched = []
    real = execution.Executor._launch

    def counting(self, fn, arrays):
        launched.append(arrays[0].shape[0])
        return real(self, fn, arrays)

    monkeypatch.setattr(execution.Executor, "_launch", counting)
    return launched


@pytest.mark.parametrize("window", [1, 4])
def test_cycles_bucket_chunks_under_the_cap(monkeypatch, window):
    """A 40-row has-cycle bucket at a cap of 8 rows: window 1 dispatches
    5 chunks of 8, window 4 splits the cap (cycles chunks, like frontier
    ones, get 1/window of it) into 20 chunks of 2, every row settled."""
    rng = np.random.default_rng(5200)
    mats = [rng.random((20, 20)) < 0.08 for _ in range(40)]
    want = ref_cycles.has_cycle_batch(mats)
    launched = _chunk_counter(monkeypatch)
    ex = execution.Executor(window, device=torch.device("cpu"))
    got = cycles.has_cycle_batch(mats, executor=ex, max_dispatch=8)
    assert np.array_equal(got, want)
    per = 8 if window == 1 else 8 // window
    assert launched == [per] * (40 // per)


@pytest.mark.parametrize("window", [1, 4])
def test_screen_bucket_chunks_and_settles(monkeypatch, window):
    """Screen buckets settle through their plan: each graph's members and
    walks equal the reference's numpy screen; a tail chunk is padded with
    all-zero (inert) rows to the stable chunk shape."""
    from jepsen_tpu_torch.elle import encode
    from jepsen_tpu_torch.elle.graph import Graph

    rng = np.random.default_rng(5300)
    graphs = []
    for i in range(11):
        g = Graph()
        k = int(rng.integers(3, 30))
        for _ in range(int(rng.integers(k, 3 * k))):
            a, b = (int(x) for x in rng.integers(0, k, size=2))
            g.add_edge(a, b, ("ww", "wr", "rw")[int(rng.integers(0, 3))])
        graphs.append(g)
    encs = [encode.encode_graph(g) for g in graphs]
    launched = _chunk_counter(monkeypatch)
    ex = execution.Executor(window, device=torch.device("cpu"))
    res = cycles.screen_graphs(encs, executor=ex, max_dispatch=12)
    assert launched and all(r == launched[0] for r in launched)
    for enc, r in zip(encs, res):
        rel = encode.stack_rel([enc], encode.graph_bucket(enc.n))
        want_m, want_w = cycles._np_screen(rel, enc.masks, enc.nonadj)
        for f, m in enumerate(enc.masks):
            assert np.array_equal(r.members[m], want_m[0, f])
        for q, key in enumerate(enc.nonadj):
            assert np.array_equal(r.walks[key], want_w[0, q])


def test_self_settling_plan_with_no_row_raises():
    plan = cycles.CyclePlan(16)
    plan.disp = 0
    pb = planning.PlannedBucket(16, plan, (np.zeros((1, 16, 16), np.uint8),),
                                [({}, 0)])
    with pytest.raises(ValueError, match="host path"):
        execution.Executor(1, device=torch.device("cpu")).submit(pb)


def test_history_buckets_keep_their_pad_fills(monkeypatch):
    """History plans carry no pad fills or settle of their own: a short
    bucket still pads with ``wgl._PAD_FILLS`` (all-padding rows) and
    settles through the verdict path."""
    from jepsen_tpu_torch import models, synth

    hs = synth.generate_batch(seed=7, n_histories=3, n_procs=3, n_ops=20)
    captured = []
    real = execution.Executor._launch

    def capture(self, fn, arrays):
        captured.append(arrays)
        return real(self, fn, arrays)

    monkeypatch.setattr(execution.Executor, "_launch", capture)
    results = wgl.check_batch(models.cas_register(0), hs, device="cpu")
    assert all(r["engine"] == "gpu" for r in results)
    arrays = captured[0]
    assert len(arrays) == 6 and arrays[0].shape[0] == \
        execution.row_bucket_target(3)
    for a, fill in zip(arrays, wgl._PAD_FILLS):
        assert (a[3:] == fill).all()


def test_estimated_cost_ranks_cycles_buckets():
    from jepsen_tpu.engine import planning as ref_planning

    plan = cycles.ScreenPlan(64, (1, 3, 7), ((4, 3),))
    assert plan.frontier == 3 + 4
    rows = [({}, i) for i in range(10)]
    pb = planning.PlannedBucket(None, plan, (None,), rows)
    assert planning.estimated_cost(pb) == 10.0 * 64 * 64 * 7
    ref_plan = ref_cycles.ScreenPlan(64, (1, 3, 7), ((4, 3),))
    if ref_plan.closure_impl == "uint8":
        assert ref_planning.estimated_cost(
            ref_planning.PlannedBucket(None, ref_plan, (None,), rows)
        ) == planning.estimated_cost(pb)
    assert cycles.CyclePlan(32).frontier == 1
