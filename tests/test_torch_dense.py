"""The plain PyTorch version of the dense automaton against the JAX
kernel (``jepsen_tpu.ops.dense.make_dense_fn``) on the same numpy inputs.

Tolerance: exact.  Every output (ok, failed_at, overflow) is an integer
or a bool, so the three arrays are compared byte for byte.  The CUDA
kernel is held against this same plain version on the card by
``chip_smoke.py``.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu.ops import dense as ref_dense
from jepsen_tpu_torch import models, synth
from jepsen_tpu_torch.ops import carry, dense, encode, wgl
from jepsen_tpu_torch.ops.step_kernels import F_ACQUIRE, F_RELEASE, F_WRITE


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain version issues many small tensor ops; one thread avoids
    oversubscribing the cores the other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _encoded(kind, n_procs, n_ops, n_values, seed, n=6):
    rng = random.Random(seed)
    if kind == "mutex":
        model = models.mutex()
        hs = [synth.generate_lock_history(rng, n_procs=n_procs, n_ops=n_ops,
                                          corrupt=i % 2 == 0)
              for i in range(n)]
    else:
        model = (models.register(0) if kind == "register"
                 else models.cas_register(0))
        weights = (1, 1, 0) if kind == "register" else None
        hs = [synth.generate_history(rng, n_procs=n_procs, n_ops=n_ops,
                                     corrupt=i % 2 == 0, n_values=n_values,
                                     op_weights=weights)
              for i in range(n)]
    encs = [encode.encode_history(h, model, slot_cap=12) for h in hs]
    return [e for e in encs if e is not None]


def _stack(encs, C, pad_rows=2):
    """Stack at exactly ``C`` lanes, plus all-padding rows."""
    E = encode.round_up(max(e.ev_slot.shape[0] for e in encs))
    b = encode.stack_encoded(encs, list(range(len(encs))), E, C)
    arrays = [b.init_state, b.ev_slot, b.cand_slot, b.cand_f, b.cand_a,
              b.cand_b]
    fills = wgl._PAD_FILLS
    return [np.concatenate([a, np.full((pad_rows,) + a.shape[1:], f, a.dtype)])
            for a, f in zip(arrays, fills)]


def _assert_matches_reference(spec, arrays, C, V):
    ref_fn = ref_dense.make_dense_fn(spec, arrays[1].shape[1], C, V)
    ref = [np.asarray(x) for x in ref_fn(*arrays)]
    tensors = carry.batch_from_reference(*arrays, device="cpu")
    ours = dense.make_dense_fn(spec, arrays[1].shape[1], C, V,
                               torch.device("cpu"))(*tensors)
    ours = [x.numpy() for x in ours]
    for name, o, r in zip(("ok", "failed_at", "overflow"), ours, ref):
        assert o.dtype == r.dtype, name
        assert o.tobytes() == r.tobytes(), (name, o, r)
    return ours


# (spec, C, V, corpus: n_procs, n_ops, n_values) — every C in {4, 8, 12},
# every V in {4, 8, 32}, each spec, and padded rows in every case (C = 12
# with V = 32 is the slow corner on the CPU; chip_smoke.py runs it)
CASES = [
    ("cas-register", 4, 4, (3, 60, 1)),
    ("cas-register", 8, 8, (5, 120, 5)),
    ("cas-register", 12, 8, (11, 40, 5)),
    ("register", 4, 32, (3, 60, 30)),
    ("register", 8, 32, (6, 60, 30)),
    ("register", 12, 4, (11, 40, 1)),
    ("mutex", 4, 4, (3, 60, None)),
    ("mutex", 8, 8, (6, 60, None)),
    ("mutex", 12, 4, (10, 30, None)),
]


@pytest.mark.parametrize("spec,C,V,corpus", CASES,
                         ids=[f"{s}-C{c}-V{v}" for s, c, v, _ in CASES])
def test_plain_version_equals_jax_kernel(spec, C, V, corpus):
    n_procs, n_ops, n_values = corpus
    encs = _encoded(spec, n_procs, n_ops, n_values, seed=C * 100 + V)
    assert max(e.max_open for e in encs) <= C
    arrays = _stack(encs, C)
    vdom = wgl.value_domain(spec, arrays[0], arrays[4], arrays[5])
    assert vdom <= V
    ok, failed_at, _ = _assert_matches_reference(spec, arrays, C, V)
    assert ok[-2:].all() and (failed_at[-2:] == -1).all()  # padding rows
    if spec != "mutex" or C == 4:
        assert not ok.all(), "the corpus must hold invalid histories"


def _random_lanes(rs, B, E, C):
    """Random candidate lanes (distinct slot ids per event) and event
    slots, a fifth of them padding."""
    cand_slot = np.full((B, E, C), -1, np.int8)
    for b in range(B):
        for e in range(E):
            k = rs.integers(0, C + 1)
            cand_slot[b, e, :k] = rs.permutation(C)[:k]
    ev_slot = np.where(rs.random((B, E)) < 0.2, -1,
                       rs.integers(0, C, (B, E))).astype(np.int32)
    return ev_slot, cand_slot


def _random_codes(seed):
    """The cas-register random-code batch: (arrays, C, V)."""
    rs = np.random.default_rng(seed)
    B, E, C, V = 6, 24, 8, 8
    ev_slot, cand_slot = _random_lanes(rs, B, E, C)
    arrays = [
        rs.integers(0, V, B).astype(np.int32), ev_slot, cand_slot,
        rs.integers(0, 12, (B, E, C)).astype(np.int8),
        rs.integers(0, V, (B, E, C)).astype(np.int16),
        rs.integers(0, V, (B, E, C)).astype(np.int16),
    ]
    return arrays, C, V


@pytest.mark.parametrize("seed", range(3))
def test_plain_version_equals_jax_kernel_random_codes(seed):
    """Random lanes, op codes (all twelve, so the read branch's catch-all
    is exercised), slot ids and padding events."""
    arrays, C, V = _random_codes(seed)
    _assert_matches_reference("cas-register", arrays, C, V)


def test_mutex_codes_reach_the_cas_transitions():
    """acquire/release are cas(0 → 1)/cas(1 → 0): a release first fails."""
    ev_slot = np.array([[0, 0], [0, 0]], np.int32)
    f = np.full((2, 2, 4), 0, np.int8)
    f[0, :, 0] = (F_ACQUIRE, F_RELEASE)
    f[1, :, 0] = (F_RELEASE, F_ACQUIRE)
    cand_slot = np.full((2, 2, 4), -1, np.int8)
    cand_slot[:, :, 0] = 0
    zeros = np.zeros((2, 2, 4), np.int16)
    arrays = [np.zeros(2, np.int32), ev_slot, cand_slot, f, zeros, zeros]
    ok, failed_at, _ = _assert_matches_reference("mutex", arrays, 4, 4)
    assert ok.tolist() == [True, False] and failed_at.tolist() == [-1, 0]


@pytest.mark.parametrize("C", range(1, 13))
def test_subset_tables_equal_reference(C):
    maps = [np.asarray(t) for t in ref_dense._subset_maps(C)]
    carry.tables_from_reference(C, *maps, np.asarray(ref_dense._subset_has(C)))


def test_tables_from_reference_rejects_a_drift():
    maps = [np.asarray(t) for t in ref_dense._subset_maps(8)]
    maps[1] = maps[1].copy()
    maps[1][3, 0] ^= 1
    with pytest.raises(ValueError, match="umask"):
        carry.tables_from_reference(8, *maps,
                                    np.asarray(ref_dense._subset_has(8)))


def test_batch_from_reference_checks_dtypes():
    arrays = _stack(_encoded("cas-register", 3, 30, 3, seed=1), 4)
    tensors = carry.batch_from_reference(*arrays, device="cpu")
    assert [t.dtype for t in tensors] == [
        torch.int32, torch.int32, torch.int8, torch.int8, torch.int16,
        torch.int16]
    arrays[4] = arrays[4].astype(np.int32)
    with pytest.raises(TypeError, match="cand_a"):
        carry.batch_from_reference(*arrays, device="cpu")


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
def test_pack_words_equal_reference(n):
    bits = np.random.default_rng(n).random((3, n)) < 0.5
    words = dense.pack_words_np(bits)
    np.testing.assert_array_equal(words, ref_dense.pack_words_np(bits))
    np.testing.assert_array_equal(dense.unpack_words_np(words, n), bits)


def test_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU the engine takes the plain version; the kernel wrapper
    itself only takes CUDA tensors and says so."""
    arrays = _stack(_encoded("cas-register", 3, 30, 3, seed=2), 4)
    tensors = carry.batch_from_reference(*arrays, device="cpu")
    launches = dense.DENSE_AUTOMATON.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        dense.DENSE_AUTOMATON(*tensors, S=4)
    assert dense.DENSE_AUTOMATON.launches == launches


def test_checker_validates_inputs():
    arrays = _stack(_encoded("cas-register", 3, 30, 3, seed=3), 4)
    tensors = list(carry.batch_from_reference(*arrays, device="cpu"))
    checker = dense.make_dense_fn("cas-register", arrays[1].shape[1], 4, 4,
                                  torch.device("cpu"))
    tensors[1] = tensors[1][:, ::2]
    with pytest.raises(ValueError):
        checker(*tensors)
    with pytest.raises(ValueError, match="no dense kernel"):
        dense.DenseChecker("cas-register", 64, 13, 4)


def test_work_counts_the_operations_the_function_needs():
    """One write of 2 at C = 4, V = 4 (one word): a single closure pass
    changes D (4 source-bit ORs + AND/shift/OR of the one live target +
    D | update and compare over 4 words = 15), the confirming pass is not
    counted, and the completion costs shift/AND/OR over 4 words (12).
    Copies add up; an all-padding row adds nothing."""
    lanes = np.array([[[0, -1, -1, -1]]], np.int8)
    one = (np.zeros(1, np.int32), np.zeros((1, 1), np.int32), lanes,
           np.array([[[F_WRITE, 0, 0, 0]]], np.int8),
           np.array([[[2, 0, 0, 0]]], np.int16), np.zeros((1, 1, 4), np.int16))
    work = {}
    ok, failed_at, _ = dense.dense_check_reference(
        *carry.batch_from_reference(*one, device="cpu"), S=4, work=work)
    assert bool(ok[0]) and int(failed_at[0]) == -1
    assert work == {"int_ops": 27, "max_passes": 1}
    fills = wgl._PAD_FILLS
    three = [np.concatenate([a, a, np.full_like(a, f)])
             for a, f in zip(one, fills)]
    work = {}
    dense.dense_check_reference(
        *carry.batch_from_reference(*three, device="cpu"), S=4, work=work)
    assert work == {"int_ops": 54, "max_passes": 1}


# ---------------------------------------------------------------------------
# the reentrant-mutex (K1r), permit (K1p) and multi-register (K1m) families
# ---------------------------------------------------------------------------


def _family_encoded(spec, n_procs, n_ops, seed, n=5, **kw):
    """Encoded synth histories of ``spec`` (a quarter of the generator's
    seeds corrupted), slot cap 12."""
    rng = random.Random(seed)
    if spec == "reentrant-mutex":
        model = models.reentrant_mutex()
        hs = [synth.generate_lock_history(rng, n_procs=n_procs, n_ops=n_ops,
                                          reentrant=True, corrupt=i % 2 == 0)
              for i in range(n)]
    elif spec == "acquired-permits":
        model = models.acquired_permits(2)
        hs = [synth.generate_permits_history(rng, n_procs=n_procs,
                                             n_ops=n_ops, corrupt=i % 2 == 0)
              for i in range(n)]
    else:
        n_keys = kw["n_keys"]
        model = models.multi_register({k: 0 for k in range(n_keys)})
        hs = [synth.generate_mr_history(rng, n_procs=n_procs, n_ops=n_ops,
                                        n_keys=n_keys,
                                        n_values=kw["n_values"],
                                        corrupt=i % 2 == 0)
              for i in range(n)]
    encs = [encode.encode_history(h, model, slot_cap=12) for h in hs]
    return [e for e in encs if e is not None]


def _family_shape(spec, arrays):
    """The shape plan_bucket gives the batch: (Vr, K), (N rounded to 4,
    2), or the reentrant domain rounded to 4."""
    if spec == "multi-register":
        return dense.mr_shape_probe(arrays[0], arrays[4], arrays[5])
    if spec == "acquired-permits":
        return (encode.round_up(int(arrays[4].max()), 4), 2)
    return encode.round_up(
        wgl.value_domain(spec, arrays[0], arrays[4], arrays[5]), 4)


# (spec, C, corpus: n_procs, n_ops, generator keywords, shape override or
# None) — C in {4, 8, 12} per family, S up to 128, K up to 4
FAMILY_CASES = [
    ("reentrant-mutex", 4, (3, 60, {}), None),
    ("reentrant-mutex", 8, (6, 60, {}), None),
    ("reentrant-mutex", 12, (10, 40, {}), None),
    ("reentrant-mutex", 8, (6, 40, {}), 32),
    ("acquired-permits", 4, (3, 60, {}), None),
    ("acquired-permits", 8, (6, 60, {}), None),
    ("acquired-permits", 12, (10, 30, {}), (12, 2)),
    ("multi-register", 4, (3, 60, dict(n_keys=2, n_values=4)), None),
    ("multi-register", 8, (6, 60, dict(n_keys=3, n_values=2)), None),
    ("multi-register", 8, (6, 60, dict(n_keys=2, n_values=8)), (11, 2)),
    ("multi-register", 12, (10, 30, dict(n_keys=1, n_values=6)), (128, 1)),
]


@pytest.mark.parametrize(
    "spec,C,corpus,shape", FAMILY_CASES,
    ids=[f"{s}-C{c}-{v or 'planned'}" for s, c, _, v in FAMILY_CASES])
def test_family_plain_version_equals_jax_kernel(spec, C, corpus, shape):
    n_procs, n_ops, kw = corpus
    encs = _family_encoded(spec, n_procs, n_ops, seed=C * 10 + n_procs,
                           **kw)
    assert max(e.max_open for e in encs) <= C
    arrays = _stack(encs, C)
    planned = _family_shape(spec, arrays)
    V = shape or planned
    if isinstance(V, tuple) and spec == "multi-register":
        assert planned[0] <= V[0] and planned[1] <= V[1]
    assert dense.applicable(spec, C, V)
    ok, failed_at, _ = _assert_matches_reference(spec, arrays, C, V)
    assert ok[-2:].all() and (failed_at[-2:] == -1).all()  # padding rows
    assert not ok.all(), "the corpus must hold invalid histories"


#: (spec, C, shape, init bound) of the random-code batches: every op code,
#: values and registers past the shape's range, initial states past S
RANDOM_FAMILIES = [
    ("reentrant-mutex", 8, 12, 14),
    ("acquired-permits", 4, (4, 2), 20),
    ("acquired-permits", 8, (8, 1), 12),
    ("multi-register", 8, (4, 2), 1 << 12),
    ("multi-register", 4, (2, 4), 1 << 30),
    ("multi-register", 8, (3, 4), 1 << 30),
    ("multi-register", 12, (128, 1), 1 << 9),
    ("cas-register", 8, 8, 12),
]


@pytest.mark.parametrize("spec,C,V,init_hi", RANDOM_FAMILIES,
                         ids=[f"{s}-{v}" for s, _, v, _ in RANDOM_FAMILIES])
def test_family_plain_version_equals_jax_kernel_random_codes(spec, C, V,
                                                              init_hi):
    """Random lanes, all twelve op codes, a/b past the clients, values and
    registers (clipped as the reference clips them), initial states past
    S (clamped), and padding events."""
    _assert_matches_reference(spec, _random_family_codes(C, init_hi), C, V)


def _random_family_codes(C, init_hi):
    rs = np.random.default_rng(C)
    B, E = 6, 24
    ev_slot, cand_slot = _random_lanes(rs, B, E, C)
    return [
        rs.integers(-2, init_hi, B).astype(np.int32), ev_slot, cand_slot,
        rs.integers(0, 12, (B, E, C)).astype(np.int8),
        rs.integers(-2, 10, (B, E, C)).astype(np.int16),
        rs.integers(-2, 6, (B, E, C)).astype(np.int16),
    ]


def _fixpoint_corpus(name):
    """(spec, arrays, C, V) of one corpus the fixpoint test runs: the
    flagship-like synth batch (cas-register, C = 8, V = 8), the
    cas-register random codes, or a RANDOM_FAMILIES batch."""
    kind, _, arg = name.partition(":")
    if kind == "synth":
        encs = _encoded("cas-register", 5, 120, 5, seed=808)
        return "cas-register", _stack(encs, 8), 8, 8
    if kind == "codes":
        arrays, C, V = _random_codes(int(arg))
        return "cas-register", arrays, C, V
    spec, C, V, init_hi = RANDOM_FAMILIES[int(arg)]
    return spec, _random_family_codes(C, init_hi), C, V


FIXPOINT_CORPORA = (["synth", "codes:0", "codes:1", "codes:2"]
                    + [f"family:{i}" for i in range(len(RANDOM_FAMILIES))])


@pytest.mark.parametrize("corpus", FIXPOINT_CORPORA)
def test_closure_settles_within_c_passes(corpus):
    """At most C closure passes change D at any event of any row, so the
    pass that confirms the fixpoint is at most pass C + 1 and the C + 2
    cap never binds: the least fixpoint is reached, whatever the order of
    updates, which the CUDA kernels' in-place passes rely on."""
    spec, arrays, C, V = _fixpoint_corpus(corpus)
    tensors = carry.batch_from_reference(*arrays, device="cpu")
    checker = dense.make_dense_fn(spec, arrays[1].shape[1], C, V,
                                  torch.device("cpu"))
    work: dict = {}
    checker.reference(*tensors, work=work)
    assert 1 <= work["max_passes"] <= C


def test_permits_tables_equal_reference():
    for N, P in ((1, 1), (4, 2), (12, 2), (16, 2)):
        S, acq, rel = dense.permits_tables(N, P)
        rS, racq, rrel = ref_dense.permits_tables(N, P)
        assert S == rS
        np.testing.assert_array_equal(acq, racq)
        np.testing.assert_array_equal(rel, rrel)
        assert acq.dtype == racq.dtype and rel.dtype == rrel.dtype
    with pytest.raises(ValueError):
        dense.permits_tables(4, 3)


@pytest.mark.parametrize("N,P", [(1, 1), (4, 2), (12, 2), (8, 1)])
def test_permit_sources_invert_the_tables(N, P):
    """The kernel's source tables: src[c, t] = s exactly where
    tbl[c, s] = t, -1 elsewhere."""
    S, acq, rel = dense.permits_tables(N, P)
    for tbl in (acq, rel):
        src = dense.permit_sources(tbl)
        assert src.dtype == tbl.dtype and src.shape == tbl.shape
        for c in range(N + 1):
            for t in range(S):
                want = [s for s in range(S) if tbl[c, s] == t]
                assert src[c, t] == (want[0] if want else -1)
    bad = acq.copy()
    bad[1, :2] = 0
    with pytest.raises(ValueError, match="one-to-one"):
        dense.permit_sources(bad)


def test_mr_shape_probe_and_envelope_equal_reference():
    rs = np.random.default_rng(5)
    for _ in range(20):
        init = rs.integers(0, 1 << 16, 7).astype(np.int32)
        a = rs.integers(0, 9, (7, 5, 4)).astype(np.int16)
        b = rs.integers(0, 4, (7, 5, 4)).astype(np.int16)
        assert dense.mr_shape_probe(init, a, b) == \
            ref_dense.mr_shape_probe(init, a, b)
    pairs = ((11, 2), (12, 2), (3, 4), (4, 4), (16, 2), (128, 1), (129, 1),
             (5, 3), (4, 3))
    for spec in ("register", "mutex", "owner-mutex", "reentrant-mutex",
                 "multi-register", "acquired-permits", "unordered-queue"):
        paired = spec in ("multi-register", "acquired-permits")
        for C in (4, 12, 13):
            for V in (4, 32, 36) + (pairs if paired else ()):
                assert dense.applicable(spec, C, V) == \
                    ref_dense.applicable(spec, C, V), (spec, C, V)
    assert dense.MR_MAX_STATES == ref_dense.MR_MAX_STATES


def test_family_wrappers_count_apart_and_refuse_cpu_tensors():
    arrays = _stack(_family_encoded("acquired-permits", 3, 30, seed=4), 4)
    tensors = carry.batch_from_reference(*arrays, device="cpu")
    checker = dense.make_dense_fn("acquired-permits", arrays[1].shape[1], 4,
                                  (4, 2), torch.device("cpu"))
    before = {f: k.launches for f, k in dense.DENSE_KERNELS.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        dense.DENSE_KERNELS["acquired-permits"](
            *tensors, S=checker.S,
            permit_sources=(checker.pm_acq_src, checker.pm_rel_src))
    checker(*tensors)  # CPU tensors: the plain version, no launch
    assert {f: k.launches for f, k in dense.DENSE_KERNELS.items()} == before
    assert {k.name for k in dense.DENSE_KERNELS.values()} == {
        "dense_automaton", "dense_automaton[reentrant-mutex]",
        "dense_automaton[acquired-permits]",
        "dense_automaton[multi-register]", "dense_queue"}
    assert dense.DENSE_AUTOMATON is dense.DENSE_KERNELS["register"]


def test_design_rule_matches_the_kernel_source():
    """``dense.design`` mirrors the CUDA launch's switch: the register
    family runs the warp design while S·W ≤ kWarpMaxSW, every other
    family and shape the block design."""
    src = (Path(dense.__file__).parent / "csrc" / "dense_automaton.cu")
    m = re.search(r"#define DENSE_WARP_MAX_SW (\d+)", src.read_text())
    assert m and int(m.group(1)) == dense.WARP_MAX_SW
    assert dense.design("register", 8, 8) == "warp"        # the flagship
    assert dense.design("register", 12, 12) == "warp"      # owner-mutex
    S_edge = dense.WARP_MAX_SW // 128
    assert dense.design("register", S_edge, 12) == "warp"
    assert dense.design("register", S_edge + 1, 12) == "block"
    for fam in ("reentrant-mutex", "acquired-permits", "multi-register"):
        assert dense.design(fam, 4, 4) == "block"
