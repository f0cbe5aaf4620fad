"""The unordered-queue dense automaton (K2): the port's plain version
against the JAX kernel (``jepsen_tpu.ops.dense.make_dense_fn(
"unordered-queue", ...)``, jitted on the CPU) on the same numpy inputs,
and against the port's direct checker and frontier search; the queue
generator against the reference's; a plain twin of the CUDA kernel's
arithmetic (slot masks from the P_j / Q_j slot sets, the closure as an
enqueue sweep and a dequeue sweep) against the JAX kernel; ``max_passes`` ≤ C on the plain version; and
``dense.queue_design`` against the kernel source.

Tolerance: byte-equal.  Every output (ok, failed_at, overflow) is an
integer or a bool, so the arrays are compared byte for byte.  The CUDA
kernel is held against this plain version on the card by
``chip_smoke.py`` (phase 18).
"""

import importlib.util
import os
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu.ops import dense as ref_dense
from jepsen_tpu_torch import models, synth
from jepsen_tpu_torch.ops import carry, dense, encode, wgl
from jepsen_tpu_torch.ops.step_kernels import F_DEQUEUE, F_ENQUEUE

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_generator():
    """The reference's ``tests/test_models.py:_gen_queue_history``."""
    spec = importlib.util.spec_from_file_location(
        "_ref_test_models", os.path.join(TESTS, "test_models.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._gen_queue_history


def _op_tuples(h):
    return [(op.index, op.process, op.type, op.f, op.value, op.time)
            for op in h]


@pytest.mark.parametrize("n_procs,n_ops", [(4, 24), (8, 40), (12, 60)])
def test_generator_equals_reference(n_procs, n_ops):
    ref_gen = _reference_generator()
    for seed in range(8):
        corrupt = seed % 2 == 0
        ours = synth.generate_queue_history(random.Random(seed), n_procs,
                                            n_ops, corrupt=corrupt)
        ref = ref_gen(random.Random(seed), n_procs, n_ops, corrupt=corrupt)
        assert _op_tuples(ours) == _op_tuples(ref), seed


def test_generator_initial_contents_are_dequeued():
    rng = random.Random(3)
    h = synth.generate_queue_history(rng, 4, 60, initial=(1, 2, 3))
    got = {op.value for op in h if op.type == "ok" and op.f == "dequeue"}
    assert got & {1, 2, 3}
    enq = {op.value for op in h if op.f == "enqueue"}
    assert not enq & {1, 2, 3} and min(enq) == 4


def _crash_some(h, rng):
    """Turn about one ok enqueue in five into an info op: a crashed
    enqueue that may or may not have happened (still linearizable)."""
    return h.map(lambda op: op.copy(type="info")
                 if op.type == "ok" and op.f == "enqueue"
                 and rng.random() < 0.2 else op)


def _corpus(C, seed, n=10, n_ops=30):
    """Queue histories at slot cap C: valid and corrupted, empty and
    non-empty initial contents, some with crashed enqueues; all-padding
    rows appended.  Returns (histories, models, arrays)."""
    rng = random.Random(seed)
    hs, ms = [], []
    for i in range(n):
        init = (1, 2) if i % 3 == 1 else ()
        h = synth.generate_queue_history(rng, max(1, C), n_ops,
                                         corrupt=i % 4 == 0, initial=init)
        if i % 3 == 2:
            h = _crash_some(h, rng)
        hs.append(h)
        ms.append(models.UnorderedQueue(init))
    encs = [encode.encode_history(h, m, slot_cap=C) for h, m in zip(hs, ms)]
    keep = [i for i, e in enumerate(encs) if e is not None]
    encs = [encs[i] for i in keep]
    E = encode.round_up(max(e.ev_slot.shape[0] for e in encs))
    b = encode.stack_encoded(encs, list(range(len(encs))), E, C)
    arrays = [b.init_state, b.ev_slot, b.cand_slot, b.cand_f, b.cand_a,
              b.cand_b]
    arrays = [np.concatenate([a, np.full((2,) + a.shape[1:], f, a.dtype)])
              for a, f in zip(arrays, wgl._PAD_FILLS)]
    return [hs[i] for i in keep], [ms[i] for i in keep], arrays


def _assert_plain_equals_jax(arrays, C):
    E = arrays[1].shape[1]
    ref = [np.asarray(x) for x in
           ref_dense.make_dense_fn("unordered-queue", E, C, 0)(*arrays)]
    tensors = carry.batch_from_reference(*arrays, device="cpu")
    checker = dense.make_dense_fn("unordered-queue", E, C, 0,
                                  torch.device("cpu"))
    ours = [x.numpy() for x in checker(*tensors)]
    for name, o, r in zip(("ok", "failed_at", "overflow"), ours, ref):
        assert o.dtype == r.dtype, name
        assert o.tobytes() == r.tobytes(), (name, o, r)
    return ours


@pytest.mark.parametrize("C", range(1, 13))
def test_plain_version_equals_jax_kernel(C):
    hs, _, arrays = _corpus(C, 4700 + C)
    ok, failed_at, _ = _assert_plain_equals_jax(arrays, C)
    assert arrays[0].any()  # some rows start with initial contents
    assert (~ok).any() and ok[:len(hs)].any()
    assert ok[-2:].all() and (failed_at[-2:] == -1).all()  # padding rows


def _random_codes(seed, B=16, E=32, C=7, amin=-3, amax=40):
    """Random lanes: any slot ids and op codes, value ids past both ends
    of 1..32, an initial bitset of any 32 bits, events past C."""
    r = np.random.default_rng(seed)
    init = r.integers(-2 ** 31, 2 ** 31, B, dtype=np.int64).astype(np.int32)
    ev = r.integers(-1, C + 2, (B, E)).astype(np.int32)
    cs = r.integers(-1, C, (B, E, C)).astype(np.int8)
    cf = r.choice([F_ENQUEUE, F_DEQUEUE, 0, 1, 13], (B, E, C),
                  p=[0.4, 0.4, 0.1, 0.05, 0.05]).astype(np.int8)
    ca = r.integers(amin, amax + 1, (B, E, C)).astype(np.int16)
    cb = r.integers(0, 4, (B, E, C)).astype(np.int16)
    return [init, ev, cs, cf, ca, cb]


@pytest.mark.parametrize("seed,C,amax", [(0, 7, 40), (1, 12, 33),
                                         (2, 3, 8)])
def test_plain_version_equals_jax_kernel_random_codes(seed, C, amax):
    _assert_plain_equals_jax(_random_codes(seed, C=C, amax=amax), C)


@pytest.mark.parametrize("C", [2, 5, 7])
def test_verdicts_equal_direct_checker_and_frontier(C):
    hs, ms, arrays = _corpus(C, 4800 + C, n=8)
    n = len(hs)
    ok = _assert_plain_equals_jax(arrays, C)[0][:n]
    direct = [wgl.check_batch(m, [h], device="cpu")[0]
              for h, m in zip(hs, ms)]
    assert {r["engine"] for r in direct} == {"oracle-routed"}
    assert ok.tolist() == [r["valid?"] for r in direct]
    E = arrays[1].shape[1]
    F = wgl.sufficient_frontier(1, C, "unordered-queue")
    frontier = wgl.make_check_fn("unordered-queue", E, C, F, C + 1)
    f_ok, _, f_ovf = frontier.reference(
        *carry.batch_from_reference(*arrays, device="cpu"))
    assert not f_ovf.any()
    assert f_ok.numpy()[:n].tolist() == ok.tolist()


def test_value_domain_is_normalised_out_and_routing_unchanged():
    cpu = torch.device("cpu")
    a = dense.make_dense_fn("unordered-queue", 64, 6, 0, cpu)
    assert dense.make_dense_fn("unordered-queue", 64, 6, 28, cpu) is a
    assert a.S == 1 and a.family == "unordered-queue"
    assert wgl.kernel_choice("unordered-queue", 6, 8) == "oracle"
    assert wgl.make_best_check_fn("unordered-queue", 64, 6, 128, 7, 8,
                                  cpu) is None
    assert dense.applicable("unordered-queue", 12, 0)
    assert not dense.applicable("unordered-queue", 13, 0)
    with pytest.raises(ValueError, match="no dense kernel"):
        dense.DenseChecker("unordered-queue", 64, 13, 0)


def test_work_counts_the_operations_the_function_needs():
    """One enqueue at C = 1 (W = 1): one closure pass changes D (4 for
    the slot's AND, mask, shift and OR, 2 for D | update and the
    compare), the confirming pass is free, the completion costs 3."""
    h = synth.generate_queue_history(random.Random(0), 1, 1)
    e = encode.encode_history(h, models.unordered_queue(), slot_cap=1)
    b = encode.stack_encoded([e], [0], e.ev_slot.shape[0], 1)
    arrays = carry.batch_from_reference(
        b.init_state, b.ev_slot, b.cand_slot, b.cand_f, b.cand_a, b.cand_b,
        device="cpu")
    work: dict = {}
    ok, _, _ = dense.dense_queue_reference(*arrays, work=work)
    assert ok.all() and work["int_ops"] == 9


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_apart():
    _, _, arrays = _corpus(4, 4900, n=4)
    tensors = carry.batch_from_reference(*arrays, device="cpu")
    kernel = dense.DENSE_KERNELS["unordered-queue"]
    assert kernel.name == "dense_queue"
    before = {f: k.launches for f, k in dense.DENSE_KERNELS.items()}
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel(*tensors)
    dense.make_dense_fn("unordered-queue", arrays[1].shape[1], 4, 0,
                        torch.device("cpu"))(*tensors)
    assert {f: k.launches for f, k in dense.DENSE_KERNELS.items()} == before


# ---------------------------------------------------------------------------
# The CUDA kernel's warp design (csrc/dense_automaton.cu, dense_queue_kernel)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _low_has(x):
    """OR of has(o, .) over the slots o < 5 of the set x."""
    r = 0
    for o in range(5):
        if x >> o & 1:
            r |= ~dense._LOMASK[o] & _U32
    return r


def _slot_words(kind, vbit, P, Q, enq_c, deq_c):
    """The kernel's ``slot_words``: (w0, w1, hi) of a dequeue slot, zeros
    for any other."""
    if kind == 2 and not deq_c & vbit:
        notq = ~_low_has(Q) & _U32
        enq_done = enq_c & vbit != 0
        p_hi = 0 if enq_done else P >> 5
        w0 = notq if enq_done else _low_has(P) & notq
        w1 = notq if enq_done or p_hi else 0
        return w0, w1, p_hi | (Q >> 5) << 8
    return 0, 0, 0


def _image(D, x, j, k):
    """Slot j's subset map of the words x (the image holds slot j)."""
    if j < 5:
        return ((x & dense._LOMASK[j]) << (1 << j)) & _U32
    wb = 1 << (j - 5)
    return np.where(k & wb, x[k ^ wb], 0)


def _queue_twin(arrays):
    """A plain twin of the kernel's arithmetic, one row at a time: the
    dequeue slots' masks from the P_j / Q_j slot sets (three words a
    slot), the closure as one sweep over the enqueue slots and one over
    the dequeue slots, completion, the prefix bitsets.  Returns (ok,
    failed_at, stale): stale counts the events where one more closure
    pass over every slot would still have changed D (the two sweeps not
    at the fixpoint)."""
    init, ev, cs, cf, ca, _ = (np.asarray(a) for a in arrays)
    B, E, C = cs.shape
    W = max(1, (1 << C) // 32)
    k = np.arange(W, dtype=np.int64)
    ok = np.ones(B, bool)
    failed_at = np.full(B, -1, np.int32)
    stale = 0
    for row in range(B):
        D = np.zeros(W, np.int64)
        D[0] = 1
        enq_c, deq_c = int(init[row]) & _U32, 0
        for e in range(E):
            es = int(ev[row, e])
            if es < 0:
                continue
            kind, a, vbit = [0] * C, [0] * C, [0] * C
            for j in range(C):
                lanes = [l for l in range(C) if cs[row, e, l] == j]
                f = sum(int(cf[row, e, l]) for l in lanes)
                a[j] = sum(int(ca[row, e, l]) for l in lanes)
                if lanes:
                    kind[j] = {F_ENQUEUE: 1, F_DEQUEUE: 2}.get(f, 0)
                    vbit[j] = 1 << a[j] - 1 if 1 <= a[j] <= 32 else 0
            valid = []
            for j in range(C):
                P = sum(1 << o for o in range(C)
                        if kind[o] == 1 and a[o] == a[j])
                Q = sum(1 << o for o in range(C)
                        if kind[o] == 2 and a[o] == a[j] and o != j)
                w0, w1, hi = _slot_words(kind[j], vbit[j], P, Q, enq_c,
                                         deq_c)
                valid.append(np.where((hi >> 8) & k, 0,
                                      np.where(hi & 0xFF & k, w1, w0)))
            for j in range(C):  # the enqueue sweep
                if kind[j] == 1:
                    D = D | _image(D, D, j, k)
            for j in range(C):  # the dequeue sweep
                D = D | _image(D, D & valid[j], j, k)
            after = D.copy()
            for j in range(C):
                moves = D if kind[j] == 1 else D & valid[j]
                after |= _image(D, moves, j, k)
            stale += int((after != D).any())
            if es >= C:
                D = np.zeros_like(D)
            elif es < 5:
                D = (D >> (1 << es)) & dense._LOMASK[es]
            else:
                wb = 1 << (es - 5)
                D = np.where(k & wb, 0, D[k | wb])
            if not D.any():
                ok[row], failed_at[row] = False, e
                break
            if kind[es] == 1:
                enq_c |= vbit[es]
            if kind[es] == 2:
                deq_c |= vbit[es]
    return ok, failed_at, stale


@pytest.mark.parametrize("C", range(1, 13))
def test_kernel_twin_equals_jax_kernel(C):
    """The kernel's mask formula and its closure of two ordered sweeps,
    held byte for byte against the reference's build_dense_queue (and the
    plain version) on the generator's corpus, invalid and crashed
    histories included, and on random codes; no event ends its sweeps
    short of the fixpoint."""
    for arrays in (_corpus(C, 4700 + C)[2],
                   _random_codes(5100 + C, B=12, E=24, C=C)):
        ours = _assert_plain_equals_jax(arrays, C)
        ok, failed_at, stale = _queue_twin(arrays)
        assert ok.tobytes() == ours[0].tobytes()
        assert failed_at.tobytes() == ours[1].tobytes()
        assert stale == 0


@pytest.mark.parametrize("C", range(1, 13))
def test_closure_settles_within_c_passes(C):
    """No event needs more than C closure passes that change D, so the
    reference's C + 2 cap never binds: its passes stop at the least
    fixpoint, which any order of the same updates that ends there (the
    kernel's two sweeps) reaches too."""
    cpu = torch.device("cpu")
    for arrays, floor in ((_corpus(C, 5200 + C, n=12, n_ops=40)[2], 1),
                          (_random_codes(5300 + C, B=24, C=C), 0)):
        work: dict = {}
        dense.dense_queue_reference(
            *carry.batch_from_reference(*arrays, device=cpu), work=work)
        assert floor <= work["max_passes"] <= C


def test_queue_design_matches_the_kernel_source():
    """``dense.queue_design`` mirrors the launch: G = min(W, 2^kLogMaxGroup)
    lanes a history, 32 / G histories a warp, W / G words a lane."""
    src = (Path(dense.__file__).parent / "csrc" / "dense_automaton.cu")
    m = re.search(r"constexpr int kLogMaxGroup = (\d+);", src.read_text())
    assert m and 1 << int(m.group(1)) == dense.MAX_GROUP_LANES
    shapes = {C: tuple(dense.queue_design(C)[key] for key in (
        "lanes_per_history", "histories_per_warp", "words_per_lane"))
        for C in range(1, 13)}
    assert {shapes[C] for C in range(1, 6)} == {(1, 32, 1)}
    assert shapes[6] == (2, 16, 1) and shapes[8] == (8, 4, 1)
    assert shapes[10] == (32, 1, 1)
    assert shapes[11] == (32, 1, 2) and shapes[12] == (32, 1, 4)
