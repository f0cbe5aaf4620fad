"""Sharded dispatch over a device mesh and the verdict-stats reduction
(K9), on the CPU: a mesh that names the CPU four times stands in for four
devices, as the reference's tests use virtual host devices.

- ``check_batch(mesh=...)`` against the unsharded port (whole result
  dicts, byte-equal as JSON) and against the reference's verdicts, on
  dense, frontier-with-escalation, lock-family and decomposed
  multi-register corpora; Elle's ``check_batch`` through an Executor on
  the mesh against the unsharded port and the reference.
- ``shard_row_target`` against the reference's over a grid.
- The plain ``verdict_stats`` against the reference's, and over sharded
  outputs of a batch that does not divide the mesh: a padding row counted
  as valid would show.  Tolerance: exact (integer counts).
- A plain twin of the CUDA kernel's word-wise count (16-byte alignment,
  per-byte truth of 32-bit words, head and tail bytes) against the plain
  version at every start offset, bytes other than 0 and 1 included, and
  ``stats_design`` against the kernel source's switch.

The CUDA kernel is held against the plain version on the card by
``chip_smoke.py`` (phase 20).
"""

import json
import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import elle as ref_elle
from jepsen_tpu import models as ref_models
from jepsen_tpu.engine import execution as ref_execution
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.parallel import mesh as ref_mesh
from jepsen_tpu_torch import elle, models, synth
from jepsen_tpu_torch.engine import execution
from jepsen_tpu_torch.ops import carry, cycles, dense, encode, wgl
from jepsen_tpu_torch.parallel import mesh as mesh_mod

CPU = torch.device("cpu")
MESH4 = mesh_mod.Mesh(["cpu"] * 4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    wgl.ESCALATIONS.clear()
    yield
    torch.set_num_threads(n)
    wgl.ESCALATIONS.clear()


def _dumps(results):
    return json.dumps(results, sort_keys=True, default=repr)


def _ref(hs):
    return [RefHistory.from_dicts(h.to_dicts()) for h in hs]


def _lock_corpus(seed, reentrant=False, as_mutex=False):
    rng = random.Random(seed)
    hs = [synth.generate_lock_history(rng, n_procs=4, n_ops=40,
                                      reentrant=reentrant,
                                      corrupt=i % 2 == 0) for i in range(9)]
    if as_mutex:  # the plain mutex takes no client identities
        hs = [h.map(lambda op: op.copy(value=None)) for h in hs]
    return hs


def _corpus(case):
    """(port model, reference model, histories, check_batch kwargs)."""
    if case == "cas-register-dense":
        hs = synth.generate_batch(seed=4600, n_histories=13, n_procs=4,
                                  n_ops=40, corrupt_fraction=0.4)
        return models.cas_register(0), ref_models.cas_register(0), hs, {}
    if case == "cas-register-frontier-escalation":
        rng = random.Random(4610)
        hs = [synth.generate_history(rng, n_procs=5, n_ops=150, crash_p=0.02,
                                     replace_crashed=True, n_values=60,
                                     corrupt=i % 4 == 0) for i in range(10)]
        return (models.cas_register(0), ref_models.cas_register(0), hs,
                {"frontier": 4})
    if case == "mutex":
        return (models.mutex(), ref_models.mutex(),
                _lock_corpus(4620, as_mutex=True), {})
    if case == "owner-mutex":
        return (models.owner_mutex(), ref_models.owner_mutex(),
                _lock_corpus(4630), {})
    if case == "reentrant-mutex":
        return (models.reentrant_mutex(), ref_models.reentrant_mutex(),
                _lock_corpus(4640, reentrant=True), {})
    if case == "multi-register-decomposed":
        rng = random.Random(4650)
        hs = [synth.generate_mr_history(rng, n_procs=4, n_ops=40, n_keys=3,
                                        n_values=4, corrupt=i % 3 == 0)
              for i in range(9)]
        regs = {k: 0 for k in range(3)}
        return (models.multi_register(regs), ref_models.multi_register(regs),
                hs, {"decomposed": True})
    raise KeyError(case)


CASES = ["cas-register-dense", "cas-register-frontier-escalation", "mutex",
         "owner-mutex", "reentrant-mutex", "multi-register-decomposed"]


@pytest.mark.parametrize("case", CASES)
def test_sharded_check_batch_equals_unsharded_and_reference(case):
    model, ref_model, hs, kw = _corpus(case)
    whole = wgl.check_batch(model, hs, device="cpu", **kw)
    rungs = dict(wgl.ESCALATIONS)
    wgl.ESCALATIONS.clear()
    stats: dict = {}
    sharded = wgl.check_batch(model, hs, mesh=MESH4, stats=stats, **kw)
    assert _dumps(sharded) == _dumps(whole)
    assert stats["devices"] == ["cpu"] * 4
    assert sum(stats["dev_rows_live"]) >= len(hs)
    assert sum(stats["dev_rows_total"]) == \
        sum(stats["dev_rows_live"]) + stats["shard_pad_rows"]
    assert dict(wgl.ESCALATIONS) == rungs
    ref = ref_wgl.check_batch(ref_model, _ref(hs), **kw)
    assert [r["valid?"] for r in sharded] == [r["valid?"] for r in ref]
    assert {r["valid?"] for r in sharded} == {True, False}
    engines = {r["engine"] for r in sharded}
    if case == "cas-register-frontier-escalation":
        assert rungs and "oracle-overflow" in engines
    else:
        assert "gpu" in engines


@pytest.mark.parametrize("workload,mode", [("list-append", "append"),
                                           ("rw-register", "wr")])
def test_elle_through_a_mesh_executor_equals_unsharded(workload, mode):
    hs = synth.generate_txn_batch(4660, 6, mode, n_txns=50, key_count=6)
    opts = {"workload": workload, "consistency-models": ["serializable"],
            "screen-route": "device"}
    whole = elle.check_batch(opts, hs, device="cpu")
    ex = execution.Executor(4, mesh=MESH4)
    sharded = elle.check_batch(opts, hs, executor=ex)
    assert _dumps(sharded) == _dumps(whole)
    assert sum(ex.dev_rows_total) > 0 and ex.n_devices == 4
    ref = ref_elle.check_batch(dict(opts, **{"screen-route": "cpu"}),
                               _ref(hs))
    assert [r["valid?"] for r in sharded] == [r["valid?"] for r in ref]
    assert False in [r["valid?"] for r in sharded]


def test_executor_counts_live_and_padding_rows_per_device():
    rng = np.random.default_rng(1)
    mats = [rng.random((12, 12)) < 0.1 for _ in range(10)]
    ex = execution.Executor(2, mesh=MESH4)
    flags = cycles.has_cycle_batch(mats, executor=ex)
    whole = cycles.has_cycle_batch(mats, device="cpu")
    assert flags.tolist() == whole.tolist()
    # 10 rows pad to 4 shards of 16 (the 64-row floor spread over 4)
    assert ex.shard_pad_rows == 54
    assert ex.dev_rows_live == [10, 0, 0, 0]
    assert ex.dev_rows_total == [16] * 4


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_shard_row_target_equals_reference(shards):
    for n in (0, 1, 2, 7, 63, 64, 65, 100, 1000, 5000, 16385):
        ours = execution.shard_row_target(n, shards)
        assert ours == ref_execution.shard_row_target(n, shards), (n, shards)
        assert ours % shards == 0 and ours >= n


@pytest.mark.parametrize("B,p_ok,p_ovf", [(1, 0.5, 0.0), (100, 0.6, 0.1),
                                          (4097, 0.3, 0.5)])
def test_plain_verdict_stats_equals_reference(B, p_ok, p_ovf):
    r = np.random.default_rng(B)
    ok = r.random(B) < p_ok
    ovf = r.random(B) < p_ovf
    ref = ref_mesh.verdict_stats(jnp.asarray(ok), jnp.asarray(ovf))
    ours = mesh_mod.verdict_stats(torch.from_numpy(ok), torch.from_numpy(ovf))
    for k in ("valid", "invalid", "unknown"):
        assert ours[k].dtype == torch.int64 and ours[k].dim() == 0
        assert int(ours[k]) == int(ref[k]), k
    plain = mesh_mod.verdict_stats_reference(torch.from_numpy(ok),
                                             torch.from_numpy(ovf))
    assert plain.tolist() == [int(ref[k]) for k in
                              ("valid", "invalid", "unknown")]


def test_sharded_stats_count_live_rows_only():
    """7 histories on a 4-shard mesh: one neutral padding row, which
    reports valid.  Stats over the sharded outputs must equal the
    unsharded ones; over the padded outputs they would not."""
    hs = synth.generate_batch(seed=4670, n_histories=7, n_procs=3, n_ops=30,
                              corrupt_fraction=0.5)
    b = encode.batch_encode(hs, models.cas_register(0), slot_cap=8)
    arrays = (b.init_state, b.ev_slot, b.cand_slot, b.cand_f, b.cand_a,
              b.cand_b)
    B, E, C = b.cand_slot.shape
    assert B == 7
    fn = dense.make_dense_fn("cas-register", E, C, 8, CPU)
    ok, failed_at, ovf = mesh_mod.sharded_check(fn, MESH4, *arrays)
    assert [len(s) for s in ok] == [2, 2, 2, 1]
    stats = mesh_mod.verdict_stats(ok, ovf, MESH4)
    whole_ok, _, whole_ovf = fn(*carry.batch_from_reference(*arrays,
                                                            device="cpu"))
    ref = ref_mesh.verdict_stats(jnp.asarray(whole_ok.numpy()),
                                 jnp.asarray(whole_ovf.numpy()))
    for k in ("valid", "invalid", "unknown"):
        assert int(stats[k]) == int(ref[k]), k
    assert int(stats["invalid"]) > 0
    assert torch.cat(failed_at).tolist() == \
        fn(*carry.batch_from_reference(*arrays, device="cpu"))[1].tolist()
    padded = tuple(mesh_mod.pad_to_multiple(a, 4, f)
                   for a, f in zip(arrays, wgl._PAD_FILLS))
    p_ok, _, p_ovf = mesh_mod.shard_fn(fn, MESH4)(*padded)
    with_pads = mesh_mod.verdict_stats(p_ok, p_ovf, MESH4)
    assert int(with_pads["valid"]) == int(ref["valid"]) + 1


def test_mesh_and_default_resolution_on_the_cpu(monkeypatch):
    assert MESH4.size == 4 and MESH4.distinct == 1 and MESH4.repeated
    assert "repeated" in repr(MESH4)
    assert not mesh_mod.Mesh(["cpu"]).repeated
    assert MESH4.describe()["devices"] == ["cpu"] * 4
    with pytest.raises(ValueError):
        mesh_mod.Mesh([])
    assert mesh_mod.engine_default_mesh() is None
    assert mesh_mod.engine_default_mesh("off") is None
    with pytest.raises(ValueError, match="mesh mode"):
        mesh_mod.engine_default_mesh("force")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_mod.engine_default_mesh() is None
    monkeypatch.undo()
    assert mesh_mod.run_placement("cpu") == (CPU, None)
    assert mesh_mod.run_placement(None, MESH4) == (CPU, MESH4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_mod.run_placement(None)
    assert mesh_mod.resolve_mesh({"mesh": MESH4}) is MESH4
    assert mesh_mod.resolve_mesh({"mesh-fn": lambda: MESH4}) is MESH4
    assert mesh_mod.resolve_mesh({}) is None


def test_shard_fn_is_cached_per_mesh_and_splits_evenly():
    fn = wgl.make_check_fn("cas-register", 16, 2, 8, 3)
    assert mesh_mod.shard_fn(fn, MESH4) is mesh_mod.shard_fn(fn, MESH4)
    two = mesh_mod.Mesh(["cpu", "cpu"])
    assert mesh_mod.shard_fn(fn, two) is not mesh_mod.shard_fn(fn, MESH4)
    with pytest.raises(ValueError, match="equal shards"):
        mesh_mod.shard_batch(MESH4, np.zeros((6, 2)))
    shards = mesh_mod.shard_batch(two, np.arange(6), np.zeros((6, 3)))
    assert [s[0].tolist() for s in shards] == [[0, 1, 2], [3, 4, 5]]


def test_verdict_stats_kernel_refuses_cpu_tensors():
    ok = torch.ones(4, dtype=torch.bool)
    before = mesh_mod.VERDICT_STATS.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        mesh_mod.VERDICT_STATS(ok, ~ok)
    with pytest.raises(ValueError, match="bool"):
        mesh_mod.shard_counts(ok.int(), ~ok)
    assert int(mesh_mod.verdict_stats(ok, ~ok)["valid"]) == 4
    assert mesh_mod.VERDICT_STATS.launches == before


# ---------------------------------------------------------------------------
# The CUDA kernel's word-wise count (csrc/verdict_stats.cu)
# ---------------------------------------------------------------------------


def _true_bytes(words):
    """``__vcmpne4(w, 0) & 0x01010101``: bit 0 of each byte of the uint32
    words set where that byte is nonzero."""
    t = words | words >> 4
    t |= t >> 2
    t |= t >> 1
    return t & np.uint32(0x01010101)


def _stats_twin(ok_u8, ovf_u8, ok_at, ovf_at):
    """A plain twin of the kernel's count of two byte arrays that start at
    addresses ``ok_at`` and ``ovf_at`` mod 16: when the two agree, the
    bytes before the first 16-byte boundary and after the last one by
    one, the body as 32-bit words four true bytes at a time; else every
    byte by itself.  Returns [valid, invalid, unknown]."""
    B = len(ok_u8)

    def count(o, v):
        on, vn = _true_bytes(o), _true_bytes(v)
        return (int(np.bitwise_count(on & ~vn).sum()),
                int(np.bitwise_count(vn).sum()))

    def by_byte(lo, hi):
        return count(ok_u8[lo:hi].astype(np.uint32),
                     ovf_u8[lo:hi].astype(np.uint32))

    if (ok_at ^ ovf_at) & 15:
        valid, unknown = by_byte(0, B)
    else:
        head = min((16 - ok_at) & 15, B)
        tail = head + (B - head) // 16 * 16
        body = count(ok_u8[head:tail].view("<u4"), ovf_u8[head:tail].view("<u4"))
        edges = [by_byte(0, head), by_byte(tail, B)]
        valid = body[0] + sum(x[0] for x in edges)
        unknown = body[1] + sum(x[1] for x in edges)
    return [valid, B - valid - unknown, unknown]


@pytest.mark.parametrize("B", [0, 1, 15, 17, 16384, 10 ** 6])
def test_word_wise_count_equals_plain_version(B):
    """The twin against ``verdict_stats_reference`` on bool tensors viewed
    from bytes other than 0 and 1 as well, at every start offset 0-15 of
    each array (all pairs up to 16384 rows; at 10^6, each offset of one
    array beside another of the other)."""
    r = np.random.default_rng(4700 + B)
    buf_ok = r.choice(np.array([0, 1, 2, 0x80, 0xFF, 0], np.uint8), B + 16)
    buf_ovf = r.choice(np.array([0, 0, 0, 1, 7, 0x40], np.uint8), B + 16)
    pairs = ([(i, j) for i in range(16) for j in range(16)] if B <= 16384
             else [(i, (7 * i + 3) % 16) for i in range(16)])
    for i, j in pairs:
        ok_u8, ovf_u8 = buf_ok[i:i + B], buf_ovf[j:j + B]
        want = mesh_mod.verdict_stats_reference(
            torch.from_numpy(ok_u8).view(torch.bool),
            torch.from_numpy(ovf_u8).view(torch.bool)).tolist()
        assert want == mesh_mod.verdict_stats_reference(
            torch.from_numpy(ok_u8 != 0), torch.from_numpy(ovf_u8 != 0)
        ).tolist()
        assert _stats_twin(ok_u8, ovf_u8, i, j) == want, (i, j)


def test_stats_design_matches_the_kernel_source():
    """``mesh.stats_design`` mirrors the launch's switch: one block up to
    VERDICT_STATS_SINGLE_MAX_ROWS rows, a grid past them."""
    src = Path(mesh_mod.__file__).parents[1] / "ops" / "csrc" / \
        "verdict_stats.cu"
    m = re.search(r"#define VERDICT_STATS_SINGLE_MAX_ROWS (\d+)",
                  src.read_text())
    assert m and int(m.group(1)) == mesh_mod.STATS_SINGLE_MAX_ROWS
    n = mesh_mod.STATS_SINGLE_MAX_ROWS
    assert mesh_mod.stats_design(16384) == "single"
    assert mesh_mod.stats_design(n) == "single"
    assert mesh_mod.stats_design(n + 1) == "grid"
