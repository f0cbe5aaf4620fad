"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); imports nothing of
JAX or of the JAX package.  Every phase prints one JSON line; any build
failure, launch error or mismatch raises and the script exits non-zero
without its last line.

1. build — compiles every kernel of the port from ``jepsen_tpu_torch/ops
   /csrc/`` (one ``nvcc`` per source, started together) into
   ``build/kernels/``, and prints the card's name and power limit.
2. flagship — the dense automaton's CUDA kernel against its plain
   PyTorch version on the card at the headline shape: 32 synth templates
   of 1000-op CAS-register histories (seed 45100, 5 processes, crash
   probability 0.002, a quarter corrupted, slot cap 16) expanded to
   16384 rows by per-row value relabelings (the batch bench.py builds),
   E = 832, C = 8, V = 8.  Outputs must be byte-equal (tolerance: exact,
   every output is an integer or a bool), and rows of one template must
   agree (a relabeling preserves the verdict).
3. edges — the same comparison at the envelope's edges: C = 4 (one
   word), C = 12 (128 words), V = 32, C = 12 with V = 32, and mutex op
   codes.
4. end to end — ``check_batch(models.cas_register(0), histories)`` on
   1024 synth 1000-op histories plus a few that overflow the slot cap
   (so the oracle pool runs), window 4, launch counter reset just before
   and read just after; verdicts held against the port's CPU oracle on a
   64-history sample.
5. times — kernel ms (CUDA events, median of 7 after 2 warm-ups), its
   bound, the plain version's ms, end-to-end histories/s, each beside the
   card's name and power limit.

The last lines are the nvidia-smi line, ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

import numpy as np
import torch

from jepsen_tpu_torch import models, synth
from jepsen_tpu_torch.checker import linear
from jepsen_tpu_torch.ops import _build, dense, encode, wgl

#: H100 SXM peak rates the bound is priced against: HBM3 bandwidth
#: (NVIDIA data sheet), and 32-bit integer operations at 132 SMs × 64
#: INT32 lanes × 1.98 GHz boost clock (Hopper architecture white paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

FLAGSHIP_ROWS = 16384
E2E_HISTORIES = 1024


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def to_device(arrays, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def batch_arrays(b: encode.EncodedBatch):
    return (b.init_state, b.ev_slot, b.cand_slot, b.cand_f, b.cand_a,
            b.cand_b)


def compare(checker: dense.DenseChecker, arrays):
    """Kernel vs plain version on the same device tensors; returns
    (kernel outputs as numpy, plain seconds, max |kernel - plain|)."""
    kern = checker(*arrays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = checker.reference(*arrays)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    kern = [x.cpu().numpy() for x in kern]
    plain = [x.cpu().numpy() for x in plain]
    for name, k, p in zip(("ok", "failed_at", "overflow"), kern, plain):
        require(k.dtype == p.dtype and k.tobytes() == p.tobytes(),
                f"kernel and plain version differ in {name} "
                f"(B={len(k)}, first row {int(np.argmax(k != p))})")
    err = max(int(np.abs(k.astype(np.int64) - p.astype(np.int64)).max(
        initial=0)) for k, p in zip(kern, plain))
    return kern, plain_s, err


def flagship_batch():
    """bench.py's headline batch: templates expanded by relabelings."""
    hists = synth.generate_batch(seed=45100, n_histories=32, n_procs=5,
                                 n_ops=1000, crash_p=0.002,
                                 corrupt_fraction=0.25)
    batch = encode.batch_encode(hists, models.cas_register(0), slot_cap=16)
    K = batch.init_state.shape[0]
    require(K > 0, "no flagship template survived encoding")
    vmax = int(max(batch.cand_a.max(), batch.cand_b.max(),
                   batch.init_state.max()))
    B = FLAGSHIP_ROWS
    reps = np.random.default_rng(45100).integers(0, K, size=B)
    r = np.random.default_rng(0)
    perm = np.argsort(r.random((B, vmax)), axis=1).astype(np.int16) + 1
    table = np.concatenate([np.zeros((B, 1), np.int16), perm], axis=1)
    a = np.take_along_axis(table, batch.cand_a[reps].reshape(B, -1), axis=1)
    b = np.take_along_axis(table, batch.cand_b[reps].reshape(B, -1), axis=1)
    E, C = batch.ev_slot.shape[1], batch.cand_slot.shape[2]
    arrays = (
        table[np.arange(B), batch.init_state[reps]].astype(np.int32),
        batch.ev_slot[reps], batch.cand_slot[reps], batch.cand_f[reps],
        a.reshape(B, E, C), b.reshape(B, E, C),
    )
    return arrays, reps, encode.round_up(vmax + 1, 4)


def kernel_bound(arrays, failed_at, int_ops):
    """Least time for the function on these inputs: each input byte the
    run needs read once (a row's events up to its failing one, candidate
    lanes of non-padding events only), each output written once, and the
    integer operations the run's data needs; the larger of the two."""
    ev_slot = arrays[1]
    B, E = ev_slot.shape
    C = arrays[2].shape[2]
    n_ev = np.where(failed_at >= 0, failed_at + 1, E)
    needed = np.arange(E)[None, :] < n_ev[:, None]
    live = needed & (ev_slot >= 0)
    nbytes = (B * (4 + 6) + 4 * int(needed.sum())
              + (1 + 1 + 2 + 2) * C * int(live.sum()))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int_ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def time_kernel(checker, arrays, reps=7, warmup=2):
    for _ in range(warmup):
        checker(*arrays)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        checker(*arrays)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def edge_cases():
    """(name, spec, model, histories, slot cap, C, V) at the envelope's
    edges."""
    rng = random.Random(4242)
    cas = models.cas_register(0)
    return [
        ("C4-W1", "cas-register", cas,
         [synth.generate_history(rng, n_procs=3, n_ops=300, corrupt=i % 4 == 0)
          for i in range(128)], 4, 4, None),
        ("C12-W128", "cas-register", cas,
         [synth.generate_history(rng, n_procs=11, n_ops=150, crash_p=0.01,
                                 corrupt=i % 4 == 0) for i in range(128)],
         12, 12, None),
        ("V32", "cas-register", cas,
         [synth.generate_history(rng, n_procs=5, n_ops=300, n_values=28,
                                 corrupt=i % 4 == 0) for i in range(128)],
         8, 8, 32),
        ("C12-V32", "register", models.register(0),
         [synth.generate_history(rng, n_procs=11, n_ops=150, n_values=28,
                                 crash_p=0.01, op_weights=(1, 1, 0),
                                 corrupt=i % 4 == 0) for i in range(64)],
         12, 12, 32),
        ("mutex", "mutex", models.mutex(),
         [synth.generate_lock_history(rng, n_procs=6, n_ops=300,
                                      corrupt=i % 4 == 0)
          for i in range(128)], 8, 8, None),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # -- 1. build and device ------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build()
    card = card_line()
    print(card, flush=True)
    emit(phase="build", seconds=time.perf_counter() - t0,
         kernels={k: v["seconds"] for k, v in report.items()},
         ptxas={k: v["ptxas"] for k, v in report.items()},
         card=card, torch=torch.__version__, cuda=torch.version.cuda)

    # -- 2. kernel against its plain version at the flagship shape ----------
    arrays_np, reps, V = flagship_batch()
    B, E, C = arrays_np[2].shape
    arrays = to_device(arrays_np, device)
    checker = dense.make_dense_fn("cas-register", E, C, V, device)
    (ok, failed_at, _), plain_s, err = compare(checker, arrays)
    work: dict = {}  # a second plain run counts the integer operations
    checker.reference(*arrays, work=work)
    for t in np.unique(reps):
        rows = reps == t
        require(len(set(ok[rows])) == 1 and len(set(failed_at[rows])) == 1,
                f"rows of template {int(t)} disagree")
    emit(phase="flagship", rows=int(B), E=int(E), C=int(C), V=int(V),
         compared_rows=int(B), invalid=int((~ok).sum()), max_abs_err=err,
         plain_s=plain_s, tolerance="exact (byte-equal)")

    # -- 3. kernel coverage at the envelope edges ---------------------------
    for name, spec, model, hs, cap, c_edge, v_edge in edge_cases():
        encs = [e for e in (encode.encode_history(h, model, cap) for h in hs)
                if e is not None]
        E_edge = encode.round_up(max(e.ev_slot.shape[0] for e in encs))
        eb = encode.stack_encoded(encs, list(range(len(encs))), E_edge,
                                  c_edge)
        dom = wgl.value_domain(eb.init_state, eb.cand_a, eb.cand_b)
        v = v_edge or encode.round_up(dom, 4)
        require(dom <= v, f"{name}: value domain {dom} exceeds V={v}")
        edge = dense.make_dense_fn(spec, E_edge, c_edge, v, device)
        (e_ok, _, _), _, e_err = compare(edge,
                                         to_device(batch_arrays(eb), device))
        err = max(err, e_err)
        emit(phase="edge", case=name, spec=spec, rows=len(encs), E=E_edge,
             C=c_edge, V=v, invalid=int((~e_ok).sum()), max_abs_err=e_err)

    # -- 4. end to end through check_batch ----------------------------------
    hs = synth.generate_batch(seed=45101, n_histories=E2E_HISTORIES - 8,
                              n_procs=5, n_ops=1000, crash_p=0.002,
                              corrupt_fraction=0.25)
    rng = random.Random(45102)
    hs += [synth.generate_history(rng, n_procs=12, n_ops=48, crash_p=0.0)
           for _ in range(8)]
    model = models.cas_register(0)
    dense.DENSE_AUTOMATON.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = wgl.check_batch(model, hs, slot_cap=8)
    e2e_s = time.perf_counter() - t0
    launches = dense.DENSE_AUTOMATON.launches
    require(launches > 0, "check_batch never launched the dense kernel")
    stats = wgl.batch_stats(results)
    require(stats["engines"].get("oracle-fallback", 0) > 0,
            "no history overflowed the slot cap: the oracle pool never ran")
    device_rows = [i for i, r in enumerate(results) if r["engine"] == "gpu"]
    invalid = [i for i in device_rows if results[i]["valid?"] is False]
    pick = np.random.default_rng(7)
    sample = sorted(set(invalid[:16]) | set(
        pick.choice(device_rows, 64, replace=False).tolist()))[:64]
    for i in sample:
        r = linear.analysis(model, hs[i], pure_fs=("read",))
        require(r["valid?"] == results[i]["valid?"],
                f"history {i}: device says {results[i]['valid?']}, "
                f"oracle says {r['valid?']}")
    emit(phase="end_to_end", histories=len(hs), seconds=e2e_s,
         histories_per_s=len(hs) / e2e_s, launches=launches,
         oracle_sample=len(sample), batch_stats=stats, card=card)

    # -- 5. times -----------------------------------------------------------
    ms, all_ms = time_kernel(checker, arrays)
    bound_ms, bound_by, nbytes = kernel_bound(arrays_np, failed_at,
                                              work["int_ops"])
    emit(phase="times", kernel="dense_automaton", rows=int(B), E=int(E),
         C=int(C), V=int(V), ms=ms, runs_ms=all_ms, bound_ms=bound_ms,
         bound_by=bound_by, bytes=nbytes, int_ops=work["int_ops"],
         plain_ms=plain_s * 1e3, e2e_histories_per_s=len(hs) / e2e_s,
         library_ms=None,
         library="no single PyTorch call computes the dense automaton",
         card=card)

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "dense_automaton",
        "route": "cuda",
        "source": "jepsen_tpu_torch/ops/csrc/dense_automaton.cu",
        "replaces": "jepsen_tpu/ops/dense.py:381",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_s * 1e3,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
