"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (``nvcc``); imports nothing of
JAX or of the JAX package.  Every phase prints one JSON line (with the
seconds elapsed since the script started); any build failure, launch
error or mismatch raises and the script exits non-zero without its last
line.

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
   agree (a relabeling preserves the verdict).  The compared plain run
   also counts the integer operations the bound is priced with.
3. edges — the same comparison at the envelope's edges: C = 4, 6 and 7
   (W = 1, 2 and 4 words: 32, 16 and 8 histories per warp), C = 12 (128
   words), V = 32, C = 12 with V = 32, and mutex op codes; then rows
   built for the kernel's two designs: batches whose row count is not a
   multiple of the histories per warp, rows that fail at event 0,
   all-padding rows, rows of read-any codes, and the register family at
   C = 12 on both sides of the warp/block switch (S·W = WARP_MAX_SW and
   one state more, through the wrapper directly).
4. end to end — ``check_batch(models.cas_register(0), histories)`` on
   1024 synth 1000-op histories plus a few that overflow the slot cap
   (so the oracle pool runs), window 4, launch counter reset just before
   and read just after; verdicts held against the port's CPU oracle on a
   64-history sample.
5. times — kernel ms (CUDA events, median of 7 after 2 warm-ups), its
   bound, the plain version's ms, end-to-end histories/s, the design the
   shape runs ("warp" or "block") with the kernel's registers and spill
   bytes from ptxas, each beside the card's name and power limit.
6. frontier — the frontier search's CUDA kernel against its plain
   PyTorch version on the card at the slice's shape: 1024 synth 1000-op
   CAS-register histories (seed 45200, 5 processes, crash probability
   0.002, a quarter corrupted, writes from 40 values, so the value
   domain leaves the dense envelope), E ≈ 768, C = 8, at F = 128 and at
   F = 512.  Byte-equal on every output (tolerance: exact).
7. frontier edges — the same comparison at C = 16 (crash-heavy
   10-process histories); at its first rung's capacity (F = 512) the
   kernel runs on every row of that batch that overflowed, padded as the
   escalation ladder pads them, and is held against the plain version on
   a fixed subset of those rows (the first of each outcome the full run
   gave, then the first rows, 8 in all, padded the same way; the
   subset's outputs must also equal the full run's); then at the
   sufficient rung's capacity (C = 4),
   with two linset words (slot ids moved past 32), with max_closure = 2,
   and on one random batch per step function (register, cas-register,
   mutex, reentrant mutex, multi-register, unordered queue) at F = 16.
   Then rows built for the kernel's two designs (each line names the
   design it ran): both sides of the warp/block switch in F (the C = 16
   rows at the largest warp capacity and twice it) and in C (64 and 65),
   rows whose first closure pass fills exactly F and F + 1 configs and
   then carry on over later events (on both designs), rows of one block
   that finish at different events beside all-padding rows and a row
   failing at event 0, 131 rows (no multiple of the histories a block
   holds), valid rows of 2200 events (past the dedup table's cycle of
   1023 epochs), and C = 32 and 33 (one linset word and two).
8. frontier end to end — ``check_batch`` on the slice's 1024 histories
   plus 8 crash-heavy 10-process ones, frontier launch counter and
   escalation counter reset just before and read just after: the kernel
   must have launched, at least one escalation rung must have run on the
   card, and some rows must have gone to the oracle as
   ``"oracle-overflow"``; device verdicts held against the CPU oracle on
   a 64-history sample.
9. frontier times — as in 5, for the frontier kernel at the slice's
   shape (1024 rows, F = 128), with its design ("warp" or "block"),
   registers and spill bytes.
10. lock and permit families — the dense automaton's reentrant-mutex
    (K1r), register (owner-mutex as cas codes) and acquired-permits
    (K1p) families against their plain versions on the card, at the
    hazelcast workloads' full width: 1024 synth 1000-op histories each
    (10 processes, a quarter corrupted): ``reentrant-cp-lock`` (E = 1024,
    C = 12, V = 24), ``non-reentrant-cp-lock`` (V = 12) and the
    semaphore (2 permits, (N, P) = (12, 2), S = 91 — the largest permit
    shape the planner gives at C = 12).  Byte-equal (tolerance: exact).
11. multi-register — the multi-register family (K1m) the same way: 1024
    two-key 1000-op histories (8 processes, 8 values, crash probability
    0.002) as one composite automaton, (Vr, K) = (11, 2), S = 121, C = 8;
    and bench.py's decomposition headline, 64 histories of 1000 ops over
    64 keys split into per-key sub-histories (K = 1).
12. family edges — the largest shapes the planner gives at C = 12: K1m
    at (Vr, K) = (128, 1) and (3, 4), K1r at V = 32 (a directly encoded
    batch of clients 1..15; no synth history reaches it, and rows that
    fail at event 0 and all-padding rows ride with it), and K1p at
    (N, P) = (12, 2) with all twelve clients.
13. family end to end — ``check_batch`` on each of the five batches of
    10 and 11, with a few 15-process lock and permit histories beside
    them (past the dense envelope: the oracle and its direct checkers
    take them), every family's launch counter reset just before and read
    just after: each family's kernel must have launched on its phase.
    Verdicts held against the CPU oracle on a sample; the multi-register
    batches decomposed and undecomposed must agree.
14. family times — as in 5, for each family at its phase-10/11 shape
    (with its design, registers and spills).
15. Elle kernels — the has-cycle (K6) and screen (K7, with the K8 bit
    packing fused) entry points of ``cycles_closure.cu`` against their
    plain PyTorch versions on the card, byte-equal (tolerance: exact), in
    both closure modes: has-cycle on the rw-register per-key version
    graphs of the phase-16 corpus (n = 16, one word per row) and on
    random stacks at n = 32 … 1024; the screen at the list-append
    strict-serializable profile (n = 512, 6 filter masks, 2 lifted
    queries) on the corpus's 64 graphs tiled to 1024 rows; edges: a
    512-vertex ring (the most rounds), a ring whose walks take the
    want→rest hop 256 times, want edges into vertices with no rest
    out-edge, the smallest screen (n = 32), all-zero rows, graphs of
    exactly 512 vertices, has-cycle rings at 32 and 64 (both sides of the
    warp/shared switch), 512 and 1024, and 1023 version graphs (the last
    warp holds one plane).  Each line names the design the shape runs.
16. Elle end to end — ``elle.check_batch`` at bench.py:1282's shape (64
    histories × 400 transactions × 32 keys from ``synth``, the injected
    G1c in every 4th): list-append strict-serializable and rw-register
    serializable with ``screen-route: "device"``, launch counters reset
    just before and read just after (the screen must launch on the
    list-append phase, has-cycle on the rw-register phase); results
    equal to the ``"cpu"`` route's and the self-calibrating ``"auto"``
    route's; histories/s for both routes and the route counts.
17. Elle times — each kernel at a 1024-row stack (has-cycle on the
    version graphs, the screen on phase 15's stack): median of 7 with
    CUDA events around the wrapper, ``device_ms`` (launches captured in
    one CUDA graph and replayed: the device's time without the wrapper's
    host time), its design with the registers and spill bytes ptxas
    reported, its bound (the operations of the algorithm the kernel runs,
    from its plain twin ``cycles.reduced_screen``, or the bytes) beside
    the squaring's count and bound, the plain version's time, and
    ``library_ms``: the same fixed squaring ladder as one thresholded
    bf16 ``torch.bmm`` per round.

18. queue — the unordered-queue automaton (K2, ``dense_queue_launch`` in
    ``dense_automaton.cu``) against its plain version at
    ``linearizable_queue_workload``'s shape (suites/common.py:207-228):
    32 templates of ``synth.generate_queue_history`` (8 processes, 40
    ops, a quarter corrupted, every third with three values queued
    initially) relabelled to 16384 rows by per-row permutations of the
    value ids 1..31; edges at C = 1, 5, 6, 10, 11 and 12 (either side of
    the warp design's one-word and one-warp boundaries), at the 31-value
    cap, all-padding rows, random op codes, a row count that is no
    multiple of the histories a warp, rows failing at event 0 and warps
    whose histories fail at different events.  Byte-equal (tolerance:
    exact).  End to end: the dense entry point
    (``dense.make_dense_fn("unordered-queue", ...)``, K2 counter reset
    around it) on 1024 fresh histories must agree with ``check_batch``'s
    direct checker and the frontier search at F = 256; then its times as
    in 5, with the design (``dense.queue_design``), registers and spills,
    and ``device_ms`` by CUDA-graph replay as in 17.
19. mesh — a two-shard mesh (two cards when there are, else the one card
    named twice; the line says which): ``check_batch(mesh=...)`` on the
    histories of 4 and on 264 of 8's with ``frontier=32`` (escalation
    reruns must run), and ``elle.check_batch`` on the list-append corpus
    of 16 through an Executor on the mesh, each equal to its unsharded
    run, with the padding and live rows per device.
20. verdict stats — K9 (``verdict_stats.cu``) against its plain version
    at 16384 rows, then summed over the shards of ``sharded_check`` on
    the mesh (the dense flagship and the frontier slice at F = 32),
    equal to the unsharded counts; edges: B = 1, inputs that start off a
    16-byte boundary (both alike, and each differently), bytes other than
    0 and 1 read as true, and 10^6 rows past the single-block switch
    (``mesh.stats_design``), each equal to the plain version on the
    bytes' truth.  Times: median of 7 with CUDA events around the wrapper
    (its host time), ``device_ms`` by CUDA-graph replay at 16384 and 10^6
    rows beside an empty kernel's (the floor of a launch), the design,
    registers and spills, the bound by bytes (2B + 24), the plain time
    and ``library_ms`` (three ``torch.count_nonzero`` calls).
21. checker seam — phase 4's 1024 histories as one keyed history (history
    i's values wrapped as ``KV(i, v)``, its processes offset by i × its
    process count, one un-keyed nemesis op at its head: 1024 keys of
    1000-op cas-register histories, 8 of them past the slot cap) through
    ``check_safe(compose({"linear": independent.batched_linearizable(
    cas_register(0), slot_cap=8)}), ...)``, once with obs off and once
    with obs on (histories/s of both beside phase 4's: what the seam and
    the flight recorder cost).  Every key's verdict must equal phase 4's,
    no ``"error"`` anywhere, ``failures`` the invalid keys,
    ``batch-stats`` with ``"gpu"`` and ``"oracle-fallback"`` rows, dense
    launches in both runs; with obs on the ``checker/Compose``,
    ``checker/BatchedLinearizable``, ``engine/pipeline`` and
    ``engine/dispatch`` spans and ``jepsen_kernel_dispatches_total
    {engine="dense"}`` > 0, exported to ``build/obs/`` and passed through
    the port's validators.  Then ``linearizable(model)`` ("auto", on the
    card) on one phase-4 history and one phase-8 frontier history (the
    frontier kernel must launch), an invalid history with a store
    identity (its ``linear.svg`` must be written under ``build/store/``),
    and ``"race"`` on 4 histories past the slot cap (the CPU oracle's
    verdicts; its arms are waited for).
22. profile — ``obs.profiling.capture`` (``torch.profiler``, CPU and CUDA
    activity) around phase 21's batched run with obs on, into
    ``build/profile/``: the trace must be there and list
    ``register_warp_kernel`` with device time > 0; the line gives the
    window's wall seconds, the kernels' summed device seconds and their
    ratio, the device's busy share of the seam run.
23. tuning — the CUDA probe (``platform.probe_accelerator``) must pass;
    the CLI's ``tune --profile smoke`` (``tune.run_tune``) writes its
    artifact into a temporary directory, keyed to the card's name, with budget checks and
    no breach; the line gives the picks beside the pinned defaults, the
    measured configs, the cost table and the tuner's launches of K1, K4,
    K7 (and K1m's).  Then, with that artifact active, phase 4's corpus
    through ``check_batch``: every verdict (``valid?``, ``failed-event``,
    kernel, engine) must equal phase 4's untuned one.  Again with a
    dispatch journal in the temporary directory and a drift sentinel: one
    schema-valid journal row per settled dispatch, each a cache hit whose
    cost is on ``execute_s``, every row scored; the sentinel's snapshot
    is printed.  The calibration, the journal and the sentinel are
    cleared afterwards (the script starts with calibration disabled, so
    no ``calibration.json`` in the working directory steers any phase).
24. checker service — ``serve.spawn_daemon`` starts ``python -m
    jepsen_tpu_torch.serve`` on the card with its default admission bound
    and a temporary WAL under ``build/`` (seconds to ``/healthz``); its
    first request (64 of phase 4's histories) is timed cold.  Four client threads send
    a quarter of phase 4's corpus each at once (``serve.check_batch``):
    every result must equal phase 4's, the clients must have made no
    fallback, ``/status`` must show coalesced dispatches, and the
    daemon's K1 launches (its own counters, read from ``/status`` before
    and after) must be fewer than four separate in-process runs of the
    same quarters make; the line adds the wire's host cost of one
    quarter (the request's build and its decode, in this process).  Then
    256 of phase 8's frontier histories and
    its 8 crash-heavy ones: K4 must launch in the daemon, an escalation
    rung must run there, every result must equal phase 8's.  Phase 16's
    list-append graphs through ``serve.screen_graphs`` must equal the
    in-process device screens, K7 launching in the daemon.  A 64-key
    history of phase 21's form through ``check_safe`` with
    ``linearizable(algorithm="service")`` under the independent lift must
    equal the in-process lift key for key, with no fallback.  Then phase
    25 on the same daemon, and the CLI's ``status`` (its launches line),
    ``top --once`` (the last-60 s rates and settled verdicts off the
    WAL) and ``profile`` (a one-second ``torch.profiler`` window on the
    daemon, its ``profile.json`` written); the CLI's ``shutdown`` must
    drain and the process exit 0.
25. online checking — on phase 24's daemon, a ``/watch`` subscriber from
    the WAL's tail; a feed session of 256 of phase 4's histories in 16
    deltas of 16 (each stamped with ``t_inv``): the first ``valid? =
    false`` verdict must reach ``/watch`` before the close, and the close
    results must equal phase 4's (the line gives the feed's histories/s,
    the seconds from the append that carried the first violation to its
    event, the ``jepsen_feed_ingest_lag_seconds`` mean from ``/metrics``
    and the daemon's K1 launches).  Op mode: one corrupted history of
    phase 4's as raw event dicts in deltas of 64 (the reference's live
    shipper's batch), each delta checking the whole prefix again: the
    violation must reach ``/watch`` before the close, the close must equal
    phase 4's result (the line gives the first and the last delta's
    seconds).  The frontier route: 64 of phase 8's histories and its 8
    crash-heavy ones, K4 and an escalation rung in the daemon, results
    equal to phase 8's.  ``/status`` must show no open session and the
    sessions, deltas and histories sent; the ``/watch`` thread must end at
    phase 24's drain.
26. the fleet — ``python -m jepsen_tpu_torch.cli serve --checker
    --supervise --fleet 2`` (started when phase 24's daemon is ready: two
    daemons on the one card, one WAL each) behind the CLI's ``route`` run
    on a thread of this process: the seconds until both answer
    ``/healthz``, and the CLI's ``status`` with ``--daemon`` must show both
    members; through the router phase 4's corpus
    as four concurrent requests, 72 of phase 8's rows, phase 16's graphs
    through ``/elle`` and a feed session of 64 of phase 4's histories,
    each equal to its phase, each on the member the router ranks first
    (``rendezvous_order`` under its weights; the feed's deltas all on the
    member that opened it), K1, K4 and K7 launching in the members.  Then
    the first quarter's member is SIGKILLed with that request in flight:
    the request must complete on its sibling with phase 4's results and a
    counted reroute, the supervisor must restart the member on the same
    port and WAL (seconds to ``/healthz``), one ``probe_once()`` must mark
    it up and the key's next request must reach it again.  The CLI's
    ``shutdown`` of both members: the supervisor exits 0; its
    ``shutdown`` of the router: the ``route`` command returns 0.
27. the chaos drills — ``serve.chaos.run`` on the card: kill -9 mid-request
    and after settled batches with the WAL's last line torn, a stalled
    socket tripping the breaker and its half-open recovery, a dropped
    response and its idempotent retry, WAL compaction with a crash beside
    a half-written ``.tmp``, a fleet member SIGKILLed behind the router
    and revived with no ``nvcc``.  Drills 1 and 5 carry full-width traffic
    (256 of phase 4's histories, 64 of phase 8's frontier histories), so
    the kills land on requests the daemons are working on; drills 2-4 run
    the reference's smoke corpora.  Every daemon starts at once.  One line
    per drill (its gates, counters, seconds, and its daemons' K1 and K4
    launches from ``/status``); a failed gate raises, and K1 and K4 must
    launch in the daemons.
28. the kernel audit's card half — ``kernel-resources`` on phase 1's ptxas
    reports (one line per ``__global__`` function: its worst instance's
    registers, spill bytes and static shared memory beside its declared
    bound), then ``kernel-budget``: every registered kernel launched at
    its shape buckets at two batch sizes, the per-row device bytes (the
    slope of the allocator's requested peak, ``max_memory_allocated``'s
    beside it) beside its pricing and the ratio, the frontier library's workspace beside the pricing's
    term, the dense entries' bytes at the planner's most rows against the
    dispatch budget.  Any finding raises.
29. the test harness — (a) ``python -m jepsen_tpu_torch.cli test
    --workload linearizable-register`` in-process (``cli.run_cli``) at the
    reference's smoke: 5 nodes, ``--concurrency 3n`` (15 workers in key
    groups of 5), the CLI's per-key limit of 32, ``--time-limit 10``, the
    in-memory keyed fake client, analysed on the card; it must exit 0,
    valid, every key on the ``gpu`` engine, K1 launched (counters reset
    first); the stored ``test.jtpu`` is loaded again (``store.load``) and
    every key's whole result must equal the plain versions' on that
    history (``batched_linearizable(device="cpu")``).  (b) ``cli analyze``
    on that store must give the same results from the file alone.  (c)
    ``core.run`` of the same workload with a client that crashes before
    every 11th invoke and answers every 97th read stale, under an
    in-process nemesis (``nemesis.validate`` over ``f_map``; start and
    stop every second, no network): at least one key invalid, the
    nemesis ops in the history and in no key's subhistory, and the card's
    per-key results equal the plain versions' key by key.  The lines give
    ops recorded, keys, ops/s, and the analysis, per-key artifact and
    store seconds.
30. real processes — the CLI's ``test --suite localkv --faults
    partition,kill --time-limit 10 --concurrency 6 --rate 40 -o
    interval=2`` (the reference's documented real-cluster run,
    ``doc/example-local-cluster/README.md:13-16``) in-process at the
    CLI's five nodes, the launch counters reset first: five ``repregd``
    replicas compiled from ``native/repregd.cc`` with the host's g++ and
    started under ``start-stop-daemon`` under ``build/``, every peer link
    through a loopback forwarder, partitions and SIGKILLs every 2 s, the
    single-register history checked by ``linearizable(cas_register(0))``
    on the card.  It must exit 0 (valid) with more than 20 ok ops, a
    partition and a kill in the history, a K1 or K4 launch, each node's
    ``server.log`` snarfed into the store naming ``repregd``; the stored
    history re-checked on the card, by the plain versions
    (``device="cpu"``) and by the CPU oracle must give the stored result
    (whole maps; the oracle's shares every key it has); ``cli analyze``
    of the store must give it again.  The line gives the ops, oks, fails,
    infos, the nemesis fs, the history's E, C and V, its engine, kernel
    and escalation rungs, the K1 and K4 launches, and the card's, plain
    and oracle seconds.  Any ``repregd`` left under its directory is
    killed.
31. every in-process workload — the CLI's ``test-all --dummy
    --time-limit 5`` (the reference's documented command,
    ``README.md:595``) in-process at the CLI's defaults: bank, long-fork,
    adya-g2 (its own 2n concurrency), causal, causal-reverse,
    linearizable-register, list-append and rw-register, each against its
    fake client and analysed on the card, the launch counters reset and
    the Elle router's pinned choices cleared first (a fresh process's
    router).  It must exit 0, the store must hold exactly the registry's
    names, every workload's history ok ops (causal excepted: its ops come
    a second apart behind a nemesis that sleeps ten) and every verdict
    valid; one line per workload gives ops, oks, seconds, generator and
    analysis seconds.  rw-register's per-key version graphs must form one
    screened batch (at least ``ELLE_SCREEN_MIN_BATCH`` graphs, none past
    ``DEVICE_SCREEN_MAX_VERTICES``) and launch K6; the stored history
    re-checked with ``screen-route cpu`` (no launch) must give the card's
    anomalies, verdict and transaction count.  list-append's dependency
    graph (its vertex count) is a batch of one and stays on the CPU, as
    the reference routes it (K7's launches are printed).

The last lines are the nvidia-smi line, ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import gc
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from jepsen_tpu_torch import checker as checker_mod
from jepsen_tpu_torch import cli, core, fake
from jepsen_tpu_torch import generator as harness_gen
from jepsen_tpu_torch import nemesis as nemesis_mod
from jepsen_tpu_torch import store as store_mod
from jepsen_tpu_torch import workloads
from jepsen_tpu_torch import elle, independent, models, obs, synth, tune
from jepsen_tpu_torch import platform as platform_mod
from jepsen_tpu_torch.checker import linear
from jepsen_tpu_torch.elle import core as elle_core
from jepsen_tpu_torch.elle import cycles as elle_cycles
from jepsen_tpu_torch.elle import encode as elle_encode
from jepsen_tpu_torch.elle import graph as elle_graph
from jepsen_tpu_torch.elle import rw_register as elle_rw
from jepsen_tpu_torch.engine import decompose, execution, planning
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.lint import kernel_audit
from jepsen_tpu_torch.obs import drift as obs_drift
from jepsen_tpu_torch.obs import export as obs_export
from jepsen_tpu_torch.obs import journal as obs_journal
from jepsen_tpu_torch.obs import profiling
from jepsen_tpu_torch.ops import (_build, cycles, dense, encode,
                                  step_kernels, wgl)
from jepsen_tpu_torch.parallel import mesh as mesh_mod
from jepsen_tpu_torch.ops.step_kernels import (
    F_ACQUIRE, F_CAS, F_DEQUEUE, F_ENQUEUE, F_RACQUIRE, F_READ, F_READ_ANY,
    F_RELEASE, F_RRELEASE, F_WRITE)

#: H100 SXM peak rates the bound is priced against: HBM3 bandwidth
#: (NVIDIA data sheet), and 32-bit integer operations at 132 SMs × 64
#: INT32 lanes × 1.98 GHz boost clock (Hopper architecture white paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

FLAGSHIP_ROWS = 16384
E2E_HISTORIES = 1024
FRONTIER_HISTORIES = 1024
FAMILY_HISTORIES = 1024
DECOMPOSE_HISTORIES, DECOMPOSE_KEYS = 64, 64


#: the script's start, for each line's elapsed seconds
_T0 = time.perf_counter()


def emit(**fields) -> None:
    print(json.dumps({**fields, "elapsed_s": time.perf_counter() - _T0}),
          flush=True)


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


def compare(checker, arrays, work=None):
    """Kernel vs plain version on the same device tensors; returns
    (kernel outputs as numpy, plain seconds, max |kernel - plain|)."""
    kern = checker(*arrays)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = (checker.reference(*arrays) if work is None
             else checker.reference(*arrays, work=work))
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


def kernel_bound(arrays, failed_at, int_ops, table_bytes=0, lane_bytes=6):
    """Least time for the function on these inputs: each input byte the
    run needs read once (a row's events up to its failing one, the
    ``lane_bytes`` of each candidate lane of non-padding events only, and
    ``table_bytes`` of transition tables), each output written once, and
    the integer operations the run's data needs; the larger of the two."""
    ev_slot = arrays[1]
    B, E = ev_slot.shape
    C = arrays[2].shape[2]
    n_ev = np.where(failed_at >= 0, failed_at + 1, E)
    needed = np.arange(E)[None, :] < n_ev[:, None]
    live = needed & (ev_slot >= 0)
    nbytes = (B * (4 + 6) + 4 * int(needed.sum())
              + lane_bytes * C * int(live.sum()) + table_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int_ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def kernel_symbol(fam: str, S: int, C: int) -> str:
    """The mangled-name fragment of the ``dense_automaton.cu`` instance a
    launch of family ``fam`` at (S, C) runs."""
    if dense.design(fam, S, C) == "warp":
        return f"register_warp_kernelILi{max(C - 5, 0)}E"
    return f"dense_block_kernelILi{dense.FAMILY_IDS[fam]}E"


def ptxas_resources(ptxas: str, fragment: str) -> dict:
    """Registers and spill bytes that ptxas reported for the kernel whose
    mangled name holds ``fragment`` (empty when it reported nothing)."""
    for row in kernel_audit.parse_ptxas(ptxas):
        if fragment in row["mangled"]:
            return {"registers": row["regs"],
                    "spill_store_bytes": row["spill_store"],
                    "spill_load_bytes": row["spill_load"]}
    return {}


def design_fields(fam: str, S: int, C: int, ptxas: str) -> dict:
    return {"design": dense.design(fam, S, C),
            **ptxas_resources(ptxas, kernel_symbol(fam, S, C))}


def frontier_design_fields(spec: str, F: int, C: int, ptxas: str) -> dict:
    """The frontier kernel's design at (F, C) with the registers and spill
    bytes ptxas reported for the instance a ``spec`` launch runs."""
    design = wgl.frontier_design(F, C)
    step = step_kernels.STEP_IDS[spec]
    fragment = (f"frontier_warp_kernelILi{step}ELi{wgl.linset_words(C)}E"
                if design == "warp" else f"frontier_search_kernelILi{step}E")
    return {"design": design, **ptxas_resources(ptxas, fragment)}


class RawRegister:
    """The register family's kernel wrapper at ``S`` states with its plain
    version, for shapes no planner gives (S past 32)."""

    def __init__(self, S: int):
        self.S = S

    def __call__(self, *arrays):
        return dense.DENSE_AUTOMATON(*arrays, S=self.S)

    def reference(self, *arrays, work=None):
        return dense.dense_check_reference(*arrays, S=self.S, work=work)


def with_rows(arrays, extra):
    """``arrays`` with the rows of ``extra`` appended."""
    return tuple(np.concatenate([a, x]) for a, x in zip(arrays, extra))


def padding_rows(arrays, n):
    """``n`` all-padding rows shaped like ``arrays``' rows."""
    return tuple(np.full((n,) + a.shape[1:], f, a.dtype)
                 for a, f in zip(arrays, wgl._PAD_FILLS))


def failing_at(arrays, events, f=F_READ, a=32000):
    """Copies of ``arrays``' rows where row i completes, at event
    ``events[i]`` (None: never), slot 0 alone with op code ``f`` and value
    ``a`` (each a number or a per-row array; by default a read of a value
    no register holds, so the row fails there unless it failed before)."""
    init, ev, cs, cf, ca, cb = (x.copy() for x in arrays)
    f, a = (np.broadcast_to(x, (len(init),)) for x in (f, a))
    for i, e in enumerate(events):
        if e is not None:
            ev[i, e] = 0
            cs[i, e, :] = -1
            cs[i, e, 0] = 0
            cf[i, e, 0] = f[i]
            ca[i, e, 0] = a[i]
    return init, ev, cs, cf, ca, cb


def register_edges(flagship, V):
    """(name, arrays, S) of the register family's rows around the warp
    design: row counts that are not a multiple of the histories per warp
    (4 at C = 8, 32 at C = 4), rows that fail at event 0, all-padding
    rows among real ones, read-any codes, and C = 12 on both sides of
    the warp/block switch."""
    init = flagship[0][:9]
    fail0 = failing_at(tuple(a[:9] for a in flagship), [0] * 9, F_READ,
                       np.where(init == 0, 1, 0).astype(np.int16))
    read_any = tuple(a[:64].copy() for a in flagship)
    read_any[3][read_any[2] >= 0] = F_READ_ANY
    s_warp = dense.WARP_MAX_SW // 128
    edges = [
        ("B131-H4", tuple(a[:131] for a in flagship), V),
        ("C4-B45-H32", random_batch("cas-register", 45301, B=45, E=96, C=4,
                                    p_accept=0.98, p_stray=0.0), 8),
        ("fail-at-0", with_rows(fail0, tuple(a[:3] for a in flagship)), V),
        ("all-padding", with_rows(tuple(a[:5] for a in flagship),
                                  padding_rows(flagship, 6)), V),
        ("read-any", read_any, V),
        (f"switch-warp-S{s_warp}",
         random_batch("cas-register", 45302, B=64, E=128, C=12,
                      amax=s_warp - 1, p_accept=0.995, p_stray=0.0), s_warp),
        (f"switch-block-S{s_warp + 1}",
         random_batch("cas-register", 45303, B=64, E=128, C=12,
                      amax=s_warp, p_accept=0.995, p_stray=0.0), s_warp + 1),
    ]
    return edges


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


def graph_ms(run, args, launches=20, reps=7):
    """Median ms a launch takes when ``launches`` of them are captured back
    to back in one CUDA graph and replayed: the device's time, without the
    host's wrapper between the CUDA events of :func:`time_kernel`."""
    run(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            run(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


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
        ("C6-W2", "cas-register", cas,
         [synth.generate_history(rng, n_procs=6, n_ops=300, corrupt=i % 4 == 0)
          for i in range(128)], 6, 6, None),
        ("C7-W4", "cas-register", cas,
         [synth.generate_history(rng, n_procs=7, n_ops=300, corrupt=i % 4 == 0)
          for i in range(128)], 7, 7, None),
    ]


def slice_histories(seed: int, n: int):
    """The frontier slice's histories: ``synth.generate_batch`` with
    writes drawn from 40 values (same generator, same draws per
    history)."""
    rng = random.Random(seed)
    return [synth.generate_history(rng, n_procs=5, n_ops=1000,
                                   crash_p=0.002, n_values=40,
                                   corrupt=rng.random() < 0.25)
            for _ in range(n)]


def crash_heavy_histories(seed: int, n: int):
    """10 processes, crashed processes replaced: C reaches 16."""
    rng = random.Random(seed)
    return [synth.generate_history(rng, n_procs=10, n_ops=200, crash_p=0.03,
                                   replace_crashed=True, corrupt=i % 4 == 0)
            for i in range(n)]


def encoded(hs, slot_cap):
    """One padded batch of the encodable histories, as arrays."""
    b = encode.batch_encode(hs, models.cas_register(0), slot_cap=slot_cap)
    return batch_arrays(b)


#: op codes and value-id bound of each step function's random batch
RANDOM_OPS = {
    "register": ([F_READ, F_WRITE, F_READ_ANY], 6),
    "cas-register": ([F_READ, F_WRITE, F_CAS, F_READ_ANY], 6),
    "mutex": ([F_ACQUIRE, F_RELEASE], 2),
    "reentrant-mutex": ([F_RACQUIRE, F_RRELEASE], 3),
    "multi-register": ([F_READ, F_WRITE, F_READ_ANY], 5),
    "unordered-queue": ([F_ENQUEUE, F_DEQUEUE], 34),
}


def random_batch(spec: str, seed: int, B=128, E=64, C=8, amin=0, amax=None,
                 p_accept=0.95, p_stray=0.1):
    """Random encoded histories of ``spec``: ops open into free slots,
    each event completes one open op — one the step accepts in a
    sequential run with probability ``p_accept``, else any; when the step
    accepts none, any with probability ``p_stray``, else none — and ops
    left open act as crashed ones (the generator of
    tests/test_torch_frontier.py).  ``a`` is drawn from [amin, amax]
    (default: the spec's bound in RANDOM_OPS)."""
    r = np.random.default_rng(seed)
    step = step_kernels.STEPS[spec]
    codes, spec_amax = RANDOM_OPS[spec]
    amax = spec_amax if amax is None else amax
    init = np.zeros((B,), np.int32)
    ev = np.full((B, E), -1, np.int32)
    cs = np.full((B, E, C), -1, np.int8)
    cf = np.zeros((B, E, C), np.int8)
    ca = np.zeros((B, E, C), np.int16)
    cb = np.zeros((B, E, C), np.int16)

    seen = {}

    def run(state, op):
        # the step is pure: one call per distinct (state, op) — set-up on
        # the host, which took most of phase 7's time when every open op
        # of every event paid a tensor call
        key = (state,) + op
        out = seen.get(key)
        if out is None:
            s2, ok = step(*(torch.tensor([x], dtype=dt) for x, dt in zip(
                key, (torch.int32, torch.int8, torch.int16, torch.int16))))
            out = seen[key] = (int(s2[0]), bool(ok[0]))
        return out

    for row in range(B):
        state, open_ops = 0, {}
        for e in range(E):
            free = [c for c in range(C) if c not in open_ops]
            while free and (not open_ops or r.random() < 0.6):
                slot = free.pop(int(r.integers(0, len(free))))
                open_ops[slot] = (int(codes[r.integers(0, len(codes))]),
                                  int(r.integers(amin, amax + 1)),
                                  int(r.integers(0, 4)))
            accepted = [c for c in open_ops if run(state, open_ops[c])[1]]
            if r.random() < 0.1 or not (accepted or r.random() < p_stray):
                continue
            lanes = list(open_ops)
            r.shuffle(lanes)
            for lane, slot in enumerate(lanes):
                cs[row, e, lane] = slot
                cf[row, e, lane], ca[row, e, lane], cb[row, e, lane] = \
                    open_ops[slot]
            pool = accepted if accepted and r.random() < p_accept else lanes
            done = pool[int(r.integers(0, len(pool)))]
            state2, ok = run(state, open_ops.pop(done))
            state = state2 if ok else state
            ev[row, e] = done
    return init, ev, cs, cf, ca, cb


def two_word(arrays, C2=40):
    """The same histories with every slot id moved up by 32 at C2 lanes:
    every linset bit lives in word 1."""
    init, ev, cs, cf, ca, cb = arrays
    B, E, C = cs.shape
    cs2 = np.full((B, E, C2), -1, np.int8)
    cs2[:, :, :C] = np.where(cs >= 0, cs + 32, cs)
    wide = []
    for a in (cf, ca, cb):
        w = np.zeros((B, E, C2), a.dtype)
        w[:, :, :C] = a
        wide.append(w)
    return (init, np.where(ev >= 0, ev + 32, ev).astype(np.int32), cs2,
            *wide)


def fill_rows(F: int, C: int, k: int, E: int = 48, B: int = 8):
    """Cas-register rows whose first closure pass meets the capacity F:
    event 0 opens k ops cas(0 -> i + 1) in slots 0..k-1 and completes slot
    0, so that pass finds 1 + k distinct configs (exactly F at k = F - 1,
    F + 1 at k = F: an overflow) and the next pass none.  The row carries
    on: each later event reuses slot 0 for a write, then a read, of a fresh
    value while the k - 1 other ops stay open (no state is 0 again, so none
    is accepted), and every odd row reads a wrong value at event 4, 8, 12
    or 16, a different one per row."""
    init = np.zeros((B,), np.int32)
    ev = np.zeros((B, E), np.int32)
    cs = np.full((B, E, C), -1, np.int8)
    cf = np.full((B, E, C), F_CAS, np.int8)
    ca = np.zeros((B, E, C), np.int16)
    cb = np.zeros((B, E, C), np.int16)
    cs[:, :, :k] = np.arange(k)
    cb[:, :, :k] = np.arange(1, k + 1)
    for e in range(1, E):
        cf[:, e, 0] = F_WRITE if e % 2 else F_READ
        ca[:, e, 0] = k + 1 + (e - 1) // 2
        cb[:, e, 0] = 0
    for r in range(1, B, 2):
        ca[r, 2 * (r + 1), 0] += 1000
    return init, ev, cs, cf, ca, cb


def frontier_switch_capacity(C: int) -> int:
    """The largest power-of-two capacity that runs the warp design at C."""
    F = 1
    while wgl.frontier_design(2 * F, C) == "warp":
        F *= 2
    return F


def frontier_design_edges(slice_arrays, crash_heavy):
    """(name, spec, arrays, F, max_closure) of the rows around the frontier
    kernel's two designs: both sides of the warp/block switch in F (the
    crash-heavy C = 16 rows) and in C (64 and 65), rows whose first pass
    fills exactly F and F + 1 configs and carry on (on both designs), rows
    of one block finishing at different events with all-padding rows
    beside them, a row count no multiple of the histories a block holds,
    valid rows of 2200 events (past the dedup table's epoch cycle), and
    C = 32 and 33 (one linset word and two)."""
    F_w = frontier_switch_capacity(16)
    C, mc = slice_arrays[2].shape[2], slice_arrays[2].shape[2] + 1
    apart = failing_at(tuple(a[:9] for a in slice_arrays),
                       [0, 1, 2, 5, 17, 40, 100, 300, None])
    return [
        (f"switch-warp-F{F_w}", "cas-register", crash_heavy, F_w, 17),
        (f"switch-block-F{2 * F_w}", "cas-register", crash_heavy, 2 * F_w,
         17),
        ("switch-warp-C64", "cas-register",
         random_batch("cas-register", 45260, B=64, E=64, C=64), 16, 65),
        ("switch-block-C65", "cas-register",
         random_batch("cas-register", 45261, B=64, E=64, C=65), 16, 66),
        ("fill-F", "cas-register", fill_rows(16, 16, 15), 16, 17),
        ("fill-F+1", "cas-register", fill_rows(16, 16, 16), 16, 17),
        ("fill-F-block", "cas-register", fill_rows(64, 65, 63), 64, 66),
        ("fill-F+1-block", "cas-register", fill_rows(64, 65, 64), 64, 66),
        ("finish-apart", "cas-register",
         with_rows(apart, padding_rows(slice_arrays, 3)),
         wgl.DEFAULT_FRONTIER, mc),
        ("B131", "cas-register", tuple(a[:131] for a in slice_arrays),
         wgl.DEFAULT_FRONTIER, mc),
        ("E2200", "cas-register",
         random_batch("cas-register", 45264, B=32, E=2200, p_accept=1.0,
                      p_stray=0.0), 32, 9),
        ("C32", "cas-register",
         random_batch("cas-register", 45262, B=64, E=64, C=32), 16, 33),
        ("C33", "cas-register",
         random_batch("cas-register", 45263, B=64, E=64, C=33), 16, 34),
    ]


def frontier_compare(name, spec, arrays, F, mc, device, work=None):
    """The frontier kernel against its plain version on ``arrays``; emits
    one line and returns (kernel outputs, plain seconds, max error)."""
    B, E, C = arrays[2].shape
    checker = wgl.make_check_fn(spec, E, C, F, mc, device)
    (ok, failed_at, ovf), plain_s, err = compare(
        checker, to_device(arrays, device), work)
    emit(phase="frontier_edge" if name else "frontier", case=name, spec=spec,
         rows=int(B), E=int(E), C=int(C), F=F, max_closure=mc,
         design=wgl.frontier_design(F, int(C)),
         invalid=int((~ok).sum()), overflowed=int(ovf.sum()),
         max_abs_err=err, plain_s=plain_s, tolerance="exact (byte-equal)")
    return (ok, failed_at, ovf), plain_s, err


#: rows of the C16 escalation rung that phase 7 holds against the plain
#: version (the kernel runs on all of them)
RUNG_COMPARED_ROWS = 8


def rung_outcome(ok, ovf) -> np.ndarray:
    """Per row: "overflow", "valid" or "invalid"."""
    return np.where(ovf, "overflow", np.where(ok, "valid", "invalid"))


def rung_subset_compare(name, arrays, overflow, F, mc, device):
    """The first escalation rung's shape: the kernel on every overflowed
    row of ``arrays`` (padded as ``escalate_overflows`` pads them), and
    against its plain version on a fixed subset of them — the first row
    of every outcome the kernel gave the full set, then the first rows in
    order up to :data:`RUNG_COMPARED_ROWS` — padded the same way.  The
    subset's kernel outputs must equal the full run's on its rows.
    Returns the max error."""
    bad, full = wgl.overflow_rows(arrays, overflow)
    B, E, C = full[2].shape
    checker = wgl.make_check_fn("cas-register", E, C, F, mc, device)
    f_ok, f_failed, f_ovf = (x.cpu().numpy()
                             for x in checker(*to_device(full, device)))
    outcomes = rung_outcome(f_ok, f_ovf)[:len(bad)]
    pick = {int(np.argmax(outcomes == o)) for o in set(outcomes)}
    for i in range(len(bad)):
        if len(pick) >= RUNG_COMPARED_ROWS:
            break
        pick.add(i)
    pick = sorted(pick)
    mask = np.zeros(len(overflow), bool)
    mask[bad[pick]] = True
    sub_bad, sub = wgl.overflow_rows(arrays, mask)
    require(list(sub_bad) == list(bad[pick]), "subset rows out of order")
    (ok, failed_at, ovf), plain_s, err = compare(checker,
                                                 to_device(sub, device))
    n = len(pick)
    for what, k, f in (("ok", ok, f_ok), ("failed_at", failed_at, f_failed),
                       ("overflow", ovf, f_ovf)):
        require((k[:n] == f[pick]).all(), f"{name}: the subset's {what} "
                "differs from the full run's on the same rows")
    sub_outcomes = rung_outcome(ok[:n], ovf[:n])
    require(set(sub_outcomes) == set(outcomes),
            f"{name}: the subset lacks an outcome of the full set")
    emit(phase="frontier_edge", case=name, spec="cas-register", rows=int(B),
         compared_rows=int(sub[0].shape[0]), E=int(E), C=int(C), F=F,
         max_closure=mc, design=wgl.frontier_design(F, int(C)),
         outcomes={o: int((outcomes == o).sum()) for o in set(outcomes)},
         compared_outcomes={o: int((sub_outcomes == o).sum())
                            for o in set(sub_outcomes)},
         invalid=int((~f_ok[:len(bad)]).sum()),
         overflowed=int(f_ovf[:len(bad)].sum()), max_abs_err=err,
         plain_s=plain_s, tolerance="exact (byte-equal)")
    return err


# ---------------------------------------------------------------------------
# the lock, permit and multi-register families (phases 10-14)
# ---------------------------------------------------------------------------


def lock_histories(seed: int, n: int, n_procs=10, n_ops=1000,
                   reentrant=False):
    rng = random.Random(seed)
    return [synth.generate_lock_history(rng, n_procs=n_procs, n_ops=n_ops,
                                        reentrant=reentrant,
                                        corrupt=i % 4 == 0)
            for i in range(n)]


def permit_histories(seed: int, n: int, n_procs=10, n_ops=1000):
    rng = random.Random(seed)
    return [synth.generate_permits_history(rng, n_procs=n_procs,
                                           n_ops=n_ops, n_permits=2,
                                           corrupt=i % 4 == 0)
            for i in range(n)]


def mr_histories(seed: int, n: int, n_keys: int, n_values: int,
                 n_procs=8, n_ops=1000, crash_p=0.002, corrupt=True):
    rng = random.Random(seed)
    return [synth.generate_mr_history(rng, n_procs=n_procs, n_ops=n_ops,
                                      n_keys=n_keys, n_values=n_values,
                                      crash_p=crash_p,
                                      corrupt=corrupt and i % 4 == 0)
            for i in range(n)]


def flip_one_read(h):
    """A copy of a 0/1-valued multi-register history with one completed
    read's value flipped (an invalid history that keeps the value
    domain)."""
    h = type(h)(op.copy() for op in h)
    for i, op in enumerate(h):
        if op.type == "ok" and op.value and op.value[0][0] == "r":
            _, k, v = op.value[0]
            h[i] = op.copy(value=[("r", k, 1 - v)])
            break
    return h


def family_batch(model, hs, device, slot_cap=32):
    """The histories as one encoded batch and the plan the engine gives
    it; the plan must be the dense automaton."""
    b = encode.batch_encode(hs, model, slot_cap=slot_cap)
    require(not b.fallback, f"{len(b.fallback)} histories did not encode")
    arrays = batch_arrays(b)
    plan = wgl.plan_bucket(model, step_kernels.spec_for(model), arrays,
                           device=device)
    require(plan.kernel == "dense",
            f"{type(model).__name__} batch routed to {plan.kernel}")
    return arrays, plan


def decomposed_batch(model, hs, device):
    """bench.py's decomposition headline as the engine splits it: every
    history's per-key sub-histories, encoded against their seeded
    sub-models, in one batch; (arrays, plan, sub-histories, sub-models)."""
    subs, encs = [], []
    for h in hs:
        for _key, sub, subh in decompose.split_history(model, h):
            e = encode.encode_history(subh, sub, 32)
            require(e is not None, "a sub-history did not encode")
            subs.append((sub, subh))
            encs.append(e)
    E = encode.round_up(max(e.ev_slot.shape[0] for e in encs))
    C = encode.round_up(max(e.max_open for e in encs), 4)
    b = encode.stack_encoded(encs, list(range(len(encs))), E, C)
    arrays = batch_arrays(b)
    plan = wgl.plan_bucket(subs[0][0], step_kernels.spec_for(subs[0][0]),
                           arrays, device=device)
    require(plan.kernel == "dense", f"sub-histories routed to {plan.kernel}")
    return arrays, plan, subs


def family_compare(name, checker, arrays, device, phase="family"):
    """A family's kernel against its plain version on every row of
    ``arrays``; emits one line and returns (failed_at, plain seconds,
    max error, integer operations)."""
    B, E, C = arrays[2].shape
    work: dict = {}
    (ok, failed_at, _), plain_s, err = compare(
        checker, to_device(arrays, device), work)
    emit(phase=phase, case=name, spec=checker.spec_name,
         family=checker.family, rows=int(B), E=int(E), C=int(C),
         V=str(checker.V), S=checker.S, compared_rows=int(B),
         invalid=int((~ok).sum()), max_abs_err=err, plain_s=plain_s,
         tolerance="exact (byte-equal)")
    return failed_at, plain_s, err, work["int_ops"]


def reset_dense_launches() -> None:
    for k in dense.DENSE_KERNELS.values():
        k.launches = 0


def family_end_to_end(name, fam, model, hs, extra, card, pick,
                      decomposed=True, oracle_sample=24):
    """``check_batch`` on ``hs`` plus ``extra`` (histories past the dense
    envelope, which the oracle must take), dense launch counters reset
    around it; device verdicts held against the CPU oracle on a sample.
    Returns (results, launches of ``fam``, seconds)."""
    allh = hs + extra
    reset_dense_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = wgl.check_batch(model, allh, decomposed=decomposed)
    seconds = time.perf_counter() - t0
    launches = {f: k.launches for f, k in dense.DENSE_KERNELS.items()}
    require(launches[fam] > 0,
            f"{name}: check_batch never launched the {fam} kernel")
    stats = wgl.batch_stats(results)
    for i in range(len(hs), len(allh)):
        require(str(results[i]["engine"]).startswith("oracle"),
                f"{name}: history {i} past the envelope ran on "
                f"{results[i]['engine']}")
    on_device = [i for i, r in enumerate(results) if r["engine"] == "gpu"]
    require(on_device, f"{name}: no history was decided on the card")
    invalid = [i for i in on_device if results[i]["valid?"] is False]
    sample = sorted(set(invalid[:oracle_sample // 4]) | set(pick.choice(
        on_device, min(oracle_sample, len(on_device)),
        replace=False).tolist()))
    for i in sample:
        r = linear.analysis(model, allh[i])
        require(r["valid?"] == results[i]["valid?"],
                f"{name} history {i}: device says {results[i]['valid?']}, "
                f"oracle says {r['valid?']}")
    emit(phase="family_end_to_end", case=name, histories=len(allh),
         decomposed=decomposed, seconds=seconds,
         histories_per_s=len(allh) / seconds, launches=launches,
         oracle_sample=len(sample), batch_stats=stats, card=card)
    return results, launches[fam], seconds


def same_verdicts(a, b) -> bool:
    return [r["valid?"] for r in a] == [r["valid?"] for r in b]


def family_phases(device, card, pick, ptxas=""):
    """Phases 10-14; returns the ``{"kernels": [...]}`` entries of the
    reentrant-mutex, acquired-permits and multi-register families, and
    the register family's largest error on the owner-mutex batch.
    ``ptxas`` is the build's report (registers and spills per kernel)."""
    n = FAMILY_HISTORIES
    lock_cases = [
        ("reentrant-cp-lock", "reentrant-mutex", models.reentrant_mutex(),
         lock_histories(46100, n, reentrant=True),
         lock_histories(46110, 4, n_procs=15, n_ops=200, reentrant=True)),
        ("non-reentrant-cp-lock", "register", models.owner_mutex(),
         lock_histories(46200, n),
         lock_histories(46210, 4, n_procs=15, n_ops=200)),
        ("semaphore", "acquired-permits", models.acquired_permits(2),
         permit_histories(46300, n),
         permit_histories(46310, 4, n_procs=15, n_ops=200)),
    ]
    mr_model = models.multi_register({0: 0, 1: 0})
    mr_hs = mr_histories(46400, n, n_keys=2, n_values=8)
    wide_model = models.multi_register(
        {k: 0 for k in range(DECOMPOSE_KEYS)})
    wide_hs = mr_histories(45100, DECOMPOSE_HISTORIES,
                           n_keys=DECOMPOSE_KEYS, n_values=4)

    # -- 10/11. each family against its plain version at full width ------
    measured = {}
    for name, fam, model, hs, _extra in lock_cases:
        arrays, plan = family_batch(model, hs, device)
        measured[name] = (arrays, plan.fn) + family_compare(
            name, plan.fn, arrays, device)
    arrays, plan = family_batch(mr_model, mr_hs, device)
    require(plan.n_values == (11, 2),
            f"multi-register shape {plan.n_values}, not (11, 2)")
    measured["multi-register"] = (arrays, plan.fn) + family_compare(
        "multi-register", plan.fn, arrays, device)
    d_arrays, d_plan, subs = decomposed_batch(wide_model, wide_hs, device)
    require(d_plan.n_values[1] == 1, "decomposed sub-histories have K > 1")
    _, _, d_err, _ = family_compare("multi-register-decomposed", d_plan.fn,
                                    d_arrays, device)
    errs = {"reentrant-mutex": 0, "acquired-permits": 0,
            "multi-register": d_err}

    # -- 12. the largest shapes the planner gives at C = 12 ---------------
    k1 = [e for e in (encode.encode_history(h, models.multi_register({0: 0}),
                                            12)
                      for h in mr_histories(46500, 64, n_keys=1,
                                            n_values=126, n_procs=10,
                                            n_ops=250, crash_p=0.005))
          if e is not None]
    k4_model = models.multi_register({k: 0 for k in range(4)})
    k4_hs = [flip_one_read(h) if i % 4 == 0 else h for i, h in enumerate(
        mr_histories(46600, 64, n_keys=4, n_values=1, n_procs=10,
                     n_ops=250, crash_p=0.005, corrupt=False))]
    k4 = [e for e in (encode.encode_history(h, k4_model, 12) for h in k4_hs)
          if e is not None]
    edges = []
    for name, encs, shape in (("K1m-Vr128-K1", k1, (128, 1)),
                              ("K1m-Vr3-K4", k4, (3, 4))):
        E = encode.round_up(max(e.ev_slot.shape[0] for e in encs))
        eb = batch_arrays(encode.stack_encoded(encs, list(range(len(encs))),
                                               E, 12))
        probe = dense.mr_shape_probe(eb[0], eb[4], eb[5])
        require(probe[0] <= shape[0] and probe[1] <= shape[1],
                f"{name}: shape {probe} exceeds {shape}")
        edges.append((name, "multi-register", eb, shape))
    r_edge = random_batch("reentrant-mutex", 46700, B=128, E=256, C=12,
                          amin=1, amax=15, p_accept=0.99, p_stray=0.0)
    r_dom = encode.round_up(wgl.value_domain("reentrant-mutex", r_edge[0],
                                             r_edge[4], r_edge[5]), 4)
    require(r_dom == 32, f"reentrant edge domain {r_dom}, not 32")
    # rows that fail at event 0 (a release of a free lock) and all-padding
    # rows ride with the reentrant edge
    r_edge = with_rows(with_rows(r_edge, failing_at(
        tuple(a[:4] for a in r_edge), [0] * 4, F_RRELEASE, 1)),
        padding_rows(r_edge, 5))
    edges.append(("K1r-V32", "reentrant-mutex", r_edge, 32))
    for name, spec, eb, shape in edges:
        checker = dense.make_dense_fn(spec, eb[1].shape[1], 12, shape,
                                      device)
        e_failed, _, e_err, _ = family_compare(name, checker, eb, device,
                                               phase="family_edge")
        errs[spec] = max(errs[spec], e_err)
        if name == "K1r-V32":
            require((e_failed[128:132] == 0).all(),
                    "K1r rows did not fail at event 0")
    # the largest permit shape the planner gives at C = 12: all twelve
    # clients, (N, P) = (12, 2), S = 91
    p_arrays, p_plan = family_batch(models.acquired_permits(2),
                                    permit_histories(46800, 64, n_procs=12,
                                                     n_ops=300), device)
    require(p_plan.n_values == (12, 2) and p_arrays[2].shape[2] == 12,
            f"permit edge shape {p_plan.n_values}, C={p_arrays[2].shape[2]}")
    _, _, e_err, _ = family_compare("K1p-N12-P2", p_plan.fn, p_arrays,
                                    device, phase="family_edge")
    errs["acquired-permits"] = max(errs["acquired-permits"], e_err)

    # -- 13. end to end through check_batch -------------------------------
    e2e = {}
    for name, fam, model, hs, extra in lock_cases:
        _, launches, seconds = family_end_to_end(name, fam, model, hs, extra,
                                                 card, pick)
        e2e[name] = (launches, (len(hs) + len(extra)) / seconds)
    mr_res, mr_launches, mr_s = family_end_to_end(
        "multi-register", "multi-register", mr_model, mr_hs, [], card, pick,
        decomposed=False)
    mr_dec = wgl.check_batch(mr_model, mr_hs)
    require(same_verdicts(mr_res, mr_dec),
            "multi-register: decomposed and undecomposed verdicts differ")
    w_res, w_launches, w_s = family_end_to_end(
        "multi-register-decomposed", "multi-register", wide_model, wide_hs,
        [], card, pick)
    w_whole = wgl.check_batch(wide_model, wide_hs, decomposed=False)
    require(same_verdicts(w_res, w_whole),
            "64-key batch: decomposed and undecomposed verdicts differ")
    require(all(r["engine"] == "oracle-fallback" for r in w_whole),
            "undecomposed 64-key histories should not encode")
    emit(phase="decomposition", histories=len(wide_hs),
         sub_histories=len(subs),
         decomposed_histories_per_s=len(wide_hs) / w_s,
         verdicts_agree=True, composite_verdicts_agree=True, card=card)
    e2e["multi-register"] = (mr_launches + w_launches,
                             len(mr_hs) / mr_s)

    # -- 14. times ----------------------------------------------------------
    entries = []
    for name, fam, replaces in (
            ("reentrant-cp-lock", "reentrant-mutex",
             "jepsen_tpu/ops/dense.py:516"),
            ("semaphore", "acquired-permits", "jepsen_tpu/ops/dense.py:506"),
            ("multi-register", "multi-register",
             "jepsen_tpu/ops/dense.py:471"),
            ("non-reentrant-cp-lock", "register", None)):
        arrays, checker, failed_at, plain_s, err, int_ops = measured[name]
        ms, all_ms = time_kernel(checker, to_device(arrays, device))
        tables = (2 * 4 * checker.pm_acq.numel()
                  if fam == "acquired-permits" else 0)
        bound_ms, bound_by, nbytes = kernel_bound(arrays, failed_at, int_ops,
                                                  tables)
        launches, e2e_rate = e2e[name]
        B, E, C = arrays[2].shape
        emit(phase="family_times", case=name, kernel=dense.DENSE_KERNELS[
            fam].name, rows=int(B), E=int(E), C=int(C), V=str(checker.V),
             S=checker.S, **design_fields(fam, checker.S, C, ptxas),
             ms=ms, runs_ms=all_ms, bound_ms=bound_ms,
             bound_by=bound_by, bytes=nbytes, int_ops=int_ops,
             plain_ms=plain_s * 1e3, e2e_histories_per_s=e2e_rate,
             launches=launches, library_ms=None,
             library="no single PyTorch call computes the dense automaton",
             card=card)
        if replaces is None:
            continue
        entries.append({
            "name": dense.DENSE_KERNELS[fam].name,
            "route": "cuda",
            "source": "jepsen_tpu_torch/ops/csrc/dense_automaton.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(err, errs[fam]),
            "ms": ms,
            "plain_ms": plain_s * 1e3,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    return entries, measured["non-reentrant-cp-lock"][4]


# ---------------------------------------------------------------------------
# the Elle screens (phases 15-17)
# ---------------------------------------------------------------------------

#: bench.py:1282's accelerator shape: histories × transactions × keys
ELLE_HISTORIES, ELLE_TXNS, ELLE_KEYS = 64, 400, 32
ELLE_STACK_ROWS = 1024
#: the list-append strict-serializable profile at its bucket
ELLE_N, ELLE_MASKS, ELLE_NONADJ = 512, (1, 3, 7, 25, 27, 31), ((4, 3),
                                                               (4, 27))
HAS_CYCLE_SIZES = (32, 64, 128, 256, 512, 1024)
#: rows of the all-zero edge batches
ELLE_EDGE_ROWS = 64


def elle_histories(mode: str, seed: int):
    """64 × 400-txn histories over 32 active keys from the port's synth,
    the injected G1c in every 4th."""
    return synth.generate_txn_batch(seed, ELLE_HISTORIES, mode,
                                    n_txns=ELLE_TXNS, key_count=ELLE_KEYS)


def version_graph_stack(hs):
    """The rw-register per-key version graphs of ``hs`` (serializable: no
    realtime order), padded as has_cycle_batch pads them: (B, 16, 16)."""
    mats = []
    for h in hs:
        graphs, _ = elle_rw.version_graphs(elle_core.transactions(h), (),
                                           use_device=False)
        mats += [g.adjacency()[1] for g in graphs.values()]
    n = cycles._bucket(max(m.shape[0] for m in mats))
    require(n == 16, f"version graphs bucket at n={n}, not 16")
    stack = np.zeros((len(mats), n, n), np.uint8)
    for i, m in enumerate(mats):
        stack[i, :m.shape[0], :m.shape[1]] = m
    return stack


def list_append_stack(hs):
    """The list-append strict-serializable graphs of ``hs`` at their
    bucket, tiled to :data:`ELLE_STACK_ROWS`; every graph must share one
    profile."""
    opts = {"workload": "list-append",
            "consistency-models": ["strict-serializable"]}
    encs = [elle_encode.encode_graph(elle.list_append.prepare(h, opts)[0])
            for h in hs]
    keys = {elle_encode.bucket_key(e) for e in encs}
    require(keys == {(ELLE_N, ELLE_MASKS, ELLE_NONADJ)},
            f"list-append profiles {sorted(keys)}")
    rel = elle_encode.stack_rel(encs, ELLE_N)
    reps = -(-ELLE_STACK_ROWS // len(encs))
    return (np.concatenate([rel] * reps)[:ELLE_STACK_ROWS],
            max(e.n for e in encs))


def cycles_compare(case, kernel, plain, x, **fields):
    """A cycles kernel against its plain version on the same device
    tensor; every output byte-equal.  Emits one line and returns (plain
    seconds, max error, the plain version's operation count)."""
    kern = kernel(x)
    torch.cuda.synchronize()
    work: dict = {}
    t0 = time.perf_counter()
    ref = plain(x, work)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = 0
    for i, (k, p) in enumerate(zip(kern, ref)):
        k, p = k.cpu().numpy(), p.cpu().numpy()
        require(k.dtype == p.dtype and k.shape == p.shape
                and k.tobytes() == p.tobytes(),
                f"{case}: kernel and plain version differ in output {i}")
        err = max(err, int(np.abs(k.astype(np.int64) - p.astype(
            np.int64)).max(initial=0)))
    emit(phase="elle_kernel", case=case, rows=int(x.shape[0]),
         n=int(x.shape[-1]), max_abs_err=err, plain_s=plain_s,
         rounds=int(kern[-1][0]) if len(kern[-1]) else None,
         tolerance="exact (byte-equal)", **fields)
    return plain_s, err, work.get("int_ops", 0)


def has_cycle_pair(mode):
    return (lambda x: cycles.HAS_CYCLE(x, mode),
            lambda x, work: cycles.has_cycle_reference(x, mode, work))


def screen_pair(mode, masks=ELLE_MASKS, nonadj=ELLE_NONADJ):
    return (lambda x: cycles.SCREEN(x, masks, nonadj, mode),
            lambda x, work: cycles.screen_reference(x, masks, nonadj, mode,
                                                    work))


def ring_relation(n, rows, pattern=(1, 1 | 4)):
    """Row 0: a ring through all n vertices whose edge i carries
    ``pattern[i % len(pattern)]`` (by default every edge ww and every
    other one also rw: nonadjacent rw edges, so each vertex with an rw
    out-edge has a walk); the other rows are all-zero."""
    rel = np.zeros((rows, n, n), np.uint8)
    for i in range(n):
        rel[0, i, (i + 1) % n] = pattern[i % len(pattern)]
    return rel


def graph_of_512(seed):
    """A dependency graph of exactly 512 vertices: a realtime chain through
    all of them and random ww/wr/rw/process edges."""
    rng = np.random.default_rng(seed)
    g = elle_graph.Graph()
    for v in range(511):
        g.add_edge(v, v + 1, elle_graph.REALTIME)
    rels = (elle_graph.WW, elle_graph.WR, elle_graph.RW, elle_graph.PROCESS)
    for _ in range(1500):
        a, b = (int(x) for x in rng.integers(0, 512, size=2))
        g.add_edge(a, b, rels[int(rng.integers(0, 4))])
    enc = elle_encode.encode_graph(g)
    require(enc.n == 512 and elle_encode.graph_bucket(enc.n) == 512,
            "the 512-vertex graph does not fill its bucket")
    return enc


def library_ladder(planes, R):
    """The reference's uint8 arithmetic as PyTorch calls: R rounds of
    r ← min(1, r + r·r), one bf16 torch.bmm each."""
    r = planes.to(torch.bfloat16)
    for _ in range(R):
        r = torch.clamp(r + torch.bmm(r, r), max=1.0)
    return r > 0


def library_has_cycle(adj):
    n = adj.shape[-1]
    c = library_ladder(adj > 0, cycles.closure_rounds(n))
    return c.diagonal(dim1=-2, dim2=-1).any(-1)


def library_screen(rel, masks=ELLE_MASKS, nonadj=ELLE_NONADJ):
    B, n = rel.shape[0], rel.shape[-1]
    marr = torch.tensor(masks, dtype=torch.uint8, device=rel.device)
    planes = ((rel[:, None] & marr[None, :, None, None]) > 0).reshape(
        B * len(masks), n, n)
    c = library_ladder(planes, cycles.closure_rounds(n)).reshape(
        B, len(masks), n, n)
    members = (c & c.transpose(-1, -2)).any(-1)
    del c, planes
    lift = torch.stack([cycles.lifted(rel, w, r) for w, r in nonadj], 1)
    c = library_ladder(lift.reshape(B * len(nonadj), 2 * n, 2 * n),
                       cycles.closure_rounds(2 * n)).reshape(
        B, len(nonadj), 2 * n, 2 * n)
    aw = torch.stack([(rel & w) > 0 for w, _ in nonadj], 1)
    walks = (aw & c[:, :, n:, :n].transpose(-1, -2)).any(-1)
    return members, walks


def cycles_bound(nbytes, int_ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int_ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def elle_end_to_end(name, workload, models, hs, card):
    """``elle.check_batch`` with screen-route "device", both kernels'
    launch counters reset just before and read just after; its results
    must equal the "cpu" route's and the "auto" route's (whose first call
    at each bucket calibrates on the card), and exactly the histories with
    the injected G1c must be invalid.  Returns (launches, seconds)."""
    opts = {"workload": workload, "consistency-models": models}
    mod = elle._workload_module(opts)
    graphs = [mod.prepare(h, {**opts, "screen-route": "cpu"})[0] for h in hs]
    screenable = sum(2 <= len(g.vertices)
                     <= elle_cycles.DEVICE_SCREEN_MAX_VERTICES
                     for g in graphs)
    cycles.HAS_CYCLE.launches = cycles.SCREEN.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = elle.check_batch({**opts, "screen-route": "device"}, hs)
    dev_s = time.perf_counter() - t0
    launches = {"has_cycle": cycles.HAS_CYCLE.launches,
                "screen": cycles.SCREEN.launches}
    t0 = time.perf_counter()
    cpu = elle.check_batch({**opts, "screen-route": "cpu"}, hs)
    cpu_s = time.perf_counter() - t0
    require(json.dumps(dev, sort_keys=True, default=repr)
            == json.dumps(cpu, sort_keys=True, default=repr),
            f"{name}: device and cpu routes differ")
    elle_cycles._SCREEN_CHOICE.clear()
    elle_cycles._CLASSIFY_CHOICE.clear()
    auto = elle.check_batch(opts, hs)
    require(json.dumps(auto, sort_keys=True, default=repr)
            == json.dumps(cpu, sort_keys=True, default=repr),
            f"{name}: auto and cpu routes differ")
    valid = [r["valid?"] for r in dev]
    require(valid == [i % 4 != 0 for i in range(len(hs))],
            f"{name}: verdicts {valid} are not the injected G1c pattern")
    emit(phase="elle_end_to_end", case=name, histories=len(hs),
         txns=ELLE_TXNS, keys=ELLE_KEYS, device_s=dev_s, cpu_s=cpu_s,
         device_histories_per_s=len(hs) / dev_s,
         cpu_histories_per_s=len(hs) / cpu_s, launches=launches,
         route_counts={"screened": screenable,
                       "cpu": len(graphs) - screenable},
         auto_choices={"classify": {str(k): v for k, v in
                                    elle_cycles._CLASSIFY_CHOICE.items()},
                       "version_screen": {str(k): v for k, v in
                                          elle_cycles._SCREEN_CHOICE.items()}},
         invalid=valid.count(False), card=card)
    return launches, dev_s


def want_into_dead_ends(n, rows, seed):
    """Random relations (2/n, every Elle bit) in which a third of the
    vertices keep only rw out-edges, and rw edges lead into them: walks
    whose first want hop lands where no rest edge leaves."""
    rng = np.random.default_rng(seed)
    rel = (rng.choice([1, 2, 4, 8, 16, 5, 6, 17], size=(rows, n, n))
           * (rng.random((rows, n, n)) < 2.0 / n)).astype(np.uint8)
    dead = rng.random((rows, n)) < 1 / 3
    rel[dead] &= np.uint8(4)
    into = (rng.random((rows, n, n)) < 2.0 / n) & dead[:, None, :]
    rel[into] |= np.uint8(4)
    return rel


def cycles_kernels(kind, mode, n):
    """Mangled-name fragments of the ``cycles_closure.cu`` kernels a
    launch runs (ptxas reports registers and spills under them)."""
    if kind == "has_cycle":
        return [{"warp": f"has_cycle_warp_kernelILi{n}E",
                 "double": f"has_cycle_double_kernelILi{n // 32}E",
                 "single": "has_cycle_kernelILi32E"}[
                     cycles.has_cycle_design(n)]]
    out = [f"screen_kernelILi{n // 32}E"]
    if cycles.screen_design(mode, n) == "lifted":
        out.append(f"screen_lifted_kernelILi{n // 16}E")
    return out


def cycles_design(kind, mode, n):
    if kind == "has_cycle":
        return cycles.has_cycle_design(n)
    return {"filter": "double", "walks": cycles.screen_design(mode, n)}


def elle_kernel_phase(device, la_hs, rw_hs):
    """Phase 15: both entry points against their plain versions, both
    modes, at the corpus stacks, random stacks and edge rows.  Returns
    (version-graph stack, list-append stack, has-cycle max error, screen
    max error, the screen's plain seconds and squaring count by mode)."""
    vg = version_graph_stack(rw_hs)
    vg_dev = torch.from_numpy(vg).to(device)
    hc_err = 0
    for mode in ("fixed", "earlyexit"):
        _, err, _ = cycles_compare("version-graphs", *has_cycle_pair(mode),
                                   vg_dev, entry="has_cycle", mode=mode,
                                   design=cycles_design("has_cycle", mode, 16))
        hc_err = max(hc_err, err)
    rng = np.random.default_rng(47300)
    for n in HAS_CYCLE_SIZES:
        rows = 256 if n <= 256 else 64
        dens = rng.choice([0.5, 1.0, 1.5, 4.0], size=rows) / n
        adj = (rng.random((rows, n, n)) < dens[:, None, None]).astype(
            np.uint8)
        for mode in ("fixed", "earlyexit"):
            _, err, _ = cycles_compare(f"random-n{n}", *has_cycle_pair(mode),
                                       torch.from_numpy(adj).to(device),
                                       entry="has_cycle", mode=mode,
                                       design=cycles_design("has_cycle", mode,
                                                            n))
            hc_err = max(hc_err, err)
    rel_np, n_max = list_append_stack(la_hs)
    rel = torch.from_numpy(rel_np).to(device)
    sc_err, sc_plain = 0, {}
    for mode in ("fixed", "earlyexit"):
        plain_s, err, ops = cycles_compare(
            "list-append-1024", *screen_pair(mode), rel, entry="screen",
            mode=mode, largest_graph=n_max,
            design=cycles_design("screen", mode, ELLE_N))
        sc_plain[mode] = (plain_s, ops)
        sc_err = max(sc_err, err)
    small = np.random.default_rng(47410)
    edge_cases = [
        ("screen", "ring-512", torch.from_numpy(ring_relation(512, 8))),
        # want, rest, want, rest ...: each walk takes 256 want→rest hops
        ("screen", "ring-many-hops-512",
         torch.from_numpy(ring_relation(512, 8, (4, 2, 4, 1)))),
        ("screen", "want-into-dead-ends-512",
         torch.from_numpy(want_into_dead_ends(512, 16, 47420))),
        ("screen", "smallest-n32", torch.from_numpy(
            (small.integers(0, 32, size=(ELLE_EDGE_ROWS, 32, 32))
             * (small.random((ELLE_EDGE_ROWS, 32, 32)) < 3.0 / 32)
             ).astype(np.uint8))),
        ("screen", "zeros-512", torch.zeros((ELLE_EDGE_ROWS, 512, 512),
                                            dtype=torch.uint8)),
        ("screen", "graph-of-512", torch.from_numpy(elle_encode.stack_rel(
            [graph_of_512(47400 + i) for i in range(4)], 512))),
        ("has_cycle", "ring-512", torch.from_numpy(
            (ring_relation(512, 8) > 0).astype(np.uint8))),
        ("has_cycle", "ring-1024", torch.from_numpy(
            (ring_relation(1024, 4) > 0).astype(np.uint8))),
        ("has_cycle", "zeros-W1-n16", torch.zeros((ELLE_EDGE_ROWS, 16, 16),
                                                  dtype=torch.uint8)),
        # an odd count of n = 16 graphs: the last warp holds one plane
        ("has_cycle", "version-graphs-1023", torch.from_numpy(
            vg[np.arange(1023) % len(vg)])),
        # both sides of the warp/shared switch
        ("has_cycle", "ring-32", torch.from_numpy(
            (ring_relation(32, 8) > 0).astype(np.uint8))),
        ("has_cycle", "ring-64", torch.from_numpy(
            (ring_relation(64, 8) > 0).astype(np.uint8))),
    ]
    for kind, case, x in edge_cases:
        for mode in ("fixed", "earlyexit"):
            pair = screen_pair(mode) if kind == "screen" else \
                has_cycle_pair(mode)
            _, err, _ = cycles_compare(
                case, *pair, x.to(device), entry=kind, mode=mode,
                design=cycles_design(kind, mode, int(x.shape[-1])))
            if kind == "screen":
                sc_err = max(sc_err, err)
            else:
                hc_err = max(hc_err, err)
    return vg, rel, hc_err, sc_err, sc_plain


def elle_phases(device, card, ptxas=""):
    """Phases 15-17; returns the ``{"kernels": [...]}`` entries of the
    has-cycle and screen kernels, and the list-append corpus."""
    la_hs = elle_histories("append", 47100)
    rw_hs = elle_histories("wr", 47200)

    # -- 15. kernels against their plain versions -----------------------
    vg, rel, hc_err, sc_err, sc_plain = elle_kernel_phase(device, la_hs,
                                                          rw_hs)

    # -- 16. end to end through elle.check_batch -------------------------
    la_launches, la_s = elle_end_to_end(
        "list-append", "list-append", ["strict-serializable"], la_hs, card)
    require(la_launches["screen"] > 0,
            "list-append: check_batch never launched the screen kernel")
    rw_launches, rw_s = elle_end_to_end(
        "rw-register", "rw-register", ["serializable"], rw_hs, card)
    require(rw_launches["has_cycle"] > 0,
            "rw-register: check_batch never launched the has-cycle kernel")

    # -- 17. times at the 1024-row stacks --------------------------------
    vg_rows = vg[np.arange(ELLE_STACK_ROWS) % len(vg)]
    vg_t = torch.from_numpy(vg_rows).to(device)
    hc_work: dict = {}
    t0 = time.perf_counter()
    cycles.has_cycle_reference(vg_t, "fixed", hc_work)
    torch.cuda.synchronize()
    hc_plain_s = time.perf_counter() - t0
    hc_ms, hc_all = time_kernel(cycles.HAS_CYCLE, (vg_t,))
    hc_device_ms = graph_ms(cycles.HAS_CYCLE, (vg_t,))
    hc_lib_ms, _ = time_kernel(library_has_cycle, (vg_t,))
    require(np.array_equal(library_has_cycle(vg_t).cpu().numpy(),
                           cycles.HAS_CYCLE(vg_t)[0].cpu().numpy()),
            "the bmm ladder disagrees with the has-cycle kernel")
    B, n = vg_rows.shape[0], vg_rows.shape[-1]
    hc_bytes = B * n * n + B + 4 * B
    # the warp design runs full Jacobi rounds: its count is the squaring's
    hc_bound, hc_by = cycles_bound(hc_bytes, hc_work["int_ops"])
    sc_ms, sc_all = time_kernel(
        lambda t: cycles.SCREEN(t, ELLE_MASKS, ELLE_NONADJ), (rel,))
    sc_device_ms = graph_ms(
        lambda t: cycles.SCREEN(t, ELLE_MASKS, ELLE_NONADJ), (rel,),
        launches=5)
    sc_lib_ms, _ = time_kernel(library_screen, (rel,), reps=3, warmup=1)
    lib_m, lib_w = library_screen(rel)
    k_m, k_w, k_r = cycles.SCREEN(rel, ELLE_MASKS, ELLE_NONADJ)
    require(torch.equal(lib_m, k_m) and torch.equal(lib_w, k_w),
            "the bmm ladder disagrees with the screen kernel")
    del lib_m, lib_w
    # the count of the algorithm the kernel runs, from its plain twin
    sc_twin: dict = {}
    t_m, t_w, t_r = cycles.reduced_screen(rel, ELLE_MASKS, ELLE_NONADJ,
                                          "fixed", sc_twin)
    require(torch.equal(t_m, k_m) and torch.equal(t_w, k_w)
            and torch.equal(t_r, k_r),
            "the screen's plain twin disagrees with the kernel")
    require(sc_twin["stale_rows"] == 0, "the semi-naive closure went stale")
    del t_m, t_w
    B, n = rel.shape[0], rel.shape[-1]
    sc_bytes = B * n * n + B * (len(ELLE_MASKS) + len(ELLE_NONADJ)) * n \
        + 4 * B
    sc_plain_s, sc_ops_sq = sc_plain["fixed"]
    sc_bound, sc_by = cycles_bound(sc_bytes, sc_twin["int_ops"])
    sc_bound_sq, sc_by_sq = cycles_bound(sc_bytes, sc_ops_sq)
    hc_regs = {k: ptxas_resources(ptxas, k)
               for k in cycles_kernels("has_cycle", "fixed", 16)}
    sc_regs = {k: ptxas_resources(ptxas, k)
               for k in cycles_kernels("screen", "fixed", ELLE_N)}
    emit(phase="elle_times", kernel=cycles.HAS_CYCLE.name,
         case="version-graphs", rows=ELLE_STACK_ROWS, n=16, mode="fixed",
         design=cycles_design("has_cycle", "fixed", 16), resources=hc_regs,
         ms=hc_ms, runs_ms=hc_all, device_ms=hc_device_ms,
         bound_ms=hc_bound, bound_by=hc_by,
         bytes=hc_bytes, int_ops=hc_work["int_ops"],
         int_ops_squaring=hc_work["int_ops"], bound_ms_squaring=hc_bound,
         bound_by_squaring=hc_by, plain_ms=hc_plain_s * 1e3,
         library_ms=hc_lib_ms,
         library="bf16 torch.bmm per round, thresholded (fixed ladder)",
         e2e_histories_per_s=len(rw_hs) / rw_s, card=card)
    emit(phase="elle_times", kernel=cycles.SCREEN.name,
         case="list-append-strict-serializable", rows=ELLE_STACK_ROWS,
         n=ELLE_N, F=len(ELLE_MASKS), Q=len(ELLE_NONADJ), mode="fixed",
         design=cycles_design("screen", "fixed", ELLE_N), resources=sc_regs,
         ms=sc_ms, runs_ms=sc_all, device_ms=sc_device_ms,
         bound_ms=sc_bound, bound_by=sc_by,
         bytes=sc_bytes, int_ops=sc_twin["int_ops"],
         int_ops_squaring=sc_ops_sq, bound_ms_squaring=sc_bound_sq,
         bound_by_squaring=sc_by_sq, plain_ms=sc_plain_s * 1e3,
         library_ms=sc_lib_ms,
         library="bf16 torch.bmm per round, thresholded (fixed ladder)",
         e2e_histories_per_s=len(la_hs) / la_s, card=card)
    return [{
        "name": cycles.HAS_CYCLE.name,
        "route": "cuda",
        "source": "jepsen_tpu_torch/ops/csrc/cycles_closure.cu",
        "replaces": "jepsen_tpu/ops/cycles.py:376",
        "launches": rw_launches["has_cycle"],
        "max_abs_err": hc_err,
        "ms": hc_ms,
        "plain_ms": hc_plain_s * 1e3,
        "bound_ms": hc_bound,
        "bound_by": hc_by,
        "library_ms": hc_lib_ms,
    }, {
        "name": cycles.SCREEN.name,
        "route": "cuda",
        "source": "jepsen_tpu_torch/ops/csrc/cycles_closure.cu",
        "replaces": "jepsen_tpu/ops/cycles.py:400",
        "launches": la_launches["screen"],
        "max_abs_err": sc_err,
        "ms": sc_ms,
        "plain_ms": sc_plain_s * 1e3,
        "bound_ms": sc_bound,
        "bound_by": sc_by,
        "library_ms": sc_lib_ms,
    }], la_hs


# ---------------------------------------------------------------------------
# the unordered queue (phase 18), the mesh (19) and verdict stats (20)
# ---------------------------------------------------------------------------

#: suites/common.py:207-228 linearizable_queue_workload: unique elements,
#: 8 client processes, op-limit 40 per key
QUEUE_PROCS, QUEUE_OPS, QUEUE_TEMPLATES = 8, 40, 32
QUEUE_E2E_HISTORIES = 1024
#: initial contents of every third queue history
QUEUE_INITIAL = (1, 2, 3)
#: the value-id bitset's width (step_kernels.UQ_MAX_VALUES)
QUEUE_VALUES = step_kernels.UQ_MAX_VALUES


def queue_histories(seed: int, n: int, n_procs=QUEUE_PROCS,
                    n_ops=QUEUE_OPS):
    """(histories, models): the unique-element queue generator, a quarter
    corrupted, every third starting with :data:`QUEUE_INITIAL` queued."""
    rng = random.Random(seed)
    hs, ms = [], []
    for i in range(n):
        init = QUEUE_INITIAL if i % 3 == 1 else ()
        hs.append(synth.generate_queue_history(
            rng, n_procs, n_ops, corrupt=i % 4 == 0, initial=init))
        ms.append(models.UnorderedQueue(init))
    return hs, ms


def queue_arrays(hs, ms, C, pad_rows=0):
    """The encodable histories (at most 31 values) stacked at ``C`` lanes,
    plus ``pad_rows`` all-padding rows: (arrays, indices kept)."""
    encs, keep = [], []
    for i, (h, m) in enumerate(zip(hs, ms)):
        e = encode.encode_history(h, m, slot_cap=C)
        if e is not None:
            encs.append(e)
            keep.append(i)
    require(encs, "no queue history encoded")
    E = encode.round_up(max(e.ev_slot.shape[0] for e in encs))
    b = encode.stack_encoded(encs, list(range(len(encs))), E, C)
    arrays = tuple(np.concatenate([a, np.full((pad_rows,) + a.shape[1:], f,
                                              a.dtype)])
                   for a, f in zip(batch_arrays(b), wgl._PAD_FILLS))
    return arrays, keep


def queue_flagship():
    """32 queue templates relabelled to :data:`FLAGSHIP_ROWS` rows: each
    row permutes the value ids 1..31 (initial bitset included), which
    keeps its template's verdict."""
    hs, ms = queue_histories(48100, QUEUE_TEMPLATES)
    t_arrays, _ = queue_arrays(hs, ms, QUEUE_PROCS)
    K = t_arrays[0].shape[0]
    B = FLAGSHIP_ROWS
    reps = np.random.default_rng(48100).integers(0, K, size=B)
    r = np.random.default_rng(1)
    perm = np.argsort(r.random((B, QUEUE_VALUES)), axis=1) + 1
    table = np.concatenate([np.zeros((B, 1), np.int64), perm], axis=1)
    init0 = t_arrays[0][reps].astype(np.int64) & 0xFFFFFFFF
    init = np.zeros(B, np.int64)
    for v in range(1, QUEUE_VALUES + 1):
        init |= ((init0 >> (v - 1)) & 1) << (table[:, v] - 1)
    init = np.where(init >= 1 << 31, init - (1 << 32), init)
    E, C = t_arrays[1].shape[1], t_arrays[2].shape[2]
    a = np.take_along_axis(table, t_arrays[4][reps].reshape(B, -1).astype(
        np.int64), axis=1).astype(np.int16).reshape(B, E, C)
    arrays = (init.astype(np.int32), t_arrays[1][reps], t_arrays[2][reps],
              t_arrays[3][reps], a, t_arrays[5][reps])
    return arrays, reps


def queue_at_value_cap(seed: int, n: int):
    """Queue histories whose value ids reach the bitset's 31: each history
    of the generator, beside initial contents of fresh values that make
    up the difference (queued, never dequeued, so the verdict stays)."""
    rng = random.Random(seed)
    hs, ms = [], []
    while len(hs) < n:
        h = synth.generate_queue_history(rng, 4, 40,
                                         corrupt=len(hs) % 2 == 0)
        values = {op.value for op in h if op.value is not None}
        extra = QUEUE_VALUES - len(values)
        if extra < 1:
            continue
        hs.append(h)
        ms.append(models.UnorderedQueue(tuple(range(1000, 1000 + extra))))
    return hs, ms


def random_queue_codes(seed: int, B=128, E=64, C=12):
    """Random lanes: any slot ids and op codes, value ids past both ends
    of 1..32, any 32-bit initial bitset, completing slots past C."""
    r = np.random.default_rng(seed)
    init = r.integers(-2 ** 31, 2 ** 31, B, dtype=np.int64).astype(np.int32)
    ev = r.integers(-1, C + 2, (B, E)).astype(np.int32)
    cs = r.integers(-1, C, (B, E, C)).astype(np.int8)
    cf = r.choice([F_ENQUEUE, F_DEQUEUE, 0, 1, 13], (B, E, C),
                  p=[0.4, 0.4, 0.1, 0.05, 0.05]).astype(np.int8)
    ca = r.integers(-3, 41, (B, E, C)).astype(np.int16)
    cb = r.integers(0, 4, (B, E, C)).astype(np.int16)
    return init, ev, cs, cf, ca, cb


def completing_past_c(arrays, events):
    """Copies of queue ``arrays``' rows where row i's event ``events[i]``
    (None: none) completes slot C, which no lane holds: no config
    linearized it, so the row fails there unless it failed before."""
    init, ev, cs, cf, ca, cb = (x.copy() for x in arrays)
    for i, e in enumerate(events):
        if e is not None:
            ev[i, e] = cs.shape[2]
    return init, ev, cs, cf, ca, cb


def queue_warp_edges(flagship):
    """(name, arrays, forced events) of queue rows around the warp design
    (4 histories a warp at C 8, 32 at C 4): a row count that is no multiple
    of 4; rows that fail at event 0, where slot 0 alone holds a dequeue of
    value 40, which no value bit or open enqueue serves (``failing_at``);
    and warps whose histories fail at different events, each completing a
    slot past C there (``completing_past_c``; None: not forced)."""
    rows9 = tuple(a[:9] for a in flagship)
    rows8 = tuple(a[:8] for a in flagship)
    staggered = [3, None, 9, 0, 17, 5, None, 30]
    c4, _ = queue_arrays(*queue_histories(48160, 45, n_procs=4), 4)
    E4 = c4[1].shape[1]
    c4_events = [None if i % 3 == 0 else (7 * i) % E4
                 for i in range(len(c4[0]))]
    return [
        ("B131-H4", tuple(a[:131] for a in flagship), []),
        ("fail-at-0", failing_at(rows9, [0] * 9, F_DEQUEUE, 40), [0] * 9),
        ("fail-staggered-H4", completing_past_c(rows8, staggered),
         staggered),
        ("fail-staggered-H32", completing_past_c(c4, c4_events), c4_events),
    ]


def queue_compare(name, arrays, device, work=None):
    """The queue automaton's kernel against its plain version on every
    row of ``arrays``; emits one line and returns (outputs, plain seconds,
    max error)."""
    B, E, C = arrays[2].shape
    checker = dense.make_dense_fn("unordered-queue", E, C, 0, device)
    (ok, failed_at, ovf), plain_s, err = compare(
        checker, to_device(arrays, device), work)
    require(not ovf.any(), f"queue {name}: the dense automaton overflowed")
    emit(phase="queue_edge" if name else "queue", case=name, rows=int(B),
         E=int(E), C=int(C), compared_rows=int(B),
         invalid=int((~ok).sum()), max_abs_err=err, plain_s=plain_s,
         tolerance="exact (byte-equal)")
    return (ok, failed_at, ovf), plain_s, err


def queue_phase(device, card, ptxas=""):
    """Phase 18; returns the ``{"kernels": [...]}`` entry of K2."""
    kernel = dense.DENSE_KERNELS["unordered-queue"]
    arrays, reps = queue_flagship()
    B, E, C = arrays[2].shape
    work: dict = {}
    (ok, failed_at, _), plain_s, err = queue_compare("", arrays, device,
                                                     work)
    for t in np.unique(reps):
        rows = reps == t
        require(len(set(ok[rows])) == 1 and len(set(failed_at[rows])) == 1,
                f"queue rows of template {int(t)} disagree")
    require((~ok).any() and ok.any(), "the queue batch is all one verdict")

    # edges: C either side of the warp design's boundaries (one word a
    # lane from C 5 to 6, one warp a history from C 10 to 11), the
    # 31-value cap, padding, random codes, and the rows of queue_warp_edges
    edges = []
    for n_procs in (1, 5, 6, 10, 11, 12):
        hs, ms = queue_histories(48110 + n_procs, 64, n_procs=n_procs)
        edges.append((f"C{n_procs}", queue_arrays(hs, ms, n_procs,
                                                  pad_rows=2)[0]))
    hs, ms = queue_at_value_cap(48120, 64)
    cap_arrays, _ = queue_arrays(hs, ms, 4, pad_rows=2)
    require(int((cap_arrays[0] != 0).sum()) > 0, "no initial contents")
    edges.append(("31-values", cap_arrays))
    edges.append(("random-ops", random_batch("unordered-queue", 48130,
                                             C=8)))
    edges.append(("random-codes", random_queue_codes(48140)))
    forced = queue_warp_edges(arrays)
    edges += [(name, e_arrays) for name, e_arrays, _ in forced]
    failed_by_name = {}
    for name, e_arrays in edges:
        (_, e_failed, _), _, e_err = queue_compare(name, e_arrays, device)
        failed_by_name[name] = e_failed
        err = max(err, e_err)
    for name, _, events in forced:
        got = failed_by_name[name]
        for i, e in enumerate(events):
            require(e is None or 0 <= got[i] <= e,
                    f"queue {name}: row {i} failed at {got[i]}, not by {e}")
    require((failed_by_name["fail-at-0"] == 0).all(),
            "queue fail-at-0 rows did not fail at event 0")
    require(len(set(failed_by_name["fail-staggered-H4"][:4].tolist())) > 1,
            "the first queue warp's histories all failed at one event")

    # end to end: the dense entry point (launch counter reset around it)
    # against the direct checker through check_batch and the frontier
    # search, on 1024 fresh histories of the same workload
    hs, ms = queue_histories(48150, QUEUE_E2E_HISTORIES)
    e_arrays, keep = queue_arrays(hs, ms, QUEUE_PROCS)
    eB, eE, eC = e_arrays[2].shape
    checker = dense.make_dense_fn("unordered-queue", eE, eC, 0, device)
    e_dev = to_device(e_arrays, device)
    kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_ok = checker(*e_dev)[0].cpu().numpy()
    dense_s = time.perf_counter() - t0
    launches = kernel.launches
    require(launches > 0, "the queue's dense entry point never launched K2")
    t0 = time.perf_counter()
    direct = {}
    for init in ((), QUEUE_INITIAL):
        idx = [i for i in range(len(hs))
               if ms[i] == models.UnorderedQueue(init)]
        for i, r in zip(idx, wgl.check_batch(models.UnorderedQueue(init),
                                             [hs[i] for i in idx])):
            direct[i] = r
    direct_s = time.perf_counter() - t0
    require(all(direct[i]["engine"] == "oracle-routed" for i in keep),
            "check_batch did not route the queue to the direct checker")
    want = [direct[i]["valid?"] for i in keep]
    require(q_ok.tolist() == want,
            "K2 and the direct checker disagree on the queue histories")
    frontier = wgl.make_check_fn("unordered-queue", eE, eC, 256, eC + 1,
                                 device)
    f_ok, _, f_ovf = (x.cpu().numpy() for x in frontier(*e_dev))
    require(not f_ovf.any(), "the queue's frontier search overflowed")
    require(f_ok.tolist() == want,
            "K2 and the frontier search disagree on the queue histories")
    emit(phase="queue_end_to_end", histories=len(hs), encoded=len(keep),
         E=int(eE), C=int(eC), invalid=int((~q_ok).sum()),
         launches=launches, dense_s=dense_s, direct_s=direct_s,
         direct_histories_per_s=len(hs) / direct_s,
         agrees_with=["check_batch direct checker", "frontier search F=256"],
         card=card)

    flag_checker = dense.make_dense_fn("unordered-queue", E, C, 0, device)
    flag_dev = to_device(arrays, device)
    ms_, all_ms = time_kernel(flag_checker, flag_dev)
    device_ms = graph_ms(flag_checker, flag_dev, launches=5)
    # the queue automaton reads no cand_b: 4 bytes per lane
    bound_ms, bound_by, nbytes = kernel_bound(arrays, failed_at,
                                              work["int_ops"], lane_bytes=4)
    emit(phase="queue_times", kernel=kernel.name, rows=int(B), E=int(E),
         C=int(C), design=dense.queue_design(int(C)),
         **ptxas_resources(ptxas, f"dense_queue_kernelILi{max(C - 5, 0)}E"),
         ms=ms_, runs_ms=all_ms, device_ms=device_ms, bound_ms=bound_ms,
         bound_by=bound_by, bytes=nbytes, int_ops=work["int_ops"],
         max_passes=work["max_passes"],
         plain_ms=plain_s * 1e3, launches=launches, library_ms=None,
         library="no single PyTorch call computes the queue automaton",
         card=card)
    return {
        "name": kernel.name,
        "route": "cuda",
        "source": "jepsen_tpu_torch/ops/csrc/dense_automaton.cu",
        "replaces": "jepsen_tpu/ops/dense.py:632",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms_,
        "plain_ms": plain_s * 1e3,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def pick_mesh(device):
    """A two-shard mesh: two distinct cards when there are, else the one
    card named twice (the counterpart of the reference's virtual
    devices)."""
    if torch.cuda.device_count() >= 2:
        return mesh_mod.Mesh([torch.device("cuda", 0),
                              torch.device("cuda", 1)])
    return mesh_mod.Mesh([device, device])


def same_results(a, b) -> bool:
    return (json.dumps(a, sort_keys=True, default=repr)
            == json.dumps(b, sort_keys=True, default=repr))


def mesh_phase(mesh, card, model, hs, results, f_hs, la_hs):
    """Phase 19: check_batch over the mesh on the dense and the frontier
    (with escalation) paths, and Elle through an Executor on the mesh,
    each equal to its unsharded run."""
    emit(phase="mesh", mesh=mesh.describe(),
         placement=("one card named twice" if mesh.repeated
                    else "distinct cards"), card=card)
    stats: dict = {}
    reset_dense_launches()
    t0 = time.perf_counter()
    sharded = wgl.check_batch(model, hs, slot_cap=8, mesh=mesh, stats=stats)
    seconds = time.perf_counter() - t0
    require(same_results(sharded, results),
            "sharded and unsharded check_batch differ on the dense path")
    require(dense.DENSE_AUTOMATON.launches > 0,
            "the sharded run never launched the dense kernel")
    emit(phase="mesh_check_batch", case="cas-register dense",
         histories=len(hs), seconds=seconds,
         histories_per_s=len(hs) / seconds,
         launches=dense.DENSE_AUTOMATON.launches, **stats, card=card)

    sub = f_hs[:256] + f_hs[-8:]
    wgl.ESCALATIONS.clear()
    whole = wgl.check_batch(model, sub, frontier=32)
    whole_rungs = dict(wgl.ESCALATIONS)
    wgl.ESCALATIONS.clear()
    wgl.FRONTIER_SEARCH.launches = 0
    stats = {}
    t0 = time.perf_counter()
    sharded = wgl.check_batch(model, sub, frontier=32, mesh=mesh,
                              stats=stats)
    seconds = time.perf_counter() - t0
    rungs = dict(wgl.ESCALATIONS)
    require(rungs, "no escalation rung ran under the mesh")
    require(rungs == whole_rungs, f"escalations {rungs} != {whole_rungs}")
    require(same_results(sharded, whole),
            "sharded and unsharded check_batch differ on the frontier path")
    emit(phase="mesh_check_batch", case="cas-register 40 values, F=32",
         histories=len(sub), seconds=seconds,
         histories_per_s=len(sub) / seconds,
         launches=wgl.FRONTIER_SEARCH.launches,
         escalations={str(k): v for k, v in rungs.items()},
         batch_stats=wgl.batch_stats(sharded), **stats, card=card)

    opts = {"workload": "list-append",
            "consistency-models": ["strict-serializable"],
            "screen-route": "device"}
    whole = elle.check_batch(opts, la_hs)
    ex = execution.Executor(4, mesh=mesh)
    cycles.SCREEN.launches = 0
    t0 = time.perf_counter()
    sharded = elle.check_batch(opts, la_hs, executor=ex)
    seconds = time.perf_counter() - t0
    require(same_results(sharded, whole),
            "sharded and unsharded elle.check_batch differ")
    require(cycles.SCREEN.launches >= mesh.size,
            "the sharded Elle run did not launch the screen per shard")
    emit(phase="mesh_elle", case="list-append strict-serializable",
         histories=len(la_hs), seconds=seconds,
         histories_per_s=len(la_hs) / seconds,
         launches=cycles.SCREEN.launches, **ex.counters(), card=card)


#: rows of phase 20's input past the single-block switch
STATS_BIG_ROWS = 10 ** 6


def stats_edges(device):
    """(name, ok, overflow) of K9's edge inputs as bool views of uint8
    bytes on ``device``: bytes 0, 1, 2, 0x80 and 0xFF (any nonzero byte
    reads as true), B = 1, starts off a 16-byte boundary (both arrays
    alike, and each differently: the byte-wise path), and 10^6 rows past
    the single-block switch, aligned and not."""
    r = np.random.default_rng(48210)
    n = STATS_BIG_ROWS + 32
    ok_u8 = torch.from_numpy(r.choice(np.array(
        [0, 1, 2, 0x80, 0xFF, 0], np.uint8), n)).to(device)
    ovf_u8 = torch.from_numpy(r.choice(np.array(
        [0, 0, 0, 1, 7, 0x40], np.uint8), n)).to(device)
    cases = [("B1", 0, 0, 1), ("B1-unaligned", 5, 9, 1),
             ("B16384-both-off-3", 3, 3, 16384),
             ("B16384-ok[1:]", 1, 0, 16384),
             ("B16383-off-5-12", 5, 12, 16383),
             ("B1e6", 0, 0, STATS_BIG_ROWS),
             ("B1e6-both-off-7", 7, 7, STATS_BIG_ROWS - 5),
             ("B1e6-off-2-9", 2, 9, STATS_BIG_ROWS - 11)]
    return [(name, ok_u8[i:i + b].view(torch.bool),
             ovf_u8[j:j + b].view(torch.bool))
            for name, i, j, b in cases]


def empty_kernel():
    """A launch of ``verdict_stats.cu``'s empty kernel on the current
    stream (the floor a launch-bound kernel is timed against)."""
    fn = _build.load("verdict_stats").verdict_stats_empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run():
        err = fn(torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"empty kernel launch failed: CUDA error {err}")
    return run


def stats_phase(mesh, device, card, flagship, f_arrays, ptxas=""):
    """Phase 20: K9 against its plain version at 16384 rows, then summed
    over the shards of sharded_check runs (counts equal to the unsharded
    ones); times.  ``flagship`` is (arrays, dense checker, its ok);
    ``f_arrays`` the frontier slice.  Returns K9's kernels entry."""
    f_np, checker, ok_np = flagship
    B = ok_np.shape[0]
    ovf_np = np.random.default_rng(48200).random(B) < 0.05
    ok_t = torch.from_numpy(ok_np).to(device)
    ovf_t = torch.from_numpy(ovf_np).to(device)
    kern = mesh_mod.VERDICT_STATS(ok_t, ovf_t).cpu().numpy()
    plain = mesh_mod.verdict_stats_reference(ok_t, ovf_t).cpu().numpy()
    want = [int((ok_np & ~ovf_np).sum()), int((~ok_np & ~ovf_np).sum()),
            int(ovf_np.sum())]
    require(kern.tolist() == plain.tolist() == want,
            f"K9 {kern.tolist()}, plain {plain.tolist()}, numpy {want}")
    err = int(np.abs(kern - plain).max())
    edges = stats_edges(device)
    for name, e_ok, e_ovf in edges:
        got = mesh_mod.VERDICT_STATS(e_ok, e_ovf).cpu().numpy()
        e_plain = mesh_mod.verdict_stats_reference(
            e_ok.view(torch.uint8) != 0,
            e_ovf.view(torch.uint8) != 0).cpu().numpy()
        o, v = (x.view(torch.uint8).cpu().numpy() != 0 for x in (e_ok, e_ovf))
        e_want = [int((o & ~v).sum()), int((~o & ~v).sum()), int(v.sum())]
        require(got.tolist() == e_plain.tolist() == e_want,
                f"K9 {name}: {got.tolist()}, plain {e_plain.tolist()}, "
                f"numpy {e_want}")
        e_err = int(np.abs(got - e_plain).max())
        err = max(err, e_err)
        emit(phase="verdict_stats_edge", case=name, rows=int(len(o)),
             offsets=[e_ok.data_ptr() % 16, e_ovf.data_ptr() % 16],
             design=mesh_mod.stats_design(len(o)), max_abs_err=e_err,
             tolerance="exact (integer counts)")

    fB, fE, fC = f_arrays[2].shape
    f_checker = wgl.make_check_fn("cas-register", fE, fC, 32, fC + 1,
                                  device)
    mesh_mod.VERDICT_STATS.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_ok, _, d_ovf = mesh_mod.sharded_check(checker, mesh, *f_np)
    d_stats = mesh_mod.verdict_stats(d_ok, d_ovf, mesh)
    s_ok, _, s_ovf = mesh_mod.sharded_check(f_checker, mesh, *f_arrays)
    s_stats = mesh_mod.verdict_stats(s_ok, s_ovf, mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = mesh_mod.VERDICT_STATS.launches
    require(launches > 0, "verdict_stats never launched K9")
    w_ok, _, w_ovf = (x.cpu().numpy() for x in
                      f_checker(*to_device(f_arrays, device)))
    for name, st, (o, v) in (
            ("dense", d_stats, (ok_np, np.zeros(B, bool))),
            ("frontier F=32", s_stats, (w_ok, w_ovf))):
        got = [int(st[k]) for k in ("valid", "invalid", "unknown")]
        ref = [int((o & ~v).sum()), int((~o & ~v).sum()), int(v.sum())]
        require(got == ref, f"{name}: sharded stats {got} != {ref}")
        emit(phase="verdict_stats", case=name, shards=mesh.size,
             rows=int(len(o)), counts=dict(zip(("valid", "invalid",
                                                 "unknown"), got)),
             equal_to_unsharded=True, card=card)
    require(int(s_stats["unknown"]) > 0, "no frontier row overflowed at F=32")

    ms, all_ms = time_kernel(mesh_mod.VERDICT_STATS, (ok_t, ovf_t))
    device_ms = graph_ms(mesh_mod.VERDICT_STATS, (ok_t, ovf_t))
    empty_ms = graph_ms(empty_kernel(), ())
    big_ok, big_ovf = next((o, v) for name, o, v in edges if name == "B1e6")
    big_device_ms = graph_ms(mesh_mod.VERDICT_STATS, (big_ok, big_ovf))
    plain_ms, _ = time_kernel(mesh_mod.verdict_stats_reference,
                              (ok_t, ovf_t))
    library_ms, _ = time_kernel(
        lambda o, v: (torch.count_nonzero(o & ~v),
                      torch.count_nonzero(~o & ~v), torch.count_nonzero(v)),
        (ok_t, ovf_t))
    nbytes = 2 * B + 24
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    emit(phase="verdict_stats_times", kernel=mesh_mod.VERDICT_STATS.name,
         rows=int(B), design=mesh_mod.stats_design(B),
         **ptxas_resources(ptxas, "verdict_stats_kernel"), ms=ms,
         runs_ms=all_ms, device_ms=device_ms, empty_kernel_device_ms=empty_ms,
         device_ms_1e6=big_device_ms, bound_ms_1e6=(
             2 * STATS_BIG_ROWS + 24) / HBM_BYTES_PER_S * 1e3,
         bound_ms=bound_ms,
         bound_by="bytes", bytes=nbytes, plain_ms=plain_ms,
         library_ms=library_ms,
         library="three torch.count_nonzero calls", launches=launches,
         sharded_seconds=seconds, card=card)
    return {
        "name": mesh_mod.VERDICT_STATS.name,
        "route": "cuda",
        "source": "jepsen_tpu_torch/ops/csrc/verdict_stats.cu",
        "replaces": "jepsen_tpu/parallel/mesh.py:221",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# the Checker seam (phase 21) and the profile of its run (22)
# ---------------------------------------------------------------------------


def keyed_history(hs) -> History:
    """Phase 4's histories as one keyed history, built in one pass: an
    un-keyed nemesis op at the head, then history i's ops with values
    ``KV(i, v)`` and processes offset by i × its process count.  Set-up,
    not the seam: the cyclic collector is paused while two million ops
    (which hold no cycles) are allocated, two thirds of the build
    otherwise."""
    ops = [Op("info", "nemesis", "start", None, 0)]
    gc.disable()
    try:
        for i, h in enumerate(hs):
            off = i * (1 + max(op.process for op in h))
            ops.extend(Op(op.type, op.process + off, op.f,
                          independent.KV(i, op.value), op.time, -1,
                          **op.extra)
                       for op in h)
    finally:
        gc.enable()
    return History(ops).index_ops()


def error_paths(x, path="") -> list:
    """Where an ``"error"`` key sits anywhere in a result."""
    found = []
    if isinstance(x, dict):
        for k, v in x.items():
            if k == "error":
                found.append(f"{path}/error")
            found += error_paths(v, f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            found += error_paths(v, f"{path}/{i}")
    return found


def seam_run(keyed):
    """One ``check_safe`` → ``compose`` → ``batched_linearizable`` run on
    the keyed history: ``(result, seconds, dense launches)``."""
    chk = checker_mod.compose({"linear": independent.batched_linearizable(
        models.cas_register(0), slot_cap=8)})
    dense.DENSE_AUTOMATON.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = checker_mod.check_safe(chk, {"store?": False}, keyed)
    seconds = time.perf_counter() - t0
    return out, seconds, dense.DENSE_AUTOMATON.launches


def check_seam_result(out, results, launches, what):
    require(not error_paths(out), f"{what}: errors at {error_paths(out)}")
    lin = out["linear"]
    n = len(results)
    require(sorted(lin["results"]) == list(range(n)),
            f"{what}: keys {len(lin['results'])} != {n}")
    for i in range(n):
        require(lin["results"][i]["valid?"] == results[i]["valid?"],
                f"{what}: key {i} says {lin['results'][i]['valid?']}, "
                f"phase 4 said {results[i]['valid?']}")
    invalid = sorted((i for i in range(n) if results[i]["valid?"] is not
                      True), key=str)
    require(lin["failures"] == invalid, f"{what}: failures differ")
    engines = lin["batch-stats"]["engines"]
    require(engines.get("gpu", 0) > 0 and engines.get("oracle-fallback", 0)
            > 0, f"{what}: batch-stats engines {engines}")
    require(launches > 0, f"{what}: the dense kernel never launched")
    return engines


def checker_seam_phase(card, model, hs, results, e2e_rate, f_hs,
                       f_results):
    """Phase 21: the Checker seam at full width, obs off and on; the
    single-history ``linearizable`` routes; the witness; the race."""
    t0 = time.perf_counter()
    keyed = keyed_history(hs)
    build_s = time.perf_counter() - t0
    require(len(independent.history_keys(keyed)) == len(hs),
            "the keyed history lost keys")
    obs.disable()
    off, off_s, off_launches = seam_run(keyed)
    engines = check_seam_result(off, results, off_launches, "obs off")
    obs.enable(reset=True)
    on, on_s, on_launches = seam_run(keyed)
    check_seam_result(on, results, on_launches, "obs on")
    spans = {s.name for s in obs.tracer().finished()}
    want = {"checker/Compose", "checker/BatchedLinearizable",
            "engine/pipeline", "engine/dispatch"}
    require(want <= spans, f"spans missing: {sorted(want - spans)}")
    dispatches = sum(d["value"] for d in obs.registry().snapshot()
                     if d["name"] == "jepsen_kernel_dispatches_total"
                     and d["labels"].get("engine") == "dense")
    require(dispatches > 0, "jepsen_kernel_dispatches_total{engine=dense} "
            "is 0")
    paths = obs.export_all("build/obs")
    for check, key in ((obs_export.validate_chrome_trace, "trace"),
                       (obs_export.validate_prometheus, "metrics")):
        bad = check(paths[key])
        require(bad is None, f"exported {key} invalid: {bad}")
    summary = obs.summary()

    # one history each through linearizable's "auto" route on the card
    lin = checker_mod.linearizable(model)
    j = next(i for i, r in enumerate(results)
             if r["engine"] == "gpu" and r["valid?"] is False)
    r = lin.check({}, hs[j])
    require(r["valid?"] == results[j]["valid?"] and r["engine"] == "gpu",
            f"linearizable on history {j}: {r}")
    jf = next(i for i, r in enumerate(f_results)
              if r["engine"] == "gpu" and r.get("kernel") == "frontier")
    wgl.FRONTIER_SEARCH.launches = 0
    rf = lin.check({}, f_hs[jf])
    require(rf["valid?"] == f_results[jf]["valid?"]
            and rf.get("kernel") == "frontier",
            f"linearizable on frontier history {jf}: {rf}")
    require(wgl.FRONTIER_SEARCH.launches > 0,
            "linearizable never launched the frontier kernel")

    # a failing history with a store identity writes its witness
    stamp = time.strftime("%Y%m%dT%H%M%S")
    rw = lin.check({"name": "chip_smoke", "start-time": stamp,
                    "store-base": "build/store"}, hs[j])
    require(rw["valid?"] is False and os.path.isfile(rw.get("witness", "")),
            f"no linear.svg for history {j}: {rw.get('witness-error')}")

    # the race last: wait for both arms of every race before going on
    racers = [i for i, r in enumerate(results)
              if r["engine"] == "oracle-fallback"][:4]
    before = set(threading.enumerate())
    race = checker_mod.linearizable(model, algorithm="race")
    winners = []
    for i in racers:
        rr = race.check({}, hs[i])
        require(rr["valid?"] == results[i]["valid?"],
                f"race on history {i}: {rr['valid?']}, the oracle said "
                f"{results[i]['valid?']}")
        winners.append(rr["engine"])
    for t in set(threading.enumerate()) - before:
        t.join(timeout=checker_mod.RACE_LOSER_WAIT_S)
    n = len(hs)
    emit(phase="checker_seam", keys=n, ops=len(keyed),
         keyed_build_s=build_s, seconds_obs_off=off_s,
         histories_per_s_obs_off=n / off_s, seconds_obs_on=on_s,
         histories_per_s_obs_on=n / on_s, phase4_histories_per_s=e2e_rate,
         launches_obs_off=off_launches, launches_obs_on=on_launches,
         dense_dispatches_total=dispatches, batch_stats_engines=engines,
         spans=len(obs.tracer()), spans_dropped=obs.tracer().dropped,
         obs_summary_engines=summary.get("engines"),
         engine_occupancy=summary.get("engine-occupancy"),
         linearizable=[j, jf], witness=rw["witness"], race=racers,
         race_winners=winners, card=card)
    return keyed


def profile_phase(card, keyed, device):
    """Phase 22: ``torch.profiler`` around phase 21's batched run with obs
    on; the device's busy share of the window."""
    obs.enable(reset=True)
    box = {}
    manifest = profiling.capture(
        "build/profile", label="checker_seam", device=device,
        work=lambda: box.update(run=seam_run(keyed)))
    require(manifest["trace"] is not None,
            f"torch.profiler captured no trace: "
            f"{manifest.get('trace_error')}")
    out, seconds, launches = box["run"]
    require(not error_paths(out) and launches > 0,
            "the profiled seam run failed or never launched the dense "
            "kernel")
    kernels = manifest["kernels"]
    register = sum(v for k, v in kernels.items()
                   if "register_warp_kernel" in k)
    require(register > 0, "the profile lists no register_warp_kernel "
            f"device time (kernels: {sorted(kernels)[:8]})")
    busy = sum(kernels.values())
    wall = manifest["wall_seconds"]
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    emit(phase="profile", wall_s=wall, seam_seconds=seconds,
         kernel_device_s=busy, register_warp_kernel_s=register,
         device_busy_share=busy / wall, launches=launches,
         kernels={k: v for k, v in top}, n_kernel_names=len(kernels),
         memory=manifest["memory"], card=card)


# ---------------------------------------------------------------------------
# the checker service (phase 24)
# ---------------------------------------------------------------------------

#: the service's client threads, and the frontier histories it is sent
SERVICE_CLIENTS = 4
SERVICE_FRONTIER_ROWS = 256
SERVICE_KEYS = 64
SERVICE_PROBE_ROWS = 64


def daemon_delta(after: dict, before: dict) -> dict:
    """Per-wrapper launches the daemon made between two ``/status``
    reads."""
    return {k: v - before["kernel_launches"].get(k, 0)
            for k, v in after["kernel_launches"].items()
            if v - before["kernel_launches"].get(k, 0)}


def timed_check(client, model, hs, **opts):
    from jepsen_tpu_torch import serve

    t0 = time.perf_counter()
    out = serve.check_batch(model, hs, client=client, **opts)
    return out, time.perf_counter() - t0


def service_phase(card, model, hs, results, e2e_rate, f_hs, f_results,
                  la_hs, device, on_ready=None):
    """Phase 24: the resident checker service in a child process, with
    phase 25 on it before its drain.  ``on_ready`` runs once the daemon
    answers (phase 26's fleet starts there, off the critical path)."""
    import tempfile

    from jepsen_tpu_torch import serve
    from jepsen_tpu_torch.elle import list_append as elle_la

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_",
                                     dir="build") as tmp:
        t0 = time.perf_counter()
        client = serve.spawn_daemon(
            wal=os.path.join(tmp, "verdict-wal.jsonl"), coalesce_wait=0.25,
            wait_s=300, log_path=os.path.join(tmp, "daemon.log"))
        ready_s = time.perf_counter() - t0
        clients = [client]
        if on_ready is not None:
            on_ready()
        try:
            probe = hs[:SERVICE_PROBE_ROWS]
            out, cold_s = timed_check(client, model, probe, slot_cap=8)
            require(out == results[:SERVICE_PROBE_ROWS],
                    "service: the first request differs from phase 4")
            cold_diag = dict(client.last_diag)
            require(cold_diag.get("cold_dispatches", 0) > 0,
                    "service: the cold daemon's first request was warm")

            # -- four clients at once, a quarter of phase 4 each --------
            quarter = -(-len(hs) // SERVICE_CLIENTS)
            parts = [hs[i:i + quarter] for i in range(0, len(hs), quarter)]
            separate = 0
            for part in parts:
                dense.DENSE_AUTOMATON.launches = 0
                wgl.check_batch(model, part, slot_cap=8)
                separate += dense.DENSE_AUTOMATON.launches
            pool = [serve.ServiceClient(port=client.port) for _ in parts]
            clients += pool
            got = [None] * len(parts)
            errors = []
            barrier = threading.Barrier(len(parts))

            def send(i):
                try:
                    barrier.wait(timeout=60)
                    got[i] = serve.check_batch(model, parts[i],
                                               client=pool[i], slot_cap=8)
                except Exception as e:  # noqa: BLE001 — re-raised below
                    errors.append(repr(e))

            st0 = client.status()
            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(len(parts))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            served_s = time.perf_counter() - t0
            st1 = client.status()
            require(not errors, f"service: client errors {errors}")
            merged = [r for part in got for r in part]
            require(merged == results,
                    "service: the four clients' results differ from "
                    "phase 4's")
            fallbacks = {k: v for c in pool for k, v in c.fallbacks.items()}
            require(not fallbacks, f"service: fallbacks {fallbacks}")
            coalesced = (st1["coalesced_dispatches"]
                         - st0["coalesced_dispatches"])
            require(coalesced > 0, "service: no dispatch was shared")
            k1 = daemon_delta(st1, st0).get("dense/register", 0)
            require(0 < k1 < separate,
                    f"service: {k1} K1 launches in the daemon, {separate} "
                    "in four separate runs")
            rows = st1["dispatch_rows"].get("dense", 0) - \
                st0["dispatch_rows"].get("dense", 0)
            # the wire's host cost of one quarter, in this process: the
            # client's request build, and the daemon's decode of it
            t0 = time.perf_counter()
            body = serve.protocol.check_request(model, parts[0],
                                                {"slot_cap": 8})
            wire_encode_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            serve.protocol.histories_from_wire(
                serve.protocol.decode_body(body)["histories"])
            wire_decode_s = time.perf_counter() - t0
            emit(phase="service", step="coalesce", clients=len(parts),
                 histories=len(hs), ready_s=ready_s,
                 seconds=served_s, histories_per_s=len(hs) / served_s,
                 phase4_histories_per_s=e2e_rate, k1_launches=k1,
                 k1_launches_separate=separate,
                 rows_per_launch=rows / k1,
                 coalesced_requests=st1["coalesced"] - st0["coalesced"],
                 coalesced_dispatches=coalesced,
                 batches=st1["batches"] - st0["batches"],
                 quarter_wire_bytes=len(body),
                 quarter_wire_encode_s=wire_encode_s,
                 quarter_wire_decode_s=wire_decode_s,
                 first_request_s=cold_s, first_request=cold_diag, card=card)

            # -- phase 8's frontier rows, the crash-heavy ones included ---
            pick = list(range(SERVICE_FRONTIER_ROWS)) + \
                list(range(len(f_hs) - 8, len(f_hs)))
            st0 = client.status()
            f_out, f_s = timed_check(client, model, [f_hs[i] for i in pick])
            st1 = client.status()
            require(f_out == [f_results[i] for i in pick],
                    "service: frontier results differ from phase 8's")
            f_delta = daemon_delta(st1, st0)
            rungs = {k: v - st0["escalations"].get(k, 0)
                     for k, v in st1["escalations"].items()
                     if v - st0["escalations"].get(k, 0)}
            require(f_delta.get("frontier_search", 0) > 0,
                    "service: K4 never launched in the daemon")
            require(rungs, "service: no escalation rung ran in the daemon")
            emit(phase="service", step="frontier", histories=len(pick),
                 seconds=f_s, launches=f_delta, escalations=rungs,
                 batch_stats=wgl.batch_stats(f_out), card=card)

            # -- phase 16's list-append graphs through /elle ---------------
            opts = {"workload": "list-append",
                    "consistency-models": ["strict-serializable"]}
            encs = [elle_encode.encode_graph(elle_la.prepare(h, opts)[0])
                    for h in la_hs]
            st0 = client.status()
            t0 = time.perf_counter()
            via = serve.screen_graphs(encs, client=client)
            e_s = time.perf_counter() - t0
            st1 = client.status()
            require(via is not None, f"service: /elle failed "
                    f"({client.fallbacks})")
            local = cycles.screen_graphs(encs, device=device)
            for i, (a, b) in enumerate(zip(via, local)):
                require((a is None) == (b is None), f"service: graph {i} "
                        "screened on one side only")
                if a is None:
                    continue
                require(sorted(a.members) == sorted(b.members)
                        and all((a.members[m] == b.members[m]).all()
                                for m in a.members)
                        and sorted(a.walks) == sorted(b.walks)
                        and all((a.walks[q] == b.walks[q]).all()
                                for q in a.walks),
                        f"service: graph {i}'s screens differ")
            e_delta = daemon_delta(st1, st0)
            require(e_delta.get("cycles_screen", 0) > 0,
                    "service: K7 never launched in the daemon")
            emit(phase="service", step="elle", graphs=len(encs),
                 seconds=e_s, launches=e_delta,
                 screened=sum(r is not None for r in via), card=card)

            # -- linearizable(algorithm="service") under the lift ----------
            keys = list(range(SERVICE_KEYS - 8)) + \
                list(range(len(hs) - 8, len(hs)))
            keyed = keyed_history([hs[i] for i in keys])
            test = {"store?": False}
            st0 = client.status()
            t0 = time.perf_counter()
            lin = checker_mod.check_safe(independent.checker(
                checker_mod.linearizable(model, algorithm="service",
                                         client=client)), test, keyed)
            lin_s = time.perf_counter() - t0
            st1 = client.status()
            ref = checker_mod.check_safe(independent.checker(
                checker_mod.linearizable(model)), test, keyed)
            require(not error_paths(lin), f"service: linearizable errors at "
                    f"{error_paths(lin)}")
            require(not client.fallbacks,
                    f"service: fallbacks {client.fallbacks}")
            differ = [k for k in ref["results"]
                      if lin["results"].get(k) != ref["results"][k]]
            require(not differ, f"service: {len(differ)} keys differ from "
                    f"the in-process lift, first {differ[:1]}: "
                    f"{lin['results'].get(differ[0]) if differ else None} "
                    f"against {ref['results'][differ[0]] if differ else None}")
            for j, i in enumerate(keys):
                require(lin["results"][j]["valid?"] == results[i]["valid?"],
                        f"service: key {j} says "
                        f"{lin['results'][j]['valid?']}, phase 4 said "
                        f"{results[i]['valid?']}")
            emit(phase="service", step="linearizable", keys=len(keys),
                 seconds=lin_s, requests=st1["requests"] - st0["requests"],
                 coalesced_requests=st1["coalesced"] - st0["coalesced"],
                 launches=daemon_delta(st1, st0), valid=lin["valid?"],
                 card=card)

            # -- 25. online checking on this daemon ------------------------
            watcher = feed_phase(card, client, model, hs, results, f_hs,
                                 f_results)

            # -- the CLI's status, top and profile on this daemon ---------
            cli_service_commands(card, client, tmp)

            # -- drain and exit, through the CLI's shutdown ---------------
            code, out = run_cli_captured(["shutdown", "--port",
                                          str(client.port)])
            require(code == cli.EXIT_VALID and "draining" in out,
                    f"service: cli shutdown exited {code}: {out!r}")
            rc = client.spawned.wait(timeout=300)
            require(rc == 0, f"service: the daemon exited {rc}")
            watcher.thread.join(timeout=60)
            require(not watcher.thread.is_alive() and watcher.error is None,
                    f"service: the /watch subscriber did not end cleanly "
                    f"({watcher.error})")
            emit(phase="service", step="drain", exit_code=rc,
                 watch_events=len(watcher.events),
                 phase_seconds=time.perf_counter() - t_phase, card=card)
        finally:
            for c in clients:
                if c.spawned is not None and c.spawned.poll() is None:
                    serve.client._reap(c.spawned)


def cli_service_commands(card, client, tmp) -> None:
    """Phase 24's daemon through the CLI: ``status``, ``top --once`` and
    ``profile`` (a one-second ``torch.profiler`` window on the daemon)."""
    port = ["--port", str(client.port)]
    t0 = time.perf_counter()
    code, status = run_cli_captured(["status", *port])
    require(code == cli.EXIT_VALID and status.startswith(
        "── checker service") and "launches:" in status,
        f"service: cli status exited {code}: {status!r}")
    code, top = run_cli_captured(["top", "--once", *port])
    require(code == cli.EXIT_VALID and "last 60s:" in top
            and "── verdicts" in top and "(no settled verdicts yet)"
            not in top, f"service: cli top exited {code}: {top!r}")
    prof_dir = os.path.join(tmp, "profile")
    code, prof = run_cli_captured(["profile", *port, "--seconds", "1",
                                   "--label", "chip-smoke", "--dir",
                                   prof_dir])
    require(code == cli.EXIT_VALID and prof.startswith(
        f"profile capture → {prof_dir}")
        and os.path.exists(os.path.join(prof_dir, "profile.json")),
        f"service: cli profile exited {code}: {prof!r}")
    emit(phase="service", step="cli", status=status.splitlines(),
         top=top.splitlines(), profile=prof.splitlines(),
         seconds=time.perf_counter() - t0, card=card)


# ---------------------------------------------------------------------------
# online checking (phase 25) and the fleet (phase 26)
# ---------------------------------------------------------------------------

#: phase 25: phase 4's histories fed in deltas of 16; the op-mode delta of
#: the reference's live shipper (jepsen_tpu/interpreter.py:37); the part of
#: phase 8's corpus fed on the frontier route (its 8 crash-heavy histories
#: added)
FEED_HISTORIES, FEED_DELTA_HISTORIES = 256, 16
FEED_OP_BATCH = 64
FEED_FRONTIER_ROWS = 64
#: phase 26: the feed session sent through the router
FLEET_FEED_HISTORIES = 64
FLEET_MEMBERS = 2


class Watcher:
    """A ``/watch`` subscriber on a thread: :attr:`events` gathers
    ``(arrival, offset, row)``; the thread ends when the daemon closes the
    stream (at its drain)."""

    def __init__(self, client, last_id: int):
        self.events: list = []
        self.error = None
        self.thread = threading.Thread(target=self._run,
                                       args=(client, last_id), daemon=True)
        self.thread.start()

    def _run(self, client, last_id):
        try:
            for off, row in client.watch(last_id=last_id, timeout=900):
                self.events.append((time.perf_counter(), off, row))
        except Exception as e:  # noqa: BLE001 — the phase checks it
            self.error = repr(e)

    def first_violation(self, sid: str, wait_s: float = 60.0):
        """The first ``valid? = false`` event of session ``sid`` to arrive,
        waiting up to ``wait_s`` for one; None when none came."""
        deadline = time.monotonic() + wait_s
        while True:
            for ev in list(self.events):
                if ev[2]["req"] == sid and \
                        ev[2]["result"].get("valid?") is False:
                    return ev
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.05)


def prom_value(text: str, name: str):
    """The sum of a metric's samples (over its labels) in Prometheus text,
    or None when it has none."""
    values = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
              if line.startswith((name + " ", name + "{"))]
    return sum(values) if values else None


def feed_phase(card, client, model, hs, results, f_hs, f_results):
    """Phase 25: online checking on phase 24's daemon.  Returns the
    :class:`Watcher`, which must end when phase 24 drains the daemon."""
    t_phase = time.perf_counter()
    st0 = client.status()
    require(st0["wal_path"], "feed: phase 24's daemon has no WAL")
    # from the WAL's current tail: only this phase's verdicts
    watcher = Watcher(client, st0["wal_rows"] - 1)

    # -- whole histories: 256 of phase 4's in deltas of 16 ------------------
    sel = list(range(FEED_HISTORIES))
    session = client.open_feed(model, {"slot_cap": 8})
    sent = []
    t0 = time.perf_counter()
    for k in range(0, len(sel), FEED_DELTA_HISTORIES):
        sent.append(time.perf_counter())
        session.append(histories=hs[k:k + FEED_DELTA_HISTORIES],
                       t_inv=time.time())
    feed_s = time.perf_counter() - t0
    ev = watcher.first_violation(session.sid)
    t_close = time.perf_counter()
    require(ev is not None and ev[0] < t_close,
            "feed: no violation reached /watch before the close")
    out = session.close()
    st1 = client.status()
    require(out == [results[i] for i in sel],
            "feed: the close results differ from phase 4's")
    metrics = client.metrics_text()
    lag_n = prom_value(metrics, "jepsen_feed_ingest_lag_seconds_count")
    lag_mean = prom_value(metrics, "jepsen_feed_ingest_lag_seconds_sum") \
        / lag_n
    k1 = daemon_delta(st1, st0).get("dense/register", 0)
    require(k1 > 0, "feed: K1 never launched in the daemon")
    first = ev[2]["idx"]
    emit(phase="feed", step="histories", histories=len(sel),
         deltas=len(sent), seconds=feed_s,
         histories_per_s=len(sel) / feed_s,
         first_violation_history=first,
         first_violation_to_watch_s=ev[0] - sent[first
                                                // FEED_DELTA_HISTORIES],
         ingest_lag_mean_s=lag_mean, ingest_lag_observations=lag_n,
         k1_launches=k1, card=card)

    # -- raw op events of one corrupted history, 64 a delta ------------------
    bad = next(i for i in sel if results[i]["valid?"] is False
               and results[i]["engine"] == "gpu")
    ops = hs[bad].to_dicts()
    session = client.open_feed(model, {"slot_cap": 8})
    laps = []
    for k in range(0, len(ops), FEED_OP_BATCH):
        t0 = time.perf_counter()
        session.append(ops=ops[k:k + FEED_OP_BATCH], t_inv=time.time())
        laps.append(time.perf_counter() - t0)
    ev = watcher.first_violation(session.sid)
    t_close = time.perf_counter()
    require(ev is not None and ev[0] < t_close,
            "feed: the op-mode violation never reached /watch before the "
            "close")
    out = session.close()
    require(out == [results[bad]],
            f"feed: op mode says {out}, phase 4 said {results[bad]}")
    emit(phase="feed", step="ops", history=bad, ops=len(ops),
         deltas=len(laps), first_delta_s=laps[0], last_delta_s=laps[-1],
         seconds=sum(laps), first_violating_delta=ev[2]["idx"],
         failed_event=results[bad].get("failed-event"), card=card)

    # -- the frontier route: part of phase 8's corpus ------------------------
    pick = list(range(FEED_FRONTIER_ROWS)) + \
        list(range(len(f_hs) - 8, len(f_hs)))
    st_a = client.status()
    session = client.open_feed(model)
    t0 = time.perf_counter()
    for k in range(0, len(pick), FEED_DELTA_HISTORIES):
        session.append(histories=[f_hs[i] for i in
                                  pick[k:k + FEED_DELTA_HISTORIES]],
                       t_inv=time.time())
    out = session.close()
    f_s = time.perf_counter() - t0
    st_b = client.status()
    require(out == [f_results[i] for i in pick],
            "feed: frontier results differ from phase 8's")
    f_delta = daemon_delta(st_b, st_a)
    rungs = {k: v - st_a["escalations"].get(k, 0)
             for k, v in st_b["escalations"].items()
             if v - st_a["escalations"].get(k, 0)}
    require(f_delta.get("frontier_search", 0) > 0,
            "feed: K4 never launched in the daemon")
    require(rungs, "feed: no escalation rung ran in the daemon")
    emit(phase="feed", step="frontier", histories=len(pick), seconds=f_s,
         launches=f_delta, escalations=rungs,
         batch_stats=wgl.batch_stats(out), card=card)

    st = client.status()
    counts = {k: st[k] - st0[k] for k in ("feed_sessions", "feed_deltas",
                                          "feed_histories", "watch_events")}
    want = {"feed_sessions": 3,
            "feed_deltas": len(sent) + len(laps)
            + -(-len(pick) // FEED_DELTA_HISTORIES),
            "feed_histories": len(sel) + len(laps) + len(pick)}
    require(st["feed_open"] == 0, f"feed: {st['feed_open']} sessions open")
    require(all(counts[k] == v for k, v in want.items()),
            f"feed: /status counted {counts}, the phase sent {want}")
    require(st["watch_subscribers"] == 1,
            f"feed: {st['watch_subscribers']} /watch subscribers")
    emit(phase="feed", step="status", feed_open=st["feed_open"],
         watch_subscribers=st["watch_subscribers"], watch_events_seen=len(
             watcher.events), live=st["live"],
         phase_seconds=time.perf_counter() - t_phase, **counts, card=card)
    return watcher


def free_port_run(n: int) -> int:
    """A port P with P … P + n - 1 all free right now."""
    from jepsen_tpu_torch.serve import client as serve_client

    for _ in range(100):
        port = serve_client.free_port()
        try:
            for i in range(1, n):
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", port + i))
            return port
        except OSError:
            continue
    raise RuntimeError("chip_smoke: no run of free ports")


def start_fleet(fleet: dict) -> None:
    """``python -m jepsen_tpu_torch.cli serve --checker --supervise --fleet
    2`` on the card, its WALs and log in a directory under ``build/``,
    described in ``fleet``; a thread notes there when both members first
    answer ``/healthz``."""
    import tempfile

    from jepsen_tpu_torch.serve import client as serve_client

    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_", dir="build")
    port = free_port_run(FLEET_MEMBERS)
    with open(os.path.join(root, "fleet.log"), "ab") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch.cli", "serve",
             "--checker", "--supervise", "--fleet", str(FLEET_MEMBERS),
             "--port", str(port), "--wal", os.path.join(root, "wal.jsonl")],
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
    fleet.update(proc=proc, port=port, root=root, t0=time.perf_counter(),
                 ready_s=None)

    def note_ready():
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and proc.poll() is None:
            if all(serve_client.probe_healthz(f"127.0.0.1:{port + i}")
                   for i in range(FLEET_MEMBERS)):
                fleet["ready_s"] = time.perf_counter() - fleet["t0"]
                return
            time.sleep(0.1)

    threading.Thread(target=note_ready, daemon=True).start()


def stop_fleet(fleet: dict) -> None:
    """Stop the supervisor and its members (the whole process group) if
    still running, and remove the fleet's directory."""
    import shutil

    proc = fleet.get("proc")
    if proc is not None and proc.poll() is None:
        for sig in (signal.SIGTERM, signal.SIGKILL):
            try:
                os.killpg(proc.pid, sig)
                proc.wait(timeout=30)
                break
            except (ProcessLookupError, subprocess.TimeoutExpired):
                continue
    if fleet.get("root"):
        shutil.rmtree(fleet["root"], ignore_errors=True)


def check_key(model, hs, opts) -> str:
    """The router's key of a ``/check`` of ``hs`` (what it derives from the
    body, without building one)."""
    from jepsen_tpu_torch.serve import protocol, router

    return router.check_route_key({"model": protocol.model_to_wire(model),
                                   "opts": dict(opts), "histories": hs})


def start_router(members):
    """``cli route`` over ``members`` on a thread of this process (probes
    only when asked: the weights stay put while the phase predicts each
    key's member).  Returns the :class:`Router` the command built, its
    thread and a box that gets the command's exit code."""
    from jepsen_tpu_torch.serve import client as serve_client
    from jepsen_tpu_torch.serve import router as router_mod

    built = []

    class Noted(router_mod.Router):
        def start(self, block=True):
            built.append(self)
            return super().start(block)

    port = serve_client.free_port()
    box: dict = {}
    argv = ["route", "--port", str(port), "--probe-interval", "3600"]
    for m in members:
        argv += ["--member", m]
    plain_router = router_mod.Router
    router_mod.Router = Noted
    try:
        # not captured: redirecting stdout on this thread would take the
        # main thread's lines for the command's whole life
        t = threading.Thread(target=lambda: box.update(
            code=cli.run_cli(cli.default_commands(), argv)), daemon=True)
        t.start()
        deadline = time.monotonic() + 60
        while not (built and serve_client.probe_healthz(
                f"127.0.0.1:{port}")):
            require(t.is_alive() and time.monotonic() < deadline,
                    f"fleet: cli route did not come up ({box})")
            time.sleep(0.05)
    finally:
        router_mod.Router = plain_router
    return built[0], t, box


def fleet_phase(card, fleet, model, hs, results, f_hs, f_results, la_hs,
                device):
    """Phase 26: a supervised fleet of two daemons on the card behind
    ``cli route``."""
    from jepsen_tpu_torch import serve
    from jepsen_tpu_torch.elle import list_append as elle_la
    from jepsen_tpu_torch.serve import router as router_mod

    t_phase = time.perf_counter()
    proc, port = fleet["proc"], fleet["port"]
    members = [f"127.0.0.1:{port + i}" for i in range(FLEET_MEMBERS)]
    mclients = {m: serve.ServiceClient(port=port + i)
                for i, m in enumerate(members)}
    deadline = time.monotonic() + 300
    while fleet["ready_s"] is None:
        require(proc.poll() is None,
                f"fleet: the supervisor exited {proc.returncode}")
        require(time.monotonic() < deadline,
                "fleet: the members did not answer /healthz in 300 s")
        time.sleep(0.1)
    sts = {m: c.status() for m, c in mclients.items()}
    require(all(st["platform"] == ("gpu" if device.type == "cuda" else
                                   device.type) for st in sts.values()),
            f"fleet: members on {[st['device'] for st in sts.values()]}")
    emit(phase="fleet", step="ready", members=members,
         ready_s=fleet["ready_s"], pids=[st["pid"] for st in sts.values()],
         wal_paths=[st["wal_path"] for st in sts.values()], card=card)

    def statuses():
        return {m: c.status() for m, c in mclients.items()}

    def launches(st1, st0, name):
        return sum(daemon_delta(st1[m], st0[m]).get(name, 0)
                   for m in members)

    code, table = run_cli_captured(["status", "--port", str(port),
                                    "--daemon", members[1]])
    require(code == cli.EXIT_VALID and table.startswith("── fleet")
            and all(m in table for m in members)
            and "unreachable" not in table,
            f"fleet: cli status exited {code}: {table!r}")
    router, router_thread, router_box = start_router(members)
    try:
        require(router.probe_once() == FLEET_MEMBERS,
                "fleet: the router's probe found a member down")
        small = hs[-8:]
        require(check_key(model, small, {"slot_cap": 8})
                == router_mod.check_route_key(serve.protocol.decode_body(
                    serve.protocol.check_request(model, small,
                                                 {"slot_cap": 8}))),
                "fleet: the smoke's route key differs from the router's")

        # -- phase 4's corpus as four requests at once ---------------------
        quarter = -(-len(hs) // 4)
        parts = [hs[i:i + quarter] for i in range(0, len(hs), quarter)]
        keys = [check_key(model, p, {"slot_cap": 8}) for p in parts]
        owners = [router._candidates(k)[0] for k in keys]
        got = [None] * len(parts)
        errors = []

        def send(i):
            try:
                got[i] = serve.ServiceClient(port=router.port).check_batch(
                    model, parts[i], slot_cap=8)
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(repr(e))

        st0 = statuses()
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(parts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check_s = time.perf_counter() - t0
        st1 = statuses()
        require(not errors, f"fleet: routed /check errors {errors}")
        require([r for g in got for r in g] == results,
                "fleet: routed results differ from phase 4's")
        moved = {m: st1[m]["requests"] - st0[m]["requests"] for m in members}
        require(moved == {m: owners.count(m) for m in members},
                f"fleet: requests reached {moved}, the router ranked "
                f"{owners} first")
        k1 = launches(st1, st0, "dense/register")
        require(k1 > 0, "fleet: K1 never launched in the members")
        emit(phase="fleet", step="check", requests=len(parts),
             histories=len(hs), seconds=check_s,
             histories_per_s=len(hs) / check_s, ranked_first=owners,
             requests_by_member=moved, k1_launches=k1, card=card)

        def routed(step, key, counter, call):
            """One request through the router: it must reach the member
            the router ranks first for ``key``."""
            owner = router._candidates(key)[0]
            st0 = statuses()
            t0 = time.perf_counter()
            out = call()
            secs = time.perf_counter() - t0
            st1 = statuses()
            moved = {m: st1[m][counter] - st0[m][counter] for m in members}
            require(moved == {m: int(m == owner) for m in members},
                    f"fleet {step}: {counter} moved {moved}, the router "
                    f"ranked {owner} first")
            return out, secs, owner, st1, st0

        # -- phase 8's frontier rows --------------------------------------
        fpick = list(range(FEED_FRONTIER_ROWS)) + \
            list(range(len(f_hs) - 8, len(f_hs)))
        fh = [f_hs[i] for i in fpick]
        client = serve.ServiceClient(port=router.port)
        out, secs, owner, st1, st0 = routed(
            "frontier", check_key(model, fh, {}), "requests",
            lambda: client.check_batch(model, fh))
        require(out == [f_results[i] for i in fpick],
                "fleet: routed frontier results differ from phase 8's")
        k4 = launches(st1, st0, "frontier_search")
        require(k4 > 0, "fleet: K4 never launched in the members")
        emit(phase="fleet", step="frontier", histories=len(fh),
             seconds=secs, member=owner, k4_launches=k4, card=card)

        # -- phase 16's list-append graphs through /elle -------------------
        opts = {"workload": "list-append",
                "consistency-models": ["strict-serializable"]}
        encs = [elle_encode.encode_graph(elle_la.prepare(h, opts)[0])
                for h in la_hs]
        key = router_mod.elle_route_key(
            {"graphs": [{"rel": [0] * len(e.rel)} for e in encs]})
        via, secs, owner, st1, st0 = routed(
            "elle", key, "elle_requests", lambda: client.screen_graphs(encs))
        local = cycles.screen_graphs(encs, device=device)
        for i, (a, b) in enumerate(zip(via, local)):
            require((a is None) == (b is None)
                    and (a is None
                         or (sorted(a.members) == sorted(b.members)
                             and all((a.members[m] == b.members[m]).all()
                                     for m in a.members)
                             and sorted(a.walks) == sorted(b.walks)
                             and all((a.walks[q] == b.walks[q]).all()
                                     for q in a.walks))),
                    f"fleet: graph {i}'s routed screens differ")
        k7 = launches(st1, st0, "cycles_screen")
        require(k7 > 0, "fleet: K7 never launched in the members")
        emit(phase="fleet", step="elle", graphs=len(encs), seconds=secs,
             member=owner, k7_launches=k7, card=card)

        # -- a feed session, pinned to the member that opened it -----------
        fkey = json.dumps(["feed", serve.protocol.model_to_wire(model),
                           {"slot_cap": 8}], sort_keys=True, default=repr)
        owner = router._candidates(fkey)[0]
        st0 = statuses()
        t0 = time.perf_counter()
        session = client.open_feed(model, {"slot_cap": 8})
        pinned = router._pins.get(session.sid)
        for k in range(0, FLEET_FEED_HISTORIES, FEED_DELTA_HISTORIES):
            session.append(histories=hs[k:k + FEED_DELTA_HISTORIES],
                           t_inv=time.time())
        out = session.close()
        secs = time.perf_counter() - t0
        st1 = statuses()
        n_deltas = FLEET_FEED_HISTORIES // FEED_DELTA_HISTORIES
        require(out == results[:FLEET_FEED_HISTORIES],
                "fleet: the routed feed's results differ from phase 4's")
        deltas = {m: st1[m]["feed_deltas"] - st0[m]["feed_deltas"]
                  for m in members}
        require(pinned == owner and deltas == {
            m: n_deltas * (m == owner) for m in members},
            f"fleet: the session opened on {pinned} (ranked {owner}), its "
            f"deltas reached {deltas}")
        emit(phase="fleet", step="feed", histories=FLEET_FEED_HISTORIES,
             deltas=n_deltas, seconds=secs, member=pinned,
             deltas_by_member=deltas, card=card)

        # -- SIGKILL the first quarter's member with its request in flight --
        victim = owners[0]
        sibling = next(m for m in members if m != victim)
        vst = mclients[victim].status()
        reg = obs.registry()

        def rerouted():
            return sum(reg.value(n, member=victim) or 0 for n in (
                "jepsen_route_reroutes_total",
                "jepsen_route_spillover_total"))

        before = rerouted()
        sent = threading.Event()

        def noting_send(member, path, body):
            if member == victim and path == "/check":
                sent.set()
            return router_mod.Router._send(router, member, path, body)

        router._send = noting_send
        box = {}

        def send_first():
            try:
                box["out"] = serve.ServiceClient(
                    port=router.port).check_batch(model, parts[0],
                                                  slot_cap=8)
            except Exception as e:  # noqa: BLE001 — re-raised below
                box["error"] = repr(e)

        sib0 = mclients[sibling].status()["requests"]
        t = threading.Thread(target=send_first)
        t0 = time.perf_counter()
        t.start()
        require(sent.wait(300), "fleet: the request never left the router")
        time.sleep(0.25)  # the member is reading or decoding the body
        os.kill(vst["pid"], signal.SIGKILL)
        t_kill = time.perf_counter()
        t.join(timeout=600)
        rerouted_s = time.perf_counter() - t0
        del router._send
        require("error" not in box, f"fleet: {box.get('error')}")
        require(box.get("out") == results[:len(parts[0])],
                "fleet: the rerouted request's results differ from phase 4's")
        require(mclients[sibling].status()["requests"] == sib0 + 1,
                "fleet: the killed member's request did not reach its "
                "sibling")
        require(rerouted() > before, "fleet: the router counted no reroute")
        deadline = time.monotonic() + 300
        while True:
            if mclients[victim].healthy():
                vst2 = mclients[victim].status()
                if vst2["pid"] != vst["pid"]:
                    break
            require(proc.poll() is None,
                    f"fleet: the supervisor exited {proc.returncode}")
            require(time.monotonic() < deadline,
                    "fleet: the killed member was not restarted in 300 s")
            time.sleep(0.1)
        restart_s = time.perf_counter() - t_kill
        require(vst2["wal_path"] == vst["wal_path"],
                f"fleet: restarted on WAL {vst2['wal_path']}, not "
                f"{vst['wal_path']}")
        require(router.probe_once() == FLEET_MEMBERS and all(
            m["up"] for m in router.status()["members"]),
            "fleet: the restarted member is not marked up")
        out, secs, owner, _, _ = routed(
            "after restart", keys[0], "requests",
            lambda: client.check_batch(model, parts[0], slot_cap=8))
        require(owner == victim and out == results[:len(parts[0])],
                "fleet: the key's next request did not return to its member")
        emit(phase="fleet", step="kill", member=victim, sibling=sibling,
             killed_pid=vst["pid"], restarted_pid=vst2["pid"],
             wal_path=vst2["wal_path"], rerouted_request_s=rerouted_s,
             reroutes=rerouted() - before, restart_to_healthz_s=restart_s,
             next_request_s=secs, card=card)

        # -- drain both members and the router through the CLI; the
        # supervisor and the route command exit 0 --------------------------
        code, out = run_cli_captured(["shutdown", "--port", str(port),
                                      "--daemon", members[1]])
        require(code == cli.EXIT_VALID and out.count("draining") == 2,
                f"fleet: cli shutdown exited {code}: {out!r}")
        rc = proc.wait(timeout=300)
        require(rc == 0, f"fleet: the supervisor exited {rc}")
        code, out = run_cli_captured(["shutdown", "--port",
                                      str(router.port)])
        require(code == cli.EXIT_VALID, f"fleet: the router's cli shutdown "
                f"exited {code}")
        router_thread.join(timeout=60)
        require(not router_thread.is_alive()
                and router_box.get("code") == cli.EXIT_VALID,
                f"fleet: cli route ended with {router_box}")
    finally:
        if router_thread.is_alive():
            router.stop()
            router_thread.join(timeout=60)
    require(not client.healthy(), "fleet: the router still answers")
    emit(phase="fleet", step="drain", exit_code=rc, fleet_table=
         table.splitlines(), phase_seconds=time.perf_counter() - t_phase,
         card=card)


# ---------------------------------------------------------------------------
# the tuner (phase 23)
# ---------------------------------------------------------------------------


def verdict_tuple(r: dict) -> tuple:
    return (r["valid?"], r.get("failed-event"), r.get("kernel"),
            r.get("engine"))


#: the wrappers of the kernels on the tuner's path, by table row
TUNER_KERNELS = {
    "K1": lambda: dense.DENSE_AUTOMATON,
    "K1m": lambda: dense.DENSE_KERNELS["multi-register"],
    "K4": lambda: wgl.FRONTIER_SEARCH,
    "K7": lambda: cycles.SCREEN,
}


def dense_dispatches() -> float:
    reg = obs.registry()
    return sum(reg.value("jepsen_kernel_dispatches_total", engine="dense",
                         phase=p) or 0 for p in ("compile", "execute"))


def tuning_phase(card, model, hs, results):
    """Phase 23: the probe, the smoke tuner on the card, phase 4's corpus
    tuned against untuned, then journalled and drift-scored."""
    import tempfile

    t0 = time.perf_counter()
    ok, probe_err = platform_mod.probe_accelerator()
    require(ok, f"the CUDA probe failed: {probe_err}")
    probe_s = time.perf_counter() - t0
    kind = torch.cuda.get_device_name()
    want = [verdict_tuple(r) for r in results]
    defaults = {"window": execution.DEFAULT_WINDOW,
                "flush_rows": planning.DEFAULT_FLUSH_ROWS,
                "row_bucket": execution.ROW_BUCKET,
                "closure_mode": cycles.DEFAULT_CLOSURE_MODE}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        before = {k: w().launches for k, w in TUNER_KERNELS.items()}
        # the tuner through the CLI's ``tune``, which also activates the
        # fresh artifact in this process (reset below)
        try:
            code, out = run_cli_captured([
                "tune", "--out", os.path.join(tmp, "calibration.json"),
                "--profile", "smoke"])
        finally:
            tune.use(None)
        require(code == 0, f"cli tune exited {code}")
        line = json.loads(out.strip().splitlines()[-1])
        path = line["path"]
        with open(path) as f:
            data = json.load(f)
        require(line["calibration"] == data["calibration_id"],
                "cli tune's line names another artifact")
        tuner_launches = {k: w().launches - before[k]
                          for k, w in TUNER_KERNELS.items()}
        sweep = data["sweep"]
        require(data["device_kind"] == kind,
                f"the artifact is keyed to {data['device_kind']!r}, not the "
                f"card's {kind!r}")
        require(sweep["budget_checks"] > 0 and sweep["budget_breaches"] == 0,
                f"budget checks {sweep['budget_checks']}, breaches "
                f"{sweep['budget_breaches']}")
        require(data["cost_table"], "the smoke tuner measured no cost point")
        require(all(tuner_launches[k] > 0 for k in ("K1", "K4", "K7")),
                f"the tuner's path missed a kernel: {tuner_launches}")
        emit(phase="tuning", step="tune", probe_ok=ok, probe_s=probe_s,
             device_kind=data["device_kind"], n_devices=data["n_devices"],
             calibration=data["calibration_id"], params=data["params"],
             defaults=defaults, measured_configs=sweep["measured_configs"],
             trail=sweep["trail"], budget_checks=sweep["budget_checks"],
             budget_breaches=sweep["budget_breaches"],
             tune_wall_s=sweep["wall_s"], launches=tuner_launches,
             cost_table=data["cost_table"], card=card)

        tune.use(path)  # vetted against the card and the code
        try:
            cal = tune.active()
            require(cal is not None
                    and cal.calibration_id == data["calibration_id"],
                    "the tuned artifact did not load")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tuned = wgl.check_batch(model, hs, slot_cap=8)
            tuned_s = time.perf_counter() - t1
            differ = [i for i, r in enumerate(tuned)
                      if verdict_tuple(r) != want[i]]
            require(not differ, f"tuned verdicts differ from phase 4's at "
                    f"{differ[:8]}")
            emit(phase="tuning", step="tuned_vs_untuned",
                 histories=len(hs), seconds=tuned_s,
                 histories_per_s=len(hs) / tuned_s, equal=True, card=card)

            jpath = os.path.join(tmp, "dispatch-journal.jsonl")
            obs.enable(reset=True)
            obs_journal.configure(jpath)
            sentinel = obs_drift.configure()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            journalled = wgl.check_batch(model, hs, slot_cap=8)
            journal_s = time.perf_counter() - t1
            require([verdict_tuple(r) for r in journalled] == want,
                     "journalled verdicts differ from phase 4's")
            rows = list(obs_journal.read_rows(jpath, strict=True))
            dispatches = dense_dispatches()
            require(len(rows) == dispatches > 0,
                    f"{len(rows)} journal rows for {dispatches} dispatches")
            require(all(obs_journal.validate_row(r) for r in rows),
                    "a journal row fails the schema")
            require(all(r["cache"] == "hit" and r["execute_s"] > 0
                        and r["compile_s"] == 0 for r in rows),
                    "a journal row's cost is not on execute_s")
            require(all(r["calibration"] == cal.calibration_id
                        for r in rows), "a journal row names no calibration")
            snap = sentinel.snapshot()
            require(snap["rows_scored"] == len(rows),
                    f"the sentinel scored {snap['rows_scored']} of "
                    f"{len(rows)} rows")
            emit(phase="tuning", step="journal", rows=len(rows),
                 dispatches=dispatches, seconds=journal_s,
                 rows_per_dispatch=[r["rows"] for r in rows],
                 execute_s=[r["execute_s"] for r in rows],
                 retune_recommended=tune.retune_recommended(),
                 drift=snap, card=card)
        finally:
            obs_journal.configure(None)
            obs_drift.disable()
            tune.use(None)


# ---------------------------------------------------------------------------
# the chaos drills (phase 27) and the kernel audit's card half (28)
# ---------------------------------------------------------------------------

#: phase 27's full-width traffic in drills 1 and 5
CHAOS_DENSE_HISTORIES, CHAOS_FRONTIER_HISTORIES = 256, 64


def chaos_phase(card, hs, f_hs):
    """Phase 27: the five drills of ``serve.chaos`` against daemons on the
    card; drills 1 and 5 carry phase 4's and phase 8's histories."""
    import shutil

    from jepsen_tpu_torch.serve import chaos

    root = os.path.join("build", "chip_smoke_chaos")
    shutil.rmtree(root, ignore_errors=True)
    out = chaos.run(device=None, drills=sorted(chaos.DRILLS),
                    heavy={"dense": hs[:CHAOS_DENSE_HISTORIES],
                           "frontier": f_hs[:CHAOS_FRONTIER_HISTORIES]},
                    tmp=root, log=lambda line: None)
    k1 = k4 = 0
    for r in out["drills"]:
        launches = r["launches"]
        k1 += launches.get("dense/register", 0)
        k4 += launches.get(wgl.FRONTIER_SEARCH.name, 0)
        emit(phase="chaos", drill=r["drill"], name=r["name"], ok=r["ok"],
             gates=r["gates"], failures=r["failures"],
             counters=r["counters"], seconds=r["seconds"],
             k1_launches=launches.get("dense/register", 0),
             k4_launches=launches.get(wgl.FRONTIER_SEARCH.name, 0),
             launches=launches, card=card)
        require(r["ok"], f"chaos drill {r['drill']} ({r['name']}) failed: "
                f"{r['failures']} (daemon logs under {root})")
    require(k1 > 0 and k4 > 0,
            f"the drills' daemons launched K1 {k1} and K4 {k4} times")
    emit(phase="chaos_summary", drills=len(out["drills"]),
         gates=sum(r["gates"] for r in out["drills"]),
         seconds=out["seconds"], k1_launches=k1, k4_launches=k4,
         dense_histories=CHAOS_DENSE_HISTORIES,
         frontier_histories=CHAOS_FRONTIER_HISTORIES, card=card)
    shutil.rmtree(root, ignore_errors=True)


def audit_phase(card, report, device):
    """Phase 28: ``kernel-resources`` on phase 1's ptxas reports, then the
    measured half of ``kernel-budget``; any finding raises."""
    from jepsen_tpu_torch.lint import core as lint_core

    t0 = time.perf_counter()
    logs = {name: r["ptxas"] for name, r in report.items()}
    require(all(logs.values()),
            f"phase 1 has no ptxas report for "
            f"{[n for n, v in logs.items() if not v]}")
    contracts = {}
    for path in _build.SOURCES.values():
        for name, _, contract, _ in kernel_audit.cuda_globals(
                path.read_text()):
            contracts[name] = contract
    table = kernel_audit.ptxas_table(logs, contracts)
    for row in table:
        emit(phase="kernel_resources", **row, card=card)
    res = lint_core.lint_paths(
        [os.path.dirname(_build.__file__)],
        rules=["kernel-resources", "kernel-coverage"],
        options={"ptxas_logs": logs})
    require(not res.findings, "kernel audit: " + "; ".join(
        f.render() for f in res.findings))
    rows, findings = kernel_audit.measure_budgets(device)
    for row in rows:
        emit(phase="kernel_budget", **row, card=card)
    require(not findings, "kernel audit: " + "; ".join(
        f.message for f in findings))
    emit(phase="kernel_audit", functions=len(contracts),
         instances=len(table), budget_rows=len(rows),
         findings=0, seconds=time.perf_counter() - t0, card=card)


# ---------------------------------------------------------------------------
# the test harness (phase 29)
# ---------------------------------------------------------------------------

#: phase 29's cluster and run: the reference's in-process smoke
#: (``python -m jepsen_tpu.cli test --workload linearizable-register
#: --time-limit 10``) on 5 nodes at 3n workers
HARNESS_NODES = "n1,n2,n3,n4,n5"
HARNESS_SECONDS, HARNESS_FAULT_SECONDS = 10, 5


def plain_per_key(history, test) -> dict:
    """Every key's result by the plain versions on the CPU, as JSON
    gives it back (string keys)."""
    plain = independent.batched_linearizable(
        models.cas_register(), device="cpu").check(
            {**test, "store?": False}, history, {})
    return json.loads(json.dumps(plain["results"], default=repr))


def harness_run_stats(results: dict, history_len: int, keys: int) -> dict:
    """The phase's figures from a run's ``results["obs"]`` phase rows and
    the batched lift's per-key artifact span: ops recorded, keys, ops/s
    over the generator phase, and the analysis, artifact and store
    seconds."""
    phases = {r["name"]: r["wall_s"]
              for r in (results.get("obs") or {}).get("phases", [])}
    artifacts = sum(rec.duration_s() for rec in obs.tracer().finished(
        cat="checker") if rec.name == "independent/artifacts"
        and rec.t1 is not None)
    run_s = phases.get("generator")
    return {"ops": history_len, "keys": keys, "generator_s": run_s,
            "ops_per_s": history_len / run_s if run_s else None,
            "analysis_s": phases.get("analyze"),
            "key_artifacts_s": artifacts,
            "save_history_s": phases.get("save-history")}


class StaleCrashingClient(fake.KeyedAtomClient):
    """Phase 29c's client: the keyed CAS-register fake, but it crashes
    before applying every 11th invoke (an ``:info`` op, a retired
    process) and answers every 97th read with a value other than the
    register's."""

    CRASH_EVERY, STALE_EVERY = 11, 97

    def __init__(self, registers=None, latency: float = 0.0, shared=None):
        super().__init__(registers, latency)
        self.shared = shared if shared is not None else {
            "n": 0, "lock": threading.Lock()}

    def open(self, test, node):
        c = StaleCrashingClient(self.registers, self.latency, self.shared)
        c.lock = self.lock
        return c

    def invoke(self, test, op):
        with self.shared["lock"]:
            self.shared["n"] += 1
            n = self.shared["n"]
        if n % self.CRASH_EVERY == 0:
            raise RuntimeError("crashed before applying")
        res = super().invoke(test, op)
        if op["f"] == "read" and n % self.STALE_EVERY == 0:
            k, v = res["value"]
            res = {**res, "value": independent.kv(k, ((v or 0) + 1) % 5)}
        return res


class StartStopNemesis(nemesis_mod.Nemesis):
    """An in-process fault: start and stop flip a flag (no network)."""

    def __init__(self):
        self.active = False

    def invoke(self, test, op):
        self.active = op["f"] == "start"
        return {**op, "type": "info", "value": self.active}

    def fs(self):
        return {"start", "stop"}


def harness_phase(card):
    """Phase 29: the CLI's ``test`` and ``analyze`` and ``core.run`` under
    faults, each checked on the card and held against the plain
    versions on the history it recorded."""
    import contextlib
    import glob
    import io
    import shutil

    root = os.path.join("build", "chip_smoke_harness")
    shutil.rmtree(root, ignore_errors=True)
    base = os.path.join(root, "store")
    name = "linearizable-register"

    # -- 29a. the CLI's test --------------------------------------------------
    dense.DENSE_AUTOMATON.launches = 0
    wgl.FRONTIER_SEARCH.launches = 0
    t0 = time.perf_counter()
    code = cli.run_cli(cli.default_commands(), [
        "test", "--workload", name, "--nodes", HARNESS_NODES,
        "--concurrency", "3n", "--time-limit", str(HARNESS_SECONDS),
        "--store-base", base])
    cli_s = time.perf_counter() - t0
    k1, k4 = dense.DENSE_AUTOMATON.launches, wgl.FRONTIER_SEARCH.launches
    require(code == cli.EXIT_VALID, f"harness: cli test exited {code}")
    require(k1 > 0, "harness: the CLI's run never launched K1")
    [run_dir] = [d for d in glob.glob(os.path.join(base, name, "2*"))
                 if not os.path.islink(d)]
    with open(os.path.join(run_dir, "results.json")) as f:
        results = json.load(f)
    lin = results["linearizable"]
    keys = len(lin["results"])
    require(results["valid?"] is True, "harness: the CLI's run is not valid")
    require(lin["batch-stats"]["engines"] == {"gpu": keys},
            f"harness: keys off the gpu engine: {lin['batch-stats']}")
    t0 = time.perf_counter()
    stored = store_mod.load({"name": name, "start-time":
                             os.path.basename(run_dir), "store-base": base})
    load_s = time.perf_counter() - t0
    require(not stored.get("recovered"), "harness: the store was torn")
    t0 = time.perf_counter()
    plain = plain_per_key(stored["history"], stored)
    plain_s = time.perf_counter() - t0
    require(plain == lin["results"],
            "harness: a key's card result differs from its plain version's")
    stats = harness_run_stats(results, len(stored["history"]), keys)
    emit(phase="harness_cli", code=code, seconds=cli_s, **stats,
         load_s=load_s, plain_s=plain_s, k1_launches=k1, k4_launches=k4,
         kernels=lin["batch-stats"]["kernels"], card=card)

    # -- 29b. analyze, from the store alone ----------------------------------
    dense.DENSE_AUTOMATON.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = cli.run_cli(cli.default_commands(), [
            "analyze", "--test-name", name, "--store-base", base])
    analyze_s = time.perf_counter() - t0
    again = json.loads(out.getvalue())
    k1 = dense.DENSE_AUTOMATON.launches
    require(code == cli.EXIT_VALID, f"harness: cli analyze exited {code}")
    require(k1 > 0, "harness: analyze never launched K1")
    require(again["linearizable"]["batch-stats"]["engines"] == {"gpu": keys},
            f"harness: analyze's keys off the gpu engine: "
            f"{again['linearizable']['batch-stats']}")
    require(again["linearizable"]["results"] == lin["results"],
            "harness: analyze's per-key results differ from the run's")
    emit(phase="harness_analyze", code=code, seconds=analyze_s, keys=keys,
         k1_launches=k1, card=card)

    # -- 29c. core.run with crashes, stale reads and a nemesis --------------
    wl = workloads.workload(name, {"nodes": HARNESS_NODES.split(","),
                                   "concurrency": "3n",
                                   "per-key-limit": 32})
    faults = nemesis_mod.validate(nemesis_mod.f_map(
        lambda f: f"fault-{f}", StartStopNemesis()))
    g = harness_gen.time_limit(HARNESS_FAULT_SECONDS, harness_gen.any(
        wl["generator"], harness_gen.nemesis(harness_gen.delay(1.0, (
            harness_gen.cycle([{"f": "fault-start"},
                               {"f": "fault-stop"}]))))))
    test = {"name": name + "-faults", "nodes": HARNESS_NODES.split(","),
            "concurrency": wl["concurrency"],
            "client": StaleCrashingClient(), "nemesis": faults,
            "generator": g, "checker": wl["checker"], "store?": False}
    dense.DENSE_AUTOMATON.launches = 0
    wgl.FRONTIER_SEARCH.launches = 0
    t0 = time.perf_counter()
    run = core.run(test)
    run_s = time.perf_counter() - t0
    k1, k4 = dense.DENSE_AUTOMATON.launches, wgl.FRONTIER_SEARCH.launches
    h = run["history"]
    card_lin = run["results"]["linearizable"]
    card_results = json.loads(json.dumps(card_lin["results"], default=repr))
    invalid = [k for k, r in card_results.items() if r["valid?"] is not True]
    nemesis_ops = [op for op in h if op.process == "nemesis"]
    crashed = [op for op in h if op.type == "info" and op.process != "nemesis"]
    require(k1 > 0, "harness: the faulted run never launched K1")
    require(invalid, "harness: stale reads left no key invalid")
    require({op.f for op in nemesis_ops} == {"fault-start", "fault-stop"},
            "harness: the nemesis ops are missing from the history")
    require(crashed, "harness: no client op crashed")
    # each key's subhistory holds every nemesis op at its place, as the
    # reference's does, and the ops the lift checks are exactly the
    # key's own client ops
    own: dict = {}
    for op in h:
        if isinstance(op.value, independent.KV):
            own.setdefault(op.value.key, []).append(
                (op.index, op.type, op.f, op.value.value))
    subs = independent.split_by_key(h)
    require(set(subs) == set(own), "harness: the split lost a key")
    for k, sub in subs.items():
        require([op.index for op in sub if op.process == "nemesis"]
                == [op.index for op in nemesis_ops],
                f"harness: key {k}'s subhistory misplaces the nemesis ops")
        require([(op.index, op.type, op.f, op.value)
                 for op in sub.client_ops()] == own[k],
                f"harness: key {k}'s checked ops are not its own")
    t0 = time.perf_counter()
    plain = plain_per_key(h, test)
    plain_s = time.perf_counter() - t0
    require(plain == card_results,
            "harness: a faulted key's card result differs from its plain "
            "version's")
    stats = harness_run_stats(run["results"], len(h), len(card_results))
    emit(phase="harness_faults", seconds=run_s, **stats, invalid=len(invalid),
         crashed=len(crashed), nemesis_ops=len(nemesis_ops),
         plain_s=plain_s, k1_launches=k1, k4_launches=k4,
         batch_stats=card_lin["batch-stats"], card=card)
    shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the real-process path: the localkv suite (phase 30)
# ---------------------------------------------------------------------------

#: phase 30's run: the reference's documented real-cluster run
#: (doc/example-local-cluster/README.md:13-16) at the CLI's five nodes
LOCALKV_ARGS = ["--suite", "localkv", "--faults", "partition,kill",
                "--time-limit", "10", "--concurrency", "6", "--rate", "40",
                "-o", "interval=2"]


def run_cli_captured(argv):
    """``cli.run_cli`` of the default commands with its standard output
    captured: ``(exit code, output)``."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.run_cli(cli.default_commands(), argv)
    return code, out.getvalue()


def as_json(x):
    """``x`` as JSON gives it back (tuples become lists)."""
    return json.loads(json.dumps(x, default=repr))


def localkv_phase(card):
    """Phase 30: ``cli test --suite localkv`` — five ``repregd`` replicas
    built with g++, partitioned and killed, the history checked on the
    card — held against the plain versions and the CPU oracle, then
    ``cli analyze`` of the stored run on the card."""
    import shutil

    root = os.path.abspath(os.path.join("build", "chip_smoke_localkv"))
    shutil.rmtree(root, ignore_errors=True)
    base = os.path.join(root, "store")
    nodes_dir = os.path.join(root, "nodes")
    model = models.cas_register(0)
    try:
        reset_dense_launches()
        wgl.FRONTIER_SEARCH.launches = 0
        wgl.ESCALATIONS.clear()
        t0 = time.perf_counter()
        code, _ = run_cli_captured(["test", *LOCALKV_ARGS, "--store-base",
                                    base, "-o", f"dir={nodes_dir}"])
        run_s = time.perf_counter() - t0
        k1 = dense.DENSE_AUTOMATON.launches
        k4 = wgl.FRONTIER_SEARCH.launches
        rungs = {str(k): v for k, v in wgl.ESCALATIONS.items()}
        require(code == cli.EXIT_VALID, f"localkv: cli test exited {code}")
        require(k1 + k4 > 0, "localkv: the check launched no kernel")
        start = store_mod.latest_time(base, "localkv")
        stored = store_mod.load({"name": "localkv", "start-time": start,
                                 "store-base": base})
        require(not stored.get("recovered"), "localkv: the store was torn")
        h, results = stored["history"], stored["results"]
        card_result = results["workload"]
        client = [op for op in h if isinstance(op.process, int)]
        types = {t: sum(1 for op in client if op.type == t)
                 for t in ("invoke", "ok", "fail", "info")}
        nemesis_fs = sorted({op.f for op in h if op.process == "nemesis"})
        require(types["ok"] > 20, f"localkv: only {types['ok']} ok ops")
        require({"start-partition", "kill"} <= set(nemesis_fs),
                f"localkv: the faults seen were {nemesis_fs}")
        enc = encode.encode_history(h, model)
        E = len(enc.ev_slot) if enc is not None else None
        C = enc.max_open if enc is not None else None
        V = (wgl.value_domain("cas-register", enc.init_state, enc.cand_a,
                              enc.cand_b) if enc is not None else None)
        run_dir = os.path.join(base, "localkv", start)
        for n in cli.DEFAULT_NODES:
            log = os.path.join(run_dir, n, "server.log")
            require(os.path.exists(log), f"localkv: {log} was not snarfed")
            with open(log) as f:
                require("repregd" in f.read(),
                        f"localkv: {log} does not name repregd")

        # the card again, the plain versions and the oracle on the history
        # the store holds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again_card = as_json(checker_mod.check_safe(
            checker_mod.linearizable(model), {}, h))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = as_json(checker_mod.check_safe(
            checker_mod.linearizable(model, device="cpu"), {}, h))
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        oracle = as_json(checker_mod.check_safe(
            checker_mod.linearizable(model, algorithm="oracle"), {}, h))
        oracle_s = time.perf_counter() - t0
        require(again_card == card_result,
                f"localkv: the stored result {card_result} differs from a "
                f"re-check on the card {again_card}")
        require(card_result == plain, f"localkv: the card's result "
                f"{card_result} differs from the plain versions' {plain}")
        # the oracle's map has no engine and the device's no op count:
        # every key the two share, the verdict first, must agree
        shared = sorted(set(card_result) & set(oracle))
        require("valid?" in shared and all(
            card_result[k] == oracle[k] for k in shared),
            f"localkv: the card's result {card_result} differs from the "
            f"oracle's {oracle}")

        # -- cli analyze of the stored run, on the card --------------------
        k4_before = wgl.FRONTIER_SEARCH.launches
        t0 = time.perf_counter()
        code, out = run_cli_captured(["analyze", "--test-name", "localkv",
                                      "--store-base", base])
        analyze_s = time.perf_counter() - t0
        require(code == cli.EXIT_VALID, f"localkv: cli analyze exited {code}")
        again = json.loads(out)
        require(again["workload"] == card_result,
                f"localkv: analyze says {again['workload']}, the run said "
                f"{card_result}")
        phases = {r["name"]: r["wall_s"]
                  for r in (results.get("obs") or {}).get("phases", [])}
        emit(phase="localkv", args=LOCALKV_ARGS, code=code, seconds=run_s,
             ops=types["invoke"], oks=types["ok"], fails=types["fail"],
             infos=types["info"], nemesis_fs=nemesis_fs, E=E, C=C, V=V,
             engine=card_result.get("engine"),
             kernel=card_result.get("kernel"), escalations=rungs,
             k1_launches=k1, k4_launches=k4, valid=card_result["valid?"],
             card_check_s=card_s, plain_s=plain_s, oracle_s=oracle_s,
             analysis_s=phases.get("analyze"),
             db_start_s=phases.get("db-start"),
             generator_s=phases.get("generator"), analyze_cli_s=analyze_s,
             analyze_k4_launches=wgl.FRONTIER_SEARCH.launches - k4_before,
             equal_plain=True, equal_oracle_keys=shared, card=card)
    finally:
        subprocess.run(["pkill", "-9", "-f", nodes_dir], capture_output=True)
    shutil.rmtree(root, ignore_errors=True)


TEST_ALL_ARGS = ["test-all", "--dummy", "--time-limit", "5"]


def test_all_phase(card):
    """Phase 31: ``cli test-all --dummy --time-limit 5`` (the README's
    command for every in-process workload) on the card at the CLI's
    defaults; rw-register's version graphs through K6, re-checked with
    ``screen-route cpu``; list-append's dependency graph and its route."""
    import shutil

    from jepsen_tpu_torch.elle import list_append as elle_la

    root = os.path.abspath(os.path.join("build", "chip_smoke_test_all"))
    shutil.rmtree(root, ignore_errors=True)
    base = os.path.join(root, "store")
    names = workloads.names()
    # a fresh process's router: no (device, bucket) choice pinned by the
    # earlier phases, so the auto route calibrates as a user's run does
    elle_cycles._SCREEN_CHOICE.clear()
    elle_cycles._CLASSIFY_CHOICE.clear()
    screens = []
    mask = elle_cycles.cyclic_graph_mask

    def recording_mask(graphs, *a, **kw):
        screens.append([len(g.vertices) for g in graphs])
        return mask(graphs, *a, **kw)

    elle_cycles.cyclic_graph_mask = recording_mask
    reset_dense_launches()
    wgl.FRONTIER_SEARCH.launches = 0
    cycles.HAS_CYCLE.launches = 0
    cycles.SCREEN.launches = 0
    try:
        t0 = time.perf_counter()
        code, _ = run_cli_captured([*TEST_ALL_ARGS, "--store-base", base])
        run_s = time.perf_counter() - t0
    finally:
        elle_cycles.cyclic_graph_mask = mask
    k1 = dense.DENSE_AUTOMATON.launches
    k4 = wgl.FRONTIER_SEARCH.launches
    k6 = cycles.HAS_CYCLE.launches
    k7 = cycles.SCREEN.launches
    require(code == cli.EXIT_VALID, f"test-all: exited {code}")
    ran = sorted(n for n in os.listdir(base)
                 if not n.startswith((".", "latest", "current")))
    require(ran == names, f"test-all: the store holds {ran}, the registry "
            f"{names}")
    stored = {}
    for name in names:
        start = store_mod.latest_time(base, name)
        t = store_mod.load({"name": name, "start-time": start,
                            "store-base": base})
        require(not t.get("recovered"), f"test-all: {name}'s store is torn")
        h, results = t["history"], t["results"]
        client = [op for op in h if isinstance(op.process, int)]
        oks = sum(1 for op in client if op.type == "ok")
        # causal paces its ops at one a second behind a nemesis that
        # sleeps ten: a run may complete only a few (tests/test_cli_web.py)
        require(oks > 0 or name == "causal", f"test-all: {name} has no ok op")
        phases = {r["name"]: r["wall_s"]
                  for r in (results.get("obs") or {}).get("phases", [])}
        stored[name] = (t, h, results)
        emit(phase="test_all_run", workload=name, ops=sum(
            1 for op in client if op.type == "invoke"), oks=oks,
             seconds=sum(phases.values()),
             generator_s=phases.get("generator"),
             analysis_s=phases.get("analyze"), valid=results["valid?"],
             card=card)
        require(results["valid?"] is True, f"test-all: {name} is "
                f"{results['valid?']}")

    # rw-register: its version graphs went through K6; the CPU route on
    # the stored history gives the card's anomalies and verdict
    require(len(screens) == 1, f"rw-register: {len(screens)} version-graph "
            "screens, not one")
    require(len(screens[0]) >= elle_cycles.ELLE_SCREEN_MIN_BATCH and max(
        screens[0]) <= elle_cycles.DEVICE_SCREEN_MAX_VERTICES,
        f"rw-register: {len(screens[0])} version graphs, the largest of "
        f"{max(screens[0])} vertices: not a screened batch")
    require(k6 > 0, "rw-register: the version graphs never launched K6")
    t, h, results = stored["rw-register"]
    launches = cycles.HAS_CYCLE.launches
    t0 = time.perf_counter()
    cpu = as_json(workloads.workload("rw-register", {
        **{k: v for k, v in t.items() if k not in ("history", "results")},
        "screen-route": "cpu"})["checker"].check({}, h, {}))
    cpu_s = time.perf_counter() - t0
    require(cycles.HAS_CYCLE.launches == launches,
            "rw-register: the cpu route launched K6")
    for k in ("valid?", "anomaly-types", "anomalies", "txn-count"):
        require(cpu[k] == results[k], f"rw-register: {k} is {results[k]} on "
                f"the card and {cpu[k]} on the cpu route")
    emit(phase="test_all_rw_register", version_graphs=len(screens[0]),
         largest_vertices=max(screens[0]), k6_launches=k6,
         txns=results["txn-count"], cpu_recheck_s=cpu_s, equal_cpu=True,
         card=card)

    # list-append: one dependency graph a history, so a batch of one,
    # under ELLE_SCREEN_MIN_BATCH (and past DEVICE_SCREEN_MAX_VERTICES
    # when it is large): classify_graphs keeps it on the CPU, as the
    # reference's does; no screen launched (K7 0) shows it
    t, h, results = stored["list-append"]
    g = elle_la.prepare(h, {"anomalies": ["G1", "G2"]})[0]
    n_vertices = len(g.vertices)
    emit(phase="test_all_list_append", vertices=n_vertices, batch=1,
         min_batch=elle_cycles.ELLE_SCREEN_MIN_BATCH,
         max_vertices=elle_cycles.DEVICE_SCREEN_MAX_VERTICES,
         route="cpu" if k7 == 0 else "device", k7_launches=k7,
         txns=results["txn-count"], card=card)
    emit(phase="test_all", args=TEST_ALL_ARGS, code=code, seconds=run_s,
         workloads=names, k1_launches=k1, k4_launches=k4, k6_launches=k6,
         k7_launches=k7, card=card)
    shutil.rmtree(root, ignore_errors=True)
    return k6


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    # no calibration.json in the working directory steers any phase; phase
    # 23 activates its own artifact
    tune.use(None)

    # -- 1. build and device ------------------------------------------------
    t0 = time.perf_counter()
    report = _build.build()
    ptxas = "\n".join(v["ptxas"] for v in report.values())
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
    # the compared plain run also counts the integer operations (as the
    # family phases' do: the count stays on the device)
    work: dict = {}
    (ok, failed_at, _), plain_s, err = compare(checker, arrays, work)
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
        dom = wgl.value_domain(spec, eb.init_state, eb.cand_a, eb.cand_b)
        v = v_edge or encode.round_up(dom, 4)
        require(dom <= v, f"{name}: value domain {dom} exceeds V={v}")
        edge = dense.make_dense_fn(spec, E_edge, c_edge, v, device)
        (e_ok, _, _), _, e_err = compare(edge,
                                         to_device(batch_arrays(eb), device))
        err = max(err, e_err)
        emit(phase="edge", case=name, spec=spec, rows=len(encs), E=E_edge,
             C=c_edge, V=v, invalid=int((~e_ok).sum()), max_abs_err=e_err,
             design=dense.design("register", v, c_edge))
    for name, eb, S in register_edges(arrays_np, V):
        (e_ok, e_failed, _), _, e_err = compare(RawRegister(S),
                                                to_device(eb, device))
        err = max(err, e_err)
        if name.startswith("fail-at-0"):
            require((e_failed[:9] == 0).all(), "fail-at-0 rows did not fail "
                    "at event 0")
        emit(phase="edge", case=name, spec="register", rows=int(len(eb[0])),
             E=int(eb[1].shape[1]), C=int(eb[2].shape[2]), V=S,
             invalid=int((~e_ok).sum()), max_abs_err=e_err,
             design=dense.design("register", S, eb[2].shape[2]))

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
         C=int(C), V=int(V), **design_fields("register", V, C, ptxas),
         ms=ms, runs_ms=all_ms, bound_ms=bound_ms,
         bound_by=bound_by, bytes=nbytes, int_ops=work["int_ops"],
         plain_ms=plain_s * 1e3, e2e_histories_per_s=len(hs) / e2e_s,
         library_ms=None,
         library="no single PyTorch call computes the dense automaton",
         card=card)

    # -- 6. frontier kernel against its plain version at the slice's shape --
    slice_hs = slice_histories(45200, FRONTIER_HISTORIES)
    f_arrays = encoded(slice_hs, slot_cap=32)
    fB, fE, fC = f_arrays[2].shape
    dom = wgl.value_domain("cas-register", f_arrays[0], f_arrays[4],
                           f_arrays[5])
    require(wgl.kernel_choice("cas-register", fC, dom) == "frontier",
            f"the slice's shape (C={fC}, V={dom}) is not a frontier shape")
    f_work: dict = {}
    (f_ok, f_failed, _), f_plain_s, f_err = frontier_compare(
        "", "cas-register", f_arrays, wgl.DEFAULT_FRONTIER, fC + 1, device,
        work=f_work)
    _, _, e512 = frontier_compare("", "cas-register", f_arrays, 512, fC + 1,
                                  device)
    f_err = max(f_err, e512)

    # -- 7. frontier edges ---------------------------------------------------
    hc = encoded(crash_heavy_histories(45210, 64), slot_cap=16)
    require(hc[2].shape[2] == 16, f"crash-heavy C={hc[2].shape[2]}, not 16")
    suff_hs = [synth.generate_history(random.Random(45220 + i), n_procs=4,
                                      n_ops=150, n_values=200, crash_p=0.0,
                                      corrupt=i % 4 == 0) for i in range(64)]
    suff = encoded(suff_hs, slot_cap=4)
    suff_F = wgl.sufficient_frontier(
        wgl.value_domain("cas-register", suff[0], suff[4], suff[5]),
        suff[2].shape[2])
    require(suff_F is not None, "no sufficient capacity for the C=4 batch")
    short = tuple(a[:128] for a in f_arrays)
    (_, _, hc_ovf), _, e_err = frontier_compare(
        "C16", "cas-register", hc, wgl.DEFAULT_FRONTIER, 17, device)
    f_err = max(f_err, e_err)
    require(hc_ovf.any(), "no C = 16 row overflowed at the base capacity")
    # the first escalation rung's own shape: the overflowed rows at F ×
    # the first factor, compared on a fixed subset
    f_err = max(f_err, rung_subset_compare(
        "C16-rung", hc, hc_ovf,
        wgl.DEFAULT_FRONTIER * wgl.ESCALATION_FACTORS[0], 17, device))
    edges = [
        ("sufficient", "cas-register", suff, suff_F, 5),
        ("W2", "cas-register", two_word(short), wgl.DEFAULT_FRONTIER, 41),
        ("max_closure=2", "cas-register", short, wgl.DEFAULT_FRONTIER, 2),
    ] + [(f"random-{spec}", spec, random_batch(spec, 45230 + i), 16, 9)
         for i, spec in enumerate(RANDOM_OPS)
         ] + frontier_design_edges(f_arrays, hc)
    for name, spec, arrays, F, mc in edges:
        _, _, e_err = frontier_compare(name, spec, arrays, F, mc, device)
        f_err = max(f_err, e_err)

    # -- 8. frontier end to end through check_batch ---------------------------
    f_hs = slice_histories(45240, FRONTIER_HISTORIES) + \
        crash_heavy_histories(45250, 8)
    wgl.FRONTIER_SEARCH.launches = 0
    wgl.ESCALATIONS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_results = wgl.check_batch(model, f_hs)
    f_e2e_s = time.perf_counter() - t0
    f_launches = wgl.FRONTIER_SEARCH.launches
    rungs = dict(wgl.ESCALATIONS)
    f_stats = wgl.batch_stats(f_results)
    require(f_launches > 0, "check_batch never launched the frontier kernel")
    require(rungs, "no escalation rung ran on the card")
    require(f_stats["engines"].get("oracle-overflow", 0) > 0,
            "no row went to the oracle as oracle-overflow")
    f_device = [i for i, r in enumerate(f_results) if r["engine"] == "gpu"]
    f_invalid = [i for i in f_device if f_results[i]["valid?"] is False]
    f_sample = sorted(set(f_invalid[:16]) | set(
        pick.choice(f_device, 64, replace=False).tolist()))[:64]
    for i in f_sample:
        r = linear.analysis(model, f_hs[i], pure_fs=("read",))
        require(r["valid?"] == f_results[i]["valid?"],
                f"frontier history {i}: device says "
                f"{f_results[i]['valid?']}, oracle says {r['valid?']}")
    emit(phase="frontier_end_to_end", histories=len(f_hs), seconds=f_e2e_s,
         histories_per_s=len(f_hs) / f_e2e_s, launches=f_launches,
         escalations={str(k): v for k, v in rungs.items()},
         oracle_sample=len(f_sample), batch_stats=f_stats, card=card)

    # -- 9. frontier times ----------------------------------------------------
    f_checker = wgl.make_check_fn("cas-register", fE, fC,
                                  wgl.DEFAULT_FRONTIER, fC + 1, device)
    f_dev = to_device(f_arrays, device)
    f_ms, f_all_ms = time_kernel(f_checker, f_dev)
    f_bound_ms, f_bound_by, f_bytes = kernel_bound(f_arrays, f_failed,
                                                   f_work["int_ops"])
    emit(phase="frontier_times", kernel="frontier_search", rows=int(fB),
         E=int(fE), C=int(fC), F=wgl.DEFAULT_FRONTIER,
         **frontier_design_fields("cas-register", wgl.DEFAULT_FRONTIER,
                                  int(fC), ptxas), ms=f_ms,
         runs_ms=f_all_ms, bound_ms=f_bound_ms, bound_by=f_bound_by,
         bytes=f_bytes, int_ops=f_work["int_ops"], plain_ms=f_plain_s * 1e3,
         e2e_histories_per_s=len(f_hs) / f_e2e_s, library_ms=None,
         library="no single PyTorch call computes the frontier search",
         card=card)

    # -- 10-14. the lock, permit and multi-register families ---------------
    family_entries, owner_err = family_phases(device, card, pick, ptxas)
    err = max(err, owner_err)

    # -- 15-17. the Elle screens -------------------------------------------
    elle_entries, la_hs = elle_phases(device, card, ptxas)

    # -- 18. the unordered-queue automaton ----------------------------------
    queue_entry = queue_phase(device, card, ptxas)

    # -- 19. sharded dispatch over a two-shard mesh --------------------------
    mesh = pick_mesh(device)
    mesh_phase(mesh, card, model, hs, results, f_hs, la_hs)

    # -- 20. verdict statistics over the shards ------------------------------
    stats_entry = stats_phase(mesh, device, card,
                              (arrays_np, checker, ok), f_arrays, ptxas)

    # -- 21. the Checker seam and the flight recorder -------------------------
    keyed = checker_seam_phase(card, model, hs, results, len(hs) / e2e_s,
                               f_hs, f_results)

    # -- 22. the device's busy share of the seam run --------------------------
    profile_phase(card, keyed, device)

    # -- 23. the tuner, the journal and the drift sentinel --------------------
    tuning_phase(card, model, hs, results)

    # -- 24-26. the checker service, online checking, the fleet ---------------
    fleet: dict = {}
    try:
        service_phase(card, model, hs, results, len(hs) / e2e_s, f_hs,
                      f_results, la_hs, device,
                      on_ready=lambda: start_fleet(fleet))
        fleet_phase(card, fleet, model, hs, results, f_hs, f_results, la_hs,
                    device)
    finally:
        stop_fleet(fleet)

    # -- 27. the service's chaos drills on the card -------------------------
    chaos_phase(card, hs, f_hs)

    # -- 28. the kernel audit's card half ------------------------------------
    audit_phase(card, report, device)

    # -- 29. the test harness: the CLI, analyze, core.run under faults -------
    harness_phase(card)

    # -- 30. real processes: the localkv suite under partitions and kills ----
    localkv_phase(card)

    # -- 31. every in-process workload: cli test-all on the card -----------
    test_all_phase(card)

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
    }] + family_entries + [{
        "name": "frontier_search",
        "route": "cuda",
        "source": "jepsen_tpu_torch/ops/csrc/frontier_search.cu",
        "replaces": "jepsen_tpu/ops/wgl.py:300",
        "launches": f_launches,
        "max_abs_err": f_err,
        "ms": f_ms,
        "plain_ms": f_plain_s * 1e3,
        "bound_ms": f_bound_ms,
        "bound_by": f_bound_by,
        "library_ms": None,
    }] + elle_entries + [queue_entry, stats_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
