"""The offline autotuner — the port of :mod:`jepsen_tpu.tune.calibrate`.

It replaces the engine's pinned dispatch constants with measured picks
for the *attached* device: a coordinate-descent search from the current
defaults over

- ``closure_mode`` — fixed-round against convergence-early-exit closure
  in the Elle screens,
- ``window`` — the engine's in-flight dispatch bound,
- ``flush_rows`` — the streaming bucket flush threshold,
- ``row_bucket`` — the power-of-two dispatch-row floor,

each candidate timed as a full pipelined run (encode → bucket → window
→ drain, the engine's ``Planner``/``Executor`` composition) on synthetic
corpora covering both kernel routes and the screens.  The reference's
``union_mode`` and ``closure_impl`` axes choose lowerings the port does
not carry, so they are not swept.  Every candidate is warmed up once
before it is timed: the first dispatch at a row shape includes a
kernel's build at first use, and no candidate is judged on it.

A second pass measures the **cost table**: per-(kernel, E, C, F)
dispatch seconds at a few row counts, the measured stand-in for
``planning.estimated_cost``'s analytic proxy.  On a CUDA device each
point is the kernel's launch between two ``torch.cuda.Event``s on the
current stream, after a warm-up launch; on the CPU (tests only) it is
``time.perf_counter`` around the plain version.

**Budget gate**: no proposal — sweep candidate or cost-table row count —
may put more rows in flight on one device than the plan's cap
(``wgl.frontier_max_dispatch``, ``cycles.cycles_max_dispatch``, the
port's own device-memory budgets).  :func:`proposal_within_budget` is the
single gate; rejected proposals are counted
(``jepsen_tune_budget_rejections_total``), and every measured run's
``Executor.chip_row_accounting`` peaks are checked after the fact, so
the artifact carries proof, not a promise.  A measured breach raises.

The reference's scoped environment overrides are arguments here: the
knobs go to ``Planner(flush_rows=)``, ``Executor(window=, row_bucket=)``
and ``screen_graphs(mode=)``.  Results persist via :mod:`.artifact`.
"""

from __future__ import annotations

import datetime
import random
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..obs import journal as obs_journal
from . import artifact

#: sweep profiles: bounded candidate sets and corpus sizes.  The corpora
#: must look like production traffic (hundreds of ops per history) or a
#: pick that wins at toy shapes loses at real ones; "smoke" is the tiny
#: gate (seconds).
PROFILES: Dict[str, Dict[str, Any]] = {
    "default": dict(
        n_hists=32, n_ops=160, n_procs=3, reps=2, passes=2,
        windows=(1, 2, 4, 8), closures=("fixed", "earlyexit"),
        flush_rows=(4096, 16384, 65536), row_buckets=(32, 64, 128),
        cost_rows=(32, 128), screen_ns=(16, 64), n_graphs=24,
        budget_s=100.0,
    ),
    "smoke": dict(
        n_hists=10, n_ops=12, n_procs=3, reps=1, passes=1,
        windows=(1, 4), closures=("fixed", "earlyexit"),
        flush_rows=(16384,), row_buckets=(64,),
        cost_rows=(8,), screen_ns=(16,), n_graphs=6, budget_s=30.0,
    ),
}

#: shared shape knobs for the synthetic corpora (small on purpose: the
#: tuner ranks configs, it does not need flagship batch sizes)
SLOT_CAP = 32
FRONTIER = 64

#: the Elle screens' canonical no-suffix filter profile
_MASKS, _NONADJ = (1, 3, 7), ((4, 3),)


def proposal_within_budget(plan, rows: int, window: int,
                           n_devices: int = 1) -> bool:
    """True iff dispatching ``rows`` rows of ``plan`` under an in-flight
    ``window`` keeps the rows in flight on one device within the plan's
    cap (``plan.disp``).  Dense kernels allow the full cap per dispatch
    at any depth (a small per-row footprint); frontier kernels hold at
    most ``disp`` rows across the whole window (the executor splits
    chunks to ``disp // window``, or serialises when even that floors
    out).  A plan with no dispatchable kernel admits nothing."""
    if plan.fn is None or plan.disp == 0:
        return rows == 0
    cap = plan.disp * max(1, n_devices)
    if plan.kernel == "dense":
        return rows <= cap
    w = max(1, window)
    if plan.disp >= w:
        # window-deep frontier dispatch: w chunks of disp // w rows each
        return rows <= (plan.disp // w) * w * max(1, n_devices)
    return rows <= cap  # serialised: one full-cap dispatch at a time


def _corpora(profile: Dict[str, Any]):
    """Synthetic measurement corpora: one CAS-register batch (dense-routed,
    and frontier-routed at ``max_closure=9``; every history encodable, so
    timings are the device and host pipeline, no oracle), a multi-register
    batch for the cost table, and an ``"elle"`` list of encoded graphs for
    the ``closure_mode`` coordinate (not a ``(model, hists)`` pair)."""
    from .. import models as m
    from ..synth import generate_history, generate_mr_history

    rng = random.Random(45100)
    n, L, P = profile["n_hists"], profile["n_ops"], profile["n_procs"]
    cas = [generate_history(rng, n_procs=P, n_ops=L, crash_p=0.0,
                            corrupt=(i % 4 == 0))
           for i in range(n)]
    mr = [generate_mr_history(rng, n_procs=P, n_ops=L, n_keys=4,
                              n_values=4, crash_p=0.0, corrupt=(i % 4 == 0))
          for i in range(max(2, n // 4))]
    return {
        "cas": (m.cas_register(0), cas),
        "multi-register": (m.multi_register({k: 0 for k in range(4)}), mr),
        "elle": _screen_corpus(profile.get("n_graphs", 8)),
    }


def _ring_chain(n: int, g: int) -> np.ndarray:
    """Graph ``g``'s ``(n, n)`` relation bytes: a chain whose edges cycle
    through the three relation bits, closed into a ring when ``g`` is
    even."""
    rel = np.zeros((n, n), np.uint8)
    for i in range(n - 1):
        rel[i, i + 1] = (1, 2, 4)[(g + i) % 3]
    if g % 2 == 0:
        rel[n - 1, 0] = 1
    return rel


def _screen_corpus(n_graphs: int):
    """Deterministic encoded graphs for the screen timings: rings and
    chains of 16 and 32 vertices at the canonical filter profile (both
    sizes screen in the engine's 32-vertex bucket)."""
    from ..elle import encode as encode_mod

    encs = []
    for g in range(max(1, n_graphs)):
        n = 16 if g % 2 == 0 else 32
        encs.append(encode_mod.EncodedGraph(list(range(n)), _ring_chain(n, g),
                                            7, _MASKS, _NONADJ))
    return encs


def journal_rows(path: Optional[str] = None,
                 kernel: Optional[str] = None) -> List[dict]:
    """Dispatch-journal rows (:mod:`..obs.journal`) read back in the
    cost-table entry shape — observed traffic beside the synthetic
    :func:`measure_cost_table` points.  ``seconds`` is the warm execute
    time of a cache hit, else the compile time; ``corpus`` is
    ``"journal"``.  Reads the process's journal by default (else
    ``dispatch-journal.jsonl`` in the working directory); bad lines are
    skipped, and a missing file is an empty list."""
    p = path or obs_journal.path() or obs_journal.DEFAULT_FILENAME
    out: List[dict] = []
    for row in obs_journal.read_rows(p):
        if kernel is not None and row.get("kernel") != kernel:
            continue
        secs = row["execute_s"] if row["cache"] == "hit" else row["compile_s"]
        out.append({
            "kernel": row["kernel"], "E": row["E"], "C": row["C"],
            "F": row["F"], "rows": row["rows"],
            "seconds": round(float(secs), 6),
            "corpus": "journal",
            "cache": row["cache"],
            "coalesced": row["coalesced"],
        })
    return out


class _Runner:
    """Measurement harness: one timed pipelined run per call through the
    engine's planning/execution composition on ``device``, with per-run
    budget evidence from the executor's row accounting."""

    def __init__(self, device):
        self.device = device
        self.budget_evidence: List[dict] = []
        self.budget_breaches: List[dict] = []

    def timed_run(self, model, hists, *, window: int, flush_rows: int,
                  row_bucket: int, max_closure: Optional[int] = None) -> float:
        """Wall seconds of one full pipelined pass (encode → buckets →
        window → drain; the drain waits for the device).  The oracle is
        off: the corpora are fully encodable."""
        from ..engine import execution, planning
        from ..ops import wgl

        ctx = planning.RunContext(model, hists, oracle_fallback=False)
        planner = planning.Planner(
            model, slot_cap=SLOT_CAP, device=self.device,
            max_dispatch=wgl.DEFAULT_MAX_DISPATCH, frontier=FRONTIER,
            max_closure=max_closure, bucketed=True, flush_rows=flush_rows)
        ex = execution.Executor(window, device=self.device,
                                row_bucket=row_bucket)
        t0 = time.perf_counter()
        stream = planner.open_stream()
        for idx in range(len(hists)):
            for pb in stream.feed(ctx, idx):
                ex.submit(pb)
        for pb in stream.finish():
            ex.submit(pb)
        ex.drain()
        wall = time.perf_counter() - t0
        self._collect_budget(ex)
        return wall

    def timed_screens(self, encs, *, window: int, row_bucket: int,
                      mode: str, reps: int) -> float:
        """Wall seconds of one screen pass over encoded graphs in closure
        ``mode`` (best of ``reps`` after one untimed warm-up), through
        the same Executor, with the same budget evidence."""
        from ..engine import execution
        from ..ops import cycles as ops_cycles

        def one() -> float:
            ex = execution.Executor(window, device=self.device,
                                    row_bucket=row_bucket)
            t0 = time.perf_counter()
            ops_cycles.screen_graphs(encs, executor=ex, mode=mode)
            wall = time.perf_counter() - t0
            self._collect_budget(ex)
            return wall

        one()  # warm-up
        return min(one() for _ in range(reps))

    def _collect_budget(self, ex) -> None:
        for acct in ex.chip_row_accounting.values():
            cap = acct["chip_cap"]
            if acct["kernel"] == "dense":
                cap = cap * ex.window_size
            ev = {
                "kernel": acct["kernel"],
                "peak_chip_rows": acct["peak_chip_rows"],
                "chip_cap": acct["chip_cap"],
                "window": ex.window_size,
                "within_budget": acct["peak_chip_rows"] <= cap,
            }
            self.budget_evidence.append(ev)
            if not ev["within_budget"]:  # an engine invariant: loudly
                self.budget_breaches.append(ev)


def measure_config(runner: _Runner, corpora, cfg: Dict[str, Any],
                   reps: int) -> float:
    """Objective for one candidate config: steady-state wall seconds
    (best of ``reps`` after one untimed warm-up) over the dense- and
    frontier-routed corpora and the screens."""
    model, cas = corpora["cas"]
    total = 0.0
    for max_closure in (None, 9):  # dense route, then frontier
        kw = dict(window=cfg["window"], flush_rows=cfg["flush_rows"],
                  row_bucket=cfg["row_bucket"], max_closure=max_closure)
        runner.timed_run(model, cas, **kw)  # warm-up
        total += min(runner.timed_run(model, cas, **kw) for _ in range(reps))
    total += runner.timed_screens(
        corpora["elle"], window=cfg["window"], row_bucket=cfg["row_bucket"],
        mode=cfg["closure_mode"], reps=reps)
    obs.count("jepsen_tune_measurements_total", phase="sweep")
    return total


def coordinate_descent(runner: _Runner, corpora, profile: Dict[str, Any],
                       deadline: float) -> Tuple[Dict[str, Any], dict]:
    """Start from the pinned defaults and improve one coordinate at a
    time, revisiting until a full pass changes nothing (or the time
    budget runs out — the partial result is still valid: every visited
    config was really measured)."""
    from ..engine import execution, planning
    from ..ops import cycles as ops_cycles

    space = {
        "closure_mode": tuple(profile["closures"]),
        "window": tuple(profile["windows"]),
        "flush_rows": tuple(profile["flush_rows"]),
        "row_bucket": tuple(profile["row_buckets"]),
    }
    current = {
        "closure_mode": ops_cycles.DEFAULT_CLOSURE_MODE,
        "window": execution.DEFAULT_WINDOW,
        "flush_rows": planning.DEFAULT_FLUSH_ROWS,
        "row_bucket": execution.ROW_BUCKET,
    }
    reps = profile["reps"]
    scores: Dict[str, float] = {}
    trail: List[dict] = []
    truncated = False

    def score(cfg) -> float:
        k = "|".join(f"{c}={cfg[c]}" for c in sorted(cfg))
        if k not in scores:
            scores[k] = measure_config(runner, corpora, cfg, reps)
        return scores[k]

    best_s = score(current)
    for _pass in range(profile["passes"]):
        moved = False
        for coord, cands in space.items():
            for cand in cands:
                if time.perf_counter() > deadline:
                    truncated = True
                    break
                if cand == current[coord]:
                    continue
                trial = {**current, coord: cand}
                s = score(trial)
                trail.append({"coord": coord, "value": cand,
                              "seconds": round(s, 5)})
                if s < best_s:
                    current, best_s = trial, s
                    moved = True
            if truncated:
                break
        if truncated or not moved:
            break
    diag = {
        "best_seconds": round(best_s, 5),
        "measured_configs": len(scores),
        "trail": trail,
        "truncated": truncated,
    }
    return current, diag


def _time_launch(fn, args, device) -> float:
    """Seconds of one ``fn(*args)`` after one warm-up call: between two
    CUDA events on the current stream on a CUDA device, by
    ``time.perf_counter`` on the CPU."""
    fn(*args)  # warm-up: a first use builds and loads the kernel
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def measure_cost_table(runner: _Runner, corpora, profile: Dict[str, Any],
                       params: Dict[str, Any]) -> List[dict]:
    """Per-(kernel, E, C, F) dispatch seconds at the profile's row counts
    — the interpolation points ``planning.estimated_cost`` serves.  A
    bucket with fewer histories than a point repeats them up to it (the
    reference clamps the point to the bucket instead, so a small corpus
    never measures its larger points).  Every row count passes
    :func:`proposal_within_budget` BEFORE any launch; an over-budget
    proposal is counted and dropped, never measured."""
    from ..elle import encode as encode_mod
    from ..engine import planning
    from ..ops import cycles as ops_cycles
    from ..ops import wgl
    from ..parallel import mesh as mesh_mod

    device = runner.device
    placement = mesh_mod.Mesh((device,))
    entries: List[dict] = []

    def measure(plan, host_arrays, rows, corpus):
        if not proposal_within_budget(plan, rows, params["window"]):
            obs.count("jepsen_tune_budget_rejections_total")
            return
        # a bucket shorter than the point repeats its rows up to it
        idx = np.arange(rows) % host_arrays[0].shape[0]
        (args,) = mesh_mod.shard_batch(placement,
                                       *(a[idx] for a in host_arrays))
        secs = _time_launch(plan.fn, args, device)
        obs.count("jepsen_tune_measurements_total", phase="cost")
        entries.append({"kernel": plan.kernel, "E": plan.E, "C": plan.C,
                        "F": plan.frontier, "rows": rows,
                        "seconds": round(secs, 6), "corpus": corpus})

    for name, pair in corpora.items():
        if name == "elle":
            continue  # encoded graphs: the screens' arm is below
        model, hists = pair
        for max_closure in (None, 9):
            ctx = planning.RunContext(model, hists, oracle_fallback=False)
            planner = planning.Planner(
                model, slot_cap=SLOT_CAP, device=device,
                max_dispatch=wgl.DEFAULT_MAX_DISPATCH, frontier=FRONTIER,
                max_closure=max_closure, bucketed=True,
                flush_rows=params["flush_rows"])
            if planner.spec is None:
                continue
            buckets, order = planner.encode_buckets(ctx)
            for key in order:
                pb = planner.plan_rows(key, *buckets[key])
                if pb is None or pb.plan.fn is None or pb.plan.disp == 0:
                    continue
                for rows in profile["cost_rows"]:
                    measure(pb.plan, pb.arrays, rows, name)
    # the Elle screens: (kernel "cycles", E = n, C = 0, F = plane weight)
    # in the same seconds as the history buckets, in the chosen mode, at
    # the vertex buckets the engine dispatches (n rounds up to a multiple
    # of 32: the reference's n 16 is no dispatch shape of either engine,
    # and the kernel takes none below 32)
    for n in sorted({encode_mod.graph_bucket(n)
                     for n in profile.get("screen_ns", ())}):
        plan = ops_cycles.ScreenPlan(n, _MASKS, _NONADJ,
                                     params["closure_mode"])
        if plan.disp == 0:
            continue
        for rows in profile["cost_rows"]:
            rel = np.stack([_ring_chain(n, b) for b in range(rows)])
            measure(plan, (rel,), rows, "elle-screen")
    # one point per (kernel, E, C, F, rows): keep the fastest (least
    # noisy) observation when corpora overlap in shape
    best: Dict[tuple, dict] = {}
    for e in entries:
        k = (e["kernel"], e["E"], e["C"], e["F"], e["rows"])
        if k not in best or e["seconds"] < best[k]["seconds"]:
            best[k] = e
    return [best[k] for k in sorted(best)]


def run_tune(out_path: str = artifact.DEFAULT_PATH,
             profile: str = "default",
             budget_s: Optional[float] = None,
             activate: bool = True,
             device=None) -> Tuple[str, dict]:
    """The whole offline pass: sweep → cost table → persisted artifact.
    Returns ``(path, artifact_dict)``; with ``activate`` the fresh
    artifact becomes this process's active calibration.  ``device``
    resolves as every entry point's does (None: the current CUDA device,
    after :func:`jepsen_tpu_torch.platform.ensure_usable_backend`;
    ``"cpu"``: the plain versions, for tests)."""
    from .. import device as device_mod

    if device is None or torch.device(device).type != "cpu":
        from ..platform import ensure_usable_backend

        ensure_usable_backend()
    dev = device_mod.resolve(device)
    prof = dict(PROFILES[profile])
    if budget_s is not None:
        prof["budget_s"] = float(budget_s)
    t_start = time.perf_counter()
    deadline = t_start + prof["budget_s"]
    device_kind, n_devices = artifact.device_key(dev)
    corpora = _corpora(prof)
    runner = _Runner(dev)

    params, sweep_diag = coordinate_descent(runner, corpora, prof, deadline)
    cost_table = measure_cost_table(runner, corpora, prof, params)
    if runner.budget_breaches:
        raise RuntimeError(
            "tuner measured a per-device budget breach (engine invariant "
            f"violated): {runner.budget_breaches[:3]}")
    sweep_diag.update({
        "profile": profile,
        "device_kind": device_kind,
        "n_devices": n_devices,
        "budget_checks": len(runner.budget_evidence),
        "budget_breaches": 0,
        "wall_s": round(time.perf_counter() - t_start, 3),
    })
    obs.gauge_set("jepsen_tune_sweep_seconds", time.perf_counter() - t_start)
    data = artifact.build_artifact(
        params, cost_table, device_kind, n_devices,
        created_at=datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        sweep=sweep_diag,
    )
    artifact.save(data, out_path)
    if activate:
        artifact.set_active(artifact.Calibration(data))
    return out_path, data
