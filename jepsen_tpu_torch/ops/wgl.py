"""Batched linearizability checking on the GPU — the port's entry point,
:func:`check_batch` (the counterpart of :mod:`jepsen_tpu.ops.wgl`).

Routing follows the reference's :func:`kernel_choice` for the specs this
slice takes (register, cas-register).  In this slice of the port:

- a bucket inside the dense envelope (C ≤ 12, V ≤ 32) runs the dense
  subset automaton (:mod:`.dense`): the CUDA kernel on the card, its
  plain PyTorch version with ``device="cpu"``;
- a bucket the reference sends to its generic frontier search has no
  device kernel here yet (ROADMAP.md, kernel K4): its histories go to
  the CPU oracle, tagged ``"oracle-unported"``;
- unencodable histories go to the CPU oracle, tagged
  ``"oracle-fallback"``, as in the reference.

Device results keep the reference's dict schema with ``"engine": "gpu"``
where the reference writes ``"tpu"``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .. import device as device_mod
from .. import models as m
from ..history import History
from . import dense as dense_mod
from . import encode as encode_mod
from .step_kernels import spec_for

#: largest row count per device dispatch — bounds device memory for huge
#: keyspaces; the flagship shape (16384 × 1000-op histories) is one chunk
DEFAULT_MAX_DISPATCH = 16384

#: per-array pad fill for chunked dispatch: ev_slot/cand_slot use -1 as
#: "padding", so a padded row is an all-padding history (ok, never
#: failed) and every chunk of a bucket launches at one shape
_PAD_FILLS = (0, -1, -1, 0, 0, 0)

#: the specs :func:`check_batch` takes in this slice of the port
CHECK_BATCH_SPECS = ("register", "cas-register")


def kernel_choice(spec_name: str, C: int, n_values: Optional[int]) -> str:
    """Which engine the reference routes a register-family shape to:
    "dense" (subset automaton, no sorts, no overflow) or "frontier" (the
    generic device search).  The reference's third answer, "oracle" for
    the lock family outside the envelope, comes with that family (ROADMAP
    A5)."""
    if n_values is not None:
        V = encode_mod.round_up(n_values, 4)
        if dense_mod.applicable(spec_name, C, V):
            return "dense"
    return "frontier"


def make_best_check_fn(spec_name: str, E: int, C: int, n_values: int,
                       device) -> Optional[dense_mod.DenseChecker]:
    """The device checker for a shape, or ``None`` when the shape has
    none in this slice (a "frontier" shape: that kernel is not ported
    yet).  Callers MUST check for None."""
    if kernel_choice(spec_name, C, n_values) != "dense":
        return None
    V = encode_mod.round_up(n_values, 4)
    return dense_mod.make_dense_fn(spec_name, E, C, V, device)


def value_domain(init_state, cand_a, cand_b) -> int:
    """Exclusive upper bound of the value-id domain of a batch."""
    return 1 + int(
        max(
            np.asarray(init_state).max(),
            np.asarray(cand_a).max(),
            np.asarray(cand_b).max(),
        )
    )


class BucketPlan:
    """The routing decision for one encoded ``[B, E, C]`` bucket: which
    kernel serves the shape, the device checker (None = the CPU oracle
    takes every row) and its per-dispatch row cap."""

    __slots__ = ("E", "kernel", "fn", "disp")


def plan_bucket(spec, arrays, *, device,
                max_dispatch: int = DEFAULT_MAX_DISPATCH) -> BucketPlan:
    """Pick the kernel for one encoded bucket's arrays (the 6-tuple
    ``(init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b)`` with at
    least one row)."""
    init_state, ev_slot, cand_slot, _cand_f, cand_a, cand_b = arrays
    plan = BucketPlan()
    plan.E = E = ev_slot.shape[1]
    C = cand_slot.shape[2]  # bucketed to actual concurrency
    n_values = value_domain(init_state, cand_a, cand_b)
    plan.kernel = kernel_choice(spec.name, C, n_values)
    plan.fn = make_best_check_fn(spec.name, E, C, n_values, device)
    plan.disp = 0 if plan.fn is None else max_dispatch
    return plan


def check_batch(
    model: m.Model,
    histories: Sequence[History],
    *,
    slot_cap: int = encode_mod.DEFAULT_SLOT_CAP,
    oracle_fallback: bool = True,
    max_dispatch: int = DEFAULT_MAX_DISPATCH,
    window: Optional[int] = None,
    bucketed: bool = True,
    device=None,
) -> List[dict]:
    """Check a batch of histories; per-history result dicts in input
    order, as :func:`jepsen_tpu.ops.wgl.check_batch` returns them (with
    ``"engine": "gpu"`` for device verdicts).

    ``device`` defaults to the current CUDA device and raises without
    CUDA; ``device="cpu"`` runs the plain PyTorch version of every kernel.
    Histories are encoded into per-(E, C) shape buckets and dispatched
    through a bounded in-flight ``window`` (default 4; 1 = strictly
    serial); CPU-oracle fallbacks run on a worker pool alongside device
    work.  Verdicts are independent of ``window`` and ``bucketed``.  With
    ``oracle_fallback=False`` rows the device cannot take report
    ``"unknown"``.  Batches larger than ``max_dispatch`` rows run as
    chunks.

    Models other than register and cas-register raise
    ``NotImplementedError``: the rest of the model table is ROADMAP.md
    queue A, item A5."""
    from ..engine import pipeline

    dev = device_mod.resolve(device)
    spec = spec_for(model)
    if spec is None or spec.name not in CHECK_BATCH_SPECS:
        raise NotImplementedError(
            f"check_batch does not take {type(model).__name__} models yet: "
            "the port covers register and cas-register; the other model "
            "specs come with ROADMAP.md queue A, item A5"
        )
    return pipeline.run(
        model,
        histories,
        slot_cap=slot_cap,
        oracle_fallback=oracle_fallback,
        max_dispatch=max_dispatch,
        window=window,
        bucketed=bucketed,
        device=dev,
    )


def batch_stats(results: Sequence[dict]) -> dict:
    """Engine breakdown for a check_batch result list — the share of
    histories the device decided vs the CPU oracle."""
    counts: dict = {}
    kernels: dict = {}
    for r in results:
        counts[r.get("engine", "?")] = counts.get(r.get("engine", "?"), 0) + 1
        if r.get("engine") == "gpu":
            k = r.get("kernel", "?")
            kernels[k] = kernels.get(k, 0) + 1
    n = max(1, len(results))
    return {
        "engines": counts,
        "kernels": kernels,
        "device-rate": counts.get("gpu", 0) / n,
        "oracle-rate": sum(
            v for k, v in counts.items() if k.startswith("oracle")
        ) / n,
    }


def analysis(model: m.Model, history: History, **kw) -> dict:
    """Single-history entry point matching checker.linear.analysis."""
    return check_batch(model, [history], **kw)[0]
