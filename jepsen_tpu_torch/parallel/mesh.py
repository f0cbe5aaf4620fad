"""Device meshes and history-batch sharding — the port of
:mod:`jepsen_tpu.parallel.mesh`.

The reference shards the history batch over a single-process
``jax.sharding.Mesh`` with ``shard_map``: every device runs the unmodified
checker on its rows, and one collective, :func:`verdict_stats`, aggregates
the verdicts.  The port's :class:`Mesh` is the same thing in one process:
an ordered tuple of :class:`torch.device` s.  A sharded call splits the
(padded) rows into equal shards, copies shard ``d`` to ``mesh.devices[d]``
and runs that device's checker on it, on the device's current CUDA stream;
nothing is synchronised.  There is no ``torch.distributed`` and no process
group: the devices belong to this process, as the reference's do.

A mesh may name one device more than once (``(cuda:0, cuda:0)``, four
times ``cpu``): the counterpart of the reference's virtual host devices,
how the CPU tests and a one-card machine drive the sharded path.  Such a
mesh says so (:attr:`Mesh.repeated`); :func:`engine_default_mesh` never
builds one.

:func:`verdict_stats` is K9: per shard, the hand-written CUDA reduction
``ops/csrc/verdict_stats.cu`` (:data:`VERDICT_STATS`; its plain version
:func:`verdict_stats_reference` on the CPU), then the shards' counts are
added on the mesh's first device.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..ops import _build

#: ``engine_default_mesh`` modes: ``"auto"`` shards over every CUDA device
#: when there are at least two, ``"off"`` never shards
MESH_MODES = ("auto", "off")


class Mesh:
    """An ordered tuple of devices of one type that the history batch
    shards over, shard ``d`` on ``devices[d]``.  CUDA devices without an
    index resolve to the current device; a device may appear more than
    once (:attr:`repeated`)."""

    __slots__ = ("devices",)

    def __init__(self, devices: Sequence):
        devs = tuple(device_mod.resolve(torch.device(d)) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {devs}")
        self.devices: Tuple[torch.device, ...] = devs

    @property
    def size(self) -> int:
        """Shards per dispatch (devices counted with repetition)."""
        return len(self.devices)

    @property
    def distinct(self) -> int:
        """Distinct devices the mesh names."""
        return len(set(self.devices))

    @property
    def repeated(self) -> bool:
        """True when a device holds more than one shard."""
        return self.distinct < self.size

    def describe(self) -> dict:
        return {"devices": [str(d) for d in self.devices], "size": self.size,
                "distinct": self.distinct, "repeated": self.repeated}

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        tag = ", repeated" if self.repeated else ""
        return f"Mesh({', '.join(map(str, self.devices))}{tag})"


def default_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the given devices, or over every CUDA device (raises
    without CUDA)."""
    if devices is None:
        device_mod.resolve(None)  # raises without CUDA
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def engine_default_mesh(mode: str = "auto") -> Optional[Mesh]:
    """The mesh the engine adopts when the caller passed none: every CUDA
    device when at least two are present (``mode="auto"``), else None —
    single-device dispatch, the path of a one-card machine.  ``"off"``
    always gives None.  The reference's ``JEPSEN_TPU_ENGINE_MESH`` is this
    argument; its virtual-device mode has no counterpart here (a caller
    who wants a repeated-device mesh builds one with :class:`Mesh`)."""
    if mode not in MESH_MODES:
        raise ValueError(f"mesh mode {mode!r} is not one of {MESH_MODES}")
    if mode == "off" or not torch.cuda.is_available():
        return None
    if torch.cuda.device_count() < 2:
        return None
    return default_mesh()


def resolve_mesh(test: dict) -> Optional[Mesh]:
    """The test's analysis mesh: an explicit ``test["mesh"]``, or the
    lazily built ``test["mesh-fn"]``; None falls through to the engine's
    own resolution (:func:`engine_default_mesh`) at dispatch time."""
    m = test.get("mesh")
    if m is not None:
        return m
    fn = test.get("mesh-fn")
    return fn() if callable(fn) else None


def run_placement(device, mesh: Optional[Mesh] = None):
    """``(device, mesh)`` of an engine run: the caller's mesh (its first
    device is the run's device, and a ``device`` given beside it must be
    that one); else, when the caller named no device either,
    :func:`engine_default_mesh`; else no mesh and ``device`` resolved as
    :func:`jepsen_tpu_torch.device.resolve` resolves it."""
    if mesh is None and device is None:
        mesh = engine_default_mesh()
    if mesh is None:
        return device_mod.resolve(device), None
    if device is not None and device_mod.resolve(device) != mesh.devices[0]:
        raise ValueError(f"device {device} is not the first device of "
                         f"{mesh}")
    return mesh.devices[0], mesh


def pad_to_multiple(arr: np.ndarray, multiple: int, fill=0) -> np.ndarray:
    """Pad axis 0 up to a multiple of ``multiple`` with ``fill``."""
    b = arr.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return arr
    pad = np.full((rem,) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _device_ctx(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else \
        contextlib.nullcontext()


def _to_device(a, dev: torch.device) -> torch.Tensor:
    """One shard onto its device: host rows go through pinned memory with
    a non-blocking copy on the device's current stream."""
    t = a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    t = t.contiguous()
    if t.device == dev:
        return t
    if t.device.type == "cpu" and dev.type == "cuda":
        with torch.cuda.device(dev):
            return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def shard_batch(mesh: Mesh, *arrays):
    """Split each array (numpy or tensor, the same leading dimension, a
    multiple of the mesh size; use :func:`pad_to_multiple`) into
    ``mesh.size`` equal row shards and copy shard ``d`` to
    ``mesh.devices[d]``.  Returns one tuple of tensors per shard."""
    n = mesh.size
    B = arrays[0].shape[0]
    if any(a.shape[0] != B for a in arrays):
        raise ValueError("sharded arrays must share their leading dimension")
    if B % n:
        raise ValueError(f"{B} rows do not split into {n} equal shards")
    per = B // n
    return [tuple(_to_device(a[d * per:(d + 1) * per], dev) for a in arrays)
            for d, dev in enumerate(mesh.devices)]


def _on_device(fn, dev: torch.device):
    """``fn``'s counterpart on ``dev``: a checker holding per-device
    buffers (the dense automaton) says so with ``on_device``; every other
    checker runs where its inputs lie."""
    on_device = getattr(fn, "on_device", None)
    return fn if on_device is None else on_device(dev)


class ShardedFn:
    """A checker over a mesh: ``__call__(*arrays)`` takes host arrays whose
    rows split evenly over the mesh and returns the outputs output-major,
    one tuple of per-shard tensors per output, each shard on its device
    and nothing synchronised."""

    def __init__(self, check_fn, mesh: Mesh):
        self.mesh = mesh
        #: the per-device checkers, one per shard
        self.fns = tuple(_on_device(check_fn, d) for d in mesh.devices)

    def __call__(self, *arrays):
        shard_outs = []
        for fn, dev, shard in zip(self.fns, self.mesh.devices,
                                  shard_batch(self.mesh, *arrays)):
            with _device_ctx(dev):
                shard_outs.append(tuple(fn(*shard)))
        return tuple(zip(*shard_outs))


_shard_lock = threading.Lock()


def shard_fn(check_fn, mesh: Mesh) -> ShardedFn:
    """The sharded variant of a batched checker (the reference's
    ``shard_map`` wrapper): every input and output splits along the
    history axis, each device runs its own checker on its shard, no
    collective.  Cached per mesh on the checker object itself, the
    lifetime of the ``make_check_fn``/``make_dense_fn`` caches, so repeat
    dispatches reuse one set of per-device checkers."""
    key = mesh.devices
    with _shard_lock:
        cache = getattr(check_fn, "_sharded_variants", None)
        if cache is None:
            cache = {}
            try:
                check_fn._sharded_variants = cache
            except AttributeError:
                cache = None
        hit = None if cache is None else cache.get(key)
    if hit is not None:
        return hit
    wrapped = ShardedFn(check_fn, mesh)
    if cache is not None:
        with _shard_lock:
            wrapped = cache.setdefault(key, wrapped)
    return wrapped


def _live_shards(outs, rows: int):
    """Slice the padding rows (the tail of the last shards) off output-
    major per-shard outputs whose first ``rows`` rows are live."""
    per = outs[0][0].shape[0]
    keep = [min(max(rows - d * per, 0), per) for d in range(len(outs[0]))]
    return tuple(tuple(s[:k] for s, k in zip(o, keep)) for o in outs)


def sharded_check(check_fn, mesh: Mesh, init_state, ev_slot, cand_slot,
                  cand_f, cand_a, cand_b):
    """Run a batched history checker sharded over the mesh via
    :func:`shard_fn`.  The batch pads to a multiple of the mesh size with
    neutral all-padding rows (ev_slot/cand_slot = -1: no-op events, so
    they report valid) and the padding rows are sliced off again:
    returns ``(ok, failed_at, overflow)``, each a tuple of per-shard
    tensors holding only live rows (a tail shard may be short or empty),
    each on its device, nothing synchronised."""
    from ..ops import wgl

    n = mesh.size
    arrays = (init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b)
    b = arrays[0].shape[0]
    padded = tuple(pad_to_multiple(np.asarray(a), n, fill)
                   for a, fill in zip(arrays, wgl._PAD_FILLS))
    outs = shard_fn(check_fn, mesh)(*padded)
    return _live_shards(outs, b)


def sharded_elle(fn, mesh: Mesh, rel, n_out: int):
    """Run an Elle cycle-screen function (one ``(B, n, n)`` relation input,
    ``n_out`` outputs: flags or screen planes, then the closure rounds)
    sharded over the mesh via :func:`shard_fn`.  Padding rows are
    all-zero relations: edge-free, hence acyclic, hence neutral.  Returns
    the outputs output-major as per-shard tuples, live rows only."""
    n = mesh.size
    b = rel.shape[0]
    outs = shard_fn(fn, mesh)(pad_to_multiple(np.asarray(rel), n, 0))
    if len(outs) != n_out:
        raise ValueError(f"expected {n_out} outputs, got {len(outs)}")
    return _live_shards(outs, b)


# ---------------------------------------------------------------------------
# K9: verdict statistics
# ---------------------------------------------------------------------------


def verdict_stats_reference(ok: torch.Tensor,
                            overflow: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of one shard's counts: ``[valid, invalid,
    unknown]`` as an int64 ``[3]`` tensor on the inputs' device."""
    return torch.stack([(ok & ~overflow).sum(), (~ok & ~overflow).sum(),
                        overflow.sum()])


def _check_flags(ok: torch.Tensor, overflow: torch.Tensor) -> None:
    for t, name in ((ok, "ok"), (overflow, "overflow")):
        if t.dtype != torch.bool or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-d bool tensor")
    if ok.shape != overflow.shape or ok.device != overflow.device:
        raise ValueError("ok and overflow must match in shape and device")


#: up to this many rows one thread block counts a shard, past it a grid
#: (``VERDICT_STATS_SINGLE_MAX_ROWS`` in ``csrc/verdict_stats.cu``)
STATS_SINGLE_MAX_ROWS = 32768


def stats_design(B: int) -> str:
    """Which launch of the verdict-stats kernel ``B`` rows take:
    ``"single"`` (one block) or ``"grid"`` (blocks of partials summed by
    the last to finish)."""
    return "single" if B <= STATS_SINGLE_MAX_ROWS else "grid"


class VerdictStatsKernel:
    """Wrapper of the hand-written CUDA reduction ``csrc/verdict_stats.cu``
    (replaces ``jepsen_tpu/parallel/mesh.py:verdict_stats``'s sums).  Takes
    CUDA tensors only, of any alignment, launches once on the current
    stream of their device without synchronising (zero rows too: the
    kernel writes the zeros), and counts its launches in
    :attr:`launches`.  Past :data:`STATS_SINGLE_MAX_ROWS` rows the
    launches on one device share its kernel's ticket, so they must be
    ordered on one stream, as one caller's are."""

    name = "verdict_stats"

    def __init__(self):
        #: kernel launches so far (a plain counter; callers reset it)
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = _build.load(self.name).verdict_stats_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, ok: torch.Tensor,
                 overflow: torch.Tensor) -> torch.Tensor:
        _check_flags(ok, overflow)
        dev = ok.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
        counts = torch.empty((3,), dtype=torch.int64, device=dev)
        fn = self._entry()
        B = ok.shape[0]
        args = (ok.data_ptr(), overflow.data_ptr(), B, counts.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if torch.cuda.current_device() == dev.index:
            err = fn(*args)
        else:  # the launch goes to the calling thread's current device
            with torch.cuda.device(dev):
                err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err} "
                               f"(B={B})")
        self.launches += 1
        return counts


#: the one wrapper of the verdict-stats kernel
VERDICT_STATS = VerdictStatsKernel()


def shard_counts(ok: torch.Tensor, overflow: torch.Tensor) -> torch.Tensor:
    """One shard's ``[valid, invalid, unknown]``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if ok.is_cuda:
        return VERDICT_STATS(ok, overflow)
    _check_flags(ok, overflow)
    return verdict_stats_reference(ok, overflow)


def verdict_stats(ok, overflow, mesh: Optional[Mesh] = None
                  ) -> Dict[str, torch.Tensor]:
    """Aggregate verdict statistics: ``{"valid", "invalid", "unknown"}`` as
    0-d int64 tensors.  ``ok``/``overflow`` are bool tensors, or per-shard
    sequences of them (:func:`sharded_check`'s outputs, live rows only);
    each shard is counted on its own device and the counts are added on
    the mesh's first device (the reference's all-reduce), or on the first
    shard's device without a mesh."""
    oks = tuple(ok) if isinstance(ok, (list, tuple)) else (ok,)
    ovfs = tuple(overflow) if isinstance(overflow, (list, tuple)) \
        else (overflow,)
    if len(oks) != len(ovfs) or not oks:
        raise ValueError("ok and overflow need the same, nonzero number of "
                         "shards")
    if mesh is not None and len(oks) != mesh.size:
        raise ValueError(f"{len(oks)} shards for a mesh of {mesh.size}")
    home = mesh.devices[0] if mesh is not None else oks[0].device
    counts = [shard_counts(o, v) for o, v in zip(oks, ovfs)]
    total = counts[0].to(home)
    for c in counts[1:]:
        total = total + c.to(home)
    return {"valid": total[0], "invalid": total[1], "unknown": total[2]}
