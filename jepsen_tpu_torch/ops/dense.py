"""Dense subset-automaton linearizability checker for register-family
models — the port of :mod:`jepsen_tpu.ops.dense` (register, cas-register
and mutex transitions).

For models whose state enumerates to a small integer domain there is a
representation with no frontier to overflow:

    D[v, s] = 1  iff some linearization order of the ops in subset ``s``
              (of the ≤C currently-open slots) takes the register from
              the promoted prefix to value id ``v``.

``D`` is bit-packed along the subset axis into 32-bit words.  Per event a
[C, V, V] transition is built from the candidate op codes (read keeps one
value row, write folds every row into one, cas moves row a to row b,
mutex ops are cas in disguise); the closure linearizes every open slot in
one pass — the subset map ``s → s | bit_j`` is a masked word shift for
j < 5 and a word permutation for j ≥ 5 — until fixpoint (≤ C + 2 passes);
completion of slot e applies ``s → s \\ bit_e``.  An empty D at a
completion fails the history at that event.

Three forms of the one function live here:

- :func:`dense_check_reference`, the plain PyTorch version: batch-wide,
  a Python loop over events and closure passes on int64 tensors that
  carry the 32-bit words (``uint32`` has no shifts or comparisons in
  PyTorch on the CPU, and ``int32 >>`` is arithmetic).  The CPU tests
  hold it byte for byte against the JAX kernel.
- :data:`DENSE_AUTOMATON`, the wrapper of the hand-written CUDA kernel
  ``csrc/dense_automaton.cu`` (one thread block per history, D in shared
  memory), with its launch counter.
- :class:`DenseChecker`, the module the engine calls: the kernel for CUDA
  tensors, the plain version for CPU tensors, nothing else.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import _build
from .step_kernels import F_ACQUIRE, F_CAS, F_READ_ANY, F_RELEASE, F_WRITE

#: specs whose state is exactly "current value id" and whose op codes the
#: kernel's transitions cover (mutex: 0 = free, 1 = held, ops as cas)
DENSE_SPECS = ("register", "cas-register", "mutex")

#: dense envelope: beyond these the generic frontier search takes over
MAX_C = 12   # 2^12 subsets = 128 packed words
MAX_V = 32

#: word mask of the 32-bit lanes the int64 words carry
_U32 = 0xFFFFFFFF


def applicable(spec_name: str, C: int, V: int) -> bool:
    """True when a ``(C, V)`` bucket of ``spec_name`` fits the dense
    automaton (``V`` is the value-domain size, rounded up to 4)."""
    return spec_name in DENSE_SPECS and C <= MAX_C and V <= MAX_V


#: _LOMASK[j]: bits of a 32-subset word whose subset index has bit j clear
_LOMASK = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)


def _n_words(C: int) -> int:
    return max(1, (1 << C) // 32)


def _subset_maps(C: int):
    """Static per-slot tables for the packed-axis subset maps, as numpy
    (the same arrays :func:`jepsen_tpu.ops.dense._subset_maps` builds).

    union (``s → s | bit_j``, image restricted to s ∋ j):
        out[k] = (x[uidx[j,k]] & umask[j,k]) << ushl[j]
    drop (``s → s \\ bit_j``, image restricted to s ∌ j):
        out[k] = (x[didx[j,k]] >> dshr[j]) & dmask[j,k]

    For j < 5 the map moves bits inside a word (mask + shift); for j ≥ 5
    it permutes whole words (static gather + output mask).
    """
    W = _n_words(C)
    k = np.arange(W)
    uidx = np.zeros((C, W), np.int32)
    umask = np.zeros((C, W), np.uint32)
    ushl = np.zeros((C,), np.uint32)
    didx = np.zeros((C, W), np.int32)
    dmask = np.zeros((C, W), np.uint32)
    dshr = np.zeros((C,), np.uint32)
    for j in range(C):
        if j < 5:
            uidx[j] = k
            umask[j] = _LOMASK[j]
            ushl[j] = 1 << j
            didx[j] = k
            dmask[j] = _LOMASK[j]
            dshr[j] = 1 << j
        else:
            wb = 1 << (j - 5)
            uidx[j] = k ^ wb
            umask[j] = np.where((k & wb) != 0, 0xFFFFFFFF, 0)
            didx[j] = k | wb
            dmask[j] = np.where((k & wb) == 0, 0xFFFFFFFF, 0)
    return uidx, umask, ushl, didx, dmask, dshr


def _subset_has(C: int) -> np.ndarray:
    """has[j]: [W] uint32 mask of packed bits whose subset index has bit
    j SET — the "configs that linearized slot j" selector.  The kernel
    folds it into ``didx``/``dshr``; it is kept so that
    :func:`~jepsen_tpu_torch.ops.carry.tables_from_reference` can hold
    all of the port's tables against the reference's."""
    W = _n_words(C)
    k = np.arange(W)
    has = np.zeros((C, W), np.uint32)
    for j in range(C):
        if j < 5:
            has[j] = np.uint32(0xFFFFFFFF ^ _LOMASK[j])
        else:
            has[j] = np.where((k & (1 << (j - 5))) != 0, 0xFFFFFFFF, 0)
    return has


# Host word-packing, copied with the reference's tables; the main path
# does not pack words yet (the Elle slice's bit packing, K8, will).

#: boolean lanes carried per packed word
WORD_LANES = 32


def word_count(n: int) -> int:
    """uint32 words needed to carry ``n`` boolean lanes (≥ 1)."""
    return max(1, -(-n // WORD_LANES))


def pack_words_np(bits: np.ndarray) -> np.ndarray:
    """Host word-packing: ``(..., n) bool → (..., W) uint32`` with lane
    ``j`` stored at word ``j // 32``, bit position ``j % 32`` (little bit
    order, the layout ``np.packbits(bitorder="little")`` emits)."""
    bits = np.asarray(bits, bool)
    n = bits.shape[-1]
    W = word_count(n)
    pad = W * WORD_LANES - n
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), bool)], axis=-1
        )
    by = np.packbits(bits, axis=-1, bitorder="little").astype(np.uint32)
    by = by.reshape(bits.shape[:-1] + (W, 4))
    return (by[..., 0]
            | (by[..., 1] << np.uint32(8))
            | (by[..., 2] << np.uint32(16))
            | (by[..., 3] << np.uint32(24)))


def unpack_words_np(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_words_np`: ``(..., W) uint32 → (..., n)``
    bool — lanes past ``n`` are word-floor padding and are dropped."""
    words = np.asarray(words, np.uint32)
    shifts = np.arange(WORD_LANES, dtype=np.uint32)
    lanes = (words[..., None] >> shifts) & np.uint32(1)
    return lanes.reshape(words.shape[:-1] + (-1,))[..., :n].astype(bool)


Tables = Tuple[torch.Tensor, ...]


def subset_tables(C: int, device=None) -> Tables:
    """:func:`_subset_maps` as int64 tensors on ``device`` — the form the
    plain version indexes and shifts with."""
    return tuple(
        torch.as_tensor(t.astype(np.int64), device=device)
        for t in _subset_maps(C)
    )


def _transitions(f_s, a_s, b_s, active, V: int) -> torch.Tensor:
    """Per-slot transition ``T[b, j, v', v]``: does linearizing slot j move
    value v to v'?  (mutex ops are cas in disguise: acquire = cas(0, 1),
    release = cas(1, 0))."""
    dev = f_s.device
    is_acq = f_s == F_ACQUIRE
    is_rel = f_s == F_RELEASE
    a_eff = torch.where(is_acq, 0, torch.where(is_rel, 1, a_s))
    b_eff = torch.where(is_acq, 1, torch.where(is_rel, 0, b_s))
    is_write = (f_s == F_WRITE)[..., None, None]
    is_ra = (f_s == F_READ_ANY)[..., None, None]
    cas_like = ((f_s == F_CAS) | is_acq | is_rel)[..., None, None]
    vp = torch.arange(V, device=dev)[None, None, :, None]  # v'
    vv = torch.arange(V, device=dev)[None, None, None, :]  # v
    am = a_eff[..., None, None]
    bm = b_eff[..., None, None]
    T = torch.where(
        is_write,
        vp == am,
        torch.where(
            is_ra,
            vp == vv,
            torch.where(cas_like, (vp == bm) & (vv == am),
                        (vp == am) & (vv == am)),  # read
        ),
    )
    return T & active[..., None, None]


def dense_check_reference(
    init_state: torch.Tensor,
    ev_slot: torch.Tensor,
    cand_slot: torch.Tensor,
    cand_f: torch.Tensor,
    cand_a: torch.Tensor,
    cand_b: torch.Tensor,
    V: int,
    tables: Optional[Tables] = None,
    work: Optional[dict] = None,
):
    """The plain PyTorch version of the dense automaton, on any device:
    ``(ok [B] bool, failed_at [B] int32, overflow [B] bool)`` for the
    encoded batch (the :class:`~jepsen_tpu_torch.ops.encode.EncodedBatch`
    arrays as tensors).  Same Jacobi closure passes, same C + 2 cap and a
    per-row "changed" mask, so every row stops exactly where the
    reference's vmapped ``while_loop`` stops it; each event works on the
    rows still searching only.  ``tables`` are
    :func:`subset_tables` for ``C`` on the inputs' device (built when
    omitted).

    ``work``, when given, gains ``"int_ops"``: the 32-bit ALU operations
    the function needs for these inputs — the count ``chip_smoke.py``
    prices the kernel's bound with.  Per row still searching and per
    closure pass that changes its D: one OR per source bit of each live
    (slot, target, word), then the word's AND, shift and OR into the
    pass's update (slot j < 5), or that OR alone (j ≥ 5: the mask and
    shift are the identity and half the words are zero); then D | update
    and the fixpoint compare per word.  Per completion: shift, AND and
    emptiness OR per word (slot < 5), or the emptiness OR per live word.
    Not counted: loads and stores, building the transitions, and the pass
    that only confirms the fixpoint."""
    dev = ev_slot.device
    B, E = ev_slot.shape
    C = cand_slot.shape[2]
    W = _n_words(C)
    if tables is None:
        tables = subset_tables(C, dev)
    uidx, umask, ushl, didx, dmask, dshr = tables
    max_closure = C + 2
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    slots = torch.arange(C, device=dev)
    umask_b = umask[None, :, None, :]
    ushl_b = ushl[None, :, None, None]
    dmask_b = dmask[None, :, None, :]
    dshr_b = dshr[None, :, None, None]

    D = torch.zeros((B, V, W), dtype=torch.int64, device=dev)
    init = init_state.long().clamp(0, V - 1)
    D[torch.arange(B, device=dev), init, 0] = 1
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    failed_at = torch.full((B,), -1, dtype=torch.int32, device=dev)
    int_ops = 0
    if work is not None:  # live words per slot, and ops to fold one in
        low = slots[None, :, None] < 5
        live_w = torch.where(low, W, W // 2)
        fold_w = torch.where(low, 3 * W, W // 2)

    for e in range(E):
        # only rows still searching do work: a padding event keeps D and
        # the verdict, and a finished row never changes again (the
        # reference parks it on an empty D)
        rows = ((ev_slot[:, e] >= 0) & ~done).nonzero().squeeze(1)
        n = rows.numel()
        if n == 0:
            continue
        es = ev_slot[rows, e].long()
        # regroup candidate lanes by SLOT id (at most one lane holds it)
        eq = cand_slot[rows, e].long()[:, None, :] == slots[None, :, None]
        active = eq.any(dim=2)
        f_s = torch.where(eq, cand_f[rows, e].long()[:, None, :], zero).sum(2)
        a_s = torch.where(eq, cand_a[rows, e].long()[:, None, :], zero).sum(2)
        b_s = torch.where(eq, cand_b[rows, e].long()[:, None, :], zero).sum(2)
        T = _transitions(f_s, a_s, b_s, active, V)
        T64 = T.long()  # 0/1 factors: T64 * word == (word if T else 0)
        if work is not None:
            per_pass = ((T.sum(3) * live_w).sum((1, 2))
                        + (T.any(3) * fold_w).sum((1, 2)) + 2 * V * W)

        # --- closure: Jacobi passes to fixpoint, capped, per-row stop ---
        uidx_b = uidx[None, :, None, :].expand(n, C, V, W)
        Dc = D[rows]
        on = torch.ones((n,), dtype=torch.bool, device=dev)
        for _ in range(max_closure):
            X = torch.zeros((n, C, V, W), dtype=torch.int64, device=dev)
            for v in range(V):
                X |= T64[:, :, :, v, None] * Dc[:, None, None, v, :]
            U = (torch.gather(X, 3, uidx_b) & umask_b) << ushl_b
            add = U[:, 0]
            for j in range(1, C):
                add = add | U[:, j]
            Dn = (Dc | add) & _U32
            changed = (Dn != Dc).flatten(1).any(1) & on
            if work is not None:
                int_ops += int((per_pass * changed).sum())
            Dc = torch.where(on[:, None, None], Dn, Dc)
            on = changed
            if not bool(on.any()):
                break

        # --- completion: keep configs that linearized e_slot, then
        # promote it out of the linset ---
        Ds = torch.gather(Dc[:, None].expand(n, C, V, W), 3,
                          didx[None, :, None, :].expand(n, C, V, W))
        Dvar = (Ds >> dshr_b) & dmask_b
        onehot = es[:, None] == slots[None, :]
        # at most one slot selected per row, so the sum is the OR
        Df = torch.where(onehot[:, :, None, None], Dvar, zero).sum(1)
        empty = ~(Df != 0).flatten(1).any(1)
        if work is not None:
            int_ops += int(torch.where(es < 5, 3 * V * W, V * (W // 2)).sum())
        D[rows] = Df  # an emptied row parks on D = 0
        failed = rows[empty]
        done[failed] = True
        failed_at[failed] = e

    if work is not None:
        work["int_ops"] = work.get("int_ops", 0) + int_ops
    return ~done, failed_at, torch.zeros((B,), dtype=torch.bool, device=dev)


_IN_DTYPES = (torch.int32, torch.int32, torch.int8, torch.int8, torch.int16,
              torch.int16)
_IN_NAMES = ("init_state", "ev_slot", "cand_slot", "cand_f", "cand_a",
             "cand_b")


def batch_shape(arrays) -> Tuple[int, int, int]:
    """Validate an encoded batch as tensors — dtypes, ranks, shapes, one
    device, contiguity — and return ``(B, E, C)``."""
    if len(arrays) != 6:
        raise ValueError("expected the six EncodedBatch arrays")
    for t, dt, name in zip(arrays, _IN_DTYPES, _IN_NAMES):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != arrays[0].device:
            raise ValueError(f"{name} is on {t.device}, init_state on "
                             f"{arrays[0].device}")
    init_state, ev_slot, cand_slot = arrays[:3]
    if init_state.dim() != 1 or ev_slot.dim() != 2 or cand_slot.dim() != 3:
        raise ValueError("shapes must be init_state [B], ev_slot [B, E], "
                         "cand_* [B, E, C]")
    B, E, C = cand_slot.shape
    if init_state.shape[0] != B or tuple(ev_slot.shape) != (B, E):
        raise ValueError("init_state/ev_slot disagree with cand_slot's "
                         "[B, E, C]")
    for t, name in zip(arrays[3:], _IN_NAMES[3:]):
        if tuple(t.shape) != (B, E, C):
            raise ValueError(f"{name} must be [B, E, C] = {(B, E, C)}")
    return B, E, C


def check_inputs(arrays, V: int) -> Tuple[int, int, int]:
    """:func:`batch_shape`, plus the dense envelope; ``(B, E, C)``."""
    B, E, C = batch_shape(arrays)
    if not 1 <= C <= MAX_C or not 1 <= V <= MAX_V:
        raise ValueError(f"(C={C}, V={V}) is outside the dense envelope "
                         f"(C ≤ {MAX_C}, V ≤ {MAX_V})")
    return B, E, C


class DenseAutomatonKernel:
    """Wrapper of the hand-written CUDA kernel ``csrc/dense_automaton.cu``
    (replaces ``jepsen_tpu/ops/dense.py:build_dense``).  Takes CUDA
    tensors only, launches on the current stream without synchronising,
    and counts its launches in :attr:`launches`."""

    name = "dense_automaton"

    def __init__(self):
        #: kernel launches so far (a plain counter; callers reset it)
        self.launches = 0
        self._fn = None

    def _entry(self):
        if self._fn is None:
            fn = _build.load(self.name).dense_automaton_launch
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, init_state, ev_slot, cand_slot, cand_f, cand_a,
                 cand_b, V: int):
        arrays = (init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b)
        B, E, C = check_inputs(arrays, V)
        dev = init_state.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
        ok = torch.empty((B,), dtype=torch.bool, device=dev)
        failed_at = torch.empty((B,), dtype=torch.int32, device=dev)
        overflow = torch.empty((B,), dtype=torch.bool, device=dev)
        if B == 0:
            return ok, failed_at, overflow
        fn = self._entry()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(*(t.data_ptr() for t in arrays), ok.data_ptr(),
                     failed_at.data_ptr(), overflow.data_ptr(), B, E, C, V,
                     stream)
        if err != 0:
            raise RuntimeError(f"dense_automaton launch failed: CUDA error "
                               f"{err} (B={B}, E={E}, C={C}, V={V})")
        self.launches += 1
        return ok, failed_at, overflow


#: the one wrapper of the dense-automaton kernel (its launch count is
#: what shows that a run went through the kernel)
DENSE_AUTOMATON = DenseAutomatonKernel()


class DenseChecker(nn.Module):
    """The dense checker for one ``(spec, E, C, V)`` shape:
    ``forward(init_state, ev_slot, cand_slot, cand_f, cand_a, cand_b) ->
    (ok, failed_at, overflow)``.  CUDA tensors go to the CUDA kernel, CPU
    tensors to the plain version; there is no fallback between the two.
    The subset-map tables are buffers, so they follow the module's
    device."""

    def __init__(self, spec_name: str, E: int, C: int, V: int):
        super().__init__()
        if not applicable(spec_name, C, V):
            raise ValueError(f"no dense kernel for {spec_name!r} at C={C}, "
                             f"V={V}")
        self.spec_name, self.E, self.C, self.V = spec_name, E, C, V
        for name, t in zip(("uidx", "umask", "ushl", "didx", "dmask", "dshr"),
                           subset_tables(C)):
            self.register_buffer(name, t, persistent=False)

    def tables(self) -> Tables:
        return (self.uidx, self.umask, self.ushl, self.didx, self.dmask,
                self.dshr)

    def reference(self, *arrays, work: Optional[dict] = None):
        """The plain PyTorch version on the arrays' device."""
        check_inputs(arrays, self.V)
        return dense_check_reference(*arrays, V=self.V, tables=self.tables(),
                                     work=work)

    def forward(self, *arrays):
        if arrays[0].is_cuda:
            return DENSE_AUTOMATON(*arrays, V=self.V)
        return self.reference(*arrays)


@lru_cache(maxsize=64)
def make_dense_fn(spec_name: str, E: int, C: int, V: int,
                  device: torch.device) -> DenseChecker:
    """The cached :class:`DenseChecker` for a shape, its buffers on
    ``device`` (one module per ``(spec, E, C, V, device)``, like the
    reference's per-shape jit cache)."""
    return DenseChecker(spec_name, E, C, V).to(device)
