"""Op codes, branchless model steps and model specs: how a model maps
onto the device encoding — the port of :mod:`jepsen_tpu.ops.step_kernels`.

- The ``F_*`` op codes, shared by every kernel (all twelve).
- The six branchless ``step(state, f, a, b) -> (state', ok)`` functions of
  the generic frontier search (kernel K3), as plain PyTorch on int
  tensors, and :data:`STEPS`, the table from spec name to step.  The CUDA
  kernel ``csrc/frontier_search.cu`` carries the same six as
  ``__device__`` functions; :mod:`.wgl`'s plain frontier version calls
  these.
- The per-model op encoders and initial states, and ``SPECS``, for the
  register, cas-register and mutex models (the others come with their
  ``check_batch`` support, ROADMAP.md queue A, item 5).

The steps keep XLA's integer semantics, which the reference runs under:
every step computes in int64 on sign-extended values and wraps to the
width XLA computes in (int32 state, int16 ``2a - 1`` in the reentrant
mutex), and a shift by an amount outside [0, 31] yields 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import models as m

# Op function codes shared by the register-family kernels.
F_READ = 0        # a = expected value id (observed at completion)
F_WRITE = 1       # a = written value id
F_CAS = 2         # a = expected old value id, b = new value id
F_READ_ANY = 3    # read with unknown value: always ok, no state change
F_ACQUIRE = 4     # mutex
F_RELEASE = 5     # mutex
F_ENQUEUE = 6     # unordered queue: a = value id
F_DEQUEUE = 7     # unordered queue: a = observed value id
F_RACQUIRE = 8    # reentrant mutex: a = client id
F_RRELEASE = 9    # reentrant mutex: a = client id
F_PACQUIRE = 10   # permit (semaphore) acquire: a = client id
F_PRELEASE = 11   # permit release: a = client id

#: Value id reserved for "unknown/None". Known values are 1-based.
V_UNKNOWN = 0


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor to ``bits`` bits, sign
    extended back to int64 (what XLA's fixed-width arithmetic yields)."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _widen(state, f, a, b):
    return state.long(), f.long(), a.long(), b.long()


def _state_out(state2: torch.Tensor, ok: torch.Tensor):
    return _wrap(state2, 32).to(torch.int32), ok


def register_step(state, f, a, b):
    """Read/write register.  (oracle: models.Register)"""
    state, f, a, _ = _widen(state, f, a, b)
    is_read = f == F_READ
    is_write = f == F_WRITE
    ok = is_write | (f == F_READ_ANY) | (is_read & (state == a))
    return _state_out(torch.where(is_write, a, state), ok)


def cas_register_step(state, f, a, b):
    """Read/write/compare-and-set register.  (oracle: models.CASRegister)"""
    state, f, a, b = _widen(state, f, a, b)
    is_write = f == F_WRITE
    cas_ok = (f == F_CAS) & (state == a)
    ok = (is_write | (f == F_READ_ANY) | ((f == F_READ) & (state == a))
          | cas_ok)
    state2 = torch.where(is_write, a, torch.where(cas_ok, b, state))
    return _state_out(state2, ok)


def mutex_step(state, f, a, b):
    """Lock: state 0 = free, 1 = held.  (oracle: models.Mutex)"""
    state, f, _, _ = _widen(state, f, a, b)
    is_acq = f == F_ACQUIRE
    is_rel = f == F_RELEASE
    ok = (is_acq & (state == 0)) | (is_rel & (state == 1))
    state2 = torch.where(is_acq, 1, torch.where(is_rel, 0, state))
    return _state_out(state2, ok)


def reentrant_mutex_step(state, f, a, b):
    """Reentrant owner-aware mutex with hold bound 2: 0 = free, 2c-1 =
    client c holds once, 2c = twice (a = client id c ≥ 1).  ``2a - 1``
    and ``2a`` wrap in int16, as the reference computes them on the
    int16 ``a``.  (oracle: models.ReentrantMutex)"""
    state, f, a, _ = _widen(state, f, a, b)
    is_acq = f == F_RACQUIRE
    is_rel = f == F_RRELEASE
    once = _wrap(2 * a - 1, 16)
    twice = _wrap(2 * a, 16)
    acq_fresh = is_acq & (state == 0)
    acq_re = is_acq & (state == once)
    rel_two = is_rel & (state == twice)
    rel_one = is_rel & (state == once)
    ok = acq_fresh | acq_re | rel_two | rel_one
    state2 = torch.where(
        acq_fresh, once,
        torch.where(acq_re, twice,
                    torch.where(rel_two, once,
                                torch.where(rel_one, 0, state))))
    return _state_out(state2, ok)


#: multi-register packing: up to 4 registers, 8-bit value ids each, in
#: one int32 state word
MR_REGISTERS = 4
MR_VALUE_BITS = 8
MR_MAX_VALUE_ID = (1 << MR_VALUE_BITS) - 1


def multi_register_step(state, f, a, b):
    """Single-mop multi-register: b = register index, a = value id; the
    int32 state packs MR_REGISTERS byte-wide registers.
    (oracle: models.MultiRegister)"""
    state, f, a, b = _widen(state, f, a, b)
    sh = (b & (MR_REGISTERS - 1)) * MR_VALUE_BITS
    mask = _wrap(torch.full_like(sh, MR_MAX_VALUE_ID) << sh, 32)
    cur = (state >> sh) & MR_MAX_VALUE_ID
    is_write = f == F_WRITE
    ok = is_write | (f == F_READ_ANY) | ((f == F_READ) & (cur == a))
    written = (state & ~mask) | _wrap((a & MR_MAX_VALUE_ID) << sh, 32)
    return _state_out(torch.where(is_write, written, state), ok)


#: unordered-queue packing: a bitset of present values in one int32
#: (unique values only; ids 1..31 → bits 0..30)
UQ_MAX_VALUES = 31


def unordered_queue_step(state, f, a, b):
    """Bag of unique values as a bitset: value id a is bit ``a - 1``; a
    shift amount outside [0, 31] gives no bit, and ``1 << 31`` is
    INT_MIN, as in XLA.  (oracle: models.UnorderedQueue restricted to
    multiplicity ≤ 1)"""
    state, f, a, _ = _widen(state, f, a, b)
    sh = a - 1
    in_range = (sh >= 0) & (sh < 32)
    bit = torch.where(in_range,
                      _wrap(torch.ones_like(sh) << sh.clamp(0, 31), 32), 0)
    present = (state & bit) != 0
    is_enq = f == F_ENQUEUE
    is_deq = f == F_DEQUEUE
    ok = (is_enq & ~present) | (is_deq & present)
    state2 = torch.where(is_enq, state | bit,
                         torch.where(is_deq, state & ~bit, state))
    return _state_out(state2, ok)


#: the frontier search's step per spec name (owner-mutex reuses the
#: cas-register step, as in the reference)
STEPS: Dict[str, Callable] = {
    "register": register_step,
    "cas-register": cas_register_step,
    "mutex": mutex_step,
    "owner-mutex": cas_register_step,
    "reentrant-mutex": reentrant_mutex_step,
    "multi-register": multi_register_step,
    "unordered-queue": unordered_queue_step,
}

_KERNEL_STEPS = list(dict.fromkeys(STEPS.values()))

#: the step's number in ``csrc/frontier_search.cu`` (``kStep*``): the
#: distinct functions of :data:`STEPS` in order of first appearance
STEP_IDS: Dict[str, int] = {
    name: _KERNEL_STEPS.index(fn) for name, fn in STEPS.items()}


@dataclass(frozen=True)
class ModelSpec:
    """Host-side description of how a model maps onto the kernel."""

    name: str
    #: encode an op (with completion value already propagated) into
    #: (f, a, b) int codes, given a mutable value→id map
    encode_op: Callable[[Any, Dict[Any, int]], Tuple[int, int, int]]
    #: initial kernel state from the oracle model instance
    init_state: Callable[[m.Model, Dict[Any, int]], int]
    #: fs that never change state — indeterminate ones are stripped
    pure_fs: Tuple[str, ...]
    #: the branchless (state, f, a, b) -> (state', ok) step of the
    #: frontier search, as the reference's spec carries it (its entry in
    #: :data:`STEPS`, which the frontier search reads)
    step: Optional[Callable] = None


def _value_id(value, valmap: Dict[Any, int]) -> int:
    if value is None:
        return V_UNKNOWN
    vid = valmap.get(value)
    if vid is None:
        vid = len(valmap) + 1  # ids are 1-based; 0 is V_UNKNOWN
        valmap[value] = vid
    return vid


def _encode_register_op(op, valmap) -> Tuple[int, int, int]:
    if op.f == "write":
        return F_WRITE, _value_id(op.value, valmap), 0
    if op.f == "read":
        if op.value is None:
            return F_READ_ANY, 0, 0
        return F_READ, _value_id(op.value, valmap), 0
    raise ValueError(f"register cannot encode op f={op.f!r}")


def _encode_cas_op(op, valmap) -> Tuple[int, int, int]:
    if op.f == "cas":
        if op.value is None:
            raise ValueError("cas with nil value is never linearizable")
        old, new = op.value
        return F_CAS, _value_id(old, valmap), _value_id(new, valmap)
    return _encode_register_op(op, valmap)


def _encode_mutex_op(op, valmap) -> Tuple[int, int, int]:
    if op.f == "acquire":
        return F_ACQUIRE, 0, 0
    if op.f == "release":
        return F_RELEASE, 0, 0
    raise ValueError(f"mutex cannot encode op f={op.f!r}")


def _register_init(model, valmap) -> int:
    return _value_id(model.value, valmap)


SPECS: Dict[type, ModelSpec] = {
    m.Register: ModelSpec(
        name="register",
        encode_op=_encode_register_op,
        init_state=_register_init,
        pure_fs=("read",),
        step=STEPS["register"],
    ),
    m.CASRegister: ModelSpec(
        name="cas-register",
        encode_op=_encode_cas_op,
        init_state=_register_init,
        pure_fs=("read",),
        step=STEPS["cas-register"],
    ),
    m.Mutex: ModelSpec(
        name="mutex",
        encode_op=_encode_mutex_op,
        init_state=lambda model, valmap: 1 if model.locked else 0,
        pure_fs=(),
        step=STEPS["mutex"],
    ),
}


def spec_for(model: m.Model) -> Optional[ModelSpec]:
    return SPECS.get(type(model))
