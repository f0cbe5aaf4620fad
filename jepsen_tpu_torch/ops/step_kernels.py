"""Op codes, branchless model steps and model specs: how a model maps
onto the device encoding — the port of :mod:`jepsen_tpu.ops.step_kernels`.

- The ``F_*`` op codes, shared by every kernel (all twelve).
- The six branchless ``step(state, f, a, b) -> (state', ok)`` functions of
  the generic frontier search (kernel K3), as plain PyTorch on int
  tensors, and :data:`STEPS`, the table from spec name to step.  The CUDA
  kernel ``csrc/frontier_search.cu`` carries the same six as
  ``__device__`` functions; :mod:`.wgl`'s plain frontier version calls
  these.
- The per-model op encoders and initial states, and ``SPECS``, the
  model table ``check_batch`` takes: register, cas-register, mutex,
  multi-register, unordered queue, owner-aware and reentrant mutexes
  and the permit semaphore (the last dense-only: its transitions are
  host tables, :func:`jepsen_tpu_torch.ops.dense.permits_tables`, and it
  has no step).  Models without a spec (the fenced mutexes, the FIFO
  queue, the multi-mutex) ride the CPU oracle.

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
    """Host-side description of how a model maps onto the kernels.  The
    frontier search's step is not a field: :data:`STEPS` is the one
    table of steps, keyed by :attr:`name`."""

    name: str
    #: encode an op (with completion value already propagated) into
    #: (f, a, b) int codes, given a mutable value→id map
    encode_op: Callable[[Any, Dict[Any, int]], Tuple[int, int, int]]
    #: initial kernel state from the oracle model instance
    init_state: Callable[[m.Model, Dict[Any, int]], int]
    #: fs that never change state — indeterminate ones are stripped
    pure_fs: Tuple[str, ...]
    #: True when only the dense automaton exists for this spec (its
    #: state enumeration is built from host tables no step function
    #: expresses, so it has no entry in :data:`STEPS`); outside the
    #: dense envelope such batches go to the oracle, never the frontier
    #: search
    dense_only: bool = False


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


def _owner_client(op):
    # the oracle's identity extraction (models.locks._client) is the
    # single source of truth: encoder and oracle MUST agree on WHO
    # acted or device and oracle verdicts diverge
    from ..models.locks import _client

    client = _client(op)
    if client is None:
        # an op that never reported WHO acted (e.g. a crashed acquire
        # whose client died before stamping) cannot ride the value
        # automaton; the whole history falls back to the oracle
        raise ValueError("owner-mutex op without client identity")
    return client


def _rm_client_id(client, valmap: Dict[Any, int]) -> int:
    """1-based client index (the reentrant encoder interns nothing
    else, so _value_id stays contiguous over clients); the state
    domain is 2·N+1 ids for N clients (see reentrant_mutex_step)."""
    return _value_id(("rm-client", client), valmap)


def _encode_reentrant_mutex_op(op, valmap) -> Tuple[int, int, int]:
    """Reentrant mutex ops: a = client index; the step function owns
    the (free / once / twice) state algebra.  Only the reference's
    hold bound of 2 has a kernel; other bounds ride the oracle (the
    spec's init_state raises)."""
    client = _owner_client(op)
    cid = _rm_client_id(client, valmap)
    if op.f == "acquire":
        return F_RACQUIRE, cid, 0
    if op.f == "release":
        return F_RRELEASE, cid, 0
    raise ValueError(f"reentrant-mutex cannot encode op f={op.f!r}")


def _reentrant_mutex_init(model, valmap) -> int:
    from ..models.locks import REENTRANT_ACQUIRE_COUNT

    if model.max_count != REENTRANT_ACQUIRE_COUNT:
        raise ValueError(
            "reentrant-mutex kernel supports the hold bound of "
            f"{REENTRANT_ACQUIRE_COUNT} only"
        )
    if model.owner is None:
        return 0
    if model.count not in (1, 2):
        # a held owner with a count outside the algebra (count=0 is
        # constructible) has no state id — oracle fallback, not a
        # silently-diverging kernel verdict
        raise ValueError("reentrant-mutex init outside the kernel algebra")
    cid = _rm_client_id(model.owner, valmap)
    return 2 * cid - 1 if model.count == 1 else 2 * cid


def _pm_client_id(client, valmap: Dict[Any, int]) -> int:
    """1-based client index for the permit automaton (the permits
    encoder interns nothing else, so _value_id stays contiguous)."""
    return _value_id(("pm-client", client), valmap)


def _encode_permits_op(op, valmap) -> Tuple[int, int, int]:
    """Semaphore permit ops: a = client index.  The state enumeration
    (multisets of ≤ n_permits client ids) lives in host tables built by
    the dense kernel (ops/dense.py permits_tables); no branchless step
    function exists, so the spec is dense_only."""
    client = _owner_client(op)
    cid = _pm_client_id(client, valmap)
    if op.f == "acquire":
        return F_PACQUIRE, cid, 0
    if op.f == "release":
        return F_PRELEASE, cid, 0
    raise ValueError(f"acquired-permits cannot encode op f={op.f!r}")


def _permits_init(model, valmap) -> int:
    if model.acquired:
        # a non-empty initial multiset needs the global state
        # enumeration, which depends on the final client count the
        # encoder can't know yet — oracle fallback
        raise ValueError("acquired-permits kernel needs an empty start")
    return 0


def _encode_owner_mutex_op(op, valmap) -> Tuple[int, int, int]:
    """The owner-aware mutex IS a cas-register in disguise: state =
    holder ("free" is its own value id), acquire(c) = cas(free → c),
    release(c) = cas(c → free) — so the whole cas-register kernel
    family (dense subset automaton included) applies unchanged.  Client
    identities ride the value-id map like register values."""
    client = _owner_client(op)
    free = _value_id("__free__", valmap)
    cid = _value_id(("client", client), valmap)
    if op.f == "acquire":
        return F_CAS, free, cid
    if op.f == "release":
        return F_CAS, cid, free
    raise ValueError(f"owner-mutex cannot encode op f={op.f!r}")


def _owner_mutex_init(model, valmap) -> int:
    if model.owner is None:
        return _value_id("__free__", valmap)
    return _value_id(("client", model.owner), valmap)


def _register_init(model, valmap) -> int:
    return _value_id(model.value, valmap)


def _mr_reg_id(k, valmap: Dict[Any, int]) -> int:
    """Register index for key k; at most MR_REGISTERS distinct keys."""
    key = ("mrreg", k)
    r = valmap.get(key)
    if r is None:
        r = valmap.get("__mr_nreg__", 0)
        if r >= MR_REGISTERS:
            raise ValueError("too many registers for the packed kernel")
        valmap[key] = r
        valmap["__mr_nreg__"] = r + 1
    return r


def _mr_value_id(reg: int, v, valmap: Dict[Any, int]) -> int:
    """Per-register value ids so each stays within MR_VALUE_BITS."""
    if v is None:
        return V_UNKNOWN
    key = ("mrval", reg, v)
    vid = valmap.get(key)
    if vid is None:
        nkey = ("mrn", reg)
        vid = valmap.get(nkey, 0) + 1
        if vid > MR_MAX_VALUE_ID:
            raise ValueError("too many distinct values for one register")
        valmap[key] = vid
        valmap[nkey] = vid
    return vid


def _encode_multi_register_op(op, valmap) -> Tuple[int, int, int]:
    """Single-mop [(f, k, v)] transactions; multi-mop ones fall back to
    the oracle (models.MultiRegister handles arbitrary mop lists)."""
    mops = list(op.value or [])
    if not mops:
        return F_READ_ANY, 0, 0
    if len(mops) != 1:
        raise ValueError("multi-mop transactions ride the oracle")
    mf, k, v = mops[0]
    reg = _mr_reg_id(k, valmap)
    if mf in ("w", "write"):
        if v is None:
            raise ValueError("write of nil is never linearizable")
        return F_WRITE, _mr_value_id(reg, v, valmap), reg
    if mf in ("r", "read"):
        if v is None:
            return F_READ_ANY, 0, reg
        return F_READ, _mr_value_id(reg, v, valmap), reg
    raise ValueError(f"multi-register cannot encode mop f={mf!r}")


def _mr_init(model, valmap) -> int:
    state = 0
    for k, v in dict(model.values).items():
        reg = _mr_reg_id(k, valmap)
        vid = _mr_value_id(reg, v, valmap)
        state |= vid << (reg * MR_VALUE_BITS)
    return state


def _uq_value_id(v, valmap: Dict[Any, int]) -> int:
    """Namespaced ids with their own counter (like _mr_value_id) —
    sharing _value_id's len(valmap)-based counter would double-count
    the bookkeeping keys below and halve the usable envelope."""
    if v is None:
        raise ValueError("queue op with unknown value rides the oracle")
    key = ("uqval", v)
    vid = valmap.get(key)
    if vid is None:
        vid = valmap.get("__uq_n__", 0) + 1
        if vid > UQ_MAX_VALUES:
            raise ValueError(
                "too many distinct values for the bitset kernel"
            )
        valmap[key] = vid
        valmap["__uq_n__"] = vid
    return vid


def _encode_unordered_queue_op(op, valmap) -> Tuple[int, int, int]:
    if op.f == "enqueue":
        vid = _uq_value_id(op.value, valmap)
        key = ("uq-enq", vid)
        if valmap.get(key):
            raise ValueError(
                "value enqueued more than once; multiset histories ride "
                "the oracle"
            )
        valmap[key] = 1
        return F_ENQUEUE, vid, 0
    if op.f == "dequeue":
        return F_DEQUEUE, _uq_value_id(op.value, valmap), 0
    raise ValueError(f"unordered-queue cannot encode op f={op.f!r}")


def _uq_init(model, valmap) -> int:
    state = 0
    for v, count in dict(model.items).items():
        if count != 1:
            raise ValueError("initial multiplicities >1 ride the oracle")
        vid = _uq_value_id(v, valmap)
        valmap[("uq-enq", vid)] = 1  # counts against the once-only rule
        state |= 1 << (vid - 1)
    return state


SPECS: Dict[type, ModelSpec] = {
    m.Register: ModelSpec(
        name="register",
        encode_op=_encode_register_op,
        init_state=_register_init,
        pure_fs=("read",),
    ),
    m.CASRegister: ModelSpec(
        name="cas-register",
        encode_op=_encode_cas_op,
        init_state=_register_init,
        pure_fs=("read",),
    ),
    m.Mutex: ModelSpec(
        name="mutex",
        encode_op=_encode_mutex_op,
        init_state=lambda model, valmap: 1 if model.locked else 0,
        pure_fs=(),
    ),
    m.MultiRegister: ModelSpec(
        name="multi-register",
        encode_op=_encode_multi_register_op,
        init_state=_mr_init,
        pure_fs=(),
    ),
    m.UnorderedQueue: ModelSpec(
        name="unordered-queue",
        encode_op=_encode_unordered_queue_op,
        init_state=_uq_init,
        pure_fs=(),
    ),
    # the owner-aware mutex reduces to cas-register ops at encode time
    # and shares that step (its entry in STEPS) and the register-family
    # dense transitions
    m.OwnerMutex: ModelSpec(
        name="owner-mutex",
        encode_op=_encode_owner_mutex_op,
        init_state=_owner_mutex_init,
        pure_fs=(),
    ),
    # reentrant owner-aware mutex (hold bound 2): state ids {0, 2c-1,
    # 2c}, a domain of 2·N+1 for N clients (wgl.value_domain widens it)
    m.ReentrantMutex: ModelSpec(
        name="reentrant-mutex",
        encode_op=_encode_reentrant_mutex_op,
        init_state=_reentrant_mutex_init,
        pure_fs=(),
    ),
    # semaphore permits: multisets of ≤ n_permits client ids, enumerated
    # by host tables — only the dense automaton exists
    m.AcquiredPermits: ModelSpec(
        name="acquired-permits",
        encode_op=_encode_permits_op,
        init_state=_permits_init,
        pure_fs=(),
        dense_only=True,
    ),
}


def spec_for(model: m.Model) -> Optional[ModelSpec]:
    return SPECS.get(type(model))
