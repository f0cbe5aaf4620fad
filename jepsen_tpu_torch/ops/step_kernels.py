"""Op codes and model specs: how a model maps onto the device encoding.

A copy of the host half of :mod:`jepsen_tpu.ops.step_kernels` for the
register, cas-register and mutex models: the ``F_*`` op codes (shared by
every kernel, so all twelve stay), the per-model op encoders and initial
states, and the ``SPECS`` table.  The reference's branchless step
functions feed its generic frontier search, which this slice does not
port yet (ROADMAP.md, kernels K3/K4), so :attr:`ModelSpec.step` is
``None`` here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

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
    #: frontier search; None until that kernel is ported
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
}


def spec_for(model: m.Model) -> Optional[ModelSpec]:
    return SPECS.get(type(model))
