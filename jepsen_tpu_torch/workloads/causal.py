"""Causal-consistency register workload — the port's copy of
:mod:`jepsen_tpu.workloads.causal`, its model built on the port's
:class:`~jepsen_tpu_torch.models.Model`.

A causal order of five ops (read-init, write 1, read, write 2, read) is
issued per key; all must appear to execute in issue order, linked by
``position``/``link`` markers the client fills in.
(reference: jepsen/src/jepsen/tests/causal.clj)
"""

from __future__ import annotations

from typing import Optional

from .. import generator as gen
from .. import independent
from ..checker import Checker
from ..history import OK
from ..models import Model, inconsistent, Inconsistent


class CausalRegister(Model):
    """Register whose ops carry :position/:link causal markers.
    (reference: causal.clj:33-82)"""

    def __init__(self, value=0, counter=0, last_pos=None):
        self.value = value
        self.counter = counter
        self.last_pos = last_pos

    def step(self, op):
        c = self.counter + 1
        v = op.value
        pos = op.get("position")
        link = op.get("link")
        if link != "init" and link != self.last_pos:
            return inconsistent(
                f"Cannot link {link!r} to last-seen position {self.last_pos!r}"
            )
        if op.f == "write":
            if v == c:
                return CausalRegister(v, c, pos)
            return inconsistent(
                f"expected value {c} attempting to write {v} instead"
            )
        if op.f == "read-init":
            if self.counter == 0 and v not in (0, None):
                return inconsistent(f"expected init value 0, read {v}")
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return inconsistent(f"can't read {v} from register {self.value}")
        if op.f == "read":
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return inconsistent(f"can't read {v} from register {self.value}")
        return inconsistent(f"unknown f {op.f!r}")

    def __repr__(self):
        return repr(self.value)


def causal_register() -> CausalRegister:
    return CausalRegister(0, 0, None)


class _CausalChecker(Checker):
    def __init__(self, model: Model):
        self.model = model

    def check(self, test, history, opts=None):
        state = self.model
        for op in history:
            if op.type != OK:
                continue
            state = state.step(op)
            if isinstance(state, Inconsistent):
                return {"valid?": False, "error": state.msg}
        return {"valid?": True, "model": repr(state)}


def check(model: Model) -> Checker:
    """Fold the causal model over ok ops.  (reference: causal.clj:88-110)"""
    return _CausalChecker(model)


def r(test, ctx):
    return {"type": "invoke", "f": "read"}


def ri(test, ctx):
    return {"type": "invoke", "f": "read-init"}


def cw1(test, ctx):
    return {"type": "invoke", "f": "write", "value": 1}


def cw2(test, ctx):
    return {"type": "invoke", "f": "write", "value": 2}


def test(opts: Optional[dict] = None) -> dict:
    """(reference: causal.clj:113-126)"""
    opts = opts or {}
    return {
        "checker": independent.checker(check(causal_register())),
        "generator": gen.time_limit(
            opts.get("time-limit", 60),
            gen.nemesis(
                gen.cycle(
                    [
                        gen.sleep(10),
                        {"type": "info", "f": "start"},
                        gen.sleep(10),
                        {"type": "info", "f": "stop"},
                    ]
                ),
                gen.stagger(
                    1,
                    independent.concurrent_generator(
                        1,
                        _keys(),
                        lambda k: [ri, cw1, r, cw2, r],
                    ),
                ),
            ),
        ),
    }


def _keys():
    """An unbounded key sequence (materialized lazily by the generator)."""
    return list(range(10_000))
