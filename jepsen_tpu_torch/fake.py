"""In-process fake DB and client for integration tests without a cluster.

(reference: jepsen/src/jepsen/tests.clj:27-66 atom-db/atom-client, used by
core_test.clj's basic-cas-test to drive the *real* interpreter.)
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

from . import client as client_mod


class AtomState:
    """A compare-and-settable cell guarded by a lock."""

    def __init__(self, value: Any = None):
        self.lock = threading.Lock()
        self.value = value

    def reset(self, value: Any) -> Any:
        with self.lock:
            self.value = value
            return value

    def deref(self) -> Any:
        with self.lock:
            return self.value

    def cas(self, old: Any, new: Any) -> bool:
        with self.lock:
            if self.value == old:
                self.value = new
                return True
            return False


class AtomClient(client_mod.Client):
    """CAS-register client over an AtomState.
    (reference: tests.clj:34-66)"""

    def __init__(
        self,
        state: AtomState,
        meta_log: Optional[List[str]] = None,
        latency: float = 0.001,
    ):
        self.state = state
        self.meta_log = meta_log if meta_log is not None else []
        self.latency = latency

    def open(self, test, node):
        self.meta_log.append("open")
        return AtomClient(self.state, self.meta_log, self.latency)

    def setup(self, test):
        self.meta_log.append("setup")

    def invoke(self, test, op):
        # sleep to get actual concurrency (reference: tests.clj:50)
        if self.latency:
            time.sleep(self.latency)
        f = op["f"]
        if f == "write":
            self.state.reset(op["value"])
            return {**op, "type": "ok"}
        elif f == "cas":
            old, new = op["value"]
            ok = self.state.cas(old, new)
            return {**op, "type": "ok" if ok else "fail"}
        elif f == "read":
            return {**op, "type": "ok", "value": self.state.deref()}
        raise ValueError(f"unknown op f={f!r}")

    def teardown(self, test):
        self.meta_log.append("teardown")

    def close(self, test):
        self.meta_log.append("close")


class KeyedAtomClient(client_mod.Client):
    """A map of independent CAS registers: understands ops whose value
    is an independent ``[k, v]`` tuple, routing v to the register for k.
    Drives the keyed workloads (linearizable-register etc.) in-process."""

    def __init__(self, registers=None, latency: float = 0.0):
        self.registers = registers if registers is not None else {}
        self.lock = threading.Lock()
        self.latency = latency

    def open(self, test, node):
        # type(self): subclasses (CausalAtomClient) must survive open
        c = type(self)(registers=self.registers, latency=self.latency)
        c.lock = self.lock
        return c

    def _register(self, k) -> AtomState:
        with self.lock:
            if k not in self.registers:
                self.registers[k] = AtomState(None)
            return self.registers[k]

    def invoke(self, test, op):
        from . import independent as ind

        if self.latency:
            time.sleep(self.latency)
        v = op.get("value")
        if not isinstance(v, ind.KV):
            raise ValueError(f"expected [k, v] tuple value, got {v!r}")
        k, inner_v = v.key, v.value
        reg = self._register(k)
        f = op["f"]
        if f == "write":
            reg.reset(inner_v)
            return {**op, "type": "ok"}
        if f == "cas":
            old, new = inner_v
            ok = reg.cas(old, new)
            return {**op, "type": "ok" if ok else "fail"}
        if f == "read":
            return {**op, "type": "ok", "value": ind.kv(k, reg.deref())}
        raise ValueError(f"unknown op f={f!r}")


class CrashingClient(AtomClient):
    """Like AtomClient but raises on a fraction of ops — exercises the
    interpreter's crash→:info→process-retirement path."""

    def __init__(self, state, crash_every: int = 5, **kw):
        super().__init__(state, **kw)
        self.crash_every = crash_every
        self.counter = {"n": 0}

    def open(self, test, node):
        self.meta_log.append("open")
        c = CrashingClient(
            self.state,
            crash_every=self.crash_every,
            meta_log=self.meta_log,
            latency=self.latency,
        )
        c.counter = self.counter
        return c

    def invoke(self, test, op):
        self.counter["n"] += 1
        if self.counter["n"] % self.crash_every == 0:
            raise RuntimeError("client crashed!")
        return super().invoke(test, op)


class KeyedAtomSetClient(client_mod.Client):
    """A map of independent grow-only sets: writes add the value to key
    k's set, reads return the sorted contents — the read-your-writes
    shape the causal/sequential probes expect (their checkers consume
    the LIST of writes a read observed; a single register value would
    be meaningless there)."""

    def __init__(self, sets=None, latency: float = 0.0):
        self.sets = sets if sets is not None else {}
        self.lock = threading.Lock()
        self.latency = latency

    def open(self, test, node):
        c = type(self)(sets=self.sets, latency=self.latency)
        c.lock = self.lock
        return c

    def invoke(self, test, op):
        from . import independent as ind

        if self.latency:
            time.sleep(self.latency)
        v = op.get("value")
        if not isinstance(v, ind.KV):
            raise ValueError(f"expected [k, v] tuple value, got {v!r}")
        k, inner_v = v.key, v.value
        f = op["f"]
        with self.lock:
            s = self.sets.setdefault(k, set())
            if f == "write" or f == "add":
                s.add(inner_v)
                return {**op, "type": "ok"}
            if f == "read":
                return {
                    **op, "type": "ok",
                    "value": ind.kv(k, sorted(s)),
                }
        raise ValueError(f"unknown op f={f!r}")


class BankAtomClient(client_mod.Client):
    """In-process bank: transfers move balance atomically between
    accounts (overdrafts fail, like the SQL clients' aborting
    transactions), reads return the full balance map.  Accounts seed
    lazily from the test map (total-amount split across accounts)."""

    def __init__(self, balances=None, latency: float = 0.0):
        self.balances = balances if balances is not None else {}
        self.lock = threading.Lock()
        self.latency = latency

    def open(self, test, node):
        c = type(self)(balances=self.balances, latency=self.latency)
        c.lock = self.lock
        return c

    def _seed(self, test):
        if not self.balances:
            accounts = list(test.get("accounts", range(8)))
            total = int(test.get("total-amount", 100))
            share = total // len(accounts)
            for i, a in enumerate(accounts):
                # first account takes the remainder so totals add up
                self.balances[a] = share + (
                    total - share * len(accounts) if i == 0 else 0
                )

    def invoke(self, test, op):
        if self.latency:
            time.sleep(self.latency)
        f = op["f"]
        with self.lock:
            self._seed(test)
            if f == "read":
                return {**op, "type": "ok", "value": dict(self.balances)}
            if f == "transfer":
                v = op["value"]
                frm, to, amount = v["from"], v["to"], v["amount"]
                if self.balances.get(frm, 0) < amount and not test.get(
                    "negative-balances?"
                ):
                    return {**op, "type": "fail", "error": "insufficient"}
                self.balances[frm] = self.balances.get(frm, 0) - amount
                self.balances[to] = self.balances.get(to, 0) + amount
                return {**op, "type": "ok"}
        raise ValueError(f"unknown op f={f!r}")


class TxnAtomClient(client_mod.Client):
    """Atomic micro-op transactions over a shared register map: ops
    carry mop lists ``[["w", k, v], ["r", k, None], ["append", k, v],
    ...]``; the whole list applies under one lock (a serializable
    in-memory store; appended keys hold lists).  Serves the long-fork
    and elle list-append/rw-register probes in-process."""

    def __init__(self, kv=None, latency: float = 0.0):
        self.kv = kv if kv is not None else {}
        self.lock = threading.Lock()
        self.latency = latency

    def open(self, test, node):
        c = type(self)(kv=self.kv, latency=self.latency)
        c.lock = self.lock
        return c

    def invoke(self, test, op):
        if self.latency:
            time.sleep(self.latency)
        mops = op.get("value") or []
        out = []
        with self.lock:
            for mf, k, v in mops:
                if mf in ("w", "write"):
                    self.kv[k] = v
                    out.append([mf, k, v])
                elif mf in ("r", "read"):
                    cur = self.kv.get(k)
                    out.append(
                        [mf, k, list(cur) if isinstance(cur, list) else cur]
                    )
                elif mf == "append":
                    self.kv.setdefault(k, []).append(v)
                    out.append([mf, k, v])
                else:
                    raise ValueError(f"unknown mop {mf!r}")
        return {**op, "type": "ok", "value": out}


class CausalAtomClient(KeyedAtomClient):
    """Keyed registers starting at 0 with the causal probe's
    ``read-init`` treated as a read — the CausalRegister model expects
    the initial value 0, not None."""

    def _register(self, k) -> AtomState:
        with self.lock:
            if k not in self.registers:
                self.registers[k] = AtomState(0)
            return self.registers[k]

    def invoke(self, test, op):
        from . import independent as ind

        if op["f"] == "read-init":
            v = op.get("value")
            k = v.key if isinstance(v, ind.KV) else 0
            reg = self._register(k)
            return {**op, "type": "ok", "value": ind.kv(k, reg.deref())}
        return super().invoke(test, op)


class InsertOnceAtomClient(client_mod.Client):
    """Keyed put-if-absent: the FIRST insert per key wins, later ones
    fail — the at-most-one-row guarantee the adya G2 probe checks."""

    def __init__(self, rows=None, latency: float = 0.0):
        self.rows = rows if rows is not None else {}
        self.lock = threading.Lock()
        self.latency = latency

    def open(self, test, node):
        c = type(self)(rows=self.rows, latency=self.latency)
        c.lock = self.lock
        return c

    def invoke(self, test, op):
        from . import independent as ind

        if self.latency:
            time.sleep(self.latency)
        v = op.get("value")
        if op["f"] != "insert" or not isinstance(v, ind.KV):
            raise ValueError(f"unknown op {op!r}")
        k = v.key
        with self.lock:
            if k in self.rows:
                return {**op, "type": "fail", "error": "exists"}
            self.rows[k] = v.value
        return {**op, "type": "ok"}
