"""Synthetic history generation — for differential tests and benchmarks.

A copy of :mod:`jepsen_tpu.synth`'s CAS-register, multi-register, lock
and permit generators, and of the reference tests' unique-element queue
generator (:func:`generate_queue_history`): for the same seed they
produce the same histories as the reference (``tests/test_torch_encode.py``
and ``tests/test_torch_queue.py`` pin it), so the port and the JAX
package can be fed identical corpora.

Simulates honest linearizable executions of a CAS register with real
concurrency (ops linearize at completion; crashes secretly apply or not),
plus an optional corruption pass that produces likely-invalid histories.
This is the batch feeder for BASELINE config 3 (batched 1000-op
CAS-register suites).

:func:`generate_txn_history` is the port's own transaction generator for
the Elle screens (it does not reproduce the reference's random stream):
the reference's ``TxnGenerator`` rules run against a serializable
in-memory store, with an optional committed G1c pair injected.
"""

from __future__ import annotations

import random

from .history import History, Op, invoke_op, ok_op, fail_op, info_op


def generate_history(
    rng: random.Random,
    n_procs: int = 4,
    n_ops: int = 30,
    crash_p: float = 0.1,
    corrupt: bool = False,
    n_values: int = 5,
    replace_crashed: bool = False,
    op_weights=None,
) -> History:
    """One simulated concurrent CAS-register execution.

    Valid by construction when corrupt=False (every completed op
    linearizes at its completion point; crashed ops apply secretly with
    probability 1/2).  corrupt=True flips one completion value, usually
    (not always) making the history non-linearizable.

    replace_crashed=True mirrors the interpreter's process retirement
    (interpreter.clj:233-236): a crash frees the logical worker under a
    fresh process id, so open (crashed) ops accumulate beyond n_procs.
    op_weights biases the (read, write, cas) mix.
    """
    state = 0
    hist = []
    pending = {}
    idle = list(range(n_procs))
    next_pid = n_procs
    values = list(range(1, n_values + 1))
    ops_done = 0
    while ops_done < n_ops or pending:
        do_invoke = idle and (ops_done < n_ops) and (not pending or rng.random() < 0.6)
        if do_invoke:
            p = rng.choice(idle)
            idle.remove(p)
            # plain choice when unweighted: rng.choices consumes a
            # different PRNG stream, which would silently regenerate
            # every fixed-seed corpus
            if op_weights is None:
                f = rng.choice(["read", "write", "cas"])
            else:
                f = rng.choices(["read", "write", "cas"], weights=op_weights)[0]
            if f == "read":
                hist.append(invoke_op(p, "read"))
                pending[p] = ("read", None)
            elif f == "write":
                v = rng.choice(values)
                hist.append(invoke_op(p, "write", v))
                pending[p] = ("write", v)
            else:
                old = rng.choice(values + [state])
                new = rng.choice(values)
                hist.append(invoke_op(p, "cas", (old, new)))
                pending[p] = ("cas", (old, new))
            ops_done += 1
        else:
            p = rng.choice(list(pending.keys()))
            f, v = pending.pop(p)
            if rng.random() < crash_p:
                # crashed: decide secretly whether it took effect; the
                # crashed process id is never reused
                if f == "write" and rng.random() < 0.5:
                    state = v
                elif f == "cas" and rng.random() < 0.5 and state == v[0]:
                    state = v[1]
                hist.append(info_op(p, f, v))
                if replace_crashed:
                    idle.append(next_pid)
                    next_pid += 1
            else:
                if f == "read":
                    v = state
                elif f == "write":
                    state = v
                elif f == "cas":
                    if state == v[0]:
                        state = v[1]
                    else:
                        hist.append(fail_op(p, f, v))
                        idle.append(p)
                        continue
                hist.append(ok_op(p, f, v))
                idle.append(p)
        if not idle and not pending:
            break
    out = History(hist)
    if corrupt and len(out) > 2:
        oks = [i for i, op in enumerate(out) if op.type == "ok"]
        if oks:
            i = rng.choice(oks)
            op = out[i]
            if op.f in ("read", "write"):
                out[i] = op.copy(value=rng.choice([7, 8, 9]))
    for i, op in enumerate(out):
        op.index = i
        op.time = i
    return out


def generate_batch(
    seed: int,
    n_histories: int,
    n_procs: int = 4,
    n_ops: int = 30,
    crash_p: float = 0.05,
    corrupt_fraction: float = 0.0,
):
    """A list of histories, a deterministic function of seed."""
    rng = random.Random(seed)
    out = []
    for i in range(n_histories):
        corrupt = rng.random() < corrupt_fraction
        out.append(
            generate_history(
                rng, n_procs=n_procs, n_ops=n_ops, crash_p=crash_p, corrupt=corrupt
            )
        )
    return out


def generate_lock_history(
    rng,
    n_procs: int = 4,
    n_ops: int = 40,
    reentrant: bool = False,
    corrupt: bool = False,
):
    """Simulated owner-aware (optionally reentrant, hold bound 2)
    distributed lock with real contention: waiters stay pending until
    the lock frees (like the hazelcast suite's try_lock clients), so
    histories are dense with successful acquire/release cycles rather
    than failed probes.  A release's linearization point sits anywhere
    in its invoke window, so a grant may interleave there — real
    concurrency, still linearizable.  Completions carry {"client":
    name} the way suites/hazelcast.py stamps identity.  corrupt=True
    fabricates one definite violation: a grant while held with no open
    release that could linearize first."""
    cap = 2 if reentrant else 1
    hist = []
    idle = list(range(n_procs))
    waiting: list = []      # acquire invoked, not granted
    holds = {p: 0 for p in range(n_procs)}
    releasing: list = []    # release invoked, not ok'd
    eff = 0                 # holds outstanding after in-flight releases
    corrupted = False
    done = 0
    while done < n_ops or waiting or releasing:
        can_acq = [p for p in idle if holds[p] == 0]
        can_reacq = [p for p in idle if 0 < holds[p] < cap]
        can_rel = [p for p in idle if holds[p] > 0]
        legit_grant = [
            p for p in waiting
            if eff == 0 or (0 < holds[p] < cap)
        ]
        moves = []
        if done < n_ops and (can_acq or (reentrant and can_reacq)):
            moves.append("inv_acq")
        # releases stay available past the op budget so waiters drain
        # (holders must free the lock for pending grants to complete)
        if can_rel and (done < n_ops or waiting):
            moves.append("inv_rel")
        if legit_grant:
            moves.append("grant")
        elif waiting and corrupt and not corrupted and not releasing:
            # no legitimate grant exists and no release is open: a
            # grant here is a definite violation in every ordering
            moves.append("bad_grant")
        if releasing:
            moves.append("ok_rel")
        if not moves:
            break  # defensive: the current move set always drains
        mv = rng.choice(moves)
        if mv == "inv_acq":
            pool = can_acq + (can_reacq if reentrant else [])
            p = pool[rng.randrange(len(pool))]
            idle.remove(p)
            hist.append(invoke_op(p, "acquire", None))
            waiting.append(p)
            done += 1
        elif mv == "inv_rel":
            p = can_rel[rng.randrange(len(can_rel))]
            idle.remove(p)
            hist.append(invoke_op(p, "release", None))
            releasing.append(p)
            eff -= 1  # the release may linearize from here on
            done += 1
        elif mv in ("grant", "bad_grant"):
            pool = legit_grant if mv == "grant" else waiting
            p = pool[rng.randrange(len(pool))]
            waiting.remove(p)
            holds[p] += 1
            eff += 1
            hist.append(ok_op(p, "acquire", {"client": f"c{p}"}))
            idle.append(p)
            if mv == "bad_grant":
                corrupted = True
        else:  # ok_rel
            p = releasing.pop(rng.randrange(len(releasing)))
            holds[p] -= 1
            hist.append(ok_op(p, "release", {"client": f"c{p}"}))
            idle.append(p)
    # Defensive tail (currently unreachable: a move always exists while
    # waiters remain, so the loop drains them): if a future move-set
    # change ever strands a waiter, it must leave as an IDENTITY-BEARING
    # info op — an identity-less open invoke would push the whole
    # history onto the oracle, which is exponential at contended shapes.
    for p in waiting:
        hist.append(info_op(p, "acquire", {"client": f"c{p}"}))
    h = History(hist)
    for i, op in enumerate(h):
        op.index = i
        op.time = i
    return h.index_ops()


def generate_mr_history(
    rng: random.Random,
    n_procs: int = 4,
    n_ops: int = 40,
    n_keys: int = 3,
    n_values: int = 4,
    crash_p: float = 0.1,
    corrupt: bool = False,
) -> History:
    """One simulated concurrent execution over a multi-register: ops are
    single-mop transactions ``[("r"|"w", key, value)]`` against keys
    0..n_keys-1, each initially 0 (pair with models.multi_register({k: 0
    for k in range(n_keys)})).  Valid by construction unless corrupt."""
    state = {k: 0 for k in range(n_keys)}
    hist = []
    pending = {}
    idle = list(range(n_procs))
    values = list(range(1, n_values + 1))
    ops_done = 0
    while ops_done < n_ops or pending:
        do_invoke = idle and (ops_done < n_ops) and (not pending or rng.random() < 0.6)
        if do_invoke:
            p = rng.choice(idle)
            idle.remove(p)
            k = rng.randrange(n_keys)
            if rng.random() < 0.5:
                hist.append(invoke_op(p, "txn", [("r", k, None)]))
                pending[p] = ("r", k, None)
            else:
                v = rng.choice(values)
                hist.append(invoke_op(p, "txn", [("w", k, v)]))
                pending[p] = ("w", k, v)
            ops_done += 1
        else:
            p = rng.choice(list(pending.keys()))
            mf, k, v = pending.pop(p)
            if rng.random() < crash_p:
                if mf == "w" and rng.random() < 0.5:
                    state[k] = v
                hist.append(info_op(p, "txn", [(mf, k, v)]))
            else:
                if mf == "r":
                    v = state[k]
                else:
                    state[k] = v
                hist.append(ok_op(p, "txn", [(mf, k, v)]))
                idle.append(p)
        if not idle and not pending:
            break  # every process crashed
    out = History(hist)
    if corrupt and len(out) > 2:
        reads = [
            i
            for i, op in enumerate(out)
            if op.type == "ok" and op.value and op.value[0][0] == "r"
        ]
        if reads:
            i = rng.choice(reads)
            op = out[i]
            _mf, k, _v = op.value[0]
            out[i] = op.copy(value=[("r", k, rng.choice([7, 8, 9]))])
    for i, op in enumerate(out):
        op.index = i
        op.time = i
    return out


def generate_permits_history(
    rng,
    n_procs: int = 5,
    n_ops: int = 40,
    n_permits: int = 2,
    corrupt: bool = False,
):
    """Simulated semaphore: each process is one client holding at most
    one permit at a time; waiters block until a permit frees (a
    release's linearization point sits anywhere in its invoke window).
    Completions carry {"client": name}.  corrupt=True fabricates one
    definite over-issue: a grant past n_permits with no open release
    that could linearize first."""
    hist = []
    idle = list(range(n_procs))
    waiting: list = []
    holds = {p: 0 for p in range(n_procs)}
    releasing: list = []
    eff = 0  # permits outstanding after in-flight releases linearize
    corrupted = False
    done = 0
    while done < n_ops or waiting or releasing:
        can_acq = [p for p in idle if holds[p] == 0]
        can_rel = [p for p in idle if holds[p] > 0]
        grantable = eff < n_permits
        moves = []
        if done < n_ops and can_acq:
            moves.append("inv_acq")
        if can_rel and (done < n_ops or waiting):
            moves.append("inv_rel")
        if waiting and grantable:
            moves.append("grant")
        elif waiting and corrupt and not corrupted and not releasing:
            moves.append("bad_grant")
        if releasing:
            moves.append("ok_rel")
        if not moves:
            break  # stranded waiters become open info ops below
        mv = rng.choice(moves)
        if mv == "inv_acq":
            p = can_acq[rng.randrange(len(can_acq))]
            idle.remove(p)
            hist.append(invoke_op(p, "acquire", None))
            waiting.append(p)
            done += 1
        elif mv == "inv_rel":
            p = can_rel[rng.randrange(len(can_rel))]
            idle.remove(p)
            hist.append(invoke_op(p, "release", None))
            releasing.append(p)
            eff -= 1
            done += 1
        elif mv in ("grant", "bad_grant"):
            p = waiting.pop(rng.randrange(len(waiting)))
            holds[p] += 1
            eff += 1
            hist.append(ok_op(p, "acquire", {"client": f"c{p}"}))
            idle.append(p)
            if mv == "bad_grant":
                corrupted = True
        else:  # ok_rel
            p = releasing.pop(rng.randrange(len(releasing)))
            holds[p] -= 1
            hist.append(ok_op(p, "release", {"client": f"c{p}"}))
            idle.append(p)
    for p in waiting:
        hist.append(info_op(p, "acquire", {"client": f"c{p}"}))
    h = History(hist)
    for i, op in enumerate(h):
        op.index = i
        op.time = i
    return h.index_ops()


def generate_queue_history(
    rng,
    n_procs: int = 4,
    n_ops: int = 24,
    corrupt: bool = False,
    initial=(),
):
    """Simulated unique-element unordered queue (the reference's
    ``tests/test_models.py:_gen_queue_history``, same draws for the same
    seed): enqueues of fresh values, dequeues returning any present
    element, ops linearizing at completion; a dequeue of an empty queue
    fails.  corrupt=True makes one ok dequeue claim a value that was
    never enqueued.  ``initial``: distinct integer values already in the
    queue (the model's initial contents, ``UnorderedQueue(initial)``);
    fresh values start past them.  With none, the histories are the
    reference's."""
    present = set(initial)
    next_v = max(present, default=0) + 1
    pending = {}
    idle = list(range(n_procs))
    hist = []
    done = 0
    while done < n_ops or pending:
        if idle and done < n_ops and (not pending or rng.random() < 0.6):
            p = idle.pop(rng.randrange(len(idle)))
            if present and rng.random() < 0.45:
                hist.append(invoke_op(p, "dequeue", None))
                pending[p] = ("dequeue", None)
            else:
                v = next_v
                next_v += 1
                hist.append(invoke_op(p, "enqueue", v))
                pending[p] = ("enqueue", v)
            done += 1
        else:
            p = rng.choice(list(pending))
            f, v = pending.pop(p)
            idle.append(p)
            if f == "enqueue":
                present.add(v)
                hist.append(ok_op(p, "enqueue", v))
            elif present:
                got = rng.choice(sorted(present))
                present.discard(got)
                hist.append(ok_op(p, "dequeue", got))
            else:
                hist.append(fail_op(p, "dequeue", None, error="empty"))
    h = History(hist)
    if corrupt and len(h) > 4:
        deqs = [i for i, op in enumerate(h)
                if op.type == "ok" and op.f == "dequeue"]
        if deqs:
            i = rng.choice(deqs)
            h[i] = h[i].copy(value=next_v + 7)  # never enqueued
    for i, op in enumerate(h):
        op.index = i
        op.time = i
    return h.index_ops()


def generate_txn_history(
    rng: random.Random,
    mode: str = "append",
    n_txns: int = 400,
    key_count: int = 32,
    max_writes_per_key: int = 8,
    min_len: int = 1,
    max_len: int = 4,
    n_procs: int = 3,
    latency=(5, 15),
    g1c: bool = False,
) -> History:
    """One transactional history, ``mode`` "append" (list-append) or "wr"
    (rw-register).  Transactions follow the reference's ``TxnGenerator``
    rules (``workloads/cycle/__init__.py:198-253``): ``key_count`` keys
    active at once, each retired for a fresh key after
    ``max_writes_per_key`` writes, ``min_len..max_len`` micro-ops, each a
    read with probability 0.5, else a write/append of a globally unique
    value.  ``n_procs`` processes run them back to back, each taking a
    latency drawn from ``latency``; a transaction applies atomically at
    its invocation (the reference's ``TxnAtomClient``: a serializable
    store whose order also respects real time), so the history is valid
    unless ``g1c`` appends the reference's injected committed
    wr-dependency cycle on two fresh keys (``bench.py:1221-1237``)."""
    if mode not in ("append", "wr"):
        raise ValueError(f"unknown txn mode {mode!r}")
    active = list(range(key_count))
    writes = {k: 0 for k in active}
    next_key, counter = key_count, 0
    store: dict = {}
    free_at = [0] * n_procs
    events = []
    for _ in range(n_txns):
        p = min(range(n_procs), key=lambda q: (free_at[q], q))
        t = free_at[p]
        txn, done = [], []
        for _m in range(min_len + rng.randrange(max_len - min_len + 1)):
            k = active[rng.randrange(len(active))]
            if rng.random() < 0.5:
                txn.append(["r", k, None])
                cur = store.get(k)
                done.append(["r", k, list(cur) if isinstance(cur, list)
                             else cur])
                continue
            counter += 1
            if mode == "append":
                txn.append(["append", k, counter])
                store.setdefault(k, []).append(counter)
            else:
                txn.append(["w", k, counter])
                store[k] = counter
            done.append(list(txn[-1]))
            writes[k] += 1
            if writes[k] >= max_writes_per_key:
                active[active.index(k)] = next_key
                writes[next_key] = 0
                next_key += 1
        end = t + rng.randint(*latency)
        free_at[p] = end
        events.append((t, 1, p, {"process": p, "type": "invoke", "f": "txn",
                                 "value": txn, "time": t}))
        events.append((end, 0, p, {"process": p, "type": "ok", "f": "txn",
                                   "value": done, "time": end}))
    events.sort(key=lambda e: e[:3])
    dicts = [e[3] for e in events]
    if g1c:
        t0 = max(d["time"] for d in dicts) + 100 if dicts else 0
        kx, ky = "__bx", "__by"
        if mode == "append":
            t1 = [["append", kx, 1], ["r", ky, [2]]]
            t2 = [["append", ky, 2], ["r", kx, [1]]]
        else:
            t1 = [["w", kx, 1], ["r", ky, 2]]
            t2 = [["w", ky, 2], ["r", kx, 1]]
        for p, txn, dt in ((91, t1, 0), (92, t2, 1)):
            dicts.append({"process": p, "type": "invoke", "f": "txn",
                          "value": txn, "time": t0 + dt})
            dicts.append({"process": p, "type": "ok", "f": "txn",
                          "value": txn, "time": t0 + 10 + dt})
    return History([Op.from_dict(d) for d in dicts]).index_ops()


def generate_txn_batch(seed: int, n_histories: int, mode: str = "append",
                       n_txns: int = 400, key_count: int = 32,
                       anomaly_every: int = 4, **kw):
    """``n_histories`` transactional histories from one seed, the injected
    G1c in every ``anomaly_every``-th (the first included), as the
    reference's ``bench.py:_elle_corpus`` shapes its corpus."""
    rng = random.Random(seed)
    return [generate_txn_history(rng, mode, n_txns, key_count,
                                 g1c=i % anomaly_every == 0, **kw)
            for i in range(n_histories)]
