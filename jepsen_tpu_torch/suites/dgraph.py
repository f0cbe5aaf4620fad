"""Dgraph suite — the port's copy of :mod:`jepsen_tpu.suites.dgraph`.

Reference: dgraph/src/jepsen/dgraph/support.clj — one ``dgraph zero`` on
the first node plus a ``dgraph alpha`` on every node (ports 5080/6080
zero, 7080/8080/9080 alpha; support.clj:24-60), installed from the
release tarball; clients (dgraph/client.clj) run upsert-style
transactions.  Workloads mirror dgraph/{set,bank,delete,upsert,
linearizable_register,long_fork,sequential,wr}.clj.

The reference speaks gRPC; this client uses Dgraph's equivalent HTTP
API: ``/alter`` for schema, ``/mutate?commitNow=true`` with RDF/JSON,
``/query`` with GraphQL+- — register CAS runs as a single upsert block
(query + conditional mutation), which Dgraph executes transactionally.
"""

from __future__ import annotations

import json
from typing import Optional

from .. import checker as checker_mod
from .. import client as client_mod
from .. import independent
from ..control import util as cu
from ..control import execute, sudo
from . import common
from .proto import IndeterminateError
from .proto.http import HttpError, JsonHttpClient

VERSION = "v1.1.0"
DIR = "/opt/dgraph"  # (reference: support.clj:22 dir)
ALPHA_PORT = 8080
ZERO_PORT = 5080
ZERO_PUBLIC_PORT = 6080


class DgraphDB(common.DaemonDB):
    """zero on nodes[0], alpha everywhere (reference: support.clj)."""

    dir = DIR
    binary = "dgraph"
    logfile = f"{DIR}/alpha.log"   # (reference: support.clj:27)
    pidfile = f"{DIR}/alpha.pid"
    zero_logfile = f"{DIR}/zero.log"
    zero_pidfile = f"{DIR}/zero.pid"

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.version = (opts or {}).get("version", VERSION)

    def install(self, test, node):
        url = (
            "https://github.com/dgraph-io/dgraph/releases/download/"
            f"{self.version}/dgraph-linux-amd64.tar.gz"
        )
        with sudo():
            cu.install_archive(url, DIR)

    def zero_nodes(self, test) -> list:
        """Zero runs on the first node (reference: support.clj)."""
        return [test["nodes"][0]]

    def start_zero(self, test, node):
        cu.start_daemon(
            {"logfile": self.zero_logfile, "pidfile": self.zero_pidfile,
             "chdir": DIR},
            f"{DIR}/dgraph", "zero",
            "--my", f"{node}:{ZERO_PORT}",
            "--replicas", str(len(test["nodes"])),
        )
        cu.await_tcp_port(ZERO_PUBLIC_PORT, timeout_s=60)

    def start_alpha(self, test, node):
        zero_node = test["nodes"][0]
        cu.start_daemon(
            {"logfile": self.logfile, "pidfile": self.pidfile, "chdir": DIR},
            f"{DIR}/dgraph", "alpha",
            "--my", f"{node}:7080",
            "--zero", f"{zero_node}:{ZERO_PORT}",
        )

    def stop_alpha(self, test, node):
        # pidfile-only: a killall would take the co-located zero down
        # as collateral, breaking the fault isolation the targeted
        # alpha/zero nemeses promise
        cu.stop_daemon(pidfile=self.pidfile)

    def stop_zero(self, test, node):
        cu.stop_daemon(pidfile=self.zero_pidfile)

    def alpha_running(self, test, node):
        return cu.daemon_running(self.pidfile)

    def start(self, test, node):
        if node in self.zero_nodes(test):
            self.start_zero(test, node)
        self.start_alpha(test, node)

    def kill(self, test, node):
        self.stop_alpha(test, node)
        self.stop_zero(test, node)
        # teardown-grade sweep: catch strays the pidfiles don't track
        cu.stop_daemon(cmd="dgraph")

    # -- zero cluster-management API (reference: support.clj
    # zero-state / move-tablet! via zero's HTTP port 6080) -------------

    def _zero_http(self, node) -> JsonHttpClient:
        return JsonHttpClient(
            self.opts.get("host", str(node)),
            self.opts.get("zero-public-port", ZERO_PUBLIC_PORT),
            timeout=5.0,
        )

    def zero_state(self, test, node):
        """The zero /state map (groups → tablets, zero leader), or
        "timeout" when zero is unreachable."""
        c = self._zero_http(node)
        try:
            status, body = c.get("/state", ok=(200,),
                                 raise_on_error=False)
            return body if status == 200 else "timeout"
        except Exception:  # noqa: BLE001 - nemesis probes must not throw
            return "timeout"
        finally:
            c.close()

    def move_tablet(self, test, node, predicate, group):
        """Ask the zero leader to rebalance one predicate onto a
        group.  Returns (status, body); (None, error) when zero is
        unreachable — like zero_state, nemesis probes must not throw."""
        c = self._zero_http(node)
        try:
            return c.get(
                "/moveTablet",
                params={"tablet": str(predicate), "group": str(group)},
                ok=(200,), raise_on_error=False,
            )
        except Exception as e:  # noqa: BLE001
            return None, repr(e)
        finally:
            c.close()

    def await_ready(self, test, node):
        cu.await_tcp_port(ALPHA_PORT, timeout_s=120)

    def wipe(self, test, node):
        with sudo():
            execute("rm", "-rf", f"{DIR}/p", f"{DIR}/w", f"{DIR}/zw")

    def log_files(self, test, node):
        return [self.logfile, self.zero_logfile]


SCHEMA = "key: int @index(int) @upsert .\nvalue: int .\n"


class DgraphClient(client_mod.Client):
    """Register ops as upsert blocks over the HTTP API
    (reference: dgraph/client.clj + linearizable_register.clj)."""

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}
        self.conn: Optional[JsonHttpClient] = None

    def open(self, test, node):
        c = type(self)(self.opts)
        c.conn = JsonHttpClient(
            self.opts.get("host", str(node)),
            self.opts.get("port", ALPHA_PORT),
            timeout=10.0,
        )
        return c

    def setup(self, test):
        try:
            self.conn.post("/alter", SCHEMA, ok=(200,))
        except (HttpError, IndeterminateError):
            pass

    def _query(self, q: str):
        _, body = self.conn.post(
            "/query", q, headers={"Content-Type": "application/graphql+-"},
            ok=(200,),
        )
        if "errors" in (body or {}):
            raise HttpError(200, body["errors"])
        return body.get("data", {})

    def _upsert(self, query: str, mutations: list):
        payload = json.dumps({"query": query, "mutations": mutations})
        _, out = self.conn.post(
            "/mutate?commitNow=true", payload,
            headers={"Content-Type": "application/json"}, ok=(200,),
        )
        if "errors" in (out or {}):
            raise HttpError(200, out["errors"])
        return out

    def invoke(self, test, op):
        k, v = op["value"] if isinstance(op["value"], (list, tuple)) else (
            0, op["value"])
        q = (
            f'{{ q(func: eq(key, {k})) {{ u as uid, value }} }}'
        )
        try:
            if op["f"] == "read":
                data = self._query(
                    f'{{ q(func: eq(key, {k})) {{ value }} }}'
                )
                rows = data.get("q", [])
                val = rows[0]["value"] if rows else None
                return {**op, "type": "ok", "value": independent.kv(k, val)}
            if op["f"] == "write":
                # update when the key exists, else create a fresh node —
                # both branches in one transactional upsert
                self._upsert(q, [
                    {"cond": "@if(gt(len(u), 0))",
                     "set_nquads": f'uid(u) <value> "{v}" .'},
                    {"cond": "@if(eq(len(u), 0))",
                     "set_nquads": f'_:n <key> "{k}" .\n_:n <value> "{v}" .'},
                ])
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = v
                qc = (
                    f'{{ q(func: eq(key, {k})) @filter(eq(value, {old})) '
                    f'{{ u as uid }} }}'
                )
                out = self._upsert(qc, [
                    {"cond": "@if(gt(len(u), 0))",
                     "set_nquads": f'uid(u) <value> "{new}" .'},
                ])
                # the mutate response echoes the upsert query's matches;
                # the conditional mutation applied iff q was non-empty
                matched = (out.get("data") or {}).get("queries", {}).get("q")
                if matched:
                    return {**op, "type": "ok"}
                return {**op, "type": "fail", "error": "cas-miss"}
            if op["f"] == "add":
                self._upsert(
                    f'{{ q(func: eq(key, {op["value"]})) {{ u as uid }} }}',
                    [{"cond": "@if(eq(len(u), 0))",
                      "set_nquads": f'_:n <key> "{op["value"]}" .'}],
                )
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except HttpError as e:
            return {**op, "type": "fail", "error": f"{e.status}: {e.body}"}

    def close(self, test):
        if self.conn:
            self.conn.close()


def db(opts: Optional[dict] = None):
    return DgraphDB(opts)


def client(opts: Optional[dict] = None):
    return DgraphClient(opts)


class DgraphSetClient(DgraphClient):
    """Set workload: add via key-only upsert, read via a full key scan.
    (reference: dgraph/set.clj)"""

    def invoke(self, test, op):
        if op["f"] == "read":
            try:
                data = self._query(
                    '{ q(func: has(key)) { key } }'
                )
                rows = data.get("q", [])
                return {**op, "type": "ok",
                        "value": sorted(r["key"] for r in rows)}
            except IndeterminateError as e:
                return {**op, "type": "info", "error": str(e)}
            except HttpError as e:
                return {**op, "type": "fail", "error": f"{e.status}: {e.body}"}
        return super().invoke(test, op)


def workloads(opts: Optional[dict] = None) -> dict:
    opts = dict(opts or {})
    from ..workloads import bank as bank_wl

    return {
        "register": common.register_workload(opts),
        "set": common.set_workload(opts),
        "upsert": upsert_workload(opts),
        "delete": delete_workload(opts),
        # flagship probes (reference: dgraph/bank.clj, wr.clj,
        # long_fork.clj, sequential.clj)
        "bank": bank_wl.test(opts),
        "wr": common.generic_workload("rw-register", opts),
        "long-fork": common.generic_workload("long-fork", opts),
        "sequential": sequential_workload(opts),
    }


def test(opts: Optional[dict] = None) -> dict:
    opts = dict(opts or {})
    wname = opts.get("workload", "register")
    w = workloads(opts)[wname]
    c = {
        "set": DgraphSetClient,
        "upsert": DgraphUpsertClient,
        "delete": DgraphDeleteClient,
        "bank": DgraphBankClient,
        "wr": DgraphTxnClient,
        "long-fork": DgraphTxnClient,
        "sequential": DgraphSequentialClient,
    }.get(wname, DgraphClient)(opts)
    db_obj = DgraphDB(opts)
    # per-suite fault menu: alpha/zero targeting, tablet moves, skew
    # (reference: dgraph/nemesis.clj via runner's nemesis wiring)
    pkg = None
    from . import dgraph_nemesis

    if set(opts.get("faults", ())) & dgraph_nemesis.KNOWN_FAULTS:
        pkg = common.suite_nemesis_package(
            opts, db_obj, dgraph_nemesis.package(opts, db_obj),
            dgraph_nemesis.KNOWN_FAULTS,
        )
    return common.build_test(
        f"dgraph-{wname}", opts, db=db_obj, client=c, workload=w,
        nemesis_package=pkg,
    )


# ---------------------------------------------------------------------
# upsert workload
# ---------------------------------------------------------------------

UPSERT_SCHEMA = "email: string @index(exact) @upsert .\n"


class DgraphUpsertClient(DgraphClient):
    """Concurrent insert-if-absent on an indexed predicate; at most one
    node per key may ever be created.

    Reference: dgraph/src/jepsen/dgraph/upsert.clj:13-55 — :upsert
    creates an email node unless an index read finds one (ok iff it
    inserted); :read returns the sorted uids matching the key.
    """

    def setup(self, test):
        try:
            self.conn.post("/alter", UPSERT_SCHEMA, ok=(200,))
        except (HttpError, IndeterminateError):
            pass

    def invoke(self, test, op):
        k, _v = op["value"]
        try:
            if op["f"] == "upsert":
                out = self._upsert(
                    f'{{ q(func: eq(email, "{k}")) {{ u as uid }} }}',
                    [{"cond": "@if(eq(len(u), 0))",
                      "set_nquads": f'_:n <email> "{k}" .'}],
                )
                uids = (out.get("data") or {}).get("uids") or {}
                if uids:
                    return {**op, "type": "ok",
                            "value": independent.kv(k, sorted(uids.values()))}
                return {**op, "type": "fail", "error": "exists"}
            if op["f"] == "read":
                data = self._query(
                    f'{{ q(func: eq(email, "{k}")) {{ uid }} }}'
                )
                uids = sorted(r["uid"] for r in data.get("q", []))
                return {**op, "type": "ok", "value": independent.kv(k, uids)}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except HttpError as e:
            return {**op, "type": "fail", "error": f"{e.status}: {e.body}"}


class UpsertChecker(checker_mod.Checker):
    """At most one uid may ever be read, and at most one upsert may
    succeed, per key.  (reference: upsert.clj:57-71)"""

    def check(self, test, history, opts=None):
        from ..history import OK as _OK

        reads = [op for op in history if op.type == _OK and op.f == "read"]
        upserts = [op for op in history if op.type == _OK and op.f == "upsert"]
        bad_reads = [
            {"index": op.index, "value": list(op.value)}
            for op in reads
            if op.value is not None and len(op.value) > 1
        ]
        return {
            "valid?": not bad_reads and len(upserts) <= 1,
            "bad-reads": bad_reads,
            "ok-upsert-count": len(upserts),
        }


def upsert_workload(opts: Optional[dict] = None) -> dict:
    """Per key: every thread races one upsert, then every thread reads.
    (reference: upsert.clj:73-86)"""

    from .. import generator as gen_mod

    opts = dict(opts or {})
    n = max(1, len(opts.get("nodes", ["n1"])))

    def fgen(k):
        return gen_mod.phases(
            gen_mod.each_thread(
                gen_mod.once({"type": "invoke", "f": "upsert", "value": None})
            ),
            gen_mod.each_thread(
                gen_mod.once({"type": "invoke", "f": "read", "value": None})
            ),
        )

    return {
        "generator": independent.concurrent_generator(
            2 * n, range(100_000), fgen
        ),
        "checker": independent.checker(UpsertChecker()),
        "concurrency": 4 * n,
    }


# ---------------------------------------------------------------------
# delete workload
# ---------------------------------------------------------------------


class DgraphDeleteClient(DgraphClient):
    """Create and delete indexed records per key; reads must never see
    a half-indexed state (zero records or exactly one well-formed one).

    Reference: dgraph/src/jepsen/dgraph/delete.clj:22-62 — :upsert
    creates {key k} unless present, :delete removes the record found by
    an index read, :read returns the matching records.  Both mutations
    ride one transactional upsert block.
    """

    def invoke(self, test, op):
        k, _v = op["value"]
        q = f'{{ q(func: eq(key, {int(k)})) {{ u as uid }} }}'
        try:
            if op["f"] == "read":
                data = self._query(
                    f'{{ q(func: eq(key, {int(k)})) {{ uid key }} }}'
                )
                return {**op, "type": "ok",
                        "value": independent.kv(k, data.get("q", []))}
            if op["f"] == "upsert":
                out = self._upsert(q, [
                    {"cond": "@if(eq(len(u), 0))",
                     "set_nquads": f'_:n <key> "{int(k)}" .'},
                ])
                if (out.get("data") or {}).get("uids"):
                    return {**op, "type": "ok"}
                return {**op, "type": "fail", "error": "present"}
            if op["f"] == "delete":
                out = self._upsert(q, [
                    {"cond": "@if(gt(len(u), 0))",
                     "del_nquads": "uid(u) * * ."},
                ])
                matched = (out.get("data") or {}).get("queries", {}).get("q")
                if matched:
                    return {**op, "type": "ok"}
                return {**op, "type": "fail", "error": "not-found"}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except HttpError as e:
            return {**op, "type": "fail", "error": f"{e.status}: {e.body}"}


class DeleteChecker(checker_mod.Checker):
    """Every ok read sees zero records, or exactly one {uid, key=k}.
    (reference: delete.clj:64-90)"""

    def check(self, test, history, opts=None):
        from ..history import OK as _OK

        k = (opts or {}).get("history-key")
        bad = []
        for op in history:
            if op.type != _OK or op.f != "read" or op.value is None:
                continue
            recs = op.value
            well_formed = len(recs) == 0 or (
                len(recs) == 1
                and set(recs[0].keys()) == {"uid", "key"}
                and (k is None or str(recs[0]["key"]) == str(k))
            )
            if not well_formed:
                bad.append({"index": op.index, "value": recs})
        return {"valid?": not bad, "bad-reads": bad}


def delete_workload(opts: Optional[dict] = None) -> dict:
    """Mixed upsert/delete/read ops per independent key.
    (reference: delete.clj:92-103)"""
    import random as _random

    from .. import generator as gen_mod

    opts = dict(opts or {})
    n = max(1, len(opts.get("nodes", ["n1"])))

    def rw(test, ctx):
        f = _random.choice(["read", "upsert", "delete"])
        return {"type": "invoke", "f": f, "value": None}

    def fgen(k):
        return gen_mod.limit(12, rw)

    return {
        "generator": independent.concurrent_generator(
            2 * n, range(100_000), fgen
        ),
        "checker": independent.checker(DeleteChecker()),
        "concurrency": 4 * n,
    }


# ---------------------------------------------------------------------
# Multi-op transactions over the HTTP txn protocol
# ---------------------------------------------------------------------


class TxnAborted(Exception):
    """Commit-time conflict — the TxnConflictException of the HTTP API
    (reference: dgraph/client.clj catches io.dgraph.TxnConflictException
    and fails the op; bank.clj imports it at :12)."""


class _DgraphTxn:
    """One read-modify-write transaction: queries and mutations carry a
    shared startTs; /commit applies them atomically or aborts.  This is
    Dgraph's native HTTP transaction flow (the gRPC client the reference
    uses does the same under the hood: begin ts from the first response,
    staged mutations, commit with the accumulated keys/preds)."""

    def __init__(self, conn: JsonHttpClient):
        self.conn = conn
        self.start_ts = 0
        self.keys: list = []
        self.preds: list = []

    def _merge_txn(self, body: dict) -> None:
        txn = (body or {}).get("extensions", {}).get("txn", {})
        if txn.get("start_ts"):
            self.start_ts = txn["start_ts"]
        self.keys += txn.get("keys", [])
        self.preds += txn.get("preds", [])

    def query(self, q: str) -> dict:
        path = "/query"
        if self.start_ts:
            path += f"?startTs={self.start_ts}"
        _, body = self.conn.post(
            path, q, headers={"Content-Type": "application/graphql+-"},
            ok=(200,),
        )
        if "errors" in (body or {}):
            raise HttpError(200, body["errors"])
        self._merge_txn(body)
        return body.get("data", {})

    def mutate(self, set_nquads: str = "", del_nquads: str = "") -> dict:
        path = "/mutate"
        if self.start_ts:
            path += f"?startTs={self.start_ts}"
        payload: dict = {}
        if set_nquads:
            payload["set_nquads"] = set_nquads
        if del_nquads:
            payload["del_nquads"] = del_nquads
        _, body = self.conn.post(
            path, json.dumps(payload),
            headers={"Content-Type": "application/json"}, ok=(200,),
        )
        if "errors" in (body or {}):
            raise HttpError(200, body["errors"])
        self._merge_txn(body)
        return body

    def commit(self) -> None:
        status, body = self.conn.request(
            "POST",
            f"/commit?startTs={self.start_ts}",
            body={"keys": self.keys, "preds": self.preds},
            ok=(200,),
            raise_on_error=False,
        )
        if status == 409 or (
            isinstance(body, dict) and "errors" in body
        ):
            # definite abort: the commit did not apply
            raise TxnAborted(str(body))
        if status != 200:
            # anything else (5xx through a faulted proxy, truncated
            # body, …) leaves the commit outcome UNKNOWN — acking it as
            # ok would corrupt the history exactly in the faulted runs
            # this suite exists to test
            raise IndeterminateError(
                f"commit status {status}: {str(body)[:200]}"
            )


# ---------------------------------------------------------------------
# bank workload (reference: dgraph/src/jepsen/dgraph/bank.clj:1-199)
# ---------------------------------------------------------------------

PRED_COUNT = 7  # (reference: bank.clj:15-16)


def gen_pred(prefix: str, k: int) -> str:
    """Key-striped predicate name (reference: client.clj gen-pred,
    consumed at bank.clj:63-66)."""
    return f"{prefix}_{int(k) % PRED_COUNT}"


def gen_preds(prefix: str) -> list:
    return [f"{prefix}_{i}" for i in range(PRED_COUNT)]


BANK_SCHEMA = "\n".join(
    f"{p}: int @index(int) .\n" for p in gen_preds("key") + gen_preds("amount")
) + "\n".join(f"{p}: string @index(exact) .\n" for p in gen_preds("type"))


class DgraphBankClient(DgraphClient):
    """Transfers as read-modify-write transactions over key-striped
    predicates; commit conflicts fail the op.

    Reference: dgraph/bank.clj — striped preds (:15-16, gen-pred via
    client.clj), read-accounts merging per-type-predicate queries
    (:36-57), find-account by key (:59-80), write-account! deleting
    zero-amount nodes (:82-103), transfer as one txn (:105-140)."""

    def setup(self, test):
        try:
            self.conn.post("/alter", BANK_SCHEMA, ok=(200,))
        except (HttpError, IndeterminateError):
            pass
        accounts = list(test.get("accounts", range(8)))
        total = int(test.get("total-amount", 100))
        if not accounts:
            return
        k = accounts[0]
        try:
            self._upsert(
                f'{{ q(func: eq({gen_pred("key", k)}, {int(k)})) '
                "{ u as uid } }",
                [{"cond": "@if(eq(len(u), 0))",
                  "set_nquads": (
                      f'_:a <{gen_pred("key", k)}> "{int(k)}" .\n'
                      f'_:a <{gen_pred("amount", k)}> "{total}" .\n'
                      f'_:a <{gen_pred("type", k)}> "account" .'
                  )}],
            )
        except (HttpError, IndeterminateError):
            pass

    def _find_account(self, txn: _DgraphTxn, k: int) -> dict:
        """(reference: bank.clj:59-80 find-account)"""
        kp, ap = gen_pred("key", k), gen_pred("amount", k)
        data = txn.query(
            f"{{ q(func: eq({kp}, {int(k)})) {{ uid {kp} {ap} }} }}"
        )
        rows = data.get("q", [])
        if rows:
            r = rows[0]
            return {"uid": r["uid"], "key": k,
                    "amount": int(r.get(ap) or 0)}
        return {"uid": None, "key": k, "amount": 0}

    def _write_account(self, txn: _DgraphTxn, acct: dict) -> None:
        """(reference: bank.clj:82-103 write-account!)"""
        k = acct["key"]
        kp, ap, tp = (
            gen_pred("key", k), gen_pred("amount", k), gen_pred("type", k)
        )
        if acct["uid"] is None:
            txn.mutate(set_nquads=(
                f'_:a <{kp}> "{int(k)}" .\n'
                f'_:a <{ap}> "{acct["amount"]}" .\n'
                f'_:a <{tp}> "account" .'
            ))
        elif acct["amount"] == 0:
            txn.mutate(del_nquads=f'<{acct["uid"]}> * * .')
        else:
            txn.mutate(set_nquads=(
                f'<{acct["uid"]}> <{ap}> "{acct["amount"]}" .'
            ))

    def invoke(self, test, op):
        try:
            if op["f"] == "read":
                txn = _DgraphTxn(self.conn)
                out: dict = {}
                for tp in gen_preds("type"):
                    fields = " ".join(
                        gen_preds("key") + gen_preds("amount")
                    )
                    data = txn.query(
                        f'{{ q(func: eq({tp}, "account")) {{ {fields} }} }}'
                    )
                    for row in data.get("q", []):
                        key = amount = None
                        for pred, value in row.items():
                            if value is None:
                                continue
                            if pred.startswith("key_"):
                                key = int(value)
                            elif pred.startswith("amount_"):
                                amount = int(value)
                        if key is not None:
                            out[key] = amount
                # commit the read-only txn: validates the read set, so a
                # transfer landing between the per-predicate scans
                # aborts this read instead of yielding a torn total
                txn.commit()
                return {**op, "type": "ok", "value": out}
            if op["f"] == "transfer":
                frm = int(op["value"]["from"])
                to = int(op["value"]["to"])
                amt = int(op["value"]["amount"])
                txn = _DgraphTxn(self.conn)
                a = self._find_account(txn, frm)
                b = self._find_account(txn, to)
                a2 = {**a, "amount": a["amount"] - amt}
                b2 = {**b, "amount": b["amount"] + amt}
                if a2["amount"] < 0 and not test.get("negative-balances?"):
                    return {**op, "type": "fail",
                            "error": "insufficient funds"}
                self._write_account(txn, a2)
                self._write_account(txn, b2)
                txn.commit()
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except TxnAborted as e:
            return {**op, "type": "fail", "error": f"conflict: {e}"}
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except HttpError as e:
            return {**op, "type": "fail", "error": f"{e.status}: {e.body}"}


# ---------------------------------------------------------------------
# wr (rw-register) + long-fork txn client
# (reference: dgraph/src/jepsen/dgraph/wr.clj:1-32, long_fork.clj)
# ---------------------------------------------------------------------

WR_SCHEMA = (
    "key: int @index(int) @upsert .\n"
    "value: int .\n"
)


class DgraphTxnClient(DgraphClient):
    """Micro-op transactions ([f k v] lists) through one Dgraph txn:
    reads by key index, writes upserting value nodes; commit conflicts
    fail the whole txn.  Serves the wr (Elle rw-register) and long-fork
    workloads.  (reference: wr.clj:13-27 — mop execution in one
    (c/with-txn), conflicts → :fail via client.clj)"""

    def setup(self, test):
        try:
            self.conn.post("/alter", WR_SCHEMA, ok=(200,))
        except (HttpError, IndeterminateError):
            pass

    def _mop(self, txn: _DgraphTxn, local: dict, f, k, v):
        if f == "r":
            # read-your-writes inside the txn: the gRPC client's staged
            # mutations are visible to its own queries; the HTTP staging
            # is not, so mirror it client-side
            if k in local:
                return ["r", k, local[k]]
            data = txn.query(
                f"{{ q(func: eq(key, {int(k)})) {{ value }} }}"
            )
            rows = data.get("q", [])
            val = int(rows[0]["value"]) if rows and rows[0].get("value") is not None else None
            return ["r", k, val]
        if f == "w":
            # a second write to the same key in this txn must hit the
            # node staged by the first, not create a duplicate: the
            # committed store has no row yet, so consult the txn-local
            # uid map before querying (staged blank-node uids come back
            # in the mutate response's data.uids)
            uid = local.get(("uid", k))
            if uid is None:
                data = txn.query(
                    f"{{ q(func: eq(key, {int(k)})) {{ uid }} }}"
                )
                rows = data.get("q", [])
                uid = rows[0]["uid"] if rows else None
            if uid is not None:
                txn.mutate(set_nquads=(
                    f'<{uid}> <value> "{int(v)}" .'
                ))
            else:
                body = txn.mutate(set_nquads=(
                    f'_:n <key> "{int(k)}" .\n_:n <value> "{int(v)}" .'
                ))
                uid = (body.get("data", {}).get("uids") or {}).get("n")
            if uid is not None:
                local[("uid", k)] = uid
            local[k] = v
            return ["w", k, v]
        raise ValueError(f"unknown micro-op {f!r}")

    def invoke(self, test, op):
        txn_value = op["value"]
        try:
            txn = _DgraphTxn(self.conn)
            local: dict = {}
            out = [self._mop(txn, local, f, k, v) for f, k, v in txn_value]
            txn.commit()
            return {**op, "type": "ok", "value": out}
        except TxnAborted as e:
            return {**op, "type": "fail", "error": f"conflict: {e}"}
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except HttpError as e:
            return {**op, "type": "fail", "error": f"{e.status}: {e.body}"}


# ---------------------------------------------------------------------
# sequential workload (reference: dgraph/sequential.clj)
# ---------------------------------------------------------------------


class DgraphSequentialClient(DgraphClient):
    """Read and read-increment-write transactions on per-key registers
    (reference: sequential.clj:64-105).  Restricting transactions to
    read-only or write-your-whole-read-set shapes makes snapshot-
    isolation histories serializable, so each process must observe
    monotonically nondecreasing values of an increment-only register —
    the sequential-consistency probe of sequential.clj:1-48."""

    def invoke(self, test, op):
        k, _ = op["value"]
        try:
            txn = _DgraphTxn(self.conn)
            data = txn.query(
                f"{{ q(func: eq(key, {int(k)})) {{ uid value }} }}"
            )
            rows = data.get("q", [])
            uid = rows[0].get("uid") if rows else None
            value = (
                int(rows[0]["value"])
                if rows and rows[0].get("value") is not None
                else 0
            )
            if op["f"] == "inc":
                value += 1
                if uid:
                    txn.mutate(set_nquads=f'<{uid}> <value> "{value}" .')
                else:
                    txn.mutate(set_nquads=(
                        f'_:n <key> "{int(k)}" .\n_:n <value> "{value}" .'
                    ))
                txn.commit()
                return {**op, "type": "ok",
                        "value": independent.kv(k, value)}
            if op["f"] == "read":
                txn.commit()
                return {**op, "type": "ok",
                        "value": independent.kv(k, value)}
            raise ValueError(f"unknown f {op['f']!r}")
        except TxnAborted as e:
            return {**op, "type": "fail", "error": f"conflict: {e}"}
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except HttpError as e:
            return {**op, "type": "fail", "error": f"{e.status}: {e.body}"}


def sequential_non_monotonic_pairs(history):
    """Pairs of ok ops on one process whose observed value went DOWN
    (reference: sequential.clj:107-126)."""
    from ..history import OK

    last: dict = {}
    errs = []
    for op in history:
        if op.type != OK or not isinstance(op.value, int):
            continue
        prev = last.get(op.process)
        prev_value = prev.value if prev is not None else 0
        if op.value < prev_value:
            errs.append([
                {"op-index": prev.index, "value": prev.value},
                {"op-index": op.index, "value": op.value},
            ])
        last[op.process] = op
    return errs


class SequentialChecker(checker_mod.Checker):
    """Per-process monotonicity of an increment-only register
    (reference: sequential.clj:128-136; generalized over keys by
    independent.checker exactly as the reference does)."""

    def check(self, test, history, opts=None):
        errs = sequential_non_monotonic_pairs(history)
        return {"valid?": not errs, "non-monotonic": errs}


def merged_windows(s, points):
    """[lower, upper] windows of s elements around each point, merged
    when overlapping (reference: sequential.clj:138-158)."""
    if not points:
        return []
    points = sorted(points)
    windows = []
    lower, upper = points[0] - s, points[0] + s
    for p in points[1:]:
        # bounds are inclusive (the plotter slices upper+1), so
        # touching windows merge; split only past the boundary
        if p - s > upper:
            windows.append([lower, upper])
            lower, upper = p - s, p + s
        else:
            upper = p + s
    windows.append([lower, upper])
    return windows


class SequentialPlotter(checker_mod.Checker):
    """Per-process value-over-time SVGs of the ±32-event windows around
    each non-monotonic spot (reference: sequential.clj:160-227; the
    gnuplot rendering is replaced by the framework's self-rendered SVG
    scatter, checker/perf.py)."""

    WINDOW = 32

    def check(self, test, history, opts=None):
        from ..history import NEMESIS, OK
        from ..checker import perf

        interesting = [
            op for op in history
            if (op.type == OK and isinstance(op.value, int))
            or op.process == NEMESIS
        ]
        last: dict = {}
        spots = []
        for i, op in enumerate(interesting):
            if op.process == NEMESIS:
                continue
            prev = last.get(op.process)
            if op.value < (prev.value if prev is not None else 0):
                spots.append(i)
            last[op.process] = op
        for w, (lower, upper) in enumerate(
            merged_windows(self.WINDOW, spots)
        ):
            window = interesting[max(lower, 0):max(upper + 1, 0)]
            series: dict = {}
            for op in window:
                if op.process == NEMESIS:
                    continue
                series.setdefault(op.process, []).append(
                    (op.time / 1e9, op.value)
                )
            if not series:
                continue
            perf.scatter_plot(
                test,
                series,
                path_components=list((opts or {}).get("subdirectory", []))
                + [f"sequential-{w}.svg"],
                title=f"{test.get('name', 'test')} sequential by process",
                ylabel="register value",
                history=history,
            )
        return {"valid?": True}


def sequential_workload(opts: Optional[dict] = None) -> dict:
    """(reference: sequential.clj:229-247 workload)"""
    from .. import generator as gen_mod
    from ..checker import timeline

    opts = dict(opts or {})

    def inc_gen(test, ctx):
        return {"type": "invoke", "f": "inc",
                "value": independent.kv(gen_mod.rng.randrange(8), None)}

    def read_gen(test, ctx):
        return {"type": "invoke", "f": "read",
                "value": independent.kv(gen_mod.rng.randrange(8), None)}

    return {
        "generator": gen_mod.mix([inc_gen, read_gen]),
        "checker": independent.checker(checker_mod.compose({
            "sequential": SequentialChecker(),
            "plot": SequentialPlotter(),
            "timeline": timeline.html(),
        })),
    }
