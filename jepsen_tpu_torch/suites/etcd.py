"""etcd suite — the canonical walkthrough database.

The port's copy of :mod:`jepsen_tpu.suites.etcd`.

The reference builds this test across doc/tutorial/01-…08-*.md: install
an etcd release tarball on every node (02-db.md), cluster them with
``--initial-cluster``, drive reads/writes/CAS over the v2 keys HTTP API
via the verschlimmbesserung client (03-client.md), check with a
CAS-register model (04-checker.md), partition with a nemesis
(05-nemesis.md), and finish with a set workload (08-set.md).

Here the client speaks the v2 keys API directly over
:mod:`.proto.http` — quorum reads, ``prevValue`` CAS —
and the register workload feeds the batched linearizability
checker on the card.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from .. import client as client_mod
from .. import independent
from ..control import util as cu
from ..control import execute, sudo
from . import common
from .proto import IndeterminateError
from .proto.http import HttpError, JsonHttpClient

VERSION = "v3.1.5"  # (reference: doc/tutorial/02-db.md — etcd-test v3.1.5)
DIR = "/opt/etcd"  # (reference: doc/tutorial/02-db.md `(def dir "/opt/etcd")`)
CLIENT_PORT = 2379
PEER_PORT = 2380


def node_url(node: Any, port: int) -> str:
    return f"http://{node}:{port}"


def initial_cluster(test: dict) -> str:
    """node1=http://node1:2380,… (reference: doc/tutorial/02-db.md
    initial-cluster)."""
    return ",".join(f"{n}={node_url(n, PEER_PORT)}" for n in test["nodes"])


class EtcdDB(common.DaemonDB):
    dir = DIR
    binary = "etcd"
    logfile = f"{DIR}/etcd.log"
    pidfile = f"{DIR}/etcd.pid"

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.version = (opts or {}).get("version", VERSION)

    def install(self, test, node):
        url = (
            "https://storage.googleapis.com/etcd/"
            f"{self.version}/etcd-{self.version}-linux-amd64.tar.gz"
        )
        with sudo():
            cu.install_archive(url, self.dir)

    def start_args(self, test, node):
        return [
            "--log-output", "stderr",
            "--name", str(node),
            "--listen-peer-urls", node_url(node, PEER_PORT),
            "--initial-advertise-peer-urls", node_url(node, PEER_PORT),
            "--listen-client-urls", f"http://0.0.0.0:{CLIENT_PORT}",
            "--advertise-client-urls", node_url(node, CLIENT_PORT),
            "--initial-cluster-state", "new",
            "--initial-cluster", initial_cluster(test),
        ]

    def start_env(self, test, node):
        return {"ETCD_API": "2"}

    def await_ready(self, test, node):
        cu.await_tcp_port(CLIENT_PORT)

    def wipe(self, test, node):
        with sudo():
            execute("rm", "-rf", self.dir)


class EtcdClient(client_mod.Client):
    """CAS register over the etcd v2 keys API.

    read → quorum GET /v2/keys/<k>; write → PUT value=v; cas → PUT
    value=v' prevValue=v (reference: doc/tutorial/03-client.md; the
    verschlimmbesserung calls etcd/get :quorum?, etcd/reset!,
    etcd/cas!).  Values travel as JSON ints.  Ops use the
    independent-key convention value=[k, v].
    """

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}
        self.conn: Optional[JsonHttpClient] = None

    def open(self, test, node):
        c = type(self)(self.opts)
        host = self.opts.get("host", str(node))
        port = self.opts.get("port", CLIENT_PORT)
        c.conn = JsonHttpClient(host, port, timeout=5.0)
        return c

    def _key(self, k) -> str:
        return f"/v2/keys/jepsen/{k}"

    def invoke(self, test, op):
        k, v = op["value"] if isinstance(op["value"], (list, tuple)) else (
            "r", op["value"])
        try:
            if op["f"] == "read":
                try:
                    _, body = self.conn.get(self._key(k), params={"quorum": "true"})
                    val = json.loads(body["node"]["value"])
                except HttpError as e:
                    if e.status == 404:
                        val = None
                    else:
                        raise
                return {**op, "type": "ok", "value": independent.kv(k, val)}
            elif op["f"] == "write":
                self.conn.put(self._key(k), {"value": json.dumps(v)}, form=True)
                return {**op, "type": "ok"}
            elif op["f"] == "cas":
                old, new = v
                try:
                    self.conn.put(
                        self._key(k),
                        {"value": json.dumps(new), "prevValue": json.dumps(old)},
                        form=True,
                    )
                    return {**op, "type": "ok"}
                except HttpError as e:
                    # 412 precondition failed / 404 missing key = clean fail
                    if e.status in (404, 412):
                        return {**op, "type": "fail", "error": e.body}
                    raise
            elif op["f"] == "add":
                # set workload: append to a single set key via CAS loop
                return self._add(test, op)
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except HttpError as e:
            return {**op, "type": "fail", "error": f"{e.status}: {e.body}"}

    def _add(self, test, op):
        """Set workload add: read-modify-CAS a JSON list (reference:
        doc/tutorial/08-set.md uses a single set key)."""
        for _ in range(5):
            try:
                _, body = self.conn.get("/v2/keys/jepsen/set",
                                        params={"quorum": "true"})
                cur = json.loads(body["node"]["value"])
                idx = body["node"]["modifiedIndex"]
                new = cur + [op["value"]]
                self.conn.put(
                    "/v2/keys/jepsen/set",
                    {"value": json.dumps(new), "prevIndex": str(idx)},
                    form=True,
                )
                return {**op, "type": "ok"}
            except HttpError as e:
                if e.status == 404:
                    try:
                        self.conn.put(
                            "/v2/keys/jepsen/set",
                            {"value": json.dumps([op["value"]]),
                             "prevExist": "false"},
                            form=True,
                        )
                        return {**op, "type": "ok"}
                    except HttpError as e2:
                        if e2.status == 412:
                            continue
                        return {**op, "type": "fail", "error": str(e2.body)}
                elif e.status == 412:
                    continue
                else:
                    return {**op, "type": "fail", "error": f"{e.status}"}
        return {**op, "type": "fail", "error": "cas-retries-exhausted"}

    def close(self, test):
        if self.conn:
            self.conn.close()


class _SetReadClient(EtcdClient):
    """Reads the whole set key for the final read."""

    def invoke(self, test, op):
        if op["f"] == "read":
            try:
                _, body = self.conn.get("/v2/keys/jepsen/set",
                                        params={"quorum": "true"})
                return {**op, "type": "ok",
                        "value": json.loads(body["node"]["value"])}
            except IndeterminateError as e:
                return {**op, "type": "info", "error": str(e)}
            except HttpError as e:
                if e.status == 404:
                    return {**op, "type": "ok", "value": []}
                return {**op, "type": "fail", "error": f"{e.status}"}
        return super().invoke(test, op)


def db(opts: Optional[dict] = None):
    return EtcdDB(opts)


def client(opts: Optional[dict] = None):
    return EtcdClient(opts)


def workloads(opts: Optional[dict] = None) -> dict:
    opts = dict(opts or {})
    return {
        "register": common.register_workload(opts),
        "set": common.set_workload(opts),
    }


def test(opts: Optional[dict] = None) -> dict:
    """Full etcd test map (reference: doc/tutorial/06-refining.md
    etcd-test)."""
    opts = dict(opts or {})
    wname = opts.get("workload", "register")
    w = workloads(opts)[wname]
    c = _SetReadClient(opts) if wname == "set" else EtcdClient(opts)
    return common.build_test(
        f"etcd-{wname}", opts, db=EtcdDB(opts), client=c, workload=w
    )
