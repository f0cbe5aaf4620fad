"""Consul suite.

The port's copy of :mod:`jepsen_tpu.suites.consul`.

Reference: consul/src/jepsen/consul/{db,client,register}.clj — install a
consul release zip (db.clj:54-95), run ``consul agent -server`` with the
first node bootstrapping and the rest retry-joining it (db.clj:23-51),
and drive a CAS register over the KV HTTP API: base64-encoded values,
index-based CAS (two-phase: read ModifyIndex, then ``?cas=<index>``;
client.clj:66-85), with reads at configurable consistency
(default/consistent/stale).
"""

from __future__ import annotations

import base64
import json
from typing import Optional

from .. import client as client_mod
from .. import independent
from ..control import util as cu
from ..control import execute, sudo
from . import common
from .proto import IndeterminateError
from .proto.http import HttpError, JsonHttpClient

VERSION = "0.5.2"
DIR = "/opt"                     # (reference: consul/db.clj:14)
BINARY = "consul"
PIDFILE = "/var/run/consul.pid"  # (reference: consul/db.clj:18)
LOGFILE = "/var/log/consul.log"
DATA_DIR = "/var/lib/consul"
HTTP_PORT = 8500
RETRY_INTERVAL = "5s"            # (reference: consul/db.clj:21)


class ConsulDB(common.DaemonDB):
    dir = DIR
    binary = BINARY
    logfile = LOGFILE
    pidfile = PIDFILE

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.version = (opts or {}).get("version", VERSION)

    def install(self, test, node):
        url = (
            "https://releases.hashicorp.com/consul/"
            f"{self.version}/consul_{self.version}_linux_amd64.zip"
        )
        with sudo():
            cu.install_archive(url, f"{DIR}/{BINARY}")

    def start_args(self, test, node):
        # (reference: consul/db.clj:23-51 start-consul!)
        primary = test["nodes"][0]
        args = [
            "agent", "-server",
            "-log-level", "debug",
            "-client", "0.0.0.0",
            "-bind", str(node),
            "-data-dir", DATA_DIR,
            "-node", str(node),
            "-retry-interval", RETRY_INTERVAL,
        ]
        if node == primary:
            args.append("-bootstrap")
        else:
            args += ["-retry-join", str(primary)]
        return args

    def await_ready(self, test, node):
        cu.await_tcp_port(HTTP_PORT)

    def wipe(self, test, node):
        # (reference: consul/db.clj:80-87)
        with sudo():
            execute("rm", "-rf", PIDFILE, LOGFILE, DATA_DIR, f"{DIR}/{BINARY}")


class ConsulClient(client_mod.Client):
    """CAS register over the consul KV API (reference:
    consul/client.clj).  Values are JSON ints, base64-wrapped by consul;
    CAS reads the current ModifyIndex then writes with ``?cas=``."""

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}
        self.conn: Optional[JsonHttpClient] = None

    def open(self, test, node):
        c = type(self)(self.opts)
        host = self.opts.get("host", str(node))
        port = self.opts.get("port", HTTP_PORT)
        c.conn = JsonHttpClient(host, port, timeout=5.0)
        return c

    def _read(self, k):
        """→ (value, modify-index) or (None, 0).  (reference:
        consul/client.clj:22-46 parse-body/parse-index)"""
        params = {}
        consistency = self.opts.get("consistency")
        if consistency:
            params[consistency] = ""
        try:
            _, body = self.conn.get(f"/v1/kv/jepsen/{k}", params=params)
        except HttpError as e:
            if e.status == 404:
                return None, 0
            raise
        rec = body[0]
        raw = base64.b64decode(rec["Value"]).decode() if rec.get("Value") else None
        value = json.loads(raw) if raw not in (None, "null") else None
        return value, rec["ModifyIndex"]

    def invoke(self, test, op):
        k, v = op["value"] if isinstance(op["value"], (list, tuple)) else (
            "r", op["value"])
        try:
            if op["f"] == "read":
                value, _ = self._read(k)
                return {**op, "type": "ok", "value": independent.kv(k, value)}
            if op["f"] == "write":
                self.conn.put(f"/v1/kv/jepsen/{k}", json.dumps(v))
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                # (reference: consul/client.clj:66-85 cas!)
                old, new = v
                cur, index = self._read(k)
                if cur != old:
                    return {**op, "type": "fail", "error": "value-mismatch"}
                _, okbody = self.conn.put(
                    f"/v1/kv/jepsen/{k}", json.dumps(new),
                    params={"cas": str(index)},
                )
                if okbody is True or okbody == "true":
                    return {**op, "type": "ok"}
                return {**op, "type": "fail", "error": "index-cas-lost"}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except HttpError as e:
            return {**op, "type": "fail", "error": f"{e.status}: {e.body}"}

    def close(self, test):
        if self.conn:
            self.conn.close()


def db(opts: Optional[dict] = None):
    return ConsulDB(opts)


def client(opts: Optional[dict] = None):
    return ConsulClient(opts)


def workloads(opts: Optional[dict] = None) -> dict:
    return {"register": common.register_workload(dict(opts or {}))}


def test(opts: Optional[dict] = None) -> dict:
    opts = dict(opts or {})
    w = workloads(opts)[opts.get("workload", "register")]
    return common.build_test(
        "consul-register", opts, db=ConsulDB(opts), client=ConsulClient(opts),
        workload=w,
    )
