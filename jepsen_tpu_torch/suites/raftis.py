"""Raftis (Redis over Raft) suite.

The port's copy of :mod:`jepsen_tpu.suites.raftis`.

Reference: raftis/src/jepsen/raftis.clj — clone + build raftis on each
node, start it with the cluster's member list, and run a single
read/write register over the Redis protocol (:20-48; note the
reference's client has no CAS — raftis only exposes GET/SET — so the
register model is write/read only).
"""

from __future__ import annotations

from typing import Optional

from .. import client as client_mod
from .. import independent
from .. import control
from ..control import util as cu
from ..os_setup import debian
from . import common
from .proto import IndeterminateError, ProtocolError
from .proto.resp import RespClient

DIR = "/opt/raftis"
PORT = 6379


class RaftisDB(common.DaemonDB):
    dir = DIR
    binary = "raftis"
    logfile = f"{DIR}/raftis.log"
    pidfile = f"{DIR}/raftis.pid"

    def install(self, test, node):
        # (reference: raftis.clj — git clone + build)
        debian.install(["git-core", "build-essential", "golang"])
        with control.su():
            control.execute(
                "bash", "-c",
                f"test -d {DIR} || git clone --depth 1 "
                f"https://github.com/goraft/raftis {DIR}",
                check=False,
            )
            with control.cd(DIR):
                control.execute("go", "build", "-o", "raftis", check=False)

    def start_args(self, test, node):
        peers = ",".join(f"{n}:{PORT}" for n in test["nodes"])
        return ["-bind", f"0.0.0.0:{PORT}", "-peers", peers]

    def await_ready(self, test, node):
        cu.await_tcp_port(PORT, timeout_s=120)


class RaftisClient(client_mod.Client):
    """GET/SET register (reference: raftis.clj:34-48)."""

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}
        self.conn: Optional[RespClient] = None

    def open(self, test, node):
        c = type(self)(self.opts)
        c.conn = RespClient(
            self.opts.get("host", str(node)),
            self.opts.get("port", PORT),
            timeout=self.opts.get("timeout", 5.0),
        )
        return c

    def invoke(self, test, op):
        k, v = op["value"]
        try:
            if op["f"] == "read":
                raw = self.conn.call("GET", f"r{k}")
                val = int(raw) if raw is not None else None
                return {**op, "type": "ok", "value": independent.kv(k, val)}
            if op["f"] == "write":
                self.conn.call("SET", f"r{k}", str(v))
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except ProtocolError as e:
            return {**op, "type": "fail", "error": str(e)}

    def close(self, test):
        if self.conn:
            self.conn.close()


def db(opts: Optional[dict] = None):
    return RaftisDB(opts)


def client(opts: Optional[dict] = None):
    return RaftisClient(opts)


def workloads(opts: Optional[dict] = None) -> dict:
    # write/read only — raftis exposes no CAS (reference: raftis.clj:20-22)
    opts = dict(opts or {})
    opts["cas?"] = False
    return {"register": common.register_workload(opts)}


def test(opts: Optional[dict] = None) -> dict:
    opts = dict(opts or {})
    w = workloads(opts)["register"]
    return common.build_test(
        "raftis-register", opts, db=RaftisDB(opts),
        client=RaftisClient(opts), workload=w,
    )
