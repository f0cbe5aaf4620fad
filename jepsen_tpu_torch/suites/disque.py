"""Disque (distributed job queue) suite.

The port's copy of :mod:`jepsen_tpu.suites.disque`.

Reference: disque/src/jepsen/disque.clj — build disque from source
(install!:40-53), start ``disque-server`` under start-stop-daemon
(:75-92), ``CLUSTER MEET`` every node to the primary (:94-104), and
run a total-queue workload over the Jedisque client: ADDJOB with
retry/replication params, GETJOB + ACKJOB for dequeues (:140-215).
The client here speaks disque's RESP protocol directly.
"""

from __future__ import annotations

from typing import Optional

from .. import client as client_mod
from .. import control
from ..control import util as cu
from ..os_setup import debian
from . import common
from .proto import IndeterminateError, ProtocolError
from .proto.resp import RespClient

DIR = "/opt/disque"
PORT = 7711
QUEUE = "jepsen"
JOB_TIMEOUT_MS = 100       # (reference: disque.clj addjob timeout)
GET_TIMEOUT_MS = 100


class DisqueDB(common.DaemonDB):
    dir = DIR
    binary = "src/disque-server"
    logfile = f"{DIR}/disque.log"
    pidfile = f"{DIR}/disque.pid"
    proc_name = "disque-server"

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.version = (opts or {}).get("version", "master")

    def install(self, test, node):
        # (reference: disque.clj:40-53 — git build)
        debian.install(["git-core", "build-essential"])
        with control.su():
            control.execute(
                "bash", "-c",
                f"test -d {DIR} || git clone "
                f"https://github.com/antirez/disque.git {DIR}",
            )
            with control.cd(DIR):
                control.execute("git", "reset", "--hard", self.version,
                                check=False)
                control.execute("make", check=False)

    def start_args(self, test, node):
        return ["--port", str(PORT), "--appendonly", "yes",
                "--dir", DIR]

    def setup(self, test, node):
        super().setup(test, node)
        # join everyone to the primary (reference: disque.clj:94-104)
        primary = test["nodes"][0]
        if node != primary:
            control.execute(
                f"{DIR}/src/disque", "-p", str(PORT),
                "cluster", "meet", str(primary), str(PORT), check=False,
            )

    def await_ready(self, test, node):
        cu.await_tcp_port(PORT, timeout_s=120)

    def wipe(self, test, node):
        with control.su():
            control.execute("rm", "-f", f"{DIR}/appendonly.aof",
                            f"{DIR}/nodes.conf", check=False)


class DisqueClient(client_mod.Client):
    """enqueue → ADDJOB, dequeue → GETJOB + ACKJOB, drain → GETJOB until
    empty (reference: disque.clj:140-215)."""

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

    def _dequeue_one(self):
        jobs = self.conn.call(
            "GETJOB", "TIMEOUT", str(GET_TIMEOUT_MS), "FROM", QUEUE
        )
        if not jobs:
            return None
        # [[queue, job-id, body]]
        _qname, job_id, body = jobs[0][0], jobs[0][1], jobs[0][2]
        self.conn.call("ACKJOB", job_id)
        return int(body)

    def invoke(self, test, op):
        try:
            if op["f"] == "enqueue":
                self.conn.call(
                    "ADDJOB", QUEUE, str(op["value"]), str(JOB_TIMEOUT_MS)
                )
                return {**op, "type": "ok"}
            if op["f"] == "dequeue":
                v = self._dequeue_one()
                if v is None:
                    return {**op, "type": "fail", "error": "empty"}
                return {**op, "type": "ok", "value": v}
            if op["f"] == "drain":
                got = []
                while True:
                    v = self._dequeue_one()
                    if v is None:
                        break
                    got.append(v)
                return {**op, "type": "ok", "value": got}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except ProtocolError as e:
            return {**op, "type": "fail", "error": str(e)}

    def close(self, test):
        if self.conn:
            self.conn.close()


def db(opts: Optional[dict] = None):
    return DisqueDB(opts)


def client(opts: Optional[dict] = None):
    return DisqueClient(opts)


def workloads(opts: Optional[dict] = None) -> dict:
    return {
        "queue": common.queue_workload(dict(opts or {})),
        "linearizable-queue": common.linearizable_queue_workload(
            dict(opts or {})
        ),
    }


def test(opts: Optional[dict] = None) -> dict:
    opts = dict(opts or {})
    wname = opts.get("workload", "queue")
    w = workloads(opts)[wname]
    return common.build_test(
        f"disque-{wname}", opts, db=DisqueDB(opts), client=DisqueClient(opts),
        workload=w,
    )
