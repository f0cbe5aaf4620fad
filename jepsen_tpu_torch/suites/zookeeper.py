"""ZooKeeper suite.

The port's copy of :mod:`jepsen_tpu.suites.zookeeper`.

Reference: zookeeper/src/jepsen/zookeeper.clj — install the zookeeper
debs (:46-49), write ``/etc/zookeeper/conf/myid`` from the node's index
(:50-51) and a zoo.cfg whose ``server.N=node:2888:3888`` lines span the
test nodes (:32-43,52-56), restart the service, and run a linearizable
compare-and-set register over a znode (the reference drives an avout
distributed atom; here the client uses the ZAB wire protocol directly
with version-checked ``setData`` for CAS).
"""

from __future__ import annotations

import json
import uuid
from typing import Any, Optional

from .. import checker as checker_mod
from .. import client as client_mod
from .. import independent
from .. import control
from ..control import util as cu
from ..os_setup import debian
from . import common
from .proto import IndeterminateError
from .proto.zk import ZkClient, ZkError

PORT = 2181


def zk_node_id(test: dict, node: Any) -> int:
    """(reference: zookeeper.clj:26-30)"""
    return test["nodes"].index(node)


def zoo_cfg_servers(test: dict) -> str:
    """(reference: zookeeper.clj:32-43)"""
    return "\n".join(
        f"server.{i}={n}:2888:3888" for i, n in enumerate(test["nodes"])
    )


_ZOO_CFG = """tickTime=2000
initLimit=10
syncLimit=5
dataDir=/var/lib/zookeeper
clientPort=2181
"""


class ZookeeperDB(common.DaemonDB):
    logfile = "/var/log/zookeeper/zookeeper.log"
    proc_name = "java"

    def __init__(self, opts: Optional[dict] = None):
        super().__init__(opts)
        self.version = (opts or {}).get("version")

    def install(self, test, node):
        # (reference: zookeeper.clj:46-49)
        pkgs = (
            [f"zookeeper={self.version}", f"zookeeperd={self.version}"]
            if self.version else ["zookeeper", "zookeeperd"]
        )
        debian.install(pkgs)

    def configure(self, test, node):
        with control.su():
            cu.write_file(str(zk_node_id(test, node)),
                          "/etc/zookeeper/conf/myid")
            cu.write_file(_ZOO_CFG + zoo_cfg_servers(test) + "\n",
                          "/etc/zookeeper/conf/zoo.cfg")

    def start(self, test, node):
        with control.su():
            control.execute("service", "zookeeper", "restart", check=False)

    def kill(self, test, node):
        with control.su():
            control.execute("service", "zookeeper", "stop", check=False)
            cu.grepkill("zookeeper")

    def await_ready(self, test, node):
        cu.await_tcp_port(PORT, timeout_s=120)

    def wipe(self, test, node):
        with control.su():
            control.execute("rm", "-rf", "/var/lib/zookeeper/version-2",
                            check=False)


class ZkRegisterClient(client_mod.Client):
    """CAS register on a znode: read via getData, write via versioned
    create/set, CAS via read-version + conditional setData (the znode
    version is the optimistic lock).  One znode per independent key."""

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}
        self.conn: Optional[ZkClient] = None

    def open(self, test, node):
        c = type(self)(self.opts)
        c.conn = ZkClient(
            self.opts.get("host", str(node)),
            self.opts.get("port", PORT),
            timeout=self.opts.get("timeout", 10.0),
        )
        return c

    def _path(self, k) -> str:
        return f"/jepsen-{k}"

    def invoke(self, test, op):
        k, v = op["value"]
        path = self._path(k)
        try:
            if op["f"] == "read":
                try:
                    data, _ = self.conn.get_data(path)
                    val = json.loads(data.decode())
                except ZkError as e:
                    if e.code == -101:  # NONODE
                        val = None
                    else:
                        raise
                return {**op, "type": "ok", "value": independent.kv(k, val)}
            if op["f"] == "write":
                data = json.dumps(v).encode()
                try:
                    self.conn.set_data(path, data)
                except ZkError as e:
                    if e.code != -101:
                        raise
                    try:
                        self.conn.create(path, data)
                    except ZkError as e2:
                        if e2.code != -110:  # NODEEXISTS: lost a race
                            raise
                        self.conn.set_data(path, data)
                return {**op, "type": "ok"}
            if op["f"] == "cas":
                old, new = v
                try:
                    data, stat = self.conn.get_data(path)
                except ZkError as e:
                    if e.code == -101:
                        return {**op, "type": "fail", "error": "no-node"}
                    raise
                if json.loads(data.decode()) != old:
                    return {**op, "type": "fail", "error": "value-mismatch"}
                try:
                    self.conn.set_data(path, json.dumps(new).encode(),
                                       version=stat.version)
                except ZkError as e:
                    if e.code == -103:  # BADVERSION: lost the race
                        return {**op, "type": "fail", "error": "bad-version"}
                    raise
                return {**op, "type": "ok"}
            raise ValueError(f"unknown f {op['f']!r}")
        except IndeterminateError as e:
            return {**op, "type": "info", "error": str(e)}
        except ZkError as e:
            return {**op, "type": "fail", "error": str(e)}

    def close(self, test):
        if self.conn:
            self.conn.close()


class ZkLockClient(client_mod.Client):
    """Distributed try-lock over a well-known znode: acquire = create
    (NODE_EXISTS → definite fail), release = delete of our own node —
    the classic ZooKeeper lock recipe, checked against the OWNER-AWARE
    mutex model: completions carry the ZK session id, so the checker
    catches not just double grants but releases by a non-holder
    (reference: hazelcast.clj:340-449 lock clients + the knossos mutex
    model consumed at jepsen/src/jepsen/checker.clj:19-26; the
    owner-aware reduction rides the dense device kernel).

    The client refuses double-acquires and releases-without-holding
    locally (definite fails that never touch the wire).  A connection
    cut mid-acquire is indeterminate: the lock may now be held by a
    node nobody will release — the history stays linearizable (an
    :info acquire may linearize forever), later acquires just fail."""

    PATH = "/jepsen-lock"

    def __init__(self, opts: Optional[dict] = None):
        self.opts = opts or {}
        self.conn: Optional[ZkClient] = None
        self.held = False
        self.uid = uuid.uuid4().hex[:8]

    def open(self, test, node):
        c = type(self)(self.opts)
        c.conn = ZkClient(
            self.opts.get("host", str(node)),
            self.opts.get("port", PORT),
            timeout=self.opts.get("timeout", 10.0),
        )
        return c

    def _me(self) -> dict:
        """A per-opened-client identity for the owner-aware model.
        Deliberately NOT the ZK session id: the connection is lazy, so
        a crash during the handshake would stamp the shared sentinel
        0 and collide distinct clients on one phantom owner — and an
        identity must stay stable across ALL of one client's ops.  One
        client ≈ one session for this recipe, so the per-open id keeps
        the model's owner semantics faithful."""
        return {"client": f"zk-{self.uid}"}

    def invoke(self, test, op):
        try:
            if op["f"] == "acquire":
                if self.held:
                    return {**op, "type": "fail", "error": "already-held"}
                try:
                    self.conn.create(self.PATH, b"held")
                except ZkError as e:
                    if e.code == -110:  # NODEEXISTS: lock taken
                        return {**op, "type": "fail", "error": "taken"}
                    raise
                self.held = True
                return {**op, "type": "ok", "value": self._me()}
            if op["f"] == "release":
                if not self.held:
                    return {**op, "type": "fail", "error": "not-held"}
                try:
                    self.conn.delete(self.PATH)
                except ZkError as e:
                    self.held = False
                    if e.code == -101:
                        # NONODE: the delete DEFINITELY did not execute
                        # — report a definite fail so the checker can
                        # flag the underlying anomaly (our held lock
                        # vanishing is exactly what a lock test exists
                        # to catch: a later acquire-ok with no
                        # intervening release-ok must read as invalid)
                        return {**op, "type": "fail",
                                "error": "lock vanished while held"}
                    raise
                self.held = False
                return {**op, "type": "ok", "value": self._me()}
            raise ValueError(f"unknown f {op['f']!r}")
        except (IndeterminateError, OSError) as e:
            # a cut connection loses track of whether we hold the lock;
            # assume not (never release what we might not own).  OSError
            # covers the lazy handshake dying raw (ConnectionRefused
            # etc.) — without this catch the interpreter's crash path
            # would record an identity-less info op, pushing the WHOLE
            # history off the kernel onto the exponential oracle.  The
            # info op still says WHO may have acted, so the model can
            # linearize it (checker/linear.py info-value propagation)
            self.held = False
            return {**op, "type": "info", "error": str(e),
                    "value": self._me()}
        except ZkError as e:
            return {**op, "type": "fail", "error": str(e)}

    def close(self, test):
        if self.conn:
            self.conn.close()


def lock_workload(opts: Optional[dict] = None) -> dict:
    """Contended try-lock/release cycles checked against the
    owner-aware mutex model — which reduces to cas-register codes at
    encode time (ops/step_kernels.py owner-mutex spec; the dense
    automaton inside C ≤ 12, the frontier search beyond), where
    ``opts["device"]`` says."""
    from .. import generator as gen
    from .. import models

    return {
        "generator": gen.each_thread(gen.cycle([
            {"type": "invoke", "f": "acquire", "value": None},
            {"type": "invoke", "f": "release", "value": None},
        ])),
        "checker": checker_mod.linearizable(
            models.owner_mutex(), pure_fs=(), device=(opts or {}).get("device")
        ),
    }


def db(opts: Optional[dict] = None):
    return ZookeeperDB(opts)


def client(opts: Optional[dict] = None):
    return ZkRegisterClient(opts)


def workloads(opts: Optional[dict] = None) -> dict:
    opts = dict(opts or {})
    return {
        "register": common.register_workload(opts),
        "lock": lock_workload(opts),
    }


def test(opts: Optional[dict] = None) -> dict:
    opts = dict(opts or {})
    wname = opts.get("workload", "register")
    w = workloads(opts)[wname]
    c = {"lock": ZkLockClient}.get(wname, ZkRegisterClient)(opts)
    return common.build_test(
        f"zookeeper-{wname}", opts, db=ZookeeperDB(opts),
        client=c, workload=w,
    )
