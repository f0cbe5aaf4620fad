"""localkv suite — a real native database, installed and torn apart on
this host; the port's copy of :mod:`jepsen_tpu.suites.localkv`.

The "database" is ``native/repregd.cc``, a single-binary replicated
linearizable register (multi-writer ABD over majority quorums, fsync'd
state).  The suite's DB **compiles the source on the node with g++
through the control layer** — the deploy-and-build mechanism the
reference uses for its clock-fault helpers
(jepsen/src/jepsen/nemesis/time.clj:20-50) — then runs one replica per
node under ``start-stop-daemon``, with every directed peer link routed
through a partitionable loopback forwarder
(:class:`jepsen_tpu_torch.net.LoopbackProxyNet`).

That makes this the full reference test shape — install → run →
partition/kill → snarf logs → check — against real processes with real
replication state, on any host with g++ and ``start-stop-daemon``
(reference shape: the etcd tutorial, doc/tutorial/01-…05-*.md, and
core_test.clj:122-177's integration tests; the run
``doc/example-local-cluster`` records).  The history is checked by
``checker.linearizable(cas_register(0))`` where ``opts["device"]`` says:
the current CUDA device by default, the plain versions with ``"cpu"``.

The node directories default to ``jepsen-localkv`` under the temporary
directory (:func:`tempfile.gettempdir`, ``/tmp`` where the reference
writes); ``opts["dir"]`` moves them.
"""

from __future__ import annotations

import os
import random
import socket
import tempfile
import threading
from typing import Any, Dict, List, Optional

from .. import client as client_mod, util
from .. import db as db_mod
from .. import net as net_mod
from ..checker import linearizable
from ..control import execute, upload
from ..control import util as cu
from ..models import cas_register
from . import common

#: the daemon source at the repository's root (neither package owns it);
#: uploaded to each node and compiled there
SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "repregd.cc",
)


def _node_id(node: Any, nodes: List[Any]) -> int:
    try:
        return int(str(node).lstrip("n"))
    except ValueError:
        return nodes.index(node) + 1


class LocalKVDB(db_mod.DB, db_mod.Process, db_mod.Pause, db_mod.LogFiles):
    """Compiles and runs one repregd replica per node.

    All replicas share this host (the localkv deployment model), so
    each gets a per-node directory, port, and state file; peer links
    ride per-edge loopback forwarders so the standard partitioner
    genuinely severs replication traffic.  Wiring (ports + proxy
    routes) is built lazily on first setup — test assembly stays free
    of side effects.
    """

    def __init__(self, opts: Optional[dict] = None):
        self.opts = dict(opts or {})
        self.base = self.opts.get(
            "dir", os.path.join(tempfile.gettempdir(), "jepsen-localkv"))
        self.net = net_mod.LoopbackProxyNet()
        self.ports: Dict[Any, int] = {}
        self._peer_specs: Dict[Any, str] = {}
        self._lock = threading.Lock()
        self._wired = False
        self._torn_down: set = set()

    # -- wiring --------------------------------------------------------

    def _ensure_wiring(self, test: dict) -> None:
        with self._lock:
            if self._wired:
                return
            nodes = list(test["nodes"])
            self.ports = {n: util.free_port() for n in nodes}
            for a in nodes:
                spec = []
                for b in nodes:
                    if a == b:
                        continue
                    p = self.net.add_route(a, b, "127.0.0.1", self.ports[b])
                    spec.append(f"{_node_id(b, nodes)}=127.0.0.1:{p}")
                self._peer_specs[a] = ",".join(spec)
            self._wired = True
            # teardowns recorded before wiring (db.cycle tears down
            # first, in parallel across nodes) must not count toward
            # the live cluster's shutdown
            self._torn_down = set()

    def _dir(self, node: Any) -> str:
        return f"{self.base}/{node}"

    # -- DB ------------------------------------------------------------

    def setup(self, test: dict, node: Any) -> None:
        self._ensure_wiring(test)
        d = self._dir(node)
        execute("mkdir", "-p", d)
        upload(SOURCE, f"{d}/repregd.cc")
        # build on the node, exactly like the reference gcc's its clock
        # helpers on DB nodes (nemesis/time.clj:20-50)
        execute(
            "g++", "-O2", "-pthread", "-o", f"{d}/repregd", f"{d}/repregd.cc"
        )
        self.start(test, node)
        cu.await_tcp_port(self.ports[node], host="127.0.0.1", timeout_s=60)

    def teardown(self, test: dict, node: Any) -> None:
        cu.meh(lambda: self.kill(test, node))
        execute("rm", "-rf", self._dir(node), check=False)
        with self._lock:
            if not self._wired:
                return  # pre-wiring teardown of a cycle: nothing to free
            self._torn_down.add(node)
            if self._torn_down >= set(test["nodes"]):
                # all replicas down: release the forwarders, and arm a
                # fresh wiring pass — core.run CYCLES the db (teardown
                # before setup, db.py cycle), so the next setup must
                # rebuild routes on this same Net instance
                self.net.reset()
                self._wired = False
                self._torn_down = set()

    # -- Process -------------------------------------------------------

    def start(self, test: dict, node: Any) -> None:
        d = self._dir(node)
        nodes = list(test["nodes"])
        cu.start_daemon(
            {
                "logfile": f"{d}/server.log",
                "pidfile": f"{d}/server.pid",
                "chdir": d,
                "match-executable?": False,
            },
            f"{d}/repregd",
            str(_node_id(node, nodes)),
            str(self.ports[node]),
            f"{d}/state",
            self._peer_specs[node],
        )

    def kill(self, test: dict, node: Any) -> None:
        # match this node's unique binary path, not a generic name, so
        # other replicas (and other runs) survive
        cu.grepkill(f"{self._dir(node)}/repregd", 9)
        cu.stop_daemon(pidfile=f"{self._dir(node)}/server.pid")

    # -- Pause ---------------------------------------------------------

    def pause(self, test: dict, node: Any) -> None:
        cu.grepkill(f"{self._dir(node)}/repregd", "STOP")

    def resume(self, test: dict, node: Any) -> None:
        cu.grepkill(f"{self._dir(node)}/repregd", "CONT")

    # -- LogFiles ------------------------------------------------------

    def log_files(self, test: dict, node: Any):
        return [f"{self._dir(node)}/server.log"]


class LocalKVClient(client_mod.Client):
    """Line-protocol client: each worker talks to its own node's
    replica, which coordinates the quorum op.  ERR-EARLY → :fail
    (nothing stored), ERR-MAYBE → :info (indeterminate)."""

    def __init__(self, opts: Optional[dict] = None, node: Any = None):
        self.opts = dict(opts or {})
        self.node = node
        self.sock: Optional[socket.socket] = None
        self.f = None

    def open(self, test, node):
        c = LocalKVClient(self.opts, node)
        c._connect(test)
        return c

    def _connect(self, test):
        port = test["db"].ports[self.node]
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        self.f = self.sock.makefile("rw")

    def _ask(self, line: str) -> str:
        self.f.write(line + "\n")
        self.f.flush()
        out = self.f.readline().strip()
        if not out:
            raise ConnectionError("server went away")
        return out

    def invoke(self, test, op):
        if op["f"] not in ("read", "write"):
            # a programming error must fail loudly, not soak into the
            # history as indeterminate ops
            raise ValueError(f"unsupported op f={op['f']!r}")
        try:
            if self.sock is None:
                self._connect(test)
        except OSError as e:
            # connect refused: the request never reached any server —
            # definite failure for every op type
            self.sock = None
            return {**op, "type": "fail", "error": f"connect: {e!r}"}
        try:
            if op["f"] == "read":
                out = self._ask("R")
                if out.startswith("ERR"):
                    return {**op, "type": "fail", "error": out}
                return {**op, "type": "ok", "value": int(out)}
            out = self._ask(f"W {op['value']}")
            if out == "OK":
                return {**op, "type": "ok"}
            if out.startswith("ERR-EARLY"):
                return {**op, "type": "fail", "error": out}
            return {**op, "type": "info", "error": out}
        except (OSError, ConnectionError, ValueError) as e:
            # ValueError here = a mangled wire reply (int parse), the
            # same indeterminacy class as a cut connection
            self.sock = None
            t = "fail" if op["f"] == "read" else "info"
            return {**op, "type": t, "error": repr(e)}

    def close(self, test):
        if self.sock is not None:
            self.sock.close()
            self.sock = None


def db(opts: Optional[dict] = None) -> LocalKVDB:
    return LocalKVDB(opts)


def client(opts: Optional[dict] = None) -> LocalKVClient:
    return LocalKVClient(opts)


def register_workload(opts: Optional[dict] = None) -> dict:
    """Single replicated register: concurrent reads and unique-valued
    writes (unique values keep the linearizability search sharp — a
    read's value pins exactly which write it observed).  The checker
    runs where ``opts["device"]`` says."""
    counter = {"n": 0}

    def rw(test, ctx):
        if random.random() < 0.5:
            return {"type": "invoke", "f": "read", "value": None}
        counter["n"] += 1
        return {"type": "invoke", "f": "write", "value": counter["n"]}

    return {
        "generator": rw,
        "checker": linearizable(cas_register(0),
                                device=(opts or {}).get("device")),
    }


def workloads(opts: Optional[dict] = None) -> dict:
    return {"register": register_workload(opts or {})}


def test(opts: Optional[dict] = None) -> dict:
    """Full runnable test map.  opts: nodes, faults (partition/kill/
    pause), time-limit, concurrency, rate, dir, device."""
    opts = dict(opts or {})
    opts.setdefault("nodes", ["n1", "n2", "n3"])
    d = db(opts)
    wname = opts.get("workload", "register")
    # only_active: an idle clock sub-nemesis would build the clock
    # helpers with gcc on every node at setup — pointless for a loopback
    # cluster that never requests clock faults
    from ..nemesis import combined

    pkg = combined.nemesis_package(
        {
            "db": d,
            "faults": opts.get("faults", ["partition", "kill"]),
            "interval": opts.get("interval", combined.DEFAULT_INTERVAL),
        },
        only_active=True,
    )
    t = common.build_test(
        "localkv",
        opts,
        db=d,
        client=client(opts),
        workload=workloads(opts)[wname],
        nemesis_package=pkg,
    )
    # partitions act on the DB's own peer forwarders
    t["net"] = d.net
    from ..control.local import LocalRemote

    t.setdefault("remote", LocalRemote())
    return t
