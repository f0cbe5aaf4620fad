"""Network fault primitives — the port's copy of :mod:`jepsen_tpu.net`
(reference: jepsen/src/jepsen/net.clj).

The Net protocol (:15-26): drop!/heal!/slow!/flaky!/fast!, plus the
grudge-bulk drop-all! (:29-44, with the iptables fast path :101-111).
A *grudge* maps each node to the set of nodes it should drop traffic
FROM.  :class:`LoopbackProxyNet` cuts links between processes on one host
without iptables or root: the localkv suite routes every peer link
through it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from . import control
from .control.core import RemoteError, lit
from .util import real_pmap

TC = "/sbin/tc"


def node_ip(node: Any) -> str:
    """Resolve a node's IP.  On real clusters this shells out to
    getent/host (reference: control/net.clj); nodes that already look
    like IPs (or dummy nodes) pass through."""
    s = str(node)
    if all(c.isdigit() or c == "." for c in s) and s.count(".") == 3:
        return s
    try:
        out = control.execute("getent", "ahostsv4", s, check=True)
        first = out.split()
        return first[0] if first else s
    except Exception:
        return s


class Net:
    def drop(self, test: dict, src: Any, dest: Any) -> None:
        raise NotImplementedError

    def heal(self, test: dict) -> None:
        raise NotImplementedError

    def slow(self, test: dict, opts: Optional[dict] = None) -> None:
        raise NotImplementedError

    def flaky(self, test: dict) -> None:
        raise NotImplementedError

    def fast(self, test: dict) -> None:
        raise NotImplementedError

    # PartitionAll fast path (reference: net/proto.clj + net.clj:101-111)
    def drop_all(self, test: dict, grudge: Dict[Any, Iterable[Any]]) -> None:
        pairs = [
            (src, dst) for dst, srcs in grudge.items() for src in srcs
        ]
        real_pmap(lambda p: self.drop(test, p[0], p[1]), pairs)


class NoopNet(Net):
    """(reference: net.clj:48-56)"""

    def drop(self, test, src, dest):
        pass

    def heal(self, test):
        pass

    def slow(self, test, opts=None):
        pass

    def flaky(self, test):
        pass

    def fast(self, test):
        pass

    def drop_all(self, test, grudge):
        pass


noop = NoopNet()


class IPTables(Net):
    """Default iptables implementation (reference: net.clj:58-111)."""

    def drop(self, test, src, dest):
        def thunk():
            with control.su():
                control.execute(
                    "iptables", "-A", "INPUT", "-s", node_ip(src), "-j",
                    "DROP", "-w",
                )

        control.on_many([dest], thunk)

    def heal(self, test):
        def thunk():
            with control.su():
                control.execute("iptables", "-F", "-w")
                control.execute("iptables", "-X", "-w")

        control.with_test_nodes(test, thunk)

    def slow(self, test, opts=None):
        opts = opts or {}
        mean = opts.get("mean", 50)
        variance = opts.get("variance", 10)
        distribution = opts.get("distribution", "normal")

        def thunk():
            with control.su():
                control.execute(
                    TC, "qdisc", "add", "dev", "eth0", "root", "netem",
                    "delay", f"{mean}ms", f"{variance}ms", "distribution",
                    distribution,
                )

        control.with_test_nodes(test, thunk)

    def flaky(self, test):
        def thunk():
            with control.su():
                control.execute(
                    TC, "qdisc", "add", "dev", "eth0", "root", "netem",
                    "loss", "20%", "75%",
                )

        control.with_test_nodes(test, thunk)

    def fast(self, test):
        def thunk():
            with control.su():
                try:
                    control.execute(TC, "qdisc", "del", "dev", "eth0", "root")
                except RemoteError as e:
                    if "RTNETLINK answers: No such file or directory" in str(e):
                        return
                    raise

        control.with_test_nodes(test, thunk)

    def drop_all(self, test, grudge):
        # one iptables rule per node with a comma-joined source list
        # (reference: net.clj:101-111 PartitionAll fast path)
        def snub(test_, node):
            srcs = list(grudge.get(node) or [])
            if not srcs:
                return
            with control.su():
                control.execute(
                    "iptables", "-A", "INPUT", "-s",
                    ",".join(node_ip(s) for s in srcs), "-j", "DROP", "-w",
                )

        control.on_nodes(test, list(grudge.keys()), snub)


iptables = IPTables()


class IPFilter(Net):
    """ipf-based variant for SmartOS/illumos (reference: net.clj:113-145)."""

    def drop(self, test, src, dest):
        def thunk():
            with control.su():
                control.execute(
                    lit(f"echo block in from {node_ip(src)} to any | ipf -f -")
                )

        control.on_many([dest], thunk)

    def heal(self, test):
        def thunk():
            with control.su():
                control.execute("ipf", "-Fa")

        control.with_test_nodes(test, thunk)

    slow = IPTables.slow
    flaky = IPTables.flaky

    def fast(self, test):
        def thunk():
            with control.su():
                control.execute(TC, "qdisc", "del", "dev", "eth0", "root")

        control.with_test_nodes(test, thunk)


ipfilter = IPFilter()


def drop_all(test: dict, grudge: Dict[Any, Iterable[Any]]) -> None:
    """Apply a grudge via the test's net.  (reference: net.clj:29-44)"""
    net = test.get("net", iptables)
    net.drop_all(test, grudge)


def heal(test: dict) -> None:
    net = test.get("net", iptables)
    net.heal(test)


class LoopbackProxyNet(Net):
    """Real connection-severing partitions on one host, no
    iptables/root: every (src, dst) node edge gets a localhost TCP
    forwarder; dropping the edge kills its live connections (clients
    see genuine resets, not polite errors) and refuses new ones until
    healed.  The loopback analogue of the iptables Net for integration
    tests and CI (reference behavior contract: net.clj:15-44 — drop!
    blocks src→dst traffic, heal! restores everything).

    Routes are registered up front with :meth:`add_route`; clients on
    node ``src`` talking to the service on node ``dst`` must connect to
    ``port(src, dst)``.
    """

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._routes: Dict[tuple, "_Forwarder"] = {}

    def add_route(self, src: Any, dst: Any, target_host: str,
                  target_port: int) -> int:
        """Start a forwarder for the src→dst edge; returns its port."""
        fwd = _Forwarder(target_host, target_port)
        with self._lock:
            self._routes[(src, dst)] = fwd
        return fwd.port

    def port(self, src: Any, dst: Any) -> int:
        return self._routes[(src, dst)].port

    def close(self) -> None:
        with self._lock:
            for fwd in self._routes.values():
                fwd.close()

    def reset(self) -> None:
        """Close and forget every forwarder so add_route can wire the
        same Net instance afresh (a DB cycle tears down, then sets up
        again — the test map's net reference must stay valid across
        that)."""
        self.close()
        with self._lock:
            self._routes.clear()

    def drop(self, test, src, dest):
        fwd = self._routes.get((src, dest))
        if fwd is not None:
            fwd.block()

    def heal(self, test):
        for fwd in self._routes.values():
            fwd.unblock()

    def slow(self, test, opts=None):
        # mean is in MILLISECONDS, matching the tc-backed Net impls
        # (IPTables.slow default mean=50 → "50ms")
        delay_ms = float((opts or {}).get("mean", 50))
        for fwd in self._routes.values():
            fwd.delay = delay_ms / 1000.0

    def flaky(self, test):
        for fwd in self._routes.values():
            fwd.loss = 0.2

    def fast(self, test):
        for fwd in self._routes.values():
            fwd.delay = 0.0
            fwd.loss = 0.0


class _Forwarder:
    """One TCP forwarder: accept on a loopback port, pump bytes to the
    target; blocking kills live connections and refuses new ones."""

    def __init__(self, target_host: str, target_port: int):
        import socket
        import threading

        self.target = (target_host, target_port)
        self.blocked = False
        self.delay = 0.0
        self.loss = 0.0
        self._conns: list = []
        self._lock = threading.Lock()
        self._accept_done = threading.Event()
        self._listener = self._listen(0)
        self.port = self._listener.getsockname()[1]
        self._closed = False
        self._start_accepting()

    def _listen(self, port: int):
        import socket
        import time as _time

        # the previous accept thread closes its listener asynchronously
        # (see _accept_loop); tolerate a brief EADDRINUSE window when
        # rebinding the same port
        deadline = _time.monotonic() + 2.0
        while True:
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("127.0.0.1", port))
                s.listen(32)
                return s
            except OSError:
                s.close()
                if _time.monotonic() > deadline:
                    raise
                _time.sleep(0.01)

    def _start_accepting(self):
        import threading

        self._accept_done.clear()
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        import socket
        import threading

        listener = self._listener
        try:
            while not (self._closed or self.blocked):
                try:
                    client, _addr = listener.accept()
                except OSError:
                    break  # block()/close() shut the listener down
                if self.blocked or self._closed:
                    # woken by block()'s self-connect poke on platforms
                    # where shutdown() on a listener is ENOTCONN
                    # (BSD/macOS)
                    client.close()
                    break
                try:
                    upstream = socket.create_connection(
                        self.target, timeout=5
                    )
                except OSError:
                    client.close()
                    continue
                with self._lock:
                    self._conns.append((client, upstream))
                for a, b in ((client, upstream), (upstream, client)):
                    threading.Thread(
                        target=self._pump, args=(a, b), daemon=True
                    ).start()
        finally:
            # the accept thread owns the fd: closing it from another
            # thread while accept() blocks on it races in-process fd
            # reuse
            try:
                listener.close()
            except OSError:
                pass
            self._accept_done.set()

    def _pump(self, src, dst):
        import random as _random
        import time as _time

        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                if self.blocked:
                    break
                if self.delay:
                    _time.sleep(self.delay)
                if self.loss and _random.random() < self.loss:
                    # the proxy terminates TCP, so silently dropping
                    # bytes would CORRUPT the stream (they were already
                    # ACKed to the sender) — flakiness at this layer
                    # means the connection dies, which clients see as a
                    # clean reset/indeterminate op
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.close()
                except OSError:
                    pass

    def block(self):
        import socket

        # lock-free fault flag: pump threads poll it per recv; the
        # store is atomic under the GIL and one extra forwarded chunk
        # is acceptable
        self.blocked = True  # lock-free fault flag (see above)
        # shut the listener down so NEW connection attempts are refused
        # outright (a definite, safe failure for clients) rather than
        # accepted-then-reset (which reads as an indeterminate cut).
        # shutdown — not close — wakes the accept thread, which then
        # closes the fd it owns.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            # BSD/macOS: shutdown on a listener is ENOTCONN; poke the
            # accept loop awake with a throwaway connection instead
            try:
                socket.create_connection(
                    ("127.0.0.1", self.port), timeout=1
                ).close()
            except OSError:
                pass
        self._accept_done.wait(timeout=2)
        with self._lock:
            conns, self._conns = self._conns, []
        for a, b in conns:
            for s in (a, b):
                try:
                    s.close()  # live connections die mid-flight
                except OSError:
                    pass

    def unblock(self):
        # block/unblock/close all run on the nemesis control thread;
        # `blocked` is additionally polled lock-free by pump threads
        # (see block) and `_listener` is handed to the accept thread
        # only via _start_accepting, AFTER _accept_done ordered the
        # old accept loop's exit
        if not self.blocked or self._closed:
            self.blocked = False  # control-thread flag (see above)
            return
        self.blocked = False  # control-thread flag (see above)
        self._listener = self._listen(self.port)  # published via _start_accepting thread start
        self._start_accepting()

    def close(self):
        import socket

        # only the control thread reads `_closed` (unblock)
        self._closed = True  # control-thread flag, atomic store
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.block()
        self.blocked = False  # control-thread flag (see unblock)
