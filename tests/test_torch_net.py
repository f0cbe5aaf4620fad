"""The port's control helpers, network faults and partitioners
(``jepsen_tpu_torch.control.util``, ``control.local``, ``net``, the
nemesis ``Partitioner`` family) against the JAX package's.

- On a recording remote (each package's ``DummyRemote``), the commands
  that ``IPTables``, ``IPFilter``, the partitioners and ``control.util``
  emit equal the reference's, node by node, with their sudo user, stdin
  and working directory; the nemeses' answers equal too.  The cases are
  ``tests/test_control.py``'s and ``tests/test_nemesis.py``'s (``:79``
  on), the random partitions from one generator seed in both packages.
- ``LoopbackProxyNet`` really cuts a TCP route on this host: a live
  connection dies, new ones are refused until it heals, and it forwards
  again after ``heal``; ``slow`` delays and ``fast`` restores.
- ``LocalRemote`` runs commands and moves files on this host, as the
  reference's does.
"""

import socket
import threading
import time

import pytest

from jepsen_tpu import control as ref_control
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import nemesis as ref_nemesis
from jepsen_tpu import net as ref_net
from jepsen_tpu.control import local as ref_local
from jepsen_tpu.control import util as ref_cu
from jepsen_tpu_torch import control, generator as gen, nemesis, net
from jepsen_tpu_torch.control import local
from jepsen_tpu_torch.control import util as cu

NODES = ["n1", "n2", "n3", "n4", "n5"]
JOIN_S = 10


def _recorded(log):
    """Each node's commands, in the order it ran them (nodes run
    concurrently, so only the order within a node is fixed)."""
    by_node = {}
    for node, c in log:
        if isinstance(c, tuple):
            entry = c
        else:
            entry = (c.cmd, c.sudo, c.stdin, c.dir, c.sudo_password)
        by_node.setdefault(node, []).append(entry)
    return by_node


def both(fn, nodes=NODES, seed=45100, **test_kw):
    """``fn(pkg, test)`` under each package's recording remote; returns
    ``(port answer, port commands), (reference answer, reference
    commands)`` with both generators seeded alike."""
    out = []
    for pkg in ("port", "ref"):
        c = control if pkg == "port" else ref_control
        nt = net if pkg == "port" else ref_net
        (gen if pkg == "port" else ref_gen).set_seed(seed)
        test = {"name": "nettest", "nodes": list(nodes), "net": nt.iptables,
                **test_kw}
        if pkg == "ref" and "net" in test_kw:
            test["net"] = getattr(ref_net, test_kw["net"].__class__.__name__
                                  .lower())
        remote = c.DummyRemote()
        with c.with_session(test, remote):
            answer = fn(pkg, test)
        out.append((answer, _recorded(remote.log)))
    return out


def _mods(pkg):
    if pkg == "port":
        return control, net, nemesis, cu
    return ref_control, ref_net, ref_nemesis, ref_cu


# ---------------------------------------------------------------------------
# net: iptables and ipfilter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,action", [
    (impl, action) for impl in ("iptables", "ipfilter")
    for action in ("drop", "heal", "slow", "slow-opts", "flaky", "fast")
] + [("iptables", "drop_all")])
def test_net_commands_equal_the_reference(impl, action):
    def run(pkg, test):
        _, nt, _, _ = _mods(pkg)
        n = getattr(nt, impl)
        if action == "drop":
            n.drop(test, "n2", "n1")
        elif action == "heal":
            n.heal(test)
        elif action == "slow":
            n.slow(test)
        elif action == "slow-opts":
            n.slow(test, {"mean": 120, "variance": 7,
                          "distribution": "pareto"})
        elif action == "flaky":
            n.flaky(test)
        elif action == "fast":
            n.fast(test)
        else:
            nt.drop_all({**test, "net": n},
                        {"n1": {"n2", "n3"}, "n2": set(), "n4": ["n5"]})

    (_, port), (_, ref) = both(run)
    assert port == ref and port


def test_ipfilter_drop_all_is_per_edge_in_both():
    def run(pkg, test):
        _, nt, _, _ = _mods(pkg)
        nt.ipfilter.drop_all(test, {"n1": ["n2", "n3"], "n4": ["n5"]})

    (_, port), (_, ref) = both(run)
    assert {k: sorted(v) for k, v in port.items()} == \
        {k: sorted(v) for k, v in ref.items()}
    # one ``getent`` resolving the source, then one ``ipf`` rule, per edge
    assert sum(1 for v in port.values() for c in v if "ipf -f -" in c[0]) \
        == 3


def test_drop_all_and_heal_follow_the_test_net():
    def run(pkg, test):
        _, nt, _, _ = _mods(pkg)
        nt.drop_all(test, {"n3": ["n1"]})
        nt.heal(test)

    (_, port), (_, ref) = both(run)
    assert port == ref
    assert any("iptables -A INPUT -s n1 -j DROP -w" in c[0]
               for c in port["n3"])
    assert all(any("iptables -F -w" in c[0] for c in port[n]) for n in NODES)


def test_the_noop_net_emits_nothing():
    def run(pkg, test):
        _, nt, _, _ = _mods(pkg)
        nt.noop.drop(test, "n1", "n2")
        nt.noop.drop_all(test, {"n1": ["n2"]})
        nt.noop.heal(test)

    (_, port), (_, ref) = both(run)
    assert port == ref == {}


# ---------------------------------------------------------------------------
# the partitioners
# ---------------------------------------------------------------------------


def _run_nemesis(make, ops):
    def run(pkg, test):
        _, _, nm, _ = _mods(pkg)
        nem = make(nm).setup(test)
        answers = [nem.invoke(test, dict(op)) for op in ops]
        nem.teardown(test)
        return answers

    return both(run)


START = {"f": "start", "value": None, "process": "nemesis", "time": 0}
STOP = {"f": "stop", "value": None, "process": "nemesis", "time": 1}


@pytest.mark.parametrize("make", [
    lambda nm: nm.partition_halves(),
    lambda nm: nm.partition_random_halves(),
    lambda nm: nm.partition_random_node(),
    lambda nm: nm.partition_majorities_ring(),
], ids=["halves", "random-halves", "random-node", "majorities-ring"])
@pytest.mark.parametrize("seed", [45100, 7])
def test_partitioners_equal_the_reference(make, seed):
    ops = [START, STOP, {**START, "time": 2}]

    def run(pkg, test):
        (gen if pkg == "port" else ref_gen).set_seed(seed)
        _, _, nm, _ = _mods(pkg)
        nem = make(nm).setup(test)
        answers = [nem.invoke(test, dict(op)) for op in ops]
        nem.teardown(test)
        return answers

    (port_ans, port), (ref_ans, ref) = both(run, seed=seed)
    assert port_ans == ref_ans
    assert port_ans[0]["value"][0] == "isolated"
    assert port_ans[1]["value"] == "network-healed"
    assert port == ref
    drops = [c for cmds in port.values() for c in cmds
             if "iptables -A INPUT -s" in c[0] and "DROP" in c[0]]
    assert drops and all(c[1] == "root" for c in drops)


def test_partitioner_with_an_explicit_grudge_equals_the_reference():
    (port_ans, port), (ref_ans, ref) = _run_nemesis(
        lambda nm: nm.partitioner(),
        [{**START, "value": {"n1": {"n2"}, "n3": ["n4", "n5"]}}, STOP])
    assert port_ans == ref_ans and port == ref
    assert port_ans[0]["value"] == ["isolated", {"n1": ["n2"],
                                                 "n3": ["n4", "n5"]}]


def test_partitioner_without_a_grudge_raises_in_both():
    for nm in (nemesis, ref_nemesis):
        with pytest.raises(ValueError, match="grudge"):
            nm.partitioner().invoke({"nodes": NODES}, dict(START))
        with pytest.raises(ValueError):
            nm.partition_halves().invoke({"nodes": NODES},
                                         {"f": "zap", "value": None})
    assert nemesis.partition_halves().fs() == {"start", "stop"}


def test_f_mapped_partitioner_equals_the_reference():
    (port_ans, port), (ref_ans, ref) = _run_nemesis(
        lambda nm: nm.f_map(lambda f: f"net-{f}", nm.partition_halves()),
        [{**START, "f": "net-start"}, {**STOP, "f": "net-stop"}])
    assert port_ans == ref_ans and port == ref
    assert port_ans[0]["f"] == "net-start"


# ---------------------------------------------------------------------------
# control.util and the command DSL
# ---------------------------------------------------------------------------


DAEMON_OPTS = [
    {"logfile": "/var/log/db.log", "pidfile": "/var/run/db.pid",
     "chdir": "/opt/db"},
    {"logfile": "/var/log/db.log", "pidfile": "/var/run/db.pid",
     "chdir": "/opt/db", "match-executable?": False,
     "env": {"B": "two words", "A": 1}},
    {"background?": False, "match-process-name?": True,
     "process-name": "dbd", "make-pidfile?": False,
     "pidfile": "/run/x.pid"},
    {},
]


@pytest.mark.parametrize("opts", DAEMON_OPTS)
def test_start_daemon_equals_the_reference(opts):
    def run(pkg, test):
        c, _, _, u = _mods(pkg)
        return c.on_many(["n1"], lambda: u.start_daemon(
            opts, "/opt/db/bin/db", "--port", 5000, "a b"))

    (port_ans, port), (ref_ans, ref) = both(run)
    assert port_ans == ref_ans == {"n1": "started"}
    assert port == ref
    assert any("start-stop-daemon" in cmd[0] for cmd in port["n1"])


def test_control_util_helpers_equal_the_reference():
    def run(pkg, test):
        c, _, _, u = _mods(pkg)

        def thunk():
            out = [u.exists("/etc/motd"),
                   u.daemon_running("/var/run/db.pid"),
                   u.signal("dbd", "HUP"),
                   u.meh(lambda: 1 / 0)]
            u.write_file("hello\n", "/etc/motd")
            u.await_tcp_port(5000, host="127.0.0.1", timeout_s=1)
            u.stop_daemon(pidfile="/var/run/db.pid", cmd="db")
            u.stop_daemon(pidfile="/var/run/db.pid")
            u.grepkill("dbproc")
            u.grepkill("/opt/db/n1/db", "STOP")
            with c.su():
                with c.cd("/opt/db"):
                    c.execute("ls", "-l", "a b")
                    c.upload("/tmp/x", "/opt/db/x")
            with c.trace():
                c.exec_("echo", "traced")
            return out

        return c.on_many(["n1", "n2"], thunk)

    (port_ans, port), (ref_ans, ref) = both(run)
    assert port_ans == ref_ans
    assert port == ref
    cmds = [c[0] for c in port["n1"]]
    assert "cat > /etc/motd" in cmds and port["n1"][cmds.index(
        "cat > /etc/motd")][2] == "hello\n"
    assert any("killall -9 -w db" in c for c in cmds)
    assert any("xargs --no-run-if-empty kill -STOP" in c for c in cmds)
    assert ("ls -l 'a b'", "root", None, "/opt/db", None) in port["n1"]


def test_su_and_cd_bindings_convey_into_on_nodes():
    def run(pkg, test):
        c, _, _, _ = _mods(pkg)
        with c.su(), c.cd("/srv"):
            c.on_nodes(test, lambda t, node: c.execute("whoami"))

    (_, port), (_, ref) = both(run, nodes=["n1", "n2"])
    assert port == ref == {n: [("whoami", "root", None, "/srv", None)]
                           for n in ("n1", "n2")}


def test_sudo_password_and_env_tokens_equal_the_reference():
    from jepsen_tpu.control import core as ref_core
    from jepsen_tpu_torch.control import core

    for mod in (core, ref_core):
        c = mod.Command(cmd="ls", sudo="root", sudo_password="pw",
                        stdin="data", dir="/d")
        assert mod.effective_stdin(c) == "pw\ndata"
    args = dict(cmd="ls -l", sudo="bob", dir="/o p")
    assert core.wrap_sudo(core.Command(**args)) == \
        ref_core.wrap_sudo(ref_core.Command(**args))
    env = {"PATH": "/a b", "X": 1}
    assert core.env(env) == ref_core.env(env)
    assert core.env(None) == ref_core.env(None) == []


# ---------------------------------------------------------------------------
# real processes and sockets on this host
# ---------------------------------------------------------------------------


def test_local_remote_runs_commands_and_moves_files(tmp_path):
    src = tmp_path / "src.txt"
    src.write_text("payload\n")
    test = {"nodes": ["n1"]}
    answers = []
    for c, remote, d in ((control, local.LocalRemote(), "port"),
                         (ref_control, ref_local.LocalRemote(), "ref")):
        dest = tmp_path / d
        dest.mkdir()

        def thunk(c=c, dest=dest):
            c.upload(str(src), str(dest / "up.txt"))
            c.download(str(dest / "up.txt"), str(dest / "down.txt"))
            with c.cd(str(dest)):
                out = c.execute("cat", "up.txt")
            err = None
            try:
                c.execute("false")
            except Exception as e:  # noqa: BLE001 — compared below
                err = type(e).__name__
            return out, err, c.execute("cat", stdin="from stdin")

        with c.with_session(test, remote):
            answers.append(c.on_many(["n1"], thunk))
        assert (dest / "down.txt").read_text() == "payload\n"
    assert answers[0] == answers[1] == {
        "n1": ("payload", "RemoteError", "from stdin")}


class _Echo:
    """A TCP echo server on a free loopback port."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self.threads = []
        self.thread = threading.Thread(target=self._accept)
        self.thread.start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._echo, args=(conn,))
            self.threads.append(t)
            t.start()

    @staticmethod
    def _echo(conn):
        with conn:
            while True:
                try:
                    data = conn.recv(4096)
                except OSError:
                    return
                if not data:
                    return
                conn.sendall(data)

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        self.thread.join(JOIN_S)
        for t in self.threads:
            t.join(JOIN_S)
        assert not self.thread.is_alive()
        assert not any(t.is_alive() for t in self.threads)


def _roundtrip(port, payload=b"ping"):
    with socket.create_connection(("127.0.0.1", port), timeout=2) as s:
        s.sendall(payload)
        return s.recv(64)


def test_loopback_proxy_net_cuts_and_heals_a_tcp_route():
    echo = _Echo()
    pn = net.LoopbackProxyNet()
    try:
        port = pn.add_route("n1", "n2", "127.0.0.1", echo.port)
        assert pn.port("n1", "n2") == port
        assert _roundtrip(port) == b"ping"
        live = socket.create_connection(("127.0.0.1", port), timeout=2)
        live.sendall(b"a")
        assert live.recv(8) == b"a"
        pn.drop({}, "n1", "n2")
        # the live connection dies mid-flight
        live.settimeout(2)
        try:
            live.sendall(b"b")
            assert live.recv(8) == b""
        except OSError:
            pass
        live.close()
        # new connections are refused outright while the route is cut
        with pytest.raises(OSError):
            _roundtrip(port)
        pn.drop({}, "n2", "n1")  # an unknown edge is ignored
        pn.heal({})
        deadline = time.monotonic() + JOIN_S
        while True:
            try:
                assert _roundtrip(port, b"again") == b"again"
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.05)
        pn.slow({}, {"mean": 150})
        t0 = time.monotonic()
        assert _roundtrip(port, b"slow") == b"slow"
        assert time.monotonic() - t0 >= 0.25  # 150 ms each way
        pn.fast({})
        t0 = time.monotonic()
        assert _roundtrip(port, b"fast") == b"fast"
        assert time.monotonic() - t0 < 0.25
        pn.flaky({})
        assert all(f.loss == 0.2 for f in pn._routes.values())
        pn.fast({})
        # reset frees the forwarders; the same Net wires afresh
        pn.reset()
        with pytest.raises(OSError):
            _roundtrip(port)
        port2 = pn.add_route("n1", "n2", "127.0.0.1", echo.port)
        assert _roundtrip(port2) == b"ping"
    finally:
        pn.close()
        echo.close()
