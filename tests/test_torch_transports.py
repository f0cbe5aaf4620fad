"""The control transports on the port — ``control.ssh``, ``control.scp``,
``control.agent_ssh``, ``control.docker``, ``control.k8s``,
``control.retry`` and ``reconnect`` (``jepsen_tpu_torch``) — against the
JAX package's, on the CPU.

- **Transports.**  Each remote runs the same script in both packages —
  plain commands, ``cd``, sudo with its password on standard input, a
  non-zero exit, an argument with spaces, standard input, and the upload
  and download of a file and of a list — through the PATH shims of
  ``tests/fake_transports.py``: the shims' argv logs (their
  per-connection directories normalised), the standard input they read,
  the ``Result``s and the files moved are equal.  The agent-ssh remote
  climbs its auth ladder against a shim that takes only the password.
- **Retry and reconnect.**  A remote that fails N times and then
  succeeds, and a connection that breaks, give the same call sequences,
  reconnects and final raises in both packages; two threads share one
  ``reconnect.Wrapper``.
- **The reference's own assertions** on the ported code
  (``tests/test_control.py``, ``tests/test_codec_k8s.py``,
  ``tests/test_parity_extras.py``), the agent rung given as an argument
  where the reference reads ``SSH_AUTH_SOCK``.
- **The CLI.**  ``--ssh-transport ssh|agent-ssh`` builds the reference's
  remote with its options, ``--dummy`` wins, and a suite's own default
  remote does not replace the CLI's; ``cli test --suite localkv
  --ssh-transport ssh --faults kill`` runs valid through the shims, every
  thread it starts ended when it returns.
"""

import dataclasses
import getpass
import importlib
import json
import os
import random
import shutil
import subprocess
import threading

import pytest

from fake_transports import PROGRAMS, normalise, read_log, write_shims
from test_torch_localkv import needs_cluster, own_threads  # noqa: F401

ROOTS = {"ref": "jepsen_tpu", "port": "jepsen_tpu_torch"}
#: the variables the reference's agent-ssh transport reads
AGENT_VARS = ("SSH_AUTH_SOCK", "DISPLAY", "SSH_ASKPASS",
              "SSH_ASKPASS_REQUIRE")


def mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


@pytest.fixture
def shims(tmp_path, monkeypatch):
    """``install(log_name, auth=None)``: write the shims (and ``sudo``'s)
    into one directory ahead of ``PATH``, logging to ``log_name`` under
    the test's directory; returns the log's path."""
    for k in AGENT_VARS:
        monkeypatch.delenv(k, raising=False)
    bin_dir = str(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")

    def install(log_name, auth=None):
        log = str(tmp_path / log_name)
        write_shims(bin_dir, log, PROGRAMS + ("sudo",), auth=auth)
        return log

    return install


# ---------------------------------------------------------------------------
# the transports, each through its shim
# ---------------------------------------------------------------------------


def _ssh(pkg):
    return mod(pkg, "control.ssh").SSHRemote(
        username="u", port=2222, private_key_path="/k/id")


#: transport → (prototype remote of a package, shim auth)
TRANSPORTS = {
    "ssh": (_ssh, None),
    "agent-ssh": (lambda pkg: mod(pkg, "control.agent_ssh").AgentSSHRemote(
        username="u", password="pw", port=2222), {"password": "pw"}),
    "docker": (lambda pkg: mod(pkg, "control.docker").DockerRemote(), None),
    "k8s": (lambda pkg: mod(pkg, "control.k8s").K8sRemote("jepsen"), None),
    "scp": (lambda pkg: mod(pkg, "control.scp").remote(
        _ssh(pkg), username="u", port=2222), None),
    # staged through the sudo'd copy (to this host's own user, whom the
    # chown always accepts)
    "scp-sudo": (lambda pkg: mod(pkg, "control.scp").remote(
        _ssh(pkg), username="u", port=2222, sudo=getpass.getuser()), None),
}


def _script(pkg, remote, work):
    """The same calls on a connected remote: what each returned (a
    ``Result`` as a dict, or the class and message of what it raised)."""
    core = mod(pkg, "control.core")
    calls = [
        ("execute", core.Command(cmd="echo hello")),
        ("execute", core.Command(cmd="pwd", dir=str(work))),
        ("execute", core.Command(cmd="cat", sudo="root", sudo_password="pw",
                                 stdin="secret input\n")),
        ("execute", core.Command(cmd="echo no; exit 3")),
        ("execute", core.Command(
            cmd="printf '<%s>' " + core.escape("a b  c") + " x")),
        ("execute", core.Command(cmd="cat", stdin="line one\nline two\n")),
        ("upload", str(work / "one.txt"), str(work / "remote" / "a.txt")),
        ("upload", [str(work / "one.txt"), str(work / "two.txt")],
         str(work / "remote")),
        ("download", str(work / "remote" / "a.txt"), str(work / "back")),
        ("download", [str(work / "remote" / "one.txt"),
                      str(work / "remote" / "two.txt")],
         str(work / "back")),
    ]
    out = []
    for name, *args in calls:
        try:
            r = getattr(remote, name)(*args)
            out.append(dataclasses.asdict(r) if r is not None else None)
        except Exception as e:  # noqa: BLE001 — compared by class
            out.append(("raised", type(e).__name__, str(e)))
    return out


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f)).read()
            for d, _, fs in os.walk(root) for f in fs}


def _run_transport(pkg, name, install, tmp_path, monkeypatch):
    make, auth = TRANSPORTS[name]
    log = install(f"{name}-{pkg}.jsonl", auth)
    work = tmp_path / "work"
    shutil.rmtree(work, ignore_errors=True)
    (work / "remote").mkdir(parents=True)
    (work / "back").mkdir()
    (work / "one.txt").write_text("first file\n")
    (work / "two.txt").write_text("second file\n")
    # scp's sudo staging directory and name (the module `random`'s)
    monkeypatch.setattr(mod(pkg, "control.scp"), "TMP_DIR",
                        str(tmp_path / "staging"))
    random.seed(2020)
    session = make(pkg).connect("n1", {})
    try:
        results = _script(pkg, session, work)
    finally:
        session.disconnect()
    return (normalise(results), normalise(read_log(log)),
            _files(str(work)))


@pytest.mark.parametrize("name", sorted(TRANSPORTS))
def test_each_transport_runs_as_the_reference(name, shims, tmp_path,
                                              monkeypatch):
    ref = _run_transport("ref", name, shims, tmp_path, monkeypatch)
    port = _run_transport("port", name, shims, tmp_path, monkeypatch)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    results, log, files = port
    # what the script asked for happened on the "node"
    assert results[0]["out"] == "hello\n" and results[0]["exit"] == 0
    assert results[1]["out"] == f"{tmp_path / 'work'}\n"
    assert results[2]["out"] == "secret input\n"
    assert results[3]["exit"] == 3 and results[3]["out"] == "no\n"
    assert results[4]["out"] == "<a b  c><x>"
    assert results[5]["out"] == "line one\nline two\n"
    assert files["remote/a.txt"] == files["back/a.txt"] == "first file\n"
    assert files["back/two.txt"] == "second file\n"
    stdins = [e["stdin"] for e in log if e["prog"] != "sudo"]
    assert "pw\nsecret input\n" in stdins
    assert "line one\nline two\n" in stdins
    sudo = [e for e in log if e["prog"] == "sudo"]
    assert sudo and sudo[0]["argv"][:4] == ["-k", "-S", "-u", "root"]
    if name in ("ssh", "scp", "scp-sudo"):
        ssh = [e["argv"] for e in log if e["prog"] == "ssh"]
        assert all("ControlMaster=auto" in a for a in ssh)
        assert sum(a[-3:-1] == ["-O", "exit"] for a in ssh) == 1
    if name == "agent-ssh":
        # the default identities were refused, the password taken
        probes = [e for e in log if e["argv"][-1] == "true"]
        assert [bool(e["env"]) for e in probes] == [False, True]
        assert probes[1]["env"]["SSH_ASKPASS_REQUIRE"] == "force"
        assert probes[1]["env"]["DISPLAY"] == "none:0"
    if name == "scp-sudo":
        staged = [e for e in log if e["prog"] == "scp"
                  and str(tmp_path / "staging") in e["argv"][-1]]
        assert len(staged) == 3  # the file and each of the list's two


@pytest.mark.parametrize("auth", [{"identity": "/k/other"},
                                  {"agent": "/run/agent.sock"}])
def test_a_ladder_with_no_working_rung_raises_as_the_reference(
        auth, shims, tmp_path):
    out = {}
    for pkg in ROOTS:
        log = shims(f"fail-{pkg}.jsonl", auth)
        r = mod(pkg, "control.agent_ssh").AgentSSHRemote(
            username="u", private_key_path="/k/id").connect("n1")
        try:
            with pytest.raises(RuntimeError) as e:
                r.execute(mod(pkg, "control.core").Command(cmd="true"))
        finally:
            r.disconnect()
        out[pkg] = (str(e.value), normalise(read_log(log)))
    assert out["port"] == out["ref"]
    assert "every auth method failed for u@n1" in out["port"][0]
    assert len(out["port"][1]) == 2  # the key, then the default identities


@pytest.mark.parametrize("display", [None, ":7"])
def test_the_ladders_are_equal_rung_for_rung(display, tmp_path,
                                             monkeypatch):
    """The reference given its agent through ``SSH_AUTH_SOCK`` (and
    ``DISPLAY``), the port the same through its arguments."""
    monkeypatch.setenv("SSH_AUTH_SOCK", "/run/agent.sock")
    if display is None:
        monkeypatch.delenv("DISPLAY", raising=False)
    else:
        monkeypatch.setenv("DISPLAY", display)
    kw = dict(username="u", password="it's", private_key_path="/k/id",
              port=2222)
    ref = mod("ref", "control.agent_ssh").AgentSSHRemote(**kw)
    port = mod("port", "control.agent_ssh").AgentSSHRemote(
        **kw, agent_socket="/run/agent.sock",
        **({} if display is None else {"display": display}))
    rungs = {}
    for pkg, r in (("ref", ref), ("port", port)):
        r.node = "n1"
        r._tmpdir = str(tmp_path / pkg)
        os.makedirs(r._tmpdir)
        rungs[pkg] = [(args, {k: v.replace(r._tmpdir, "TMP")
                              for k, v in env.items()})
                      for args, env in r.auth_rungs()]
    assert rungs["port"] == rungs["ref"]
    assert len(rungs["port"]) == 4
    assert rungs["port"][3][1]["DISPLAY"] == (display or "none:0")
    assert rungs["port"][0][0] == [
        "-o", "IdentitiesOnly=yes", "-i", "/k/id", "-o", "BatchMode=yes"]
    # the askpass scripts print the same password
    assert (tmp_path / "port" / "askpass.sh").read_text() == \
        (tmp_path / "ref" / "askpass.sh").read_text()
    out = subprocess.run([str(tmp_path / "port" / "askpass.sh")],
                         capture_output=True, timeout=30).stdout
    assert out == b"it's"


def test_the_port_reads_no_agent_from_the_environment(monkeypatch,
                                                      tmp_path):
    monkeypatch.setenv("SSH_AUTH_SOCK", "/run/agent.sock")
    monkeypatch.setenv("DISPLAY", ":9")
    r = mod("port", "control.agent_ssh").AgentSSHRemote(password="pw")
    r._tmpdir = str(tmp_path)
    rungs = r.auth_rungs()
    assert [args for args, _ in rungs] == [
        ["-o", "BatchMode=yes"],
        ["-o", "PreferredAuthentications=password,keyboard-interactive",
         "-o", "NumberOfPasswordPrompts=1"]]
    assert rungs[1][1]["DISPLAY"] == "none:0"
    ssh = {"ssh": {"username": "u", "agent-socket": "/a.sock"}}
    assert mod("port", "control.agent_ssh").AgentSSHRemote.from_test(
        ssh).agent_socket == "/a.sock"


def test_the_env_prefix_adds_variables_without_reading_any():
    ssh = mod("port", "control.ssh")
    assert ssh.env_prefix(None) == [] and ssh.env_prefix({}) == []
    assert ssh.env_prefix({"A": "1", "B": "x y"}) == ["env", "A=1", "B=x y"]
    out = subprocess.run(ssh.env_prefix({"JT_PROBE": "a b"}) + [
        "sh", "-c", 'printf %s "$JT_PROBE"'], capture_output=True,
        timeout=30).stdout
    assert out == b"a b"


# ---------------------------------------------------------------------------
# retry and reconnect
# ---------------------------------------------------------------------------


def _flaky(pkg, calls, fails):
    """A remote of ``pkg`` that records every call into ``calls`` and
    raises ``OSError`` while ``fails[kind]`` is positive."""
    core = mod(pkg, "control.core")

    class Flaky(core.Remote):
        def __init__(self, node=None):
            self.node = node

        def _call(self, kind, *args):
            calls.append((kind, self.node) + args)
            if fails.get(kind, 0) > 0:
                fails[kind] -= 1
                raise OSError(f"{kind} reset")

        def connect(self, node, test=None):
            self._call("connect", node)
            return Flaky(node)

        def disconnect(self):
            self._call("disconnect")

        def execute(self, command):
            self._call("execute", command.cmd)
            if command.cmd == "false":
                raise core.RemoteError(core.Result(cmd="false", exit=1,
                                                   node=self.node))
            return core.Result(cmd=command.cmd, out="ok", node=self.node)

        def upload(self, local_paths, remote_path):
            self._call("upload", remote_path)

        def download(self, remote_paths, local_path):
            self._call("download", local_path)

    return Flaky()


RETRY_CASES = {
    "execute-fails-twice": ({"execute": 2}, ["ls"]),
    "connect-fails-twice": ({"connect": 2}, ["ls"]),
    "connect-fails-for-good": ({"connect": 9}, ["ls"]),
    "execute-fails-for-good": ({"execute": 9}, ["ls"]),
    "reconnects-fail-too": ({"execute": 2, "disconnect": 1, "connect": 0},
                            ["ls", "ls"]),
    "command-failure-not-retried": ({}, ["false", "ls"]),
    "transfers": ({"upload": 1, "download": 3}, ["up", "down"]),
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_retry_remote_as_the_reference(case, caplog):
    out = {}
    for pkg in ROOTS:
        fails, script = RETRY_CASES[case]
        fails, calls, got = dict(fails), [], []
        core = mod(pkg, "control.core")
        retry = mod(pkg, "control.retry")
        proto = retry.retry(_flaky(pkg, calls, fails), retries=4, backoff=0)
        caplog.clear()
        try:
            conn = proto.connect("n1", {"nodes": ["n1"]})
            for cmd in script:
                try:
                    if cmd == "up":
                        got.append(conn.upload(["a"], "/r"))
                    elif cmd == "down":
                        got.append(conn.download(["/r"], "/l"))
                    else:
                        r = conn.execute(core.Command(cmd=cmd))
                        got.append(dataclasses.asdict(r))
                except Exception as e:  # noqa: BLE001
                    got.append(("raised", type(e).__name__))
            conn.disconnect()
        except Exception as e:  # noqa: BLE001
            got.append(("connect raised", type(e).__name__, str(e)))
        warnings = [r.getMessage() for r in caplog.records
                    if r.name.endswith("control.retry")]
        out[pkg] = (calls, got, warnings)
    assert out["port"] == out["ref"]
    assert mod("port", "control.retry").log.name == \
        "jepsen_tpu_torch.control.retry"
    assert (mod("port", "control.retry").RETRIES,
            mod("port", "control.retry").BACKOFF_SECONDS) == (
        mod("ref", "control.retry").RETRIES,
        mod("ref", "control.retry").BACKOFF_SECONDS)


def _wrapper_run(pkg, fail_on, retries):
    events, n = [], {"open": 0, "calls": 0}

    def open_fn():
        n["open"] += 1
        events.append(("open", n["open"]))
        if n["open"] in fail_on.get("open", ()):
            raise OSError("open failed")
        return n["open"]

    def close_fn(conn):
        events.append(("close", conn))

    def body(conn):
        n["calls"] += 1
        events.append(("call", conn, n["calls"]))
        if n["calls"] in fail_on.get("call", ()):
            raise OSError("broken")
        return conn * 10

    w = mod(pkg, "reconnect").wrapper(open_fn, close_fn, name="db")
    got = []
    for step in ("open", "with_conn", "with_conn", "reopen", "with_conn",
                 "close", "with_conn", "close", "close"):
        try:
            if step == "open":
                got.append(w.open() is w)
            elif step == "with_conn":
                got.append(w.with_conn(body, retries=retries))
            else:
                got.append(getattr(w, step)())
        except Exception as e:  # noqa: BLE001
            got.append(("raised", type(e).__name__, str(e)))
    return events, got


@pytest.mark.parametrize("fail_on,retries", [
    ({}, 1),
    ({"call": (1,)}, 1),
    ({"call": (1, 2)}, 1),
    ({"call": (1, 2)}, 2),
    ({"call": (2,), "open": (3,)}, 1),
    ({"open": (1,)}, 0),
])
def test_reconnect_wrapper_as_the_reference(fail_on, retries):
    ref = _wrapper_run("ref", fail_on, retries)
    port = _wrapper_run("port", fail_on, retries)
    assert port == ref
    assert ref[1][0] == (("raised", "OSError", "open failed")
                         if 1 in fail_on.get("open", ()) else True)


def test_two_threads_share_one_wrapper():
    out = {}
    for pkg in ROOTS:
        opened, closed, lock = [], [], threading.Lock()

        def open_fn():
            with lock:
                opened.append(len(opened) + 1)
                return opened[-1]

        w = mod(pkg, "reconnect").Wrapper(open_fn, closed.append)
        failures = {"left": 3}
        results = []

        def body(conn):
            with lock:
                if failures["left"] > 0:
                    failures["left"] -= 1
                    raise OSError("broken")
            return conn

        def worker():
            for _ in range(50):
                results.append(w.with_conn(body, retries=5))

        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        w.close()
        out[pkg] = (len(results), len(opened), len(closed),
                    set(results) <= set(opened))
    assert out["port"] == out["ref"] == (100, 4, 4, True)


# ---------------------------------------------------------------------------
# the reference's own assertions on the ported code
# ---------------------------------------------------------------------------


def test_retry_remote_reconnects():
    from jepsen_tpu_torch.control.core import Command, DummyRemote, Result
    from jepsen_tpu_torch.control.retry import RetryRemote

    class FlakyRemote(DummyRemote):
        def __init__(self, fail_times=2, state=None):
            super().__init__()
            self.state = state if state is not None else {"fails": fail_times}

        def connect(self, node, test=None):
            r = FlakyRemote(state=self.state)
            r.node = node
            return r

        def execute(self, command):
            if self.state["fails"] > 0:
                self.state["fails"] -= 1
                raise OSError("connection reset")
            return Result(cmd=command.cmd, exit=0, out="ok", node=self.node)

    remote = RetryRemote(FlakyRemote(), backoff=0.001)
    conn = remote.connect("n1")
    res = conn.execute(Command(cmd="ls"))
    assert res.out == "ok"


def test_retry_remote_does_not_mask_command_failure():
    from jepsen_tpu_torch.control.core import (Command, DummyRemote,
                                               RemoteError, Result)
    from jepsen_tpu_torch.control.retry import RetryRemote

    class FailingRemote(DummyRemote):
        def connect(self, node, test=None):
            r = FailingRemote()
            r.node = node
            return r

        def execute(self, command):
            raise RemoteError(Result(cmd=command.cmd, exit=7, node=self.node))

    conn = RetryRemote(FailingRemote(), backoff=0.001).connect("n1")
    with pytest.raises(RemoteError):
        conn.execute(Command(cmd="false"))


class _ScpSpy:
    """Collects scp subprocess invocations in place of subprocess.run."""

    def __init__(self):
        self.calls = []

    def __call__(self, args, capture_output=True, timeout=None):
        self.calls.append(args)
        import types

        return types.SimpleNamespace(returncode=0, stdout=b"", stderr=b"")


def test_scp_remote_direct_transfer(monkeypatch):
    from jepsen_tpu_torch.control import scp as cscp
    from jepsen_tpu_torch.control.core import Command, DummyRemote

    spy = _ScpSpy()
    monkeypatch.setattr(cscp.subprocess, "run", spy)
    inner = DummyRemote()
    r = cscp.remote(inner, username="admin", port=2222).connect("n1", {})
    r.upload("/local/a.tar", "/remote/a.tar")
    r.download(["/var/log/db.log"], "/tmp/out")
    up, down = spy.calls
    assert up[:4] == ["scp", "-rpC", "-P", "2222"]
    assert up[-2:] == ["/local/a.tar", "admin@n1:/remote/a.tar"]
    assert down[-2:] == ["admin@n1:/var/log/db.log", "/tmp/out"]
    # execute still goes through the wrapped remote
    r.execute(Command(cmd="hostname"))
    assert any(
        isinstance(e, tuple) and getattr(e[1], "cmd", None) == "hostname"
        for e in inner.log
    )


def test_scp_remote_sudo_stages_via_tmpfile(monkeypatch):
    from jepsen_tpu_torch.control import scp as cscp
    from jepsen_tpu_torch.control.core import DummyRemote

    spy = _ScpSpy()
    monkeypatch.setattr(cscp.subprocess, "run", spy)
    inner = DummyRemote()
    r = cscp.remote(inner, username="admin", sudo="postgres").connect("n2", {})
    r.upload("/local/conf", "/etc/db")
    # one scp into the staging dir, then chown + mv as root over the
    # command remote (reference: control/scp.clj:100-110).  The dummy
    # remote answers exit 0 to the `test -d` probe, so the dest counts
    # as a directory and the source keeps its basename.
    (up,) = spy.calls
    assert up[-1].startswith("admin@n2:" + cscp.TMP_DIR)
    cmds = [getattr(e[1], "cmd", "") for e in inner.log if isinstance(e, tuple)]
    assert any(c.startswith("chown -R postgres") for c in cmds)
    assert any(c.startswith("mv ") and c.endswith("/etc/db/conf") for c in cmds)


@pytest.fixture
def fake_kubectl(shims):
    return shims("kubectl.jsonl")


def test_k8s_execute_and_stdin(fake_kubectl):
    from jepsen_tpu_torch.control.core import Command
    from jepsen_tpu_torch.control.k8s import k8s

    session = k8s(namespace="jepsen").connect("pod1")
    r = session.execute(Command(cmd="echo hello"))
    assert r.exit == 0 and r.out.strip() == "hello"
    assert r.node == "pod1"
    # argv carried the namespace and pod
    logged = [" ".join(e["argv"]) for e in read_log(fake_kubectl)]
    assert any("-n jepsen" in a and "pod1 -- sh -c" in a for a in logged)
    # stdin adds -i and reaches the command
    r = session.execute(Command(cmd="cat", stdin="via-stdin"))
    assert "via-stdin" in r.out
    assert any("exec -n jepsen -i pod1" in " ".join(e["argv"])
               for e in read_log(fake_kubectl))
    # nonzero exits propagate without raising
    assert session.execute(Command(cmd="false")).exit != 0


def test_k8s_upload_download(fake_kubectl, tmp_path):
    from jepsen_tpu_torch.control.k8s import K8sRemote

    session = K8sRemote().connect("pod1")
    src = tmp_path / "up.txt"
    src.write_text("payload")
    dest = tmp_path / "landed.txt"
    session.upload([str(src)], str(dest))
    assert dest.read_text() == "payload"
    back = tmp_path / "back.txt"
    session.download([str(dest)], str(back))
    assert back.read_text() == "payload"


def test_agent_ssh_auth_ladder_order(tmp_path):
    from jepsen_tpu_torch.control.agent_ssh import AgentSSHRemote

    r = AgentSSHRemote(
        username="u", password="pw", private_key_path="/k/id", port=2222,
        agent_socket="/tmp/fake-agent.sock",
    )
    r.node = "n1"
    r._tmpdir = str(tmp_path)
    rungs = r.auth_rungs()
    # key first, then agent, then default identities, then password
    assert len(rungs) == 4
    assert "/k/id" in rungs[0][0] and "IdentitiesOnly=yes" in rungs[0][0]
    assert any("IdentityAgent=" in a for a in rungs[1][0])
    assert rungs[2][0] == ["-o", "BatchMode=yes"]
    args, env = rungs[3]
    assert "SSH_ASKPASS" in env and env["SSH_ASKPASS_REQUIRE"] == "force"
    script = open(env["SSH_ASKPASS"]).read()
    assert "pw" in script
    assert os.stat(env["SSH_ASKPASS"]).st_mode & 0o077 == 0  # private

    # without agent/key/password: only the default-identities rung
    r2 = AgentSSHRemote(username="u")
    r2._tmpdir = str(tmp_path)
    assert len(r2.auth_rungs()) == 1


def test_agent_ssh_remembers_first_working_rung(monkeypatch):
    from jepsen_tpu_torch.control.agent_ssh import AgentSSHRemote

    r = AgentSSHRemote(username="u", private_key_path="/k/id")
    r.node = "n1"
    r._tmpdir = "/tmp"
    calls = []

    class FakeProc:
        def __init__(self, rc):
            self.returncode = rc
            self.stdout = b""
            self.stderr = b"denied"

    def fake_run(args, env, cmd, stdin):
        calls.append((tuple(args), cmd))
        # first rung (pinned key) fails; second (default ids) works
        return FakeProc(255 if "IdentitiesOnly=yes" in args else 0)

    monkeypatch.setattr(r, "_run_ssh", fake_run)
    args, env = r._authed()
    assert "IdentitiesOnly=yes" not in args
    n = len(calls)
    # subsequent auth lookups don't re-probe
    assert r._authed() == (args, env)
    assert len(calls) == n


def test_cli_ssh_transport_flag():
    import argparse

    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.control.agent_ssh import AgentSSHRemote
    from jepsen_tpu_torch.control.core import DummyRemote as DR
    from jepsen_tpu_torch.control.ssh import SSHRemote

    def build(argv):
        p = argparse.ArgumentParser()
        cli.add_test_opts(p)
        return cli.test_opts_to_map(p.parse_args(argv))

    t = build(["--nodes", "n1", "--ssh-transport", "agent-ssh",
               "--password", "pw"])
    assert isinstance(t["remote"], AgentSSHRemote)
    assert t["remote"].password == "pw"
    t2 = build(["--nodes", "n1", "--ssh-transport", "ssh"])
    assert isinstance(t2["remote"], SSHRemote)
    t3 = build(["--nodes", "n1", "--dummy"])
    assert isinstance(t3["remote"], DR)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli_map(pkg, argv):
    import argparse

    cli = mod(pkg, "cli")
    p = argparse.ArgumentParser()
    cli.add_test_opts(p)
    args = p.parse_args(argv)
    return cli, args, cli.test_opts_to_map(args)


CLI_CASES = {
    "ssh": ["--ssh-transport", "ssh"],
    "ssh-key": ["--ssh-transport", "ssh", "--username", "admin",
                "--ssh-private-key", "/k/id"],
    "agent-ssh": ["--ssh-transport", "agent-ssh", "--password", "pw",
                  "--username", "admin"],
    "agent-ssh-key": ["--ssh-transport", "agent-ssh", "--ssh-private-key",
                      "/k/id"],
    "dummy-wins": ["--ssh-transport", "ssh", "--dummy"],
    "none": [],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_the_cli_builds_the_references_remote(case):
    argv = ["--nodes", "n1,n2"] + CLI_CASES[case]
    out = {}
    for pkg in ROOTS:
        _, _, t = _cli_map(pkg, argv)
        r = t.get("remote")
        attrs = {k: v for k, v in vars(r).items()
                 if k not in ("agent_socket", "display")} if r else None
        out[pkg] = (type(r).__name__, attrs, t["ssh"])
        if pkg == "port" and type(r).__name__ == "AgentSSHRemote":
            assert (r.agent_socket, r.display) == (None, "none:0")
    assert out["port"] == out["ref"]
    assert out["port"][0] == {
        "ssh": "SSHRemote", "ssh-key": "SSHRemote",
        "agent-ssh": "AgentSSHRemote", "agent-ssh-key": "AgentSSHRemote",
        "dummy-wins": "DummyRemote", "none": "NoneType"}[case]


@pytest.mark.parametrize("transport", [None, "ssh", "agent-ssh"])
def test_a_suites_default_remote_does_not_replace_the_clis(transport,
                                                           tmp_path):
    """localkv sets its ``LocalRemote`` only where the CLI gave no
    remote, in both packages (``common.build_test`` carries the CLI's)."""
    argv = ["--nodes", "n1,n2,n3"] + (
        ["--ssh-transport", transport] if transport else [])
    names = {}
    for pkg in ROOTS:
        cli, args, base = _cli_map(pkg, argv)
        opts = {**cli.given_opts(args), **base, "dir": str(tmp_path)}
        if pkg == "port":
            opts["device"] = "cpu"
        t = mod(pkg, "suites").suite("localkv").test(opts)
        names[pkg] = type(t["remote"]).__name__
        if transport:
            assert t["remote"] is base["remote"]
    assert names["port"] == names["ref"] == {
        None: "LocalRemote", "ssh": "SSHRemote",
        "agent-ssh": "AgentSSHRemote"}[transport]


@needs_cluster
def test_the_cli_runs_localkv_over_the_ssh_transport(shims, tmp_path,
                                                     own_threads):
    from jepsen_tpu_torch import cli

    log = shims("localkv.jsonl")
    nodes_dir = tmp_path / "nodes"
    store = str(tmp_path / "store")
    argv = ["test", "--suite", "localkv", "--ssh-transport", "ssh",
            "--faults", "kill", "--nodes", "n1,n2,n3", "--time-limit", "3",
            "--concurrency", "6", "--rate", "30", "-o", "interval=1", "-o",
            f"dir={nodes_dir}", "--store-base", store, "--device", "cpu"]
    try:
        code = cli.run_cli(cli.default_commands(), argv)
    finally:
        subprocess.run(["pkill", "-9", "-f", str(nodes_dir)],
                       capture_output=True, timeout=30)
    (run_dir,) = [d for d in os.listdir(os.path.join(store, "localkv"))
                  if d != "latest"]
    with open(os.path.join(store, "localkv", run_dir, "results.json")) as f:
        results = json.load(f)
    assert code == cli.EXIT_VALID, results.get("valid?")
    assert results["valid?"] is True
    assert results["workload"]["valid?"] is True
    entries = read_log(log)
    ssh = [e["argv"] for e in entries if e["prog"] == "ssh"]
    scp = [e["argv"] for e in entries if e["prog"] == "scp"]
    # every node's commands, each over its connection's ControlMaster
    for n in ("n1", "n2", "n3"):
        assert any(f"root@{n}" in a for a in ssh), n
        assert any(a[-1].startswith(f"root@{n}:") for a in scp), n
    paths = {o for a in ssh for o in a if o.startswith("ControlPath=")}
    assert all("ControlMaster=auto" in a for a in ssh)
    exits = [a for a in ssh if a[-3:-1] == ["-O", "exit"]]
    # one -O exit a connection, each with its own ControlMaster directory
    assert sorted(o for a in exits for o in a
                  if o.startswith("ControlPath=")) == sorted(paths)
    assert any("g++" in a[-1] for a in ssh)
    assert not os.path.exists(nodes_dir / "n1")
