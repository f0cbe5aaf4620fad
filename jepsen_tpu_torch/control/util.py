"""Node-side helpers: daemons, downloads, archives, files, ports — the
port's copy of :mod:`jepsen_tpu.control.util`.

(reference: jepsen/src/jepsen/control/util.clj — exists?/file ops :14-110,
cached-wget! :167-198, install-archive! :199-260, grepkill! :286-309,
start-daemon! :310-368, stop-daemon! :369-385, daemon-running? :386-398,
signal! :399-403, await-tcp-port :14-30.)

``cached_wget`` and ``install_archive`` run ``wget``, ``tar`` and
``unzip`` on the node through the session's remote; nothing is fetched
on the control host.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from . import execute, su
from .core import RemoteError, escape, lit


def meh(thunk):
    """Run thunk, swallow exceptions, return result-or-None (the
    reference's `meh`)."""
    try:
        return thunk()
    except Exception:
        return None


def exists(path: str) -> bool:
    """(reference: control/util.clj exists?)"""
    try:
        execute("stat", path)
        return True
    except RemoteError:
        return False


def file_contents(path: str) -> str:
    return execute("cat", path)


def write_file(content: str, path: str) -> None:
    """Write a string to a remote file via stdin redirect.
    (reference: control/util.clj:88-110 write-file!)"""
    execute(lit(f"cat > {escape(path)}"), stdin=content)


def ls(path: str = ".") -> List[str]:
    out = execute("ls", "-1", path)
    return [l for l in out.splitlines() if l]


def ls_full(path: str) -> List[str]:
    """Fully-qualified paths of directory entries."""
    base = path if path.endswith("/") else path + "/"
    return [base + f for f in ls(path)]


def tmp_file(ext: str = "") -> str:
    return execute("mktemp", f"--suffix={ext}")


def tmp_dir() -> str:
    return execute("mktemp", "-d")


def await_tcp_port(port: int, host: str = "localhost", timeout_s: float = 60, interval_s: float = 0.5) -> None:
    """Block until a TCP port opens.
    (reference: control/util.clj:14-30)"""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            # /dev/tcp is a bash-ism; docker/k8s remotes run sh, so be
            # explicit about the shell
            execute(
                "bash", "-c",
                f"cat < /dev/null > /dev/tcp/{host}/{port}",
            )
            return
        except RemoteError:
            if time.monotonic() > deadline:
                raise
            time.sleep(interval_s)


def cached_wget(url: str, dest_dir: str = "/tmp/jepsen/wget", force: bool = False) -> str:
    """Download a URL once on the node; reuse the cached copy on later
    calls.  (reference: control/util.clj:167-198)"""
    name = url.rstrip("/").rsplit("/", 1)[-1]
    path = f"{dest_dir}/{name}"
    execute("mkdir", "-p", dest_dir)
    if force or not exists(path):
        execute("wget", "-O", path, url, check=True)
    return path


def install_archive(url: str, dest: str, force: bool = False) -> str:
    """Download (or copy file://) an archive on the node and expand it
    into dest, stripping the wrapper directory if there is exactly one.
    (reference: control/util.clj:199-260)"""
    local = cached_wget(url, force=force) if "://" in url and not url.startswith("file://") else url.replace("file://", "")
    with su():
        execute("rm", "-rf", dest)
        execute("mkdir", "-p", dest)
        if local.endswith(".zip"):
            execute("unzip", "-d", dest, local)
        else:
            execute("tar", "-xf", local, "-C", dest)
        entries = ls_full(dest)
        if len(entries) == 1:
            inner = entries[0]
            execute(
                lit(
                    f"mv {escape(inner)}/* {escape(dest)}/ && rmdir {escape(inner)}"
                )
            )
    return dest


def grepkill(pattern: str, signal: Any = 9) -> None:
    """Kill processes matching a pattern (grep/awk, avoiding our own
    sudo bash wrapper).  (reference: control/util.clj:286-309)"""
    try:
        execute(
            lit(
                f"ps aux | grep {escape(pattern)} | grep -v grep "
                f"| awk '{{print $2}}' "
                f"| xargs --no-run-if-empty kill -{signal}"
            )
        )
    except RemoteError as e:
        if "No such process" in e.result.err:
            return
        if e.result.exit in (0, 123):
            return
        raise


def start_daemon(opts: Dict[str, Any], bin: str, *args: Any) -> str:
    """Start a daemon under start-stop-daemon, logging to opts["logfile"].
    Returns "started" or "already-running".
    (reference: control/util.clj:310-368)"""
    from .core import env as env_tokens

    logfile = opts.get("logfile")
    ssd: List[Any] = ["start-stop-daemon", "--start"]
    if opts.get("background?", True):
        ssd += ["--background", "--no-close"]
    if opts.get("pidfile") and opts.get("make-pidfile?", True):
        ssd += ["--make-pidfile"]
    if opts.get("match-executable?", True):
        ssd += ["--exec", opts.get("exec", bin)]
    if opts.get("match-process-name?", False):
        ssd += ["--name", opts.get("process-name", bin.rsplit("/", 1)[-1])]
    if opts.get("pidfile"):
        ssd += ["--pidfile", opts["pidfile"]]
    if opts.get("chdir"):
        ssd += ["--chdir", opts["chdir"]]
    ssd += ["--startas", bin, "--", *args]

    if logfile:
        execute(
            lit(
                "echo \"`date +'%Y-%m-%d %H:%M:%S'` Jepsen starting "
                + escape(" ".join(str(a) for a in (bin,) + args))
                + f"\" >> {escape(logfile)}"
            )
        )
    tokens = env_tokens(opts.get("env")) + [escape(a) for a in ssd]
    cmd = " ".join(tokens)
    if logfile:
        cmd += f" >> {escape(logfile)} 2>&1"
    try:
        execute(lit(cmd))
        return "started"
    except RemoteError as e:
        if e.result.exit == 1:
            return "already-running"
        raise


def stop_daemon(pidfile: Optional[str] = None, cmd: Optional[str] = None) -> None:
    """Kill a daemon by pidfile and/or command name; remove the pidfile.
    (reference: control/util.clj:369-385)"""
    if cmd is not None:
        meh(lambda: execute("killall", "-9", "-w", cmd))
        if pidfile:
            meh(lambda: execute("rm", "-rf", pidfile))
        return
    if pidfile is not None and exists(pidfile):
        pid = execute("cat", pidfile).strip()
        if pid:
            meh(lambda: execute("kill", "-9", pid))
        meh(lambda: execute("rm", "-rf", pidfile))


def daemon_running(pidfile: str) -> Optional[bool]:
    """True if pidfile exists and its process is alive; None if no
    pidfile; False if stale.  (reference: control/util.clj:386-398)"""
    pid = meh(lambda: execute("cat", pidfile))
    if not pid:
        return None
    try:
        execute("ps", "-o", "pid=", "-p", pid.strip())
        return True
    except RemoteError:
        return False


def signal(process_name: str, sig: Any) -> str:
    """(reference: control/util.clj:399-403)"""
    meh(lambda: execute("pkill", "--signal", str(sig), process_name))
    return "signaled"
