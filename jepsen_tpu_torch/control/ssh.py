"""SSH remote via the system ssh/scp binaries — the port's copy of
:mod:`jepsen_tpu.control.ssh`.

Replaces the reference's JSch/SSHJ library transports
(jepsen/src/jepsen/control/clj_ssh.clj, sshj.clj) with subprocess ssh
using ControlMaster connection sharing for session reuse, and scp for
file transfer (control/scp.clj).
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Any, Optional, Sequence, Union

from .core import Command, Remote, Result, effective_stdin, wrap_sudo


def _as_paths(paths) -> list:
    """Normalize one-or-many path arguments to a list of strings."""
    if isinstance(paths, (str, os.PathLike)):
        return [str(paths)]
    return [str(p) for p in paths]


def env_prefix(env: Optional[dict]) -> list:
    """``env(1)``'s argv prefix that sets ``env``'s variables for one
    child (``[]`` for none): the child inherits this process's
    environment with them added, and this process reads none of it."""
    if not env:
        return []
    return ["env"] + [f"{k}={v}" for k, v in env.items()]


def run_scp(ssh_args: list, sources: list, dest: str, env=None) -> None:
    """Run one scp transfer with ssh-style args (the ``-p`` port flag is
    rewritten to scp's ``-P``); raises RuntimeError on failure.  Shared
    by both SSH transports so fixes land in one place.  ``env`` holds
    variables to add to scp's environment (:func:`env_prefix`)."""
    args = list(ssh_args)
    try:
        i = args.index("-p")
        args[i] = "-P"
    except ValueError:
        pass
    proc = subprocess.run(
        env_prefix(env) + ["scp", "-r"] + args + list(sources) + [dest],
        capture_output=True,
        timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"scp to {dest} failed: {proc.stderr.decode(errors='replace')}"
        )


class SSHRemote(Remote):
    """One connected SSH session per node, multiplexed over a
    ControlMaster socket so repeated execs don't re-handshake."""

    def __init__(
        self,
        username: str = "root",
        port: int = 22,
        private_key_path: Optional[str] = None,
        strict_host_key_checking: bool = False,
        connect_timeout: int = 10,
    ):
        # Key-based auth only: BatchMode=yes forbids password prompts.
        # sudo passwords flow through the command DSL (control.sudo),
        # not the transport.
        self.username = username
        self.port = port
        self.private_key_path = private_key_path
        self.strict = strict_host_key_checking
        self.connect_timeout = connect_timeout
        self.node: Optional[str] = None
        self._control_dir: Optional[str] = None

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_test(test: dict) -> "SSHRemote":
        ssh = test.get("ssh", {})
        return SSHRemote(
            username=ssh.get("username", "root"),
            port=ssh.get("port", 22),
            private_key_path=ssh.get("private-key-path"),
            strict_host_key_checking=ssh.get("strict-host-key-checking", False),
        )

    def _base_args(self) -> list:
        args = [
            "-p",
            str(self.port),
            "-o",
            f"ConnectTimeout={self.connect_timeout}",
            "-o",
            "BatchMode=yes",
        ]
        if not self.strict:
            args += [
                "-o",
                "StrictHostKeyChecking=no",
                "-o",
                "UserKnownHostsFile=/dev/null",
                "-o",
                "LogLevel=ERROR",
            ]
        if self.private_key_path:
            args += ["-i", self.private_key_path]
        if self._control_dir:
            args += [
                "-o",
                "ControlMaster=auto",
                "-o",
                f"ControlPath={self._control_dir}/%r@%h:%p",
                "-o",
                "ControlPersist=60",
            ]
        return args

    def connect(self, node, test=None):
        r = SSHRemote(
            self.username,
            self.port,
            self.private_key_path,
            self.strict,
            self.connect_timeout,
        )
        r.node = str(node)
        r._control_dir = tempfile.mkdtemp(prefix="jepsen-ssh-")
        return r

    def disconnect(self):
        if self._control_dir and self.node:
            subprocess.run(
                ["ssh"]
                + self._base_args()
                + ["-O", "exit", f"{self.username}@{self.node}"],
                capture_output=True,
                timeout=10,
            )
            import shutil

            shutil.rmtree(self._control_dir, ignore_errors=True)
            self._control_dir = None

    # -- operations --------------------------------------------------------

    def execute(self, command: Command) -> Result:
        import time as _time

        from .. import obs

        cmd = wrap_sudo(command)
        stdin = effective_stdin(command)
        t0 = _time.perf_counter()
        proc = subprocess.run(
            ["ssh"] + self._base_args() + [f"{self.username}@{self.node}", cmd],
            input=stdin.encode() if stdin else None,
            capture_output=True,
            timeout=600,
        )
        # transport-level latency (vs jepsen_control_exec_seconds at the
        # session seam, which also covers dummy/docker/k8s remotes)
        obs.observe(
            "jepsen_ssh_exec_seconds", _time.perf_counter() - t0,
            node=str(self.node),
        )
        return Result(
            cmd=cmd,
            exit=proc.returncode,
            out=proc.stdout.decode(errors="replace"),
            err=proc.stderr.decode(errors="replace"),
            node=self.node,
        )

    def upload(self, local_paths, remote_path):
        run_scp(
            self._base_args(),
            _as_paths(local_paths),
            f"{self.username}@{self.node}:{remote_path}",
        )

    def download(self, remote_paths, local_path):
        run_scp(
            self._base_args(),
            [f"{self.username}@{self.node}:{p}" for p in _as_paths(remote_paths)],
            str(local_path),
        )


def ssh(test: Optional[dict] = None) -> SSHRemote:
    """The default SSH remote (reference: control.clj:35-37)."""
    return SSHRemote.from_test(test or {})
