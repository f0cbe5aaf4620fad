"""Alternative SSH transport with an sshj-style auth ladder — the port's
copy of :mod:`jepsen_tpu.control.agent_ssh`.

The primary transport (:mod:`.ssh`) is key-only: ``BatchMode=yes``
refuses any interactive auth, so agent-forwarded identities and
password logins are out of reach.  This transport mirrors the
reference's experimental sshj remote (jepsen/src/jepsen/control/
sshj.clj:43-70 auth!), which tries, in order:

1. the explicitly configured private key (pinned via IdentitiesOnly),
2. the ssh-agent at ``agent_socket`` (IdentityAgent),
3. the default ~/.ssh identity files,
4. username + password.

Steps 1–3 ride normal ssh flags; step 4 uses an ``SSH_ASKPASS`` helper
(with ``SSH_ASKPASS_REQUIRE=force``) since the image has no sshpass.
The first rung that authenticates is remembered per connection so later
commands don't re-probe the whole ladder.

Unlike the JAX package's copy, this one reads no environment variable:
the agent's socket is the ``agent_socket`` argument (``from_test`` takes
``test["ssh"]["agent-socket"]``), and without one the agent rung is left
out (the default-identities rung still reaches the agent a child ``ssh``
finds in the environment it inherits).  The password rung's variables
reach ``ssh`` and ``scp`` through an ``env(1)`` prefix on their argv
(:func:`.ssh.env_prefix`), ``DISPLAY`` from the ``display`` argument.
"""

from __future__ import annotations

import os
import stat
import subprocess
import tempfile
from typing import List, Optional, Tuple

from .core import Command, Remote, Result, effective_stdin, wrap_sudo
from .ssh import _as_paths, env_prefix, run_scp

#: the DISPLAY the askpass rung gives ssh (some ssh builds demand one)
DEFAULT_DISPLAY = "none:0"


class AgentSSHRemote(Remote):
    """Subprocess-ssh remote that can authenticate via agent or
    password, not just a pinned key."""

    def __init__(
        self,
        username: str = "root",
        password: Optional[str] = None,
        port: int = 22,
        private_key_path: Optional[str] = None,
        strict_host_key_checking: bool = False,
        connect_timeout: int = 10,
        agent_socket: Optional[str] = None,
        display: str = DEFAULT_DISPLAY,
    ):
        self.username = username
        self.password = password
        self.port = port
        self.private_key_path = private_key_path
        self.strict = strict_host_key_checking
        self.connect_timeout = connect_timeout
        self.agent_socket = agent_socket
        self.display = display
        self.node: Optional[str] = None
        self._tmpdir: Optional[str] = None
        #: rungs of the auth ladder, tried lazily on first command
        self._auth: Optional[List[str]] = None

    @staticmethod
    def from_test(test: dict) -> "AgentSSHRemote":
        ssh = test.get("ssh", {})
        return AgentSSHRemote(
            username=ssh.get("username", "root"),
            password=ssh.get("password"),
            port=ssh.get("port", 22),
            private_key_path=ssh.get("private-key-path"),
            strict_host_key_checking=ssh.get("strict-host-key-checking", False),
            agent_socket=ssh.get("agent-socket"),
        )

    # -- auth ladder -------------------------------------------------------

    def _common_args(self) -> list:
        args = [
            "-p", str(self.port),
            "-o", f"ConnectTimeout={self.connect_timeout}",
        ]
        if not self.strict:
            args += [
                "-o", "StrictHostKeyChecking=no",
                "-o", "UserKnownHostsFile=/dev/null",
                "-o", "LogLevel=ERROR",
            ]
        return args

    def _askpass_script(self) -> str:
        """An SSH_ASKPASS helper that prints the password.  0600, inside
        this connection's private tmpdir."""
        path = os.path.join(self._tmpdir, "askpass.sh")
        if not os.path.exists(path):
            with open(path, "w") as f:
                f.write(f"#!/bin/sh\nprintf '%s' {_sh_quote(self.password)}\n")
            os.chmod(path, stat.S_IRUSR | stat.S_IWUSR | stat.S_IXUSR)
        return path

    def auth_rungs(self) -> List[Tuple[list, dict]]:
        """The (extra ssh args, extra env) ladder, most-specific first.
        (reference: sshj.clj:43-70 auth!)"""
        rungs: List[Tuple[list, dict]] = []
        if self.private_key_path:
            rungs.append(
                (
                    ["-o", "IdentitiesOnly=yes", "-i", self.private_key_path,
                     "-o", "BatchMode=yes"],
                    {},
                )
            )
        if self.agent_socket:
            rungs.append(
                (
                    ["-o", f"IdentityAgent={self.agent_socket}",
                     "-o", "BatchMode=yes"],
                    {},
                )
            )
        # default ~/.ssh identities
        rungs.append((["-o", "BatchMode=yes"], {}))
        if self.password is not None and self._tmpdir:
            rungs.append(
                (
                    ["-o", "PreferredAuthentications=password,"
                           "keyboard-interactive",
                     "-o", "NumberOfPasswordPrompts=1"],
                    {
                        "SSH_ASKPASS": self._askpass_script(),
                        "SSH_ASKPASS_REQUIRE": "force",
                        "DISPLAY": self.display,
                    },
                )
            )
        return rungs

    def _run_ssh(self, args: list, env: dict, cmd: str, stdin) -> subprocess.CompletedProcess:
        return subprocess.run(
            env_prefix(env) + ["ssh"] + self._common_args() + args
            + [f"{self.username}@{self.node}", cmd],
            input=stdin.encode() if stdin else None,
            capture_output=True,
            timeout=600,
        )

    def _authed(self) -> Tuple[list, dict]:
        """Probe the ladder once; remember the first rung that works."""
        if self._auth is not None:
            return self._auth
        last = None
        for args, env in self.auth_rungs():
            probe = self._run_ssh(args, env, "true", None)
            if probe.returncode == 0:
                self._auth = (args, env)
                return self._auth
            last = probe
        raise RuntimeError(
            f"every auth method failed for {self.username}@{self.node}: "
            + (last.stderr.decode(errors="replace") if last else "no rungs")
        )

    # -- Remote protocol ---------------------------------------------------

    def connect(self, node, test=None):
        r = AgentSSHRemote(
            self.username,
            self.password,
            self.port,
            self.private_key_path,
            self.strict,
            self.connect_timeout,
            self.agent_socket,
            self.display,
        )
        r.node = str(node)
        r._tmpdir = tempfile.mkdtemp(prefix="jepsen-assh-")
        return r

    def disconnect(self):
        if self._tmpdir:
            import shutil

            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None

    def execute(self, command: Command) -> Result:
        cmd = wrap_sudo(command)
        stdin = effective_stdin(command)
        args, env = self._authed()
        proc = self._run_ssh(args, env, cmd, stdin)
        return Result(
            cmd=cmd,
            exit=proc.returncode,
            out=proc.stdout.decode(errors="replace"),
            err=proc.stderr.decode(errors="replace"),
            node=self.node,
        )

    def upload(self, local_paths, remote_path):
        args, env = self._authed()
        run_scp(
            self._common_args() + args,
            _as_paths(local_paths),
            f"{self.username}@{self.node}:{remote_path}",
            env=env,
        )

    def download(self, remote_paths, local_path):
        args, env = self._authed()
        run_scp(
            self._common_args() + args,
            [f"{self.username}@{self.node}:{p}" for p in _as_paths(remote_paths)],
            str(local_path),
            env=env,
        )


def _sh_quote(s: Optional[str]) -> str:
    if s is None:
        return "''"
    return "'" + str(s).replace("'", "'\\''") + "'"
