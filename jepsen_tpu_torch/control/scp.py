"""SCP-subprocess file transfer decorator — the port's copy of
:mod:`jepsen_tpu.control.scp`.

Wraps a command-capable Remote, overriding upload/download to shell out
to the system ``scp`` binary — library transports can be orders of
magnitude slower than scp for multi-GB files.
(reference: jepsen/src/jepsen/control/scp.clj:1-144)

When the transfer must land somewhere only another user can write (the
command context carries sudo), files route through a root-owned tmp file
and are chown/mv'd into place, mirroring scp.clj:95-140.
"""

from __future__ import annotations

import os
import random
import subprocess
from typing import Any, Optional, Sequence, Union

from .core import (
    Command,
    Remote,
    RemoteError,
    Result,
    escape,
    lit,
    throw_on_nonzero_exit,
)

TMP_DIR = "/tmp/jepsen/scp"
"""Remote staging directory for sudo'd transfers (scp.clj:12-15)."""


class SCPRemote(Remote):
    """Delegates execute to ``cmd_remote``; upload/download use scp.
    (reference: control/scp.clj:80-140)"""

    def __init__(
        self,
        cmd_remote: Remote,
        username: str = "root",
        port: int = 22,
        private_key_path: Optional[str] = None,
        sudo: Optional[str] = None,
        strict_host_key_checking: bool = False,
    ):
        self.cmd_remote = cmd_remote
        self.username = username
        self.port = port
        self.private_key_path = private_key_path
        self.sudo = sudo
        self.strict = strict_host_key_checking
        self.node: Optional[str] = None
        self._tmp_dir_ready = False

    def connect(self, node, test=None):
        ssh = (test or {}).get("ssh", {})
        r = SCPRemote(
            self.cmd_remote.connect(node, test),
            username=ssh.get("username", self.username),
            port=ssh.get("port", self.port),
            private_key_path=ssh.get("private-key-path", self.private_key_path),
            sudo=self.sudo,
            strict_host_key_checking=ssh.get(
                "strict-host-key-checking", self.strict
            ),
        )
        r.node = str(node)
        return r

    def disconnect(self):
        self.cmd_remote.disconnect()

    def execute(self, command: Command) -> Result:
        return self.cmd_remote.execute(command)

    # -- scp plumbing ------------------------------------------------------

    def _scp(self, sources: Sequence[str], dest: str) -> None:
        """Run one scp subprocess (reference: scp.clj:59-70)."""
        args = ["scp", "-rpC", "-P", str(self.port)]
        if self.private_key_path:
            args += ["-i", self.private_key_path]
        if not self.strict:
            args += [
                "-o",
                "StrictHostKeyChecking=no",
                "-o",
                "UserKnownHostsFile=/dev/null",
                "-o",
                "LogLevel=ERROR",
            ]
        args += ["-o", "BatchMode=yes"]
        proc = subprocess.run(
            args + [str(s) for s in sources] + [dest],
            capture_output=True,
            timeout=3600,
        )
        if proc.returncode != 0:
            raise RemoteError(
                Result(
                    cmd=" ".join(args),
                    exit=proc.returncode,
                    err=proc.stderr.decode(errors="replace"),
                    node=self.node,
                ),
                f"scp to/from {self.node} failed: "
                f"{proc.stderr.decode(errors='replace')}",
            )

    def _remote_path(self, path: str) -> str:
        """user@host:path string (reference: scp.clj:72-79)."""
        assert self.node, "No node given for remote-path!"
        prefix = f"{self.username}@" if self.username else ""
        return f"{prefix}{self.node}:{path}"

    def _exec_root(self, *tokens: Any) -> Result:
        """Run a root command through the wrapped remote
        (reference: scp.clj:17-27)."""
        cmd = " ".join(escape(t) for t in tokens)
        return throw_on_nonzero_exit(
            self.cmd_remote.execute(Command(cmd=cmd, sudo="root"))
        )

    def _tmp_file(self) -> str:
        """A random remote staging path; ensures TMP_DIR exists once per
        connection (reference: scp.clj:29-56)."""
        if not self._tmp_dir_ready:
            self._exec_root(
                lit(f"mkdir -p {escape(TMP_DIR)} && chmod a+rwx {escape(TMP_DIR)}")
            )
            self._tmp_dir_ready = True
        return f"{TMP_DIR}/{random.randrange(2**31)}"

    def _cleanup(self, tmp: str) -> None:
        """Best-effort staging cleanup: a node that just got partitioned
        must not let the rm failure mask the transfer error in flight."""
        try:
            self._exec_root("rm", "-rf", tmp)
        except Exception:
            pass

    # -- operations --------------------------------------------------------

    def upload(self, local_paths: Union[str, Sequence[str]], remote_path: str) -> None:
        paths = (
            [local_paths]
            if isinstance(local_paths, (str, os.PathLike))
            else list(local_paths)
        )
        if self.sudo is None or self.sudo == self.username:
            self._scp(paths, self._remote_path(remote_path))
            return
        # Becoming another user: stage via tmpfile, chown, mv
        # (reference: scp.clj:100-110).  A directory dest keeps each
        # source's basename; a file dest can only take one source.
        import posixpath

        dest_is_dir = (
            self.cmd_remote.execute(
                Command(cmd=f"test -d {escape(remote_path)}", sudo="root")
            ).exit
            == 0
        )
        if not dest_is_dir and len(paths) > 1:
            raise ValueError(
                f"cannot upload {len(paths)} files to single path {remote_path!r}"
            )
        for src in paths:
            tmp = self._tmp_file()
            dest = (
                posixpath.join(remote_path, posixpath.basename(str(src).rstrip("/")))
                if dest_is_dir
                else remote_path
            )
            try:
                self._scp([src], self._remote_path(tmp))
                self._exec_root("chown", "-R", self.sudo, tmp)
                self._exec_root("mv", tmp, dest)
            finally:
                self._cleanup(tmp)

    def download(self, remote_paths: Union[str, Sequence[str]], local_path: str) -> None:
        paths = (
            [remote_paths]
            if isinstance(remote_paths, (str, os.PathLike))
            else list(remote_paths)
        )
        if self.sudo is None or self.sudo == self.username:
            self._scp([self._remote_path(p) for p in paths], str(local_path))
            return
        # Copy anything we can't read directly into a readable staging
        # dir first (reference: scp.clj:112-140 — but via cp -r, never a
        # hardlink: chowning a hardlink would mutate the source inode's
        # ownership on the node).
        import posixpath

        for src in paths:
            readable = (
                self.cmd_remote.execute(Command(cmd=f"head -c 1 {escape(src)}")).exit
                == 0
            )
            if readable:
                self._scp([self._remote_path(src)], str(local_path))
                continue
            tmp = self._tmp_file()
            staged = posixpath.join(tmp, posixpath.basename(str(src).rstrip("/")))
            try:
                self._exec_root("mkdir", "-p", tmp)
                self._exec_root("cp", "-r", src, staged)
                self._exec_root("chown", "-R", self.username, tmp)
                self._scp([self._remote_path(staged)], str(local_path))
            finally:
                self._cleanup(tmp)


def remote(cmd_remote: Remote, **kw) -> SCPRemote:
    """Wrap a command remote so transfers go over scp
    (reference: scp.clj:141-144)."""
    return SCPRemote(cmd_remote, **kw)
