"""Local remote: run "remote" commands as subprocesses on the control
host itself — the port's copy of :mod:`jepsen_tpu.control.local`.
Useful for single-machine tests and for the full control stack (daemon
helpers, net command paths) without SSH; the localkv suite runs its
replicas through it.  No reference equivalent in Jepsen — its closest
mode is :dummy? (control.clj:40), which performs no IO at all.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

from .core import Command, Remote, Result, effective_stdin, wrap_sudo


class LocalRemote(Remote):
    def __init__(self, node=None):
        self.node = node

    def connect(self, node, test=None):
        return LocalRemote(node)

    def execute(self, command: Command) -> Result:
        cmd = wrap_sudo(command)
        stdin = effective_stdin(command)
        proc = subprocess.run(
            ["bash", "-c", cmd],
            input=stdin.encode() if stdin else None,
            capture_output=True,
            timeout=600,
        )
        return Result(
            cmd=cmd,
            exit=proc.returncode,
            out=proc.stdout.decode(errors="replace"),
            err=proc.stderr.decode(errors="replace"),
            node=self.node,
        )

    def upload(self, local_paths, remote_path):
        paths = [local_paths] if isinstance(local_paths, str) else list(local_paths)
        for p in paths:
            shutil.copy(str(p), remote_path)

    def download(self, remote_paths, local_path):
        paths = [remote_paths] if isinstance(remote_paths, str) else list(remote_paths)
        for p in paths:
            shutil.copy(str(p), str(local_path))


def local() -> LocalRemote:
    return LocalRemote()
