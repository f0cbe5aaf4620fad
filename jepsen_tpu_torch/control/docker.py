"""Remote over ``docker exec`` — the port's copy of
:mod:`jepsen_tpu.control.docker` (reference:
jepsen/src/jepsen/control/docker.clj — resolve-container-id :14-30,
exec/upload/download via the docker CLI)."""

from __future__ import annotations

import subprocess
from typing import Optional

from .core import Command, Remote, Result, effective_stdin, wrap_sudo


class DockerRemote(Remote):
    def __init__(self, container_id: Optional[str] = None):
        self.container_id = container_id

    def connect(self, node, test=None):
        return DockerRemote(container_id=self._resolve(str(node)))

    @staticmethod
    def _resolve(node: str) -> str:
        """Accept a container name or id; resolve names via docker ps.
        (reference: control/docker.clj:14-30)"""
        proc = subprocess.run(
            ["docker", "ps", "-q", "-f", f"name={node}"],
            capture_output=True,
            timeout=30,
        )
        out = proc.stdout.decode().strip()
        return out.splitlines()[0] if out else node

    def execute(self, command: Command) -> Result:
        cmd = wrap_sudo(command)
        argv = ["docker", "exec"]
        stdin = effective_stdin(command)
        if stdin:
            argv.append("-i")
        argv += [self.container_id, "sh", "-c", cmd]
        proc = subprocess.run(
            argv,
            input=stdin.encode() if stdin else None,
            capture_output=True,
            timeout=600,
        )
        return Result(
            cmd=cmd,
            exit=proc.returncode,
            out=proc.stdout.decode(errors="replace"),
            err=proc.stderr.decode(errors="replace"),
            node=self.container_id,
        )

    def upload(self, local_paths, remote_path):
        paths = [local_paths] if isinstance(local_paths, str) else list(local_paths)
        for p in paths:
            subprocess.run(
                ["docker", "cp", str(p), f"{self.container_id}:{remote_path}"],
                check=True,
                timeout=600,
            )

    def download(self, remote_paths, local_path):
        paths = [remote_paths] if isinstance(remote_paths, str) else list(remote_paths)
        for p in paths:
            subprocess.run(
                ["docker", "cp", f"{self.container_id}:{p}", str(local_path)],
                check=True,
                timeout=600,
            )


def docker() -> DockerRemote:
    return DockerRemote()
