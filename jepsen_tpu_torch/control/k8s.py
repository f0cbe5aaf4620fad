"""Remote over ``kubectl exec`` — the port's copy of
:mod:`jepsen_tpu.control.k8s` (reference:
jepsen/src/jepsen/control/k8s.clj — exec :15-40, cp-based transfer)."""

from __future__ import annotations

import subprocess
from typing import Optional

from .core import Command, Remote, Result, effective_stdin, wrap_sudo


class K8sRemote(Remote):
    def __init__(self, namespace: str = "default", pod: Optional[str] = None):
        self.namespace = namespace
        self.pod = pod

    def connect(self, node, test=None):
        return K8sRemote(self.namespace, pod=str(node))

    def execute(self, command: Command) -> Result:
        cmd = wrap_sudo(command)
        argv = ["kubectl", "exec", "-n", self.namespace]
        stdin = effective_stdin(command)
        if stdin:
            argv.append("-i")
        argv += [self.pod, "--", "sh", "-c", cmd]
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
            node=self.pod,
        )

    def upload(self, local_paths, remote_path):
        paths = [local_paths] if isinstance(local_paths, str) else list(local_paths)
        for p in paths:
            subprocess.run(
                [
                    "kubectl", "cp", "-n", self.namespace, str(p),
                    f"{self.pod}:{remote_path}",
                ],
                check=True,
                timeout=600,
            )

    def download(self, remote_paths, local_path):
        paths = [remote_paths] if isinstance(remote_paths, str) else list(remote_paths)
        for p in paths:
            subprocess.run(
                [
                    "kubectl", "cp", "-n", self.namespace,
                    f"{self.pod}:{p}", str(local_path),
                ],
                check=True,
                timeout=600,
            )


def k8s(namespace: str = "default") -> K8sRemote:
    return K8sRemote(namespace)
