"""Remote protocol, shell escaping, sudo wrapping.

(reference: jepsen/src/jepsen/control/core.clj — Remote protocol :7-58,
lit :62-66, escape :67-110, env :112-140, wrap-sudo :142-153,
throw-on-nonzero-exit :155-171.)
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union


class Lit:
    """A literal string, passed to the shell unescaped.
    (reference: control/core.clj:62-66)"""

    __slots__ = ("s",)

    def __init__(self, s: str):
        self.s = s

    def __str__(self):
        return self.s

    def __repr__(self):
        return f"lit({self.s!r})"


def lit(s: str) -> Lit:
    return Lit(s)


_SAFE = re.compile(r"^[a-zA-Z0-9_+./:=@%^,-]+$")


def escape(arg: Any) -> str:
    """Escape one shell token.  Sequences flatten to space-joined escaped
    tokens; Lits pass through.  (reference: control/core.clj:67-110)"""
    if isinstance(arg, Lit):
        return arg.s
    if isinstance(arg, (list, tuple)):
        return " ".join(escape(a) for a in arg)
    if isinstance(arg, bool):
        return "true" if arg else "false"
    s = str(arg)
    if s == "":
        return "''"
    if _SAFE.match(s):
        return s
    return "'" + s.replace("'", "'\\''") + "'"


def env(env_map: Optional[Dict[str, Any]]) -> List[str]:
    """k=v tokens for an environment prefix.
    (reference: control/core.clj:112-140)"""
    if not env_map:
        return []
    return [f"{k}={escape(v)}" for k, v in sorted(env_map.items())]


@dataclass
class Command:
    """An action to run on a remote node."""

    cmd: str
    stdin: Optional[str] = None
    sudo: Optional[str] = None
    dir: Optional[str] = None
    sudo_password: Optional[str] = None


def wrap_sudo(command: Command) -> str:
    """Wrap a command string in sudo -u / cd as needed.
    (reference: control/core.clj:142-153)"""
    cmd = command.cmd
    if command.dir:
        cmd = f"cd {escape(command.dir)}; {cmd}"
    if command.sudo:
        cmd = f"sudo -k -S -u {escape(command.sudo)} bash -c {escape(cmd)}"
    return cmd


def effective_stdin(command: Command) -> Optional[str]:
    """The stdin a transport should feed: sudo -S reads the password from
    the first stdin line, so prepend it ahead of any command stdin
    (reference semantics: control/core.clj:142-153 feeds *password*)."""
    if command.sudo and command.sudo_password is not None:
        return command.sudo_password + "\n" + (command.stdin or "")
    return command.stdin


@dataclass
class Result:
    cmd: str
    exit: int = 0
    out: str = ""
    err: str = ""
    node: Any = None


class RemoteError(Exception):
    def __init__(self, result: Result, msg: str = ""):
        self.result = result
        super().__init__(
            msg
            or f"Command on {result.node!r} returned exit status "
            f"{result.exit}\ncmd: {result.cmd}\nout: {result.out}\n"
            f"err: {result.err}"
        )


def throw_on_nonzero_exit(result: Result) -> Result:
    """(reference: control/core.clj:155-171)"""
    if result.exit != 0:
        raise RemoteError(result)
    return result


class Remote:
    """A transport for running commands and moving files.
    (reference: control/core.clj:7-58)

    connect returns a *connected* remote bound to one node; execute/
    upload/download run on that bound instance.
    """

    def connect(self, node: Any, test: Optional[dict] = None) -> "Remote":
        raise NotImplementedError

    def disconnect(self) -> None:
        pass

    def execute(self, command: Command) -> Result:
        raise NotImplementedError

    def upload(self, local_paths: Union[str, Sequence[str]], remote_path: str) -> None:
        raise NotImplementedError

    def download(self, remote_paths: Union[str, Sequence[str]], local_path: str) -> None:
        raise NotImplementedError


class DummyRemote(Remote):
    """Performs no IO; records every command.  The reference's :dummy?
    mode (control.clj:40) — lets full tests run in-process.
    """

    def __init__(self, node: Any = None, log_: Optional[List[Command]] = None):
        self.node = node
        self.log = log_ if log_ is not None else []

    def connect(self, node, test=None):
        return DummyRemote(node, self.log)

    def execute(self, command: Command) -> Result:
        self.log.append((self.node, command))
        return Result(cmd=command.cmd, exit=0, out="", err="", node=self.node)

    def upload(self, local_paths, remote_path):
        self.log.append((self.node, ("upload", local_paths, remote_path)))

    def download(self, remote_paths, local_path):
        self.log.append((self.node, ("download", remote_paths, local_path)))
