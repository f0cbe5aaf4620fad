"""Remote protocol, shell escaping, sudo wrapping.

(reference: jepsen/src/jepsen/control/core.clj — Remote protocol :7-58,
lit :62-66, escape :67-110, throw-on-nonzero-exit :155-171.)  The
transports' helpers (``env``, ``wrap_sudo``) come with the first
transport the port gets.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Union


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


@dataclass
class Command:
    """An action to run on a remote node."""

    cmd: str
    stdin: Optional[str] = None
    sudo: Optional[str] = None
    dir: Optional[str] = None
    sudo_password: Optional[str] = None


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
