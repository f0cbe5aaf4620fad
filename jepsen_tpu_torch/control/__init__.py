"""Remote-command control plane.

The dynamic-context command DSL over pluggable Remote transports
(reference: jepsen/src/jepsen/control.clj:40-319 — dynamic vars, exec,
su/sudo/cd, upload/download, sessions, on-nodes).

This module holds the dynamic execution context (current node, session,
sudo/dir state, thread-local) and the session lifecycle; ``core`` holds
the Remote protocol, escaping and the dummy remote mirroring the
reference's ``:dummy?`` mode (control.clj:40), which in-process tests
run under; ``local`` runs commands on this host (the localkv suite's
remote); ``util`` holds the node-side helpers (daemons, files, ports).
The port has no network transport yet (the reference's ``ssh``,
``agent_ssh``, ``docker``, ``k8s``, ``retry`` and ``scp`` submodules).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

from .core import Remote, DummyRemote, RemoteError, lit, escape  # noqa: F401

# The node binding is thread-local (each on-nodes worker thread binds its
# own node — the reference uses dynamic vars with binding conveyance,
# control.clj:40-53 + util.clj:65-83).  The session table is
# process-global: worker threads spawned by real_pmap must see it.
_local = threading.local()
_sessions_lock = threading.Lock()
_sessions: Dict[Any, Remote] = {}


@contextmanager
def with_session(test: dict, remote: Remote):
    """Open a session per node; body runs with sessions available.
    Sessions do not nest: one test's control plane at a time.
    (reference: core.clj:275-296 with-sessions + control.clj:226-266)"""
    sessions = {}
    try:
        for node in test["nodes"]:
            sessions[node] = remote.connect(node, test)
        with _sessions_lock:
            _sessions.update(sessions)
        try:
            yield sessions
        finally:
            with _sessions_lock:
                for node in sessions:
                    _sessions.pop(node, None)
    finally:
        for s in sessions.values():
            try:
                s.disconnect()
            except Exception:
                pass


@contextmanager
def dummy_session(test: dict):
    """All commands become no-ops that record themselves — the
    reference's :dummy? ssh mode (control.clj:40, cli.clj:85-86)."""
    remote = DummyRemote()
    with with_session(test, remote) as sessions:
        yield sessions


def with_node(node: Any, fn: Callable[[], Any]) -> Any:
    """Bind the dynamic node for this thread while running fn.
    (reference: control.clj:272-293 on/on-nodes)"""
    prev = getattr(_local, "node", None)
    _local.node = node
    try:
        return fn()
    finally:
        _local.node = prev


def current_node() -> Optional[Any]:
    return getattr(_local, "node", None)


def current_session() -> Optional[Remote]:
    node = current_node()
    if node is None:
        return None
    with _sessions_lock:
        return _sessions.get(node)


# ---------------------------------------------------------------------------
# Command DSL (reference: control.clj:138-218 exec/su/sudo/cd,
# :167-189 upload/download)
# ---------------------------------------------------------------------------


def _dyn(name: str, default=None):
    return getattr(_local, name, default)


@contextmanager
def sudo(user: str = "root", password: Optional[str] = None):
    """Run body's commands as `user` (optionally with a sudo password,
    fed on stdin via sudo -S).  (reference: control.clj:203-213)"""
    prev = _dyn("sudo")
    prev_pw = _dyn("sudo_password")
    _local.sudo = user
    if password is not None:
        _local.sudo_password = password
    try:
        yield
    finally:
        _local.sudo = prev
        _local.sudo_password = prev_pw


su = sudo  # reference aliases su to sudo-as-root

#: process-wide default for command tracing, the `*trace*` dynamic var
#: (reference: control.clj:43); the `trace` context manager overrides it
#: per thread.
TRACE = False


@contextmanager
def trace(enabled: bool = True):
    """Log every command (with its node) before it runs in the body.
    (reference: control.clj:43 *trace* + :115-119 wrap-trace)"""
    # restore by deletion when previously unset: leaving `None` behind
    # would shadow the module-level TRACE default on this thread
    had = hasattr(_local, "trace")
    prev = _dyn("trace")
    _local.trace = enabled
    try:
        yield
    finally:
        if had:
            _local.trace = prev
        else:
            del _local.trace


@contextmanager
def cd(dir: str):
    """Run body's commands within `dir`.  (reference: control.clj:214-218)"""
    prev = _dyn("dir")
    _local.dir = dir
    try:
        yield
    finally:
        _local.dir = prev


def execute(*args, stdin: Optional[str] = None, check: bool = True):
    """Build + run one shell command on the current node's session.
    Args are escaped (Lit passes raw).  Returns stdout (stripped), like
    the reference's exec (control.clj:138-157)."""
    from .core import Command, throw_on_nonzero_exit

    session = current_session()
    if session is None:
        raise RuntimeError(
            f"no session bound for node {current_node()!r}; "
            "use with_session/on_nodes"
        )
    cmd = " ".join(escape(a) for a in args)
    if _dyn("trace", TRACE):
        import logging

        logging.getLogger(__name__).info(
            "Host: %s cmd: %s", current_node(), cmd
        )
    command = Command(
        cmd=cmd,
        stdin=stdin,
        sudo=_dyn("sudo"),
        dir=_dyn("dir"),
        sudo_password=_dyn("sudo_password"),
    )
    from .. import obs

    with obs.span("control/exec", cat="control") as sp:
        sp.set("node", current_node())
        result = session.execute(command)
    obs.observe("jepsen_control_exec_seconds", sp.duration_s())
    if check:
        throw_on_nonzero_exit(result)
    return result.out.strip()


# short name matching the reference's c/exec
exec_ = execute


def upload(local_path, remote_path):
    """(reference: control.clj:167-178)"""
    session = current_session()
    if session is None:
        raise RuntimeError("no session bound")
    session.upload(local_path, remote_path)


def download(remote_path, local_path):
    """(reference: control.clj:179-189)"""
    session = current_session()
    if session is None:
        raise RuntimeError("no session bound")
    session.download(remote_path, local_path)


def _binding_snapshot() -> dict:
    """Capture the caller's dynamic bindings so worker threads inherit
    them — the reference's binding conveyance (util.clj:65-83)."""
    return {
        "sudo": _dyn("sudo"),
        "dir": _dyn("dir"),
        "sudo_password": _dyn("sudo_password"),
        "trace": _dyn("trace", TRACE),
    }


@contextmanager
def _with_bindings(snapshot: dict):
    # restore-by-deletion for keys that weren't set: leaving e.g.
    # trace=None behind would shadow its module-level default (the
    # worker may be the calling thread itself when the pool runs a task
    # inline)
    had = {k: hasattr(_local, k) for k in snapshot}
    prev = {k: _dyn(k) for k in snapshot}
    for k, v in snapshot.items():
        setattr(_local, k, v)
    try:
        yield
    finally:
        for k in snapshot:
            if had[k]:
                setattr(_local, k, prev[k])
            else:
                delattr(_local, k)


def on_nodes(test: dict, fn_or_nodes, maybe_fn=None) -> Dict[Any, Any]:
    """Run (fn test node) on some (default: all) nodes concurrently, with
    the node binding set and the caller's sudo/cd bindings conveyed.
    Returns {node: result}.  (reference: control.clj:295-311)"""
    from ..util import real_pmap

    if maybe_fn is None:
        nodes, fn = test["nodes"], fn_or_nodes
    else:
        nodes, fn = fn_or_nodes, maybe_fn
    snapshot = _binding_snapshot()

    def run_one(node):
        with _with_bindings(snapshot):
            return with_node(node, lambda: fn(test, node))

    return dict(zip(nodes, real_pmap(run_one, list(nodes))))


def on_many(nodes, thunk: Callable[[], Any]) -> Dict[Any, Any]:
    """Run thunk bound to each node concurrently; {node: result}.
    Conveys the caller's sudo/cd bindings into the worker threads.
    (reference: control.clj:272-293 on-many)"""
    from ..util import real_pmap

    snapshot = _binding_snapshot()

    def run_one(node):
        with _with_bindings(snapshot):
            return with_node(node, thunk)

    return dict(zip(nodes, real_pmap(run_one, list(nodes))))


def with_test_nodes(test: dict, thunk: Callable[[], Any]) -> Dict[Any, Any]:
    """(reference: control.clj with-test-nodes)"""
    return on_many(test["nodes"], thunk)
