"""PATH shims standing in for ``ssh``, ``scp``, ``docker``, ``kubectl``
and ``sudo``: what the control transports' tests, and ``chip_smoke.py``'s
localkv run over the SSH transport, put ahead of ``PATH``.  Stdlib only.

:func:`write_shims` writes one small Python script per program into a
directory.  Each call of a shim appends one JSON line to the log: the
program, its argv, the standard input it read, and the askpass variables
it saw.  Then it does on this host what the real program would do on the
node:

- ``ssh [options] user@node command`` runs ``command`` with ``bash -c``
  (as ``control.local.LocalRemote`` does), its standard input fed
  through; ``ssh -O exit ...`` (a ControlMaster command) only logs;
- ``scp [options] sources... dest``, ``docker cp a b`` and ``kubectl cp
  -n ns a b`` copy with ``cp -r`` after dropping the operands'
  ``user@node:``, ``container:`` or ``pod:`` prefix;
- ``docker ps -q -f name=N`` prints the container id ``c0ffee-N``;
  ``docker exec [-i] C argv...`` and ``kubectl exec -n ns [-i] pod --
  argv...`` run ``argv``;
- ``sudo -k -S -u user argv...`` takes the password from the first line
  of its standard input and runs ``argv`` with the rest.

With ``auth`` given, ``ssh`` and ``scp`` authenticate first, as a server
with one account would: ``{"identity": path}`` accepts ``-i path``,
``{"agent": socket}`` accepts ``IdentityAgent=socket`` and
``{"password": pw}`` accepts an ``SSH_ASKPASS`` program that prints
``pw``; anything else exits 255 with "Permission denied".

A shim reads its standard input to its end when that is a pipe, a file
or ``/dev/null`` (never a terminal): run it with input given, or with
``/dev/null`` (pytest's capture gives that).
"""

from __future__ import annotations

import json
import os
import re
import stat
import sys

PROGRAMS = ("ssh", "scp", "docker", "kubectl")

_SHIM = r'''
import fcntl, json, os, re, select, stat, subprocess, sys

PROG = __PROG__
LOG = __LOG__
AUTH = __AUTH__
SSH_ARGS = set("BbcDEeFIiJLlmOopQRSWw")
SCP_ARGS = set("cDFiJlOoPSX")
ASKPASS = ("SSH_ASKPASS", "SSH_ASKPASS_REQUIRE", "DISPLAY")


def read_stdin():
    try:
        mode = os.fstat(0).st_mode
    except OSError:
        return b""
    if os.isatty(0):
        return b""
    if stat.S_ISFIFO(mode) or stat.S_ISSOCK(mode):
        if not select.select([0], [], [], 5.0)[0]:
            return b""
    chunks = []
    while True:
        b = os.read(0, 65536)
        if not b:
            return b"".join(chunks)
        chunks.append(b)


def log(argv, data):
    entry = {"prog": PROG, "argv": argv,
             "stdin": data.decode("utf-8", "replace"),
             "env": {k: os.environ[k] for k in ASKPASS if k in os.environ}}
    with open(LOG, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.write(json.dumps(entry) + "\n")
        fcntl.flock(f, fcntl.LOCK_UN)


def parse(argv, with_arg):
    """(options as (flag, value) pairs, operands) of an ssh/scp argv."""
    opts, i = [], 0
    while i < len(argv):
        a = argv[i]
        if a == "--":
            i += 1
            break
        if not a.startswith("-") or a == "-":
            break
        j = 1
        while j < len(a):
            c = a[j]
            if c in with_arg:
                v = a[j + 1:]
                if not v:
                    i += 1
                    v = argv[i]
                opts.append((c, v))
                break
            opts.append((c, None))
            j += 1
        i += 1
    return opts, argv[i:]


def authed(opts):
    if AUTH is None:
        return True
    o = [v for c, v in opts if c == "o"]
    ids = [v for c, v in opts if c == "i"]
    if "identity" in AUTH and AUTH["identity"] in ids:
        return True
    if "agent" in AUTH and "IdentityAgent=" + AUTH["agent"] in o:
        return True
    if "password" in AUTH and os.environ.get("SSH_ASKPASS"):
        got = subprocess.run([os.environ["SSH_ASKPASS"]],
                             capture_output=True, timeout=30).stdout
        return got.decode() == AUTH["password"]
    return False


def local(path):
    return re.sub(r"^([^/:@]+@)?[^/:]+:", "", path)


def run(argv, data):
    return subprocess.run(argv, input=data, timeout=600).returncode


def main():
    argv = sys.argv[1:]
    data = read_stdin()
    log(argv, data)
    if PROG == "ssh":
        opts, rest = parse(argv, SSH_ARGS)
        if any(c == "O" for c, _ in opts):
            return 0
        if not authed(opts):
            sys.stderr.write("Permission denied (publickey,password).\n")
            return 255
        return run(["bash", "-c", " ".join(rest[1:])], data)
    if PROG == "scp":
        opts, rest = parse(argv, SCP_ARGS)
        if not authed(opts):
            sys.stderr.write("Permission denied (publickey,password).\n")
            return 255
        return run(["cp", "-r"] + [local(p) for p in rest], data)
    if PROG == "docker":
        if argv[0] == "ps":
            name = [a for a in argv if a.startswith("name=")]
            print("c0ffee-" + name[0][len("name="):] if name else "")
            return 0
        if argv[0] == "cp":
            return run(["cp", "-r", local(argv[1]), local(argv[2])], data)
        if argv[0] == "exec":
            rest = argv[1:]
            while rest[0].startswith("-"):
                rest = rest[1:]
            return run(rest[1:], data)
    if PROG == "kubectl":
        if argv[0] == "cp":
            ops = [a for i, a in enumerate(argv[1:], 1)
                   if a != "-n" and argv[i - 1] != "-n"]
            return run(["cp", "-r"] + [local(p) for p in ops], data)
        if argv[0] == "exec":
            return run(argv[argv.index("--") + 1:], data)
    if PROG == "sudo":
        opts, rest = parse(argv, set("ugCghpr"))
        _, _, data = data.partition(b"\n")
        return run(rest, data)
    sys.stderr.write(PROG + ": unsupported call\n")
    return 2


sys.exit(main())
'''


def write_shims(directory: str, log: str, programs=PROGRAMS,
                auth=None) -> str:
    """Write a shim for each of ``programs`` into ``directory`` (made if
    absent), logging to ``log``; returns ``directory``, to put ahead of
    ``PATH``."""
    os.makedirs(directory, exist_ok=True)
    for prog in programs:
        src = (f"#!{sys.executable} -I\n" + _SHIM
               .replace("__PROG__", repr(prog))
               .replace("__LOG__", repr(os.path.abspath(log)))
               .replace("__AUTH__", repr(auth)))
        path = os.path.join(directory, prog)
        with open(path, "w") as f:
            f.write(src)
        os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP
                 | stat.S_IXOTH)
    return directory


def read_log(log: str) -> list:
    """The log's entries, oldest first (``[]`` before the first call)."""
    if not os.path.exists(log):
        return []
    with open(log) as f:
        return [json.loads(line) for line in f if line.strip()]


#: the per-connection paths that differ between runs: the SSH transport's
#: ControlMaster directory and the agent-ssh transport's askpass directory
_RUN_PATHS = re.compile(r"jepsen-(a?ssh)-[A-Za-z0-9_]+")


def normalise(x):
    """``x`` (a log entry, a list of them, a string) with every
    per-connection temporary directory name made ``jepsen-ssh-*`` or
    ``jepsen-assh-*``."""
    if isinstance(x, str):
        return _RUN_PATHS.sub(r"jepsen-\1-*", x)
    if isinstance(x, dict):
        return {k: normalise(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [normalise(v) for v in x]
    return x
