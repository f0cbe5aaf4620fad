"""Lint core: source model, pass registry, suppressions, baseline.

The framework half of :mod:`jepsen_tpu_torch.lint` (the passes live in
sibling modules), a copy of the reference's ``jepsen_tpu/lint/core.py``
cut to what the port's passes use.  Everything here is stdlib-``ast``
based: no imports of the code under analysis, so linting ``ops/`` never
imports torch or initialises CUDA, and a syntax error in one file is one
finding, not a crashed run.

- :class:`SourceFile` — one parsed file: text, lines, AST, and the
  ``# jt: …`` directives in its comments.  Parses are cached per
  ``(path, mtime, size)``.
- :class:`Project` — the scanned file set plus options; passes that need
  cross-file context read it here, and leave :attr:`Project.notes` (what
  a pass skipped, and why) for the report.
- :class:`Pass` — one registered analysis owning one or more rule ids;
  ``lint_paths(rules=…)`` filters at the finding level.
- :class:`Finding` — one diagnostic, with a stable fingerprint (rule,
  path, enclosing scope, message and occurrence index; no line number,
  so an unrelated edit above a baselined finding does not churn the
  baseline).
- Baseline — a committed JSON file of fingerprints of grandfathered
  findings.  Matching findings are reported as baselined and never fail;
  entries with no matching finding are reported as stale warnings, so
  the file only shrinks.

Directive syntax (one trailing comment, on the line or a comment line
directly above): ``# jt: allow[rule-id]``, ``# jt: allow[rule-a,
rule-b]``, ``# jt: allow[*]`` suppress those rules' findings on that
line.  A directive must start its comment, so prose and string literals
that mention the syntax are never live.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import time
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: the committed baseline of grandfathered findings (package-relative, so
#: the CLI finds it from any working directory)
DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")

_DIRECTIVE_RE = re.compile(r"^#+\s*jt:\s*(.+?)\s*$")
_ALLOW_RE = re.compile(r"allow\[([^\]]*)\]")


class Finding:
    """One diagnostic.  ``scope`` is the enclosing class/function qualname
    (fingerprint stability under line drift); ``occurrence`` tells
    identical findings in one scope apart."""

    __slots__ = ("rule", "path", "line", "col", "message", "scope",
                 "occurrence", "baselined")

    def __init__(self, rule: str, path: str, line: int, col: int,
                 message: str, scope: str = ""):
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.message = message
        self.scope = scope
        self.occurrence = 0
        self.baselined = False

    def fingerprint(self) -> str:
        raw = "\x1f".join((self.rule, self.path, self.scope, self.message,
                           str(self.occurrence)))
        return hashlib.sha1(raw.encode("utf-8")).hexdigest()[:16]

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule, self.message)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "scope": self.scope, "fingerprint": self.fingerprint(),
                "baselined": self.baselined}

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class SourceFile:
    """One parsed source file plus its ``# jt:`` directives."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree: Optional[ast.Module] = ast.parse(text, filename=path)
        except SyntaxError as e:
            self.tree = None
            self.parse_error = e
        # line -> directive text (after "jt:"); comment tokens only
        self.directives: Dict[int, str] = {}
        if "jt:" in text:
            try:
                for tok in tokenize.generate_tokens(
                        io.StringIO(text).readline):
                    if tok.type == tokenize.COMMENT:
                        m = _DIRECTIVE_RE.match(tok.string)
                        if m:
                            self.directives[tok.start[0]] = m.group(1)
            except (tokenize.TokenError, IndentationError, SyntaxError):
                pass  # unparseable file: a parse-error finding, no directives

    def directives_at(self, line: int) -> List[str]:
        """Directives attached to ``line``: its own trailing comment or a
        standalone comment on the line directly above."""
        out = []
        d = self.directives.get(line)
        if d is not None:
            out.append(d)
        prev = self.directives.get(line - 1)
        if (prev is not None and line - 2 < len(self.lines)
                and self.lines[line - 2].lstrip().startswith("#")):
            out.append(prev)
        return out

    def allowed(self, line: int, rule: str) -> bool:
        for d in self.directives_at(line):
            m = _ALLOW_RE.search(d)
            if m:
                ids = {s.strip() for s in m.group(1).split(",")}
                if "*" in ids or rule in ids:
                    return True
        return False


#: parse cache: abspath -> (mtime_ns, size, SourceFile)
_CACHE: Dict[str, Tuple[int, int, SourceFile]] = {}


def load_file(path: str, rel: str) -> SourceFile:
    st = os.stat(path)
    key = os.path.abspath(path)
    hit = _CACHE.get(key)
    if hit is not None and hit[0] == st.st_mtime_ns and hit[1] == st.st_size:
        return hit[2]
    with open(path, "r", encoding="utf-8") as f:
        sf = SourceFile(path, rel, f.read())
    _CACHE[key] = (st.st_mtime_ns, st.st_size, sf)
    return sf


class Project:
    """The scanned file set plus options and the passes' notes."""

    def __init__(self, files: List[SourceFile],
                 options: Optional[dict] = None):
        self.files = files
        self.options = dict(options or {})
        #: what a pass skipped or could not check, for the report
        self.notes: List[str] = []

    def file_named(self, suffix: str) -> Optional[SourceFile]:
        suffix = suffix.replace("/", os.sep)
        for sf in self.files:
            if sf.path.endswith(suffix):
                return sf
        return None


class Pass:
    """One registered analysis pass."""

    name: str = ""
    rules: Tuple[str, ...] = ()

    def run(self, project: Project) -> List[Finding]:
        raise NotImplementedError


_PASSES: List[Pass] = []
_registered = False


def register(p: Pass) -> Pass:
    _PASSES.append(p)
    return p


def all_passes() -> List[Pass]:
    global _registered
    if not _registered:
        _registered = True
        # importing the pass modules registers them
        from . import budget  # noqa: F401
        from . import kernel_audit  # noqa: F401
    return list(_PASSES)


def all_rules() -> List[str]:
    return sorted(r for p in all_passes() for r in p.rules)


# -- path collection --------------------------------------------------------


def _rel_for(path: str) -> str:
    """Display/baseline path: ``jepsen_tpu_torch/…`` for files of the
    repository whatever the working directory, cwd-relative otherwise,
    absolute as a last resort."""
    ap = os.path.abspath(path)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for base in (repo, os.getcwd()):
        rel = os.path.relpath(ap, base)
        if not rel.startswith(".."):
            return rel.replace(os.sep, "/")
    return ap.replace(os.sep, "/")


def collect_files(paths: Sequence[str]) -> List[SourceFile]:
    seen = set()
    out: List[SourceFile] = []

    def add(fp: str) -> None:
        ap = os.path.abspath(fp)
        if ap not in seen:
            seen.add(ap)
            out.append(load_file(fp, _rel_for(fp)))

    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__"
                                     and not d.startswith("."))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        add(os.path.join(dirpath, fn))
        elif p.endswith(".py") and os.path.isfile(p):
            add(p)
    out.sort(key=lambda sf: sf.rel)
    return out


# -- runner -----------------------------------------------------------------


class LintResult:
    def __init__(self, findings: List[Finding], stale: List[dict],
                 n_files: int, timings: Dict[str, float]):
        self.findings = findings          # every non-baselined finding
        self.baselined: List[Finding] = []
        self.stale = stale                # stale baseline entries
        self.n_files = n_files
        self.timings = timings
        self.scanned_paths: set = set()   # rel paths of scanned files
        self.notes: List[str] = []        # what passes skipped, and why

    @property
    def ok(self) -> bool:
        return not self.findings


def _dedup_occurrences(findings: List[Finding]) -> None:
    """Occurrence indices, so identical findings in one scope get distinct
    fingerprints (assigned in sorted order, for determinism)."""
    counts: Dict[tuple, int] = {}
    for f in sorted(findings, key=Finding.sort_key):
        key = (f.rule, f.path, f.scope, f.message)
        f.occurrence = counts.get(key, 0)
        counts[key] = f.occurrence + 1


def lint_paths(paths: Sequence[str], rules: Optional[Iterable[str]] = None,
               options: Optional[dict] = None,
               baseline: Optional[dict] = None) -> LintResult:
    """Run every registered pass over ``paths``; returns the result with
    the baseline applied (``baseline=None`` skips it)."""
    files = collect_files(paths)
    project = Project(files, options)
    enabled = set(rules) if rules is not None else None
    findings: List[Finding] = []
    timings: Dict[str, float] = {}
    for sf in files:
        if sf.parse_error is not None:
            findings.append(Finding(
                "parse-error", sf.rel, sf.parse_error.lineno or 1, 0,
                f"syntax error: {sf.parse_error.msg}"))
    for p in all_passes():
        if enabled is not None and not (set(p.rules) & enabled):
            continue
        t0 = time.perf_counter()
        findings.extend(f for f in p.run(project)
                        if enabled is None or f.rule in enabled)
        timings[p.name] = time.perf_counter() - t0
    findings.sort(key=Finding.sort_key)
    _dedup_occurrences(findings)

    scanned = {sf.rel for sf in files}
    stale: List[dict] = []
    kept: List[Finding] = []
    baselined: List[Finding] = []
    if baseline:
        entries = {e["fp"]: e for e in baseline.get("findings", ())}
        matched = set()
        for f in findings:
            fp = f.fingerprint()
            if fp in entries:
                f.baselined = True
                matched.add(fp)
                baselined.append(f)
            else:
                kept.append(f)
        for fp, e in sorted(entries.items()):
            # stale only when its file was scanned and its rule enabled:
            # a subset run must not call out-of-scope entries stale
            if (fp not in matched and e.get("path") in scanned
                    and (enabled is None or e.get("rule") in enabled)):
                stale.append(e)
    else:
        kept = findings
    res = LintResult(kept, stale, len(files), timings)
    res.baselined = baselined
    res.scanned_paths = scanned
    res.notes = list(project.notes)
    return res


# -- baseline I/O -----------------------------------------------------------


def load_baseline(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("version") != 1:
        raise ValueError(f"unrecognized baseline format in {path!r}")
    return data


def make_baseline(findings: List[Finding]) -> dict:
    return {"version": 1, "findings": [
        {"fp": f.fingerprint(), "rule": f.rule, "path": f.path,
         "message": f.message}
        for f in sorted(findings, key=Finding.sort_key)]}


def write_baseline(path: str, findings: List[Finding]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(make_baseline(findings), f, indent=2, sort_keys=True)
        f.write("\n")


# -- shared AST helpers ------------------------------------------------------


def cached_walk(node: ast.AST):
    """``ast.walk`` order, memoised on the node (trees are immutable once
    parsed, and the passes walk them many times)."""
    cached = getattr(node, "_jt_walk_cache", None)
    if cached is None:
        cached = tuple(ast.walk(node))
        node._jt_walk_cache = cached
    return cached


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_name(node: ast.AST) -> str:
    """The last component of a Name/Attribute chain (``""`` otherwise)."""
    return (dotted_name(node) or "").rsplit(".", 1)[-1]


class FunctionIndex:
    """Every function/method in a module, by qualname, with parents."""

    def __init__(self, tree: ast.Module):
        self.funcs: Dict[str, ast.AST] = {}
        self.parents: Dict[str, Optional[str]] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        self._walk(tree.body, None)

    def _walk(self, body, scope: Optional[str]) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{scope}.{node.name}" if scope else node.name
                self.funcs[q] = node
                self.parents[q] = scope
                self._walk(node.body, q)
            elif isinstance(node, ast.ClassDef):
                q = f"{scope}.{node.name}" if scope else node.name
                self.classes[q] = node
                self.parents[q] = scope
                self._walk(node.body, q)
            else:
                # conditionally defined functions share the scope
                self._walk(list(ast.iter_child_nodes(node)), scope)

    def owning_class(self, q: str) -> Optional[str]:
        parent = self.parents.get(q)
        while parent is not None:
            if parent in self.classes:
                return parent
            parent = self.parents.get(parent)
        return None


def function_index(sf: SourceFile) -> FunctionIndex:
    """The file's :class:`FunctionIndex`, memoised on the SourceFile."""
    idx = getattr(sf, "_jt_fn_index", None)
    if idx is None:
        idx = sf._jt_fn_index = FunctionIndex(sf.tree)
    return idx
