"""Dispatch discipline: every kernel launch rides a capped path.

The port of ``jepsen_tpu/lint/budget.py``.  A kernel launched outside
the Executor's chunk loop is not held to the per-dispatch row cap, so one
oversized batch can take more device memory than every other path allows
itself.  The model, inferred from the source (no annotations needed):

- A **wrapper** is a class that counts its launches (``self.launches +=
  1``): the hand-written kernels' ctypes wrappers.  A module-level name
  bound to a wrapper instance (``HAS_CYCLE = HasCycleKernel()``), a dict
  of them (``DENSE_KERNELS``) or an entry of one is a *wrapper value*.
- A **dispatcher** is a function that calls a wrapper value behind the
  device switch (it also reads ``.is_cuda`` or ``.device.type``): the
  CUDA/plain pair ``has_cycle``, ``screen``.  A **checker class** is a
  class one of whose methods calls a wrapper value (``FrontierChecker``,
  ``DenseChecker``).  Both are the wrapper layer: their own launches
  are not dispatches.
- A **builder** is what manufactures a kernel checker: a function that
  returns a checker-class instance or a ``functools.partial`` of a
  dispatcher (directly, through a local, or through a method chain such
  as ``DenseChecker(...).to(device)``); a module-level ``lru_cache(...)``
  of a checker class or builder (``_checker``); a function that returns a
  builder's result (``make_check_fn``, ``make_dense_fn``,
  ``make_best_check_fn``); and a *plan class* whose ``__init__`` binds
  ``self.fn`` to a builder's result or a dispatcher partial
  (``CyclePlan``, ``ScreenPlan``).  A **kernel value** is what a builder
  returns, held in a local, a ``self`` attribute or called at once, or a
  wrapper value called outside the wrapper layer.

Rules:

- ``budget-direct-dispatch`` — a kernel value called outside the
  sanctioned paths: ``engine/execution.py`` (the Executor owns chunking),
  ``chip_smoke.py`` and ``scripts/*_ab.py``/``*_diag.py`` (measurement),
  a function that visibly reads the cap (a ``*max_dispatch*`` helper, a
  ``.safe_dispatch`` or ``.disp``), and a line with ``# jt:
  allow[budget-direct-dispatch]``.  A kernel passed as an argument is the
  capped hand-off idiom and is not tracked.
- ``budget-missing-cap`` — a checker class, plan class or partial-
  returning builder with no row cap the Executor reads: nothing stamps
  ``safe_dispatch`` (read by ``ops/wgl.py:plan_bucket`` into
  ``plan.disp``) or ``disp``.
"""

from __future__ import annotations

import ast
import fnmatch
import os
from typing import Dict, List, Optional, Set

from .core import (Finding, Pass, Project, SourceFile, cached_walk,
                   dotted_name, function_index, last_name, register)

#: files whose launches are the capped path or a measurement
SANCTIONED = ("*engine/execution.py", "*chip_smoke.py", "*scripts/*_ab.py",
              "*scripts/*_diag.py")

#: attributes that carry a row cap the Executor reads
CAP_ATTRS = ("safe_dispatch", "disp")

_PARTIAL = ("partial", "functools.partial")
_CACHES = ("lru_cache", "cache")


def _own_nodes(fn: ast.AST) -> tuple:
    """``fn``'s nodes without nested defs or classes (memoised)."""
    cached = getattr(fn, "_jt_own_nodes", None)
    if cached is None:
        out = []
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            out.append(node)
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef, ast.Lambda)):
                stack.extend(ast.iter_child_nodes(node))
        cached = fn._jt_own_nodes = tuple(out)
    return cached


def _counts_launches(cls: ast.ClassDef) -> bool:
    for node in cached_walk(cls):
        if (isinstance(node, ast.AugAssign)
                and isinstance(node.target, ast.Attribute)
                and node.target.attr == "launches"
                and isinstance(node.target.value, ast.Name)
                and node.target.value.id == "self"):
            return True
    return False


def _root_call(node: ast.AST) -> Optional[ast.Call]:
    """The innermost call of a method chain: ``X(...).to(d)`` → ``X(...)``."""
    while isinstance(node, ast.Call):
        inner = node.func
        if isinstance(inner, ast.Attribute) and isinstance(inner.value,
                                                           ast.Call):
            node = inner.value
            continue
        return node
    return None


def _stamps_cap(node: ast.AST) -> bool:
    """Does the body assign ``<anything>.safe_dispatch`` or ``.disp``?"""
    for n in cached_walk(node):
        targets = (n.targets if isinstance(n, ast.Assign)
                   else [n.target] if isinstance(n, ast.AnnAssign) else [])
        for t in targets:
            for tt in (t.elts if isinstance(t, ast.Tuple) else [t]):
                if isinstance(tt, ast.Attribute) and tt.attr in CAP_ATTRS:
                    return True
    return False


class _Facts:
    """Program-wide names: wrapper classes and values, checker classes,
    dispatchers, builders."""

    def __init__(self, files: List[SourceFile]):
        self.files = files
        self.wrapper_classes: Set[str] = set()
        self.wrapper_values: Set[str] = set()
        self.checker_classes: Set[str] = set()
        self.plan_classes: Set[str] = set()
        self.dispatchers: Set[str] = set()
        self.builders: Set[str] = set()
        for sf in files:
            for q, cls in function_index(sf).classes.items():
                if _counts_launches(cls):
                    self.wrapper_classes.add(cls.name)
        for sf in files:
            self._wrapper_values(sf)
        for sf in files:
            idx = function_index(sf)
            for q, cls in idx.classes.items():
                if any(self.reaches_wrapper(m) for m in cls.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and m.name != "__init__"):
                    self.checker_classes.add(cls.name)
            for q, fn in idx.funcs.items():
                if (idx.owning_class(q) is None
                        and self.reaches_wrapper(fn)
                        and _device_switch(fn)):
                    self.dispatchers.add(fn.name)
        self._builders()

    # -- wrapper values ------------------------------------------------------

    def _is_wrapper_ctor(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and last_name(node.func) in self.wrapper_classes)

    def _wrapper_values(self, sf: SourceFile) -> None:
        for _ in range(2):  # aliases of aliases settle in two sweeps
            for node in sf.tree.body:
                if not isinstance(node, ast.Assign):
                    continue
                v = node.value
                hit = (self._is_wrapper_ctor(v)
                       or (isinstance(v, ast.Dict) and any(
                           self._is_wrapper_ctor(x) for x in v.values))
                       or (isinstance(v, ast.DictComp)
                           and self._is_wrapper_ctor(v.value))
                       or (isinstance(v, (ast.Name, ast.Subscript))
                           and self.is_wrapper_value(v)))
                for t in node.targets:
                    if isinstance(t, ast.Name) and hit:
                        self.wrapper_values.add(t.id)
                    elif (isinstance(t, ast.Subscript)
                          and isinstance(t.value, ast.Name)
                          and self._is_wrapper_ctor(v)):
                        self.wrapper_values.add(t.value.id)

    def is_wrapper_value(self, node: ast.AST) -> bool:
        """``NAME``, ``mod.NAME`` or ``NAME[...]`` of a wrapper value."""
        if isinstance(node, ast.Subscript):
            node = node.value
        return last_name(node) in self.wrapper_values

    def reaches_wrapper(self, fn: ast.AST) -> bool:
        return bool(self.wrapper_calls(fn))

    def wrapper_calls(self, fn: ast.AST) -> List[ast.Call]:
        """Calls of a wrapper value in ``fn``'s own body, through a local
        alias too (``kernel = DENSE_KERNELS[fam]; kernel(...)``)."""
        aliases: Set[str] = set()
        for node in _own_nodes(fn):
            if (isinstance(node, ast.Assign)
                    and self.is_wrapper_value(node.value)):
                aliases.update(t.id for t in node.targets
                               if isinstance(t, ast.Name))
        return [node for node in _own_nodes(fn)
                if isinstance(node, ast.Call)
                and (self.is_wrapper_value(node.func)
                     or (isinstance(node.func, ast.Name)
                         and node.func.id in aliases))]

    # -- builders ------------------------------------------------------------

    def builder_expr(self, node: ast.AST) -> bool:
        """Is ``node`` a freshly built kernel checker?"""
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name in _PARTIAL and node.args and \
                    last_name(node.args[0]) in self.dispatchers:
                return True
            root = _root_call(node)
            if root is not None and isinstance(root.func, ast.Call):
                # lru_cache(...)(X)(...) or builder(...)(...)
                return False
            if root is not None and last_name(root.func) in (
                    self.checker_classes | self.builders):
                return True
        return False

    def _returns_checker(self, fn: ast.AST) -> bool:
        built: Set[str] = set()
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign) and self.builder_expr(node.value):
                built.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
        for node in _own_nodes(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                v = node.value
                if self.builder_expr(v) or (isinstance(v, ast.Name)
                                            and v.id in built):
                    return True
        return False

    def _builders(self) -> None:
        changed = True
        while changed:
            changed = False
            for sf in self.files:
                idx = function_index(sf)
                for q, fn in idx.funcs.items():
                    if fn.name not in self.builders and \
                            self._returns_checker(fn):
                        self.builders.add(fn.name)
                        changed = True
                for node in sf.tree.body:
                    if (isinstance(node, ast.Assign)
                            and isinstance(node.value, ast.Call)
                            and isinstance(node.value.func, ast.Call)
                            and last_name(node.value.func.func) in _CACHES
                            and node.value.args
                            and last_name(node.value.args[0]) in (
                                self.checker_classes | self.builders)):
                        for t in node.targets:
                            if isinstance(t, ast.Name) and \
                                    t.id not in self.builders:
                                self.builders.add(t.id)
                                changed = True
                for q, cls in idx.classes.items():
                    if cls.name in self.plan_classes:
                        continue
                    init = next((m for m in cls.body
                                 if isinstance(m, ast.FunctionDef)
                                 and m.name == "__init__"), None)
                    if init is not None and any(
                            isinstance(n, ast.Assign)
                            and any(_is_self_attr(t, "fn")
                                    for t in n.targets)
                            and self.builder_expr(n.value)
                            for n in cached_walk(init)):
                        self.plan_classes.add(cls.name)
                        changed = True


def _is_self_attr(node: ast.AST, attr: Optional[str] = None) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self"
            and (attr is None or node.attr == attr))


def _device_switch(fn: ast.AST) -> bool:
    """The function picks the kernel or the plain version by device."""
    for node in cached_walk(fn):
        if isinstance(node, ast.Attribute) and node.attr == "is_cuda":
            return True
        if (isinstance(node, ast.Attribute) and node.attr == "type"
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "device"):
            return True
    return False


def _reads_cap(fn: ast.AST) -> bool:
    for node in cached_walk(fn):
        if (isinstance(node, ast.Attribute) and node.attr in CAP_ATTRS
                and isinstance(node.ctx, ast.Load)):
            return True
        if isinstance(node, ast.Call) and \
                "max_dispatch" in last_name(node.func):
            return True
    return False


class BudgetDiscipline(Pass):
    name = "budget"
    rules = ("budget-direct-dispatch", "budget-missing-cap")

    def run(self, project: Project) -> List[Finding]:
        files = [sf for sf in project.files if sf.tree is not None]
        facts = _Facts(files)
        out: List[Finding] = []
        for sf in files:
            self._missing_cap(sf, facts, out)
            if not any(fnmatch.fnmatch(sf.rel.replace(os.sep, "/"), pat)
                       for pat in SANCTIONED):
                self._direct_dispatch(sf, facts, out)
        return out

    # -- budget-missing-cap --------------------------------------------------

    def _missing_cap(self, sf: SourceFile, facts: _Facts,
                     out: List[Finding]) -> None:
        idx = function_index(sf)
        for q, cls in sorted(idx.classes.items()):
            kind = ("checker class" if cls.name in facts.checker_classes
                    else "plan class" if cls.name in facts.plan_classes
                    else None)
            if kind is not None and not _stamps_cap(cls):
                self._emit(out, sf, "budget-missing-cap", cls, q,
                           f"{kind} `{cls.name}` carries no row cap: stamp"
                           " `self.safe_dispatch` (or the plan's `disp`)"
                           " so the Executor chunks its dispatches")
        for q, fn in sorted(idx.funcs.items()):
            partial_returner = any(
                isinstance(n, ast.Call)
                and (dotted_name(n.func) or "") in _PARTIAL and n.args
                and last_name(n.args[0]) in facts.dispatchers
                for n in _own_nodes(fn))
            if (fn.name in facts.builders and partial_returner
                    and idx.owning_class(q) is None and not _stamps_cap(fn)):
                self._emit(out, sf, "budget-missing-cap", fn, q,
                           f"builder `{fn.name}` returns a dispatcher partial"
                           " without stamping `safe_dispatch` — every kernel"
                           " checker carries its footprint-safe row cap")

    # -- budget-direct-dispatch ----------------------------------------------

    def _direct_dispatch(self, sf: SourceFile, facts: _Facts,
                         out: List[Finding]) -> None:
        idx = function_index(sf)
        kernel_attrs: Dict[str, Set[str]] = {}
        for cq, cls in idx.classes.items():
            kernel_attrs[cq] = {
                t.attr for n in cached_walk(cls) if isinstance(n, ast.Assign)
                and facts.builder_expr(n.value)
                for t in n.targets if _is_self_attr(t)}
        for q, fn in sorted(idx.funcs.items()):
            cls = idx.owning_class(q)
            layer = (fn.name in facts.dispatchers
                     or (cls is not None and idx.classes[cls].name in (
                         facts.checker_classes | facts.wrapper_classes)))
            attrs = kernel_attrs.get(cls, set()) if cls else set()
            kernel_vars = {t.id for n in _own_nodes(fn)
                           if isinstance(n, ast.Assign)
                           and facts.builder_expr(n.value)
                           for t in n.targets if isinstance(t, ast.Name)}
            wrapper_calls = set() if layer else {
                id(c) for c in facts.wrapper_calls(fn)}
            enforcing = None
            for node in _own_nodes(fn):
                if not isinstance(node, ast.Call):
                    continue
                target = None
                if isinstance(node.func, ast.Name) and \
                        node.func.id in kernel_vars:
                    target = node.func.id
                elif _is_self_attr(node.func) and node.func.attr in attrs:
                    target = f"self.{node.func.attr}"
                elif isinstance(node.func, ast.Call) and \
                        facts.builder_expr(node.func):
                    target = last_name(_root_call(node.func).func)
                elif id(node) in wrapper_calls:
                    target = dotted_name(node.func) or "wrapper"
                if target is None:
                    continue
                if enforcing is None:
                    enforcing = _reads_cap(fn)
                if enforcing:
                    continue
                self._emit(out, sf, "budget-direct-dispatch", node, q,
                           f"kernel `{target}` dispatched directly — route it"
                           " through the Executor or a loop capped by"
                           " `safe_dispatch` (or allow a measurement line)")

    def _emit(self, out, sf, rule, node, scope, msg) -> None:
        if not sf.allowed(node.lineno, rule):
            out.append(Finding(rule, sf.rel, node.lineno, node.col_offset,
                               msg, scope))


register(BudgetDiscipline())
