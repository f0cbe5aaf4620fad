"""Kernel contracts: the port's counterpart of ``jepsen_tpu/lint/jaxpr_audit.py``.

The AST passes certify the Python around the kernels; this pass
certifies the kernels themselves against what the code around them
assumes.  It keeps a registry (:data:`REGISTRY`) of every entry point of
the CUDA sources in ``ops/_build.py``'s ``SOURCES``, each with its
wrapper, its pricing function and its shape buckets, and has five rules:

- ``kernel-resources`` — every ``__global__`` function carries a declared
  bound on the line of its declaration (or a comment line directly above
  it or its ``template`` line)::

      // jt: ptxas(regs<=64, spill<=24, smem<=3072)

  and ptxas's report for every instance of it (registers, the larger of
  the spill store and load bytes, static shared memory) stays within it.
  The report is the ``-Xptxas=-v`` log ``ops/_build.py`` keeps beside
  each library when it builds it with ``nvcc``; with no log this half is
  skipped and the run says so.
- ``kernel-budget`` — each pricing function declares, on its ``def``
  line, the bands its measured-over-priced ratios must fall in: the
  requested bytes' and the allocated bytes'::

      # jt: budget(0.99..1.01, allocated=0.99..1.01)
      def frontier_row_bytes(F, E, C):

  On the CPU the bands are parsed and checked for every registry entry.
  The measurement is the card half (:func:`measure_budgets`, run by
  ``chip_smoke.py``): at every bucket, the per-row device bytes a launch
  really holds — the slope of the allocator's peak between two batch
  sizes, the peak reset before each: inputs, outputs and workspace —
  must sit inside the bands: the requested bytes (the tensors' own
  sizes) at two small batches, and ``torch.cuda.max_memory_allocated()``
  (the allocator's blocks, what an out-of-memory error counts) at half
  and all of the rows a dispatch may take, held where the two differ by
  :data:`ALLOCATED_MIN_SPAN` or more, so the allocator's rounding is a
  negligible share of the slope.  The frontier library's own workspace
  size must equal the workspace term of its pricing; a dense entry (no
  byte price: its cap is the planner's flush rows) must fit the dispatch
  budget at the most rows the planner sends.
- ``kernel-cache-key`` — knob dataflow into the kernel caches: a knob
  resolver (a function whose body calls ``resolve_knob``) called inside
  an ``lru_cache``'d factory; a knob-named parameter or resolved knob of
  a function that calls a cached factory but does not pass it into the
  call; a ``shard_fn`` whose cache is neither kept on the checker object
  nor keyed on every knob attribute the checkers stamp.
- ``kernel-host-sync`` — a device sync between a wrapper's entry and its
  launch (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize``, ``int()``/``bool()``/``float()`` of a
  tensor), in the wrapper's launching method or a function of the same
  module it calls.  The wrappers launch without synchronising.
- ``kernel-coverage`` — every ``*_launch`` entry point of the sources has
  a registry entry, and every entry anchors to a wrapper that exists and
  names its entry point.

The reference's ``jaxpr-shape-pin`` and ``jaxpr-retrace`` have no CUDA
counterpart (no lowering to pin, no tracer to re-enter).

The AST half imports nothing it lints; only :func:`measure_budgets`
imports torch and the port, on the card.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .core import (Finding, Pass, Project, SourceFile, _rel_for,
                   cached_walk, dotted_name, function_index, last_name,
                   register)
from .budget import _counts_launches

#: the least bytes the two batches of the allocated slope must differ by
#: for ``kernel-budget`` to hold it to its band: the caching allocator
#: rounds each block up by under 1 MB, so a launch's ten or so blocks move
#: the slope by under 1% of 1 GiB; below it the slope is reported only
ALLOCATED_MIN_SPAN = 1 << 30


class KernelEntry:
    """One entry point of a kernel library: ``launch`` (the C symbol) in
    ``library`` (a key of ``_build.SOURCES``), reached through
    ``wrapper`` (``path:Qualname`` of the Python wrapper), priced by
    ``pricing`` (``path:function``, or None where the cap is not a byte
    price) at ``buckets`` (the shapes the main path gives it; ``kind``
    says how :func:`measure_budgets` builds inputs for them)."""

    __slots__ = ("name", "library", "launch", "wrapper", "pricing", "kind",
                 "buckets")

    def __init__(self, name: str, library: str, launch: str, wrapper: str,
                 pricing: Optional[str], kind: str,
                 buckets: Sequence[dict] = ()):
        self.name, self.library, self.launch = name, library, launch
        self.wrapper, self.pricing, self.kind = wrapper, pricing, kind
        self.buckets = tuple(buckets)


_OPS = "jepsen_tpu_torch/ops/"

#: the frontier rungs: the base capacity 128 and its rung 512 among
#: F 16…512 at C 8, 12 and 16 (phase 8's E 768), and one block-design
#: shape (the sufficient rung past F 1024)
_FRONTIER_BUCKETS = tuple(
    {"F": F, "E": 768, "C": C} for C in (8, 12, 16)
    for F in (16, 32, 64, 128, 256, 512)) + ({"F": 2048, "E": 768, "C": 8},)

#: the classify ladder's list-append profile (``chip_smoke.py`` phase 15)
_SCREEN_MASKS, _SCREEN_NONADJ = (1, 3, 7, 25, 27, 31), ((4, 3), (4, 27))

REGISTRY: Tuple[KernelEntry, ...] = (
    KernelEntry("dense_automaton[register]", "dense_automaton",
                "dense_automaton_launch", _OPS + "dense.py:DenseAutomatonKernel",
                None, "dense",
                ({"spec": "cas-register", "E": 832, "C": 8, "V": 8},
                 {"spec": "owner-mutex", "E": 1024, "C": 12, "V": 12})),
    KernelEntry("dense_automaton[reentrant-mutex]", "dense_automaton",
                "dense_automaton_launch", _OPS + "dense.py:DenseAutomatonKernel",
                None, "dense",
                ({"spec": "reentrant-mutex", "E": 1024, "C": 12, "V": 24},)),
    KernelEntry("dense_automaton[acquired-permits]", "dense_automaton",
                "dense_automaton_launch", _OPS + "dense.py:DenseAutomatonKernel",
                None, "dense",
                ({"spec": "acquired-permits", "E": 1024, "C": 12,
                  "V": (12, 2)},)),
    KernelEntry("dense_automaton[multi-register]", "dense_automaton",
                "dense_automaton_launch", _OPS + "dense.py:DenseAutomatonKernel",
                None, "dense",
                ({"spec": "multi-register", "E": 1024, "C": 8,
                  "V": (11, 2)},)),
    KernelEntry("dense_queue", "dense_automaton", "dense_queue_launch",
                _OPS + "dense.py:DenseQueueKernel", None, "dense",
                ({"spec": "unordered-queue", "E": 64, "C": 8, "V": 0},)),
    KernelEntry("frontier_search", "frontier_search",
                "frontier_search_launch", _OPS + "wgl.py:FrontierSearchKernel",
                _OPS + "wgl.py:frontier_row_bytes", "frontier",
                _FRONTIER_BUCKETS),
    KernelEntry("cycles_has_cycle", "cycles_closure",
                "cycles_has_cycle_launch", _OPS + "cycles.py:HasCycleKernel",
                _OPS + "cycles.py:cycles_row_bytes", "has_cycle",
                tuple({"n": n} for n in (16, 32, 64, 128, 256, 512, 1024))),
    KernelEntry("cycles_screen", "cycles_closure", "cycles_screen_launch",
                _OPS + "cycles.py:ScreenKernel",
                _OPS + "cycles.py:cycles_row_bytes", "screen",
                tuple({"n": n, "masks": _SCREEN_MASKS,
                       "nonadj": _SCREEN_NONADJ}
                      for n in (32, 64, 128, 256, 512))),
    KernelEntry("verdict_stats", "verdict_stats", "verdict_stats_launch",
                "jepsen_tpu_torch/parallel/mesh.py:VerdictStatsKernel", None,
                "stats", ({"rows": 16384}, {"rows": 1 << 20})),
    # the empty kernel at K9's block size: the launch floor the smoke and
    # scripts/stats_ab.py time K9 against; nothing on the main path
    KernelEntry("verdict_stats_empty", "verdict_stats",
                "verdict_stats_empty_launch", "chip_smoke.py:empty_kernel",
                None, "none"),
)


# -- ptxas contracts and reports ------------------------------------------------

_PTXAS_RE = re.compile(r"//\s*jt:\s*ptxas\(([^)]*)\)")
_CLAUSE_RE = re.compile(r"^(regs|spill|smem)<=(\d+)$")
_SELECT_RE = re.compile(r"^(\w+)=(-?\d+)$")
_GLOBAL_RE = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TEMPLATE_RE = re.compile(r"^\s*template\s*<([^>]*)>")
_LAUNCH_RE = re.compile(r"\b(?:int|cudaError_t)\s+(\w+_launch)\s*\(")
_TEMPLATE_ARG_RE = re.compile(r"L[a-z](n?\d+)E")

RESOURCES = ("regs", "spill", "smem")


class PtxasContract:
    """The ``// jt: ptxas(...)`` bounds of one ``__global__`` function:
    ``groups``, in source order, each ``(selector, bounds)``.  A selector
    names template parameters (``{"LOG_W": 3}``) and binds the instances
    whose arguments match it; the group without one binds every other
    instance.  ``params`` are the template's parameter names."""

    __slots__ = ("params", "groups")

    def __init__(self, params: Sequence[str],
                 groups: Sequence[Tuple[Dict[str, int], Dict[str, int]]]):
        self.params = tuple(params)
        self.groups = tuple(groups)

    def bound(self, args: Sequence[int]) -> Optional[Dict[str, int]]:
        """The bounds of the instance with template arguments ``args``:
        the first group whose selector it matches, else the unselected
        group (None when neither exists)."""
        named = dict(zip(self.params, args))
        for sel, bounds in self.groups:
            if sel and all(named.get(k) == v for k, v in sel.items()):
                return bounds
        return next((b for sel, b in self.groups if not sel), None)

    def label(self, args: Sequence[int]) -> str:
        """``LOG_W=3`` for an instance's arguments ('' for none)."""
        return ", ".join(f"{k}={v}" for k, v in zip(self.params, args))

    def __eq__(self, other) -> bool:
        return (isinstance(other, PtxasContract)
                and (self.params, self.groups) == (other.params,
                                                    other.groups))

    def __repr__(self) -> str:
        return f"PtxasContract({self.params!r}, {self.groups!r})"


def parse_ptxas_contract(texts: Sequence[str], params: Sequence[str] = ()
                         ) -> Optional[PtxasContract]:
    """The contract of the ``// jt: ptxas(...)`` comments in ``texts``
    (one or more lines).  Each comment holds ``;``-separated groups, each
    ``[NAME=V, …:] regs<=N, spill<=N, smem<=N`` (clauses optional); an
    unknown clause or a selector naming no template parameter makes the
    contract malformed: None."""
    groups = []
    for text in texts:
        m = _PTXAS_RE.search(text)
        if not m:
            continue
        for group in m.group(1).split(";"):
            sel_text, _, clauses = group.rpartition(":")
            sel: Dict[str, int] = {}
            for item in filter(None, (x.strip().replace(" ", "")
                                      for x in sel_text.split(","))):
                c = _SELECT_RE.match(item)
                if not c or c.group(1) not in params:
                    return None
                sel[c.group(1)] = int(c.group(2))
            bounds: Dict[str, int] = {}
            for clause in clauses.split(","):
                clause = clause.strip().replace(" ", "")
                if not clause:
                    continue
                c = _CLAUSE_RE.match(clause)
                if not c:
                    return None
                bounds[c.group(1)] = int(c.group(2))
            if not bounds:
                return None
            groups.append((sel, bounds))
    return PtxasContract(params, groups) if groups else None


def template_params(line: str) -> Tuple[str, ...]:
    """The parameter names of a ``template <int STEP, int W>`` line."""
    m = _TEMPLATE_RE.match(line)
    if not m:
        return ()
    return tuple(re.findall(r"\w+", piece.split("=")[0])[-1]
                 for piece in m.group(1).split(",") if piece.strip())


def cuda_globals(text: str) -> List[Tuple[str, int, Optional[PtxasContract],
                                          bool]]:
    """Every ``__global__`` function of a CUDA source: ``(name, line,
    contract, annotated)`` — ``contract`` None with ``annotated`` True is
    a malformed annotation.  The contract is read from the ``// jt:
    ptxas(...)`` comments on the declaration's line and in the comment
    block directly above it or above its ``template <...>`` line."""
    lines = text.splitlines()
    out = []
    for m in _GLOBAL_RE.finditer(text):
        line = text.count("\n", 0, m.start()) + 1
        candidates = [lines[line - 1]]
        above = line - 2
        params: Tuple[str, ...] = ()
        if above >= 0 and lines[above].lstrip().startswith("template"):
            params = template_params(lines[above])
            above -= 1
        while above >= 0 and lines[above].lstrip().startswith("//"):
            candidates.append(lines[above])
            above -= 1
        found = [c for c in reversed(candidates) if _PTXAS_RE.search(c)]
        contract = parse_ptxas_contract(found, params) if found else None
        out.append((m.group(1), line, contract, bool(found)))
    return out


_CU_ALLOW_RE = re.compile(r"//\s*jt:.*allow\[([^\]]*)\]")


def cu_allowed(text: str, line: int, rule: str) -> bool:
    """A ``// jt: allow[rule]`` on a CUDA source's ``line``, or on a
    comment line directly above it or above its ``template`` line."""
    lines = text.splitlines()
    candidates = [lines[line - 1]] if 0 < line <= len(lines) else []
    above = line - 2
    while above >= 0 and (lines[above].lstrip().startswith("//")
                          or lines[above].lstrip().startswith("template")):
        candidates.append(lines[above])
        if not lines[above].lstrip().startswith("template"):
            break
        above -= 1
    for c in candidates:
        m = _CU_ALLOW_RE.search(c)
        if m and ({x.strip() for x in m.group(1).split(",")} & {rule, "*"}):
            return True
    return False


def launch_symbols(text: str) -> List[str]:
    """The ``*_launch`` C entry points a CUDA source defines."""
    return sorted(set(_LAUNCH_RE.findall(text)))


def _nested_names(mangled: str) -> Tuple[str, str]:
    """The last length-prefixed name of an Itanium-mangled symbol's
    nested name and what follows it."""
    s = mangled[2:] if mangled.startswith("_Z") else mangled
    if s.startswith("N"):
        s = s[1:]
    last, rest = mangled, ""
    while s and s[0].isdigit():
        digits = re.match(r"\d+", s).group(0)
        n = int(digits)
        s = s[len(digits):]
        last, s = s[:n], s[n:]
        rest = s
    return last, rest


def demangle_base(mangled: str) -> str:
    """The unqualified function name of an Itanium-mangled symbol
    (``_ZN…12empty_kernelEv`` → ``empty_kernel``): the last
    length-prefixed name of its nested name."""
    return _nested_names(mangled)[0]


def template_args(mangled: str) -> Tuple[int, ...]:
    """The integer template arguments of a mangled function instance
    (``…20register_warp_kernelILi3EEEv…`` → ``(3,)``); () for none."""
    rest = _nested_names(mangled)[1]
    args: List[int] = []
    pos = 1 if rest.startswith("I") else len(rest)
    while True:
        m = _TEMPLATE_ARG_RE.match(rest, pos)
        if not m:
            return tuple(args)
        args.append(int(m.group(1).replace("n", "-")))
        pos = m.end()


def parse_ptxas(log: str) -> List[dict]:
    """One row per entry function of an ``nvcc -Xptxas=-v`` report:
    ``{"mangled", "function", "args", "regs", "spill_store",
    "spill_load", "spill", "smem", "stack"}`` (``args`` its template
    arguments, ``spill`` the larger of the two spill counts)."""
    rows = []
    for part in log.split("Compiling entry function '")[1:]:
        mangled, _, body = part.partition("'")
        body = body.split("Compiling entry function")[0]

        def num(pattern):
            m = re.search(pattern, body)
            return int(m.group(1)) if m else 0

        store = num(r"(\d+) bytes spill stores")
        load = num(r"(\d+) bytes spill loads")
        rows.append({
            "mangled": mangled, "function": demangle_base(mangled),
            "args": template_args(mangled),
            "regs": num(r"Used (\d+) registers"), "spill_store": store,
            "spill_load": load, "spill": max(store, load),
            "smem": num(r"(\d+) bytes smem"),
            "stack": num(r"(\d+) bytes stack frame")})
    return rows


def ptxas_table(logs: Dict[str, str],
                contracts: Optional[Dict[str, PtxasContract]] = None
                ) -> List[dict]:
    """One row per library and entry-function instance: ``{"library",
    "function", "instance", "regs", "spill_store", "spill_load",
    "smem", "bound"}``, ``instance`` its template arguments (named after
    the contract's parameters where ``contracts`` has the function) and
    ``bound`` the contract's bounds for it (None without one)."""
    out = []
    for lib in sorted(logs):
        rows = sorted(parse_ptxas(logs[lib]),
                      key=lambda r: (r["function"], r["args"]))
        for r in rows:
            contract = (contracts or {}).get(r["function"])
            out.append({
                "library": lib, "function": r["function"],
                "instance": (contract.label(r["args"]) if contract
                             else ", ".join(map(str, r["args"]))),
                **{k: r[k] for k in ("regs", "spill_store", "spill_load",
                                     "smem")},
                "bound": contract.bound(r["args"]) if contract else None})
    return out


# -- the source tree -----------------------------------------------------------


def _module_constant(tree: ast.Module, name: str):
    for node in tree.body:
        if (isinstance(node, (ast.Assign, ast.AnnAssign))
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in (node.targets if isinstance(node, ast.Assign)
                                  else [node.target]))):
            return node.value
    return None


class _Tree:
    """What the audit reads of the tree: the sources and build flags of
    ``ops/_build.py`` (by AST, not import), the repository root, and the
    kept ptxas logs."""

    def __init__(self, project: Project):
        opts = project.options
        self.build_sf = project.file_named("jepsen_tpu_torch/ops/_build.py")
        self.root: Optional[str] = opts.get("kernel_root")
        if self.root is None and self.build_sf is not None:
            self.root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(self.build_sf.path))))
        self.sources: Dict[str, str] = dict(opts.get("kernel_sources") or {})
        self.flags: Tuple[str, ...] = ()
        if not self.sources and self.build_sf is not None:
            self._read_build()

    def _read_build(self) -> None:
        tree = self.build_sf.tree
        csrc = os.path.join(os.path.dirname(self.build_sf.path), "csrc")
        sources = _module_constant(tree, "SOURCES")
        if isinstance(sources, ast.Dict):
            for k, v in zip(sources.keys, sources.values):
                consts = [n.value for n in cached_walk(v)
                          if isinstance(n, ast.Constant)
                          and isinstance(n.value, str)]
                if isinstance(k, ast.Constant) and consts:
                    self.sources[k.value] = os.path.join(csrc, consts[-1])
        flags = _module_constant(tree, "NVCC_FLAGS")
        if isinstance(flags, ast.Tuple):
            self.flags = tuple(e.value for e in flags.elts
                               if isinstance(e, ast.Constant))

    def text(self, lib: str) -> Optional[str]:
        path = self.sources.get(lib)
        if path is None or not os.path.exists(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            return f.read()

    def rel(self, path: str) -> str:
        if self.root:
            r = os.path.relpath(os.path.abspath(path), self.root)
            if not r.startswith(".."):
                return r.replace(os.sep, "/")
        return path.replace(os.sep, "/")

    def kept_log(self, lib: str) -> Optional[str]:
        """The ptxas log ``ops/_build.py`` kept beside the current build
        of ``lib`` (same digest as ``_build.library_path``)."""
        if self.root is None or not self.flags:
            return None
        with open(self.sources[lib], "rb") as f:
            digest = hashlib.sha256(
                f.read() + "\0".join(self.flags).encode()).hexdigest()[:16]
        path = os.path.join(self.root, "build", "kernels",
                            f"lib{lib}-{digest}.ptxas.txt")
        if not os.path.exists(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            return f.read()


# -- the pass ------------------------------------------------------------------

#: knob-named parameters (the tuner's knobs and the closure mode, the
#: one that shapes a kernel) and the attribute names they are stamped as
KNOB_PARAMS = ("mode", "closure_mode", "window", "flush_rows", "row_bucket")

_BAND = r"([0-9.]+)\.\.([0-9.]+)"
_BUDGET_RE = re.compile(r"budget\(" + _BAND + r"(?:,\s*allocated=" + _BAND
                        + r")?\)")
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy", "synchronize")
_REDUCTIONS = ("sum", "max", "min", "any", "all", "amax", "amin",
               "count_nonzero", "nonzero", "argmax", "argmin", "aminmax")
_NOT_TENSORS = ("torch.device", "torch.dtype", "torch.Size")


def budget_band(sf: SourceFile, fn: ast.AST) -> Optional[dict]:
    """The ``# jt: budget(LO..HI, allocated=LO..HI)`` bands on a
    function's signature lines (or the comment line above it):
    ``{"requested": (lo, hi), "allocated": (lo, hi) or None}``."""
    end = fn.body[0].lineno if fn.body else fn.lineno + 1
    for line in range(fn.lineno, max(fn.lineno + 1, end)):
        for d in sf.directives_at(line):
            m = _BUDGET_RE.search(d)
            if m:
                g = m.groups()
                return {"requested": (float(g[0]), float(g[1])),
                        "allocated": (None if g[2] is None
                                      else (float(g[2]), float(g[3])))}
    return None


class KernelAudit(Pass):
    name = "kernel-audit"
    rules = ("kernel-budget", "kernel-cache-key", "kernel-coverage",
             "kernel-host-sync", "kernel-resources")

    def run(self, project: Project) -> List[Finding]:
        out: List[Finding] = []
        registry = project.options.get("kernel_registry", REGISTRY)
        tree = _Tree(project)
        self._cache_keys(project, out)
        self._host_sync(project, out)
        self._coverage(project, tree, registry, out)
        self._budget_contracts(project, tree, registry, out)
        self._resources(project, tree, out)
        return out

    def _emit(self, out: List[Finding], sf: Optional[SourceFile], rel: str,
              rule: str, line: int, scope: str, msg: str) -> None:
        if sf is None or not sf.allowed(line, rule):
            out.append(Finding(rule, rel, line, 0, msg, scope))

    # -- kernel-cache-key ------------------------------------------------------

    def _cache_keys(self, project: Project, out: List[Finding]) -> None:
        files = [sf for sf in project.files if sf.tree is not None]
        resolvers = set()
        #: cached factory name -> (file, scope, the body its key covers)
        cached: Dict[str, Tuple[SourceFile, str, ast.AST]] = {}
        for sf in files:
            idx = function_index(sf)
            for q, fn in idx.funcs.items():
                if any(isinstance(n, ast.Call)
                       and last_name(n.func) == "resolve_knob"
                       for n in cached_walk(fn)):
                    resolvers.add(fn.name)
                if _is_cached(fn):
                    cached[fn.name] = (sf, q, fn)
            for node in sf.tree.body:
                wrapped = _cache_wrapped(node)
                if wrapped is None:
                    continue
                target, inner = wrapped
                body = idx.funcs.get(inner)
                if body is None and inner in idx.classes:
                    body = next((m for m in idx.classes[inner].body
                                 if isinstance(m, ast.FunctionDef)
                                 and m.name == "__init__"), None)
                if body is not None:
                    cached[target] = (sf, f"{inner}", body)
        resolvers.discard("resolve_knob")
        for name, (sf, q, body) in sorted(cached.items()):
            for n in cached_walk(body):
                if isinstance(n, ast.Call) and last_name(n.func) in resolvers:
                    self._emit(
                        out, sf, sf.rel, "kernel-cache-key", n.lineno, q,
                        f"knob resolver `{last_name(n.func)}()` runs inside"
                        f" the body of cached factory `{name}`: the resolved"
                        " value bypasses the cache key, so a knob change"
                        " returns a stale kernel; resolve in the caller and"
                        " pass it as a parameter")
        bodies = {id(body) for _, _, body in cached.values()}
        stamped = set()
        shard_fns = []
        for sf in files:
            idx = function_index(sf)
            for q, fn in idx.funcs.items():
                stamped |= _knob_stamps(fn)
                if fn.name == "shard_fn":
                    shard_fns.append((sf, fn, q))
                if id(fn) not in bodies:
                    self._reaches_factory(sf, fn, q, resolvers, cached, out)
        for sf, fn, q in shard_fns:
            self._shard_key(sf, fn, q, stamped, out)

    def _reaches_factory(self, sf, fn, q, resolvers, cached, out) -> None:
        calls = [n for n in cached_walk(fn) if isinstance(n, ast.Call)
                 and last_name(n.func) in cached]
        if not calls:
            return
        passed = set()
        direct = set()
        for call in calls:
            for a in list(call.args) + [k.value for k in call.keywords]:
                for n in cached_walk(a):
                    if isinstance(n, ast.Name):
                        passed.add(n.id)
                    elif isinstance(n, ast.Call):
                        direct.add(id(n))
        params = [a.arg for a in fn.args.args + fn.args.kwonlyargs]
        for p in params:
            if p in KNOB_PARAMS and p not in passed:
                self._emit(out, sf, sf.rel, "kernel-cache-key", fn.lineno, q,
                           f"`{q}` takes knob `{p}` and calls a cached kernel"
                           " factory without passing it: the factory's lru"
                           " key cannot see this knob")
        bound: Dict[int, str] = {}
        for n in cached_walk(fn):
            if (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)):
                bound[id(n.value)] = n.targets[0].id
        for n in cached_walk(fn):
            if not (isinstance(n, ast.Call) and last_name(n.func) in resolvers):
                continue
            if id(n) in direct or bound.get(id(n)) in passed:
                continue
            self._emit(out, sf, sf.rel, "kernel-cache-key", n.lineno, q,
                       f"`{q}` resolves `{last_name(n.func)}()` and calls a"
                       " cached kernel factory, but the resolved value is not"
                       " passed into the call: the factory's lru key cannot"
                       " see this knob")

    def _shard_key(self, sf, fn, q, stamped, out) -> None:
        args = [a.arg for a in fn.args.args]
        checker = args[0] if args else None
        on_checker = any(
            (isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name) and t.value.id == checker
                for t in n.targets))
            or (isinstance(n, ast.Call) and last_name(n.func) == "setattr"
                and n.args and isinstance(n.args[0], ast.Name)
                and n.args[0].id == checker)
            for n in cached_walk(fn))
        if on_checker:
            return  # keyed by the checker object itself: as wide as its key
        read = set()
        names = set()
        for n in cached_walk(fn):
            if (isinstance(n, ast.Call) and last_name(n.func) == "getattr"
                    and len(n.args) >= 2
                    and isinstance(n.args[1], ast.Constant)):
                read.add(n.args[1].value)
            if (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                    and n.value.id == checker):
                read.add(n.attr)
            if isinstance(n, ast.Call) and last_name(n.func) == "id" and \
                    n.args and isinstance(n.args[0], ast.Name):
                names.add(n.args[0].id)
        if checker in names:
            return  # keyed by the checker's identity
        for attr in sorted(stamped - read):
            self._emit(out, sf, sf.rel, "kernel-cache-key", fn.lineno, q,
                       f"kernel checkers carry knob `{attr}` but `{q}`'s"
                       " cache neither lives on the checker nor reads it"
                       " back into its key: two knob states would share one"
                       " sharded checker")
        if not stamped and not read:
            self._emit(out, sf, sf.rel, "kernel-cache-key", fn.lineno, q,
                       f"`{q}` caches sharded checkers on a key that names"
                       " neither the checker object nor its fields: checkers"
                       " of different shapes would share one entry")

    # -- kernel-host-sync ------------------------------------------------------

    def _host_sync(self, project: Project, out: List[Finding]) -> None:
        for sf in project.files:
            if sf.tree is None:
                continue
            idx = function_index(sf)
            module_fns = {fn.name: fn for q, fn in idx.funcs.items()
                          if idx.parents.get(q) is None}
            for cq, cls in idx.classes.items():
                if not _counts_launches(cls):
                    continue
                for meth in cls.body:
                    if not isinstance(meth, ast.FunctionDef):
                        continue
                    launch = _launch_line(meth)
                    if launch is None:
                        continue
                    scope = f"{cq}.{meth.name}"
                    self._syncs(sf, meth, scope, launch, out)
                    seen = set()
                    todo = _callees(meth, launch, module_fns)
                    while todo:
                        name = todo.pop()
                        if name in seen:
                            continue
                        seen.add(name)
                        callee = module_fns[name]
                        self._syncs(sf, callee, name, None, out,
                                    via=scope)
                        todo.extend(_callees(callee, None, module_fns))

    def _syncs(self, sf, fn, scope, before: Optional[int], out,
               via: Optional[str] = None) -> None:
        tensors = _tensor_names(fn)
        for n in cached_walk(fn):
            if not isinstance(n, ast.Call):
                continue
            if before is not None and n.lineno >= before:
                continue
            what = None
            if isinstance(n.func, ast.Attribute) and \
                    n.func.attr in _SYNC_METHODS:
                what = f".{n.func.attr}()"
            elif (isinstance(n.func, ast.Name)
                  and n.func.id in ("int", "bool", "float") and n.args
                  and _tensorish(n.args[0], tensors)):
                what = f"{n.func.id}() of a tensor"
            if what is None:
                continue
            where = f" (called by `{via}`)" if via else ""
            self._emit(out, sf, sf.rel, "kernel-host-sync", n.lineno, scope,
                       f"{what} in `{scope}`{where} syncs the device before"
                       " the launch: a wrapper launches"
                       " without synchronising; validate on the host arrays"
                       " before the copy")

    # -- kernel-coverage -------------------------------------------------------

    def _coverage(self, project, tree: _Tree, registry, out) -> None:
        if not tree.sources:
            return
        launches = {e.launch for e in registry}
        for lib in sorted(tree.sources):
            text = tree.text(lib)
            if text is None:
                continue
            for sym in launch_symbols(text):
                line = text[:text.find(sym)].count("\n") + 1
                if sym not in launches and not cu_allowed(
                        text, line, "kernel-coverage"):
                    self._emit(out, None, tree.rel(tree.sources[lib]),
                               "kernel-coverage", line, sym,
                               f"entry point `{sym}` of {lib} has no kernel"
                               " audit registry entry: its footprint and"
                               " resources ship unchecked")
        if tree.root is None:
            return
        build_rel = _rel_for(__file__)
        for e in registry:
            path, _, qual = e.wrapper.partition(":")
            full = os.path.join(tree.root, path)
            node = None
            if os.path.exists(full):
                sf = project.file_named(path)
                if sf is None:
                    with open(full, "r", encoding="utf-8") as f:
                        sf = SourceFile(full, path, f.read())
                if sf.tree is not None:
                    idx = function_index(sf)
                    node = idx.classes.get(qual) or idx.funcs.get(qual)
            if node is None:
                self._emit(out, None, build_rel, "kernel-coverage", 1,
                           e.name, f"registry entry `{e.name}` anchors to"
                           f" `{e.wrapper}`, which does not exist")
            elif not any(isinstance(n, ast.Attribute) and n.attr == e.launch
                         for n in cached_walk(node)):
                self._emit(out, None, build_rel, "kernel-coverage", 1,
                           e.name, f"wrapper `{e.wrapper}` of registry entry"
                           f" `{e.name}` never reaches `{e.launch}`")

    # -- kernel-budget (the CPU half: the contracts) -----------------------------

    def _budget_contracts(self, project, tree: _Tree, registry, out) -> None:
        if tree.root is None:
            return
        for pricing in sorted({e.pricing for e in registry
                               if e.pricing is not None}):
            e = next(x for x in registry if x.pricing == pricing)
            path, _, fname = e.pricing.partition(":")
            sf = project.file_named(path)
            if sf is None or sf.tree is None:
                continue  # a subset run: the pricing's file is not scanned
            fn = function_index(sf).funcs.get(fname)
            if fn is None:
                self._emit(out, None, sf.rel, "kernel-budget", 1, e.name,
                           f"registry entry `{e.name}` is priced by"
                           f" `{e.pricing}`, which does not exist")
            else:
                band = budget_band(sf, fn)
                if band is None or band["allocated"] is None:
                    self._emit(out, sf, sf.rel, "kernel-budget", fn.lineno,
                               fname, f"pricing function `{fname}` declares"
                               " no `# jt: budget(LO..HI, allocated=LO..HI)`"
                               " bands for its measured bytes per row")
        project.notes.append(
            "kernel-budget: measured bytes per row skipped (the card half,"
            " run by chip_smoke.py phase 28); registry and bands checked")

    # -- kernel-resources --------------------------------------------------------

    def _resources(self, project, tree: _Tree, out) -> None:
        if not tree.sources:
            return
        logs: Dict[str, str] = dict(project.options.get("ptxas_logs") or {})
        missing = [lib for lib in sorted(tree.sources) if lib not in logs]
        for lib in missing:
            log = tree.kept_log(lib)
            if log is not None:
                logs[lib] = log
        missing = [lib for lib in missing if lib not in logs]
        if missing:
            project.notes.append(
                "kernel-resources: ptxas report skipped for "
                f"{', '.join(missing)} (no ptxas log kept under "
                "build/kernels: ops/_build.py keeps one when it builds with "
                "nvcc); the bounds were parsed")
        for lib in sorted(tree.sources):
            text = tree.text(lib)
            if text is None:
                continue
            rel = tree.rel(tree.sources[lib])
            rows = parse_ptxas(logs[lib]) if lib in logs else []
            for name, line, contract, annotated in cuda_globals(text):
                if cu_allowed(text, line, "kernel-resources"):
                    continue
                if contract is None:
                    self._emit(out, None, rel, "kernel-resources", line, name,
                               f"__global__ `{name}` has "
                               + ("a malformed" if annotated else "no")
                               + " `// jt: ptxas(regs<=…, spill<=…, smem<=…)`"
                               " bound")
                    continue
                for r in rows:
                    if r["function"] != name:
                        continue
                    bound = contract.bound(r["args"])
                    which = contract.label(r["args"]) or "its only instance"
                    if bound is None:
                        self._emit(out, None, rel, "kernel-resources", line,
                                   name, f"`{r['mangled']}` ({which}) matches"
                                   " no selector of its bound and the bound"
                                   " has no group without one")
                        continue
                    over = [f"{k} {r[k]} > {bound[k]}" for k in RESOURCES
                            if k in bound and r[k] > bound[k]]
                    if over:
                        self._emit(out, None, rel, "kernel-resources", line,
                                   name, f"`{r['mangled']}` ({which}) exceeds"
                                   f" its declared bound: {', '.join(over)}")


# -- AST helpers -----------------------------------------------------------------

_CACHE_NAMES = ("lru_cache", "cache")


def _is_cached(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        if last_name(target) in _CACHE_NAMES:
            return True
    return False


def _cache_wrapped(node: ast.AST) -> Optional[Tuple[str, str]]:
    """``name = lru_cache(...)(inner)`` at module level → (name, inner)."""
    if (isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Call)
            and last_name(node.value.func.func) in _CACHE_NAMES
            and node.value.args):
        return node.targets[0].id, last_name(node.value.args[0])
    return None


def _knob_stamps(fn: ast.AST) -> set:
    """Knob attributes stamped on objects in ``fn`` (``self.mode = …`` in
    a checker's ``__init__``, ``fn.closure_mode = …`` in a factory)."""
    out = set()
    for n in cached_walk(fn):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Attribute) and t.attr in KNOB_PARAMS:
                    out.add(t.attr)
    return out


def _launch_line(meth: ast.AST) -> Optional[int]:
    for n in cached_walk(meth):
        if (isinstance(n, ast.AugAssign) and isinstance(n.target, ast.Attribute)
                and n.target.attr == "launches"):
            return n.lineno
    return None


def _callees(fn: ast.AST, before: Optional[int], module_fns) -> List[str]:
    out = []
    for n in cached_walk(fn):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id in module_fns
                and (before is None or n.lineno < before)):
            out.append(n.func.id)
    return out


def _tensor_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func) or ""
    if name.startswith("torch.") and not name.startswith("torch.cuda.") \
            and name not in _NOT_TENSORS:
        return True
    return isinstance(node.func, ast.Attribute) and \
        node.func.attr in _REDUCTIONS


def _tensorish(node: ast.AST, tensors: set) -> bool:
    for n in cached_walk(node):
        if _tensor_call(n):
            return True
        if isinstance(n, ast.Name) and n.id in tensors:
            return True
    return False


def _targets(t: ast.AST) -> Iterable[str]:
    for n in cached_walk(t):
        if isinstance(n, ast.Name):
            yield n.id


def _tensor_names(fn: ast.AST) -> set:
    """Names bound in ``fn`` to a tensor-valued expression (a ``torch.*``
    call or a reduction), or iterating one (``for x in torch.aminmax(t)``
    and comprehension targets)."""
    names: set = set()
    for _ in range(2):
        for n in cached_walk(fn):
            if isinstance(n, ast.Assign) and _tensorish(n.value, names):
                for t in n.targets:
                    names.update(_targets(t))
            elif isinstance(n, (ast.For, ast.comprehension)) and \
                    _tensorish(n.iter, names):
                names.update(_targets(n.target))
    return names


register(KernelAudit())


# -- the card half -------------------------------------------------------------


def _bucket_label(bucket: dict) -> str:
    return ", ".join(f"{k}={v}" for k, v in bucket.items()
                     if k not in ("masks", "nonadj"))


def measure_budgets(device, registry: Sequence[KernelEntry] = REGISTRY,
                    rows: Tuple[int, int] = (256, 512)) -> Tuple[List[dict],
                                                                 List[Finding]]:
    """The card half of ``kernel-budget``: every registry entry launched
    at each of its buckets on ``device`` (a CUDA device), the per-row
    bytes measured as the slope of the allocator's peak between two batch
    sizes, the peak reset before each.  The requested bytes
    (``requested_bytes.all.peak``: the tensors' own sizes) are measured
    at ``rows``; the allocated bytes (``max_memory_allocated()``: the
    caching allocator's blocks, which round a large request up) at half
    and all of the rows a dispatch may take (the pricing's cap, or the
    planner's flush rows for a dense entry), and held to its band where
    the two differ by :data:`ALLOCATED_MIN_SPAN` bytes or more.  Returns one row per (entry, bucket) — measured and
    priced bytes per row, the ratios, the bands — and the findings."""
    import torch

    from ..ops import cycles, dense, wgl
    from ..ops import _build
    from ..parallel import mesh as mesh_mod
    from ..engine import planning

    budget = min(wgl.FRONTIER_DISPATCH_BUDGET, cycles.CYCLES_DISPATCH_BUDGET)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    bands: Dict[str, dict] = {}
    for e in registry:
        if e.pricing is None:
            continue
        path, _, fname = e.pricing.partition(":")
        full = os.path.join(repo, path)
        with open(full, "r", encoding="utf-8") as f:
            sf = SourceFile(full, path, f.read())
        band = budget_band(sf, function_index(sf).funcs[fname]) or {}
        bands[e.name] = {"requested": band.get("requested") or (0.0, 0.0),
                         "allocated": band.get("allocated") or (0.0, 0.0)}

    def dense_inputs(b, B):
        E, C = b["E"], b["C"]
        return (torch.zeros((B,), dtype=torch.int32, device=device),
                torch.full((B, E), -1, dtype=torch.int32, device=device),
                torch.full((B, E, C), -1, dtype=torch.int8, device=device),
                torch.zeros((B, E, C), dtype=torch.int8, device=device),
                torch.zeros((B, E, C), dtype=torch.int16, device=device),
                torch.zeros((B, E, C), dtype=torch.int16, device=device))

    # the launches below are the measurement itself: one bucket at two
    # batch sizes, neither above its cap
    def launch(e, b, B):
        if e.kind == "dense":
            checker = dense.make_dense_fn(b["spec"], b["E"], b["C"], b["V"],
                                          device)
            return checker(*dense_inputs(b, B))  # jt: allow[budget-direct-dispatch]
        if e.kind == "frontier":
            return wgl.FRONTIER_SEARCH(  # jt: allow[budget-direct-dispatch]
                *dense_inputs(b, B), spec_name="cas-register", F=b["F"],
                max_closure=b["C"] + 1)
        if e.kind == "has_cycle":
            adj = torch.zeros((B, b["n"], b["n"]), dtype=torch.uint8,
                              device=device)
            return cycles.HAS_CYCLE(adj)  # jt: allow[budget-direct-dispatch]
        if e.kind == "screen":
            rel = torch.zeros((B, b["n"], b["n"]), dtype=torch.uint8,
                              device=device)
            return cycles.SCREEN(  # jt: allow[budget-direct-dispatch]
                rel, b["masks"], b["nonadj"])
        if e.kind == "stats":
            ok = torch.ones((B,), dtype=torch.bool, device=device)
            return mesh_mod.VERDICT_STATS(  # jt: allow[budget-direct-dispatch]
                ok, torch.zeros_like(ok))
        raise ValueError(e.kind)

    def held(e, b, B) -> Tuple[int, int]:
        """Peak bytes one launch at ``B`` rows holds above what was held
        before it: requested (the tensors' own sizes) and allocated (the
        caching allocator's blocks)."""
        torch.cuda.synchronize(device)
        stats = torch.cuda.memory_stats(device)
        base_req = stats.get("requested_bytes.all.current", 0)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        outs = launch(e, b, B)
        torch.cuda.synchronize(device)
        stats = torch.cuda.memory_stats(device)
        peak = torch.cuda.max_memory_allocated(device) - base
        del outs
        return stats.get("requested_bytes.all.peak", 0) - base_req, peak

    def slopes(e, b, lo, hi) -> Tuple[float, float]:
        (q2, a2), (q1, a1) = held(e, b, hi), held(e, b, lo)
        return (q2 - q1) / (hi - lo), (a2 - a1) / (hi - lo)

    def priced(e, b) -> Optional[int]:
        if e.kind == "frontier":
            return wgl.frontier_row_bytes(b["F"], b["E"], b["C"])
        if e.kind == "has_cycle":
            return cycles.cycles_row_bytes(b["n"], 1, 0)
        if e.kind == "screen":
            return cycles.cycles_row_bytes(b["n"], len(b["masks"]),
                                           len(b["nonadj"]))
        return None

    def check(label, e, what, per_row, price, row) -> None:
        lo, hi = bands[e.name][what]
        ratio = per_row / price
        row.update({f"{what}_ratio": ratio, f"{what}_band": [lo, hi]})
        if not lo <= ratio <= hi:
            findings.append(Finding(
                "kernel-budget", e.pricing.partition(":")[0], 0, 0,
                f"{label} holds {per_row:.1f} {what} bytes a row,"
                f" {ratio:.4f} × its pricing ({price} B), outside the"
                f" declared band {lo}..{hi}", e.name))

    lib_ws = None
    table: List[dict] = []
    findings: List[Finding] = []
    for e in registry:
        for b in e.buckets:
            r1, r2 = rows
            if e.kind == "stats":
                r1, r2 = b["rows"], 2 * b["rows"]
            elif e.kind == "frontier" and wgl.frontier_design(
                    b["F"], b["C"]) == "block":
                r1, r2 = 32, 64
            held(e, b, r1)  # warm: build, load, first-use allocations
            per_row, alloc = slopes(e, b, r1, r2)
            price = priced(e, b)
            cap = None
            if e.kind == "frontier":
                cap = wgl.frontier_max_dispatch(b["F"], b["E"], b["C"])
            elif e.kind in ("has_cycle", "screen"):
                cap = cycles.cycles_max_dispatch(
                    b["n"], len(b.get("masks", (0,))),
                    len(b.get("nonadj", ())))
            elif e.kind == "dense":
                cap = min(planning.DEFAULT_FLUSH_ROWS,
                          dense.make_dense_fn(b["spec"], b["E"], b["C"],
                                              b["V"], device).safe_dispatch)
            if cap is not None and cap >= 2:
                r1, r2 = cap // 2, cap
                torch.cuda.empty_cache()
                alloc = slopes(e, b, r1, r2)[1]
                torch.cuda.empty_cache()
            span = alloc * (r2 - r1)
            row = {"entry": e.name, "bucket": _bucket_label(b),
                   "measured_bytes_per_row": per_row,
                   "allocated_bytes_per_row": alloc,
                   "allocated_rows": [r1, r2],
                   "allocated_held": (price is not None
                                      and span >= ALLOCATED_MIN_SPAN)}
            label = f"kernel `{e.name}` at [{row['bucket']}]"
            if price is not None:
                row.update(priced_bytes_per_row=price,
                           allocated_ratio=alloc / price)
                check(label, e, "requested", per_row, price, row)
                if row["allocated_held"]:
                    check(label, e, "allocated", alloc, price, row)
            if e.kind == "frontier":
                if lib_ws is None:
                    lib_ws = _build.load("frontier_search") \
                        .frontier_search_workspace_bytes
                    import ctypes
                    lib_ws.argtypes = [ctypes.c_int, ctypes.c_int]
                    lib_ws.restype = ctypes.c_longlong
                ws = int(lib_ws(b["F"], b["C"]))
                term = wgl.frontier_workspace_bytes(b["F"], b["C"])
                row.update(library_workspace=ws, priced_workspace=term,
                           design=wgl.frontier_design(b["F"], b["C"]))
                if ws != term:
                    findings.append(Finding(
                        "kernel-budget", "jepsen_tpu_torch/ops/wgl.py", 0, 0,
                        f"{label}: the library allocates {ws} workspace bytes"
                        f" a row, the pricing's workspace term says {term}",
                        e.name))
            if e.kind == "dense":
                held_bytes = max(per_row, alloc) * cap
                row.update(max_rows=cap, dispatch_bytes=held_bytes,
                           budget=budget)
                if held_bytes > budget:
                    findings.append(Finding(
                        "kernel-budget", "jepsen_tpu_torch/ops/dense.py", 0,
                        0, f"{label}: {cap} rows × {max(per_row, alloc):.1f}"
                        f" bytes exceed the {budget}-byte dispatch budget",
                        e.name))
            table.append(row)
    return table, findings
