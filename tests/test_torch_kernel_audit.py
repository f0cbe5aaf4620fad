"""The kernel audit (``jepsen_tpu_torch/lint/kernel_audit.py``) on the CPU.

Every rule fires, passes clean and is suppressed on ``tmp_path`` fixture
trees in the style of ``tests/test_lint_jaxpr.py``: a toy ``ops/_build.py``
with its ``SOURCES``, a toy CUDA source with ``// jt: ptxas(...)`` bounds,
a toy wrapper, a recorded ptxas report.  The ptxas parser runs on a
recorded log of the card's build.  The measured half of ``kernel-budget``
runs on the card (``chip_smoke.py`` phase 28) and is not exercised here;
its registry, bands and the frontier pricing it holds are.
"""

import stat
import sys
import textwrap

import numpy as np
import pytest
import torch

from jepsen_tpu.ops import dense as ref_dense
from jepsen_tpu_torch import models
from jepsen_tpu_torch.lint import core, kernel_audit as ka
from jepsen_tpu_torch.ops import _build, dense, encode, step_kernels, wgl

#: recorded from ``nvcc -Xptxas=-v`` on the card's build of
#: ``verdict_stats.cu`` and one ``cycles_closure.cu`` instance
RECORDED_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__8a8bddfd_16_verdict_stats_cu_0651c1ac12empty_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__8a8bddfd_16_verdict_stats_cu_0651c1ac12empty_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 4 registers, used 0 barriers
ptxas info    : Compile time = 2.570 ms
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__8a8bddfd_16_verdict_stats_cu_0651c1ac20verdict_stats_kernelEPKhS1_xPx' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__8a8bddfd_16_verdict_stats_cu_0651c1ac20verdict_stats_kernelEPKhS1_xPx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 257 bytes smem
ptxas info    : Compile time = 67.651 ms
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__601b3001_17_cycles_closure_cu_8efb211b13screen_kernelILi16EEEvPKhPhS3_PiNS_7ProfileEiiiS4_ib' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__601b3001_17_cycles_closure_cu_8efb211b13screen_kernelILi16EEEvPKhPhS3_PiNS_7ProfileEiiiS4_ib
    136 bytes stack frame, 188 bytes spill stores, 312 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 136 bytes cumulative stack size, 208 bytes smem
ptxas info    : Compile time = 221.107 ms
"""


def test_ptxas_parser_on_a_recorded_log():
    rows = ka.parse_ptxas(RECORDED_LOG)
    assert [r["function"] for r in rows] == [
        "empty_kernel", "verdict_stats_kernel", "screen_kernel"]
    assert (rows[0]["regs"], rows[0]["smem"], rows[0]["spill"]) == (4, 0, 0)
    assert (rows[1]["regs"], rows[1]["smem"]) == (32, 257)
    screen = rows[2]
    assert (screen["regs"], screen["spill_store"], screen["spill_load"],
            screen["spill"], screen["smem"], screen["stack"]) == (
        40, 188, 312, 312, 208, 136)
    assert [r["args"] for r in rows] == [(), (), (16,)]
    table = ka.ptxas_table({"verdict_stats": RECORDED_LOG})
    assert [(r["function"], r["instance"], r["bound"]) for r in table] == [
        ("empty_kernel", "", None), ("screen_kernel", "16", None),
        ("verdict_stats_kernel", "", None)]
    contract = ka.PtxasContract(("W",), [({"W": 16}, {"spill": 312}),
                                         ({}, {"spill": 360})])
    (_, screen_row, _) = ka.ptxas_table({"verdict_stats": RECORDED_LOG},
                                        {"screen_kernel": contract})
    assert (screen_row["instance"], screen_row["bound"]) == (
        "W=16", {"spill": 312})


@pytest.mark.parametrize("mangled, args", [
    ("_ZN12_GLOBAL__N_120register_warp_kernelILi3EEEvPKi", (3,)),
    ("_ZN7anon_ns20frontier_warp_kernelILi1ELi2EEEvPKi", (1, 2)),
    ("_Z3fooILin2ELb1EEvv", (-2, 1)),
    ("_Z13rounds_kernelPiiPKiiii", ()),
])
def test_template_args(mangled, args):
    assert ka.template_args(mangled) == args


@pytest.mark.parametrize("mangled, name", [
    ("_ZN12_GLOBAL__N_120register_warp_kernelILi3EEEvPKi", "register_warp_kernel"),
    ("_Z13rounds_kernelPiiPKiiii", "rounds_kernel"),
    ("_ZN49_GLOBAL__N__8a8bddfd_16_verdict_stats_cu_0651c1ac12empty_kernelEv",
     "empty_kernel"),
])
def test_demangle_base(mangled, name):
    assert ka.demangle_base(mangled) == name


def test_cuda_globals_read_contracts_beside_templates():
    text = textwrap.dedent("""\
        // jt: ptxas(regs<=64, spill<=8, smem<=512)
        template <int N>
        __global__ void __launch_bounds__(256, 2)
        tmpl_kernel(int* x) {}
        __global__ void plain_kernel(int* x) {}  // jt: ptxas(regs<=32)
        // jt: ptxas(regs<=oops)
        __global__ void bad_kernel(int* x) {}
        // The main path's instance first:
        // jt: ptxas(STEP=1, W=1: regs<=48, spill<=58; W=2: regs<=50)
        // jt: ptxas(regs<=56, spill<=62)
        template <int STEP, int W>
        __global__ void sel_kernel(int* x) {}
        // jt: ptxas(V=1: regs<=8)
        template <int N>
        __global__ void unknown_param_kernel(int* x) {}
        extern "C" int toy_launch(void* s) { return 0; }
        """)
    got = ka.cuda_globals(text)
    assert got[:3] == [
        ("tmpl_kernel", 3, ka.PtxasContract(
            ("N",), [({}, {"regs": 64, "spill": 8, "smem": 512})]), True),
        ("plain_kernel", 5, ka.PtxasContract((), [({}, {"regs": 32})]),
         True),
        ("bad_kernel", 7, None, True)]
    name, line, sel, annotated = got[3]
    assert (name, line, annotated) == ("sel_kernel", 12, True)
    assert sel.params == ("STEP", "W")
    assert sel.bound((1, 1)) == {"regs": 48, "spill": 58}
    assert sel.bound((3, 2)) == {"regs": 50}
    assert sel.bound((3, 1)) == {"regs": 56, "spill": 62}
    assert sel.label((1, 1)) == "STEP=1, W=1"
    assert got[4] == ("unknown_param_kernel", 15, None, True)
    only = ka.parse_ptxas_contract(["// jt: ptxas(N=1: regs<=8)"], ("N",))
    assert only.bound((1,)) == {"regs": 8} and only.bound((2,)) is None
    assert ka.launch_symbols(text) == ["toy_launch"]


# ---------------------------------------------------------------------------
# fixture trees
# ---------------------------------------------------------------------------

BUILD = """
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"toy": CSRC / "toy.cu"}
NVCC_FLAGS = ("-O3", "-Xptxas=-v")
"""

TOY_CU = """\
// jt: ptxas(regs<=40, spill<=0, smem<=256)
template <int N>
__global__ void __launch_bounds__(128) toy_kernel(int* x) {}

extern "C" int toy_launch(void* x, void* stream) { return 0; }
"""

WRAPPER = """
class ToyKernel:
    def __init__(self):
        self.launches = 0

    def __call__(self, x):
        fn = load("toy").toy_launch
        fn(x)
        self.launches += 1
        return x


def toy_row_bytes(n):  # jt: budget(0.9..1.01, allocated=0.9..1.02)
    return 4 * n
"""


def toy_log(regs=32, spill=0, smem=128, n=1):
    return (f"ptxas info    : Compiling entry function "
            f"'_Z10toy_kernelILi{n}EEvPi' for 'sm_90a'\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers, "
            f"{smem} bytes smem\n")


TOY_REGISTRY = (ka.KernelEntry(
    "toy", "toy", "toy_launch", "jepsen_tpu_torch/ops/toy.py:ToyKernel",
    "jepsen_tpu_torch/ops/toy.py:toy_row_bytes", "none"),)


def audit(tmp_path, files=None, log=None, registry=TOY_REGISTRY, rules=None):
    tree = {"jepsen_tpu_torch/ops/_build.py": BUILD,
            "jepsen_tpu_torch/ops/csrc/toy.cu": TOY_CU,
            "jepsen_tpu_torch/ops/toy.py": WRAPPER}
    tree.update(files or {})
    for rel, code in tree.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(code if rel.endswith(".cu") else textwrap.dedent(code))
    options = {"kernel_registry": registry,
               "ptxas_logs": {} if log is None else {"toy": log}}
    return core.lint_paths([str(tmp_path / "jepsen_tpu_torch")],
                           rules=rules or list(ka.KernelAudit.rules),
                           options=options)


def found(res, rule=None):
    return [(f.rule, f.scope) for f in res.findings
            if rule is None or f.rule == rule]


def test_fixture_tree_is_clean(tmp_path):
    res = audit(tmp_path, log=toy_log())
    assert res.findings == []
    assert not any("ptxas report skipped" in n for n in res.notes)


def test_resources_fire_over_a_bound(tmp_path):
    res = audit(tmp_path, log=toy_log(regs=48, spill=16, smem=300))
    (f,) = res.findings
    assert (f.rule, f.scope) == ("kernel-resources", "toy_kernel")
    assert "regs 48 > 40" in f.message and "spill 16 > 0" in f.message
    assert "smem 300 > 256" in f.message
    assert f.path.endswith("ops/csrc/toy.cu") and f.line == 3


def test_resources_fire_without_a_bound(tmp_path):
    cu = TOY_CU.replace("// jt: ptxas(regs<=40, spill<=0, smem<=256)\n", "")
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/csrc/toy.cu": cu},
                log=toy_log())
    assert found(res) == [("kernel-resources", "toy_kernel")]
    assert "has no" in res.findings[0].message
    bad = TOY_CU.replace("smem<=256", "smem<=lots")
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/csrc/toy.cu": bad},
                log=toy_log())
    assert "malformed" in res.findings[0].message


def test_resources_hold_each_instance_to_its_own_bound(tmp_path):
    """A selected instance is held to its own bound, not the worst
    instance's: ``toy_kernel<1>`` at 36 registers fires under ``N=1:
    regs<=32`` though the other instances' bound is 40."""
    cu = TOY_CU.replace(
        "// jt: ptxas(regs<=40, spill<=0, smem<=256)\n",
        "// jt: ptxas(N=1: regs<=32, spill<=0, smem<=128)\n"
        "// jt: ptxas(regs<=40, spill<=0, smem<=256)\n")
    files = {"jepsen_tpu_torch/ops/csrc/toy.cu": cu}
    res = audit(tmp_path, files, log=toy_log(regs=32) + toy_log(regs=40, n=2))
    assert res.findings == []
    res = audit(tmp_path, files, log=toy_log(regs=36) + toy_log(regs=40, n=2))
    (f,) = res.findings
    assert (f.rule, f.scope) == ("kernel-resources", "toy_kernel")
    assert "(N=1)" in f.message and "regs 36 > 32" in f.message
    res = audit(tmp_path, files, log=toy_log(regs=36, n=2))
    assert res.findings == []
    only = TOY_CU.replace("// jt: ptxas(regs<=40,", "// jt: ptxas(N=1: regs<=40,")
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/csrc/toy.cu": only},
                log=toy_log(n=2))
    (f,) = res.findings
    assert "matches no selector" in f.message


def test_resources_suppressed(tmp_path):
    cu = TOY_CU.replace(
        "__global__ void __launch_bounds__(128) toy_kernel(int* x) {}",
        "__global__ void __launch_bounds__(128) toy_kernel(int* x) {}"
        "  // jt: allow[kernel-resources]")
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/csrc/toy.cu": cu},
                log=toy_log(regs=99))
    assert res.findings == []


def test_resources_skipped_without_a_kept_log(tmp_path):
    res = audit(tmp_path)
    assert res.findings == []
    assert any("kernel-resources: ptxas report skipped for toy" in n
               for n in res.notes)


def test_resources_read_the_log_kept_beside_the_library(tmp_path):
    audit(tmp_path)  # writes the tree
    src = tmp_path / "jepsen_tpu_torch/ops/csrc/toy.cu"
    import hashlib
    digest = hashlib.sha256(src.read_bytes() + "\0".join(
        ("-O3", "-Xptxas=-v")).encode()).hexdigest()[:16]
    kept = tmp_path / "build" / "kernels" / f"libtoy-{digest}.ptxas.txt"
    kept.parent.mkdir(parents=True)
    kept.write_text(toy_log(regs=41))
    res = audit(tmp_path)
    assert found(res) == [("kernel-resources", "toy_kernel")]


def test_coverage_fires_on_an_unregistered_entry_point(tmp_path):
    cu = TOY_CU + 'extern "C" int other_launch(void* s) { return 0; }\n'
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/csrc/toy.cu": cu},
                log=toy_log())
    assert found(res) == [("kernel-coverage", "other_launch")]


def test_coverage_fires_on_a_missing_or_unlinked_wrapper(tmp_path):
    gone = (ka.KernelEntry("toy", "toy", "toy_launch",
                           "jepsen_tpu_torch/ops/toy.py:GoneKernel", None,
                           "none"),)
    res = audit(tmp_path, log=toy_log(), registry=gone)
    assert found(res) == [("kernel-coverage", "toy")]
    assert "does not exist" in res.findings[0].message
    unlinked = WRAPPER.replace("toy_launch", "something_else")
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/toy.py": unlinked},
                log=toy_log())
    assert found(res) == [("kernel-coverage", "toy")]
    assert "never reaches `toy_launch`" in res.findings[0].message


def test_coverage_suppressed(tmp_path):
    cu = TOY_CU + ('// jt: allow[kernel-coverage] — a measurement floor\n'
                   'extern "C" int other_launch(void* s) { return 0; }\n')
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/csrc/toy.cu": cu},
                log=toy_log())
    assert res.findings == []


def test_budget_band_fires_clean_and_suppressed(tmp_path):
    directive = "# jt: budget(0.9..1.01, allocated=0.9..1.02)"
    bare = WRAPPER.replace("  " + directive, "")
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/toy.py": bare},
                log=toy_log())
    assert found(res) == [("kernel-budget", "toy_row_bytes")]
    requested_only = WRAPPER.replace(directive, "# jt: budget(0.9..1.01)")
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/toy.py": requested_only},
                log=toy_log())
    assert found(res) == [("kernel-budget", "toy_row_bytes")]
    assert "allocated=" in res.findings[0].message
    allowed = WRAPPER.replace(directive, "# jt: allow[kernel-budget]")
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/toy.py": allowed},
                log=toy_log())
    assert res.findings == []
    gone = (ka.KernelEntry("toy", "toy", "toy_launch",
                           "jepsen_tpu_torch/ops/toy.py:ToyKernel",
                           "jepsen_tpu_torch/ops/toy.py:gone_bytes", "none"),)
    res = audit(tmp_path, log=toy_log(), registry=gone)
    assert found(res) == [("kernel-budget", "toy")]
    assert any("card half" in n for n in res.notes)


# -- kernel-cache-key -----------------------------------------------------------

RESOLVER = """
from functools import lru_cache


def resolve_knob(arg, get, default):
    return default if arg is None else arg


def closure_mode(mode=None):
    return resolve_knob(mode, None, "fixed")
"""


def cache_key(tmp_path, code):
    return audit(tmp_path, {"jepsen_tpu_torch/ops/k.py": RESOLVER + code},
                 log=toy_log(), rules=["kernel-cache-key"])


def test_cache_key_fires_on_a_resolver_inside_a_cached_factory(tmp_path):
    res = cache_key(tmp_path, """
@lru_cache(maxsize=8)
def make_fn(n):
    return (n, closure_mode())


class Checker:
    def __init__(self, n):
        self.mode = closure_mode()


_checker = lru_cache(maxsize=8)(Checker)
""")
    assert found(res) == [("kernel-cache-key", "make_fn"),
                          ("kernel-cache-key", "Checker")]


def test_cache_key_fires_on_knobs_that_miss_the_key(tmp_path):
    res = cache_key(tmp_path, """
@lru_cache(maxsize=8)
def _make(n, mode):
    return (n, mode)


def make_resolved(n):
    mode = closure_mode()
    return _make(n, "fixed")


def make_param(n, mode=None):
    return _make(n, "fixed")
""")
    assert found(res) == [("kernel-cache-key", "make_resolved"),
                          ("kernel-cache-key", "make_param")]


def test_cache_key_clean_and_suppressed(tmp_path):
    res = cache_key(tmp_path, """
@lru_cache(maxsize=8)
def _make(n, mode):
    return (n, mode)


def make_resolved(n):
    mode = closure_mode()
    return _make(n, mode)


def make_direct(n, mode=None):
    return _make(n, closure_mode(mode))


@lru_cache(maxsize=8)
def make_allowed(n):
    return (n, closure_mode())  # jt: allow[kernel-cache-key]
""")
    assert res.findings == []


def test_cache_key_shard_fn_must_key_on_the_checker(tmp_path):
    narrow = """
class Checker:
    def __init__(self, n, mode):
        self.mode = mode

_CACHE = {}


def shard_fn(check_fn, mesh):
    key = mesh.devices
    return _CACHE.setdefault(key, (check_fn, mesh))
"""
    res = cache_key(tmp_path, narrow)
    assert found(res) == [("kernel-cache-key", "shard_fn")]
    on_checker = narrow.replace(
        "    key = mesh.devices\n",
        "    key = mesh.devices\n    check_fn._variants = {}\n")
    assert cache_key(tmp_path, on_checker).findings == []
    reads = narrow.replace(
        "    key = mesh.devices\n",
        "    key = (mesh.devices, getattr(check_fn, 'mode', None))\n")
    assert cache_key(tmp_path, reads).findings == []
    allowed = narrow.replace("def shard_fn(check_fn, mesh):",
                             "def shard_fn(check_fn, mesh):  "
                             "# jt: allow[kernel-cache-key]")
    assert cache_key(tmp_path, allowed).findings == []


# -- kernel-host-sync -----------------------------------------------------------

SYNCING = """
import torch


def check_ids(t, C):
    lo, hi = (int(x) for x in torch.aminmax(t))
    return lo, hi


def shape_of(t):
    return int(t.shape[0])


class SyncKernel:
    def __init__(self):
        self.launches = 0

    def __call__(self, t, mode="fixed"):
        B = shape_of(t)
        flag = int(mode == "earlyexit")
        check_ids(t, 4)
        n = t.sum().item()
        self.launches += 1
        after = t.tolist()
        return B, flag, n, after
"""


def test_host_sync_fires_before_the_launch(tmp_path):
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/s.py": SYNCING},
                log=toy_log(), rules=["kernel-host-sync"])
    msgs = [(f.scope, f.message.split(" in ")[0]) for f in res.findings]
    assert msgs == [("check_ids", "int() of a tensor"),
                    ("SyncKernel.__call__", ".item()")]
    assert "called by `SyncKernel.__call__`" in res.findings[0].message


def test_host_sync_clean_and_suppressed(tmp_path):
    clean = SYNCING.replace("        check_ids(t, 4)\n", "").replace(
        "        n = t.sum().item()\n", "        n = 0\n")
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/s.py": clean},
                log=toy_log(), rules=["kernel-host-sync"])
    assert res.findings == []
    allowed = SYNCING.replace(
        "    lo, hi = (int(x) for x in torch.aminmax(t))",
        "    lo, hi = (int(x) for x in torch.aminmax(t))"
        "  # jt: allow[kernel-host-sync]").replace(
        "        n = t.sum().item()",
        "        n = t.sum().item()  # jt: allow[kernel-host-sync]")
    res = audit(tmp_path, {"jepsen_tpu_torch/ops/s.py": allowed},
                log=toy_log(), rules=["kernel-host-sync"])
    assert res.findings == []


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------


def test_registry_covers_every_entry_point_of_the_sources():
    launches = {e.launch for e in ka.REGISTRY}
    for name, path in _build.SOURCES.items():
        syms = ka.launch_symbols(path.read_text())
        assert syms and set(syms) <= launches, (name, syms)
        assert name in {e.library for e in ka.REGISTRY}


def test_every_global_of_the_sources_declares_its_bounds():
    for path in _build.SOURCES.values():
        for name, line, contract, _ in ka.cuda_globals(path.read_text()):
            assert contract and any(not sel for sel, _ in contract.groups), (
                path.name, name, line)
            for _, bounds in contract.groups:
                assert set(bounds) == set(ka.RESOURCES), (path.name, name)


#: recorded from the card's build of ``dense_automaton.cu`` (nvcc 12.9):
#: the flagship's C 8 instance and the largest one
FLAGSHIP_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__c0acefda_18_dense_automaton_cu_c1775fea20register_warp_kernelILi7EEEvPKiS2_PKaS4_PKsS6_PhPiS7_iiiNS_6ParamsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__c0acefda_18_dense_automaton_cu_c1775fea20register_warp_kernelILi3EEEvPKiS2_PKaS4_PKsS6_PhPiS7_iiiNS_6ParamsE' for 'sm_90a'
    24 bytes stack frame, 20 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""


@pytest.mark.parametrize("regs, spill, fires", [
    (64, (20, 24), False), (96, (20, 24), True), (64, (52, 52), True)])
def test_the_flagship_instance_is_held_to_its_own_bound(regs, spill, fires):
    """The register warp kernel's C 8 instance (the flagship's) regressing
    to numbers the largest instance's bound still admits fires."""
    log = FLAGSHIP_LOG.replace("Used 64 registers", f"Used {regs} registers")
    log = log.replace("20 bytes spill stores, 24 bytes spill loads",
                      f"{spill[0]} bytes spill stores, {spill[1]} bytes "
                      "spill loads")
    res = core.lint_paths([str(_build.CSRC.parent)],
                          rules=["kernel-resources"],
                          options={"ptxas_logs": {"dense_automaton": log}})
    got = [(f.scope, "(LOG_W=3)" in f.message) for f in res.findings]
    assert got == ([("register_warp_kernel", True)] if fires else [])


def test_frontier_pricing_follows_the_design_rule():
    """The workspace term is the block design's layout or nothing, as
    ``frontier_search_workspace_bytes`` in the CUDA source decides; the
    card half holds it equal to the library's own count."""
    for b in ka.REGISTRY[5].buckets:
        F, E, C = b["F"], b["E"], b["C"]
        ws = wgl.frontier_workspace_bytes(F, C)
        assert (ws == 0) == (wgl.frontier_design(F, C) == "warp")
        assert ws % 16 == 0
        assert wgl.frontier_row_bytes(F, E, C) == ws + 4 + 4 * E + \
            6 * E * C + 6
    assert ka.REGISTRY[5].name == "frontier_search"
    assert any(wgl.frontier_design(b["F"], b["C"]) == "block"
               for b in ka.REGISTRY[5].buckets)


def test_dense_checkers_carry_the_reference_cap():
    """``budget-missing-cap`` found the dense checker without a row cap
    (the engine read it through a default); it now carries the one the
    reference stamps on its dense kernels."""
    fn = dense.make_dense_fn("cas-register", 64, 4, 4, torch.device("cpu"))
    ref = ref_dense.make_dense_fn("cas-register", 64, 4, 4)
    assert fn.safe_dispatch == ref.safe_dispatch == wgl.DEFAULT_MAX_DISPATCH
    from jepsen_tpu_torch import synth
    hs = synth.generate_batch(seed=3, n_histories=4, n_ops=20)
    model = models.cas_register(0)
    b = encode.batch_encode(hs, model)
    arrays = (b.init_state, b.ev_slot, b.cand_slot, b.cand_f, b.cand_a,
              b.cand_b)
    plan = wgl.plan_bucket(model, step_kernels.spec_for(model), arrays,
                           device=torch.device("cpu"), max_dispatch=1 << 20)
    assert plan.kernel == "dense" and plan.disp == wgl.DEFAULT_MAX_DISPATCH


def test_frontier_slot_ids_are_checked_on_the_host():
    """The wrapper's input check reads no element (no device sync before
    a launch); ``plan_bucket`` checks the slot ids on the host arrays."""
    from jepsen_tpu_torch import synth
    import random
    rng = random.Random(5)
    hs = [synth.generate_history(rng, n_procs=3, n_ops=200, n_values=200,
                                 crash_p=0.02)
          for _ in range(3)]
    model = models.cas_register(0)
    b = encode.batch_encode(hs, model)
    arrays = [b.init_state, b.ev_slot, b.cand_slot.copy(), b.cand_f,
              b.cand_a, b.cand_b]
    C = arrays[2].shape[2]
    spec = step_kernels.spec_for(model)
    plan = wgl.plan_bucket(model, spec, tuple(arrays),
                           device=torch.device("cpu"))
    assert plan.kernel == "frontier"
    arrays[2][0, 0, 0] = C  # one slot id out of range
    with pytest.raises(ValueError, match="cand_slot holds slot ids"):
        wgl.plan_bucket(model, spec, tuple(arrays),
                        device=torch.device("cpu"))
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a))
                    for a in arrays)
    assert wgl.check_frontier_inputs(tensors)[2] == C
    with pytest.raises(ValueError, match="slot ids"):
        plan.fn.reference(*tensors)


def test_build_keeps_the_ptxas_report_beside_the_library(tmp_path,
                                                         monkeypatch):
    """A fake ``nvcc`` writes its output and a ptxas report: the report is
    kept beside the library, and a second build (nothing to compile)
    returns it from there."""
    fake = tmp_path / "nvcc"
    fake.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        out = sys.argv[sys.argv.index("-o") + 1]
        open(out, "wb").write(b"lib")
        print("ptxas info    : Used 7 registers")
        """))
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    first = _build.build(["verdict_stats"])["verdict_stats"]
    assert "Used 7 registers" in first["ptxas"]
    kept = _build.ptxas_log_path("verdict_stats")
    assert kept.parent == tmp_path / "kernels"
    assert kept.read_text().strip() == first["ptxas"]
    second = _build.build(["verdict_stats"])["verdict_stats"]
    assert second["seconds"] == 0.0 and second["ptxas"] == kept.read_text()
    assert _build.ptxas_log("dense_automaton") is None
