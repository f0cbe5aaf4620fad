"""The port's lint core and its dispatch-discipline pass.

The core (:mod:`jepsen_tpu_torch.lint.core`) is held against the
reference's ``jepsen_tpu.lint.core`` on the same fixture files: the same
fingerprints, the same suppressions, the same baseline verdicts.  The
``budget`` rules fire, pass clean and are suppressed on ``tmp_path``
fixtures in the style of ``tests/test_lint.py``; the CLI keeps the
reference's exit codes; the whole package lints clean with its baseline.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from jepsen_tpu.lint import core as ref_core
from jepsen_tpu_torch.lint import core
from jepsen_tpu_torch.lint.__main__ import main as lint_main
from jepsen_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write(tmp_path, sources):
    for rel, code in sources.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(code))
    return str(tmp_path)


def run_lint(tmp_path, sources, rules=None, options=None, baseline=None):
    return core.lint_paths([write(tmp_path, sources)], rules=rules,
                           options=options, baseline=baseline)


def rules_of(res):
    return sorted(f.rule for f in res.findings)


# ---------------------------------------------------------------------------
# the core against the reference's
# ---------------------------------------------------------------------------

FIXTURE = """
def alpha():
    BAD_x = 1
    BAD_y = 2  # jt: allow[fixture-rule]
    # jt: allow[fixture-rule]
    BAD_z = 3
    return "BAD # jt: allow[fixture-rule] in a string is no directive"


class Beta:
    def gamma(self):
        BAD_0 = 0  # jt: allow[*]
        BAD_w = 1  # jt: allow[other-rule]
        BAD_v = 1
        return BAD_0 + BAD_w + BAD_v
"""


class _MarkPass:
    """A fixture pass for either core: one finding per line holding the
    marker, the same rule, scope and message, suppressions honoured."""

    name = "fixture"
    rules = ("fixture-rule",)

    def __init__(self, mod):
        self.mod = mod

    def run(self, project):
        out = []
        for sf in project.files:
            idx = self.mod.FunctionIndex(sf.tree)
            for i, line in enumerate(sf.lines, 1):
                if "BAD" not in line or sf.allowed(i, "fixture-rule"):
                    continue
                scope = ""
                for q, fn in idx.funcs.items():
                    if fn.lineno <= i <= fn.end_lineno:
                        scope = q
                out.append(self.mod.Finding("fixture-rule", sf.rel, i, 0,
                                            "marked line", scope))
        return out


@pytest.fixture
def both_cores(monkeypatch):
    """Each core with the fixture pass as its only pass."""
    for mod in (core, ref_core):
        monkeypatch.setattr(mod, "_PASSES", [_MarkPass(mod)])
        monkeypatch.setattr(mod, "_registered", True)
    if hasattr(ref_core, "_ensure_registered"):
        monkeypatch.setattr(ref_core, "_ensure_registered", lambda: None)
    yield


def test_fingerprints_and_suppressions_equal_the_reference(tmp_path,
                                                           both_cores):
    root = write(tmp_path, {"pkg/a.py": FIXTURE, "pkg/b.py": FIXTURE})
    ours = core.lint_paths([root])
    ref = ref_core.lint_paths([root])
    assert [f.to_dict() for f in ours.findings] == \
        [f.to_dict() for f in ref.findings]
    # five marked lines survive per file: the allow on the line, the
    # standalone allow above and the wildcard suppress the others; a
    # string never carries a directive, another rule's allow does not
    # apply
    assert len(ours.findings) == 10
    lines = sorted({f.line for f in ours.findings})
    assert lines == [3, 7, 13, 14, 15]
    # identical findings in one scope get distinct occurrences
    fps = [f.fingerprint() for f in ours.findings]
    assert len(set(fps)) == len(fps)


def test_baseline_verdicts_equal_the_reference(tmp_path, both_cores):
    root = write(tmp_path, {"pkg/a.py": FIXTURE})
    first = core.lint_paths([root])
    baseline = core.make_baseline(first.findings[:2])
    assert baseline == ref_core.make_baseline(
        ref_core.lint_paths([root]).findings[:2])
    # a baselined finding is demoted; a gone one is stale, not a failure
    baseline["findings"].append({"fp": "0" * 16, "rule": "fixture-rule",
                                 "path": first.findings[0].path,
                                 "message": "gone"})
    ours = core.lint_paths([root], baseline=baseline)
    ref = ref_core.lint_paths([root], baseline=baseline)
    assert [f.fingerprint() for f in ours.findings] == \
        [f.fingerprint() for f in ref.findings]
    assert [f.fingerprint() for f in ours.baselined] == \
        [f.fingerprint() for f in ref.baselined]
    assert ours.stale == ref.stale and len(ours.stale) == 1
    assert len(ours.baselined) == 2 and len(ours.findings) == 3
    # a subset run (another rule) calls nothing stale
    assert core.lint_paths([root], rules=["parse-error"],
                           baseline=baseline).stale == []


def test_baseline_round_trip(tmp_path, both_cores):
    root = write(tmp_path, {"pkg/a.py": FIXTURE})
    res = core.lint_paths([root])
    path = str(tmp_path / "baseline.json")
    core.write_baseline(path, res.findings)
    loaded = core.load_baseline(path)
    assert core.lint_paths([root], baseline=loaded).ok
    (tmp_path / "bad.json").write_text('{"version": 2}')
    with pytest.raises(ValueError):
        core.load_baseline(str(tmp_path / "bad.json"))
    assert core.load_baseline(str(tmp_path / "missing.json")) is None


def test_parse_error_is_one_finding(tmp_path):
    res = run_lint(tmp_path, {"pkg/broken.py": "def f(:\n    pass\n"})
    assert rules_of(res) == ["parse-error"]


def test_the_core_imports_nothing_it_lints():
    script = ("import sys; import jepsen_tpu_torch.lint as L; "
              "L.lint_paths([sys.argv[1]]); "
              "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", script,
                          os.path.join(REPO, "jepsen_tpu_torch", "ops")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "False"


# ---------------------------------------------------------------------------
# budget-direct-dispatch and budget-missing-cap
# ---------------------------------------------------------------------------

KERNELS = """
import functools
from functools import lru_cache


class ToyKernel:
    def __init__(self):
        self.launches = 0

    def __call__(self, x):
        self.launches += 1
        return x


TOY = ToyKernel()


def toy(x):
    if x.is_cuda:
        return TOY(x)
    return x


class ToyChecker:
    def __init__(self, n):
        self.n = n
        self.safe_dispatch = 64

    def __call__(self, x):
        return TOY(x)


_checker = lru_cache(maxsize=8)(ToyChecker)


def make_toy_fn(n):
    fn = _checker(n)
    return fn


class ToyPlan:
    def __init__(self, n):
        self.fn = functools.partial(toy)
        self.disp = 16
"""


def test_direct_dispatch_fires_on_every_kernel_value(tmp_path):
    res = run_lint(tmp_path, {"ops/k.py": KERNELS, "engine/run.py": """
        from ops.k import TOY, make_toy_fn, _checker


        def run_local(x):
            fn = make_toy_fn(4)
            return fn(x)


        def run_now(x):
            return make_toy_fn(4)(x)


        def run_wrapper(x):
            return TOY(x)


        class Holder:
            def __init__(self):
                self.fn = _checker(3)

            def go(self, x):
                return self.fn(x)
        """}, rules=["budget-direct-dispatch"])
    assert [f.scope for f in res.findings] == [
        "run_local", "run_now", "run_wrapper", "Holder.go"]


def test_direct_dispatch_clean_on_capped_and_sanctioned_paths(tmp_path):
    res = run_lint(tmp_path, {"ops/k.py": KERNELS, "engine/run.py": """
        from ops.k import make_toy_fn, max_dispatch_of


        def capped(xs):
            fn = make_toy_fn(4)
            cap = fn.safe_dispatch
            return [fn(x) for x in xs[:cap]]


        def helper_capped(xs):
            fn = make_toy_fn(4)
            n = max_dispatch_of(fn)
            return [fn(x) for x in xs[:n]]


        def handed_off(fn, xs):
            return [fn(x) for x in xs]
        """, "engine/execution.py": """
        from ops.k import make_toy_fn


        def chunk(x):
            fn = make_toy_fn(4)
            return fn(x)
        """, "scripts/toy_ab.py": """
        from ops.k import TOY


        def time_it(x):
            return TOY(x)
        """}, rules=["budget-direct-dispatch"])
    assert res.findings == []


def test_direct_dispatch_suppressed(tmp_path):
    res = run_lint(tmp_path, {"ops/k.py": KERNELS, "tune/t.py": """
        from ops.k import TOY


        def measure(x):
            # jt: allow[budget-direct-dispatch] — one timed launch
            return TOY(x)
        """}, rules=["budget-direct-dispatch"])
    assert res.findings == []


def test_missing_cap_fires(tmp_path):
    res = run_lint(tmp_path, {"ops/k.py": KERNELS + """

class BareChecker:
    def __init__(self, n):
        self.n = n

    def __call__(self, x):
        return TOY(x)


class BarePlan:
    def __init__(self):
        self.fn = functools.partial(toy)


def make_partial():
    fn = functools.partial(toy)
    return fn
"""}, rules=["budget-missing-cap"])
    assert [(f.scope, f.rule) for f in res.findings] == [
        ("BareChecker", "budget-missing-cap"),
        ("BarePlan", "budget-missing-cap"),
        ("make_partial", "budget-missing-cap")]


def test_missing_cap_clean_and_suppressed(tmp_path):
    res = run_lint(tmp_path, {"ops/k.py": KERNELS + """

class AllowedChecker:  # jt: allow[budget-missing-cap] — capped by its caller
    def __call__(self, x):
        return TOY(x)


def make_stamped():
    fn = functools.partial(toy)
    fn.safe_dispatch = 8
    return fn
"""}, rules=["budget-missing-cap"])
    assert res.findings == []


# ---------------------------------------------------------------------------
# the CLI and the whole tree
# ---------------------------------------------------------------------------


def test_cli_exit_codes_and_json(tmp_path, capsys):
    root = write(tmp_path, {"ops/k.py": KERNELS, "engine/run.py": """
        from ops.k import TOY


        def go(x):
            return TOY(x)
        """})
    base = str(tmp_path / "baseline.json")
    report = str(tmp_path / "lint.json")
    assert lint_main([root, "--baseline", base, "--json", report]) == 1
    data = json.loads(open(report).read())
    assert [f["rule"] for f in data["findings"]] == ["budget-direct-dispatch"]
    assert lint_main([root, "--baseline", base, "--write-baseline"]) == 0
    assert lint_main([root, "--baseline", base]) == 0
    assert lint_main([root, "--baseline", base, "--rules", "nope"]) == 2
    assert lint_main([str(tmp_path / "missing"), "--baseline", base]) == 2
    assert lint_main([root, "--rules", "budget-*", "--write-baseline",
                      "--baseline", base]) == 2
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "kernel-host-sync  [kernel-audit]" in out


def test_whole_package_lints_clean_with_its_baseline():
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.lint", "jepsen_tpu_torch"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout
    # the halves this sandbox cannot run are reported as skipped
    assert "note: kernel-budget: measured bytes per row skipped" in out.stdout
    if not any(_build.ptxas_log(n) for n in _build.SOURCES):
        assert "note: kernel-resources: ptxas report skipped" in out.stdout


def test_committed_baseline_is_empty():
    data = core.load_baseline(core.DEFAULT_BASELINE)
    assert data == {"version": 1, "findings": []}
