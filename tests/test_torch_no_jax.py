"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the caller asks for the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: runs in a fresh interpreter: refuse jax, jaxlib and jepsen_tpu (by exact
#: top-level name, so jepsen_tpu_torch still imports), then import every
#: module of the port and chip_smoke
_IMPORT_ALL = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    REFUSED = {"jax", "jaxlib", "jepsen_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import jepsen_tpu_torch
    names = ["jepsen_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            jepsen_tpu_torch.__path__, "jepsen_tpu_torch.")
    ]
    for required in ("jepsen_tpu_torch.models.locks",
                     "jepsen_tpu_torch.checker.locks_direct",
                     "jepsen_tpu_torch.engine.decompose",
                     "jepsen_tpu_torch.parallel",
                     "jepsen_tpu_torch.parallel.mesh",
                     "jepsen_tpu_torch.checker",
                     "jepsen_tpu_torch.independent",
                     "jepsen_tpu_torch.obs",
                     "jepsen_tpu_torch.obs.profiling",
                     "jepsen_tpu_torch.store",
                     "jepsen_tpu_torch.workloads.cycle",
                     "jepsen_tpu_torch.platform",
                     "jepsen_tpu_torch.obs.journal",
                     "jepsen_tpu_torch.obs.drift",
                     "jepsen_tpu_torch.tune",
                     "jepsen_tpu_torch.tune.__main__",
                     "jepsen_tpu_torch.tune.artifact",
                     "jepsen_tpu_torch.tune.calibrate",
                     "jepsen_tpu_torch.obs.propagate",
                     "jepsen_tpu_torch.serve",
                     "jepsen_tpu_torch.serve.__main__",
                     "jepsen_tpu_torch.serve.client",
                     "jepsen_tpu_torch.serve.daemon",
                     "jepsen_tpu_torch.serve.protocol",
                     "jepsen_tpu_torch.serve.router",
                     "jepsen_tpu_torch.serve.chaos",
                     "jepsen_tpu_torch.lint",
                     "jepsen_tpu_torch.lint.__main__",
                     "jepsen_tpu_torch.lint.core",
                     "jepsen_tpu_torch.lint.budget",
                     "jepsen_tpu_torch.lint.kernel_audit",
                     "jepsen_tpu_torch.util",
                     "jepsen_tpu_torch.client",
                     "jepsen_tpu_torch.generator",
                     "jepsen_tpu_torch.generator.sim",
                     "jepsen_tpu_torch.fake",
                     "jepsen_tpu_torch.control",
                     "jepsen_tpu_torch.control.core",
                     "jepsen_tpu_torch.db",
                     "jepsen_tpu_torch.nemesis",
                     "jepsen_tpu_torch.interpreter",
                     "jepsen_tpu_torch.checker.timeline",
                     "jepsen_tpu_torch.store.format",
                     "jepsen_tpu_torch.core",
                     "jepsen_tpu_torch.workloads",
                     "jepsen_tpu_torch.workloads.linearizable_register",
                     "jepsen_tpu_torch.cli",
                     "jepsen_tpu_torch.__main__",
                     "jepsen_tpu_torch.control.local",
                     "jepsen_tpu_torch.control.util",
                     "jepsen_tpu_torch.net",
                     "jepsen_tpu_torch.nemesis.combined",
                     "jepsen_tpu_torch.checker.svg",
                     "jepsen_tpu_torch.checker.perf",
                     "jepsen_tpu_torch.suites",
                     "jepsen_tpu_torch.suites.common",
                     "jepsen_tpu_torch.suites.localkv",
                     "jepsen_tpu_torch.workloads.bank",
                     "jepsen_tpu_torch.workloads.long_fork",
                     "jepsen_tpu_torch.workloads.adya",
                     "jepsen_tpu_torch.workloads.causal",
                     "jepsen_tpu_torch.workloads.causal_reverse",
                     "jepsen_tpu_torch.workloads.cycle.append",
                     "jepsen_tpu_torch.workloads.cycle.wr",
                     "jepsen_tpu_torch.trace",
                     "jepsen_tpu_torch.checker.clock",
                     "jepsen_tpu_torch.web",
                     "jepsen_tpu_torch.store.native"):
        assert required in names, required
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in REFUSED)
    assert not loaded, loaded
    print(len(names))
""")


def test_port_imports_no_jax_and_nothing_of_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every module of the port, the lock checkers, the decomposition
    # front-end, the mesh, the checker seam, the independent lift, obs,
    # the cycle workloads, the probe, the journal, the drift sentinel and
    # the tuner, trace propagation, the checker service, its chaos drills,
    # the lint passes and the test harness (generators, interpreter, fake
    # clients, control, db, nemesis, store format, core, workloads, CLI)
    # and the real-process path (the local remote and its helpers, net,
    # the combined nemeses, the perf plots, the localkv suite), the other
    # in-process workloads, span tracing, the clock plot, the web UI and
    # the native block writer's loader included
    assert int(out.stdout.split()[-1]) >= 96


def test_the_refusal_matches_names_exactly():
    """The finder refuses ``jepsen_tpu`` itself (so the check has teeth)."""
    script = _IMPORT_ALL.replace("import jepsen_tpu_torch\n",
                                 "import jepsen_tpu_torch\nimport jepsen_tpu\n",
                                 1)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "the port must not import jepsen_tpu" in out.stderr


def test_check_batch_without_a_device_raises_where_cuda_is_absent(
        monkeypatch):
    from jepsen_tpu_torch import models, synth
    from jepsen_tpu_torch.ops import wgl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hs = synth.generate_batch(seed=1, n_histories=2, n_ops=20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wgl.check_batch(models.cas_register(0), hs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wgl.check_batch(models.cas_register(0), hs, device="cuda")
    assert wgl.check_batch(models.cas_register(0), hs, device="cpu")


def test_the_daemon_entry_probes_before_it_imports_torch():
    """``python -m jepsen_tpu_torch.serve`` starts its CUDA probe before
    the daemon's imports: the ``serve`` package, its ``__main__`` and
    ``platform`` load without torch (the package's names load lazily)."""
    src = textwrap.dedent("""
        import importlib.abc, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "torch":
                    raise ImportError(name)
                return None

        sys.meta_path.insert(0, Refuse())
        import jepsen_tpu_torch.platform
        import jepsen_tpu_torch.serve
        from jepsen_tpu_torch.serve import __main__ as entry
        assert entry._card_bound([]) and entry._card_bound(["--device=1"])
        assert not entry._card_bound(["--device", "cpu"])
        assert not entry._card_bound(["--supervise", "--fleet", "2"])
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", src], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    import jepsen_tpu_torch.serve as serve

    assert serve.ServiceClient.__module__ == "jepsen_tpu_torch.serve.client"
    assert set(serve.__all__) >= {"CheckerDaemon", "Router", "spawn_daemon"}
    with pytest.raises(AttributeError):
        serve.no_such_name
