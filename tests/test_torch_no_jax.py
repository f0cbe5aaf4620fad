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
                     "jepsen_tpu_torch.serve.router"):
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
    # the tuner, trace propagation and the checker service included
    assert int(out.stdout.split()[-1]) >= 59


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
