"""The service's self-chaos drills (``jepsen_tpu_torch/serve/chaos.py``) on
the CPU, held against the JAX package.

Each drill runs under ``device="cpu"`` against real daemon processes (kill
-9, a stalling and dropping proxy, WAL compaction under a crash, a fleet
member's death behind the router) and must pass every gate; its final
results must equal the JAX package's ``jepsen_tpu.ops.wgl.check_batch`` on
the same corpus as canonical JSON (after the engine name ``"tpu"`` →
``"gpu"``), so the drills hold the port against the reference, not only
against itself.  The corpora are the reference's smoke corpora rebuilt by
the port's ``synth``.  Every wait in the drills is bounded and every
daemon is stopped by the harness, pass or fail.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from jepsen_tpu import models as ref_models
from jepsen_tpu.engine.smoke import _corpus as ref_corpus_a
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.serve.smoke import _corpus_b as ref_corpus_b
from jepsen_tpu_torch.serve import chaos, protocol

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gpu_names(x):
    if isinstance(x, dict):
        return {gpu_names(k): gpu_names(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(gpu_names(v) for v in x)
    return "gpu" if x == "tpu" else x


def canon(results) -> str:
    return json.dumps(protocol.sanitize_results(gpu_names(results)),
                      sort_keys=True)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's results on the drills' corpora, per route (its
    exact frontier compaction, as the port's parity tests run it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
        model = ref_models.cas_register(0)
        a, b = ref_corpus_a(), ref_corpus_b()
        return {
            "a/dense": canon(ref_wgl.check_batch(model, a,
                                                 **chaos.CONFIGS["dense"])),
            "a/frontier": canon(ref_wgl.check_batch(
                model, a, **chaos.CONFIGS["frontier"])),
            "b/dense": canon(ref_wgl.check_batch(model, b,
                                                 **chaos.CONFIGS["dense"])),
        }


#: which corpus and route each drill's final results ran
EXPECTED = {
    1: {"dense": "a/dense", "frontier": "a/frontier", "victim": "b/dense"},
    2: {"recovered": "b/dense"},
    3: {"deduped": "b/dense"},
    4: {"compacted": "a/dense"},
    5: {"spilled": "b/dense", "revived": "b/dense"},
}


def test_corpora_are_the_references():
    assert [h.to_dicts() for h in chaos.corpus_a()] == \
        [h.to_dicts() for h in ref_corpus_a()]
    assert [h.to_dicts() for h in chaos.corpus_b()] == \
        [h.to_dicts() for h in ref_corpus_b()]


@pytest.mark.parametrize("drill", sorted(chaos.DRILLS))
def test_drill_passes_and_equals_the_reference(drill, reference, tmp_path):
    out = chaos.run(device="cpu", drills=(drill,), tmp=str(tmp_path),
                    log=lambda line: None)
    (report,) = out["drills"]
    assert report["ok"], report["failures"]
    assert report["gates"] >= 6 and report["seconds"] > 0
    results = out["results"][drill]
    assert set(results) == set(EXPECTED[drill])
    for name, key in EXPECTED[drill].items():
        assert canon(results[name]) == reference[key], (drill, name)


def test_drills_account_every_fault():
    """The counters each drill reports: replays, trips and probes, a
    dedup, a compaction, a reroute."""
    out = chaos.run(device="cpu", drills=(2, 3), log=lambda line: None)
    assert out["ok"], [r["failures"] for r in out["drills"]]
    stall, drop = out["drills"]
    assert stall["counters"]["trips"] == 1 and stall["counters"]["probes"] >= 1
    assert stall["counters"]["stalled"] == 3
    assert stall["counters"]["max_stall_s"] <= 3.5
    assert stall["counters"]["jepsen_client_breaker_trips_total"] >= 1
    assert drop["counters"]["dropped"] == 1 and drop["counters"]["deduped"] == 1
    assert drop["counters"]["jepsen_client_retries_total"] >= 1


def test_run_defaults_to_the_card(monkeypatch, tmp_path):
    """Left without ``device``, ``run`` asks for CUDA and raises when none
    executes, before it starts a daemon; it never falls back to the
    CPU."""
    from jepsen_tpu_torch import platform

    platform.forget_probe()
    monkeypatch.setattr(platform, "probe_accelerator",
                        lambda **kw: (False, "no CUDA device present"))
    try:
        with pytest.raises(RuntimeError, match="no usable CUDA device"):
            chaos.run(drills=(3,), tmp=str(tmp_path), log=lambda line: None)
    finally:
        platform.forget_probe()
    assert os.listdir(tmp_path) == []


def test_tear_tail_keeps_every_complete_row(tmp_path):
    path = tmp_path / "wal.jsonl"
    path.write_bytes(b'{"a": 1}\n{"a": 2}\n{"a": 3}\n{"a": 4')
    chaos.tear_tail(str(path))
    data = path.read_bytes()
    assert data.startswith(b'{"a": 1}\n{"a": 2}\n')
    assert not data.endswith(b"\n") and b'{"a": 3}' not in data


def test_metric_value_sums_every_series():
    text = ("# HELP x_total x\n"
            "x_total 2\n"
            'x_total{member="a"} 3\n'
            "x_total_other 7\n")
    assert chaos.metric_value(text, "x_total") == 5.0
    assert chaos.metric_value(text, "y_total") is None


def test_cli_exit_codes():
    ok = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.serve.chaos", "--device",
         "cpu", "--drills", "3"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert ok.returncode == 0, ok.stderr
    assert "chaos: ok" in ok.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.serve.chaos", "--device",
         "cpu", "--drills", "9"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert bad.returncode == 2 and "no drill" in bad.stderr
    if not torch.cuda.is_available():
        card = subprocess.run(
            [sys.executable, "-m", "jepsen_tpu_torch.serve.chaos",
             "--drills", "3"], cwd=REPO, capture_output=True, text=True,
            timeout=120)
        assert card.returncode == 1
        assert "no usable CUDA device" in card.stderr
