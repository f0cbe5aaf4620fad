"""The port's accelerator probe (``jepsen_tpu_torch.platform``).

Where this test runs without CUDA, the probe's subprocess answers "no
CUDA device" (exit 3): one attempt, no retry, and
``ensure_usable_backend`` raises — it never pins the CPU.  The retry,
timeout and trail logic runs against a stubbed ``subprocess.run``, the
same stub for the reference's probe (``jepsen_tpu.platform``), whose
outcomes it must equal.
"""

import json
import subprocess

import pytest
import torch

from jepsen_tpu import platform as ref_platform
from jepsen_tpu_torch import platform


@pytest.fixture(autouse=True)
def _fresh_probe():
    platform.forget_probe()
    ref_platform.forget_probe()
    yield
    platform.forget_probe()
    ref_platform.forget_probe()


def _trail_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_probe_of_this_machine(tmp_path):
    trail = str(tmp_path / "trail.jsonl")
    ok, err = platform.probe_accelerator(trail=trail, backoff_s=0.0)
    lines = _trail_lines(trail)
    if torch.cuda.is_available():
        assert (ok, err) == (True, None)
        assert [x["outcome"] for x in lines] == ["ok"]
    else:
        assert (ok, err) == (False, "no CUDA device present")
        # a clean "no device" answer is deterministic: no retry
        assert [(x["attempt"], x["outcome"]) for x in lines] == \
            [(0, "no-accelerator")]
        with pytest.raises(RuntimeError, match="no usable CUDA device"):
            platform.ensure_usable_backend()
        assert platform.accelerator_usable() is False


class _Stub:
    """``subprocess.run`` stand-in replaying ``outcomes``: an exit code
    (with a stderr tail) or an exception to raise."""

    def __init__(self, outcomes):
        self.outcomes = list(outcomes)
        self.calls = 0

    def __call__(self, cmd, timeout=None, **kw):
        out = self.outcomes[min(self.calls, len(self.outcomes) - 1)]
        self.calls += 1
        if isinstance(out, BaseException):
            raise out
        return subprocess.CompletedProcess(
            cmd, out, "", f"some warning\nfailure number {self.calls}\n")


@pytest.mark.parametrize("outcomes", [
    [0],
    [3],
    [1, 0],
    [1, 1, 1],
    [-11, 3],
    [subprocess.TimeoutExpired("probe", 5.0), 0],
    [subprocess.TimeoutExpired("probe", 5.0)] * 3,
    [OSError("exec failed"), 1, 1],
], ids=["ok", "no-device", "crash-then-ok", "crashes", "segv-then-none",
        "hang-then-ok", "hangs", "oserror"])
def test_retries_and_trail_equal_the_reference(tmp_path, monkeypatch,
                                               outcomes):
    ours_trail = str(tmp_path / "ours.jsonl")
    ref_trail = str(tmp_path / "ref.jsonl")
    stub = _Stub(outcomes)
    monkeypatch.setattr(subprocess, "run", stub)
    ours = platform.probe_accelerator(retries=3, timeout_s=5.0,
                                      backoff_s=0.0, trail=ours_trail)
    n_ours = stub.calls
    stub.calls = 0
    monkeypatch.setenv("JEPSEN_TPU_PROBE_TRAIL", ref_trail)
    theirs = ref_platform.probe_accelerator(retries=3, timeout_s=5.0,
                                            backoff_s=0.0)
    assert n_ours == stub.calls
    assert ours[0] == theirs[0]
    if ours[0] or ours[1].startswith("no "):
        # the messages name the device kind each package looks for
        assert (ours[1] is None) == (theirs[1] is None)
    else:
        assert ours[1].replace("CUDA init", "backend init") == theirs[1]
    ours_lines, ref_lines = _trail_lines(ours_trail), _trail_lines(ref_trail)
    assert [x["attempt"] for x in ours_lines] == \
        [x["attempt"] for x in ref_lines]
    assert [x["outcome"].replace("CUDA init", "backend init")
            for x in ours_lines] == [x["outcome"] for x in ref_lines]


def test_the_verdict_is_memoised_until_forgotten(monkeypatch):
    stub = _Stub([1])
    monkeypatch.setattr(subprocess, "run", stub)
    first = platform.probe_accelerator(retries=2, backoff_s=0.0)
    assert first == (False, "failure number 2") and stub.calls == 2
    assert platform.probe_accelerator(retries=2, backoff_s=0.0) == first
    assert stub.calls == 2
    with pytest.raises(RuntimeError, match="failure number 2"):
        platform.ensure_usable_backend()
    platform.forget_probe()
    stub.outcomes = [0]
    assert platform.probe_accelerator() == (True, None)
    platform.ensure_usable_backend()  # usable: no error
    assert stub.calls == 3


def test_a_trail_that_cannot_be_written_is_ignored(tmp_path, monkeypatch):
    monkeypatch.setattr(subprocess, "run", _Stub([0]))
    assert platform.probe_accelerator(
        trail=str(tmp_path / "no" / "such" / "dir.jsonl")) == (True, None)
