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


#: a ctypes-level stand-in for ``libcuda.so.1``, put in front of the
#: probe's own source: ``ctypes.CDLL`` hands back plain functions that
#: keep device memory in a dict and run the probe kernel's "add one to
#: each thread's word" on the host, each step failing where ``MODE`` says
_FAKE_LIBCUDA = '''
import ctypes, types

MODE = {mode!r}
MEM = {{}}
NAMES = {{100: b"CUDA_ERROR_NO_DEVICE", 719: b"CUDA_ERROR_LAUNCH_FAILED"}}


def put(ref, value):
    ref._obj.value = value
    return 0


def cuGetErrorName(rc, name):
    return put(name, NAMES.get(rc, b"CUDA_ERROR_UNKNOWN"))


def cuMemAlloc_v2(ptr, size):
    MEM[4096] = [0] * (size // 4)
    return put(ptr, 4096)


def cuMemsetD32_v2(ptr, value, n):
    MEM[ptr][:n] = [value] * n
    return 0


def cuModuleLoadData(module, image):
    return put(module, 1) if b".entry probe" in image else 218


def cuLaunchKernel(fn, gx, gy, gz, bx, by, bz, shared, stream, params,
                   extra):
    if MODE == "launch-fails":
        return 719
    ptr = ctypes.cast(params[0], ctypes.POINTER(ctypes.c_uint64))[0]
    for t in range(bx if MODE != "wrong-words" else bx - 1):
        MEM[ptr][t] += 1
    return 0


def cuMemcpyDtoH_v2(out, ptr, size):
    for i in range(size // 4):
        out[i] = MEM[ptr][i]
    return 0


FAKE = types.SimpleNamespace(
    cuGetErrorName=cuGetErrorName,
    cuInit=lambda flags: 100 if MODE == "no-device" else 0,
    cuDeviceGetCount=lambda n: put(n, 0 if MODE == "zero-count" else 1),
    cuDeviceGet=lambda dev, i: put(dev, i),
    cuDevicePrimaryCtxRetain=lambda ctx, dev: put(ctx, 1),
    cuCtxSetCurrent=lambda ctx: 0,
    cuMemAlloc_v2=cuMemAlloc_v2,
    cuMemsetD32_v2=cuMemsetD32_v2,
    cuModuleLoadData=cuModuleLoadData,
    cuModuleGetFunction=lambda fn, module, name: put(fn, 2),
    cuLaunchKernel=cuLaunchKernel,
    cuCtxSynchronize=lambda: 0,
    cuMemcpyDtoH_v2=cuMemcpyDtoH_v2,
    cuMemFree_v2=lambda ptr: 0)


def CDLL(name, *args, **kwargs):
    if name != "libcuda.so.1" or MODE == "no-driver":
        raise OSError(name + ": cannot open shared object file")
    return FAKE


ctypes.CDLL = CDLL
'''


@pytest.mark.parametrize("mode,verdict", [
    ("ok", (True, None)),
    ("no-driver", (False, "no CUDA device present")),
    ("no-device", (False, "no CUDA device present")),
    ("zero-count", (False, "no CUDA device present")),
    ("launch-fails",
     (False, "cuLaunchKernel: CUDA_ERROR_LAUNCH_FAILED (719)")),
    ("wrong-words", (False, "probe exit 4")),
])
def test_the_probe_source_against_a_fake_driver(tmp_path, monkeypatch, mode,
                                                verdict):
    """The probe's own subprocess and source, with ``libcuda`` replaced
    by :data:`_FAKE_LIBCUDA`: exit 0 when the launched kernel's words
    come back, 3 (no retry) without a driver or a device, 4 (retried)
    when a step fails, named on stderr, or the words are wrong."""
    trail = str(tmp_path / "trail.jsonl")
    monkeypatch.setattr(platform, "_PROBE_SRC",
                        _FAKE_LIBCUDA.format(mode=mode) + platform._PROBE_SRC)
    assert platform.probe_accelerator(retries=2, timeout_s=60.0,
                                      backoff_s=0.0, trail=trail) == verdict
    attempts = [x["outcome"] for x in _trail_lines(trail)]
    if verdict[0]:
        assert attempts == ["ok"]
    elif verdict[1].startswith("no "):
        assert attempts == ["no-accelerator"]
    else:
        assert attempts == [verdict[1]] * 2


class _FakePopen:
    """``subprocess.Popen`` stand-in for :func:`platform.start_probe`: its
    ``communicate`` answers ``code`` (or raises the exception given)."""

    started = []

    def __init__(self, cmd, **kw):
        self.cmd, self.killed, self.returncode = cmd, False, None
        self.answers = list(_FakePopen.script)
        _FakePopen.started.append(self)

    def communicate(self, timeout=None):
        out = self.answers.pop(0) if self.answers else 0
        if isinstance(out, BaseException):
            raise out
        self.returncode = out
        return "", "" if out == 0 else "early failure\n"

    def kill(self):
        self.killed = True


@pytest.mark.parametrize("script, runs, want", [
    ([0], [], (True, None)),
    ([platform.NO_DEVICE_EXIT], [], (False, "no CUDA device present")),
    # the early attempt hangs: it is killed, and the retry runs as usual
    ([subprocess.TimeoutExpired("probe", 1.0), 0], [0], (True, None)),
    ([1], [0], (True, None)),
])
def test_an_early_probe_is_the_first_attempt(monkeypatch, script, runs,
                                             want):
    """``start_probe`` runs the first attempt in the background (a daemon
    starts it before importing torch); ``probe_accelerator`` takes its
    answer, and a failed or hung early attempt counts as attempt 0."""
    _FakePopen.script, _FakePopen.started = script, []
    monkeypatch.setattr(platform.subprocess, "Popen", _FakePopen)
    stub = _Stub(runs or [RuntimeError("no second attempt expected")])
    monkeypatch.setattr(platform.subprocess, "run", stub)
    platform.start_probe()
    platform.start_probe()  # once only
    assert len(_FakePopen.started) == 1
    assert platform.probe_accelerator(retries=2, timeout_s=1.0,
                                      backoff_s=0.0) == want
    assert stub.calls == len(runs)
    assert _FakePopen.started[0].killed == isinstance(script[0],
                                                      BaseException)
    platform.start_probe()  # a verdict exists: no new attempt
    assert len(_FakePopen.started) == 1


def test_forget_probe_reaps_an_unused_early_probe(monkeypatch):
    _FakePopen.script, _FakePopen.started = [0], []
    monkeypatch.setattr(platform.subprocess, "Popen", _FakePopen)
    platform.start_probe()
    platform.forget_probe()
    assert _FakePopen.started[0].killed and platform._early is None
