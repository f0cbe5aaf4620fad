"""The port's test harness end to end on the CPU: ``core.run`` of the
linearizable-register workload (``device="cpu"``, the plain versions),
checked again by the JAX package's batched lift on the same history; the
CLI's ``test`` and ``analyze``; the refusal without CUDA; and online
checking through the port's CPU daemon.

Threaded runs are not reproducible, so every run is held by invariants
and by the reference's verdicts on the history it recorded.  Tolerance:
exact — the per-key results equal the reference's after mapping its
engine name ``"tpu"`` to ``"gpu"``.  Runs are bounded by ``gen.limit``
op counts, not wall-clock limits, except the CLI's ``--time-limit``.
"""

import glob
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import history as ref_history
from jepsen_tpu import independent as ref_ind
from jepsen_tpu import models as ref_models
from jepsen_tpu import store as ref_store
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu_torch import checker as checker_mod
from jepsen_tpu_torch import cli, core, fake, models, nemesis, store
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent, workloads
from jepsen_tpu_torch.history import NEMESIS
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.serve import client as serve_client
from jepsen_tpu_torch.serve import protocol
from jepsen_tpu_torch.serve.client import ServiceClient
from jepsen_tpu_torch.serve.daemon import CheckerDaemon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = ["n1", "n2", "n3"]
JOIN_S = 60


@pytest.fixture(autouse=True)
def _exact_reference_and_one_thread(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    serve_client.reset_breakers()
    yield
    torch.set_num_threads(n)
    serve_client.reset_breakers()


def gpu_names(x):
    if isinstance(x, dict):
        return {gpu_names(k): gpu_names(v) for k, v in x.items()}
    if isinstance(x, list):
        return [gpu_names(v) for v in x]
    return "gpu" if x == "tpu" else x


class StaleReadClient(fake.KeyedAtomClient):
    """The keyed CAS-register fake, but every ``stale_every``-th read
    answers a value other than the register's (a stale read), and every
    ``crash_every``-th invoke crashes before it applies (an ``:info``
    op and a retired process)."""

    def __init__(self, stale_every=13, crash_every=0, shared=None):
        super().__init__()
        self.stale_every = stale_every
        self.crash_every = crash_every
        self.shared = shared if shared is not None else {
            "n": 0, "lock": threading.Lock()}

    def open(self, test, node):
        c = StaleReadClient(self.stale_every, self.crash_every, self.shared)
        c.registers, c.lock = self.registers, self.lock
        return c

    def invoke(self, test, op):
        with self.shared["lock"]:
            self.shared["n"] += 1
            n = self.shared["n"]
        if self.crash_every and n % self.crash_every == 0:
            raise RuntimeError("crashed before applying")
        res = super().invoke(test, op)
        if (op["f"] == "read" and self.stale_every
                and n % self.stale_every == 0):
            k, v = res["value"]
            res = {**res, "value": independent.kv(k, ((v or 0) + 1) % 5)}
        return res


class StartStop(nemesis.Nemesis):
    """An in-process fault with no network: start and stop flip a flag."""

    def __init__(self):
        self.active = False

    def invoke(self, test, op):
        self.active = op["f"] == "start"
        return {**op, "type": "info", "value": self.active}

    def fs(self):
        return {"start", "stop"}


def _workload_test(tmp_path, n_ops, client, nem=None, **opts):
    wl = workloads.workload("linearizable-register", {
        "nodes": NODES, "per-key-limit": 16, "device": "cpu", **opts})
    g = gen.limit(n_ops, wl["generator"])
    if nem is not None:
        g = gen.any(g, gen.nemesis(gen.delay(0.005, [
            {"f": "fault-start"}, {"f": "fault-stop"}] * 4)))
    return {
        "name": "linearizable-register",
        "nodes": NODES,
        "concurrency": wl["concurrency"],
        "client": client,
        "nemesis": nem or nemesis.noop(),
        "generator": g,
        "checker": wl["checker"],
        "store-base": str(tmp_path / "store"),
        "device": "cpu",
    }


def _ref_rechecked(history, test):
    """The JAX package's batched lift over the port's history."""
    ops = []
    for d in history.to_dicts():
        v = d["value"]
        if isinstance(v, independent.KV):
            d = {**d, "value": ref_ind.kv(v[0], v[1])}
        ops.append(d)
    rh = ref_history.History.from_dicts(ops).index_ops()
    return ref_checker.check_safe(
        ref_ind.batched_linearizable(ref_models.cas_register()),
        {**test, "store?": False}, rh, {})


@pytest.fixture(scope="module")
def stale_run(tmp_path_factory):
    """One ``core.run`` with stale reads, crashes and an in-process
    nemesis through ``validate`` and ``f_map``."""
    tmp = tmp_path_factory.mktemp("harness")
    nem = nemesis.f_map(lambda f: f"fault-{f}", StartStop())
    test = _workload_test(tmp, 700, StaleReadClient(13, crash_every=11),
                          nem=nem)
    return core.run(test), tmp


def test_core_run_results_equal_the_reference_on_its_history(stale_run):
    result, _ = stale_run
    lin = result["results"]["linearizable"]
    ref = _ref_rechecked(result["history"], result)
    assert lin["results"] == gpu_names(ref["results"])
    assert lin["failures"] == ref["failures"]
    assert lin["valid?"] is False and ref["valid?"] is False
    assert lin["batch-stats"] == gpu_names(ref["batch-stats"])
    # every key within the dense envelope: the register automaton
    assert set(lin["batch-stats"]["engines"]) == {"gpu"}
    assert result["results"]["valid?"] is False


def test_core_run_history_carries_faults_crashes_and_nemesis_ops(stale_run):
    result, _ = stale_run
    h = result["history"]
    assert [op.index for op in h] == list(range(len(h)))
    client_invokes = [op for op in h
                      if op.type == "invoke" and op.process != NEMESIS]
    assert len(client_invokes) == 700
    infos = [op for op in h if op.type == "info" and op.process != NEMESIS]
    assert infos and all(op.extra["error"].startswith("indeterminate:")
                         for op in infos)
    # crashed processes are retired: none invokes again
    crashed_at = {op.process: op.index for op in infos}
    assert not [op for op in h if op.type == "invoke"
                and op.index > crashed_at.get(op.process, len(h))]
    faults = [op for op in h if op.process == NEMESIS]
    assert {op.f for op in faults} == {"fault-start", "fault-stop"}
    # each key's subhistory holds every nemesis op at its place, as the
    # reference's does, and the ops the lift checks are exactly the key's
    # own client ops
    own = {}
    for op in h:
        if isinstance(op.value, independent.KV):
            own.setdefault(op.value.key, []).append(
                (op.index, op.type, op.f, op.value.value))
    subs = independent.split_by_key(h)
    assert set(subs) == set(own)
    for k, sub in subs.items():
        assert [op.index for op in sub if op.process == NEMESIS] == \
            [op.index for op in faults]
        assert [(op.index, op.type, op.f, op.value)
                for op in sub.client_ops()] == own[k]
    assert result["results"]["timeline"]["valid?"] is True


def test_core_run_store_loads_in_both_packages(stale_run):
    result, _ = stale_run
    key = {k: result[k] for k in ("name", "start-time", "store-base")}
    ours, ref = store.load(key), ref_store.load(key)
    assert [op.to_dict() for op in ours["history"]] == \
        [op.to_dict() for op in ref["history"]]
    assert ours["results"] == ref["results"]
    assert ours["results"]["linearizable"]["failures"] == \
        result["results"]["linearizable"]["failures"]
    assert len(ours["history"]) == len(result["history"])
    # the reloaded history, checked again, gives the run's per-key results
    again = independent.batched_linearizable(
        models.cas_register(), device="cpu").check(
            {**key, "store?": False}, ours["history"], {})
    assert json.loads(json.dumps(again["results"])) == \
        ours["results"]["linearizable"]["results"]
    # the per-key artifacts of the batched lift
    d = store.test_dir(result)
    assert len(glob.glob(os.path.join(d, "independent", "*",
                                      "results.json"))) == \
        len(result["results"]["linearizable"]["results"])
    for name in ("results.json", "history.jsonl", "trace.json",
                 "metrics.prom", "jepsen.log"):
        assert os.path.exists(os.path.join(d, name)), name


def test_core_run_valid_with_the_honest_client(tmp_path):
    test = _workload_test(tmp_path, 300, fake.KeyedAtomClient())
    result = core.run({**test, "store?": False})
    assert result["results"]["valid?"] is True
    ref = _ref_rechecked(result["history"], result)
    assert result["results"]["linearizable"]["results"] == \
        gpu_names(ref["results"])
    assert result["obs-summary"]["phases"]


def test_core_run_refuses_tracing(tmp_path):
    """``tracing`` was refused while ``trace.py`` was not ported; now a
    traced run appends one span per client call to the endpoint and turns
    the tracer off again when it ends."""
    from jepsen_tpu_torch import trace

    spans = tmp_path / "spans.jsonl"
    test = trace.wire(_workload_test(tmp_path, 10, fake.KeyedAtomClient()),
                      str(spans))
    assert isinstance(test["client"], trace.Traced)
    core.run(test)
    names = [json.loads(line)["name"] for line in open(spans)]
    assert names.count("client.invoke") == 10
    assert not trace._tracer.sample


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

#: runs the CLI in a fresh interpreter that refuses jax, jaxlib and
#: jepsen_tpu by exact top-level name
_REFUSING_CLI = textwrap.dedent("""
    import importlib.abc, runpy, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in {"jax", "jaxlib", "jepsen_tpu"}:
                raise ImportError(f"the port must not import {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.argv = ["jepsen_tpu_torch.cli"] + sys.argv[1:]
    runpy.run_module("jepsen_tpu_torch.cli", run_name="__main__")
""")


@pytest.fixture(scope="module")
def cli_store(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("cli") / "store")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _REFUSING_CLI, "test", "--workload",
         "linearizable-register", "--device", "cpu", "--time-limit", "3",
         "--store-base", base],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    return out, base


def test_cli_test_runs_on_the_cpu_without_the_reference(cli_store):
    out, base = cli_store
    assert out.returncode == 0, out.stderr[-3000:]
    assert "run phases" in out.stdout
    [path] = glob.glob(os.path.join(base, "linearizable-register", "2*",
                                    "results.json"))
    with open(path) as f:
        results = json.load(f)
    assert results["valid?"] is True
    lin = results["linearizable"]
    assert set(lin["batch-stats"]["engines"]) == {"gpu"}
    assert lin["batch-stats"]["kernels"] == {"dense": len(lin["results"])}


def test_cli_analyze_rechecks_the_store(cli_store, capsys):
    out, base = cli_store
    assert out.returncode == 0
    code = cli.run_cli(cli.default_commands(), [
        "analyze", "--test-name", "linearizable-register", "--device",
        "cpu", "--store-base", base])
    assert code == cli.EXIT_VALID
    printed = json.loads(capsys.readouterr().out)
    [path] = glob.glob(os.path.join(base, "linearizable-register", "2*",
                                    "results.json"))
    with open(path) as f:
        stored = json.load(f)
    assert printed["linearizable"]["results"] == \
        stored["linearizable"]["results"]
    assert printed["valid?"] is True


def test_cli_analyze_runs_where_the_command_line_says(cli_store,
                                                     monkeypatch, capsys):
    """The stored map says ``device: cpu`` (the run was checked there);
    an ``analyze`` without ``--device`` still needs the card."""
    out, base = cli_store
    assert out.returncode == 0
    assert store.latest(base)["device"] == "cpu"
    argv = ["analyze", "--test-name", "linearizable-register",
            "--store-base", base]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.run_cli(cli.default_commands(), argv) == cli.EXIT_CRASH
    assert "CUDA is not available" in capsys.readouterr().err
    # with the card stubbed usable, the analysis goes to the card's
    # device (None), not to the stored "cpu"; the stub checks on the CPU
    ensured, devices = [], []
    monkeypatch.setattr(cli, "ensure_device",
                        lambda test: ensured.append(test.get("device")))
    check_batch = wgl.check_batch

    def on_the_card(model, subs, **kw):
        devices.append(kw.get("device"))
        return check_batch(model, subs, **{**kw, "device": "cpu"})

    monkeypatch.setattr(wgl, "check_batch", on_the_card)
    assert cli.run_cli(cli.default_commands(), argv) == cli.EXIT_VALID
    assert ensured == [None] and devices == [None]
    capsys.readouterr()
    assert cli.run_cli(cli.default_commands(),
                       argv + ["--device", "cuda:0"]) == cli.EXIT_VALID
    assert ensured == [None, "cuda:0"] and devices == [None, "cuda:0"]


def test_cli_without_cuda_and_without_device_cpu_raises(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = str(tmp_path / "store")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.ensure_device({})
    code = cli.run_cli(cli.default_commands(), [
        "test", "--time-limit", "1", "--store-base", base])
    assert code == cli.EXIT_CRASH
    assert not os.path.exists(base)  # the run never started
    cli.ensure_device({"device": "cpu"})


def test_cli_engine_window_and_device_reach_the_test_map():
    cmds = cli.default_commands()
    import argparse

    p = argparse.ArgumentParser()
    cmds["test"]["add_opts"](p)
    args = p.parse_args(["--engine-window", "2", "--device", "cpu",
                         "--concurrency", "3n", "--nodes", "a,b"])
    t = cli.test_opts_to_map(args)
    assert t["engine-window"] == 2 and t["device"] == "cpu"
    assert t["concurrency"] == 6 and t["nodes"] == ["a", "b"]
    with pytest.raises(SystemExit):
        p.parse_args(["--engine-window", "0"])


# ---------------------------------------------------------------------------
# online checking: the live shipper against the port's CPU daemon
# ---------------------------------------------------------------------------


def test_the_live_shipper_reaches_watch_with_the_post_hoc_verdict(tmp_path):
    wal = str(tmp_path / "wal.jsonl")
    d = CheckerDaemon(port=0, device="cpu", wal_path=wal)
    d.start(block=False)
    try:
        client = ServiceClient(port=d.port)
        seen = []
        watcher = threading.Thread(target=lambda: seen.extend(
            client.watch(timeout=JOIN_S)), daemon=True)
        watcher.start()
        state = fake.AtomState(0)
        model = models.cas_register(0)

        def rand_op(test, ctx):
            f = gen.rng.choice(["read", "write", "cas"])
            if f == "read":
                return {"f": "read", "value": None}
            if f == "write":
                return {"f": "write", "value": gen.rng.randrange(5)}
            return {"f": "cas", "value": [gen.rng.randrange(5),
                                          gen.rng.randrange(5)]}

        test = {"name": "live", "nodes": NODES, "concurrency": 3,
                "client": fake.AtomClient(state, latency=0.0),
                "generator": gen.clients(gen.limit(120, rand_op)),
                "model": model, "live-client": client, "store?": False,
                "checker": checker_mod.unbridled_optimism()}
        result = core.run(test)
        post_hoc = wgl.check_batch(model, [result["history"].client_ops()],
                                   device="cpu")
        deadline = time.monotonic() + JOIN_S
        while not seen and time.monotonic() < deadline:
            time.sleep(0.05)
        status = d.status()
    finally:
        d.stop()
    watcher.join(JOIN_S)
    assert status["feed_sessions"] == 1 and status["feed_deltas"] >= 1
    assert seen, "no verdict reached /watch"
    last = seen[-1][1]["result"]

    def canon(r):
        return json.dumps(protocol.sanitize_results([r]), sort_keys=True)

    assert canon(last) == canon(post_hoc[0])
    assert last["valid?"] is True
    ref = ref_wgl.check_batch(ref_models.cas_register(0), [
        ref_history.History.from_dicts(
            result["history"].client_ops().to_dicts())])
    assert canon(last) == canon(gpu_names(ref[0]))


def test_no_live_client_ships_nothing():
    from jepsen_tpu_torch import interpreter

    assert interpreter._make_shipper({"model": models.cas_register(0)}) \
        is None
