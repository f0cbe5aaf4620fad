"""The localkv suite on the port: ``native/repregd.cc`` compiled on each
node through the control layer, real replicas as daemons, the partition
and kill nemeses against them mid-workload, logs snarfed, the history
checked — ``tests/test_localkv_suite.py``'s run at its settings (3
nodes, 8 s, concurrency 6, rate 30), with the analysis on the plain
PyTorch versions (``device="cpu"``).

It asserts what the reference's test asserts, and that the reference's
``linearizable(cas_register(0))`` gives the port's result on the
recorded history.  The CLI runs the same suite (``test --suite localkv``)
and ``analyze`` re-checks the stored run to the same result.  Each test
kills its replicas and waits for every thread the run started to end.
"""

import json
import os
import shutil
import subprocess
import threading
import time

import pytest
import torch

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import history as ref_history
from jepsen_tpu import models as ref_models
from jepsen_tpu_torch import checker, cli, core, models, suites

needs_cluster = pytest.mark.skipif(
    shutil.which("start-stop-daemon") is None or shutil.which("g++") is None,
    reason="needs start-stop-daemon and g++",
)

JOIN_S = 30


@pytest.fixture(autouse=True)
def _exact_reference_and_one_thread(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_FRONTIER_COMPACTION", "sort")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def own_threads():
    """Fails the test if a thread the run started outlives it (the
    forwarders' accept and pump threads, the interpreter's workers).  The
    port's oracle pool (``jepsen-oracle_*``) is one per process, grows its
    workers on demand and idles; its first run may start in the test."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + JOIN_S
    while True:
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()
                and not t.name.startswith("jepsen-oracle")]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, left


def _kill_replicas(base):
    subprocess.run(["pkill", "-9", "-f", str(base)], capture_output=True)


def gpu_names(x):
    if isinstance(x, dict):
        return {gpu_names(k): gpu_names(v) for k, v in x.items()}
    if isinstance(x, list):
        return [gpu_names(v) for v in x]
    return "gpu" if x == "tpu" else x


def _reference_result(history_dicts):
    rh = ref_history.History.from_dicts(history_dicts).index_ops()
    return gpu_names(ref_checker.check_safe(
        ref_checker.linearizable(ref_models.cas_register(0)), {}, rh))


def _check_run(history, results, store_base, start_time):
    oks = [o for o in history if o.type == "ok"
           and isinstance(o.process, int)]
    nem_fs = {o.f for o in history
              if o.process == "nemesis" and o.type == "info"}
    assert len(oks) > 20, "workload barely ran"
    assert nem_fs & {"start-partition", "start-kill", "kill"}, nem_fs
    assert results["valid?"] is True, {k: v for k, v in results.items()
                                       if k != "history"}
    # install really happened on-node: the snarfed daemon log records
    # the compiled binary's startup (teardown removed the node dirs)
    base = os.path.join(store_base, "localkv", start_time)
    log_copy = os.path.join(base, "n1", "server.log")
    assert os.path.exists(log_copy), os.listdir(base)
    assert "repregd" in open(log_copy).read()
    for svg in ("latency-raw.svg", "latency-quantiles.svg", "rate.svg"):
        assert os.path.exists(os.path.join(base, svg)), svg
    return base


@needs_cluster
def test_localkv_full_run_partition_and_kill(tmp_path, own_threads):
    localkv = suites.suite("localkv")
    t = localkv.test(
        {
            "nodes": ["n1", "n2", "n3"],
            "dir": str(tmp_path / "localkv"),
            "store-base": str(tmp_path / "store"),
            "store?": True,
            "faults": ["partition", "kill"],
            "interval": 2,
            "time-limit": 8,
            "concurrency": 6,
            "rate": 30,
            "device": "cpu",
        }
    )
    try:
        result = core.run(t)
    finally:
        _kill_replicas(tmp_path / "localkv")
    r = result["results"]
    hist = result["history"]
    _check_run(hist, r, str(tmp_path / "store"), result["start-time"])
    # the reference's checker on the recorded history gives the port's
    # result, whole
    port = checker.check_safe(
        checker.linearizable(models.cas_register(0), device="cpu"), {},
        hist)
    assert port == r["workload"]
    assert _reference_result(hist.to_dicts()) == port
    assert not os.path.exists(str(tmp_path / "localkv" / "n1"))


@needs_cluster
def test_the_cli_runs_localkv_and_analyze_agrees(tmp_path, own_threads,
                                                 capsys):
    store = str(tmp_path / "store")
    argv = ["test", "--suite", "localkv", "--faults", "partition,kill",
            "--nodes", "n1,n2,n3", "--time-limit", "6", "--concurrency",
            "6", "--rate", "30", "-o", "interval=2", "-o",
            f"dir={tmp_path / 'nodes'}", "--store-base", store,
            "--device", "cpu"]
    try:
        assert cli.run_cli(cli.default_commands(), argv) == cli.EXIT_VALID
    finally:
        _kill_replicas(tmp_path / "nodes")
    (run_dir,) = [d for d in os.listdir(os.path.join(store, "localkv"))
                  if d != "latest"]
    stored = json.load(open(os.path.join(store, "localkv", run_dir,
                                         "results.json")))
    capsys.readouterr()
    # analyze rebuilds the suite's checker from the stored suite name
    assert cli.run_cli(cli.default_commands(), [
        "analyze", "--test-name", "localkv", "--store-base", store,
        "--device", "cpu"]) == cli.EXIT_VALID
    again = json.loads(capsys.readouterr().out)
    assert again["workload"] == stored["workload"]
    assert set(again) >= {"workload", "stats", "exceptions", "perf"}
    assert os.path.exists(os.path.join(store, "localkv", run_dir, "n3",
                                       "server.log"))


def test_unported_and_unknown_suites():
    with pytest.raises(NotImplementedError, match="suites/faunadb.py"):
        suites.suite("faunadb")
    with pytest.raises(NotImplementedError, match="mongodb_rocks"):
        suites.suite("mongodb-rocks")
    with pytest.raises(KeyError):
        suites.suite("no-such-db")
    assert suites.SUITES == ("cockroachdb", "consul", "dgraph", "disque",
                             "etcd", "galera", "localkv", "mysql_cluster",
                             "percona", "postgres_rds", "raftis", "stolon",
                             "tidb", "yugabyte", "zookeeper")
    from jepsen_tpu import suites as ref_suites

    assert suites.REFERENCE_SUITES == ref_suites.SUITES
    assert cli.run_cli(cli.default_commands(), [
        "test", "--suite", "faunadb", "--device", "cpu"]) == cli.EXIT_CRASH


def test_the_suite_test_map_needs_no_side_effects(tmp_path):
    t = suites.suite("localkv").test({"dir": str(tmp_path / "d"),
                                      "device": "cpu", "rate": 10})
    assert t["nodes"] == ["n1", "n2", "n3"] and t["name"] == "localkv"
    assert t["device"] == "cpu" and t["net"] is t["db"].net
    assert not t["db"].ports and not os.path.exists(str(tmp_path / "d"))
    traced = suites.suite("localkv").test({"tracing": "spans.jsonl"})
    assert traced["tracing"] == "spans.jsonl"
    assert type(traced["client"]).__name__ == "Traced"
