"""The port's in-process workloads against the JAX package's (whose
workload modules do not import JAX): bank, long-fork, adya-g2, causal,
causal-reverse and the cycle workloads' transaction generator, then the
CLI's ``test-all`` over the whole registry, on the CPU.

- Each generator gives the reference's op list from one seed, through
  each package's deterministic simulator (every ``rng`` draw in the
  reference's order).
- Each checker gives the reference's result, JSON-equal, on the same
  histories: recorded by the port's ``core.run`` against the workload's
  fake client, and mutated into invalid ones (a lost transfer, an
  overdraft, a long fork, a G2 pair, a causal inversion, a read that
  skips an acknowledged write).
- ``cli test-all --dummy --device cpu`` is valid over exactly the
  registry's names with ok ops in each (``tests/test_cli_web.py``'s
  test-all test), and ``cli analyze`` of each stored run gives the run's
  verdict.
"""

import glob
import json
import os

import pytest

from jepsen_tpu import generator as ref_gen
from jepsen_tpu import history as ref_history
from jepsen_tpu import independent as ref_ind
from jepsen_tpu import workloads as ref_workloads
from jepsen_tpu.generator import sim as ref_sim
from jepsen_tpu.workloads import adya as ref_adya
from jepsen_tpu.workloads import bank as ref_bank
from jepsen_tpu.workloads import causal as ref_causal
from jepsen_tpu.workloads import causal_reverse as ref_cr
from jepsen_tpu.workloads import long_fork as ref_lf
from jepsen_tpu.workloads.cycle import append as ref_append
from jepsen_tpu.workloads.cycle import wr as ref_wr
from jepsen_tpu_torch import cli
from jepsen_tpu_torch import core
from jepsen_tpu_torch import fake
from jepsen_tpu_torch import generator as port_gen
from jepsen_tpu_torch import history as port_history
from jepsen_tpu_torch import independent as port_ind
from jepsen_tpu_torch import workloads as port_workloads
from jepsen_tpu_torch.generator import sim as port_sim
from jepsen_tpu_torch.workloads import adya as port_adya
from jepsen_tpu_torch.workloads import bank as port_bank
from jepsen_tpu_torch.workloads import causal as port_causal
from jepsen_tpu_torch.workloads import causal_reverse as port_cr
from jepsen_tpu_torch.workloads import long_fork as port_lf
from jepsen_tpu_torch.workloads.cycle import append as port_append
from jepsen_tpu_torch.workloads.cycle import wr as port_wr

NODES = ["n1", "n2", "n3", "n4", "n5"]

PACKAGES = {
    "ref": dict(gen=ref_gen, sim=ref_sim, ind=ref_ind, bank=ref_bank,
                lf=ref_lf, adya=ref_adya, causal=ref_causal, cr=ref_cr,
                append=ref_append, wr=ref_wr),
    "port": dict(gen=port_gen, sim=port_sim, ind=port_ind, bank=port_bank,
                 lf=port_lf, adya=port_adya, causal=port_causal, cr=port_cr,
                 append=port_append, wr=port_wr),
}

BANK_TEST = {"accounts": list(range(8)), "max-transfer": 5,
             "total-amount": 100}

#: name → (simulator mode, workers, test map, the generator made from the
#: package's modules)
GENERATORS = {
    "list-append": ("perfect", 5, None, lambda m: m["gen"].limit(
        300, m["append"].gen({"key-count": 3}))),
    "rw-register": ("perfect", 5, None, lambda m: m["gen"].limit(
        300, m["wr"].test({"max-writes-per-key": 4})["generator"])),
    "rw-register-long-txns": ("perfect", 3, None, lambda m: m["gen"].limit(
        200, m["wr"].gen({"min-txn-length": 2, "max-txn-length": 8,
                          "key-count": 5, "max-writes-per-key": 3}))),
    "bank": ("perfect", 5, BANK_TEST, lambda m: m["gen"].limit(
        300, m["bank"].generator())),
    "long-fork": ("perfect", 5, None, lambda m: m["gen"].limit(
        300, m["lf"].generator(3))),
    "adya-g2": ("perfect", 10, None, lambda m: m["gen"].limit(
        200, m["adya"].g2_gen())),
    "causal": ("perfect", 5, None, lambda m: m["gen"].limit(
        150, m["causal"].test({"time-limit": 40})["generator"])),
    "causal-reverse": ("perfect", 5, None, lambda m: m["gen"].limit(
        300, m["cr"].workload({"nodes": NODES, "per-key-limit": 20})[
            "generator"])),
}


def _sim_ops(package: str, case: str, seed: int):
    m = PACKAGES[package]
    mode, n, test, build = GENERATORS[case]
    m["gen"].set_seed(seed)
    sim = m["sim"]

    def complete(ctx, inv):
        return {**inv, "type": "ok", "time": inv["time"] + sim.PERFECT_LATENCY}

    ops = sim.simulate(build(m), complete, ctx=sim.n_plus_nemesis_context(n),
                       test=test, seed=seed)
    return json.loads(json.dumps(sim.invocations(ops), default=list))


@pytest.mark.parametrize("case", sorted(GENERATORS))
def test_generators_give_the_reference_ops(case):
    for seed in (45100, 7):
        ref = _sim_ops("ref", case, seed)
        port = _sim_ops("port", case, seed)
        assert port == ref, (case, seed)
        assert ref, case
    # the parity has teeth: another seed changes a random generator's ops
    if case not in ("adya-g2",):
        assert _sim_ops("port", case, 45100) != _sim_ops("port", case, 8)


def test_registry_equals_the_reference():
    assert port_workloads.names() == ref_workloads.names()
    for name in port_workloads.names():
        port = port_workloads.workload(name, {"nodes": NODES, "device": "cpu"})
        ref = ref_workloads.workload(name, {"nodes": NODES})
        assert set(port) == set(ref), name
        for k in ("concurrency", "accounts", "max-transfer", "total-amount"):
            assert port.get(k) == ref.get(k), (name, k)


# ---------------------------------------------------------------------------
# checkers: recorded histories, and invalid ones made from them
# ---------------------------------------------------------------------------


def _run(name, client, n_ops, **opts):
    """One port ``core.run`` of the workload against its fake client,
    without a store."""
    wl = port_workloads.workload(name, {"nodes": NODES, "device": "cpu",
                                        **opts})
    test = {
        **{k: v for k, v in wl.items()
           if k not in ("generator", "checker", "concurrency")},
        "name": name,
        "nodes": NODES,
        "concurrency": wl.get("concurrency", len(NODES)),
        "client": client,
        "generator": port_gen.limit(n_ops, wl["generator"]),
        "checker": wl["checker"],
        "store?": False,
        "device": "cpu",
    }
    result = core.run(test)
    assert result["results"]["valid?"] is True, result["results"]
    return test, result["history"]


@pytest.fixture(scope="module")
def recorded():
    return {
        "bank": _run("bank", fake.BankAtomClient(), 400),
        "long-fork": _run("long-fork", fake.TxnAtomClient(), 400),
        "adya-g2": _run("adya-g2", fake.InsertOnceAtomClient(), 200),
        "causal": _run("causal", fake.CausalAtomClient(), 12,
                       **{"time-limit": 3}),
        "causal-reverse": _run("causal-reverse", fake.KeyedAtomSetClient(),
                               300),
    }


def _dicts(history):
    return [dict(op.to_dict()) for op in history]


def _ref_history(dicts):
    """The same ops as a reference history: KV values (lists here) become
    the reference's KV where the workload is keyed."""
    out = []
    for d in dicts:
        v = d["value"]
        if isinstance(v, port_ind.KV):
            d = {**d, "value": ref_ind.kv(v[0], v[1])}
        out.append(d)
    return ref_history.History.from_dicts(out)


def _port_history(dicts):
    return port_history.History.from_dicts(dicts)


def _json(result):
    def default(o):
        if hasattr(o, "to_dict"):
            return o.to_dict()
        if isinstance(o, (set, frozenset)):
            return sorted(o, key=str)
        return repr(o)

    return json.loads(json.dumps(result, default=default, sort_keys=True))


def _both(kind, test, dicts):
    """Each package's checker of ``kind`` on the same ops."""
    ref_chk, port_chk = {
        "bank": (lambda: ref_bank.checker(), lambda: port_bank.checker()),
        "bank-negative": (lambda: ref_bank.checker({"negative-balances?": True}),
                          lambda: port_bank.checker({"negative-balances?": True})),
        "long-fork": (lambda: ref_lf.checker(2), lambda: port_lf.checker(2)),
        "long-fork-3": (lambda: ref_lf.checker(3), lambda: port_lf.checker(3)),
        "adya-g2": (ref_adya.g2_checker, port_adya.g2_checker),
        "causal": (lambda: ref_ind.checker(ref_causal.check(
                       ref_causal.causal_register())),
                   lambda: port_ind.checker(port_causal.check(
                       port_causal.causal_register()))),
        "causal-reverse": (lambda: ref_ind.checker(ref_cr.checker()),
                           lambda: port_ind.checker(port_cr.checker())),
    }[kind]
    t = {**test, "store?": False}
    ref = ref_chk().check(t, _ref_history(dicts).index_ops(), {})
    port = port_chk().check(t, _port_history(dicts).index_ops(), {})
    return _json(ref), _json(port)


def _ok_reads(dicts, f="read"):
    return [i for i, d in enumerate(dicts) if d["type"] == "ok"
            and d["f"] == f]


def _bank_cases(dicts):
    reads = _ok_reads(dicts)
    assert len(reads) > 4
    lost = [dict(d) for d in dicts]
    i = reads[len(reads) // 2]
    v = dict(lost[i]["value"])
    v[0] -= 3  # a transfer whose credit never landed
    lost[i] = {**lost[i], "value": v}
    over = [dict(d) for d in dicts]
    for j, i in enumerate(reads[1:4]):
        v = dict(over[i]["value"])
        v[1], v[2] = -5 - j, v[2] + v[1] + 5 + j  # overdrawn, total kept
        over[i] = {**over[i], "value": v}
    odd = [dict(d) for d in dicts]
    odd[reads[0]] = {**odd[reads[0]],
                     "value": {**odd[reads[0]]["value"], 99: 0}}
    odd[reads[-1]] = {**odd[reads[-1]],
                      "value": {**odd[reads[-1]]["value"], 3: None}}
    return {"valid": dicts, "lost-transfer": lost, "overdrawn": over,
            "unexpected-and-nil": odd}


def test_bank_checker_equals_the_reference(recorded):
    test, history = recorded["bank"]
    for case, dicts in _bank_cases(_dicts(history)).items():
        for kind in ("bank", "bank-negative"):
            ref, port = _both(kind, test, dicts)
            assert port == ref, (case, kind)
            if case == "valid" or (case == "overdrawn"
                                   and kind == "bank-negative"):
                assert ref["valid?"] is True, (case, kind)
            else:
                assert ref["valid?"] is False, (case, kind)


def test_bank_checker_reads_stored_account_ids(recorded):
    """JSON turns a balance map's integer account ids into strings: the
    port maps them back (the reference reports each as unexpected)."""
    test, history = recorded["bank"]
    dicts = _bank_cases(_dicts(history))["lost-transfer"]
    stored = json.loads(json.dumps(dicts))
    live = port_bank.checker().check(test, _port_history(dicts), {})
    back = port_bank.checker().check(test, _port_history(stored), {})
    assert back["valid?"] is False and back["errors"].keys() == \
        live["errors"].keys() == {"wrong-total"}
    assert back["error-count"] == live["error-count"]
    ref = ref_bank.checker().check(test, ref_history.History.from_dicts(
        stored), {})
    assert set(ref["errors"]) == {"unexpected-key"}


def _long_fork_fork():
    """The module docstring's fork: T3 sees y but not x, T4 x but not y."""
    ops = [
        (0, "invoke", "write", [["w", 0, 1]]), (1, "invoke", "write",
                                                 [["w", 1, 1]]),
        (0, "ok", "write", [["w", 0, 1]]), (1, "ok", "write", [["w", 1, 1]]),
        (2, "invoke", "read", [["r", 0, None], ["r", 1, None]]),
        (3, "invoke", "read", [["r", 1, None], ["r", 0, None]]),
        (2, "ok", "read", [["r", 0, None], ["r", 1, 1]]),
        (3, "ok", "read", [["r", 1, None], ["r", 0, 1]]),
    ]
    return [{"type": t, "process": p, "f": f, "value": v, "time": i}
            for i, (p, t, f, v) in enumerate(ops)]


def test_long_fork_checker_equals_the_reference(recorded):
    test, history = recorded["long-fork"]
    dicts = _dicts(history)
    fork = _long_fork_fork()
    twice = fork + [{"type": "invoke", "process": 4, "f": "write",
                     "value": [["w", 0, 1]], "time": 99}]
    # a read of a group of three where the checker expects two
    missized = [dict(d) for d in dicts]
    i = _ok_reads(missized)[0]
    missized[i] = {**missized[i], "value": missized[i]["value"] + [
        ["r", 10 ** 6, None]]}
    cases = {"valid": ("long-fork", dicts, True),
             "fork": ("long-fork", fork, False),
             "fork-inside-a-run": ("long-fork", dicts + [
                 {**d, "process": d["process"] + 100,
                  "value": [[m[0], m[1] + 10 ** 6, m[2]] for m in d["value"]],
                  "time": d["time"] + 10 ** 12}
                 for d in fork], False),
             "multiple-writes": ("long-fork", twice, "unknown"),
             "mis-sized-group": ("long-fork", missized, "unknown"),
             "group-of-3": ("long-fork-3", dicts, "unknown")}
    for case, (kind, ds, want) in cases.items():
        ref, port = _both(kind, test, ds)
        assert port == ref, case
        assert ref["valid?"] == want, (case, ref)


def test_adya_g2_checker_equals_the_reference(recorded):
    test, history = recorded["adya-g2"]
    dicts = _dicts(history)
    g2 = [dict(d) for d in dicts]
    # a key whose second insert also committed: the G2 pair
    fails = [i for i, d in enumerate(g2)
             if d["type"] == "fail" and d["f"] == "insert"]
    assert fails
    for i in fails[:2]:
        g2[i] = {**g2[i], "type": "ok"}
    for case, ds, want in (("valid", dicts, True), ("g2", g2, False)):
        ref, port = _both("adya-g2", test, ds)
        assert port == ref, case
        assert ref["valid?"] is want and ref["key-count"] > 0, case
    # a stored history (lists for KVs): the port re-keys, the reference
    # counts no key
    stored = json.loads(json.dumps(g2, default=list))
    back = port_adya.g2_checker().check(test, _port_history(stored), {})
    assert _json(back) == _json(port_adya.g2_checker().check(
        test, _port_history(g2), {}))
    ref_back = ref_adya.g2_checker().check(
        test, ref_history.History.from_dicts(stored), {})
    assert ref_back["key-count"] == 0 and ref_back["valid?"] is True


def test_causal_checker_equals_the_reference(recorded):
    test, history = recorded["causal"]
    dicts = _dicts(history)
    oks = [i for i, d in enumerate(dicts) if d["type"] == "ok"]
    assert oks
    # a read that sees a value the register never held
    inverted = [dict(d) for d in dicts]
    reads = [i for i in oks if inverted[i]["f"] in ("read", "read-init")]
    assert reads
    k = inverted[reads[-1]]["value"]
    inverted[reads[-1]] = {**inverted[reads[-1]],
                           "value": port_ind.kv(k[0], 7)}
    # hand-made keyed history: write 1 after write 2, so the model rejects
    # it; and one whose ops carry position/link markers
    def op(i, t, f, v, **kw):
        return {"type": t, "process": 0, "f": f,
                "value": port_ind.kv(3, v), "time": i, **kw}

    out_of_order = [op(0, "invoke", "read-init", None),
                    op(1, "ok", "read-init", 0),
                    op(2, "invoke", "write", 2), op(3, "ok", "write", 2)]
    linked = [op(0, "invoke", "read-init", None),
              op(1, "ok", "read-init", 0, position=1, link="init"),
              op(2, "invoke", "write", 1),
              op(3, "ok", "write", 1, position=2, link=1),
              op(4, "invoke", "read", None),
              op(5, "ok", "read", 1, position=3, link=9)]
    for case, ds, want in (("valid", dicts, True), ("inverted", inverted,
                                                    False),
                           ("out-of-order", out_of_order, False),
                           ("bad-link", linked, False),
                           ("good-link", linked[:4], True)):
        ref, port = _both("causal", test, ds)
        assert port == ref, case
        assert ref["valid?"] is want, (case, ref)


def test_causal_reverse_checker_equals_the_reference(recorded):
    test, history = recorded["causal-reverse"]
    dicts = _dicts(history)
    # a read, after the run, that observes the last acknowledged write of
    # a key but misses the earlier ones (the workload's read is a map
    # generator, so a run reads each key about once)
    writes = [d for d in dicts if d["type"] == "ok" and d["f"] == "write"]
    assert len(writes) > 2
    k, last = writes[-1]["value"]
    end = dicts[-1]["time"]
    skew = dicts + [
        {"type": "invoke", "process": 99, "f": "read",
         "value": port_ind.kv(k, None), "time": end + 1},
        {"type": "ok", "process": 99, "f": "read",
         "value": port_ind.kv(k, [last]), "time": end + 2}]
    for case, ds, want in (("valid", dicts, True), ("skew", skew, False)):
        ref, port = _both("causal-reverse", test, ds)
        assert port == ref, case
        assert ref["valid?"] is want, case


# ---------------------------------------------------------------------------
# the CLI: test-all over the registry, then analyze of each stored run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def test_all_store(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("test-all"))
    rc = cli.run_cli(cli.default_commands(), [
        "test-all", "--dummy", "--device", "cpu", "--time-limit", "1",
        "--store-base", base,
    ])
    return rc, base


def test_cli_test_all_runs_every_in_process_workload(test_all_store):
    rc, base = test_all_store
    assert rc == cli.EXIT_VALID
    ran = {n for n in os.listdir(base)
           if not n.startswith((".", "latest", "current"))}
    assert ran == set(port_workloads.names()), ran
    for w in ran:
        hist = sorted(glob.glob(os.path.join(base, w, "*",
                                             "history.jsonl")))[-1]
        n_ok = sum(1 for line in open(hist)
                   if json.loads(line)["type"] == "ok")
        assert n_ok > 0, f"{w}: no successful ops — wrong fake client?"


@pytest.mark.parametrize("name", sorted(port_workloads.names()))
def test_cli_analyze_gives_each_stored_runs_verdict(test_all_store, name,
                                                    capsys):
    rc, base = test_all_store
    run_dir = sorted(glob.glob(os.path.join(base, name, "2*")))[-1]
    with open(os.path.join(run_dir, "results.json")) as f:
        stored = json.load(f)
    capsys.readouterr()
    code = cli.run_cli(cli.default_commands(), [
        "analyze", "--test-name", name, "--store-base", base, "--device",
        "cpu",
    ])
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    assert code == cli.EXIT_VALID and stored["valid?"] is True
    assert printed["valid?"] == stored["valid?"]
    # the re-check looked at the stored ops, not an empty history: the
    # keys (or reads, or transactions) it counted are the run's
    for path in SIZES[name]:
        got, want = printed, stored
        for k in path:
            got, want = got[k], want[k]
        if isinstance(want, dict):
            got, want = sorted(got), sorted(want)
        assert got == want and want, (name, path)


#: per workload, the parts of its result that show what it checked
SIZES = {
    "adya-g2": [("key-count",)],
    "bank": [("SI", "read-count")],
    "causal": [("results",)],
    "causal-reverse": [("sequential", "results")],
    "linearizable-register": [("linearizable", "results")],
    "list-append": [("txn-count",)],
    "long-fork": [("reads-count",)],
    "rw-register": [("txn-count",)],
}


def test_cli_test_all_folds_a_crash_into_the_worst_exit(tmp_path):
    """A workload whose run raises (no CUDA and no ``--device cpu``)
    exits 255 for the sweep, after every workload was tried."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this case needs a host without CUDA")
    rc = cli.run_cli(cli.default_commands(), [
        "test-all", "--dummy", "--time-limit", "1",
        "--store-base", str(tmp_path),
    ])
    assert rc == cli.EXIT_CRASH
