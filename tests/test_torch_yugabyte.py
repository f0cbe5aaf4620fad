"""The yugabyte suite on the port — ``jepsen_tpu_torch.suites.yugabyte``,
its CQL client ``jepsen_tpu_torch.suites.proto.cql`` and its fault menu
``jepsen_tpu_torch.suites.yb_nemesis`` — against the JAX package's.

Every command here runs on a recording remote (each package's
``DummyRemote``): nothing installs YugabyteDB, starts, stops, kills or
pauses a master or a tserver, or sets a clock on the machine the tests
run on.

- **The CQL client.**  Against ``FakeCql`` behind a recording relay, the
  reference's ``CqlClient`` and the port's give the same results, the
  same errors (a write timeout is ``CqlError.timeout``) and the same
  request bytes; RESULT frames of every column type decode alike.
- **Clients.**  The YCQL and YSQL clients' completions and bytes are
  ``CLIENT_CASES`` rows of ``tests/test_torch_suites.py``; here, a
  server that times out every LWT and transaction gives ``info`` (not
  ``fail``) in both packages, and the reference's own round trips pass
  on the port.
- **Commands.**  ``YugabyteDB``'s masters on the first RF nodes and
  tservers everywhere, each component's start, stop and kill; every f of
  the process nemesis and the full composition's partitions and clock:
  the same answers and commands, node by node.
- **Op lists.**  Every workload's generator, the whole test's, and each
  fault schedule (mixed, final, long-recovery) give the reference's ops
  from one seed.
- **Full runs** against ``FakeCql`` and ``FakePg`` (``db`` noop, ``ssh``
  dummy, no faults, ``time-limit`` 2) on the plain versions:
  ``ycql.register``, ``ycql.multi-key-acid``, ``ysql.multi-key-acid``,
  ``ycql.bank`` and ``ysql.default-value`` come out valid (the last by
  its own checker: its stats verdict depends on the run's draw), the
  reference's checker gives the port's result on the run's history
  (exact equality), and the register and multi-register keys equal the
  CPU oracle's.  The multi-register per-key histories through
  ``check_batch(decomposed=False)`` equal the reference's.
- **The CLI**'s ``test --suite yugabyte|dgraph`` builds each suite's test
  with its fault menu.
"""

import json
import random
import struct

import pytest

from fake_servers import FakeCql, FakePg, _CqlHandler
from test_torch_clock_faults import _drain, _sim_ops, normal, on_remote
from test_torch_proto import outcome, run_both
from test_torch_suites import (_check_both, _h, _port_history, _ref_history,
                               _sim, own_threads, plain)
from jepsen_tpu import independent as ref_ind
from jepsen_tpu import models as ref_models
from jepsen_tpu.ops import wgl as ref_wgl
from jepsen_tpu.suites.proto import cql as ref_cql
from jepsen_tpu_torch import checker, core, independent, models, suites
from jepsen_tpu_torch import db as port_db
from jepsen_tpu_torch.ops import wgl
from jepsen_tpu_torch.suites.proto import cql

NODES = ["n1", "n2", "n3", "n4", "n5"]
CQL = {"ref": ref_cql, "port": cql}


def yb(pkg):
    root = "jepsen_tpu" if pkg == "ref" else "jepsen_tpu_torch"
    return __import__(f"{root}.suites.yugabyte", fromlist=["x"])


def menu(pkg):
    root = "jepsen_tpu" if pkg == "ref" else "jepsen_tpu_torch"
    return __import__(f"{root}.suites.yb_nemesis", fromlist=["x"])


def both_on_remote(fn, **test):
    """``fn(pkg, m, test)`` on each package's recording remote; the two
    (answer, commands by node) must be equal.  Returns the port's."""
    out = {pkg: on_remote(pkg, lambda m, t, pkg=pkg: fn(pkg, m, t), **test)
           for pkg in ("ref", "port")}
    assert out["port"] == out["ref"]
    return out["port"]


# ---------------------------------------------------------------------------
# the CQL client
# ---------------------------------------------------------------------------


def _result(r):
    return {"kind": r.kind, "columns": r.columns, "col_types": r.col_types,
            "rows": [[None if c is None else c.decode("latin-1") for c in row]
                     for row in r.rows]}


def _cql_script(pkg, port):
    """The reference's tests/test_proto.py:286-356 statements, and an
    unknown one, on one connection."""
    ref = pkg.proto.__name__.startswith("jepsen_tpu.")
    c = CQL["ref" if ref else "port"].CqlClient("127.0.0.1", port).connect()
    steps = [
        "INSERT INTO kv (key, val) VALUES ('a', '7')",
        "SELECT val FROM kv WHERE key='a'",
        "SELECT val FROM kv WHERE key='x'",
        "INSERT INTO kv (key, val) VALUES ('k', '1') IF NOT EXISTS",
        "INSERT INTO kv (key, val) VALUES ('k', '2') IF NOT EXISTS",
        "SELECT boom",
        "INSERT INTO kv (key, val) VALUES ('r', '1')",
        "UPDATE kv SET val='2' WHERE key='r' IF val='1'",
        "UPDATE kv SET val='9' WHERE key='r' IF val='999'",
        "SELECT val FROM kv WHERE key='r'",
        "CREATE KEYSPACE IF NOT EXISTS jepsen",
        "FROBNICATE everything",
    ]
    try:
        return [outcome(lambda s=s: _result(c.query(s, consistency=cons)))
                for s, cons in zip(steps, ["quorum", "one", "all", "serial",
                                           "local-one", "quorum"] * 2)]
    finally:
        c.close()


def test_the_cql_client_answers_and_sends_as_the_reference():
    out = run_both(FakeCql, _cql_script)
    assert out["port"] == out["ref"]
    got, sent = out["port"]
    assert len(sent) == 1 and sent[0]
    # the reference's assertions (tests/test_proto.py:286-356)
    assert got[0] == ("ok", {"kind": "void", "columns": [], "col_types": [],
                             "rows": []})
    assert got[1][1]["columns"] == ["val"] and got[1][1]["rows"] == [["7"]]
    assert got[2][1]["rows"] == []
    assert got[3][1]["rows"] == [["true"]] and got[4][1]["rows"] == [["false"]]
    assert got[5][:3] == ("err", "CqlError", 0x1100)  # a write timeout
    assert got[7][1]["rows"] == [["true"]] and got[8][1]["rows"] == [["false"]]
    assert got[9][1]["rows"] == [["2"]]
    assert got[11][:3] == ("err", "CqlError", 0x2000)
    # the frame header: version 4, a stream id counting from 1, QUERY
    header = struct.unpack("!BBhBI", sent[0][:9])
    assert header[:4] == (0x04, 0, 1, 0x01)


def test_the_cql_constants_equal_the_references():
    assert cql.CONSISTENCY == ref_cql.CONSISTENCY
    assert (cql.VERSION_REQ, cql.VERSION_RESP, cql.OP_ERROR, cql.OP_STARTUP,
            cql.OP_READY, cql.OP_QUERY, cql.OP_RESULT, cql.WRITE_TIMEOUT,
            cql.READ_TIMEOUT) == (
        ref_cql.VERSION_REQ, ref_cql.VERSION_RESP, ref_cql.OP_ERROR,
        ref_cql.OP_STARTUP, ref_cql.OP_READY, ref_cql.OP_QUERY,
        ref_cql.OP_RESULT, ref_cql.WRITE_TIMEOUT, ref_cql.READ_TIMEOUT)
    for code in (0x1100, 0x1200, 0x2000, 0x000A, None):
        e, r = cql.CqlError("m", code=code), ref_cql.CqlError("m", code=code)
        assert (e.timeout, e.code, str(e)) == (r.timeout, r.code, str(r))
    payload = struct.pack("!IH", 0x1200, 4) + b"slow"
    for pkg in CQL.values():
        e = pkg.CqlClient._error(payload)
        assert (type(e).__name__, e.code, str(e), e.timeout) == (
            "CqlError", 0x1200, "slow", True)
    for v in (None, b"\x00\x00\x00\x07", b"\xff\xff\xff\xfe", b"\x01" * 8):
        assert cql.int_value(v) == ref_cql.int_value(v)
    for v in (None, b"abc", "héllo".encode()):
        assert cql.text_value(v) == ref_cql.text_value(v)


def _string(s: bytes) -> bytes:
    return struct.pack("!H", len(s)) + s


def _cell(b):
    return struct.pack("!i", -1) if b is None else struct.pack(
        "!i", len(b)) + b


def _rows_payload(global_spec: bool):
    """A ROWS result of every column shape the decoder knows: bigint,
    int, smallint, tinyint, boolean, varchar, a custom class, a list, a
    set and a map, with null cells."""
    cols = [("big", 0x0002, b""), ("i", 0x0009, b""), ("s", 0x0013, b""),
            ("t", 0x0014, b""), ("b", 0x0004, b""), ("v", 0x000D, b""),
            ("c", 0x0000, _string(b"org.Custom")),
            ("l", 0x0020, struct.pack("!H", 0x0009)),
            ("st", 0x0022, struct.pack("!H", 0x000D)),
            ("m", 0x0021, struct.pack("!HH", 0x000D, 0x0009))]
    flags = 1 if global_spec else 0
    body = struct.pack("!III", 2, flags, len(cols))
    if global_spec:
        body += _string(b"jepsen") + _string(b"t")
    for name, t, extra in cols:
        if not global_spec:
            body += _string(b"jepsen") + _string(b"t")
        body += _string(name.encode()) + struct.pack("!H", t) + extra
    rows = [
        [struct.pack("!q", -5), struct.pack("!i", 7), struct.pack("!h", -2),
         struct.pack("!b", 3), b"\x01", b"42", b"opaque", b"", b"", b""],
        [None, struct.pack("!i", -1), None, None, b"\x00", b"false", None,
         None, None, None],
    ]
    body += struct.pack("!I", len(rows))
    for row in rows:
        body += b"".join(_cell(c) for c in row)
    return body


@pytest.mark.parametrize("payload", [
    struct.pack("!I", 1), struct.pack("!I", 3) + _string(b"jepsen"),
    struct.pack("!I", 4) + b"prepared", _rows_payload(True),
    _rows_payload(False)], ids=["void", "set-keyspace", "kind-4",
                                "rows-global", "rows-per-column"])
def test_result_frames_decode_as_the_reference(payload):
    out = {}
    for name, pkg in CQL.items():
        r = pkg.CqlClient("127.0.0.1")._decode_result(payload)
        cells = []
        for row in r.rows:
            ints, bools = [], []
            for i in range(len(row)):
                for fn, acc in ((r.cell_int, ints), (r.cell_bool, bools)):
                    try:
                        acc.append(fn(row, i))
                    except (ValueError, UnicodeDecodeError) as e:
                        acc.append(type(e).__name__)
            cells.append((ints, bools))
        out[name] = (_result(r), cells)
    assert out["port"] == out["ref"]
    if payload[3] == 2:
        assert out["port"][0]["kind"] == "rows"
        ints, bools = out["port"][1][0]
        # a boolean cell is no integer: both raise alike
        assert ints[:6] == [-5, 7, -2, 3, "ValueError", 42]
        assert bools[4] is True and bools[5] is False
        assert out["port"][1][1][0][:2] == [None, -1]


def test_a_dead_server_is_indeterminate_in_both():
    for name, pkg in CQL.items():
        srv = FakeCql().start()
        c = pkg.CqlClient("127.0.0.1", srv.port, timeout=2.0).connect()
        proto = __import__(pkg.__name__.rsplit(".", 1)[0], fromlist=["x"])
        try:
            assert c.query("SELECT val FROM kv WHERE key='a'").rows == []
            srv.stop()
            with pytest.raises(proto.IndeterminateError):
                for _ in range(3):  # the first send may land in a buffer
                    c.query("SELECT val FROM kv WHERE key='a'")
        finally:
            c.close()
            srv.stop()


# ---------------------------------------------------------------------------
# the YCQL clients: timeouts are indeterminate
# ---------------------------------------------------------------------------


class _SlowCqlHandler(_CqlHandler):
    """Every LWT (``IF``) and every transaction block times out as a
    write; everything else is ``FakeCql``'s."""

    def _query(self, stream, cql_text):
        low = cql_text.lower()
        if " if " in low or low.startswith("begin transaction"):
            self._error(stream, 0x1100, "Operation timed out - received "
                        "only 0 responses")
            return
        super()._query(stream, cql_text)


class SlowCql(FakeCql):
    handler_class = _SlowCqlHandler


TIMEOUT_CASES = {
    "YcqlRegisterClient": [("write", [0, 1]), ("cas", [0, [1, 2]]),
                           ("read", [0, None])],
    "YcqlMultiKeyAcidClient": [("write", [3, [["w", 0, 1]]]),
                               ("read", [3, [["r", 0, None]]])],
    "YcqlBankClient": [("transfer", {"from": 0, "to": 1, "amount": 1}),
                       ("read", None)],
    "YcqlCounterClient": [("add", 1), ("read", None)],
}


@pytest.mark.parametrize("cls", sorted(TIMEOUT_CASES))
def test_a_timed_out_lwt_or_transaction_is_info(cls):
    out = {}
    with own_threads():
        for pkg in ("ref", "port"):
            srv = SlowCql().start()
            test = {"nodes": ["n1"], "accounts": [0, 1], "total-amount": 10}
            c = getattr(yb(pkg), cls)({"host": "127.0.0.1",
                                       "port": srv.port}).open(test, "n1")
            try:
                c.setup(test)
                out[pkg] = [c.invoke(test, {"type": "invoke", "f": f,
                                            "value": v, "process": 0})
                            for f, v in TIMEOUT_CASES[cls]]
            finally:
                c.close(test)
                srv.stop()
    assert normal(out["port"]) == normal(out["ref"])
    first = out["port"][0]
    if cls == "YcqlCounterClient":
        # FakeCql has no counter table: a definite failure, not a timeout
        assert first["type"] == "fail"
    else:
        timed_out = out["port"][1] if cls == "YcqlRegisterClient" else first
        assert timed_out["type"] == "info", timed_out
        assert "timed out" in timed_out["error"]


# ---------------------------------------------------------------------------
# the reference's own round trips on the port
# ---------------------------------------------------------------------------


def _inv(c, f, value, test=None):
    return c.invoke(test or {}, {"f": f, "value": value, "type": "invoke"})


def test_the_ycql_register_and_set_round_trips():
    """tests/test_suites.py:215-240 on the port."""
    yugabyte = suites.suite("yugabyte")
    with own_threads():
        s = FakeCql().start()
        try:
            opts = {"host": "127.0.0.1", "port": s.port}
            c = yugabyte.YcqlRegisterClient(opts).open({"nodes": ["n1"]},
                                                       "n1")
            c.setup({})
            r = _inv(c, "read", [0, None])
            assert r["type"] == "ok" and tuple(r["value"]) == (0, None)
            assert _inv(c, "write", [0, 4])["type"] == "ok"
            assert tuple(_inv(c, "read", [0, None])["value"]) == (0, 4)
            assert _inv(c, "cas", [0, [4, 5]])["type"] == "ok"
            assert _inv(c, "cas", [0, [4, 6]])["type"] == "fail"
            c.close({})
            sc = yugabyte.YcqlSetClient(opts).open({"nodes": ["n1"]}, "n1")
            sc.setup({})
            for i in range(3):
                assert _inv(sc, "add", i)["type"] == "ok"
            assert _inv(sc, "read", None)["value"] == [0, 1, 2]
            sc.close({})
        finally:
            s.stop()


def test_the_multi_key_acid_round_trips():
    """tests/test_suite_workloads.py:217-257 (YSQL) and :697-727 (YCQL)
    on the port."""
    yugabyte = suites.suite("yugabyte")
    with own_threads():
        for fake, cls, extra in (
                (FakePg, "MultiKeyAcidClient",
                 {"dialect": "pg", "user": "postgres"}),
                (FakeCql, "YcqlMultiKeyAcidClient", {})):
            s = fake().start()
            try:
                opts = {"host": "127.0.0.1", "port": s.port, **extra}
                c = getattr(yugabyte, cls)(opts).open({"nodes": ["n1"]}, "n1")
                c.setup({})
                w = _inv(c, "write", independent.kv(5, [["w", 0, 3],
                                                        ["w", 2, 4]]))
                assert w["type"] == "ok", w
                r = _inv(c, "read", independent.kv(
                    5, [["r", 0, None], ["r", 1, None], ["r", 2, None]]))
                assert r["type"] == "ok"
                k, mops = r["value"]
                assert k == 5
                assert mops == [["r", 0, 3], ["r", 1, None], ["r", 2, 4]]
                if cls == "MultiKeyAcidClient":
                    assert _inv(c, "write", independent.kv(
                        5, [["w", 0, 9]]))["type"] == "ok"
                    assert _inv(c, "read", independent.kv(
                        5, [["r", 0, None]]))["value"][1] == [["r", 0, 9]]
                r3 = _inv(c, "read", independent.kv(6, [["r", 0, None]]))
                assert r3["value"][1] == [["r", 0, None]]
                c.close({})
            finally:
                s.stop()


def test_the_ycql_bank_and_long_fork_round_trips():
    """tests/test_suite_workloads.py:733-780 and :803-823 on the port."""
    yugabyte = suites.suite("yugabyte")
    from jepsen_tpu_torch.txn import R, W

    with own_threads():
        s = FakeCql().start()
        try:
            opts = {"host": "127.0.0.1", "port": s.port}
            t = {"nodes": ["n1"], "accounts": [0, 1, 2, 3],
                 "total-amount": 20}
            c = yugabyte.YcqlBankClient(opts).open(t, "n1")
            c.setup(t)
            r = _inv(c, "read", None, t)
            assert r["type"] == "ok" and sum(r["value"].values()) == 20, r
            assert r["value"][0] == 20
            r = _inv(c, "transfer", {"from": 0, "to": 2, "amount": 7}, t)
            assert r["type"] == "ok", r
            assert _inv(c, "read", None, t)["value"] == {0: 13, 1: 0, 2: 7,
                                                         3: 0}
            c.close(t)
            lf = yugabyte.YcqlLongForkClient(opts).open({}, "n1")
            lf.setup({})
            assert _inv(lf, "write", [[W, 0, 1]])["type"] == "ok"
            r = _inv(lf, "read", [[R, 0, None], [R, 1, None]])
            assert r["type"] == "ok"
            assert r["value"] == [[R, 0, 1], [R, 1, None]]
            lf.close({})
        finally:
            s.stop()


def test_the_ysql_default_value_append_table_and_counter_round_trips():
    """tests/test_suite_workloads.py:326-355 (the counter), :842-870 and
    :2366-2392 on the port."""
    yugabyte = suites.suite("yugabyte")
    from jepsen_tpu_torch.suites import sql

    assert "ysql.counter" in yugabyte.workloads({"nodes": ["n1"]})
    with own_threads():
        s = FakePg().start()
        try:
            opts = {"host": "127.0.0.1", "port": s.port, "user": "postgres"}
            c = yugabyte.DefaultValueClient(opts).open({"nodes": ["n1"]},
                                                       "n1")
            for f in ("create-table", "insert"):
                assert _inv(c, f, None)["type"] == "ok"
            r = _inv(c, "read", None)
            assert r["type"] == "ok" and r["value"] == [0], r
            assert _inv(c, "drop-table", None)["type"] == "ok"
            # racing reads of a dropped table fail, not crash
            assert _inv(c, "read", None)["type"] == "fail"
            c.close({})

            a = yugabyte.AppendTableClient(
                {**opts, "append-table-key": "count"}).open(
                    {"nodes": ["n1"]}, "n1")
            r = _inv(a, "txn", [["append", 7, 1], ["r", 7, None]])
            assert r["type"] == "ok", r
            assert r["value"] == [["append", 7, 1], ["r", 7, [1]]]
            r = _inv(a, "txn", [["append", 7, 2], ["append", 7, 3],
                                ["r", 7, None]])
            assert r["value"][-1] == ["r", 7, [1, 2, 3]]
            assert _inv(a, "txn", [["r", 8, None]])["value"] == [
                ["r", 8, []]]
            a.close({})

            pg = {**opts, "dialect": "pg"}
            k = sql.client_for("counter", pg).open({"nodes": ["n1"]}, "n1")
            k.setup({})
            assert _inv(k, "add", 3)["type"] == "ok"
            assert _inv(k, "add", 4)["type"] == "ok"
            assert _inv(k, "read", None)["value"] == 7
            k.close({})
        finally:
            s.stop()


def test_the_default_value_and_multi_register_checkers():
    """tests/test_suite_workloads.py:259-282 and :872-884 on the port,
    each beside the reference's on the same history."""
    good = _h((0, "invoke", "read", None), (0, "ok", "read", [0, 0, 0]))
    bad = _h((0, "invoke", "read", None), (0, "ok", "read", [0, None, 0]))
    for dicts, valid in ((good, True), (bad, False)):
        ref, port = _check_both(lambda pkg: yb(pkg).DefaultValueChecker(),
                                dicts)
        assert port == ref and port["valid?"] is valid
    assert ref["bad-read-count"] == 1

    def lin(pkg):
        if pkg == "ref":
            from jepsen_tpu import checker as ref_checker

            return ref_checker.linearizable(ref_models.multi_register({}),
                                            pure_fs=())
        return checker.linearizable(models.multi_register({}), pure_fs=(),
                                    device="cpu")

    w = [["w", 0, 1], ["w", 1, 2]]
    ok_read = _h((0, "invoke", "write", w), (0, "ok", "write", w),
                 (1, "invoke", "read", [["r", 0, None], ["r", 1, None]]),
                 (1, "ok", "read", [["r", 0, 1], ["r", 1, 2]]))
    bad_read = _h((0, "invoke", "write", w), (0, "ok", "write", w),
                  (1, "invoke", "read", [["r", 0, 1], ["r", 1, 7]]),
                  (1, "ok", "read", [["r", 0, 1], ["r", 1, 7]]))
    for dicts, valid in ((ok_read, True), (bad_read, False)):
        ref, port = _check_both(lin, dicts)
        assert port == ref and port["valid?"] is valid


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------

DB_STEPS = ("install", "start", "start_master", "start_tserver",
            "stop_master", "stop_tserver", "kill_master", "kill_tserver",
            "kill", "await_ready", "wipe", "teardown", "setup")


@pytest.mark.parametrize("opts", [{}, {"tarball": "file:///tmp/yb.tgz",
                                       "replication-factor": 1},
                                  {"replication-factor": 5}])
def test_the_db_emits_the_reference_commands(opts):
    def run(pkg, m, t):
        db = yb(pkg).YugabyteDB(opts)
        answers = {step: m["control"].on_nodes(
            t, lambda test, node, step=step: getattr(db, step)(test, node))
            for step in DB_STEPS}
        answers["log_files"] = db.log_files(t, "n1")
        answers["masters"] = db.master_nodes(t)
        answers["addresses"] = db.master_addresses(t)
        return answers

    answers, cmds = both_on_remote(run)
    masters = answers["masters"]
    assert masters == NODES[:opts.get("replication-factor", 3)]
    assert set(answers["start_master"].values()) == (
        {"started", "not a master node"} if len(masters) < len(NODES)
        else {"started"})
    for n in NODES:
        ran = [c[0] for c in cmds[n]]
        assert any("yb-tserver" in c and "--tserver_master_addrs" in c
                   for c in ran)
        assert any("bin/yb-master" in c for c in ran) is (n in masters)


def _process_run(pkg, m, t, seed, rf):
    m["gen"].set_seed(seed)
    db = yb(pkg).YugabyteDB({"replication-factor": rf})
    nem = menu(pkg).YbProcessNemesis(db).setup(t)
    out = [nem.invoke(t, {"type": "info", "f": f, "value": None})
           for _ in range(2) for f in sorted(menu(pkg).PROCESS_FS)]
    nem.teardown(t)
    return out, sorted(nem.fs())


@pytest.mark.parametrize("rf", [3, 1])
@pytest.mark.parametrize("seed", [45100, 7])
def test_the_process_nemesis_runs_as_the_reference(seed, rf):
    (answers, fs), cmds = both_on_remote(
        lambda pkg, m, t: _process_run(pkg, m, t, seed, rf))
    assert len(answers) == 20 and len(fs) == 10
    masters = set(NODES[:rf])
    for a in answers:
        assert a["type"] == "info"
        if a["f"].endswith("-master"):
            assert set(a["value"]) <= masters
    assert any("-STOP" in c[0] or "STOP" in c[0]
               for n in NODES for c in cmds.get(n, []))


@pytest.mark.parametrize("seed", [45100, 7])
def test_the_full_nemesis_runs_as_the_reference(seed):
    def run(pkg, m, t):
        m["gen"].set_seed(seed)
        nem = menu(pkg).full_nemesis(yb(pkg).YugabyteDB({})).setup(t)
        grudge = {"n1": ["n2", "n3"], "n2": ["n1"], "n3": ["n1"]}
        out = [nem.invoke(t, {"type": "info", "f": f, "value": v})
               for f, v in (("start-partition", grudge),
                            ("stop-partition", None),
                            ("kill-tserver", None), ("start-tserver", None),
                            ("bump-clock", {"n2": 1000}),
                            ("strobe-clock", {"n3": {"delta": 10,
                                                     "period": 2,
                                                     "duration": 1}}),
                            ("check-clock-offsets", None),
                            ("reset-clock", None))]
        nem.teardown(t)
        return out, sorted(map(str, nem.fs()))

    (answers, fs), cmds = both_on_remote(run)
    for f in ("kill-master", "start-partition", "stop-partition",
              "bump-clock", "reset-clock"):
        assert f in fs, f
    ran = [c[0] for n in NODES for c in cmds.get(n, [])]
    assert any(c.startswith("iptables") for c in ran)
    assert any("/opt/jepsen/bump-time 1000" in c for c in ran)


# ---------------------------------------------------------------------------
# op lists
# ---------------------------------------------------------------------------

#: case → the fault names of ``package``'s options, and extra options
SCHEDULES = {
    "kill": (["kill"], {}),
    "stop": (["stop"], {}),
    "pause": (["pause"], {}),
    "partition": (["partition"], {}),
    "clock-skew": (["clock-skew"], {}),
    "kill-master+partition-one": (["kill-master", "partition-one"], {}),
    "stop-tserver+pause-master": (["stop-tserver", "pause-master"],
                                  {"interval": 3}),
    "everything": (["kill", "stop", "pause", "partition", "clock-skew"],
                   {"interval": 2}),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_the_fault_schedules_give_the_reference_ops(case):
    faults, extra = SCHEDULES[case]
    opts = {"faults": faults, **extra}

    def whole(pkg, m):
        p = menu(pkg).package(dict(opts), yb(pkg).YugabyteDB({}))
        return m["gen"].time_limit(900, m["gen"].nemesis(p["generator"]))

    for seed in (45100, 7):
        port, ref = (_sim_ops(pkg, lambda m, pkg=pkg: whole(pkg, m), seed)
                     for pkg in ("port", "ref"))
        assert port == ref, (case, seed)
    fs = {o.get("f") for o in port if o["process"] == "nemesis"} - {None}
    assert len(fs) >= 2, fs
    p = menu("port").package(dict(opts), yb("port").YugabyteDB({}))
    r = menu("ref").package(dict(opts), yb("ref").YugabyteDB({}))
    assert normal(p["perf"]) == normal(r["perf"])
    assert normal(p["final_generator"]) == normal(r["final_generator"])
    assert p["final_generator"]


@pytest.mark.parametrize("faults", [["kill"], ["pause", "partition-ring"]])
def test_the_long_recovery_schedule_gives_the_reference_ops(faults):
    """Its 60 s calm is a sleep op: drawn with virtual time stepped."""
    opts = {"faults": faults, "interval": 5, "long-recovery": True}
    for seed in (45100, 7):
        ops = {}
        for pkg in ("port", "ref"):
            menu_gen = __import__(
                ("jepsen_tpu" if pkg == "ref" else "jepsen_tpu_torch")
                + ".generator", fromlist=["x"])
            menu_gen.set_seed(seed)
            p = menu(pkg).package(dict(opts), yb(pkg).YugabyteDB({}))
            ops[pkg] = _drain(pkg, p["generator"], 40)
        assert ops["port"] == ops["ref"]
    fs = [o["f"] for o in ops["port"]]
    assert any(f.startswith("start-") or f.startswith("resume-")
               for f in fs), fs


def test_the_generators_and_shorthands_equal_the_references():
    port, ref = menu("port"), menu("ref")
    for name in ("PROCESS_FS", "KNOWN_FAULTS"):
        assert normal(getattr(port, name)) == normal(getattr(ref, name))
    n = {"kill": True, "stop": True, "pause": True, "partition": True,
         "clock-skew": True, "interval": 1}
    assert port.expand_options(n) == ref.expand_options(n)
    assert normal(port.final_generator(port.expand_options(n))) == \
        normal(ref.final_generator(ref.expand_options(n)))
    assert port.final_generator({}) is None and port.full_generator({}) is None
    for f in ("partition_one_gen", "partition_half_gen",
              "partition_ring_gen"):
        for seed in (45100, 7):
            out = {}
            for pkg, m in (("port", port), ("ref", ref)):
                gen_mod = __import__(m.__name__.rsplit(".", 2)[0]
                                     + ".generator", fromlist=["x"])
                gen_mod.set_seed(seed)
                out[pkg] = normal(getattr(m, f)({"nodes": list(NODES)}, {}))
            assert out["port"] == out["ref"], f


#: workload → the workers of its generator's simulation
WORKERS = {"ycql.register": 6, "ycql.single-key-acid": 6, "ysql.register": 6,
           "ysql.single-key-acid": 6, "ycql.multi-key-acid": 12,
           "ysql.multi-key-acid": 12}


def _workload_ops(pkg, wname, seed, whole):
    opts = {"nodes": ["n1", "n2", "n3"], "workload": wname, "time-limit": 10,
            "rate": 10, "faults": []}

    def build(m):
        # the register and multi-key-acid generators draw from `random`
        random.seed(seed)
        if whole:
            return m["gen"].limit(400, m["suite"]("yugabyte").test(
                dict(opts))["generator"])
        w = m["suite"]("yugabyte").workloads(dict(opts))[wname]
        return m["gen"].limit(300, w["generator"])

    return _sim(pkg, build, WORKERS.get(wname, 3), seed,
                test={"nodes": opts["nodes"], "accounts": list(range(8)),
                      "total-amount": 100, "max-transfer": 5})


@pytest.mark.parametrize("wname", sorted(yb("ref").workloads(
    {"nodes": ["n1", "n2", "n3"]})))
def test_each_workloads_generator_gives_the_reference_ops(wname):
    for seed in (45100, 7):
        for whole in (False, True):
            ref = _workload_ops("ref", wname, seed, whole)
            port = _workload_ops("port", wname, seed, whole)
            assert port == ref, (wname, seed, whole)
            assert [o for o in ref if o["type"] == "invoke"], wname


def test_the_whole_tests_generator_gives_the_reference_ops_under_faults():
    opts = {"nodes": NODES, "faults": ["kill", "partition", "clock-skew"],
            "interval": 2, "time-limit": 20, "rate": 10,
            "workload": "ycql.multi-key-acid"}

    def build(m, seed):
        random.seed(seed)
        suite = yb("ref" if m["gen"].__name__.startswith("jepsen_tpu.")
                   else "port")
        return m["gen"].limit(500, suite.test(dict(opts))["generator"])

    for seed in (45100, 7):
        port, ref = (_sim_ops(pkg, lambda m, seed=seed: build(m, seed), seed,
                              n=20) for pkg in ("port", "ref"))
        assert port == ref
    fs = {o["f"] for o in port if o["process"] == "nemesis"}
    assert fs & {"kill-master", "kill-tserver"}, fs
    assert fs & {"start-master", "start-tserver"}, fs


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------


def test_the_suite_is_the_references():
    port, ref = yb("port"), yb("ref")
    for name in ("DIR", "MASTER_RPC_PORT", "TSERVER_RPC_PORT", "YCQL_PORT",
                 "YSQL_PORT", "DEFAULT_TARBALL", "KEYSPACE", "MKA_TABLE",
                 "MKA_KEYS", "DV_TABLE"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port._ysql_opts({}) == ref._ysql_opts({})
    names = sorted(ref.workloads({"nodes": NODES}))
    assert sorted(port.workloads({"nodes": NODES, "device": "cpu"})) == names
    for wname in names:
        assert type(port._client_for(wname, {})).__name__ == \
            type(ref._client_for(wname, {})).__name__
    for w in ("ycql.single-key-acid", "ysql.single-key-acid", "ycql.bank",
              "ycql.long-fork", "ysql.default-value", "ycql.multi-key-acid",
              "ysql.multi-key-acid"):
        assert w in names, w
    t = port.test({"nodes": NODES, "device": "cpu",
                   "faults": ["kill-master", "partition-one"],
                   "time-limit": 5})
    r = ref.test({"nodes": NODES, "faults": ["kill-master", "partition-one"],
                  "time-limit": 5})
    assert t["name"] == r["name"] == "yugabyte-ycql.register"
    assert normal(sorted(t["nemesis"].fs(), key=str)) == \
        normal(sorted(r["nemesis"].fs(), key=str))
    assert "kill-master" in t["nemesis"].fs()
    assert "start-partition" in t["nemesis"].fs()
    # a generic fault composes its package beside the menu's
    t = port.test({"nodes": NODES, "device": "cpu",
                   "faults": ["kill-master", "kill"]})
    assert "kill-tserver" in t["nemesis"].fs()


def test_the_reference_nemesis_assertions_on_the_port():
    """tests/test_suite_nemeses.py:33-120 and :381-420 on the port."""
    from jepsen_tpu_torch import control, generator as gen
    from jepsen_tpu_torch.control.core import DummyRemote
    from jepsen_tpu_torch.suites import yb_nemesis, yugabyte

    def dummy_test(**extra):
        return {"nodes": list(NODES), "remote": DummyRemote(),
                "ssh": {"dummy?": True}, **extra}

    db = yugabyte.YugabyteDB({"replication-factor": 3})
    t = dummy_test(db=db)
    with control.with_session(t, t["remote"]):
        nem = yb_nemesis.YbProcessNemesis(db).setup(t)
        masters = db.master_nodes(t)
        assert masters == ["n1", "n2", "n3"]
        res = _inv(nem, "kill-master", None, t)
        assert res["type"] == "info" and set(res["value"]) <= set(masters)
        assert set(_inv(nem, "kill-tserver", None, t)["value"]) <= set(NODES)
        assert sorted(_inv(nem, "start-master", None, t)["value"]) == masters
        assert sorted(_inv(nem, "start-tserver", None, t)["value"]) == NODES
        assert _inv(nem, "pause-tserver", None, t)["type"] == "info"

        full = yb_nemesis.full_nemesis(db).setup(t)
        res = full.invoke(t, {"type": "info", "f": "start-partition",
                              "value": {"n1": {"n2"}, "n2": {"n1"}}})
        assert res["f"] == "start-partition"
        assert full.invoke(t, {"type": "info", "f": "stop-partition",
                               "value": None})["f"] == "stop-partition"
        full.teardown(t)

    n = yb_nemesis.expand_options({"kill": True, "partition": True,
                                   "clock-skew": True, "interval": 0.01})
    assert n["kill-master"] and n["kill-tserver"] and n["partition-ring"]
    assert yb_nemesis.full_generator(n) is not None
    fs = [op["f"] for op in yb_nemesis.final_generator(n)]
    assert "start-tserver" in fs and "start-master" in fs
    assert "stop-partition" in fs and "reset-clock" in fs
    op = yb_nemesis.partition_ring_gen(dummy_test(), {})
    assert op["f"] == "start-partition" and set(op["value"]) == set(NODES)

    # long recovery: ops go on past the first 120 s fault window
    g = yb_nemesis.full_generator(yb_nemesis.expand_options(
        {"kill": True, "interval": 0.001, "long-recovery": True}))
    ctx = gen.context({"concurrency": 1, "nodes": NODES})
    seen = []
    for _ in range(10_000):
        if len(seen) >= 60:
            break
        res = gen.op(g, dummy_test(), ctx)
        if res is None:
            break
        o, g = res
        if o != gen.PENDING and isinstance(o, dict) and o.get("f"):
            seen.append((ctx["time"], o["f"]))
        ctx = {**ctx, "time": ctx["time"] + int(10e9)}
    fs = [f for _, f in seen]
    assert fs.count("start-tserver") >= 1, fs
    assert any(f in ("kill-tserver", "kill-master") for f in fs), fs
    assert any(ts > 2 * 120 * 1_000_000_000 for ts, _ in seen)


# ---------------------------------------------------------------------------
# full runs
# ---------------------------------------------------------------------------

#: workload → (fake server, rate, extra options): the reference's
#: ``*_full_test_in_process`` settings (tests/test_suite_workloads.py);
#: the register at rate 100, as chip_smoke.py's phase 33 runs it
FULL_RUNS = {
    "ycql.register": (FakeCql, 100, {}),
    "ycql.multi-key-acid": (FakeCql, 50, {}),
    "ysql.multi-key-acid": (FakePg, 50, {"user": "postgres"}),
    "ycql.bank": (FakeCql, 30, {}),
    "ysql.default-value": (FakePg, 30, {"user": "postgres",
                                        "nodes": ["n1", "n2"]}),
}

#: the fs whose ok completions each run needs (the stats checker calls a
#: run with an f that never succeeded invalid).  default-value needs
#: none: a drop-table among a 2 s run's first ops with no create-table
#: after it fails every later read and insert, and the stats checker
#: then calls the run invalid whatever the database did (the reference's
#: own test fails so about one time in twelve); its run is held to its
#: own checker's verdict
NEEDED = {"ycql.register": {"read", "write", "cas"},
          "ycql.multi-key-acid": {"read", "write"},
          "ysql.multi-key-acid": {"read", "write"},
          "ycql.bank": {"read", "transfer"},
          "ysql.default-value": set()}


def _opts(wname):
    _fake, rate, extra = FULL_RUNS[wname]
    return {"nodes": ["n1", "n2", "n3"], "time-limit": 2, "rate": rate,
            "workload": wname, "faults": [], **extra}


_RUNS: dict = {}


def _full_run(wname):
    """The run of ``wname`` on the plain versions (once per module)."""
    if wname not in _RUNS:
        with own_threads():
            srv = FULL_RUNS[wname][0]().start()
            try:
                t = suites.suite("yugabyte").test({
                    **_opts(wname), "host": "127.0.0.1", "port": srv.port,
                    "device": "cpu"})
                t["db"] = port_db.noop()
                t["ssh"] = {"dummy?": True}
                _RUNS[wname] = core.run(t)
            finally:
                srv.stop()
    return _RUNS[wname]


def _oracle_keys(model, history):
    return plain(independent.checker(checker.linearizable(
        model, pure_fs=(), algorithm="oracle")).check({}, history, {}))[
            "results"]


@pytest.mark.parametrize("wname", sorted(FULL_RUNS))
def test_each_workload_runs_valid_and_as_the_reference_checks_it(wname):
    result = _full_run(wname)
    history, results = result["history"], result["results"]
    oks = [op for op in history if isinstance(op.process, int)
           and op.type == "ok"]
    assert oks and {op.f for op in oks} >= NEEDED[wname], {
        op.f for op in oks}
    assert results["workload"]["valid?"] is True, results
    assert results["exceptions"]["valid?"] is True, results
    if NEEDED[wname]:
        assert results["valid?"] is True, results
    dicts = [op.to_dict() for op in history if op.process != "nemesis"]

    def make(pkg):
        opts = dict(_opts(wname))
        if pkg == "port":
            opts["device"] = "cpu"
        return yb(pkg).workloads(opts)[wname]["checker"]

    ref, port = _check_both(make, dicts,
                            test={"accounts": list(range(8)),
                                  "total-amount": 100,
                                  "negative-balances?": True})
    assert port == ref
    assert port == plain(results["workload"])
    if wname == "ycql.register":
        keys, oracle = port["linearizable"]["results"], _oracle_keys(
            models.cas_register(), history)
    elif wname.endswith("multi-key-acid"):
        keys, oracle = port["results"], _oracle_keys(
            models.multi_register({}), history)
    else:
        return
    assert sorted(keys) == sorted(oracle)
    for k, r in keys.items():
        o = oracle[k]
        shared = set(r) & set(o)
        assert "valid?" in shared
        assert all(r[f] == o[f] for f in shared), (k, r, o)


def test_the_multi_register_histories_undecomposed_equal_the_reference():
    """The ycql.multi-key-acid run's per-key histories through
    ``check_batch(decomposed=False)``: the port's plain versions against
    the reference on the same histories.  Their transactions touch up to
    three registers at once, which the multi-register encoder leaves to
    the oracle in both packages."""
    history = _full_run("ycql.multi-key-acid")["history"]
    dicts = [op.to_dict() for op in history if op.process != "nemesis"]
    port_subs = independent.split_by_key(_port_history(dicts))
    ref_h = _ref_history(dicts)
    ref_subs = [ref_ind.subhistory(k, ref_h) for k in port_subs]
    port = wgl.check_batch(models.multi_register({}),
                           list(port_subs.values()), decomposed=False,
                           device="cpu")
    ref = ref_wgl.check_batch(ref_models.multi_register({}), ref_subs,
                              decomposed=False)
    assert plain(port) == plain(ref)
    assert len(port) == len(port_subs) >= 1
    multi_mop = [any(len(op.value or []) > 1 for op in h
                     if op.type == "invoke")
                 for h in port_subs.values()]
    for r, multi in zip(port, multi_mop):
        assert r["valid?"] is True
        assert (r["engine"] == "oracle-fallback") is multi, r
    assert wgl.batch_stats(port) == json.loads(json.dumps(
        ref_wgl.batch_stats(ref)).replace('"tpu"', '"gpu"'))


@pytest.mark.parametrize("argv,name,fs", [
    (["--suite", "yugabyte", "--workload", "ycql.multi-key-acid",
      "--faults", "kill-master,partition-one"],
     "yugabyte-ycql.multi-key-acid", {"kill-master", "start-partition"}),
    (["--suite", "dgraph", "--workload", "wr", "--faults",
      "kill-alpha,move-tablet", "-o", "skew=big"], "dgraph-wr",
     {"kill-alpha", "move-tablet"}),
])
def test_the_clis_suite_option_builds_both_suites(argv, name, fs,
                                                  monkeypatch):
    """``cli test --suite yugabyte|dgraph`` builds the suite's test with
    its fault menu (the run itself is stubbed: a real remote's setup
    would download and start the databases)."""
    from jepsen_tpu_torch import cli

    built = []
    monkeypatch.setattr(cli, "run_test",
                        lambda test: built.append(test) or cli.EXIT_VALID)
    assert cli.run_cli(cli.default_commands(), [
        "test", *argv, "--nodes", "n1,n2,n3", "--device", "cpu",
        "--time-limit", "1"]) == cli.EXIT_VALID
    [t] = built
    assert t["name"] == name and t["device"] == "cpu"
    assert fs <= set(t["nemesis"].fs())
