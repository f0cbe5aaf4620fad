"""The port's wire-protocol clients (``jepsen_tpu_torch.suites.proto``:
HTTP, RESP, ZooKeeper jute, pgwire, MySQL) against the JAX package's.

Each client runs a scripted sequence of operations against a fresh fake
server of ``tests/fake_servers.py`` (the servers of ``tests/test_proto.py``
and ``tests/test_suites.py``), once through the reference's client and
once through the port's, each behind a loopback relay that records the
bytes the client sent.  The two runs must give

- the same replies;
- errors of the same class name with the same ``code`` (and message);
- the same request bytes, connection by connection.  The auth exchange
  is exempt where the server's nonce is random: pgwire's md5 and SCRAM
  password messages, MySQL's scrambled auth data.  HTTP's ``Host``
  header names each relay's own port, which is masked.

A dead connection is ``IndeterminateError`` in both packages.
"""

import socket
import struct
import threading
from types import SimpleNamespace

import pytest

from fake_disque import FakeDisque
from fake_servers import FakeHttpKv, FakeMysql, FakePg, FakeRedis, FakeZk
from jepsen_tpu.suites import proto as ref_proto
from jepsen_tpu.suites.proto import http as ref_http
from jepsen_tpu.suites.proto import mysql as ref_mysql
from jepsen_tpu.suites.proto import pgwire as ref_pgwire
from jepsen_tpu.suites.proto import resp as ref_resp
from jepsen_tpu.suites.proto import zk as ref_zk
from jepsen_tpu_torch.suites import proto
from jepsen_tpu_torch.suites.proto import http, mysql, pgwire, resp, zk

PACKAGES = {
    "ref": SimpleNamespace(proto=ref_proto, http=ref_http, resp=ref_resp,
                           zk=ref_zk, pgwire=ref_pgwire, mysql=ref_mysql),
    "port": SimpleNamespace(proto=proto, http=http, resp=resp, zk=zk,
                            pgwire=pgwire, mysql=mysql),
}
JOIN_S = 10


class Relay:
    """A loopback TCP relay to ``127.0.0.1:upstream``.  ``sent`` holds,
    per accepted connection, the bytes its client sent; when either side
    closes, the relay closes the other.

    :meth:`close` first waits for each client-to-server pump to read its
    client's end of stream, and only then closes the sockets: a client's
    last frame (ZooKeeper's CLOSE, pgwire's Terminate, MySQL's COM_QUIT),
    sent just before it closed, is then in ``sent`` however late its pump
    was scheduled."""

    def __init__(self, upstream: int):
        self.upstream = upstream
        self.lsock = socket.create_server(("127.0.0.1", 0))
        self.port = self.lsock.getsockname()[1]
        self.sent = []
        self.socks = []
        self.threads = []
        self.uplinks = []
        self._lock = threading.Lock()
        self._acceptor = self._spawn(self._accept)

    def _spawn(self, fn, *args):
        t = threading.Thread(target=fn, args=args, daemon=True)
        with self._lock:
            self.threads.append(t)
        t.start()
        return t

    def _accept(self):
        while True:
            try:
                c, _ = self.lsock.accept()
            except OSError:
                return
            try:
                u = socket.create_connection(("127.0.0.1", self.upstream))
            except OSError:
                c.close()
                continue
            rec = bytearray()
            with self._lock:
                self.sent.append(rec)
                self.socks += [c, u]
            uplink = self._spawn(self._pump, c, u, rec)
            with self._lock:
                self.uplinks.append(uplink)
            self._spawn(self._pump, u, c, None)

    @staticmethod
    def _pump(src, dst, rec):
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                if rec is not None:
                    rec += data
                dst.sendall(data)
        except OSError:
            pass
        for s in (dst, src):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def close(self):
        try:  # wakes the blocked accept
            self.lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.lsock.close()
        self._acceptor.join(JOIN_S)
        # every client has closed by now: its pump ends at the end of
        # stream, after recording the last bytes the client sent
        with self._lock:
            uplinks = list(self.uplinks)
        for t in uplinks:
            t.join(JOIN_S)
        with self._lock:
            socks = list(self.socks)
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        for t in list(self.threads):
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in self.threads)


def normal(x):
    """A reply as plain data: result objects as their fields."""
    if isinstance(x, (list, tuple)):
        return type(x)(normal(v) for v in x)
    if isinstance(x, dict):
        return {k: normal(v) for k, v in x.items()}
    if hasattr(x, "__dict__") and not isinstance(x, type):
        return (type(x).__name__, normal(vars(x)))
    if hasattr(x, "__slots__"):
        return (type(x).__name__, {k: normal(getattr(x, k))
                                   for k in x.__slots__})
    return x


def outcome(thunk):
    """``("ok", reply)`` or ``("err", class name, code, message)``."""
    try:
        return ("ok", normal(thunk()))
    except Exception as e:  # noqa: BLE001 — the class is compared
        return ("err", type(e).__name__, getattr(e, "code", None), str(e))


def run_both(fake_factory, script, mask=None):
    """``script(pkg, port)`` against a fresh fake from ``fake_factory``
    behind a relay, once per package: ``{pkg: (outcomes, request bytes
    per connection)}``, each connection's bytes through ``mask``."""
    out = {}
    for name, pkg in PACKAGES.items():
        srv = fake_factory().start()
        relay = Relay(srv.port)
        try:
            outcomes = script(pkg, relay.port)
        finally:
            relay.close()
            srv.stop()
        sent = [bytes(b) for b in relay.sent]
        if mask is not None:
            sent = [mask(b, relay.port) for b in sent]
        out[name] = (outcomes, sent)
    return out


def assert_same(out):
    ref, port = out["ref"], out["port"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert ref[1] and all(ref[1]), "the relay recorded no request"


# ---------------------------------------------------------------------------
# the exception classes
# ---------------------------------------------------------------------------


def test_the_error_classes_match():
    for pkg in PACKAGES.values():
        p = pkg.proto
        assert not issubclass(p.IndeterminateError, p.ProtocolError)
        for err in (pkg.http.HttpError, pkg.zk.ZkError, pkg.pgwire.PgError,
                    pkg.mysql.MysqlError):
            assert issubclass(err, p.ProtocolError)
    e, r = proto.ProtocolError("x", code=7), ref_proto.ProtocolError(
        "x", code=7)
    assert (str(e), e.code) == (str(r), r.code)
    assert (zk.NO_NODE, zk.NODE_EXISTS, zk.BAD_VERSION) == (
        ref_zk.NO_NODE, ref_zk.NODE_EXISTS, ref_zk.BAD_VERSION)
    assert str(zk.ZkError(zk.NO_NODE)) == str(ref_zk.ZkError(ref_zk.NO_NODE))


# ---------------------------------------------------------------------------
# RESP
# ---------------------------------------------------------------------------


def _resp_script(pkg, port):
    c = pkg.resp.RespClient("127.0.0.1", port)
    steps = [
        lambda: c.connect() and None,
        lambda: c.call("PING"),
        lambda: c.call("SET", "x", "1"),
        lambda: c.call("GET", "x"),
        lambda: c.call("GET", "missing"),
        lambda: c.call("INCR", "x"),
        lambda: c.call("INCR", "x"),
        lambda: c.call("DEL", "x", "nope"),
        lambda: c.call("SET", "u", "héllo wörld"),
        lambda: c.call("GET", "u"),
        lambda: c.call("SADD", "s", "a", "b"),
        lambda: c.call("SADD", "s", "b"),
        lambda: c.call("SMEMBERS", "s"),
        lambda: c.call("NOPE", "arg"),
        lambda: c.call("ADDJOB", "q1", "payload-1", "100"),
        lambda: c.call("ADDJOB", "q1", "payload-2", "100"),
        lambda: c.call("GETJOB", "TIMEOUT", "100", "FROM", "q1"),
        lambda: c.call("ACKJOB", "DI-fake-id"),
        lambda: c.call("GETJOB", "FROM", "q1"),
        lambda: c.call("GETJOB", "FROM", "q1"),
        lambda: c.call("PING"),
    ]
    try:
        return [outcome(s) for s in steps]
    finally:
        c.close()


@pytest.mark.parametrize("fake", [FakeRedis, FakeDisque],
                         ids=["redis", "disque"])
def test_resp_replies_errors_and_bytes(fake):
    out = run_both(fake, _resp_script)
    assert_same(out)
    outcomes = out["port"][0]
    assert outcomes[1] == ("ok", "PONG") and outcomes[4] == ("ok", None)
    assert outcomes[13][:3] == ("err", "ProtocolError", "ERR")


def test_resp_dead_server_is_indeterminate():
    for pkg in PACKAGES.values():
        srv = FakeRedis().start()
        c = pkg.resp.RespClient("127.0.0.1", srv.port).connect()
        try:
            assert c.call("SET", "x", "1") == "OK"
            srv.stop()
            with pytest.raises(pkg.proto.IndeterminateError):
                for _ in range(3):  # the first send may land in a buffer
                    c.call("SET", "x", "2")
        finally:
            c.close()
            srv.stop()


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------


def _mask_host(b, port):
    return b.replace(b"127.0.0.1:%d" % port, b"127.0.0.1:PORT")


def _http_script(pkg, port):
    c = pkg.http.JsonHttpClient("127.0.0.1", port, timeout=5.0)
    k = "/v2/keys/jepsen/r"
    steps = [
        lambda: c.get(k, params={"quorum": "true"}),
        lambda: c.put(k, {"value": "1"}, form=True),
        lambda: c.get(k, params={"quorum": "true"}),
        lambda: c.put(k, {"value": "2", "prevValue": "1"}, form=True),
        lambda: c.put(k, {"value": "3", "prevValue": "1"}, form=True),
        lambda: c.put(k, {"value": "4", "prevExist": "false"}, form=True),
        lambda: c.put("/v2/keys/jepsen/s", {"value": "[1]",
                                            "prevExist": "false"}, form=True),
        lambda: c.put("/v2/keys/jepsen/s", {"value": "[1, 2]",
                                            "prevIndex": "999"}, form=True),
        lambda: c.delete(k),
        lambda: c.get(k),
        lambda: c.put("/v1/kv/jepsen/a", "7"),
        lambda: c.get("/v1/kv/jepsen/a"),
        lambda: c.get("/v1/kv/jepsen/a", params={"consistent": ""}),
        lambda: c.put("/v1/kv/jepsen/a", "8", params={"cas": "1"}),
        lambda: c.put("/v1/kv/jepsen/a", "9", params={"cas": "999"}),
        lambda: c.get("/v1/kv/jepsen/missing"),
        lambda: c.post("/v1/kv/jepsen/j", {"json": [1, "two"]}),
        lambda: c.get("/no/such/route"),
        lambda: c.get("/no/such/route", raise_on_error=False),
    ]
    try:
        return [outcome(s) for s in steps]
    finally:
        c.close()


def test_http_replies_errors_and_bytes():
    out = run_both(FakeHttpKv, _http_script, mask=_mask_host)
    assert_same(out)
    outcomes = out["port"][0]
    assert outcomes[0][:3] == ("err", "HttpError", 404)
    assert outcomes[4][:3] == ("err", "HttpError", 412)


def test_http_dead_server_is_indeterminate():
    for pkg in PACKAGES.values():
        srv = FakeHttpKv().start()
        c = pkg.http.JsonHttpClient("127.0.0.1", srv.port, timeout=2.0)
        try:
            c.put("/v2/keys/jepsen/x", {"value": "1"}, form=True)
            srv.stop()
            with pytest.raises(pkg.proto.IndeterminateError):
                c.get("/v2/keys/jepsen/x")
            assert c.conn is None  # dropped, so the next call redials
        finally:
            c.close()
            srv.stop()


# ---------------------------------------------------------------------------
# ZooKeeper
# ---------------------------------------------------------------------------


def _zk_script(pkg, port):
    c = pkg.zk.ZkClient("127.0.0.1", port)
    steps = [
        lambda: c.connect().session_id,
        lambda: c.create("/jepsen", b"0"),
        lambda: c.create("/jepsen", b"1"),
        lambda: c.get_data("/jepsen"),
        lambda: c.set_data("/jepsen", b"5", version=0),
        lambda: c.set_data("/jepsen", b"6", version=0),
        lambda: c.set_data("/jepsen", b"7"),
        lambda: c.get_data("/jepsen"),
        lambda: c.get_data("/none"),
        lambda: c.create("/q", b""),
        lambda: c.create("/q/b", b"2"),
        lambda: c.create("/q/a", b"1"),
        lambda: c.get_children("/q"),
        lambda: c.delete("/q/a"),
        lambda: c.delete("/q/a"),
        lambda: c.get_children("/q"),
        lambda: c.exists("/q/a"),
        lambda: c.exists("/q/b"),
        lambda: c.set_data("/none", b"x"),
    ]
    try:
        return [outcome(s) for s in steps]
    finally:
        c.close()


def test_zk_replies_errors_and_bytes():
    out = run_both(FakeZk, _zk_script)
    assert_same(out)
    outcomes = out["port"][0]
    assert outcomes[2][:3] == ("err", "ZkError", zk.NODE_EXISTS)
    assert outcomes[5][:3] == ("err", "ZkError", zk.BAD_VERSION)
    assert outcomes[8][:3] == ("err", "ZkError", zk.NO_NODE)


def test_zk_sessions_and_dead_server():
    for pkg in PACKAGES.values():
        srv = FakeZk().start()
        a = pkg.zk.ZkClient("127.0.0.1", srv.port).connect()
        b = pkg.zk.ZkClient("127.0.0.1", srv.port).connect()
        try:
            assert a.session_id != b.session_id
            srv.stop()
            with pytest.raises(pkg.proto.IndeterminateError):
                for _ in range(3):
                    a.get_data("/x")
        finally:
            a.close()
            b.close()
            srv.stop()


# ---------------------------------------------------------------------------
# pgwire
# ---------------------------------------------------------------------------


def _pg_messages(b):
    """The client stream as messages: the startup packet, then typed
    ``(type, payload)`` messages."""
    n = struct.unpack("!I", b[:4])[0]
    msgs, off = [(None, b[4:n])], n
    while off < len(b):
        t, ln = b[off:off + 1], struct.unpack("!I", b[off + 1:off + 5])[0]
        msgs.append((t, b[off + 5:off + 1 + ln]))
        off += 1 + ln
    return msgs


def _mask_pg_auth(b, port):
    """md5 and SCRAM password messages carry the server's random salt or
    the client's random nonce: their bytes are exempt."""
    return [(t, b"<auth>" if t == b"p" else p) for t, p in _pg_messages(b)]


def _pg_script(auth, password="sekrit"):
    def script(pkg, port):
        c = pkg.pgwire.PgClient("127.0.0.1", port, user="alice",
                                password=password)
        steps = [
            lambda: c.connect().parameters,
            lambda: c.query("SELECT 1"),
            lambda: c.query("INSERT INTO kv (key, val) VALUES ('a', '10')"),
            lambda: c.query("SELECT val FROM kv WHERE key='a'"),
            lambda: c.query("SELECT val FROM kv WHERE key='nope'"),
            lambda: c.query("UPDATE kv SET val='11' WHERE key='a'"),
            lambda: c.query("INSERT INTO kv (key, val) VALUES ('a', '2')"),
            lambda: c.query("SELECT boom"),
            lambda: c.query("BEGIN"),
            lambda: c.query("CREATE TABLE IF NOT EXISTS registers "
                            "(id INT PRIMARY KEY, val INT)"),
            lambda: c.query("INSERT INTO registers (id, val) VALUES (1, 5) "
                            "ON CONFLICT (id) DO UPDATE SET val = 5"),
            lambda: c.query("COMMIT"),
            lambda: c.query("SELECT val FROM registers WHERE id = 1"),
            lambda: c.query("UPDATE registers SET val = 6 WHERE id = 1 "
                            "AND val = 4"),
            lambda: c.query("SELECT 1"),
        ]
        try:
            return [outcome(s) for s in steps]
        finally:
            c.close()

    return script


@pytest.mark.parametrize("auth", ["trust", "cleartext", "md5", "scram"])
def test_pg_replies_errors_and_bytes(auth):
    exempt = auth in ("md5", "scram")
    out = run_both(lambda: FakePg(auth_mode=auth, password="sekrit"),
                   _pg_script(auth),
                   mask=_mask_pg_auth if exempt else None)
    assert_same(out)
    outcomes = out["port"][0]
    assert outcomes[1][0] == "ok" and outcomes[1][1][1]["rows"] == [["1"]]
    assert outcomes[6][:3] == ("err", "PgError", "23505")
    assert outcomes[7][:3] == ("err", "PgError", "40001")
    if not exempt:
        # the whole stream is compared, the auth exchange included
        assert out["port"][1] == out["ref"][1]


def _refused(mask):
    """``mask``, then without the close's last message (pgwire's
    Terminate, MySQL's COM_QUIT): sent after the server closed a refused
    connection, it reaches the relay or not by a race."""
    def masked(b, port):
        msgs = mask(b, port)
        if msgs and msgs[-1][1] in (b"", b"\x01"):
            msgs = msgs[:-1]
        return msgs

    return masked


def _pg_connect(password):
    """Only the connect: after a refusal the server closes the socket, so
    whether a next query fails on its send or on its read is a race (and
    whether the close's Terminate reaches it: :func:`_refused`)."""
    def script(pkg, port):
        c = pkg.pgwire.PgClient("127.0.0.1", port, user="alice",
                                password=password)
        try:
            return [outcome(lambda: c.connect().parameters)]
        finally:
            c.close()

    return script


@pytest.mark.parametrize("auth", ["cleartext", "md5", "scram"])
def test_pg_bad_password(auth):
    out = run_both(lambda: FakePg(auth_mode=auth, password="right"),
                   _pg_connect("wrong"), mask=_refused(_mask_pg_auth))
    assert_same(out)
    assert out["port"][0][0][:3] == ("err", "PgError", "28P01")


def test_pg_dead_server_is_indeterminate():
    for pkg in PACKAGES.values():
        srv = FakePg().start()
        c = pkg.pgwire.PgClient("127.0.0.1", srv.port).connect()
        try:
            srv.stop()
            with pytest.raises(pkg.proto.IndeterminateError):
                for _ in range(3):
                    c.query("SELECT 1")
        finally:
            c.close()
            srv.stop()


def test_pg_quote_literal():
    for s in ("plain", "it's", "", 5, None, "a\\b"):
        try:
            want = ("ok", ref_pgwire.quote_literal(s))
        except Exception as e:  # noqa: BLE001
            want = ("err", type(e).__name__)
        try:
            got = ("ok", pgwire.quote_literal(s))
        except Exception as e:  # noqa: BLE001
            got = ("err", type(e).__name__)
        assert got == want, s


# ---------------------------------------------------------------------------
# MySQL
# ---------------------------------------------------------------------------


def _mysql_packets(b):
    out, off = [], 0
    while off < len(b):
        ln = int.from_bytes(b[off:off + 3], "little")
        out.append((b[off + 3], b[off + 4:off + 4 + ln]))
        off += 4 + ln
    return out


def _mask_mysql_auth(b, port):
    """The handshake response's auth data and any auth-switch response
    are scrambled with the server's random nonce: exempt.  Everything
    else of the handshake response (capabilities, user, database, plugin)
    is compared."""
    pkts, out, authed = _mysql_packets(b), [], False
    for seq, p in pkts:
        if not authed and seq == 1:
            user_end = p.index(b"\0", 32)
            n = p[user_end + 1]
            p = p[:user_end + 2] + b"\0" * n + p[user_end + 2 + n:]
        elif not authed and seq > 1:
            p = b"<auth>"
        if seq == 0:
            authed = True
        out.append((seq, p))
    return out


def _mysql_script(database=""):
    def script(pkg, port):
        c = pkg.mysql.MysqlClient("127.0.0.1", port, user="root",
                                  password="pw", database=database)
        steps = [
            lambda: c.connect() and None,
            lambda: c.query("SELECT 1"),
            lambda: c.query("INSERT INTO kv (key, val) VALUES ('a', '5')"),
            lambda: c.query("SELECT val FROM kv WHERE key='a'"),
            lambda: c.query("SELECT val FROM kv WHERE key='zzz'"),
            lambda: c.query("UPDATE kv SET val='6' WHERE key='a'"),
            lambda: c.query("SELECT boom"),
            lambda: c.query("INSERT INTO kv (key, val) VALUES ('a', '2')"),
            lambda: c.query("CREATE TABLE IF NOT EXISTS sets (val INT)"),
            lambda: c.query("INSERT INTO sets (val) VALUES (3)"),
            lambda: c.query("SELECT val FROM sets"),
            lambda: c.query("SELECT 1"),
        ]
        try:
            return [outcome(s) for s in steps]
        finally:
            c.close()

    return script


@pytest.mark.parametrize("database", ["", "jepsen"])
def test_mysql_replies_errors_and_bytes(database):
    out = run_both(lambda: FakeMysql(password="pw"), _mysql_script(database),
                   mask=_mask_mysql_auth)
    assert_same(out)
    outcomes = out["port"][0]
    assert outcomes[1] == out["ref"][0][1] and outcomes[1][0] == "ok"
    assert outcomes[6][:3] == ("err", "MysqlError", 1213)
    assert outcomes[7][:3] == ("err", "MysqlError", 1062)


def _mysql_connect(pkg, port):
    """Only the connect (see :func:`_pg_connect`)."""
    c = pkg.mysql.MysqlClient("127.0.0.1", port, user="root",
                              password="wrong")
    try:
        return [outcome(lambda: c.connect() and None)]
    finally:
        c.close()


def test_mysql_bad_password_and_retriable_codes():
    out = run_both(lambda: FakeMysql(password="right"), _mysql_connect,
                   mask=_refused(_mask_mysql_auth))
    assert_same(out)
    assert out["port"][0][0][:3] == ("err", "MysqlError", 1045)
    for code in (1213, 1205, 1062, 1045, 8002, 9007):
        assert mysql.MysqlError("x", code=code).retriable == \
            ref_mysql.MysqlError("x", code=code).retriable
    for pw in ("", "pw", "sekrit"):
        for scramble in (b"", b"\x01" * 20, bytes(range(20))):
            assert mysql._native_password(pw, scramble) == \
                ref_mysql._native_password(pw, scramble)


def test_mysql_dead_server_is_indeterminate():
    for pkg in PACKAGES.values():
        srv = FakeMysql(password="pw").start()
        c = pkg.mysql.MysqlClient("127.0.0.1", srv.port, user="root",
                                  password="pw").connect()
        try:
            srv.stop()
            with pytest.raises(pkg.proto.IndeterminateError):
                for _ in range(3):
                    c.query("SELECT 1")
        finally:
            c.close()
            srv.stop()
