"""The port's store (``store/__init__.py``, ``store/format.py``) against
the JAX package's, which imports no JAX: a ``test.jtpu`` either package
writes loads in the other to an equal test map, history and results; the
blocks are equal on their decoded values (the packed section is an
``np.savez`` zip whose entry timestamps come from the clock, so bytes may
differ there); torn tails recover the same way."""

import json
import os
import shutil
import struct

import numpy as np
import pytest

from jepsen_tpu import history as ref_history
from jepsen_tpu import store as ref_store
from jepsen_tpu.store import format as ref_fmt
from jepsen_tpu_torch import history as port_history
from jepsen_tpu_torch import store as port_store
from jepsen_tpu_torch.independent import kv
from jepsen_tpu_torch.store import format as port_fmt

PACKAGES = {
    "ref": (ref_store, ref_fmt, ref_history),
    "port": (port_store, port_fmt, port_history),
}


def _dicts(n, seed=0, keyed=False):
    """A seeded register history of n ops, invokes and completions, with
    nemesis events between them."""
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for i in range(n // 2):
        p = int(rng.integers(0, 5))
        f = str(rng.choice(["read", "write", "cas"]))
        v = (None if f == "read" else
             [int(rng.integers(0, 5)), int(rng.integers(0, 5))]
             if f == "cas" else int(rng.integers(0, 5)))
        if keyed:
            v = [int(rng.integers(0, 3)), v]
        out.append({"type": "invoke", "process": p, "f": f, "value": v,
                    "time": t})
        ty = str(rng.choice(["ok", "fail", "info"], p=[0.8, 0.1, 0.1]))
        comp = {"type": ty, "process": p, "f": f, "value": v, "time": t + 5}
        if ty == "info":
            comp["error"] = "indeterminate: boom"
        out.append(comp)
        if i % 17 == 0:
            out.append({"type": "info", "process": "nemesis", "f": "start",
                        "value": {"n1": ["n2"]}, "time": t + 6})
        t += int(rng.integers(10, 1000))
    return out


def _test_map(base, name="parity"):
    return {"name": name, "start-time": "20261018T000000.000",
            "store-base": str(base), "nodes": ["n1", "n2", "n3"],
            "concurrency": 6, "time-limit": 3.0, "extra": {"a": [1, 2]}}


def _save(package, base, ds, results):
    store, _fmt, hist = PACKAGES[package]
    t = _test_map(base)
    with store.with_writer(t) as t2:
        t2 = store.save_0(t2)
        t2 = {**t2, "history": hist.History.from_dicts(ds).index_ops()}
        t2 = store.save_1(t2)
        t2 = {**t2, "results": results}
        store.save_2(t2)
    return t


def _load(package, t):
    store = PACKAGES[package][0]
    return store.load({k: t[k] for k in ("name", "start-time",
                                         "store-base")})


RESULTS = {"valid?": False, "linearizable": {"valid?": False,
                                             "failures": [1]},
           "timeline": {"valid?": True}}


def _canon(loaded):
    """A loaded test as plain data: the history as op dicts."""
    out = dict(loaded)
    out["history"] = [op.to_dict() for op in loaded["history"]]
    return out


@pytest.mark.parametrize("n_ops", [40, 2 * 8192 + 50])  # one block; chunked
@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_each_package_reads_the_others_file(tmp_path, writer, reader,
                                            n_ops):
    ds = _dicts(n_ops, seed=n_ops)
    t = _save(writer, tmp_path / writer, ds, RESULTS)
    loaded = _canon(_load(reader, t))
    same = _canon(_load(writer, t))
    assert loaded == same
    assert loaded["results"] == RESULTS
    assert loaded["extra"] == {"a": [1, 2]}
    assert loaded["history"] == [
        {**d, "index": i} for i, d in enumerate(ds)]


def _blocks(fmt, path):
    """Every block of a file as (type, decoded value): JSON as parsed,
    partial maps as (rest id, head), histories as their JSONL lines and
    their packed arrays and tables."""
    r = fmt.Reader(path)
    out = []
    for bid in sorted(r.blocks):
        type_, data = r.read_id(bid)
        if type_ in (fmt.JSON_BLOCK,):
            out.append((type_, json.loads(data)))
        elif type_ == fmt.PARTIAL_MAP:
            out.append((type_, struct.unpack("<I", data[:4])[0],
                        json.loads(data[4:])))
        elif type_ == fmt.HISTORY_CHUNK:
            out.append((type_, data.decode().splitlines()))
        elif type_ in (fmt.HISTORY, fmt.CHUNKED_HISTORY):
            packed = r.read_packed_history(bid)
            arrays = {k: v.tolist() for k, v in packed["arrays"].items()}
            lines = [op.to_dict() for op in r.iter_history(bid)]
            out.append((type_, lines, arrays, packed["tables"]))
        else:
            raise AssertionError(type_)
    return out, r.root


@pytest.mark.parametrize("n_ops", [40, 2 * 8192 + 50])
def test_blocks_are_equal_on_their_decoded_values(tmp_path, n_ops):
    ds = _dicts(n_ops, seed=1 + n_ops, keyed=True)
    paths = {}
    for pkg in ("ref", "port"):
        # one store base for both, so the saved test maps are the same
        t = _save(pkg, tmp_path / "store", ds, RESULTS)
        paths[pkg] = str(tmp_path / f"{pkg}.jtpu")
        shutil.move(port_store.jtpu_file(t), paths[pkg])
    for fmt in (ref_fmt, port_fmt):
        assert _blocks(fmt, paths["port"]) == _blocks(fmt, paths["ref"])
    # outside the packed section the bytes are the same: every index,
    # JSON, partial-map and chunk block
    r_ref, r_port = port_fmt.Reader(paths["ref"]), port_fmt.Reader(
        paths["port"])
    assert r_ref.blocks == r_port.blocks
    for bid in r_ref.blocks:
        t_ref, d_ref = r_ref.read_id(bid)
        t_port, d_port = r_port.read_id(bid)
        assert t_ref == t_port
        if t_ref not in (port_fmt.HISTORY, port_fmt.CHUNKED_HISTORY):
            assert d_ref == d_port


def test_writers_write_the_same_bytes_without_a_history(tmp_path):
    """The port's pure-Python writer and the reference's (its C++ writer
    where it builds) on blocks without the clock-stamped zip."""
    paths = []
    for name, fmt in (("ref", ref_fmt), ("port", port_fmt)):
        p = str(tmp_path / f"{name}.jtpu")
        with fmt.Writer(p) as w:
            b = w.write_json({"k": "v", "n": [1, 2, {"x": None}]})
            head = w.write_partial_map({"valid?": True}, rest_id=b)
            w.set_root(head)
            w.save_index()
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def _truncated(path, tmp_path, n):
    out = str(tmp_path / f"torn-{n}.jtpu")
    with open(path, "rb") as src, open(out, "wb") as dst:
        dst.write(src.read()[:n])
    return out


def _recovered(fmt, path):
    try:
        r = fmt.Reader(path, recover=True)
    except IOError:
        return "unrecoverable"
    out = r.root_value()
    view = {k: v for k, v in out.items() if not fmt.is_block_ref(v)}
    for k in ("history", "results"):
        if fmt.is_block_ref(out.get(k)):
            v = r.read_value(out[k]["$block-ref"])
            view[k] = ([op.to_dict() for op in v] if k == "history" else v)
    return r.recovered, r.valid_prefix_end, view


def test_torn_tails_recover_the_same_way(tmp_path):
    """Cut the port's file at every block boundary ±k bytes: both
    packages' readers recover the same view (or both refuse)."""
    ds = _dicts(30, seed=5)
    t = _save("port", tmp_path / "w", ds, RESULTS)
    path = port_store.jtpu_file(t)
    frames, end = port_fmt.scan_valid_prefix(path)
    assert (frames, end) == ref_fmt.scan_valid_prefix(path)
    size = os.path.getsize(path)
    cuts = sorted({b + k for b in [off for off, _ in frames] + [size]
                   for k in (-3, -1, 0, 1, 3)
                   if port_fmt.HEADER_SIZE <= b + k <= size})
    outcomes = set()
    for n in cuts:
        torn = _truncated(path, tmp_path, n)
        port = _recovered(port_fmt, torn)
        assert port == _recovered(ref_fmt, torn), n
        outcomes.add("unrecoverable" if port == "unrecoverable"
                     else ("results" in port[2], "history" in port[2]))
    # the cuts reach every save phase and the refusal before the first
    assert outcomes == {"unrecoverable", (False, False), (False, True),
                        (True, True)}


def test_store_load_flags_recovery_in_both(tmp_path):
    ds = _dicts(30, seed=6)
    t = _save("port", tmp_path / "w", ds, RESULTS)
    path = port_store.jtpu_file(t)
    frames, _ = port_fmt.scan_valid_prefix(path)
    with open(path, "r+b") as f:
        f.truncate(frames[-1][0] + 6)  # tear the final index frame
    loads = [_canon(_load(pkg, t)) for pkg in ("ref", "port")]
    assert loads[0] == loads[1]
    assert loads[1]["recovered"] is True
    # the newest intact index is save_1's: the history, not the results
    assert "results" not in loads[1]
    assert len(loads[1]["history"]) == len(ds)


def test_packed_history_and_listing_match(tmp_path):
    ds = _dicts(60, seed=7, keyed=True)
    t = _save("port", tmp_path / "w", ds, RESULTS)
    a = ref_store.load_packed_history(t)
    b = port_store.load_packed_history(t)
    assert a["tables"] == b["tables"]
    assert {k: v.tolist() for k, v in a["arrays"].items()} == \
        {k: v.tolist() for k, v in b["arrays"].items()}
    base = t["store-base"]
    assert port_store.tests(base) == ref_store.tests(base)
    assert port_store.latest_time(base, "parity") == \
        ref_store.latest_time(base, "parity") == t["start-time"]
    assert _canon(port_store.latest(base)) == _canon(ref_store.latest(base))


def test_serializable_test_drops_the_live_client():
    t = {"name": "x", "live-client": object(), "client": object(),
         "history": [], "nodes": ["n1"]}
    assert port_store.serializable_test(t) == {"name": "x", "nodes": ["n1"]}


def test_keyed_values_round_trip(tmp_path):
    """A keyed history (``[k, v]`` values) written by the port reads back
    with lists where the KV tuples were, in both packages."""
    h = port_history.History([
        port_history.invoke_op(0, "write", kv(1, 3), time=0),
        port_history.ok_op(0, "write", kv(1, 3), time=1),
    ]).index_ops()
    t = _test_map(tmp_path)
    with port_store.with_writer(t) as t2:
        t2 = port_store.save_0(t2)
        t2 = port_store.save_1({**t2, "history": h})
        port_store.save_2({**t2, "results": {"valid?": True}})
    for pkg in ("ref", "port"):
        loaded = _load(pkg, t)
        assert [op.value for op in loaded["history"]] == [[1, 3], [1, 3]]


@pytest.mark.parametrize("keyed", [False, True])
def test_native_writer_writes_the_python_writers_bytes(tmp_path, monkeypatch,
                                                       keyed):
    """With ``native/blockfile.cc`` built (``store/native.py``, into the
    git-ignored ``build/native/``), the store's writer goes through it and
    writes the pure-Python writer's bytes; the reference reads that file.
    The packed history section is memoised so both runs write the same
    zip (its entry timestamps come from the clock)."""
    from jepsen_tpu_torch.store import native

    assert native.available(), "g++ could not build native/blockfile.cc"
    assert native.library_path().parent.parts[-2:] == ("build", "native")
    packed = {}
    pack = port_fmt._pack_history
    monkeypatch.setattr(port_fmt, "_pack_history",
                        lambda h: packed.setdefault(len(h), pack(h)))
    used = []
    create = port_fmt.Writer.__init__

    def spy(self, path):
        create(self, path)
        used.append(self._native is not None)

    monkeypatch.setattr(port_fmt.Writer, "__init__", spy)
    ds = _dicts(600, seed=3, keyed=keyed)
    results = {"valid?": False, "errors": [{"op": 7}], "n": 600}
    # one store base for both (the test map, and so its bytes, name it)
    t = _save("port", tmp_path, ds, results)
    a = open(port_store.jtpu_file(t), "rb").read()
    ref = _load("ref", t)
    assert ref["results"] == results
    assert len(ref["history"]) == len(ds)
    shutil.rmtree(tmp_path / t["name"])
    monkeypatch.setattr(native, "lib", lambda: None)
    t = _save("port", tmp_path, ds, results)
    b = open(port_store.jtpu_file(t), "rb").read()
    assert used == [True, False]
    assert a == b and len(a) > 1000
