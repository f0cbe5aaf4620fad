"""The dense automaton's plain PyTorch version of two checkouts on one card:
an earlier ``ops/dense.py`` (a copy under the git-ignored ``build/ab/``)
against the checkout's, at the shapes ``chip_smoke.py`` phases 2 and
10-11 compare the CUDA kernel with it.

    git show <parent>:jepsen_tpu_torch/ops/dense.py > build/ab/parent/dense.py
    python3 scripts/plain_ab.py --parent build/ab/parent/dense.py

For the flagship register batch (phase 2: 16384 rows, E 832, C 8), the
reentrant lock (K1r), the semaphore (K1p) and the two-register
multi-register (K1m) (phases 10-11's 1024-history corpora, planned as the
engine plans them) it copies the batch to the card and times
``dense_check_reference(..., work={})`` (as the smoke calls it) of both
versions in turns old, new, new, old, synchronised on both sides; it
prints one JSON line per family with the four seconds, each version's
best and whether the outputs and the operation counts are equal across
the versions (it raises if not).  The parent module is loaded beside the
checkout's, so it runs against the checkout's other modules.  Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from jepsen_tpu_torch import models  # noqa: E402
from jepsen_tpu_torch.ops import dense  # noqa: E402


def load_parent(path: str):
    """The parent's ``dense.py`` as ``jepsen_tpu_torch.ops._parent_dense``
    (its relative imports resolve to the checkout's package)."""
    spec = importlib.util.spec_from_file_location(
        "jepsen_tpu_torch.ops._parent_dense", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def batches(device):
    """``(name, host arrays, checker)`` of each family's batch."""
    arrays, _, V = chip_smoke.flagship_batch()
    _, E, C = arrays[2].shape
    yield ("cas-register flagship", arrays,
           dense.make_dense_fn("cas-register", E, C, V, device))
    n = chip_smoke.FAMILY_HISTORIES
    for name, model, hs in (
            ("reentrant-cp-lock", models.reentrant_mutex(),
             chip_smoke.lock_histories(46100, n, reentrant=True)),
            ("semaphore", models.acquired_permits(2),
             chip_smoke.permit_histories(46300, n)),
            ("multi-register", models.multi_register({0: 0, 1: 0}),
             chip_smoke.mr_histories(46400, n, n_keys=2, n_values=8))):
        arrays, plan = chip_smoke.family_batch(model, hs, device)
        yield name, arrays, plan.fn


def timed(fn, checker, arrays):
    work: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*arrays, S=checker.S, tables=checker.tables(), work=work,
             fam=checker.family, params=checker._params())
    torch.cuda.synchronize()
    return time.perf_counter() - t0, [x.cpu() for x in out], work


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the earlier ops/dense.py")
    args = ap.parse_args(argv)
    parent = load_parent(args.parent)
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for name, arrays, checker in batches(device):
        dev_arrays = chip_smoke.to_device(arrays, device)
        turns = []
        outs = {}
        for which in ("parent", "checkout", "checkout", "parent"):
            fn = (parent.dense_check_reference if which == "parent"
                  else dense.dense_check_reference)
            s, out, work = timed(fn, checker, dev_arrays)
            turns.append((which, s))
            outs.setdefault(which, (out, work))
        (p_out, p_work), (c_out, c_work) = outs["parent"], outs["checkout"]
        same = all(torch.equal(a, b) for a, b in zip(p_out, c_out))
        if not same or p_work != c_work:
            raise SystemExit(f"{name}: the versions differ "
                             f"(outputs equal {same}, work {p_work} vs "
                             f"{c_work})")
        print(json.dumps({
            "family": name, "spec": checker.spec_name,
            "rows": int(arrays[0].shape[0]),
            "E": int(arrays[1].shape[1]), "C": int(arrays[2].shape[2]),
            "S": checker.S, "turns_s": turns,
            "parent_best_s": min(s for w, s in turns if w == "parent"),
            "checkout_best_s": min(s for w, s in turns if w == "checkout"),
            "outputs_equal": same, "work_equal": p_work == c_work,
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
