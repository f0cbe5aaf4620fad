"""The host encode (``ops.encode.batch_encode``) of two or more checkouts,
on the corpora ``chip_smoke.py`` encodes: each checkout's
``jepsen_tpu_torch`` in a subprocess of its own, in the order given.

    git archive <parent> | tar -x -C build/ab/parent
    python3 scripts/encode_ab.py build/ab/parent . build/ab/parent .

For phase 4's cas-register histories (1000 ops, slot cap 8) and phases
10-11's reentrant lock, semaphore and two-register multi-register
corpora (1000 ops, slot cap 32), 256 histories each built by this
checkout's ``chip_smoke.py`` builders, a subprocess imports the given
checkout's package and times ``batch_encode`` (process CPU time, the
best of 5) per corpus.  It prints one JSON line per run: the checkout,
milliseconds per history by corpus and their sum, and a digest of every
output array (values, dtypes, shapes, fallback and row lists); it raises
if two checkouts' digests differ.  Host only: no CUDA device is used.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import hashlib, json, pickle, sys, time
tree, corpora = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
from jepsen_tpu_torch.ops import encode
assert encode.__file__.startswith(tree), encode.__file__
with open(corpora, "rb") as f:
    corpora = pickle.load(f)
digest = hashlib.sha256()
ms = {}
for name, (hs, model, cap) in corpora.items():
    best = None
    for _ in range(5):
        t0 = time.process_time()
        b = encode.batch_encode(hs, model, slot_cap=cap)
        t = time.process_time() - t0
        best = t if best is None else min(best, t)
    ms[name] = 1e3 * best / len(hs)
    for a in (b.init_state, b.ev_slot, b.cand_slot, b.cand_f, b.cand_a,
              b.cand_b):
        digest.update(a.tobytes() + str((a.dtype, a.shape)).encode())
    digest.update(repr((b.fallback, b.row_history)).encode())
print(json.dumps({"tree": tree, "ms_per_history": ms,
                  "sum": sum(ms.values()), "digest": digest.hexdigest()}))
"""


def corpora(n: int = 256) -> dict:
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from jepsen_tpu_torch import models

    return {
        "cas-register": (cs.end_to_end_histories()[:n],
                         models.cas_register(0), 8),
        "reentrant-lock": (cs.lock_histories(46100, n, reentrant=True),
                           models.reentrant_mutex(), 32),
        "semaphore": (cs.permit_histories(46300, n),
                      models.acquired_permits(2), 32),
        "multi-register": (cs.mr_histories(46400, n, n_keys=2, n_values=8),
                           models.multi_register({0: 0, 1: 0}), 32),
    }


def main(trees) -> int:
    import pickle
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpora.pickle")
        with open(path, "wb") as f:
            pickle.dump(corpora(), f)
        digests = set()
        for tree in trees:
            out = subprocess.run(
                [sys.executable, "-c", _CHILD, os.path.abspath(tree), path],
                capture_output=True, text=True, timeout=900, check=True)
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            digests.add(line["digest"])
        if len(digests) != 1:
            raise SystemExit("encode_ab: the checkouts' outputs differ")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [ROOT]))
