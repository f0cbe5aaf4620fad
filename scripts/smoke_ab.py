"""``chip_smoke.py``'s host-bound steps in two checkouts on one card: an
earlier ``synth.py``, ``ops/wgl.py`` and ``ops/dense.py`` (copies under the
git-ignored ``build/ab/parent/``) against the checkout's.

    mkdir -p build/ab/parent
    for f in synth.py ops/wgl.py ops/dense.py; do
        git show <parent>:jepsen_tpu_torch/$f > build/ab/parent/$(basename $f)
    done
    python3 scripts/smoke_ab.py --parent build/ab/parent [--histories 256]

It times, in turns old, new, new, old: generating ``--histories`` of each
corpus the smoke generates at full size (the end-to-end register
histories, the frontier slice, the reentrant and owner locks, the
semaphore and the multi-register histories, with their seeds and
settings), and the plain versions the smoke holds the kernels against
(the flagship register batch, the frontier slice at F 128 and the
reentrant-lock and multi-register families, each with ``work=`` as the
smoke calls them).  It requires equal histories, outputs and operation
counts from both versions, and prints one JSON line per step with the
four seconds and each version's best.  Needs one CUDA device (``--device
cpu`` rehearses it on the CPU).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from jepsen_tpu_torch import models, synth  # noqa: E402
from jepsen_tpu_torch.ops import dense, wgl  # noqa: E402


def load(path: Path, name: str):
    """A parent module as ``jepsen_tpu_torch.<name>`` (its relative
    imports resolve to the checkout's package)."""
    spec = importlib.util.spec_from_file_location(
        f"jepsen_tpu_torch.{name}", str(path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def generators(mod, n):
    """The smoke's corpora at ``n`` histories, built with ``mod``'s
    generators (seeds and settings as ``chip_smoke.py`` has them)."""
    def locks(seed, reentrant):
        rng = random.Random(seed)
        return [mod.generate_lock_history(rng, n_procs=10, n_ops=1000,
                                          reentrant=reentrant,
                                          corrupt=i % 4 == 0)
                for i in range(n)]

    def permits():
        rng = random.Random(46300)
        return [mod.generate_permits_history(rng, n_procs=10, n_ops=1000,
                                             n_permits=2, corrupt=i % 4 == 0)
                for i in range(n)]

    def mrs():
        rng = random.Random(46400)
        return [mod.generate_mr_history(rng, n_procs=8, n_ops=1000, n_keys=2,
                                        n_values=8, crash_p=0.002,
                                        corrupt=i % 4 == 0)
                for i in range(n)]

    def slice_():
        rng = random.Random(45200)
        return [mod.generate_history(rng, n_procs=5, n_ops=1000,
                                     crash_p=0.002, n_values=40,
                                     corrupt=rng.random() < 0.25)
                for _ in range(n)]

    return {
        "end_to_end": lambda: mod.generate_batch(
            seed=45101, n_histories=n, n_procs=5, n_ops=1000,
            crash_p=0.002, corrupt_fraction=0.25),
        "slice": slice_,
        "reentrant": lambda: locks(46100, True),
        "owner": lambda: locks(46200, False),
        "permit": permits,
        "multi-register": mrs,
    }


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def as_dicts(hs):
    return [[op.to_dict() for op in h] for h in hs]


def turns(name, old_fn, new_fn, same, **fields):
    """old, new, new, old; ``same(a, b)`` must hold between the two."""
    outs, secs = {}, {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        out, s = timed(old_fn if which == "old" else new_fn)
        secs[which].append(s)
        outs[which] = out
    if not same(outs["old"], outs["new"]):
        raise SystemExit(f"{name}: the two versions differ")
    print(json.dumps({"step": name, "old_s": secs["old"],
                      "new_s": secs["new"], "old_best": min(secs["old"]),
                      "new_best": min(secs["new"]), **fields}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--parent", required=True)
    p.add_argument("--histories", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="where the plain versions run (cpu: a rehearsal)")
    args = p.parse_args(argv)
    parent = Path(args.parent)
    old_synth = load(parent / "synth.py", "_parent_synth")
    old_wgl = load(parent / "wgl.py", "ops._parent_wgl")
    old_dense = load(parent / "dense.py", "ops._parent_dense")
    device = torch.device(args.device)
    print(cs.card_line(), flush=True)

    old_gen = generators(old_synth, args.histories)
    new_gen = generators(synth, args.histories)
    for name in new_gen:
        turns(f"generate {name}", old_gen[name], new_gen[name],
              lambda a, b: as_dicts(a) == as_dicts(b),
              histories=args.histories)

    def plain_pair(ref_old, ref_new, arrays, **kw):
        t = cs.to_device(arrays, device)

        def run(ref):
            work: dict = {}
            out = ref(*t, work=work, **kw)
            return [x.cpu().numpy().tobytes() for x in out], work
        return (lambda: run(ref_old)), (lambda: run(ref_new))

    arrays, _, V = cs.flagship_batch()
    _, E, C = arrays[2].shape
    fn = dense.make_dense_fn("cas-register", E, C, V, device)
    kw = dict(S=fn.S, tables=fn.tables(), fam=fn.family, params=fn._params())
    o, n = plain_pair(old_dense.dense_check_reference,
                      dense.dense_check_reference, arrays, **kw)
    turns("plain flagship", o, n, lambda a, b: a == b,
          rows=int(arrays[2].shape[0]))

    hs = cs.slice_histories(45200, cs.FRONTIER_HISTORIES)
    fa = cs.encoded(hs, slot_cap=32)
    kw = dict(spec_name="cas-register", F=wgl.DEFAULT_FRONTIER,
              max_closure=fa[2].shape[2] + 1)
    o, n = plain_pair(old_wgl.frontier_check_reference,
                      wgl.frontier_check_reference, fa, **kw)
    turns("plain frontier slice", o, n, lambda a, b: a == b,
          rows=int(fa[2].shape[0]))

    n_f = cs.FAMILY_HISTORIES
    for name, model, make in (
            ("reentrant", models.reentrant_mutex(),
             lambda: cs.lock_histories(46100, n_f, reentrant=True)),
            ("multi-register", models.multi_register({0: 0, 1: 0}),
             lambda: cs.mr_histories(46400, n_f, n_keys=2, n_values=8))):
        a, plan = cs.family_batch(model, make(), device)
        f = plan.fn
        kw = dict(S=f.S, tables=f.tables(), fam=f.family, params=f._params())
        o, n = plain_pair(old_dense.dense_check_reference,
                          dense.dense_check_reference, a, **kw)
        turns(f"plain {name}", o, n, lambda x, y: x == y,
              rows=int(a[2].shape[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
