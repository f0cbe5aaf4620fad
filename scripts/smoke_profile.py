"""Where ``chip_smoke.py``'s host time goes, on one card: for each data set
the script builds (the flagship, the end-to-end corpus, the frontier
slice, the lock, permit and multi-register families) the seconds to
generate its histories (``synth``) and to encode them, then, for the
plain versions it holds the kernels against, the wall seconds of one run
and, in a second run under ``torch.profiler``, the device seconds of the
kernels that run launched and their count.  A plain version whose wall
time is far above its device time is bound by the host (the Python loop
and the launches), not by the card.

    python3 scripts/smoke_profile.py [--only flagship,permit,...]

Prints one JSON line per data set.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from jepsen_tpu_torch import models, synth  # noqa: E402
from jepsen_tpu_torch.ops import dense, encode, wgl  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_seconds(fn):
    """Kernel device seconds and launches of one run of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total += e.device_time_total / 1e6
            count += 1
    return total, count


def plain_line(name, gen_s, enc_s, run, **fields):
    _, wall = timed(run)
    dev_s, kernels = device_seconds(run)
    print(json.dumps({"set": name, "generate_s": gen_s, "encode_s": enc_s,
                      "plain_wall_s": wall, "plain_device_s": dev_s,
                      "plain_kernels": kernels, **fields}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", default="")
    args = p.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    device = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)

    def want(name):
        return not only or name in only

    if want("flagship"):
        (arrays, _r, V), gen_s = timed(cs.flagship_batch)
        _, E, C = arrays[2].shape
        fn = dense.make_dense_fn("cas-register", E, C, V, device)
        t = cs.to_device(arrays, device)
        plain_line("flagship", gen_s, None, lambda: fn.reference(*t),
                   rows=int(arrays[2].shape[0]))
    if want("end_to_end"):
        hs, gen_s = timed(lambda: synth.generate_batch(
            seed=45101, n_histories=cs.E2E_HISTORIES - 8, n_procs=5,
            n_ops=1000, crash_p=0.002, corrupt_fraction=0.25))
        _, enc_s = timed(lambda: encode.batch_encode(
            hs, models.cas_register(0), slot_cap=8))
        print(json.dumps({"set": "end_to_end", "generate_s": gen_s,
                          "encode_s": enc_s}), flush=True)
    if want("slice"):
        hs, gen_s = timed(lambda: cs.slice_histories(45200,
                                                     cs.FRONTIER_HISTORIES))
        a, enc_s = timed(lambda: cs.encoded(hs, slot_cap=32))
        t = cs.to_device(a, device)
        C = a[2].shape[2]
        plain_line("slice", gen_s, enc_s,
                   lambda: wgl.frontier_check_reference(
                       *t, spec_name="cas-register",
                       F=wgl.DEFAULT_FRONTIER, max_closure=C + 1),
                   F=wgl.DEFAULT_FRONTIER)
    n = cs.FAMILY_HISTORIES
    for name, model, make in (
            ("reentrant", models.reentrant_mutex(),
             lambda: cs.lock_histories(46100, n, reentrant=True)),
            ("owner", models.owner_mutex(),
             lambda: cs.lock_histories(46200, n)),
            ("permit", models.acquired_permits(2),
             lambda: cs.permit_histories(46300, n)),
            ("multi-register", models.multi_register({0: 0, 1: 0}),
             lambda: cs.mr_histories(46400, n, n_keys=2, n_values=8))):
        if not want(name):
            continue
        hs, gen_s = timed(make)
        (arrays, plan), enc_s = timed(
            lambda: cs.family_batch(model, hs, device))
        t = cs.to_device(arrays, device)
        plain_line(name, gen_s, enc_s,
                   lambda: plan.fn.reference(*t, work={}), S=plan.fn.S)
    return 0


if __name__ == "__main__":
    sys.exit(main())
