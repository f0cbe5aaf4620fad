"""The dense-automaton kernels of two sources on one card: an earlier
``dense_automaton.cu`` (a copy under the git-ignored ``build/``) against
the checkout's.

    python3 scripts/dense_ab.py sass --parent build/ab/parent/dense_automaton.cu
    python3 scripts/dense_ab.py time --parent build/ab/parent/dense_automaton.cu

``sass`` builds both sources with the port's ``nvcc`` flags (printing
``-Xptxas -v``), writes each library's SASS to
``build/ab/dense_sass_<name>.txt`` and prints the instruction count of
every kernel.  ``time`` runs both libraries' ``dense_automaton_launch``
on the same inputs at ``PERF.md`` §5's shapes and prints one JSON line
per shape: the median of 7 CUDA-event timings after 2 warm-ups, taken in
turns old, new, new, old, and whether the outputs are byte-equal.  With
``--switch`` it also times the checkout's source built with every value
of the warp/block switch (``DENSE_WARP_MAX_WORDS``) on the register
shapes.  The unordered-queue automaton (K2, ``dense_queue_launch``) is
timed the same way at ``chip_smoke.py`` phase 18's shapes: its 16384-row
flagship (E 64, C 8) and that workload at C 1, 6 and 12 (64 histories
of as many processes, tiled to 16384 rows), each line also with
``*_graph_ms`` (launches captured in a CUDA graph and replayed: the
device's time) and the design (``dense.queue_design``).  ``--family
queue`` times the queue alone, ``--family register`` the others alone.
Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from jepsen_tpu_torch.ops import _build  # noqa: E402

AB_DIR = ROOT / "build" / "ab"


def build(src: Path, name: str, defines=()) -> Path:
    """``src`` built with the port's flags (plus ``-D`` ``defines``) into
    ``build/ab/lib<name>.so``; prints ptxas's report."""
    AB_DIR.mkdir(parents=True, exist_ok=True)
    out = AB_DIR / f"lib{name}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS,
           *(f"-D{d}" for d in defines), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(json.dumps({"build": name, "rc": proc.returncode,
                      "ptxas": proc.stdout + proc.stderr}), flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}")
    return out


def cuobjdump() -> str:
    return str(Path(_build.nvcc()).with_name("cuobjdump"))


def sass(args) -> None:
    for name, src in (("parent", Path(args.parent)),
                      ("checkout", _build.SOURCES["dense_automaton"])):
        lib = build(src, name)
        text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        (AB_DIR / f"dense_sass_{name}.txt").write_text(text)
        counts = {}
        for block in text.split("Function : ")[1:]:
            fn = block.split("\n", 1)[0].strip()
            counts[fn] = len(re.findall(r"/\*[0-9a-f]{4}\*/", block))
        print(json.dumps({"sass": name, "instructions": counts}), flush=True)


def launcher(path: Path):
    """``run(arrays, S, fam, mr, pm)`` calling ``path``'s
    ``dense_automaton_launch`` on the current stream."""
    import torch
    from jepsen_tpu_torch.ops import dense

    fn = ctypes.CDLL(str(path)).dense_automaton_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(arrays, S, fam, mr=(0, 0), pm=None):
        B, E, C = arrays[2].shape
        dev = arrays[0].device
        out = (torch.empty((B,), dtype=torch.bool, device=dev),
               torch.empty((B,), dtype=torch.int32, device=dev),
               torch.empty((B,), dtype=torch.bool, device=dev))
        acq, rel = pm if pm is not None else (None, None)
        err = fn(*(t.data_ptr() for t in arrays), *(t.data_ptr() for t in out),
                 B, E, C, S, dense.FAMILY_IDS[fam], mr[0], mr[1],
                 None if acq is None else acq.data_ptr(),
                 None if rel is None else rel.data_ptr(),
                 0 if acq is None else acq.shape[0] - 1,
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{path.name}: CUDA error {err}")
        return out
    return run


def queue_launcher(path: Path):
    """``run(arrays)`` calling ``path``'s ``dense_queue_launch`` on the
    current stream."""
    import torch

    fn = ctypes.CDLL(str(path)).dense_queue_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(arrays):
        B, E, C = arrays[2].shape
        dev = arrays[0].device
        out = (torch.empty((B,), dtype=torch.bool, device=dev),
               torch.empty((B,), dtype=torch.int32, device=dev),
               torch.empty((B,), dtype=torch.bool, device=dev))
        err = fn(*(t.data_ptr() for t in arrays), *(t.data_ptr() for t in out),
                 B, E, C, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{path.name}: CUDA error {err}")
        return out
    return run


def queue_shapes(device):
    """(name, arrays on ``device``) of the queue automaton at phase 18's
    flagship and at C 1, 6 and 12, tiled to as many rows."""
    import numpy as np
    import chip_smoke as cs

    flag, _ = cs.queue_flagship()
    B = flag[0].shape[0]
    out = [("queue-flagship", flag)]
    for C in (1, 6, 12):
        hs, ms = cs.queue_histories(48110 + C, 64, n_procs=C)
        arrays, _ = cs.queue_arrays(hs, ms, C)
        reps = -(-B // arrays[0].shape[0])
        out.append((f"queue-C{C}", tuple(np.concatenate([a] * reps)[:B]
                                         for a in arrays)))
    return [(name, cs.to_device(a, device)) for name, a in out]


def turn_ms(run, args, reps=7, warmup=2):
    """Median ms of ``reps`` CUDA-event-timed launches after ``warmup``."""
    import numpy as np
    import torch

    for _ in range(warmup):
        run(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def shapes(device):
    """(name, arrays on ``device``, S, family, mr, pm) at PERF.md §5's
    shapes, from chip_smoke.py's generators."""
    import numpy as np
    import chip_smoke as cs
    from jepsen_tpu_torch import models

    flag, _, V = cs.flagship_batch()
    out = [("flagship", cs.to_device(flag, device), V, "register", (0, 0),
            None)]
    edge = cs.random_batch("register", 45304, B=128, E=256, C=12, amax=31,
                           p_accept=0.995, p_stray=0.0)
    out.append(("C12-V32", cs.to_device(tuple(np.concatenate([a] * 8)
                                              for a in edge), device),
                32, "register", (0, 0), None))
    for name, fam, model, hs in (
            ("owner-mutex", "register", models.owner_mutex(),
             cs.lock_histories(46200, 1024)),
            ("reentrant", "reentrant-mutex", models.reentrant_mutex(),
             cs.lock_histories(46100, 1024, reentrant=True)),
            ("semaphore", "acquired-permits", models.acquired_permits(2),
             cs.permit_histories(46300, 1024)),
            ("multi-register", "multi-register",
             models.multi_register({0: 0, 1: 0}),
             cs.mr_histories(46400, 1024, n_keys=2, n_values=8))):
        arrays, plan = cs.family_batch(model, hs, device)
        checker = plan.fn
        pm = ((checker.pm_acq_src, checker.pm_rel_src)
              if fam == "acquired-permits" else None)
        out.append((name, cs.to_device(arrays, device), checker.S, fam,
                    checker.mr_shape, pm))
    return out


def time_ab(args) -> None:
    import torch

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    src = _build.SOURCES["dense_automaton"]
    paths = {"old": build(Path(args.parent), "parent"),
             "new": build(src, "checkout")}
    if args.family in ("all", "queue"):
        time_queue(paths, device, card)
    if args.family == "queue":
        return
    libs = {k: launcher(p) for k, p in paths.items()}
    if args.switch:
        libs["block"] = launcher(build(src, "checkout_block",
                                       ["DENSE_WARP_MAX_SW=0"]))
    for name, arrays, S, fam, mr, pm in shapes(device):
        call = (arrays, S, fam, mr, pm)
        outs = {k: [t.cpu().numpy().tobytes() for t in run(*call)]
                for k, run in libs.items()}
        equal = all(v == outs["old"] for v in outs.values())
        pairs = [("old", "new")]
        if args.switch and fam == "register":
            pairs.append(("new", "block"))
        for a, b in pairs:
            turns = [(a, turn_ms(libs[a], call)), (b, turn_ms(libs[b], call)),
                     (b, turn_ms(libs[b], call)), (a, turn_ms(libs[a], call))]
            print(json.dumps({
                "shape": name, "family": fam, "rows": int(arrays[0].shape[0]),
                "E": int(arrays[1].shape[1]), "C": int(arrays[2].shape[2]),
                "S": S, "turns_ms": turns,
                f"{a}_ms": sorted(t for k, t in turns if k == a),
                f"{b}_ms": sorted(t for k, t in turns if k == b),
                "byte_equal": equal, "card": card}), flush=True)
        if not equal:
            raise RuntimeError(f"{name}: outputs differ between builds")


def time_queue(paths, device, card) -> None:
    """Old against new for the queue automaton at :func:`queue_shapes`."""
    import chip_smoke as cs
    from jepsen_tpu_torch.ops import dense

    libs = {k: queue_launcher(p) for k, p in paths.items()}
    for name, arrays in queue_shapes(device):
        call = (arrays,)
        outs = {k: [t.cpu().numpy().tobytes() for t in run(*call)]
                for k, run in libs.items()}
        equal = outs["old"] == outs["new"]
        turns = [(k, turn_ms(libs[k], call)) for k in ("old", "new", "new",
                                                       "old")]
        graphs = [(k, cs.graph_ms(libs[k], call, launches=5))
                  for k in ("old", "new", "new", "old")]
        C = int(arrays[2].shape[2])
        print(json.dumps({
            "shape": name, "family": dense.QUEUE,
            "rows": int(arrays[0].shape[0]), "E": int(arrays[1].shape[1]),
            "C": C, "design": dense.queue_design(C), "turns_ms": turns,
            **{f"{k}_ms": sorted(t for kk, t in turns if kk == k)
               for k in ("old", "new")},
            **{f"{k}_graph_ms": sorted(t for kk, t in graphs if kk == k)
               for k in ("old", "new")},
            "byte_equal": equal, "card": card}), flush=True)
        if not equal:
            raise RuntimeError(f"{name}: outputs differ between builds")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("sass", "time"))
    ap.add_argument("--parent", required=True)
    ap.add_argument("--switch", action="store_true")
    ap.add_argument("--family", choices=("all", "queue", "register"),
                    default="all")
    args = ap.parse_args()
    if args.mode == "sass":
        sass(args)
    else:
        time_ab(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
