"""The verdict-stats kernel (K9) of two sources on one card: an earlier
``verdict_stats.cu`` (a copy under the git-ignored ``build/ab/``) against
the checkout's.

    python3 scripts/stats_ab.py sass --parent build/ab/parent/verdict_stats.cu
    python3 scripts/stats_ab.py time --parent build/ab/parent/verdict_stats.cu

``sass`` builds both sources with the port's ``nvcc`` flags (printing
``-Xptxas -v``: registers and spills), writes each library's SASS to
``build/ab/stats_sass_<name>.txt`` and prints the instruction count of
every kernel.  ``time`` runs both libraries' ``verdict_stats_launch`` on
the same bytes (random ok and overflow flags, seed 48300) at 16384 rows
(``chip_smoke.py`` phase 20), at its two 8192-row shards and at 10^6
rows, and prints one JSON line per shape: the median of 7 CUDA-event
timings around the launch after 2 warm-ups (host and device), taken in
turns old, new, new, old; ``*_graph_ms``, the same turns with 20 launches
captured in one CUDA graph and replayed (the device's time); the checkout
design (``mesh.stats_design``); and whether the counts are equal across
the builds (it raises if not).  Each line also carries
``empty_graph_ms``: an empty kernel's graph time on the same card, the
floor of a launch.  With ``--switch`` it times the checkout built to take
one block at every row count against the checkout built to take a grid
at every row count, at 16384 rows to 10^6 (graph times), which places
``VERDICT_STATS_SINGLE_MAX_ROWS``.  Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

from dense_ab import AB_DIR, build, cuobjdump, turn_ms

from jepsen_tpu_torch.ops import _build
from jepsen_tpu_torch.parallel import mesh

SOURCE = _build.SOURCES["verdict_stats"]

#: the checkout's source with one block, or a grid, at every row count
VARIANTS = {"single": ["VERDICT_STATS_SINGLE_MAX_ROWS=(1LL<<62)"],
            "grid": ["VERDICT_STATS_SINGLE_MAX_ROWS=0"]}

#: row counts of the switch's sweep
SWEEP = (16384, 32768, 65536, 131072, 262144, 1000000)


def sass(args) -> None:
    for name, src in (("parent", Path(args.parent)), ("checkout", SOURCE)):
        lib = build(src, f"stats_{name}")
        text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        (AB_DIR / f"stats_sass_{name}.txt").write_text(text)
        counts = {}
        for block in text.split("Function : ")[1:]:
            fn = block.split("\n", 1)[0].strip()
            counts[fn] = len(re.findall(r"/\*[0-9a-f]{4}\*/", block))
        print(json.dumps({"sass": name, "instructions": counts}), flush=True)


def launcher(path: Path):
    """``run(ok, overflow)`` calling ``path``'s ``verdict_stats_launch`` on
    the current stream."""
    import torch

    fn = ctypes.CDLL(str(path)).verdict_stats_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(ok, ovf):
        counts = torch.empty((3,), dtype=torch.int64, device=ok.device)
        err = fn(ok.data_ptr(), ovf.data_ptr(), ok.shape[0],
                 counts.data_ptr(),
                 torch.cuda.current_stream(ok.device).cuda_stream)
        if err:
            raise RuntimeError(f"{path.name}: CUDA error {err}")
        return counts
    return run


def flags(device, B):
    import numpy as np
    import torch

    r = np.random.default_rng(48300)
    ok = torch.from_numpy(r.random(B) < 0.75).to(device)
    ovf = torch.from_numpy(r.random(B) < 0.05).to(device)
    return ok, ovf


def time_ab(args) -> None:
    import torch

    import chip_smoke as cs

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    runs = {"old": launcher(build(Path(args.parent), "stats_parent")),
            "new": launcher(build(SOURCE, "stats_checkout"))}
    empty = cs.empty_kernel()
    ok, ovf = flags(device, 16384)
    big_ok, big_ovf = flags(device, 1000000)
    shapes = [("16384", ok, ovf), ("shard0-8192", ok[:8192], ovf[:8192]),
              ("shard1-8192", ok[8192:], ovf[8192:]),
              ("1e6", big_ok, big_ovf)]
    for name, o, v in shapes:
        call = (o, v)
        outs = {k: run(*call).tolist() for k, run in runs.items()}
        equal = outs["old"] == outs["new"]
        turns = [(k, turn_ms(runs[k], call)) for k in ("old", "new", "new",
                                                       "old")]
        graphs = [(k, cs.graph_ms(runs[k], call))
                  for k in ("old", "new", "new", "old")]
        print(json.dumps({
            "shape": name, "rows": int(o.shape[0]),
            "design": mesh.stats_design(int(o.shape[0])),
            "counts": outs["new"], "turns_ms": turns,
            **{f"{k}_ms": sorted(t for kk, t in turns if kk == k)
               for k in ("old", "new")},
            **{f"{k}_graph_ms": sorted(t for kk, t in graphs if kk == k)
               for k in ("old", "new")},
            "empty_graph_ms": sorted(cs.graph_ms(empty, ()) for _ in range(2)),
            "byte_equal": equal, "card": card}), flush=True)
        if not equal:
            raise RuntimeError(f"{name}: counts differ between builds")
    if not args.switch:
        return
    sides = {k: launcher(build(SOURCE, f"stats_{k}", d))
             for k, d in VARIANTS.items()}
    for B in SWEEP:
        call = flags(device, B)
        outs = {k: run(*call).tolist() for k, run in sides.items()}
        graphs = [(k, cs.graph_ms(sides[k], call))
                  for k in ("single", "grid", "grid", "single")]
        print(json.dumps({
            "switch_rows": B,
            **{f"{k}_graph_ms": sorted(t for kk, t in graphs if kk == k)
               for k in sides},
            "byte_equal": outs["single"] == outs["grid"], "card": card}),
            flush=True)
        if outs["single"] != outs["grid"]:
            raise RuntimeError(f"{B} rows: the two sides' counts differ")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("sass", "time"))
    ap.add_argument("--parent", required=True)
    ap.add_argument("--switch", action="store_true")
    args = ap.parse_args()
    if args.mode == "sass":
        sass(args)
    else:
        time_ab(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
