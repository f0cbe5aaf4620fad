"""The Elle closure kernels (has-cycle and the screen) of two sources on
one card: an earlier ``cycles_closure.cu`` (a copy under the git-ignored
``build/ab/``) against the checkout's.

    python3 scripts/cycles_ab.py sass --parent build/ab/parent/cycles_closure.cu
    python3 scripts/cycles_ab.py time --parent build/ab/parent/cycles_closure.cu

``sass`` builds both sources with the port's ``nvcc`` flags (printing
``-Xptxas -v``: registers and spills), writes each library's SASS to
``build/ab/cycles_sass_<name>.txt`` and prints the instruction and ``BAR``
counts of every kernel; with ``--check`` it then runs both libraries once
at every shape of ``time``, in both modes, and raises unless their outputs
are byte-equal (no timing).

``time`` runs both libraries' ``cycles_has_cycle_launch`` and
``cycles_screen_launch`` on the same inputs, in both closure modes, at:
``chip_smoke.py``'s list-append stack (1024 rows, n 512, 6 filter masks,
2 walk queries), the rw-register version-graph stack (1024 graphs, n 16)
and random has-cycle stacks at n 32, 64, 512 and 1024.  It prints one
JSON line per shape and mode: the median of 7 CUDA-event timings after 2
warm-ups, taken in turns old, new, new, old, the design the checkout runs
there (``cycles.has_cycle_design`` / ``cycles.screen_design``), and
whether the outputs are byte-equal across the builds (it raises if not);
beside each median, ``*_graph_ms``: the same turns with 20 launches
captured in one CUDA graph and replayed, the device's time per launch
without the Python wrapper's host time.
With ``--switch`` it also times, on the list-append stack in ``"fixed"``
mode, the checkout built with ``CYCLES_REDUCED_LIFTED=0`` (the walk
queries on the 2n lifted planes, the filter planes on the new closure).
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

from dense_ab import AB_DIR, build, cuobjdump, turn_ms

from jepsen_tpu_torch.ops import _build, cycles

SOURCE = _build.SOURCES["cycles_closure"]

#: the checkout's source with the walk queries on the lifted planes
VARIANTS = {"lifted": ["CYCLES_REDUCED_LIFTED=0"]}

MODES = ("fixed", "earlyexit")

#: random has-cycle stacks: (n, rows)
RANDOM_STACKS = ((32, 256), (64, 256), (512, 64), (1024, 64))


def sass(args) -> None:
    libs = {}
    for name, src in (("parent", Path(args.parent)), ("checkout", SOURCE)):
        lib = libs[name] = build(src, f"cycles_{name}")
        text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        (AB_DIR / f"cycles_sass_{name}.txt").write_text(text)
        counts = {}
        for block in text.split("Function : ")[1:]:
            fn = block.split("\n", 1)[0].strip()
            counts[fn] = {
                "instructions": len(re.findall(r"/\*[0-9a-f]{4}\*/", block)),
                "barriers": len(re.findall(r"\bBAR\.", block)),
            }
        print(json.dumps({"sass": name, "kernels": counts}), flush=True)
    if args.check:
        import torch

        runs = {"old": launcher(libs["parent"]),
                "new": launcher(libs["checkout"])}
        for name, x, profile in shapes(torch.device("cuda", 0)):
            for mode in MODES:
                equal = outputs(runs, (x, mode, profile))
                print(json.dumps({"check": name, "mode": mode,
                                  "rows": int(x.shape[0]),
                                  "n": int(x.shape[-1]),
                                  "byte_equal": equal}), flush=True)
                if not equal:
                    raise RuntimeError(f"{name} ({mode}): outputs differ "
                                       f"between builds")


def launcher(path: Path):
    """``run(x, mode, profile)`` calling ``path``'s has-cycle entry point
    (``profile`` None) or its screen entry point (``profile`` = (masks,
    nonadj)) on the current stream."""
    import torch

    lib = ctypes.CDLL(str(path))
    hc = lib.cycles_has_cycle_launch
    hc.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    hc.restype = ctypes.c_int
    sc = lib.cycles_screen_launch
    sc.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    sc.restype = ctypes.c_int
    u8 = ctypes.c_uint8

    def run(x, mode, profile):
        B, n = int(x.shape[0]), int(x.shape[-1])
        dev = x.device
        early = int(mode == "earlyexit")
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = torch.empty((2,), dtype=torch.int32, device=dev)
        rounds = torch.empty((B,), dtype=torch.int32, device=dev)
        if profile is None:
            flags = torch.empty((B,), dtype=torch.bool, device=dev)
            err = hc(x.data_ptr(), flags.data_ptr(), rounds.data_ptr(), None,
                     scratch.data_ptr(), B, n, early, stream)
            out = (flags, rounds)
        else:
            masks, nonadj = profile
            F, Q = len(masks), len(nonadj)
            members = torch.empty((B, F, n), dtype=torch.bool, device=dev)
            walks = torch.empty((B, Q, n), dtype=torch.bool, device=dev)
            m_arr = (u8 * cycles.MAX_FILTERS)(*masks)
            w_arr = (u8 * cycles.MAX_LIFTED)(*(w for w, _ in nonadj))
            r_arr = (u8 * cycles.MAX_LIFTED)(*(r for _, r in nonadj))
            err = sc(x.data_ptr(), members.data_ptr(), walks.data_ptr(),
                     rounds.data_ptr(), scratch.data_ptr(), B, n, F,
                     ctypes.addressof(m_arr), Q, ctypes.addressof(w_arr),
                     ctypes.addressof(r_arr), early, stream)
            out = (members, walks, rounds)
        if err:
            raise RuntimeError(f"{path.name}: CUDA error {err}")
        return out
    return run


def shapes(device):
    """(name, relation stack on ``device``, profile or None) at the shapes
    of ``chip_smoke.py`` phases 15-17, from its generators."""
    import numpy as np
    import torch

    import chip_smoke as cs

    rel, _ = cs.list_append_stack(cs.elle_histories("append", 47100))
    vg = cs.version_graph_stack(cs.elle_histories("wr", 47200))
    out = [("list-append", rel, (cs.ELLE_MASKS, cs.ELLE_NONADJ)),
           ("version-graphs", vg[np.arange(cs.ELLE_STACK_ROWS) % len(vg)],
            None)]
    rng = np.random.default_rng(47500)
    for n, rows in RANDOM_STACKS:
        dens = rng.choice([0.5, 1.0, 1.5, 4.0], size=rows) / n
        out.append((f"random-n{n}", (rng.random((rows, n, n))
                                     < dens[:, None, None]).astype(np.uint8),
                    None))
    return [(name, torch.from_numpy(x).to(device), profile)
            for name, x, profile in out]


def outputs(runs, call) -> bool:
    """Whether every library's outputs on ``call`` are byte-equal."""
    outs = {k: [t.cpu().numpy().tobytes() for t in run(*call)]
            for k, run in runs.items()}
    return all(v == outs["old"] for v in outs.values())


def design(x, mode, profile):
    n = int(x.shape[-1])
    if profile is None:
        return cycles.has_cycle_design(n)
    return {"filter": "double", "walks": cycles.screen_design(mode, n)}


def time_ab(args) -> None:
    import torch

    import chip_smoke as cs

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    runs = {"old": launcher(build(Path(args.parent), "cycles_parent")),
            "new": launcher(build(SOURCE, "cycles_checkout"))}
    if args.switch:
        for name, defines in VARIANTS.items():
            runs[name] = launcher(build(SOURCE, f"cycles_{name}", defines))
    for name, x, profile in shapes(device):
        for mode in MODES:
            call = (x, mode, profile)
            equal = outputs(runs, call)
            pairs = [("old", "new")]
            if profile is not None and mode == "fixed":
                pairs += [("new", v) for v in runs if v not in ("old", "new")]
            for a, b in pairs:
                turns = [(a, turn_ms(runs[a], call)),
                         (b, turn_ms(runs[b], call)),
                         (b, turn_ms(runs[b], call)),
                         (a, turn_ms(runs[a], call))]
                graphs = [(k, cs.graph_ms(runs[k], call))
                          for k in (a, b, b, a)]
                print(json.dumps({
                    "shape": name, "mode": mode, "rows": int(x.shape[0]),
                    "n": int(x.shape[-1]),
                    "design": design(x, mode, profile), "turns_ms": turns,
                    f"{a}_ms": sorted(t for k, t in turns if k == a),
                    f"{b}_ms": sorted(t for k, t in turns if k == b),
                    f"{a}_graph_ms": sorted(t for k, t in graphs if k == a),
                    f"{b}_graph_ms": sorted(t for k, t in graphs if k == b),
                    "byte_equal": equal, "card": card}), flush=True)
            if not equal:
                raise RuntimeError(f"{name} ({mode}): outputs differ "
                                   f"between builds")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("sass", "time"))
    ap.add_argument("--parent", required=True)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--switch", action="store_true")
    args = ap.parse_args()
    if args.mode == "sass":
        sass(args)
    else:
        time_ab(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
