"""The frontier-search kernels of two sources on one card: an earlier
``frontier_search.cu`` (a copy under the git-ignored ``build/``) against
the checkout's.

    python3 scripts/frontier_ab.py sass --parent build/ab/parent/frontier_search.cu
    python3 scripts/frontier_ab.py time --parent build/ab/parent/frontier_search.cu

``sass`` builds both sources with the port's ``nvcc`` flags (printing
``-Xptxas -v``: registers and spills), writes each library's SASS to
``build/ab/frontier_sass_<name>.txt`` and prints the instruction count of
every kernel.  ``time`` runs both libraries' ``frontier_search_launch`` on
the same inputs and prints one JSON line per shape: the median of 7
CUDA-event timings after 2 warm-ups, taken in turns old, new, new, old,
the design the checkout runs there (``wgl.frontier_design``), and whether
the outputs are byte-equal across the builds (it raises if not).  The
shapes: the slice of ``chip_smoke.py`` phase 6 (1024 rows, C 8) at F 128
and 512, the crash-heavy C = 16 rows at F 128 and their escalation rung
at F 512, the sufficient rung's edge, two linset words, max_closure = 2,
and the unordered queue at F 256.  With ``--switch`` it also times the
checkout built with every shape on the block design
(``FRONTIER_WARP_MAX_WORDS=0``).
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

from jepsen_tpu_torch.ops import _build

SOURCE = _build.SOURCES["frontier_search"]

#: the checkout's source built with every shape on the block design
VARIANTS = {"block": ["FRONTIER_WARP_MAX_WORDS=0"]}


def sass(args) -> None:
    for name, src in (("parent", Path(args.parent)), ("checkout", SOURCE)):
        lib = build(src, f"frontier_{name}")
        text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        (AB_DIR / f"frontier_sass_{name}.txt").write_text(text)
        counts = {}
        for block in text.split("Function : ")[1:]:
            fn = block.split("\n", 1)[0].strip()
            counts[fn] = {
                "instructions": len(re.findall(r"/\*[0-9a-f]{4}\*/", block)),
                "barriers": len(re.findall(r"\bBAR\.", block)),
            }
        print(json.dumps({"sass": name, "kernels": counts}), flush=True)


def launcher(path: Path):
    """``run(arrays, spec, F, mc)`` calling ``path``'s
    ``frontier_search_launch`` on the current stream, with the workspace
    that library asks for."""
    import torch
    from jepsen_tpu_torch.ops.step_kernels import STEP_IDS

    lib = ctypes.CDLL(str(path))
    size = lib.frontier_search_workspace_bytes
    size.argtypes = [ctypes.c_int, ctypes.c_int]
    size.restype = ctypes.c_longlong
    fn = lib.frontier_search_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(arrays, spec, F, mc):
        B, E, C = arrays[2].shape
        dev = arrays[0].device
        out = (torch.empty((B,), dtype=torch.bool, device=dev),
               torch.empty((B,), dtype=torch.int32, device=dev),
               torch.empty((B,), dtype=torch.bool, device=dev))
        ws = torch.empty((B * size(F, C),), dtype=torch.uint8, device=dev)
        err = fn(*(t.data_ptr() for t in arrays), *(t.data_ptr() for t in out),
                 ws.data_ptr(), B, E, C, F, mc, STEP_IDS[spec],
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{path.name}: CUDA error {err}")
        return out
    return run


def shapes(device, new):
    """(name, arrays on ``device``, spec, F, max_closure) at the shapes of
    ``chip_smoke.py`` phases 6, 7 and 18, from its generators; the rung's
    rows are those ``new`` overflows at F 128."""
    import random

    import chip_smoke as cs
    from jepsen_tpu_torch import synth
    from jepsen_tpu_torch.ops import wgl

    slice_a = cs.encoded(cs.slice_histories(45200, cs.FRONTIER_HISTORIES),
                         slot_cap=32)
    C = slice_a[2].shape[2]
    short = tuple(a[:128] for a in slice_a)
    hc = cs.encoded(cs.crash_heavy_histories(45210, 64), slot_cap=16)
    hc_dev = cs.to_device(hc, device)
    hc_ovf = new(hc_dev, "cas-register", 128, 17)[2].cpu().numpy()
    _, rung = wgl.overflow_rows(hc, hc_ovf)
    suff_hs = [synth.generate_history(random.Random(45220 + i), n_procs=4,
                                      n_ops=150, n_values=200, crash_p=0.0,
                                      corrupt=i % 4 == 0) for i in range(64)]
    suff = cs.encoded(suff_hs, slot_cap=4)
    suff_F = wgl.sufficient_frontier(
        wgl.value_domain("cas-register", suff[0], suff[4], suff[5]),
        suff[2].shape[2])
    q_hs, q_ms = cs.queue_histories(48150, cs.QUEUE_E2E_HISTORIES)
    queue, _ = cs.queue_arrays(q_hs, q_ms, cs.QUEUE_PROCS)
    qC = queue[2].shape[2]
    out = [
        ("slice", slice_a, "cas-register", 128, C + 1),
        ("slice-F512", slice_a, "cas-register", 512, C + 1),
        ("C16", hc, "cas-register", 128, 17),
        ("C16-rung", rung, "cas-register", 512, 17),
        ("sufficient", suff, "cas-register", suff_F, 5),
        ("W2", cs.two_word(short), "cas-register", 128, 41),
        ("max_closure=2", short, "cas-register", 128, 2),
        ("queue", queue, "unordered-queue", 256, qC + 1),
    ]
    return [(name, hc_dev if a is hc else cs.to_device(a, device), spec, F,
             mc) for name, a, spec, F, mc in out]


def time_ab(args) -> None:
    import torch
    from jepsen_tpu_torch.ops import wgl

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = {"old": launcher(build(Path(args.parent), "frontier_parent")),
            "new": launcher(build(SOURCE, "frontier_checkout"))}
    if args.switch:
        for name, defines in VARIANTS.items():
            libs[name] = launcher(build(SOURCE, f"frontier_{name}", defines))
    for name, arrays, spec, F, mc in shapes(device, libs["new"]):
        call = (arrays, spec, F, mc)
        outs = {k: [t.cpu().numpy().tobytes() for t in run(*call)]
                for k, run in libs.items()}
        equal = all(v == outs["old"] for v in outs.values())
        B, E, C = (int(x) for x in arrays[2].shape)
        pairs = [("old", "new")] + [("new", v) for v in libs
                                    if v not in ("old", "new")]
        for a, b in pairs:
            turns = [(a, turn_ms(libs[a], call)), (b, turn_ms(libs[b], call)),
                     (b, turn_ms(libs[b], call)), (a, turn_ms(libs[a], call))]
            print(json.dumps({
                "shape": name, "spec": spec, "rows": B, "E": E, "C": C,
                "F": F, "max_closure": mc,
                "design": wgl.frontier_design(F, C), "turns_ms": turns,
                f"{a}_ms": sorted(t for k, t in turns if k == a),
                f"{b}_ms": sorted(t for k, t in turns if k == b),
                "byte_equal": equal, "card": card}), flush=True)
        if not equal:
            raise RuntimeError(f"{name}: outputs differ between builds")


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
