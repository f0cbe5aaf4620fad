"""Where the frontier kernel's warp design spends its time, history by
history, on one card.

    python3 scripts/frontier_diag.py

Copies the checkout's ``frontier_search.cu`` into the git-ignored
``build/ab/`` with ``clock64`` laps added to the warp design (each history's
lane 0 sums the cycles of each phase and counts events, passes, build and
dedup chunks, survivors and probes, and writes them to a device buffer),
builds it with the port's flags, runs it on ``chip_smoke.py``'s slice (1024
rows, C 8, F 128) and prints JSON lines: the kernel's ms (CUDA events,
median of 7), the spread of per-history cycles, the mean of every counter
over all histories, over the 8 slowest and over the faster half, and the
slowest history's own counters.  The laps cost a few percent of the
kernel's time.  Fails if the source no longer has a line a lap goes after.
Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from dense_ab import AB_DIR, build, turn_ms
from frontier_ab import SOURCE, launcher

#: counter slots, each history's 24 int64 in the device buffer
NAMES = {
    0: "events", 1: "cyc_commit", 2: "survivors", 3: "build_chunks",
    4: "cyc_pass_rest", 5: "passes", 6: "dedup_chunks", 7: "cyc_loop",
    8: "probes_lane0", 9: "cyc_completion", 10: "cyc_total", 12: "n_end",
    13: "cyc_build", 14: "cyc_dedup_append", 15: "cyc_dedup_probe",
    16: "cyc_dedup_match_votes",
}
SLOTS = 24

#: (line of the source, what goes after it)
LAPS = [
    ("namespace {\n",
     "__device__ long long* g_diag;\n#define LAP(i) { long long _t = "
     "clock64(); dg[i] += _t - t_mark; t_mark = _t; }\n"),
    ("  extern __shared__ uint32_t smem[];\n",
     f"  long long dg[{SLOTS}] = {{0}}; const long long t_begin = clock64(); "
     "long long t_mark = t_begin;\n"),
    ("    const int es = nx_es;\n", "    LAP(7); dg[0]++;\n"),
    ("    prefetch(nx_e);\n    __syncwarp();\n", "    LAP(1);\n"),
    ("    while (changed && !ovf && it < max_closure) {\n", "      dg[5]++;\n"),
    ("      for (int q0 = 0; q0 < npairs && !ovf; q0 += 64) {\n",
     "        dg[3]++;\n"),
    ("        staged += __popc(ba) + __popc(bb);\n        __syncwarp();\n",
     "        LAP(13);\n"),
    ("          const uint32_t ent = table[pos];\n", "          dg[8]++;\n"),
    ("      // the lowest lane of equal fresh candidates survives\n",
     "      LAP(15);\n"),
    ("      const int tot = __popc(sb);\n", "      LAP(16);\n"),
    ("      head += m;\n      staged -= m;\n      __syncwarp();\n",
     "      dg[6]++; dg[2] += tot; LAP(14);\n"),
    ("    // stopping at the cap while still growing is a truncated closure\n",
     "    LAP(4);\n"),
    ("    epoch = next;\n", "    LAP(9);\n"),
    ("  if (row < B && lane == 0) {\n",
     "    unsigned smid; asm(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    dg[10] = clock64() - t_begin; dg[11] = smid; dg[12] = n;\n"
     f"    for (int i = 0; i < {SLOTS}; ++i) g_diag[row * {SLOTS} + i] = "
     "dg[i];\n"),
]


def instrumented() -> Path:
    """The checkout's source with the laps, written under ``build/ab/``."""
    src = SOURCE.read_text()
    for line, add in LAPS:
        if src.count(line) < 1:
            raise RuntimeError(f"no line {line!r} in {SOURCE.name}")
        src = src.replace(line, line + add, 1)
    src += ('\nextern "C" int diag_set(void* p) {\n'
            '  return (int)cudaMemcpyToSymbol(g_diag, &p, sizeof(p));\n}\n')
    AB_DIR.mkdir(parents=True, exist_ok=True)
    out = AB_DIR / "frontier_diag.cu"
    out.write_text(src)
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs

    path = build(instrumented(), "frontier_diag")
    run = launcher(path)
    lib = ctypes.CDLL(str(path))
    lib.diag_set.argtypes = [ctypes.c_void_p]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    arrays = cs.encoded(cs.slice_histories(45200, cs.FRONTIER_HISTORIES),
                        slot_cap=32)
    B, _, C = arrays[2].shape
    call = (cs.to_device(arrays, device), "cas-register", 128, C + 1)
    buf = torch.zeros((B * SLOTS,), dtype=torch.int64, device=device)
    if lib.diag_set(buf.data_ptr()) != 0:
        raise RuntimeError("diag_set failed")
    ms = turn_ms(run, call)
    buf.zero_()
    run(*call)
    torch.cuda.synchronize()
    g = buf.view(B, SLOTS).cpu().numpy()
    total = g[:, 10]
    order = np.argsort(total)
    print(json.dumps({"rows": int(B), "C": int(C), "F": 128, "ms": ms,
                      "cycles_percentiles": {
                          str(p): float(np.percentile(total, p))
                          for p in (0, 50, 90, 99, 100)},
                      "histories_per_sm_max": int(np.bincount(g[:, 11]).max()),
                      "card": card}), flush=True)
    for label, rows in (("all", slice(None)), ("slowest8", order[-8:]),
                        ("faster_half", order[:B // 2])):
        print(json.dumps({"mean_of": label, **{
            v: float(g[rows, k].mean()) for k, v in NAMES.items()}}),
              flush=True)
    top = int(order[-1])
    print(json.dumps({"slowest_row": top, **{
        v: int(g[top, k]) for k, v in NAMES.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
