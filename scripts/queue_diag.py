"""Where the queue automaton's kernel (K2) spends its time, history by
history, on one card.

    python3 scripts/queue_diag.py

Copies the checkout's ``dense_automaton.cu`` into the git-ignored
``build/ab/`` with ``clock64`` laps added to ``dense_queue_kernel`` (each
history's lane 0 sums the cycles of each phase of an event: the loop's
head and the padding skips, the regroup with the wait for the event's
loads, the masks, the enqueue sweep, the dequeue sweep, completion and
the prefix update; and counts the events its warp worked), builds it with
the port's flags, runs it on ``chip_smoke.py`` phase 18's flagship (16384
rows, E 64, C 8) and prints JSON lines: the kernel's ms (CUDA events,
median of 7), the spread of per-history cycles, the histories an SM held,
and the mean of every counter over all histories, over the 8 slowest and
over the faster half.  Fails if the source no longer has a line a lap
goes after.  Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from dense_ab import AB_DIR, build, queue_launcher, turn_ms

from jepsen_tpu_torch.ops import _build

SOURCE = _build.SOURCES["dense_automaton"]

#: counter slots, each history's 12 int64 in the device buffer
NAMES = {
    0: "cyc_head", 1: "cyc_regroup", 2: "cyc_masks", 3: "cyc_enqueue_sweep",
    4: "cyc_dequeue_sweep", 5: "cyc_completion", 6: "events",
    7: "cyc_total",
}
SLOTS = 12

#: (line of the kernel's source, what goes after it); the first one is
#: searched in the whole file, the others after it
HEAD = ("namespace {\n",
        "__device__ long long* g_diag;\n#define LAP(i) { long long _t = "
        "clock64(); dg[i] += _t - t_mark; t_mark = _t; }\n")
LAPS = [
    ("  const uint32_t group =\n"
     "      Sh::G == 32 ? kFull : ((1u << Sh::G) - 1u) << (lane & ~(Sh::G - 1));"
     "\n",
     f"  long long dg[{SLOTS}] = {{0}}; const long long t_begin = clock64(); "
     "long long t_mark = t_begin;\n"),
    ("    if (!__any_sync(kFull, active)) continue;\n",
     "    LAP(0); dg[6]++;\n"),
    ("    queue_regroup<LOG_W>(cur, active, C, enq_c, deq_c, lane, gl, sc, sl);\n",
     "    LAP(1);\n"),
    ("    // sweep each (the fixpoint, as argued above)\n", "    LAP(2);\n"),
    ("                                __reduce_or_sync(kFull, sl.enq), gl);\n",
     "    LAP(3);\n"),
    ("    queue_sweep<LOG_W, 0, false>(D, valid, sl.enq, sl.live_deq, gl);\n",
     "    LAP(4);\n"),
    ("      if ((sl.comp & 3u) == 2u) deq_c |= bit;\n    }\n",
     "    LAP(5);\n"),
    ("  if (live_row && gl == 0) {\n",
     "    unsigned smid; asm(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    dg[7] = clock64() - t_begin; dg[8] = smid;\n"
     f"    for (int i = 0; i < {SLOTS}; ++i) g_diag[row * {SLOTS} + i] = "
     "dg[i];\n"),
]


def instrumented() -> Path:
    """The checkout's source with the laps, written under ``build/ab/``."""
    src = SOURCE.read_text()
    src = src.replace(HEAD[0], HEAD[0] + HEAD[1], 1)
    at = src.index("__global__ void __launch_bounds__(kWarpsPerBlock * 32) "
                   "dense_queue_kernel(")
    head, kernel = src[:at], src[at:]
    for line, add in LAPS:
        if kernel.count(line) < 1:
            raise RuntimeError(f"no line {line!r} in the queue kernel")
        kernel = kernel.replace(line, line + add, 1)
    src = head + kernel + (
        '\nextern "C" int diag_set(void* p) {\n'
        '  return (int)cudaMemcpyToSymbol(g_diag, &p, sizeof(p));\n}\n')
    AB_DIR.mkdir(parents=True, exist_ok=True)
    out = AB_DIR / "queue_diag.cu"
    out.write_text(src)
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs

    path = build(instrumented(), "queue_diag")
    run = queue_launcher(path)
    lib = ctypes.CDLL(str(path))
    lib.diag_set.argtypes = [ctypes.c_void_p]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    arrays, _ = cs.queue_flagship()
    B, E, C = arrays[2].shape
    call = (cs.to_device(arrays, device),)
    buf = torch.zeros((B * SLOTS,), dtype=torch.int64, device=device)
    if lib.diag_set(buf.data_ptr()) != 0:
        raise RuntimeError("diag_set failed")
    ms = turn_ms(run, call)
    buf.zero_()
    run(*call)
    torch.cuda.synchronize()
    g = buf.view(B, SLOTS).cpu().numpy()
    total = g[:, 7]
    order = np.argsort(total)
    print(json.dumps({"rows": int(B), "E": int(E), "C": int(C), "ms": ms,
                      "cycles_percentiles": {
                          str(p): float(np.percentile(total, p))
                          for p in (0, 50, 90, 99, 100)},
                      "histories_per_sm_max": int(np.bincount(g[:, 8]).max()),
                      "card": card}), flush=True)
    for label, rows in (("all", slice(None)), ("slowest8", order[-8:]),
                        ("faster_half", order[:B // 2])):
        print(json.dumps({"mean_of": label, **{
            v: float(g[rows, k].mean()) for k, v in NAMES.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
