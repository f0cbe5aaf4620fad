"""Where the screen kernel's time goes, block by block, on one card.

    python3 scripts/cycles_diag.py

Copies the checkout's ``cycles_closure.cu`` into the git-ignored
``build/ab/`` with ``clock64`` laps added to the design-2 screen kernel
(thread 0 of each block times the step before the closure — packing a
filter plane, or packing Wn and Rs and building M —, each closure round
and the step after it, counts the rows each round runs, and writes them,
its SM
and its start and end on the global timer to a device buffer), builds it
with the port's flags, runs it in ``"fixed"`` mode on ``chip_smoke.py``'s
list-append stack (1024 rows, n 512, 6 filter masks, 2 walk queries) and
prints JSON lines: the kernel's ms with and without the laps (CUDA events,
median of 7), the blocks' concurrency over the kernel's span, and per
kind of plane (filter, walk query) the mean cycles of each step and
round and the rows each round runs.  Fails if the source no longer has a
line a lap goes after.  Needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

from dense_ab import AB_DIR, build, turn_ms
from cycles_ab import SOURCE, launcher

#: each block's 32 int64 slots in the device buffer
SLOTS = 32
PRE, POST, ROUND0, ROWS0, TOTAL, SM, KIND, START, END = (0, 1, 2, 12, 22, 23,
                                                         24, 26, 27)
MAX_ROUNDS = 10

#: (line of the source, what goes after it)
LAPS = [
    ("namespace {\n",
     "__device__ long long* g_diag;\n"
     f"__shared__ long long d_lap[{SLOTS}];\n"
     "__shared__ long long d_mark;\n"
     "__device__ __forceinline__ long long d_now() { long long t; asm "
     "volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); return t; }\n"
     "#define DLAP(i) if (threadIdx.x == 0) { long long _t = clock64(); "
     "d_lap[i] += _t - d_mark; d_mark = _t; }\n"),
    ("  const int b = blockIdx.x / planes, p = blockIdx.x % planes;\n",
     f"  if (threadIdx.x == 0) {{ for (int q = 0; q < {SLOTS}; ++q) "
     f"d_lap[q] = 0; d_lap[{START}] = d_now(); d_lap[{TOTAL}] = clock64(); "
     f"d_mark = d_lap[{TOTAL}]; d_lap[{KIND}] = p >= prof.F; }}\n"),
    ("  if (threadIdx.x == 0) st.next_row[1] = 0;\n  __syncthreads();\n",
     f"  DLAP({PRE});\n"),
    ("      if (run && g == 0) store_words<V>(nxt + i * W + off, acc);\n",
     "      if (lane == lead && run) "
     f"atomicAdd((unsigned long long*)&d_lap[{ROWS0 - 1} + t], 1ull);\n"),
    ("    const bool any = __syncthreads_or(changed);\n",
     f"    DLAP({ROUND0 - 1} + t);\n"),
    ("  if (rounds != nullptr && p == 0 && threadIdx.x == 0) "
     "rounds[b] = total;\n",
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) {\n"
     f"    DLAP({POST});\n"
     "    unsigned smid; asm(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     f"    d_lap[{TOTAL}] = clock64() - d_lap[{TOTAL}]; d_lap[{SM}] = smid; "
     f"d_lap[{END}] = d_now();\n"
     f"    for (int q = 0; q < {SLOTS}; ++q) "
     f"g_diag[(size_t)blockIdx.x * {SLOTS} + q] = d_lap[q];\n"
     "  }\n"),
]


def instrumented() -> Path:
    """The checkout's source with the laps, written under ``build/ab/``."""
    src = SOURCE.read_text()
    for line, add in LAPS:
        if src.count(line) != 1:
            raise RuntimeError(f"no single line {line!r} in {SOURCE.name}")
        src = src.replace(line, line + add, 1)
    src += ('\nextern "C" int diag_set(void* p) {\n'
            '  return (int)cudaMemcpyToSymbol(g_diag, &p, sizeof(p));\n}\n')
    AB_DIR.mkdir(parents=True, exist_ok=True)
    out = AB_DIR / "cycles_diag.cu"
    out.write_text(src)
    return out


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    rel, _ = cs.list_append_stack(cs.elle_histories("append", 47100))
    x = torch.from_numpy(rel).to(device)
    profile = (cs.ELLE_MASKS, cs.ELLE_NONADJ)
    call = (x, "fixed", profile)
    plain = launcher(build(SOURCE, "cycles_checkout"))
    path = build(instrumented(), "cycles_diag")
    run = launcher(path)
    lib = ctypes.CDLL(str(path))
    lib.diag_set.argtypes = [ctypes.c_void_p]
    planes = len(cs.ELLE_MASKS) + len(cs.ELLE_NONADJ)
    blocks = int(x.shape[0]) * planes
    buf = torch.zeros((blocks * SLOTS,), dtype=torch.int64, device=device)
    if lib.diag_set(buf.data_ptr()) != 0:
        raise RuntimeError("diag_set failed")
    ms_plain = turn_ms(plain, call)
    ms = turn_ms(run, call)
    buf.zero_()
    run(*call)
    torch.cuda.synchronize()
    g = buf.view(blocks, SLOTS).cpu().numpy()
    start, end = g[:, START], g[:, END]
    span = float(end.max() - start.min())
    # blocks running at each block start: how full the card stayed
    order = np.sort(start)
    running = np.searchsorted(order, start, side="right") - \
        np.searchsorted(np.sort(end), start, side="right")
    print(json.dumps({
        "rows": int(x.shape[0]), "n": int(x.shape[-1]), "blocks": blocks,
        "ms": ms_plain, "ms_with_laps": ms, "span_ms": span / 1e6,
        "mean_concurrent_blocks": float((end - start).sum() / span),
        "max_concurrent_blocks": int(running.max()),
        "blocks_per_sm_max": int(np.bincount(g[:, SM]).max()),
        "last_start_ms": float(start.max() - start.min()) / 1e6,
        "card": card}), flush=True)
    for kind, name in ((0, "filter"), (1, "walk query")):
        k = g[g[:, KIND] == kind]
        rounds = [int((k[:, ROUND0 + r] > 0).sum()) for r in range(MAX_ROUNDS)]
        print(json.dumps({
            "planes": name, "count": int(len(k)),
            "cycles_total": {str(p): float(np.percentile(k[:, TOTAL], p))
                             for p in (0, 50, 90, 100)},
            "mean_cycles_before_closure": float(k[:, PRE].mean()),
            "mean_cycles_after_closure": float(k[:, POST].mean()),
            "mean_cycles_by_round": [float(k[:, ROUND0 + r].mean())
                                     for r in range(MAX_ROUNDS) if rounds[r]],
            "mean_rows_by_round": [float(k[:, ROWS0 + r].mean())
                                   for r in range(MAX_ROUNDS) if rounds[r]],
            "planes_reaching_round": [c for c in rounds if c],
            "mean_block_us": float((k[:, END] - k[:, START]).mean()) / 1e3,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
