"""On-demand device profiling capture on ``torch.profiler`` — the port of
:mod:`jepsen_tpu.obs.profiling`.

One bounded window: start a ``torch.profiler`` trace (CPU activity, plus
CUDA activity when the device is a CUDA one), run the supplied work (or
sleep the window out), stop the trace, and sample each device's memory
high-water mark; then write a small loadable ``profile.json`` manifest
beside the raw trace directory.

The manifest carries the reference's keys (``v``, ``label``,
``requested_seconds``, ``wall_seconds``, ``idle``, ``trace``,
``memory``) and one more, ``kernels``: the summed device time, in
seconds, of every CUDA kernel the profiler saw in the window, by kernel
name (copies and memsets are left out), read from the profiler's own
events.  Their sum over ``wall_seconds`` is the device's busy share of
the window.

A profiler that cannot start (or stop) is recorded, not raised:
``trace`` is ``null`` and ``trace_error`` says why; the memory inventory
and the wall clock are still written.  Exceptions from ``work``
propagate after the trace is stopped and the manifest written.
``device`` resolves as the port's entry points do: None is the current
CUDA device (raising without CUDA), ``"cpu"`` profiles CPU activity only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import device as device_mod
from .. import obs

#: manifest filename inside every capture directory
MANIFEST = "profile.json"
#: hard cap on the idle capture window, seconds
MAX_SECONDS = 30.0
#: the Chrome trace inside the capture's ``trace/`` directory
TRACE_FILE = "trace.json"

#: device events that move or set memory rather than run a kernel
_MEMORY_EVENTS = ("Memcpy", "Memset")


def _memory_inventory(dev: torch.device) -> List[Dict[str, Any]]:
    """Per-device memory rows: every CUDA device's allocator peak and
    current bytes (``torch.cuda.max_memory_allocated`` /
    ``memory_allocated``) when CUDA is in use, else one CPU row with
    nulls (the host has no allocator high-water mark to read)."""
    if dev.type != "cuda":
        return [{"device": str(dev), "platform": "cpu",
                 "peak_bytes_in_use": None, "bytes_in_use": None}]
    out: List[Dict[str, Any]] = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        peak = int(stats.get("allocated_bytes.all.peak",
                             torch.cuda.max_memory_allocated(i)))
        name = f"cuda:{i}"
        out.append({
            "device": name,
            "platform": "gpu",
            "name": torch.cuda.get_device_name(i),
            "peak_bytes_in_use": peak,
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
        })
        obs.gauge_max("jepsen_device_hbm_peak_bytes", float(peak),
                      device=name)
    return out


def kernel_seconds(events) -> Dict[str, float]:
    """Summed device seconds per kernel name over profiler events (the
    ``FunctionEvent`` list of ``prof.events()``): each CUDA-device event
    that is not a copy or a memset, timed by its own interval."""
    out: Dict[str, float] = {}
    for evt in events:
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if evt.name.startswith(_MEMORY_EVENTS):
            continue
        us = evt.time_range.end - evt.time_range.start
        out[evt.name] = out.get(evt.name, 0.0) + us / 1e6
    return out


def capture(out_dir: str, seconds: float = 1.0, label: str = "",
            work: Optional[Callable[[], Any]] = None,
            device=None) -> Dict[str, Any]:
    """Run one bounded profiling window into ``out_dir``.

    With ``work`` the window lasts exactly as long as the work (on the
    card, until its device work has finished); idle captures sleep
    ``seconds`` (clamped to :data:`MAX_SECONDS`).  Returns the manifest
    dict (also written to ``profile.json``); the Chrome trace lands in
    ``out_dir/trace/trace.json``.  ``work`` exceptions propagate after
    the trace is stopped."""
    dev = device_mod.resolve(device)
    seconds = max(0.0, min(float(seconds), MAX_SECONDS))
    os.makedirs(out_dir, exist_ok=True)
    trace_dir = os.path.join(out_dir, "trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    error = None
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception as e:  # noqa: BLE001 — recorded in the manifest
        prof, error = None, repr(e)
    t0 = time.monotonic()
    try:
        if work is not None:
            work()
        else:
            time.sleep(seconds)
    finally:
        if dev.type == "cuda":
            # the window ends when its device work has: the profiler
            # flushes only what has finished
            torch.cuda.synchronize(dev)
        wall = time.monotonic() - t0
        kernels: Dict[str, float] = {}
        trace = None
        if prof is not None:
            try:
                prof.stop()
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
                kernels = kernel_seconds(prof.events())
                trace = "trace"
            except Exception as e:  # noqa: BLE001 — recorded below
                error = repr(e)
        manifest = {
            "v": 1,
            "label": str(label or ""),
            "requested_seconds": seconds,
            "wall_seconds": round(wall, 6),
            "idle": work is None,
            "trace": trace,
            "memory": _memory_inventory(dev),
            "kernels": kernels,
        }
        if error is not None:
            manifest["trace_error"] = error
        tmp = os.path.join(out_dir, MANIFEST + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, os.path.join(out_dir, MANIFEST))
        obs.count("jepsen_profile_captures_total")
    return manifest


def load_manifest(out_dir: str) -> Optional[Dict[str, Any]]:
    """Read a capture directory's manifest back, or None."""
    p = os.path.join(out_dir, MANIFEST)
    try:
        with open(p, "r", encoding="utf-8") as fh:
            loaded = json.load(fh)
    except (OSError, ValueError):
        return None
    return loaded if isinstance(loaded, dict) else None
