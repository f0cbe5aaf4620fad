"""The calibration artifact: schema, persistence, and the process-wide
active calibration the engine's lookups consult — the port of
:mod:`jepsen_tpu.tune.artifact`.

A calibration is the durable output of one tune sweep
(:mod:`.calibrate`): the measured-best engine knobs (window, flush rows,
row-bucket floor, the Elle screens' closure mode) and a per-(kernel, E,
C, F) cost table, keyed by **device kind + device count + code
fingerprint** so an artifact tuned on one card (or one engine revision)
never steers another.  The engine loads it lazily at its first lookup
(:func:`active`) and falls back to the pinned defaults — with a warning
and a ``jepsen_engine_calibration_fallback_total`` count — whenever the
file is missing, corrupt, version-mismatched or stale.  Verdicts never
depend on any of this: every knob only moves wall time.

The artifact names its package (``"package": "jepsen_tpu_torch"``) and
carries the port's own :data:`PARAM_KEYS`; the reference's carries two
params the port does not have.  So an artifact of either package fails
the other's :func:`validate` (a missing or an unknown param) and loads
as a warned fallback, never a crash.

Where the artifact comes from (the reference's ``JEPSEN_TPU_CALIBRATION``
variable is :func:`use` here):

- by default, ``calibration.json`` in the working directory (the tuner's
  default output), loaded only when it exists;
- ``use(path)`` — that file;
- ``use(None)`` — calibration disabled.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import obs

log = logging.getLogger("jepsen_tpu_torch.tune")

#: artifact schema version — loads refuse any other value
SCHEMA_VERSION = 1

#: the package an artifact belongs to
PACKAGE = "jepsen_tpu_torch"

#: default artifact filename (relative to the working directory)
DEFAULT_PATH = "calibration.json"

_ROOT = Path(__file__).resolve().parents[1]

#: the engine files whose constants a calibration replaces — the code
#: fingerprint hashes exactly these and the kernel sources, so editing
#: any of them stales every artifact (the knobs' meaning, or every cost,
#: may have moved)
_FINGERPRINT_FILES = (
    "engine/execution.py",
    "engine/planning.py",
    "elle/encode.py",
    "ops/cycles.py",
    "ops/dense.py",
    "ops/wgl.py",
)

#: params every artifact carries, no more and no fewer.  The reference's
#: ``union_mode`` and ``closure_impl`` choose lowerings the port does not
#: carry.
PARAM_KEYS = ("window", "flush_rows", "row_bucket", "closure_mode")

_VALID_CLOSURES = ("fixed", "earlyexit")


def code_fingerprint() -> str:
    """SHA-1 over the engine sources whose pinned constants the
    calibration replaces and over every CUDA source under ``ops/csrc/``
    (a kernel redesign moves every cost): an artifact is trusted only
    against the exact code it was measured on."""
    paths = [_ROOT / rel for rel in _FINGERPRINT_FILES]
    paths += sorted((_ROOT / "ops" / "csrc").glob("*.cu"))
    h = hashlib.sha1()
    for p in paths:
        try:
            h.update(p.read_bytes())
        except OSError:
            h.update(b"?")
        h.update(b"\x1f")
    return h.hexdigest()


def device_key(device=None) -> Tuple[str, int]:
    """(device kind, device count) of ``device`` — the hardware half of
    the artifact key: ``(torch.cuda.get_device_name, device_count)`` on
    CUDA, ``("cpu", 1)`` when the caller passes ``device="cpu"``.  None is
    the current CUDA device and raises without CUDA, as every entry point
    of the port does."""
    import torch

    from .. import device as device_mod

    dev = device_mod.resolve(device)
    if dev.type == "cpu":
        return "cpu", 1
    return str(torch.cuda.get_device_name(dev)), int(torch.cuda.device_count())


class Calibration:
    """One validated calibration artifact: the engine-facing lookups
    :meth:`window`, :meth:`flush_rows`, :meth:`row_bucket`,
    :meth:`closure_mode` and the interpolating :meth:`cost` table."""

    def __init__(self, data: Dict[str, Any]):
        self.data = data
        self.calibration_id: str = data["calibration_id"]
        self.device_kind: str = data["device_kind"]
        self.n_devices: int = int(data["n_devices"])
        self.code_fingerprint: str = data["code_fingerprint"]
        p = data["params"]
        self.params: Dict[str, Any] = {k: p[k] for k in PARAM_KEYS}
        #: (kernel, E, C, F) -> sorted [(rows, seconds), ...]
        self._table: Dict[Tuple[str, int, int, int],
                          List[Tuple[int, float]]] = {}
        for e in data.get("cost_table", ()):
            k = (str(e["kernel"]), int(e["E"]), int(e["C"]), int(e["F"]))
            self._table.setdefault(k, []).append(
                (int(e["rows"]), float(e["seconds"])))
        for pts in self._table.values():
            pts.sort()

    # -- engine-facing lookups --------------------------------------------

    def window(self) -> int:
        return int(self.params["window"])

    def flush_rows(self) -> int:
        return int(self.params["flush_rows"])

    def row_bucket(self) -> int:
        return int(self.params["row_bucket"])

    def closure_mode(self) -> str:
        return str(self.params["closure_mode"])

    def has_cost_table(self) -> bool:
        return bool(self._table)

    def cost(self, kernel: str, E: int, C: int, F: int,
             rows: int) -> Optional[float]:
        """Predicted device seconds for one ``rows``-row dispatch of
        ``kernel`` at shape (E, C, F) — the measured replacement for
        ``planning.estimated_cost``'s analytic proxy.  A measured shape
        interpolates piecewise-linearly in rows (through the origin below
        its first sample); an unmeasured shape scales the nearest measured
        shape (log-space distance) by the analytic footprint ratio — across
        kernels when the table never measured this one, so every bucket a
        sort compares is in seconds.  None only when the table is empty."""
        key = (kernel, int(E), int(C), int(F))
        pts = self._table.get(key)
        if pts is not None:
            return _interp_rows(pts, rows)
        pts, ref_key = self._nearest(kernel, E, C, F)
        if pts is None:  # no entry of this kernel: the nearest of any
            pts, ref_key = self._nearest(None, E, C, F)
            if pts is None:
                return None
        scale = _proxy(kernel, E, C, F) / max(
            _proxy(ref_key[0], *ref_key[1:]), 1e-12)
        return scale * _interp_rows(pts, rows)

    def _nearest(self, kernel: Optional[str], E: int, C: int, F: int):
        """Closest measured shape by log-space distance; ``kernel=None``
        searches every kernel's entries."""
        best = None
        best_d = None
        for key in self._table:
            if kernel is not None and key[0] != kernel:
                continue
            d = sum((math.log2(max(a, 1)) - math.log2(max(b, 1))) ** 2
                    for a, b in zip(key[1:], (E, C, F)))
            if best_d is None or d < best_d:
                best, best_d = key, d
        if best is None:
            return None, None
        return self._table[best], best

    # -- matching ----------------------------------------------------------

    def stale_reason(self, device=None) -> Optional[str]:
        """None when this artifact matches ``device`` (:func:`device_key`)
        and the current code; else a short human reason."""
        if self.code_fingerprint != code_fingerprint():
            return "code-fingerprint mismatch (engine sources changed)"
        kind, n = device_key(device)
        if self.device_kind != kind or self.n_devices != n:
            return (f"device mismatch (tuned on {self.device_kind}"
                    f"×{self.n_devices}, attached {kind}×{n})")
        return None


def _proxy(kernel: str, E: int, C: int, F: int) -> float:
    """The analytic per-row footprint proxy (the form of
    ``planning.estimated_cost``'s fallback), used only to scale a measured
    neighbour onto an unmeasured shape."""
    if kernel == "dense":
        return float(max(E, 1))
    if kernel == "cycles":
        # the Elle screens' closure: E the vertex bucket, F the plane
        # weight; per-row work scales with F planes of E×E squaring
        return float(max(E, 1)) * max(E, 1) * max(F, 1)
    words = max(1, -(-max(E, 1) // 32))
    return float(max(F, 1) * (max(C, 0) + 1) * words)


def _interp_rows(pts: List[Tuple[int, float]], rows: int) -> float:
    """Piecewise-linear seconds(rows) through measured points; linear
    through the origin below the first sample, the last segment's slope
    above the last."""
    if rows <= 0:
        return 0.0
    if len(pts) == 1 or rows <= pts[0][0]:
        r0, s0 = pts[0]
        return s0 * rows / max(r0, 1)
    for (r0, s0), (r1, s1) in zip(pts, pts[1:]):
        if rows <= r1:
            t = (rows - r0) / max(r1 - r0, 1)
            return s0 + t * (s1 - s0)
    (r0, s0), (r1, s1) = pts[-2], pts[-1]
    slope = (s1 - s0) / max(r1 - r0, 1)
    return max(0.0, s1 + slope * (rows - r1))


# -- schema validation / persistence ----------------------------------------


def validate(data: Any) -> Dict[str, Any]:
    """Structural check of a raw artifact dict; raises ValueError with a
    reason on any problem (the load path turns that into a warned
    fallback, never a crash)."""
    if not isinstance(data, dict):
        raise ValueError("artifact is not a JSON object")
    if data.get("version") != SCHEMA_VERSION:
        raise ValueError(
            f"schema version {data.get('version')!r} != {SCHEMA_VERSION}")
    for k in ("calibration_id", "device_kind", "n_devices",
              "code_fingerprint", "params"):
        if k not in data:
            raise ValueError(f"missing field {k!r}")
    p = data["params"]
    if not isinstance(p, dict):
        raise ValueError("params is not an object")
    for k in PARAM_KEYS:
        if k not in p:
            raise ValueError(f"missing param {k!r}")
    for k in p:
        if k not in PARAM_KEYS:
            raise ValueError(f"unknown param {k!r} (not a knob of "
                             f"{PACKAGE})")
    if data.get("package") != PACKAGE:
        raise ValueError(f"artifact of {data.get('package')!r}, not of "
                         f"{PACKAGE}")
    if int(p["window"]) < 1:
        raise ValueError("window must be >= 1")
    if int(p["flush_rows"]) < 1:
        raise ValueError("flush_rows must be >= 1")
    rb = int(p["row_bucket"])
    if rb < 1 or rb & (rb - 1):
        raise ValueError("row_bucket must be a power of two")
    if p["closure_mode"] not in _VALID_CLOSURES:
        raise ValueError(f"unknown closure_mode {p['closure_mode']!r}")
    for e in data.get("cost_table", ()):
        for k in ("kernel", "E", "C", "F", "rows", "seconds"):
            if k not in e:
                raise ValueError(f"cost_table entry missing {k!r}")
        if float(e["seconds"]) < 0:
            raise ValueError("negative cost_table seconds")
    return data


def build_artifact(params: Dict[str, Any], cost_table: List[dict],
                   device_kind: str, n_devices: int,
                   created_at: str, sweep: Optional[dict] = None) -> dict:
    """Assemble a schema-valid artifact dict (the tuner's output)."""
    fp = code_fingerprint()
    data = {
        "version": SCHEMA_VERSION,
        "package": PACKAGE,
        "calibration_id": (f"{device_kind.replace(' ', '-').lower()}"
                           f"x{n_devices}-{fp[:10]}"),
        "created_at": created_at,
        "device_kind": device_kind,
        "n_devices": int(n_devices),
        "code_fingerprint": fp,
        "params": {k: params[k] for k in PARAM_KEYS},
        "cost_table": list(cost_table),
    }
    if sweep is not None:
        data["sweep"] = sweep
    return validate(data)


def save(data: dict, path: str) -> str:
    validate(data)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_calibration(path: str, check_stale: bool = True,
                     device=None) -> Optional[Calibration]:
    """Load and validate one artifact file, checked against ``device``
    (:func:`device_key`); None — with a logged warning and a
    ``jepsen_engine_calibration_fallback_total`` count — on ANY problem:
    a bad artifact degrades to the pinned defaults, never crashes or
    skews a run."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        log.warning("calibration %s unreadable (%s); using pinned engine "
                    "defaults", path, e)
        obs.count("jepsen_engine_calibration_fallback_total",
                  reason="unreadable")
        return None
    try:
        cal = Calibration(validate(data))
    except (ValueError, KeyError, TypeError) as e:
        log.warning("calibration %s invalid (%s); using pinned engine "
                    "defaults", path, e)
        obs.count("jepsen_engine_calibration_fallback_total",
                  reason="invalid")
        return None
    if check_stale:
        try:
            reason = cal.stale_reason(device)
        except Exception as e:  # noqa: BLE001 — no device to vet against
            # must not take the engine down just to vet a calibration
            reason = f"device probe failed ({e!r})"
        if reason is not None:
            log.warning("calibration %s stale: %s; using pinned engine "
                        "defaults", path, reason)
            obs.count("jepsen_engine_calibration_fallback_total",
                      reason="stale")
            return None
    return cal


# -- the process-wide active calibration -------------------------------------

_lock = threading.Lock()
_UNRESOLVED = object()
_DEFAULT = object()
_active: Any = _UNRESOLVED
#: where the artifact comes from: _DEFAULT (the working directory's
#: calibration.json, when it exists), a path, or None (disabled)
_source: Any = _DEFAULT
#: the device an artifact is vetted against (None: the current CUDA one)
_device: Any = None


def resolved_path() -> Optional[str]:
    """The artifact path :func:`active` loads, or None when calibration
    is disabled or no default file exists."""
    src = _source
    if src is _DEFAULT:
        return DEFAULT_PATH if os.path.exists(DEFAULT_PATH) else None
    return src


def active() -> Optional[Calibration]:
    """The process's active calibration, resolved lazily ONCE
    (:func:`resolved_path`); None when disabled, absent or rejected.
    Every engine lookup consults it: the no-artifact path costs one
    ``os.path.exists`` at the first lookup."""
    global _active
    got = _active  # resolved once, under _lock
    if got is not _UNRESOLVED:
        return got
    with _lock:
        if _active is _UNRESOLVED:
            path = resolved_path()
            cal = load_calibration(path, device=_device) if path else None
            if cal is not None:
                log.info("calibration %s active (from %s)",
                         cal.calibration_id, path)
                obs.gauge_set("jepsen_engine_calibration_loaded", 1)
            _active = cal
        return _active


def use(path: Optional[str], device=None) -> None:
    """Load the active calibration from ``path`` at the next lookup,
    vetted against ``device`` (None: the current CUDA device); ``None``
    disables calibration.  Replaces the reference's
    ``JEPSEN_TPU_CALIBRATION=<path>`` (and ``=0``)."""
    global _active, _source, _device
    with _lock:
        _source, _device, _active = path, device, _UNRESOLVED


def resolve_knob(arg, cal_get: Callable[[Calibration], Any], default):
    """The ONE argument > calibration > pinned-default ladder every
    calibrated engine knob resolves through (window, flush rows,
    row-bucket floor, closure mode): ``arg`` when the caller passed one
    (not None), else ``cal_get`` of the active :class:`Calibration`, else
    ``default``."""
    if arg is not None:
        return arg
    cal = active()
    if cal is not None:
        return cal_get(cal)
    return default


def set_active(cal: Optional[Calibration]) -> None:
    """Pin the active calibration (tests; the tuner after a fresh write).
    ``None`` means "resolved: no calibration"."""
    global _active
    with _lock:
        _active = cal


def reset_active() -> None:
    """Back to the default source (the working directory's
    ``calibration.json``), resolved afresh at the next lookup."""
    global _active, _source, _device
    with _lock:
        _source, _device, _active = _DEFAULT, None, _UNRESOLVED
