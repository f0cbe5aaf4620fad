"""Cost-model **drift sentinel** — residual tracking over the dispatch
journal; the port of :mod:`jepsen_tpu.obs.drift`.

Every settled execute chunk that lands in the journal (:mod:`.journal`)
is also scored here, per dispatch shape ``(kernel, E, C, F)``, as the
ratio

    measured ``execute_s`` / predicted seconds

smoothed by a deterministic EWMA.  The prediction comes from the active
calibration (:mod:`jepsen_tpu_torch.tune.artifact`) when one is loaded,
so a ratio of 1.0 means "the table still tells the truth"; without one it
is the analytic footprint proxy ``planning.estimated_cost`` falls back
to, and the per-shape ratios are normalised by their cross-shape
**median** so the proxy's unknown scale cancels.

The drift **score** is the worst per-shape deviation (``max(ratio,
1/ratio)``) over shapes with at least ``min_samples`` observations;
shapes at or past the threshold are **stale**.  When the score first
crosses the threshold the sentinel records a retune recommendation — a
marker row in the journal (kernel ``drift-retune``) and a crossing
counter — and latches, so one sustained drift episode gives exactly one
recommendation.  The flag gauge tracks the current state.

The reference's ``JEPSEN_TPU_DRIFT_THRESHOLD`` is the ``threshold``
argument of :class:`DriftSentinel` and :func:`configure`.  Observation
only: nothing in the engine reads the score.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Tuple

from .. import obs
from . import journal as obs_journal

#: per-shape deviation at/past this flags the shape stale
DEFAULT_THRESHOLD = 2.0
#: EWMA smoothing weight for the newest ratio
DEFAULT_ALPHA = 0.3
#: observations a shape needs before it can flag or drive the score
DEFAULT_MIN_SAMPLES = 3
#: journal kernel name of the retune-recommendation marker row
MARKER_KERNEL = "drift-retune"

#: every reason :meth:`DriftSentinel.observe_row` may skip a row for
SKIP_REASONS = (
    "not-dict",     # row is not a mapping at all (damaged line)
    "marker",       # our own drift-retune marker row
    "no-shape",     # kernel/E/C/F/rows missing or non-numeric (old schema)
    "not-hit",      # compile rows: elapsed is compile_s, not steady-state
    "not-timed",    # execute_s absent or <= 0
    "no-estimate",  # predictor returned None/<=0 for this shape
    "bad-ratio",    # ratio not finite or <= 0
)


def analytic_proxy(kernel: str, E: int, C: int, F: int, rows: int) -> float:
    """The calibration-free footprint proxy — the arithmetic
    ``planning.estimated_cost`` falls back to, kept here so scoring never
    imports the engine.  Unitless; only ratios of it mean anything."""
    if kernel == "dense":
        return float(rows) * float(max(1, E))
    if kernel == "cycles":
        return float(rows) * float(E) * float(E) * float(max(1, F))
    if kernel == "frontier":
        words = max(1, -(-int(E) // 32))
        return float(rows) * float(max(1, F)) * float(C + 1) * float(words)
    return float(rows) * float(max(1, E))


def predicted_seconds(kernel: str, E: int, C: int, F: int,
                      rows: int) -> Tuple[Optional[float], str]:
    """Predicted cost for one dispatch shape → ``(value, source)``:
    ``"calibration"`` — seconds interpolated from the active artifact
    (absolute: 1.0 is truth); ``"proxy"`` — the analytic footprint
    (relative: needs median normalisation)."""
    try:
        from ..tune import artifact as _artifact
        cal = _artifact.active()
        if cal is not None:
            est = cal.cost(kernel, E, C, F, rows)
            if est is not None and est > 0.0:
                return float(est), "calibration"
    except Exception:  # noqa: BLE001 — scoring never raises
        pass
    proxy = analytic_proxy(kernel, E, C, F, rows)
    if proxy <= 0.0 or not math.isfinite(proxy):
        return None, "proxy"
    return proxy, "proxy"


class _ShapeState:
    __slots__ = ("ewma", "n", "source")

    def __init__(self) -> None:
        self.ewma = 0.0
        self.n = 0
        self.source = "proxy"


class DriftSentinel:
    """Residual tracker over journal rows.  Thread-safe: rows arrive from
    the executor's owner thread while snapshots may come from others."""

    def __init__(self, threshold: Optional[float] = None,
                 alpha: float = DEFAULT_ALPHA,
                 min_samples: int = DEFAULT_MIN_SAMPLES) -> None:
        self.threshold = float(DEFAULT_THRESHOLD if threshold is None
                               else threshold)
        self.alpha = float(alpha)
        self.min_samples = max(1, int(min_samples))
        self._lock = threading.Lock()
        # every field below is guarded by _lock
        self._shapes: Dict[Tuple[str, int, int, int], _ShapeState] = {}
        self._scored = 0
        self._skipped: Dict[str, int] = {}
        self._score = 1.0
        self._stale: List[Dict[str, Any]] = []
        self._above = False  # the crossing latch
        self._crossings = 0

    # ------------------------------------------------------------- score

    def _skip(self, reason: str) -> str:
        with self._lock:
            self._skipped[reason] = self._skipped.get(reason, 0) + 1
        obs.count("jepsen_drift_rows_skipped_total", reason=reason)
        return reason

    def observe_row(self, row: Any) -> Optional[str]:
        """Score one journal row.  Returns the skip reason, or None when
        the row was scored.  Never raises and never makes a NaN/inf
        ratio: old-schema rows, damaged lines and shapes the predictor
        cannot price all land in the skip counters."""
        reason = self._classify(row)
        if reason is not None:
            return self._skip(reason)
        kernel = str(row["kernel"])
        E, C, F = int(row["E"]), int(row["C"]), int(row["F"])
        measured = float(row["execute_s"])
        est, source = predicted_seconds(kernel, E, C, F, int(row["rows"]))
        if est is None or est <= 0.0:
            return self._skip("no-estimate")
        ratio = measured / est
        if not math.isfinite(ratio) or ratio <= 0.0:
            return self._skip("bad-ratio")
        with self._lock:
            st = self._shapes.setdefault((kernel, E, C, F), _ShapeState())
            if st.n == 0:
                st.ewma = ratio
            else:
                st.ewma = self.alpha * ratio + (1.0 - self.alpha) * st.ewma
            st.n += 1
            st.source = source
            self._scored += 1
            crossed, published = self._recompute_locked()
        obs.count("jepsen_drift_rows_scored_total")
        self._publish(published, crossed)
        if crossed:
            self._record_recommendation()
        return None

    @staticmethod
    def _classify(row: Any) -> Optional[str]:
        if not isinstance(row, dict):
            return "not-dict"
        if row.get("kernel") == MARKER_KERNEL:
            return "marker"
        try:
            kernel = str(row["kernel"])
            E, C, F = int(row["E"]), int(row["C"]), int(row["F"])
            rows_n = int(row["rows"])
        except (KeyError, TypeError, ValueError):
            return "no-shape"
        if not kernel or rows_n <= 0 or E < 0 or C < 0 or F < 0:
            return "no-shape"
        if row.get("cache") != "hit":
            return "not-hit"
        try:
            measured = float(row.get("execute_s") or 0.0)
        except (TypeError, ValueError):
            return "not-timed"
        if measured <= 0.0 or not math.isfinite(measured):
            return "not-timed"
        return None

    def _recompute_locked(self) -> Tuple[bool, Dict[str, Any]]:
        """Rebuild normalised deviations, the score and the stale list.
        Returns (crossed-now, gauge payload).  Caller holds ``_lock``."""
        proxy_ewmas = sorted(
            st.ewma for st in self._shapes.values() if st.source == "proxy")
        baseline = 1.0
        if proxy_ewmas:
            mid = len(proxy_ewmas) // 2
            if len(proxy_ewmas) % 2:
                baseline = proxy_ewmas[mid]
            else:
                baseline = 0.5 * (proxy_ewmas[mid - 1] + proxy_ewmas[mid])
            if baseline <= 0.0 or not math.isfinite(baseline):
                baseline = 1.0
        per_shape: List[Dict[str, Any]] = []
        score = 1.0
        stale: List[Dict[str, Any]] = []
        for (kernel, E, C, F), st in sorted(self._shapes.items()):
            nd = st.ewma if st.source == "calibration" else st.ewma / baseline
            if nd <= 0.0 or not math.isfinite(nd):
                nd = 1.0
            deviation = max(nd, 1.0 / nd)
            entry = {
                "kernel": kernel, "E": E, "C": C, "F": F,
                "ratio": round(nd, 4), "deviation": round(deviation, 4),
                "n": st.n, "source": st.source,
            }
            per_shape.append(entry)
            if st.n >= self.min_samples:
                score = max(score, deviation)
                if deviation >= self.threshold:
                    stale.append(entry)
        self._score = score
        self._stale = stale
        recommended = bool(stale)
        crossed = recommended and not self._above
        if crossed:
            self._crossings += 1
        self._above = recommended
        return crossed, {"per_shape": per_shape, "score": score,
                         "stale": len(stale), "recommended": recommended}

    def _publish(self, g: Dict[str, Any], crossed: bool) -> None:
        """Push the recomputed state to the metrics registry (outside
        ``_lock``: the registry has its own)."""
        for s in g["per_shape"]:
            obs.gauge_set("jepsen_drift_ratio", s["ratio"],
                          kernel=s["kernel"], E=s["E"], C=s["C"], F=s["F"])
        obs.gauge_set("jepsen_drift_score", round(g["score"], 4))
        obs.gauge_set("jepsen_drift_stale_shapes", g["stale"])
        obs.gauge_set("jepsen_drift_retune_recommended",
                      1.0 if g["recommended"] else 0.0)
        if crossed:
            obs.count("jepsen_drift_retune_crossings_total")

    def _record_recommendation(self) -> None:
        """Drop the retune-recommendation marker into the journal: a full
        v1 row (rows 0, nothing timed) that :meth:`observe_row` and
        ``tune.calibrate.journal_rows`` both skip."""
        if obs_journal.active() is None:
            return
        cal_id = ""
        try:
            from ..tune import artifact as _artifact
            cal = _artifact.active()
            if cal is not None:
                cal_id = str(cal.calibration_id)
        except Exception:  # noqa: BLE001 — the marker never raises
            cal_id = ""
        with self._lock:
            score = self._score
        obs_journal.emit(
            kernel=MARKER_KERNEL, E=0, C=0, F=0, rows=0, n_devices=0,
            mesh_shape=[], window=0, compile_s=0.0, execute_s=0.0,
            coalesced=0, cache="hit", closure_mode="", union="",
            calibration=cal_id, trace_id="drift-score=%.3f" % score,
        )

    # --------------------------------------------------------- read side

    def scan(self, path: Optional[str] = None) -> int:
        """Feed every readable row of a journal file (default: the process
        journal's) through :meth:`observe_row` — a warm start.  Returns
        the number of rows scored."""
        if path is None:
            path = obs_journal.path()
        if not path:
            return 0
        scored = 0
        try:
            for row in obs_journal.read_rows(path):
                if self.observe_row(row) is None:
                    scored += 1
        except OSError:
            return scored
        return scored

    def snapshot(self) -> Dict[str, Any]:
        """The sentinel's state as one plain dict."""
        with self._lock:
            _, g = self._recompute_locked() if self._shapes else (False, {
                "per_shape": [], "score": 1.0, "stale": 0,
                "recommended": False,
            })
            return {
                "score": round(g["score"], 4),
                "threshold": self.threshold,
                "shapes": len(self._shapes),
                "stale": [dict(s) for s in self._stale],
                "stale_shapes": g["stale"],
                "retune_recommended": g["recommended"],
                "crossings": self._crossings,
                "rows_scored": self._scored,
                "rows_skipped": dict(sorted(self._skipped.items())),
            }


# ----------------------------------------------------------- singleton

_active: Optional[DriftSentinel] = None
_lock = threading.Lock()


def configure(threshold: Optional[float] = None, *,
              alpha: float = DEFAULT_ALPHA,
              min_samples: int = DEFAULT_MIN_SAMPLES) -> DriftSentinel:
    """Install a fresh process sentinel, fed by every journalled
    dispatch (configure the journal beside it)."""
    global _active
    with _lock:
        _active = DriftSentinel(threshold=threshold, alpha=alpha,
                                min_samples=min_samples)
        return _active


def disable() -> None:
    global _active
    with _lock:
        _active = None


def active() -> Optional[DriftSentinel]:
    return _active
