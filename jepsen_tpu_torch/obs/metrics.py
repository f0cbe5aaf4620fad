"""Dependency-free metrics: counters, gauges, fixed-bucket histograms — a
copy of :mod:`jepsen_tpu.obs.metrics`, with the reference's
``JEPSEN_TPU_OBS_MAX_SERIES`` variable turned into the ``max_series``
argument of :class:`MetricsRegistry` (same default).

The registry is the numeric half of the observability layer
(jepsen_tpu_torch.obs): spans answer "where did the time go", these answer
"how many / how big".  Everything is plain Python + threading — no
prometheus_client, no opentelemetry — so the port needs nothing beyond
its own dependencies.  The export format IS the Prometheus
text exposition format (rendered by :func:`MetricsRegistry.prometheus_text`),
so a real scrape endpoint or push gateway could consume the dump
unchanged.

Instruments are keyed by (name, sorted label items): the registry
interns one instrument per key, so hot paths can resolve once and call
``inc``/``observe`` repeatedly — but only WITHIN one run:
``MetricsRegistry.reset()`` (invoked via ``obs.enable(reset=True)``)
discards the intern table, so a handle cached
across runs mutates an orphan no export will ever see.  Resolve per
run (or per worker loop), never at module import.  Every mutator takes
the instrument lock — increments are a few hundred ns, far below the
op latencies they count — and checks the shared enabled flag first, so
a disabled registry costs one attribute read + branch per call.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: Default histogram bucket upper bounds, in seconds — spans the range
#: from a sub-ms kernel execute to a multi-minute compile/SSH install.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

#: Sliding-window geometry: a ring of fixed slots per instrument lets a
#: long-lived daemon answer "last 60 s" without unbounded history.
SLOT_SECONDS = 10
WINDOW_SLOTS = 6  # 6 × 10 s = the 1-minute window behind *_rate1m

#: series-cardinality cap (per metric name): overflow label sets fold
#: into one {overflow="1"} series instead of growing the registry
DEFAULT_MAX_SERIES = 512
OVERFLOW_LABELS: "LabelKey" = (("overflow", "1"),)
SERIES_DROPPED = "jepsen_obs_series_dropped_total"

#: window clock — module-level so tests can monkeypatch slot rollover
_now = time.monotonic

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))



def rate1m_name(name: str) -> str:
    """Synthesized 1-minute-rate gauge name for a counter/histogram
    family: strip the unit suffix (``_total``/``_seconds``), append
    ``_rate1m``."""
    for suf in ("_total", "_seconds"):
        if name.endswith(suf):
            name = name[: -len(suf)]
            break
    return name + "_rate1m"


class _Instrument:
    __slots__ = ("name", "labels", "_lock", "_registry")

    def __init__(self, registry: "MetricsRegistry", name: str, labels: LabelKey):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._registry = registry


class _SlotRing:
    """Fixed ring of time slots accumulating (count, sum) deltas.

    Not self-locking: the owning instrument mutates/reads it under its
    own ``_lock`` (the ring is part of that instrument's state)."""

    __slots__ = ("ids", "counts", "sums")

    def __init__(self):
        self.ids = [-1] * WINDOW_SLOTS
        self.counts = [0] * WINDOW_SLOTS
        self.sums = [0.0] * WINDOW_SLOTS

    def add(self, n: int, v: float) -> None:
        slot = int(_now() // SLOT_SECONDS)
        i = slot % WINDOW_SLOTS
        if self.ids[i] != slot:  # ring wrapped: this slot is stale
            self.ids[i] = slot
            self.counts[i] = 0
            self.sums[i] = 0.0
        self.counts[i] += n
        self.sums[i] += v

    def totals(self) -> Tuple[int, float]:
        """(count, sum) over the live window — current partial slot
        plus the WINDOW_SLOTS-1 full slots behind it."""
        lo = int(_now() // SLOT_SECONDS) - WINDOW_SLOTS + 1
        n, s = 0, 0.0
        for i in range(WINDOW_SLOTS):
            if self.ids[i] >= lo:
                n += self.counts[i]
                s += self.sums[i]
        return n, s


class Counter(_Instrument):
    __slots__ = ("value", "_win")

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self.value = 0  # jt: guarded-by(_lock)
        self._win = _SlotRing()  # jt: guarded-by(_lock)

    def inc(self, n: int = 1) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self.value += n
            self._win.add(n, float(n))

    def window_sum(self) -> int:
        """Increments landed in the last WINDOW_SLOTS×SLOT_SECONDS."""
        with self._lock:
            return self._win.totals()[0]


class Gauge(_Instrument):
    __slots__ = ("value",)

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self.value = 0.0  # jt: guarded-by(_lock)

    def set(self, v: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self.value = v

    def set_max(self, v: float) -> None:
        """Record a high-water mark: keep the larger of current/new."""
        if not self._registry.enabled:
            return
        with self._lock:
            if v > self.value:
                self.value = v


class Histogram(_Instrument):
    """Fixed-boundary histogram: per-bucket counts + sum + count.
    Buckets are cumulative at render time (Prometheus ``le`` semantics);
    internally each slot counts only its own interval so ``observe`` is
    one bisect + three increments."""

    __slots__ = ("buckets", "counts", "sum", "count", "_win")

    def __init__(self, registry, name, labels,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(registry, name, labels)
        self.buckets = tuple(buckets)  # immutable after init: no guard
        self.counts = [0] * (len(self.buckets) + 1)  # jt: guarded-by(_lock)
        self.sum = 0.0  # jt: guarded-by(_lock)
        self.count = 0  # jt: guarded-by(_lock)
        self._win = _SlotRing()  # jt: guarded-by(_lock)

    def observe(self, v: float) -> None:
        if not self._registry.enabled:
            return
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            self._win.add(1, v)

    def window_totals(self) -> Tuple[int, float]:
        """(observations, summed value) over the live window."""
        with self._lock:
            return self._win.totals()

    def cumulative(self) -> List[int]:
        """Per-``le`` cumulative counts (the Prometheus rendering)."""
        out, acc = [], 0
        with self._lock:
            for c in self.counts:
                acc += c
                out.append(acc)
        return out


class MetricsRegistry:
    """Process-wide instrument registry with Prometheus text export."""

    def __init__(self, enabled: bool = True,
                 max_series: int = DEFAULT_MAX_SERIES):
        self.enabled = enabled
        #: label sets per metric name before new ones fold into the
        #: {overflow="1"} series
        self.max_series = int(max_series)
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, str, LabelKey], _Instrument] = {}  # jt: guarded-by(_lock)
        self._series: Dict[Tuple[str, str], int] = {}  # jt: guarded-by(_lock)

    def _get(self, kind: str, cls, name: str, labels: Dict[str, str],
             **kw) -> _Instrument:
        key = (kind, name, _label_key(labels))
        # lock-free fast path: a GIL-atomic dict read; double-checked
        # under the lock below before any insert
        inst = self._instruments.get(key)  # jt: allow[lock-discipline]
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    fam = (kind, name)
                    n_series = self._series.get(fam, 0)
                    if (n_series >= self.max_series
                            and key[2] != OVERFLOW_LABELS
                            and name != SERIES_DROPPED):
                        # cardinality cap: fold this (and every later)
                        # novel label set into the overflow series so
                        # a long-lived daemon's registry stays bounded
                        inst = self._overflow_locked(kind, cls, name, **kw)
                    else:
                        inst = cls(self, name, key[2], **kw)
                        self._instruments[key] = inst
                        self._series[fam] = n_series + 1
        return inst

    # jt: holds(_lock)
    def _overflow_locked(self, kind: str, cls, name: str,
                         **kw) -> _Instrument:
        """Intern the {overflow="1"} series + bump the drop counter.
        Caller holds self._lock; instrument locks are leaves (they
        never take the registry lock), so nesting is safe."""
        okey = (kind, name, OVERFLOW_LABELS)
        inst = self._instruments.get(okey)
        if inst is None:
            inst = cls(self, name, OVERFLOW_LABELS, **kw)
            self._instruments[okey] = inst
        dkey = ("counter", SERIES_DROPPED, ())
        dropped = self._instruments.get(dkey)
        if dropped is None:
            dropped = Counter(self, SERIES_DROPPED, ())
            self._instruments[dkey] = dropped
            self._series[("counter", SERIES_DROPPED)] = 1
        dropped.inc()
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get("histogram", Histogram, name, labels,
                         buckets=buckets)

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()
            self._series.clear()

    # -- introspection ----------------------------------------------------

    def snapshot(self) -> List[dict]:
        """All instruments as plain dicts (stable name/label order) —
        the source for both the Prometheus dump and the run summary."""
        with self._lock:
            items = sorted(self._instruments.items())
        out = []
        for (kind, name, labels), inst in items:
            d = {"kind": kind, "name": name, "labels": dict(labels)}
            if kind == "histogram":
                # one lock acquisition for counts+sum+count: reading
                # them separately could interleave with a concurrent
                # observe and render a +Inf bucket SMALLER than the
                # last le bucket (invalid Prometheus exposition)
                with inst._lock:
                    counts = list(inst.counts)
                    d["sum"] = inst.sum
                    d["count"] = inst.count
                    wn, ws = inst._win.totals()
                cum, acc = [], 0
                for c in counts:
                    acc += c
                    cum.append(acc)
                d["buckets"] = list(zip(inst.buckets, cum))
                d["win_count"], d["win_sum"] = wn, ws
            else:
                d["value"] = inst.value
                if kind == "counter":
                    d["win_count"] = inst.window_sum()
            out.append(d)
        return out

    # -- windowed aggregation (the /status "live" numbers) ----------------

    def window_rate(self, name: str, kind: Optional[str] = None) -> float:
        """Per-second rate over the last minute, summed across every
        label set of ``name``: counter increments, or histogram
        observation counts."""
        total = 0
        with self._lock:
            insts = [(k[0], inst) for k, inst in self._instruments.items()
                     if k[1] == name and (kind is None or k[0] == kind)]
        for k, inst in insts:
            if k == "counter":
                total += inst.window_sum()
            elif k == "histogram":
                total += inst.window_totals()[0]
        return total / float(WINDOW_SLOTS * SLOT_SECONDS)

    def window_mean(self, name: str) -> Optional[float]:
        """Mean observed value over the last minute across every label
        set of histogram ``name`` (None when the window is empty)."""
        n, s = 0, 0.0
        with self._lock:
            insts = [inst for k, inst in self._instruments.items()
                     if k[1] == name and k[0] == "histogram"]
        for inst in insts:
            wn, ws = inst.window_totals()
            n += wn
            s += ws
        return (s / n) if n else None

    def window_seconds_sum(self, name: str) -> float:
        """Summed observed seconds over the last minute across every
        label set of histogram ``name`` — busy-fraction numerator."""
        s = 0.0
        with self._lock:
            insts = [inst for k, inst in self._instruments.items()
                     if k[1] == name and k[0] == "histogram"]
        for inst in insts:
            s += inst.window_totals()[1]
        return s

    def value(self, name: str, **labels) -> Optional[float]:
        """Read one counter/gauge value (None when never recorded)."""
        for kind in ("counter", "gauge"):
            # GIL-atomic dict read, same rationale as _get's fast path;
            # the value itself is read under the instrument's own lock
            # (the lock its guarded-by annotation names)
            inst = self._instruments.get(  # jt: allow[lock-discipline]
                (kind, name, _label_key(labels)))
            if inst is not None:
                with inst._lock:
                    return inst.value
        return None

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format (one TYPE line per
        metric family, samples with sorted labels)."""
        lines: List[str] = []
        seen_type: set = set()
        for d in self.snapshot():
            name, kind = d["name"], d["kind"]
            if name not in seen_type:
                lines.append(f"# TYPE {name} {kind}")
                seen_type.add(name)
            base_labels = d["labels"]
            if kind == "histogram":
                cum = d["buckets"]
                for le, c in cum:
                    lines.append(
                        _sample(name + "_bucket",
                                {**base_labels, "le": _fmt_le(le)}, c)
                    )
                lines.append(
                    _sample(name + "_bucket",
                            {**base_labels, "le": "+Inf"}, d["count"])
                )
                lines.append(_sample(name + "_sum", base_labels, d["sum"]))
                lines.append(_sample(name + "_count", base_labels, d["count"]))
            else:
                lines.append(_sample(name, base_labels, d["value"]))
        lines.extend(self._rate_lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def _rate_lines(self) -> List[str]:
        """Synthesized ``*_rate1m`` gauge families: last-minute
        per-second rates for every counter (increments/s) and histogram
        (observations/s), one sample per underlying label set."""
        window = float(WINDOW_SLOTS * SLOT_SECONDS)
        lines: List[str] = []
        seen_type: set = set()
        seen_sample: set = set()
        for d in self.snapshot():
            if "win_count" not in d:
                continue
            rname = rate1m_name(d["name"])
            lkey = tuple(sorted(d["labels"].items()))
            if (rname, lkey) in seen_sample:
                continue  # counter+histogram families folding to one name
            seen_sample.add((rname, lkey))
            if rname not in seen_type:
                lines.append(f"# TYPE {rname} gauge")
                seen_type.add(rname)
            lines.append(
                _sample(rname, d["labels"],
                        round(d["win_count"] / window, 6)))
        return lines


def _fmt_le(v: float) -> str:
    s = repr(float(v))
    return s[:-2] if s.endswith(".0") else s


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _sample(name: str, labels: Dict[str, str], value) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())
        )
        return f"{name}{{{body}}} {_fmt_num(value)}"
    return f"{name} {_fmt_num(value)}"


def _fmt_num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return repr(f) if f != int(f) else str(int(f))
