"""Consistency models → proscribed anomalies, and verdict shaping.

A small lattice in the spirit of Elle's elle.consistency-model
(consumed transitively by the reference at
jepsen/src/jepsen/tests/cycle/wr.clj:33-47, whose docstring enumerates
these same anomaly names).  The port's copy of
:mod:`jepsen_tpu.elle.consistency`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

#: Anomalies each model proscribes.  Weaker models inherit into stronger
#: ones below.
_BASE: Dict[str, Set[str]] = {
    "read-uncommitted": {"G0", "dirty-update", "duplicate-elements",
                         "incompatible-order"},
    "read-committed": {"G1a", "G1b", "G1c", "internal"},
    "repeatable-read": {"G2-item", "lost-update"},
    "snapshot-isolation": {"G-single", "G-nonadjacent", "lost-update"},
    "serializable": {"G-single", "G-nonadjacent", "G2-item"},
    "strict-serializable": {
        "G0-realtime", "G1c-realtime", "G-single-realtime",
        "G-nonadjacent-realtime", "G2-item-realtime",
    },
    "sequential": {
        "G0-process", "G1c-process", "G-single-process",
        "G-nonadjacent-process", "G2-item-process",
    },
}

#: What each model implies (transitively expanded at lookup).
_IMPLIES: Dict[str, Sequence[str]] = {
    "read-committed": ("read-uncommitted",),
    "repeatable-read": ("read-committed",),
    "snapshot-isolation": ("read-committed",),
    "serializable": ("repeatable-read", "snapshot-isolation"),
    "sequential": ("serializable",),
    "strict-serializable": ("serializable", "sequential"),
}

KNOWN_MODELS = sorted(_BASE)

#: Cycle anomalies implied by others (a G0 is also a G1c profile etc.) —
#: used only for reporting, not detection.
SEVERITY = [
    "G0", "G1c", "G-single", "G-nonadjacent", "G2-item",
    "G0-process", "G1c-process", "G-single-process",
    "G-nonadjacent-process", "G2-item-process",
    "G0-realtime", "G1c-realtime", "G-single-realtime",
    "G-nonadjacent-realtime", "G2-item-realtime",
    "G1a", "G1b", "lost-update", "dirty-update", "internal",
    "duplicate-elements", "incompatible-order",
]


def proscribed_for_model(model: str) -> Set[str]:
    if model not in _BASE:
        raise KeyError(f"unknown consistency model {model!r}; known: {KNOWN_MODELS}")
    out = set(_BASE[model])
    for dep in _IMPLIES.get(model, ()):
        out |= proscribed_for_model(dep)
    return out


def proscribed(opts: dict) -> Set[str]:
    """The set of anomaly names that invalidate this test, from opts:
    either explicit ``anomalies`` or ``consistency-models`` (default
    strict-serializable)."""
    out: Set[str] = set()
    for a in opts.get("anomalies", ()):
        if a == "G1":
            out |= {"G1a", "G1b", "G1c"}
        elif a == "G2":
            out |= {"G-single", "G-nonadjacent", "G2-item"}
        else:
            out.add(a)
    for m in opts.get("consistency-models") or (
        [] if opts.get("anomalies") else ["strict-serializable"]
    ):
        out |= proscribed_for_model(m)
    return out


#: classify() names each cycle by its most-specific profile, but a
#: specific profile is still an *instance* of the general ones — a
#: single-rw cycle is also a nonadjacent-rw cycle and an item
#: anti-dependency cycle.  A model proscribing the general name must
#: therefore reject the specific finding too (Elle's implied-anomalies).
_INSTANCE_OF: Dict[str, Sequence[str]] = {
    "G-single": ("G-nonadjacent", "G2-item"),
    "G-nonadjacent": ("G2-item",),
    "G-single-process": ("G-nonadjacent-process", "G2-item-process"),
    "G-nonadjacent-process": ("G2-item-process",),
    "G-single-realtime": ("G-nonadjacent-realtime", "G2-item-realtime"),
    "G-nonadjacent-realtime": ("G2-item-realtime",),
    "G0": ("G1c",),
    "G0-process": ("G1c-process",),
    "G0-realtime": ("G1c-realtime",),
}


def _proscribed_name(name: str, wanted: Set[str]) -> bool:
    return name in wanted or any(
        g in wanted for g in _INSTANCE_OF.get(name, ())
    )


def result(
    anomalies: Dict[str, list], wanted: Set[str], txn_count: int = 0
) -> dict:
    """Shape the final verdict: valid iff no *proscribed* anomaly was
    found; unproscribed findings are reported under also-anomalies."""
    bad = {k: v for k, v in anomalies.items() if _proscribed_name(k, wanted)}
    also = {k: v for k, v in anomalies.items() if k not in bad}
    out: dict = {
        "valid?": not bad,
        "txn-count": txn_count,
        "anomaly-types": sorted(bad, key=_severity_key),
        "anomalies": bad,
    }
    if also:
        out["also-anomaly-types"] = sorted(also, key=_severity_key)
        out["also-anomalies"] = also
    if out["valid?"] is True:
        # "-indeterminate" markers mean a bounded search gave up before
        # confirming or refuting the base anomaly (e.g. G-nonadjacent's
        # simple-cycle budget).  If the model proscribes that anomaly —
        # by exact name or any suffixed variant — a clean pass is not
        # provable: report unknown, never a false valid.
        for k in anomalies:
            if not k.endswith("-indeterminate"):
                continue
            base = k[: -len("-indeterminate")]
            if _proscribed_name(base, wanted) or any(
                w.startswith(base) for w in wanted
            ):
                out["valid?"] = "unknown"
                break
    return out


def _severity_key(name: str) -> int:
    try:
        return SEVERITY.index(name)
    except ValueError:
        return len(SEVERITY)
