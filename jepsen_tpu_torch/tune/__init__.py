"""Auto-tuned dispatch — the port of :mod:`jepsen_tpu.tune`: an offline
tune pass (``python -m jepsen_tpu_torch.tune``) measures the attached
device and persists a calibration artifact; the engine's pinned
constants become calibration-aware lookups, with the pinned values as
the untuned fallback and an explicit argument above both.

- :mod:`.artifact` — the versioned ``calibration.json`` schema (keyed by
  device kind, device count and code fingerprint), load, validation and
  fallback, and the process-wide :func:`active` calibration every engine
  lookup consults.
- :mod:`.calibrate` — the sweep: coordinate descent over (closure mode,
  window, flush rows, row bucket) and the measured per-(kernel, E, C, F)
  cost table, every proposal gated by the per-device row caps.
"""

from .artifact import (  # noqa: F401
    Calibration,
    DEFAULT_PATH,
    PARAM_KEYS,
    SCHEMA_VERSION,
    active,
    build_artifact,
    code_fingerprint,
    device_key,
    load_calibration,
    reset_active,
    resolve_knob,
    resolved_path,
    save,
    set_active,
    use,
    validate,
)
from .calibrate import (  # noqa: F401
    PROFILES,
    journal_rows,
    proposal_within_budget,
    run_tune,
)


def retune_recommended() -> bool:
    """True when the drift sentinel (:mod:`jepsen_tpu_torch.obs.drift`)
    currently recommends re-running the tune pass: some journalled
    dispatch shape's measured cost has drifted past the sentinel's
    threshold from what the active calibration (or the analytic proxy)
    predicts.  Observation only: nothing acts on it automatically."""
    from ..obs import drift as obs_drift

    sentinel = obs_drift.active()
    if sentinel is None:
        return False
    return bool(sentinel.snapshot().get("retune_recommended"))
