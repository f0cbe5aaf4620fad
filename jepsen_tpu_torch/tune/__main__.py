"""``python -m jepsen_tpu_torch.tune`` — the offline tune pass.

Measures the attached CUDA device (or, with ``--device cpu``, the plain
versions on the CPU, for tests) and writes a calibration artifact the
engine loads at its first lookup; prints one JSON line.  Without CUDA
and without ``--device cpu`` it exits non-zero with the probe's error.
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    from . import artifact, calibrate

    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.tune",
        description="Measure the attached device and persist a "
        "calibration artifact the engine loads at its first lookup.",
    )
    ap.add_argument(
        "--out", default=None,
        help="artifact path (default calibration.json in the working "
        "directory: the path the engine loads by default)",
    )
    ap.add_argument(
        "--profile", choices=sorted(calibrate.PROFILES), default="default",
        help="sweep profile: candidate sets and corpus sizes (default "
        "'default'; 'smoke' is the tiny gate)",
    )
    ap.add_argument(
        "--budget-s", type=float, default=None,
        help="wall-clock budget for the sweep (a truncated sweep still "
        "persists every config it measured)",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where to measure (default cuda; cpu runs the plain "
        "versions, for tests only)",
    )
    args = ap.parse_args(argv)
    try:
        path, data = calibrate.run_tune(
            out_path=args.out or artifact.DEFAULT_PATH,
            profile=args.profile, budget_s=args.budget_s,
            device=args.device,
        )
    except RuntimeError as e:
        print(f"python -m jepsen_tpu_torch.tune: {e}", file=sys.stderr)
        return 1
    sweep = data.get("sweep", {})
    print(json.dumps({
        "calibration": data["calibration_id"],
        "path": path,
        "device_kind": data["device_kind"],
        "n_devices": data["n_devices"],
        "params": data["params"],
        "cost_table_entries": len(data.get("cost_table", ())),
        "measured_configs": sweep.get("measured_configs"),
        "wall_s": sweep.get("wall_s"),
        "truncated": sweep.get("truncated"),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
