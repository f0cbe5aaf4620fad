"""``python -m jepsen_tpu_torch.lint [paths] [--rules ID,…] [--json [FILE]]``.

Exit status: 0 when every finding is baselined (stale baseline entries
warn but never fail: the baseline may only shrink), 1 on any new
finding, 2 on a usage error.  ``--json [FILE]`` also writes a
machine-readable report (default ``lint.json``).  What a pass skipped
(the ptxas half without a kept log or ``nvcc``, the footprint half off
the card) is printed as a note.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import sys
import time
from typing import List, Optional

from .core import (DEFAULT_BASELINE, all_passes, all_rules, lint_paths,
                   load_baseline, make_baseline)


def _default_paths() -> List[str]:
    """The port's package (from any working directory)."""
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def _expand_rules(tokens: List[str], known: List[str]) -> List[str]:
    """fnmatch-expand rule tokens (``kernel-*``); literal ids pass through
    so an unknown rule is still reported."""
    out: List[str] = []
    for tok in tokens:
        matches = fnmatch.filter(known, tok) if any(
            ch in tok for ch in "*?[") else []
        out.extend(matches or [tok])
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.lint",
        description="dispatch-budget discipline and the kernel contracts "
                    "of the port")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: the "
                         "jepsen_tpu_torch package)")
    ap.add_argument("--rules", metavar="ID[,ID...]",
                    help="run only these rule ids (fnmatch globs allowed)")
    ap.add_argument("--list-rules", action="store_true",
                    help="list every rule id and exit")
    ap.add_argument("--baseline", metavar="PATH", default=DEFAULT_BASELINE,
                    help="baseline file (default: the committed "
                         "jepsen_tpu_torch/lint/baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write every current finding to the baseline and "
                         "exit 0")
    ap.add_argument("--json", metavar="FILE", nargs="?", const="lint.json",
                    default=None,
                    help="write a JSON report (default file: lint.json)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for p in all_passes():
            for r in p.rules:
                print(f"{r}  [{p.name}]")
        return 0

    rules = None
    if args.rules:
        if args.write_baseline:
            print("--write-baseline cannot be combined with --rules: the "
                  "baseline must cover every rule", file=sys.stderr)
            return 2
        rules = _expand_rules(
            [r.strip() for r in args.rules.split(",") if r.strip()],
            all_rules())
        unknown = set(rules) - set(all_rules()) - {"parse-error"}
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    paths = args.paths or _default_paths()
    for p in paths:
        if not os.path.exists(p):
            print(f"no such path: {p}", file=sys.stderr)
            return 2

    baseline = None
    if not args.write_baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (ValueError, json.JSONDecodeError) as e:
            print(f"bad baseline {args.baseline!r}: {e}", file=sys.stderr)
            return 2

    t0 = time.perf_counter()
    result = lint_paths(paths, rules=rules, baseline=baseline)
    elapsed = time.perf_counter() - t0

    if args.write_baseline:
        with open(args.baseline, "w", encoding="utf-8") as fh:
            json.dump(make_baseline(result.findings + result.baselined), fh,
                      indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {len(result.findings)} finding(s) to {args.baseline}")
        return 0

    for f in result.findings:
        print(f.render())
    for e in result.stale:
        print(f"warning: stale baseline entry {e['fp']} "
              f"({e.get('rule', '?')} in {e.get('path', '?')}): the finding "
              "no longer exists; remove it (--write-baseline) so the "
              "baseline keeps shrinking", file=sys.stderr)

    if args.json is not None:
        report = {
            "version": 1,
            "files": result.n_files,
            "elapsed_s": round(elapsed, 3),
            "findings": [f.to_dict() for f in result.findings],
            "baselined": [f.to_dict() for f in result.baselined],
            "stale_baseline": list(result.stale),
            "notes": list(result.notes),
            "pass_timings_s": {k: round(v, 4)
                               for k, v in sorted(result.timings.items())},
        }
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
            fh.write("\n")

    for note in result.notes:
        print(f"note: {note}")
    extra = f", {len(result.baselined)} baselined" if result.baselined \
        else ""
    extra += f", {len(result.stale)} stale" if result.stale else ""
    print(f"lint: {result.n_files} files, {len(result.findings)} "
          f"finding(s){extra} in {elapsed:.2f}s")
    return 1 if result.findings else 0


if __name__ == "__main__":
    sys.exit(main())
