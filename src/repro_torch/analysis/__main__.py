"""CLI for the determinism lint pass.

Exit codes (CI distinguishes them):
  0 — clean (no unbaselined findings, no stale baseline entries)
  1 — findings (new hits, pragmas missing reasons, or stale baseline rows)
  2 — internal error (linter crash, unparseable file, bad usage)
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import traceback

from repro_torch.analysis import simlint


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="simlint: determinism & simulation-safety rules for the "
                    "sim path (net/ storage/ core/ scenarios/)")
    ap.add_argument("paths", nargs="*", type=pathlib.Path,
                    help="files/dirs to lint (default: src/repro_torch sim path)")
    ap.add_argument("--check", action="store_true",
                    help="baseline-aware gate (this is also the default "
                         "behaviour; the flag exists for explicit CI lines)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the committed baseline from current hits")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code in sorted(simlint.RULES):
            print(f"{code}  {simlint.RULES[code]}")
        return 0

    findings = simlint.lint_paths(args.paths or None)

    if args.write_baseline:
        simlint.write_baseline(findings)
        print(f"wrote {len(findings)} baseline entries to "
              f"{simlint.BASELINE_PATH}")
        return 0

    if args.no_baseline:
        new, stale = findings, []
    else:
        new, stale = simlint.diff_baseline(findings, simlint.load_baseline())

    for f in new:
        print(f.render())
    for key in stale:
        print(f"stale baseline entry (no matching finding): {key}")
    n_files = len(simlint.iter_target_files(args.paths or None))
    if new or stale:
        print(f"simlint: {len(new)} finding(s), {len(stale)} stale baseline "
              f"entr(ies) across {n_files} sim-path files", file=sys.stderr)
        return 1
    print(f"simlint: clean ({n_files} sim-path files, "
          f"{len(findings)} baselined hit(s))")
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        raise SystemExit(2)
