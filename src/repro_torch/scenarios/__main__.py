"""Headless scenario CLI — what CI's smoke loop drives.

    python -m repro_torch.scenarios list              # one line per scenario
    python -m repro_torch.scenarios budgets           # "<name> <budget_s>" pairs
    python -m repro_torch.scenarios run <name> [...]  # run + assert SLOs + emit
    python -m repro_torch.scenarios run --all
    python -m repro_torch.scenarios run <name> --device cpu   # plain path

``run`` honors ``BACKBONE_SMOKE=1`` (shrunk traffic) and ``BENCH_JSON``
(sidecar path) as the JAX package's CLI does; ``--device`` (default: the
card) is where the scenarios' decodes, repairs and DAS extensions run.  ``budgets``
scales each scenario's CI wall budget by ``SCENARIO_BUDGET_SCALE`` (a
float; slow runners set it > 1).
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.scenarios import REGISTRY, load_builtin, run_scenario


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.scenarios")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="one line per registered scenario")
    sub.add_parser("budgets", help="name + scaled CI budget, one per line")

    p_run = sub.add_parser("run", help="run scenario(s) headless")
    p_run.add_argument("names", nargs="*", help="scenario names")
    p_run.add_argument("--all", action="store_true", help="every scenario")
    p_run.add_argument("--no-emit", action="store_true",
                       help="skip the BENCH sidecar merge")
    p_run.add_argument("--device", default=None,
                       help="torch device of the byte work (default: the card)")

    args = parser.parse_args(argv)
    load_builtin()

    if args.cmd == "list":
        width = max(len(n) for n in REGISTRY.names())
        for sc in REGISTRY:
            slos = ", ".join(s.describe() for s in sc.slos) or "none"
            print(f"{sc.name:<{width}}  section={sc.section}  "
                  f"budget={sc.budget_s}s  slos: {slos}")
        return 0

    if args.cmd == "budgets":
        scale = float(os.environ.get("SCENARIO_BUDGET_SCALE", "1.0"))
        for sc in REGISTRY:
            print(f"{sc.name} {int(sc.budget_s * scale)}")
        return 0

    names = list(REGISTRY.names()) if args.all else args.names
    if not names:
        parser.error("run: give scenario names or --all")
    for name in names:
        print(f"== scenario {name} ==")
        result = run_scenario(name, emit=not args.no_emit, device=args.device)
        status = "ok" if result.slos_ok else "SLO VIOLATED"
        print(f"== scenario {name}: {status} ==")
    return 0


if __name__ == "__main__":
    sys.exit(main())
