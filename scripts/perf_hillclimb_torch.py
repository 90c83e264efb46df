"""SLO auto-tuning driver on the port: sweep / hill-climb a scenario's knob space.

    PYTHONPATH=src python scripts/perf_hillclimb_torch.py tune_admission
    PYTHONPATH=src python scripts/perf_hillclimb_torch.py tune_admission --sweep --device cpu
    PYTHONPATH=src python scripts/perf_hillclimb_torch.py concurrent \
        --objective 5000rps.admitted.goodput_mbps \
        --axis rpc_max_inflight_fetches=4,6,8,12

The CLI of ``scripts/perf_hillclimb.py`` over ``repro_torch.scenarios.sweep``:
searches the named scenario's knob space for "max <objective> s.t. the
scenario's declared SLOs hold" (coordinate-descent hill-climb by default,
exhaustive grid with ``--sweep``).  Every evaluated point runs headless
with ``emit=False`` and records its replay digest, equal to the JAX
package's at the same knobs.  Each point's layouts live on ``--device``
(the card by default; ``cpu`` runs the plain path), whose ``gf_matmul``
decodes every read.  Without ``--axis``, axes default to
:data:`DEFAULT_AXES`.  Results land in ``results/perf_torch/<scenario>_tune.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.scenarios import REGISTRY, KnobAxis, ScenarioProblem, load_builtin

OUT = pathlib.Path("results/perf_torch")

# Curated default search spaces (the reference's).  Candidates bracket the
# registered default (include it explicitly: the search must be free to keep it).
DEFAULT_AXES = {
    "tune_admission": (
        KnobAxis("rpc_single_flight", (False, True)),
        KnobAxis("rpc_max_inflight_fetches", (None, 3, 6, 12, 24)),
        KnobAxis("rpc_shed_deadline_ms", (None, 100.0, 200.0)),
        KnobAxis("rpc_hedge_deadline_factor", (2.0, 3.0, 5.0)),
    ),
}

DEFAULT_OBJECTIVE = {
    "tune_admission": "goodput_mbps",
}


def _parse_value(tok: str):
    if tok in ("None", "none", "null"):
        return None
    if tok in ("True", "true"):
        return True
    if tok in ("False", "false"):
        return False
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            continue
    return tok


def _parse_axis(spec: str) -> KnobAxis:
    name, _, csv = spec.partition("=")
    if not csv:
        raise SystemExit(f"--axis wants name=v1,v2,...; got {spec!r}")
    return KnobAxis(name, tuple(_parse_value(t) for t in csv.split(",")))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="sweep/hill-climb a scenario's knobs against its SLOs, on the port")
    parser.add_argument("scenario", help="registered scenario name")
    parser.add_argument("--objective", default=None, help="dotted payload path to maximize")
    parser.add_argument("--minimize", action="store_true")
    parser.add_argument("--axis", action="append", default=[], metavar="KNOB=V1,V2,...",
                        help="searched axis (repeatable); defaults to the curated "
                             "DEFAULT_AXES for the scenario")
    parser.add_argument("--sweep", action="store_true",
                        help="exhaustive grid instead of hill-climb")
    parser.add_argument("--full", action="store_true",
                        help="full-size traffic (default: smoke-size runs)")
    parser.add_argument("--device", default=None,
                        help="torch device of the layouts (default: the card; 'cpu': the "
                             "plain path)")
    parser.add_argument("--out", default=None, help="result JSON path")
    args = parser.parse_args(argv)

    load_builtin()
    scenario = REGISTRY.get(args.scenario)
    axes = tuple(_parse_axis(s) for s in args.axis)
    if not axes:
        axes = DEFAULT_AXES.get(scenario.name)
        if axes is None:
            raise SystemExit(f"no default axes for {scenario.name!r} "
                             f"(tunable: {list(scenario.tunable)}); give --axis")
    objective = args.objective or DEFAULT_OBJECTIVE.get(scenario.name)
    if objective is None:
        raise SystemExit(f"no default objective for {scenario.name!r}; give --objective "
                         f"(headline paths: {list(scenario.headline)})")

    problem = ScenarioProblem(scenario, axes, objective, maximize=not args.minimize,
                              smoke=not args.full, device=args.device)
    result = problem.sweep() if args.sweep else problem.hill_climb()

    out = pathlib.Path(args.out) if args.out else OUT / f"{scenario.name}_tune.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    result.dump(out)
    doc = result.to_json()
    print(json.dumps({k: doc[k] for k in
                      ("scenario", "objective", "evaluations", "baseline", "best", "improved")},
                     indent=2))
    print(f"# wrote {out}")
    return 0 if result.best.feasible else 1


if __name__ == "__main__":
    sys.exit(main())
