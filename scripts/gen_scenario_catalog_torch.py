"""Render the scenario catalog from the port's registry, and check it against
the JAX package's.

    PYTHONPATH=src python scripts/gen_scenario_catalog_torch.py          # write
    PYTHONPATH=src python scripts/gen_scenario_catalog_torch.py --check  # compare

The counterpart of ``scripts/gen_scenario_catalog.py`` over
``repro_torch.scenarios`` (its registry, SLOs, budgets and workloads) and
``repro_torch.configs.shelby.KNOB_DOCS``, with the headline numbers read
from the committed ``BENCH_backbone.json``.  The text is the reference's,
byte for byte where the registries agree (its header and run lines name the
JAX package's commands, which the catalog documents), so that ``--check``
against the committed ``docs/CATALOG.md`` proves the two registries equal:
it regenerates into memory and compares with the file byte for byte (exit
1 if they differ).  Writing never touches ``docs/``: the default output is
``results/catalog_torch/CATALOG.md``; ``--check`` compares with
``docs/CATALOG.md`` unless ``--out`` names another file.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.configs.shelby import KNOB_DOCS
from repro_torch.scenarios import REGISTRY, load_builtin
from repro_torch.scenarios.report import metric_path

REPO = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_OUT = REPO / "results" / "catalog_torch" / "CATALOG.md"
DEFAULT_CHECK = REPO / "docs" / "CATALOG.md"
DEFAULT_BENCH = REPO / "BENCH_backbone.json"

HEADER = """\
<!-- GENERATED by scripts/gen_scenario_catalog.py - do not edit by hand.
     Regenerate: PYTHONPATH=src python scripts/gen_scenario_catalog.py
     CI verifies freshness with --check. -->

# Scenario catalog

One entry per scenario registered in `repro.scenarios` (see
[docs/scenarios.md](scenarios.md) for the authoring guide).  Every
scenario runs headless, asserts its declared SLOs, and merges its metrics
into `BENCH_backbone.json` under its section key:

```
BENCH_JSON=BENCH_backbone.json BACKBONE_SMOKE=1 \\
    PYTHONPATH=src python -m repro.scenarios run <name>
```

Headline numbers below are quoted from the **committed**
`BENCH_backbone.json` (full-size runs, not smoke).  Knobs live in
`src/repro/configs/shelby.py` (`KNOB_DOCS` documents every one); sweep
them against the SLOs with `scripts/perf_hillclimb.py`.
"""


def _fmt(v) -> str:
    if isinstance(v, bool) or v is None:
        return str(v)
    if isinstance(v, float):
        return f"{v:.4g}"
    if isinstance(v, (int, str)):
        return str(v)
    return repr(v)


def _headline_value(bench: dict, section: str, path: str) -> str:
    if section not in bench:
        return "_n/a_"
    try:
        return _fmt(metric_path(bench[section], path))
    except (KeyError, TypeError):
        return "_n/a_"


def generate(bench: dict) -> str:
    """The catalog's text from the registry, ``KNOB_DOCS`` and ``bench``."""
    load_builtin()
    lines = [HEADER]
    lines.append("| scenario | BENCH section | CI budget | SLOs | tunable knobs |")
    lines.append("|---|---|---|---|---|")
    for sc in REGISTRY:
        slos = "; ".join(f"`{s.describe()}`" for s in sc.slos) or "-"
        tun = ", ".join(f"`{k}`" for k in sc.tunable) or "-"
        lines.append(f"| [{sc.name}](#{sc.name.replace('_', '-')}) "
                     f"| `{sc.section}` | {sc.budget_s}s | {slos} | {tun} |")
    lines.append("")
    for sc in REGISTRY:
        lines += [f"## {sc.name}", "", sc.description + ".", "", f"- **Workload:** {sc.workload}"]
        if sc.knobs:
            overrides = ", ".join(f"`{k}={_fmt(v)}`" for k, v in sc.knobs.items())
            lines.append(f"- **Knob overrides:** {overrides}")
        else:
            lines.append("- **Knob overrides:** none (pure `ShelbyConfig` defaults)")
        if sc.slos:
            lines.append("- **SLOs (asserted on every run):**")
            for s in sc.slos:
                desc = f" — {s.description}" if s.description else ""
                atol = f" (atol {_fmt(s.atol)})" if s.atol else ""
                lines.append(f"  - `{s.describe()}`{atol}{desc}")
        if sc.headline:
            lines.append(f"- **Headline (committed BENCH_backbone.json, section `{sc.section}`):**")
            for path in sc.headline:
                lines.append(f"  - `{path}` = {_headline_value(bench, sc.section, path)}")
        if sc.tunable:
            lines.append("- **Tunable knobs** (see `KNOB_DOCS`):")
            for k in sc.tunable:
                lines.append(f"  - `{k}` — {KNOB_DOCS[k].split(';')[0].strip()}")
        lines.append(f"- **Run:** `PYTHONPATH=src python -m repro.scenarios run {sc.name}`")
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help=f"exit 1 unless the file (default {DEFAULT_CHECK.relative_to(REPO)}) "
                         "equals the rendered catalog byte for byte")
    ap.add_argument("--out", default=None,
                    help=f"the file written (default {DEFAULT_OUT.relative_to(REPO)}) or checked")
    ap.add_argument("--bench", default=str(DEFAULT_BENCH))
    args = ap.parse_args(argv)

    bench_path = pathlib.Path(args.bench)
    bench = json.loads(bench_path.read_text()) if bench_path.exists() else {}
    text = generate(bench)
    if args.check:
        out = pathlib.Path(args.out) if args.out else DEFAULT_CHECK
        on_disk = out.read_text() if out.exists() else ""
        if on_disk != text:
            print(f"STALE: {out} does not match the port's registry + {bench_path}.")
            return 1
        print(f"fresh: {out}")
        return 0
    out = pathlib.Path(args.out) if args.out else DEFAULT_OUT
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
