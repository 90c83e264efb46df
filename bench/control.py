#!/usr/bin/env python3
"""The readings that set a cell's upper limits: the control and the planted
faults, each put in the program's place and compared with the float32
reference as a run compares the program (``checks.readings``).

    python3 bench/control.py --workload <name> --seed <n> [--seed <n> ...]

For each seed, on the cell's own sizes (corpus, weights, batches, steps):

* ``control``: the reference computed in fp8 (every product's operands,
  output and incoming gradient rounded to float8 e4m3, one scale a tensor),
  the precision below the configuration's bfloat16;
* ``half_batch``: the float32 reference on the first half of the batch's
  rows alone (in microbatches of the same size), its mean over them;
* a state left unchanged reads 1 on ``change_leaf_gap`` and needs no run.

Each side's readings are judged by the cell's limits (``bench/limits``) as a
run's are, and come out ``correct`` false where a limit holds them.  Prints
one JSON line a seed, and each number compared beside its limit on standard
error.  Needs the card; no part of the program runs.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))


def control_readings(cell, seed: int, dev, lim: dict | None = None) -> dict:
    """The control's and the half batch's readings against the reference
    for one seed, each judged by ``lim`` (by default the cell's limits):
    module docstring."""
    from checks import (example_offsets, judge, limits, readings, reference_steps,
                        worst_leaves)
    from inputs import derived_seed, zipf_corpus

    t = time.perf_counter()
    tr = cell.traffic
    model = cell.reference.Model(cell.config)
    table = model.param_table()
    n_tokens = tr["corpus_bytes"] // 4
    corpus = zipf_corpus(n_tokens, model.v, tr["zipf_exponent"], seed, dev).cpu().numpy()
    offsets = example_offsets(derived_seed(seed, "order"), n_tokens, tr["batch"], tr["seq"],
                              tr["check_steps"])

    def steps(**kw):
        return reference_steps(cell, model, table, corpus, offsets, tr["seq"], seed, dev, **kw)

    lim = limits(cell.name) if lim is None else lim
    ref = steps()
    out = {"workload": cell.name, "seed": seed}
    for side, kw in (("control", {"precision": "fp8"}), ("half_batch", {"half": True})):
        got = steps(**kw)
        out[side] = readings(got, ref)
        found = judge(out[side], lim)
        out[f"{side}_correct"] = all(c.ok for c in found)
        out[f"{side}_checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in found}
        out[f"{side}_worst_leaves"] = worst_leaves(got, ref)
    out["reference"] = {"loss": ref["loss"], "grad_norm": ref["grad_norm"]}
    out["s"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from cells import load_cell

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control.py runs on the card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in args.seed:
        got = control_readings(cell, seed, torch.device(args.device))
        for side in ("control", "half_batch"):
            print(f"{cell.name} seed {seed} {side}: correct {got[side + '_correct']}",
                  file=sys.stderr)
            for name, c in got[side + "_checks"].items():
                print(f"  check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
