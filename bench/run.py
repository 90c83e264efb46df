#!/usr/bin/env python3
"""Runs one cell of the PyTorch port's benchmark once and prints its result.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout with one NVIDIA GPU per chip the cell asks for
(``BENCHMARK.json`` lists the cells).  Set-up (building the program's
kernels on a checkout's first run, the storage deployment, the corpus, the
weights, the check's first steps) is timed as ``setup_s``; then the window
runs for ``--seconds``; then the check.  The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, also the last lines of standard error.

Exits non-zero, printing no result, without a GPU, where the program is
missing, or where the process holds JAX or the JAX package once the window
has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache inside the checkout, at fixed paths (the
# program builds its CUDA kernels into ROOT/build/repro_torch by itself)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names


def forbidden_modules(names) -> list[str]:
    """The top-level names among ``names`` (dotted module names) that are JAX
    or the JAX package: compared whole, so ``repro_torch`` passes."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell, out, trace: bool, device: dict) -> dict:
    """The result object, ``checks`` its last key."""
    from cells import metric_reader

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(out.run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": all(c.ok for c in out.checks), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from cells import load_cell

    cell = load_cell(args.workload)
    # the deployment's setting of PyTorch's caching allocator, read before CUDA starts
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = cell.config["allocator"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = cell.driver.run(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"the process holds {found}: the benchmark runs the port alone", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    if args.trace:
        device.update({"busy_s": out.run.trace.busy_s(), "window_s": out.run.window_s})
    line = result_line(cell, out, bool(args.trace), device)
    print(json.dumps({"notes": out.notes}), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
