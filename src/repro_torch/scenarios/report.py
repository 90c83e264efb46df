"""Benchmark reporting shared by the scenario runner: CSV row emission and
the machine-readable JSON sidecar named by ``BENCH_JSON``, as in the JAX
package's ``repro/scenarios/report.py``.
"""
from __future__ import annotations

import json
import os
import time


def emit_json(section: str, payload) -> None:
    """Merge ``payload`` under ``section`` into the JSON file named by the
    ``BENCH_JSON`` env var (no-op when unset).  Sections merge read-modify-
    write so several scenario runs in one job share a file."""
    path = os.environ.get("BENCH_JSON")
    if not path:
        return
    doc = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
            if not isinstance(doc, dict):
                doc = {}
        except (json.JSONDecodeError, OSError):
            # a corrupt/partial sidecar (killed run) must not sink the
            # whole suite: start fresh, earlier sections are lost anyway
            doc = {}
    doc[section] = payload
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)  # atomic: readers never see a half-written file


def timeit(fn, *, repeats: int = 3, warmup: int = 1):
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def row(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}")


def metric_path(payload, path: str):
    """Resolve a dotted path (``"5000rps.admitted.p99_ms"``) into a nested
    metrics payload.  Integer-looking segments index dict keys first (JSON
    payloads key ramp rungs by stringified counts)."""
    node = payload
    for seg in path.split("."):
        if isinstance(node, dict):
            if seg in node:
                node = node[seg]
                continue
            raise KeyError(
                f"metric path {path!r}: no key {seg!r} "
                f"(have {sorted(node)[:12]})"
            )
        if isinstance(node, (list, tuple)):
            node = node[int(seg)]
            continue
        raise KeyError(f"metric path {path!r}: {seg!r} indexes a leaf {node!r}")
    return node
