"""Finds a cell's parts by name from files alone.

``BENCHMARK.json`` (at the checkout's root) names the cell, its
configuration and its traffic mix, and lists the metrics.  The parts:

* the configuration: the JSON file ``configs[].file`` names.  Its
  ``reference`` key names the plain reference (``bench/reference/<name>.py``)
  and its ``port`` key how the program under test builds it;
* the traffic mix: ``bench/traffic/<traffic>.json``; its ``kind`` names the
  driver that runs it (``bench/drivers/<kind>.py``);
* each per-layer metric: ``bench/metrics/<name>.py``, whose ``read(run)``
  returns the number or None where the run has nothing to read.

A new cell, configuration, mix or metric is new files and new entries.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the mix's file's contents
    end_to_end: list[dict]  # BENCHMARK.json's entries that this cell reports
    per_layer: list[dict]

    @property
    def reference(self):
        return importlib.import_module(f"reference.{self.config['reference']}")

    @property
    def driver(self):
        return importlib.import_module(f"drivers.{self.traffic['kind']}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name) and m["moves"] in moved]
    return Cell(name, w["chips"], config, traffic, e2e, per_layer)


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """``read`` of ``bench/metrics/<name>.py`` (a name may hold dots)."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
