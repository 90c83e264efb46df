"""The harness finds a configuration, a mix and a per-layer metric by name,
from files alone."""
from __future__ import annotations

import json

import pytest
import smoke_cell  # noqa: F401
from cells import ROOT, load_cell, metric_reader


def test_every_cell_of_the_benchmark_loads_with_its_parts():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = load_cell(w["name"])
        assert cell.traffic["kind"] == "train" and cell.driver.run
        assert cell.reference.Model(cell.config).param_table()
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(metric_reader(m["name"]))


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    (tmp_path / "bench" / "configs").mkdir(parents=True)
    (tmp_path / "bench" / "traffic").mkdir()
    (tmp_path / "bench" / "metrics").mkdir()
    (tmp_path / "bench" / "configs" / "m.json").write_text(json.dumps(
        {"reference": "starcoder2", "hidden_size": 8}))
    (tmp_path / "bench" / "traffic" / "mix.json").write_text(json.dumps({"kind": "train"}))
    (tmp_path / "bench" / "metrics" / "ops.count.py").write_text(
        "def read(run):\n    return None if run is None else 7.0\n")
    spec = {"configs": [{"name": "m", "file": "bench/configs/m.json"}],
            "workloads": [{"name": "m.mix", "config": "m", "traffic": "mix", "chips": 1}],
            "end_to_end": [{"name": "rate", "unit": "x/s"},
                           {"name": "setup_s", "unit": "s"},
                           {"name": "other", "unit": "s", "workloads": ["n.mix"]}],
            "per_layer": [{"name": "ops.count", "unit": "1", "moves": "rate"},
                          {"name": "elsewhere", "unit": "1", "moves": "rate",
                           "workloads": ["n.mix"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = load_cell("m.mix", root=tmp_path)
    assert cell.config["hidden_size"] == 8 and cell.traffic == {"kind": "train"}
    assert [m["name"] for m in cell.end_to_end] == ["rate", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["ops.count"]
    read = metric_reader("ops.count", root=tmp_path)
    assert read(None) is None and read(object()) == 7.0
    with pytest.raises(KeyError):
        load_cell("n.mix", root=tmp_path)
