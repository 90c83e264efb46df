"""The result's last line, and what a run prints where it must not run."""
from __future__ import annotations

import json

import pytest
import smoke_cell
import torch
from cells import load_cell

import run as bench_run


@pytest.fixture(autouse=True)
def _one_thread():
    old = smoke_cell.one_thread()
    yield
    torch.set_num_threads(old)


DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "memory_peak_bytes": 1}


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contracts_keys_and_checks_last(trace):
    cell = smoke_cell.smoke_cell("starcoder2-3b.train_4k")
    out = smoke_cell.run_smoke(cell, seed=2**31 + 17, trace=trace)
    device = dict(DEVICE, **({"busy_s": 1.0, "window_s": out.run.window_s} if trace else {}))
    line = json.loads(json.dumps(bench_run.result_line(cell, out, trace, device)))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in keys) == trace
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    wanted = cell.per_layer if trace else cell.end_to_end
    names = {m["name"]: m["unit"] for m in wanted}
    for name, m in line["metrics"].items():
        assert names[name] == m["unit"] and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(names)
        assert line["metrics"]["setup_s"]["value"] > 0
    else:  # a CPU run has no device trace: the kernels' readers give nothing
        assert {"data_wait_ms", "step_mfu_pct"} <= set(line["metrics"])
        assert "attn_fwd_roofline" not in line["metrics"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["checks"]) == {"tokens_wrong", "loss_gap", "grad_leaf_gap",
                                   "change_leaf_gap"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_without_the_card_it_exits_non_zero_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_run.main(["--workload", "deepseek-v2-lite-16b.train_4k", "--seed", "1",
                           "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_a_cell_asks_for_one_chip():
    assert all(load_cell(n).chips == 1 for n in ("deepseek-v2-lite-16b.train_4k",
                                                  "deepseek-v2-lite-16b.train_16k"))
