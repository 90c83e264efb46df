"""Every registered regime, run by both packages on the CPU, gives the same
numbers.

The JAX package (``repro.scenarios``, numpy GF) and the port
(``repro_torch.scenarios`` with ``device="cpu"``, the plain version of the
``gf_matmul`` kernel) run each scenario at smoke size from the same seeds.
The copied modules keep the simulated clock's float arithmetic op for op,
so the payloads compare with ``==`` once the fields measured on the wall
clock are removed (``wall_s``, ``engine_wall_s``, ``detection_wall_s`` and
every ``*_per_sec``); digests and SLO values too.  ``engine`` never shrinks
under smoke, so its ramp is cut to the 10k rung in both packages (the rung
whose digest ``chip_smoke.py`` pins) and its run callable is compared
directly: the declared SLO reads the 100k rung.  A 2-point sweep of
``tune_admission`` gives the same evaluation points in both.
"""
from __future__ import annotations

import importlib

import pytest
import torch

PACKAGES = ("repro", "repro_torch")
WALL_KEYS = {"wall_s", "engine_wall_s", "detection_wall_s"}
SMOKE_SCENARIOS = ("serve_grid", "concurrent", "background", "churn", "das",
                   "tune_admission")
ENGINE_DIGEST_10K = "5cb923036ace9559"  # the 10k rung, as chip_smoke.py pins it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain CPU path runs small tensors, where an intra-op thread pool
    costs far more than it saves: one thread per module, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scenarios(pkg: str):
    mod = importlib.import_module(f"{pkg}.scenarios")
    mod.load_builtin()
    return mod


def _cpu(pkg: str) -> dict:
    return {"device": "cpu"} if pkg == "repro_torch" else {}


def _sim_only(node):
    """The payload without the fields measured on the wall clock."""
    if isinstance(node, dict):
        return {k: _sim_only(v) for k, v in node.items()
                if k not in WALL_KEYS and not k.endswith("_per_sec")}
    if isinstance(node, (list, tuple)):
        return [_sim_only(v) for v in node]
    return node


def test_sim_only_drops_exactly_the_wall_fields():
    payload = {"wall_s": 1.0, "p99_ms": 2.0, "engine": {"events": 3, "wall_s": 4.0,
                                                          "events_per_sec": 5.0},
               "ramp": [{"engine_wall_s": 6.0, "requests_per_sec": 7.0, "digest": "x"}],
               "detection_wall_s": 8.0}
    assert _sim_only(payload) == {"p99_ms": 2.0, "engine": {"events": 3},
                                  "ramp": [{"digest": "x"}]}


@pytest.mark.parametrize("name", SMOKE_SCENARIOS)
def test_scenario_matches_reference(name):
    got = {}
    for pkg in PACKAGES:
        res = _scenarios(pkg).run_scenario(name, smoke=True, emit=False, **_cpu(pkg))
        assert res.slos_ok, (pkg, [r.message() for r in res.slo_results])
        got[pkg] = (_sim_only(res.payload), res.digest,
                    [(r.slo.metric, r.value, r.bound) for r in res.slo_results])
    assert got["repro_torch"][0] == got["repro"][0]
    assert got["repro_torch"][1] == got["repro"][1]
    assert got["repro_torch"][2] == got["repro"][2]


def test_engine_10k_rung_matches_reference(monkeypatch):
    got = {}
    for pkg in PACKAGES:
        sc = _scenarios(pkg)
        engine = importlib.import_module(f"{pkg}.scenarios.engine")
        monkeypatch.setattr(engine, "RAMP", (10_000,))
        scenario = sc.REGISTRY.get("engine")
        ctx = sc.ScenarioContext(scenario=scenario, config=scenario.config(), smoke=True,
                                 **_cpu(pkg))
        got[pkg] = _sim_only(scenario.run(ctx))
    assert got["repro_torch"]["digest_10k"] == ENGINE_DIGEST_10K
    assert got["repro_torch"] == got["repro"]


def test_sweep_matches_reference():
    got = {}
    for pkg in PACKAGES:
        sc = _scenarios(pkg)
        prob = sc.ScenarioProblem(
            "tune_admission", (sc.KnobAxis("rpc_max_inflight_fetches", (3, 12)),),
            "goodput_mbps", smoke=True, verbose=False, **_cpu(pkg))
        res = prob.sweep()
        got[pkg] = ([p.summary() for p in res.history], res.best.summary(),
                    res.baseline.summary(), res.improved)
    assert len(got["repro_torch"][0]) == 3 and all(p["digest"] for p in got["repro_torch"][0])
    assert got["repro_torch"] == got["repro"]
