"""The port's scenario registry, SLOs and sweep driver (``repro_torch.scenarios``).

Every test of ``tests/test_scenarios.py``, on the port: synthetic scenarios
(cheap run callables, standalone Scenario objects that never touch the
module REGISTRY) cover the registry/runner/sweep logic; one real smoke run
of ``tune_admission`` on the CPU pins the end-to-end digest-reproducibility
claim the optimiser rests on.  Beyond the reference: the built-in registry
declares the same entries as the JAX package's, and the CLI.
"""
from __future__ import annotations

import dataclasses
import hashlib

import pytest
import torch

from repro_torch.configs.shelby import CONFIG, KNOB_DOCS, ShelbyConfig, knob_doc
from repro_torch.scenarios import load_builtin
from repro_torch.scenarios.registry import (
    REGISTRY,
    SLO,
    DuplicateScenarioError,
    Scenario,
    ScenarioError,
    ScenarioRegistry,
    SLOViolation,
    UnknownKnobError,
    UnknownScenarioError,
)
from repro_torch.scenarios.report import metric_path
from repro_torch.scenarios.runner import run_scenario
from repro_torch.scenarios.sweep import KnobAxis, ScenarioProblem, SearchError


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain CPU path runs small tensors, where an intra-op thread pool
    costs far more than it saves: one thread per module, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _knob_digest(cfg) -> str:
    """A deterministic stand-in for the replay digest: any function of
    the resolved knobs works for driver-logic tests."""
    key = f"{cfg.rpc_max_inflight_fetches}|{cfg.rpc_shed_deadline_ms}"
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def _toy(name="toy", slos=(), knobs=None, run=None, **kw):
    """A standalone Scenario (NOT registered in the module REGISTRY)."""
    def default_run(ctx):
        cfg = ctx.config
        budget = cfg.rpc_max_inflight_fetches
        # saturating response: goodput grows with the fetch budget until
        # the tail blows past it — gives the optimiser a real landscape
        if budget is None:
            goodput, p99 = 500.0, 400.0   # free-running: fast but infeasible
        else:
            goodput = 100.0 + 20.0 * min(budget, 12)
            p99 = 40.0 + 8.0 * budget
        return {"goodput": goodput, "p99": p99,
                "nested": {"budget": budget if budget is not None else -1},
                "digest": _knob_digest(cfg)}
    return Scenario(
        name=name, description="toy", workload="none", section="toy",
        run=run or default_run, knobs=knobs or {}, slos=tuple(slos), **kw)


# -- registry ----------------------------------------------------------------

def test_duplicate_name_rejected():
    reg = ScenarioRegistry()
    reg.register(_toy("dup"))
    with pytest.raises(DuplicateScenarioError, match="dup"):
        reg.register(_toy("dup"))


def test_unknown_scenario_lists_names():
    reg = ScenarioRegistry()
    reg.register(_toy("present"))
    with pytest.raises(UnknownScenarioError, match="present"):
        reg.get("absent")


def test_unknown_knob_rejected_at_registration():
    with pytest.raises(UnknownKnobError, match="not_a_knob"):
        _toy(knobs={"not_a_knob": 1})
    with pytest.raises(UnknownKnobError, match="not_a_knob"):
        Scenario(name="t", description="", workload="", section="t",
                 run=lambda ctx: {}, tunable=("not_a_knob",))
    # the port's config has no GF-backend knob: the layout's device picks it
    with pytest.raises(UnknownKnobError, match="decode_matmul"):
        _toy(knobs={"decode_matmul": "pallas"})


def test_unknown_knob_rejected_at_call_time():
    sc = _toy()
    with pytest.raises(UnknownKnobError, match="typo_knob"):
        sc.config({"typo_knob": 3})
    with pytest.raises(UnknownKnobError):
        run_scenario(sc, overrides={"typo_knob": 3}, smoke=True, emit=False,
                     device="cpu")


def test_knob_resolution_order():
    """defaults < scenario.knobs < call-time overrides."""
    sc = _toy(knobs={"rpc_max_inflight_fetches": 6,
                     "rpc_shed_deadline_ms": 100.0})
    # default layer
    assert CONFIG.rpc_max_inflight_fetches is None
    # scenario layer wins over defaults
    cfg = sc.config()
    assert cfg.rpc_max_inflight_fetches == 6
    assert cfg.rpc_shed_deadline_ms == 100.0
    # override layer wins over scenario, untouched knobs keep lower layers
    cfg = sc.config({"rpc_max_inflight_fetches": 12})
    assert cfg.rpc_max_inflight_fetches == 12
    assert cfg.rpc_shed_deadline_ms == 100.0
    assert cfg.rpc_single_flight == CONFIG.rpc_single_flight


def test_builtin_registry_contents():
    load_builtin()
    names = REGISTRY.names()
    for expected in ("serve_grid", "concurrent", "background", "churn",
                     "das", "engine", "tune_admission"):
        assert expected in names, names
    # sections are unique: two scenarios must never clobber one BENCH key
    sections = [sc.section for sc in REGISTRY]
    assert len(sections) == len(set(sections))


def test_builtin_registry_matches_reference():
    """The same seven entries as the JAX package's, field for field (the
    run callables aside): names, sections, knobs, SLOs, tunables,
    headlines, budgets."""
    from repro.scenarios import REGISTRY as REF
    from repro.scenarios import load_builtin as ref_load

    load_builtin()
    ref_load()

    def view(reg):
        return [(sc.name, sc.description, sc.workload, sc.section, dict(sc.knobs),
                 [dataclasses.astuple(slo) for slo in sc.slos], sc.tunable,
                 sc.headline, sc.budget_s) for sc in reg]

    assert view(REGISTRY) == view(REF)


def test_port_runs_on_the_card_by_default():
    """``run_scenario(..., device=None)`` means the card: without one it
    raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    load_builtin()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario("tune_admission", smoke=True, emit=False)


# -- SLOs --------------------------------------------------------------------

def test_slo_ops_and_bounds():
    payload = {"p99_ms": 120.0, "limit": 150.0, "nested": {"v": 2}}
    assert SLO("p99_ms", "<=", 150.0).check(payload, CONFIG).ok
    assert not SLO("p99_ms", ">", 150.0).check(payload, CONFIG).ok
    # bound as another metric path
    assert SLO("p99_ms", "<", "limit").check(payload, CONFIG).ok
    # bound as a config knob name
    cfg = dataclasses.replace(CONFIG, bg_p99_budget=1.5)
    res = SLO("nested.v", "<=", "bg_p99_budget").check(payload, cfg)
    assert not res.ok and res.bound == 1.5
    # atol slack direction: loosens <=, tightens side for >= is symmetric
    assert SLO("p99_ms", "<=", 119.0, atol=2.0).check(payload, CONFIG).ok
    assert SLO("p99_ms", ">=", 121.0, atol=2.0).check(payload, CONFIG).ok
    with pytest.raises(ScenarioError, match="op"):
        SLO("p99_ms", "==", 1.0)


def test_slo_violation_names_scenario():
    sc = _toy("sat_storm", slos=(SLO("p99", "<=", 150.0),),
              knobs={"rpc_max_inflight_fetches": 24})  # p99 = 232 > 150
    with pytest.raises(SLOViolation) as ei:
        run_scenario(sc, smoke=True, emit=False, device="cpu")
    msg = str(ei.value)
    assert "sat_storm" in msg and "p99" in msg and "150" in msg
    # SLOViolation must trip plain assert-catching harnesses too
    assert isinstance(ei.value, AssertionError)
    # raise_on_violation=False records instead of raising
    res = run_scenario(sc, smoke=True, emit=False, raise_on_violation=False,
                       device="cpu")
    assert not res.slos_ok and not res.slo_results[0].ok


def test_metric_path_errors_name_the_segment():
    with pytest.raises(KeyError, match="missing"):
        metric_path({"a": {"b": 1}}, "a.missing")
    assert metric_path({"a": [{"x": 5}]}, "a.0.x") == 5


def test_emit_json_merges_sections(tmp_path, monkeypatch):
    """``emit`` merges a scenario's payload into the file ``BENCH_JSON``
    names, and writes nothing without it."""
    path = tmp_path / "bench.json"
    monkeypatch.setenv("BENCH_JSON", str(path))
    run_scenario(_toy("a"), smoke=True, device="cpu")
    run_scenario(dataclasses.replace(_toy("b"), section="other"), smoke=True,
                 device="cpu")
    import json

    doc = json.loads(path.read_text())
    assert sorted(doc) == ["other", "toy"] and doc["toy"]["goodput"] == 500.0
    monkeypatch.delenv("BENCH_JSON")
    path.unlink()
    run_scenario(_toy("c"), smoke=True, device="cpu")
    assert not path.exists()


# -- sweep driver ------------------------------------------------------------

AXES = (KnobAxis("rpc_max_inflight_fetches", (None, 3, 6, 12, 24)),)


def test_sweep_memoizes_and_scores_infeasible():
    calls = []
    base = _toy(slos=(SLO("p99", "<=", 150.0),),
                knobs={"rpc_max_inflight_fetches": 6})
    counted = dataclasses.replace(
        base, run=lambda ctx: (calls.append(1), base.run(ctx))[1])
    prob = ScenarioProblem(counted, AXES, "goodput", smoke=True,
                           verbose=False, device="cpu")
    result = prob.sweep()
    # baseline {} and the None axis candidate are distinct memo keys but
    # the 5-candidate grid itself evaluates each point exactly once
    assert len(calls) == len(result.history) == 6
    prob.evaluate({"rpc_max_inflight_fetches": 3})  # memoized: no new run
    assert len(calls) == 6
    # feasible argmax is budget=12 (goodput 340, p99 136); None and 24
    # are infeasible and must never win despite higher raw goodput
    assert result.best.knobs == {"rpc_max_inflight_fetches": 12}
    assert result.best.feasible and result.improved
    infeasible = [p for p in result.history if not p.feasible]
    assert infeasible and all(p.violations for p in infeasible)


def test_hill_climb_escapes_infeasible_start_and_improves():
    sc = _toy(slos=(SLO("p99", "<=", 150.0),),
              knobs={"rpc_max_inflight_fetches": 6})
    prob = ScenarioProblem(sc, AXES, "goodput", smoke=True, verbose=False,
                           device="cpu")
    # start at the ShelbyConfig default (admission off -> infeasible)
    result = prob.hill_climb(start={"rpc_max_inflight_fetches": None})
    assert result.best.feasible
    assert result.best.knobs == {"rpc_max_inflight_fetches": 12}
    # improvement is against the scenario's registered default (budget=6)
    assert result.baseline.value == pytest.approx(220.0)
    assert result.best.value == pytest.approx(340.0)
    assert result.improved
    # every evaluated point carries its reproducibility digest
    assert all(p.digest for p in result.history)
    doc = result.to_json()
    assert doc["improved"] and doc["best"]["digest"]


def test_sweep_requires_digest_and_real_axes():
    no_digest = _toy(run=lambda ctx: {"goodput": 1.0, "p99": 1.0})
    prob = ScenarioProblem(no_digest, AXES, "goodput", smoke=True,
                           verbose=False, device="cpu")
    with pytest.raises(SearchError, match="digest"):
        prob.evaluate({})
    with pytest.raises(UnknownKnobError):
        ScenarioProblem(_toy(), (KnobAxis("bogus_knob", (1,)),), "goodput")
    with pytest.raises(SearchError, match="candidates"):
        KnobAxis("rpc_hedge", ())


def test_sweep_passes_its_device_to_every_evaluation():
    seen = []
    sc = _toy(run=lambda ctx: (seen.append(ctx.device),
                               _toy().run(ctx))[1])
    ScenarioProblem(sc, AXES[:1], "goodput", smoke=True, verbose=False,
                    device="cpu").evaluate({})
    assert seen == ["cpu"]


# -- knob docs ---------------------------------------------------------------

def test_every_knob_documented():
    fields = {f.name for f in dataclasses.fields(ShelbyConfig)}
    assert set(KNOB_DOCS) == fields, (
        f"KNOB_DOCS out of sync: missing={sorted(fields - set(KNOB_DOCS))} "
        f"stale={sorted(set(KNOB_DOCS) - fields)}"
    )
    for name, doc in KNOB_DOCS.items():
        assert "unit:" in doc and "default:" in doc and "Exercised by" in doc, (
            f"{name}: doc must state unit, default, and exercising scenario"
        )
    assert "unit:" in knob_doc("rpc_hedge")
    with pytest.raises(KeyError, match="nonexistent_knob"):
        knob_doc("nonexistent_knob")


def test_registry_references_only_documented_knobs():
    load_builtin()
    for sc in REGISTRY:
        for k in list(sc.knobs) + list(sc.tunable):
            assert k in KNOB_DOCS, f"{sc.name}: undocumented knob {k}"
        for slo in sc.slos:
            if isinstance(slo.bound, str) and slo.bound in {
                    f.name for f in dataclasses.fields(ShelbyConfig)}:
                assert slo.bound in KNOB_DOCS


# -- the CLI -----------------------------------------------------------------

def test_cli_list_budgets_and_run(capsys, monkeypatch):
    from repro_torch.scenarios.__main__ import main

    assert main(["list"]) == 0
    out = capsys.readouterr().out
    assert "tune_admission" in out and "section=concurrent_ramp" in out
    monkeypatch.setenv("SCENARIO_BUDGET_SCALE", "2")
    assert main(["budgets"]) == 0
    assert "engine 840" in capsys.readouterr().out.splitlines()
    monkeypatch.setenv("BACKBONE_SMOKE", "1")
    assert main(["run", "tune_admission", "--no-emit", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "== scenario tune_admission: ok ==" in out
    with pytest.raises(SystemExit):
        main(["run"])


# -- the real thing: digest reproducibility ----------------------------------

def test_tune_admission_same_seed_same_digest():
    """Two smoke evaluations of the registered tune_admission scenario
    (fresh worlds, fresh fleets) produce the SAME replay digest — the
    property every sweep-result number leans on."""
    load_builtin()
    a = run_scenario("tune_admission", smoke=True, emit=False, device="cpu")
    b = run_scenario("tune_admission", smoke=True, emit=False, device="cpu")
    assert a.digest and a.digest == b.digest
    assert a.payload["goodput_mbps"] == b.payload["goodput_mbps"]
    assert a.slos_ok and b.slos_ok
    # overrides change the resolved config AND the digest (the knobs are
    # genuinely load-bearing, not cosmetic)
    c = run_scenario("tune_admission", smoke=True, emit=False,
                     overrides={"rpc_max_inflight_fetches": 3}, device="cpu")
    assert c.config.rpc_max_inflight_fetches == 3
    assert c.digest != a.digest
