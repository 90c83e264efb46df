"""Headless scenario execution: resolve knobs, run, assert SLOs, emit.

``run_scenario`` is the one entry point every consumer shares — the
scenario CLI (``python -m repro_torch.scenarios run <name>``), the sweep
driver, ``chip_smoke.py`` and tests.  A scenario's ``run`` callable
receives a :class:`ScenarioContext` and returns its metrics payload; the
runner then evaluates every declared SLO against that payload (failures
raise :class:`SLOViolation` naming the scenario) and merges the payload
into the BENCH sidecar.  The context carries the device the scenario's
byte work (decodes, repairs, DAS extensions) runs on: ``None`` is the
card, ``"cpu"`` the plain path.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping

import torch

from repro_torch.configs.shelby import ShelbyConfig
from repro_torch.scenarios.registry import (
    REGISTRY,
    Scenario,
    SLOResult,
    SLOViolation,
)
from repro_torch.scenarios.report import emit_json


def default_smoke() -> bool:
    """CI sets ``BACKBONE_SMOKE=1`` to shrink every scenario's traffic."""
    return bool(int(os.environ.get("BACKBONE_SMOKE", "0")))


@dataclasses.dataclass(frozen=True)
class ScenarioContext:
    """What a scenario's run callable sees: its resolved config (defaults
    < scenario.knobs < call-time overrides), the smoke flag and the device
    of its layouts (``None``: the card)."""

    scenario: Scenario
    config: ShelbyConfig
    smoke: bool
    device: torch.device | str | None = None


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    scenario: Scenario
    config: ShelbyConfig
    payload: Mapping
    slo_results: tuple[SLOResult, ...]

    @property
    def slos_ok(self) -> bool:
        return all(r.ok for r in self.slo_results)

    @property
    def digest(self) -> str | None:
        """The deterministic replay digest, when the payload carries one
        (sweep evaluations require it for reproducibility)."""
        d = self.payload.get("digest")
        return str(d) if d is not None else None


def check_slos(scenario: Scenario, payload, config: ShelbyConfig,
               *, raise_on_violation: bool = True) -> tuple[SLOResult, ...]:
    results = tuple(slo.check(payload, config) for slo in scenario.slos)
    violated = [r for r in results if not r.ok]
    for r in results:
        print(f"# slo[{scenario.name}] {r.message()}")
    if violated and raise_on_violation:
        lines = "; ".join(r.message() for r in violated)
        raise SLOViolation(
            f"scenario {scenario.name!r} violated "
            f"{len(violated)}/{len(results)} SLO(s): {lines}"
        )
    return results


def run_scenario(
    name: str | Scenario,
    *,
    overrides: Mapping[str, object] | None = None,
    smoke: bool | None = None,
    emit: bool = True,
    raise_on_violation: bool = True,
    device: torch.device | str | None = None,
) -> ScenarioResult:
    """Run one registered scenario end to end.

    ``overrides`` layer on top of the scenario's own knobs (the sweep
    driver's handle); ``smoke`` defaults to the ``BACKBONE_SMOKE`` env;
    ``emit=False`` skips the BENCH sidecar merge (sweep evaluations
    must not clobber the canonical section with a searched point);
    ``raise_on_violation=False`` records SLO outcomes instead of
    raising (how the sweep scores infeasible points); ``device`` is where
    the scenario's layouts live (``None``: the card, which raises without
    one; ``"cpu"``: the plain path).
    """
    if isinstance(name, Scenario):
        scenario = name
    else:
        from repro_torch.scenarios import load_builtin
        load_builtin()
        scenario = REGISTRY.get(name)
    config = scenario.config(overrides)
    ctx = ScenarioContext(
        scenario=scenario,
        config=config,
        smoke=default_smoke() if smoke is None else smoke,
        device=device,
    )
    payload = scenario.run(ctx)
    slo_results = check_slos(scenario, payload, config,
                             raise_on_violation=raise_on_violation)
    if emit:
        emit_json(scenario.section, payload)
    return ScenarioResult(scenario=scenario, config=config,
                          payload=payload, slo_results=slo_results)
