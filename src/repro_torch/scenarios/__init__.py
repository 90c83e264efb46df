"""Declarative scenario registry + SLO auto-tuning for the port.

``load_builtin()`` imports every scenario module so their ``register()``
calls populate :data:`REGISTRY`; the scenario CLI
(``python -m repro_torch.scenarios``), the sweep driver and
``chip_smoke.py`` start there.  The registry holds the JAX package's seven
regimes with the same knobs, SLOs, tunables and budgets (its
``docs/scenarios.md`` and ``docs/CATALOG.md`` describe them); each run's
byte work goes to the device its :class:`ScenarioContext` names.
"""
from repro_torch.scenarios.registry import (
    REGISTRY,
    SLO,
    DuplicateScenarioError,
    Scenario,
    ScenarioError,
    SLOViolation,
    UnknownKnobError,
    UnknownScenarioError,
    register,
)
from repro_torch.scenarios.runner import (
    ScenarioContext,
    ScenarioResult,
    run_scenario,
)
from repro_torch.scenarios.sweep import (
    EvalPoint,
    KnobAxis,
    ScenarioProblem,
    TuneResult,
)

__all__ = [
    "REGISTRY", "SLO", "Scenario", "ScenarioError", "SLOViolation",
    "DuplicateScenarioError", "UnknownScenarioError", "UnknownKnobError",
    "register", "ScenarioContext", "ScenarioResult", "run_scenario",
    "KnobAxis", "ScenarioProblem", "EvalPoint", "TuneResult",
    "load_builtin",
]

_LOADED = False


def load_builtin() -> None:
    """Import the built-in scenario modules (idempotent)."""
    global _LOADED
    if _LOADED:
        return
    from repro_torch.scenarios import serving  # noqa: F401
    from repro_torch.scenarios import engine  # noqa: F401
    _LOADED = True
