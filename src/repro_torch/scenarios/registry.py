"""The scenario registry: one declarative entry per serving regime.

A :class:`Scenario` names everything a regime needs to run headless —
the builder/workload callable, the knob overrides it applies on top of
``configs/shelby.py`` defaults, the SLOs it asserts, the BENCH section
it emits, and its CI smoke budget.  The :class:`ScenarioRegistry` maps
name -> Scenario with duplicate-name and unknown-knob rejection at
registration time, so a typo'd knob fails the import, not a CI smoke
three layers deep.

Knob resolution order (lowest to highest precedence):

    ShelbyConfig defaults  <  scenario.knobs  <  call-time overrides

Call-time overrides are how the sweep driver (``scenarios/sweep.py``)
searches knob space; every layer is validated against the dataclass
fields of ``ShelbyConfig`` and rejected with :class:`UnknownKnobError`
otherwise.

SLOs are declarative so the catalog generator and the optimiser can read
them without running anything: a dotted metric path into the scenario's
emitted payload, a comparison, and a bound that is a literal number, a
config-knob name (resolved against the scenario's *resolved* config, so
a sweep that moves the knob moves the bound), or another metric path.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Callable, Mapping

from repro_torch.configs.shelby import CONFIG, ShelbyConfig
from repro_torch.scenarios.report import metric_path


class ScenarioError(Exception):
    """Base for registry misuse (bad names, bad knobs)."""


class DuplicateScenarioError(ScenarioError):
    pass


class UnknownScenarioError(ScenarioError):
    pass


class UnknownKnobError(ScenarioError):
    pass


class SLOViolation(AssertionError):
    """An asserted SLO failed.  Subclasses AssertionError so benchmark
    harnesses and CI treat it exactly like the historical inline
    asserts — but the message always leads with the scenario name."""


_KNOB_FIELDS = frozenset(f.name for f in dataclasses.fields(ShelbyConfig))

_OPS = {
    "<=": operator.le,
    "<": operator.lt,
    ">=": operator.ge,
    ">": operator.gt,
}


def validate_knobs(knobs: Mapping[str, object], *, where: str) -> None:
    """Reject any key that is not a ``ShelbyConfig`` dataclass field."""
    unknown = sorted(set(knobs) - _KNOB_FIELDS)
    if unknown:
        raise UnknownKnobError(
            f"{where}: unknown knob(s) {unknown} — not fields of "
            f"ShelbyConfig (see configs/shelby.py KNOB_DOCS)"
        )


def resolve_config(
    scenario_knobs: Mapping[str, object] | None = None,
    overrides: Mapping[str, object] | None = None,
    *,
    base: ShelbyConfig = CONFIG,
    where: str = "resolve_config",
) -> ShelbyConfig:
    """Layer knob dicts onto the base config, later layers winning:
    defaults < scenario.knobs < overrides.  Every layer is validated."""
    merged: dict[str, object] = {}
    for layer in (scenario_knobs, overrides):
        if layer:
            validate_knobs(layer, where=where)
            merged.update(layer)
    return dataclasses.replace(base, **merged) if merged else base


@dataclasses.dataclass(frozen=True)
class SLO:
    """One asserted service-level objective, evaluable from the
    scenario's emitted metrics payload alone.

    ``metric`` is a dotted path into the payload.  ``bound`` is a
    literal number, the name of a ``ShelbyConfig`` knob (resolved
    against the scenario's resolved config), or another dotted metric
    path.  ``atol`` is absolute slack on the comparison (ratio metrics
    near tiny denominators need a little)."""

    metric: str
    op: str
    bound: float | int | str
    atol: float = 0.0
    description: str = ""

    def __post_init__(self):
        if self.op not in _OPS:
            raise ScenarioError(
                f"SLO op must be one of {sorted(_OPS)}, got {self.op!r}"
            )

    def resolve_bound(self, payload, config: ShelbyConfig) -> float:
        if isinstance(self.bound, (int, float)):
            return float(self.bound)
        if self.bound in _KNOB_FIELDS:
            return float(getattr(config, self.bound))
        return float(metric_path(payload, self.bound))

    def check(self, payload, config: ShelbyConfig) -> "SLOResult":
        value = float(metric_path(payload, self.metric))
        bound = self.resolve_bound(payload, config)
        slack = self.atol if self.op in ("<=", "<") else -self.atol
        ok = bool(_OPS[self.op](value, bound + slack))
        return SLOResult(slo=self, value=value, bound=bound, ok=ok)

    def describe(self) -> str:
        return f"{self.metric} {self.op} {self.bound}"


@dataclasses.dataclass(frozen=True)
class SLOResult:
    slo: SLO
    value: float
    bound: float
    ok: bool

    def message(self) -> str:
        status = "OK" if self.ok else "VIOLATED"
        return (f"{self.slo.metric} = {self.value:.4g} {self.slo.op} "
                f"{self.bound:.4g} [{status}]")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One registry entry: everything needed to run a named regime
    headless, assert its SLOs, and emit its BENCH section."""

    name: str
    description: str
    workload: str                       # one line for the catalog
    section: str                        # BENCH_backbone.json section key
    run: Callable                       # (ScenarioContext) -> metrics dict
    knobs: Mapping[str, object] = dataclasses.field(default_factory=dict)
    slos: tuple[SLO, ...] = ()
    tunable: tuple[str, ...] = ()       # knobs a sweep typically searches
    headline: tuple[str, ...] = ()      # payload paths the catalog quotes
    budget_s: int = 180                 # CI smoke wall budget (seconds)

    def __post_init__(self):
        validate_knobs(self.knobs, where=f"scenario {self.name!r} knobs")
        validate_knobs({k: None for k in self.tunable},
                       where=f"scenario {self.name!r} tunable")

    def config(self, overrides: Mapping[str, object] | None = None,
               *, base: ShelbyConfig = CONFIG) -> ShelbyConfig:
        """The resolved config this scenario runs under (plus optional
        call-time overrides — the sweep driver's entry point)."""
        return resolve_config(self.knobs, overrides, base=base,
                              where=f"scenario {self.name!r}")


class ScenarioRegistry:
    """Name -> Scenario, insertion-ordered, duplicate-rejecting."""

    def __init__(self):
        self._scenarios: dict[str, Scenario] = {}

    def register(self, scenario: Scenario) -> Scenario:
        if scenario.name in self._scenarios:
            raise DuplicateScenarioError(
                f"scenario {scenario.name!r} already registered"
            )
        self._scenarios[scenario.name] = scenario
        return scenario

    def get(self, name: str) -> Scenario:
        try:
            return self._scenarios[name]
        except KeyError:
            raise UnknownScenarioError(
                f"no scenario {name!r}; registered: {self.names()}"
            ) from None

    def names(self) -> list[str]:
        return list(self._scenarios)

    def __iter__(self):
        return iter(self._scenarios.values())

    def __contains__(self, name: str) -> bool:
        return name in self._scenarios

    def __len__(self) -> int:
        return len(self._scenarios)


REGISTRY = ScenarioRegistry()


def register(**kwargs) -> Scenario:
    """Build a Scenario from kwargs and add it to the module registry."""
    return REGISTRY.register(Scenario(**kwargs))
