"""Knob-space search over registered scenarios: sweeps and hill-climbs.

The optimiser treats a scenario as a black-box objective: a
:class:`ScenarioProblem` names the scenario, the knob axes to search
(discrete candidate lists — serving knobs are budgets, policies, and
deadlines, not smooth surfaces), a dotted metric path to maximize (or
minimize), and uses the scenario's *declared SLOs* as the feasibility
constraints — "max goodput s.t. p99 <= SLO".  An infeasible point scores
``-inf`` (or ``+inf`` when minimizing), so the search can traverse
infeasible regions without ever selecting one.

Every evaluation runs headless through ``run_scenario(emit=False,
raise_on_violation=False)`` — searched points never clobber the canonical
BENCH section — and must carry the deterministic replay digest in its
payload: an :class:`EvalPoint` is reproducible bit-for-bit from
(scenario, knobs, seed), which is what makes a tuning result a citable
artifact rather than a lucky wall-clock.  Evaluations are memoized on
the knob assignment, so revisiting a point during coordinate descent is
free and the reported evaluation count is the number of *distinct*
configs run.

Two drivers:

* :meth:`ScenarioProblem.sweep` — the full cartesian grid (or any
  explicit list of points).  Exhaustive, embarrassingly parallel in
  principle, exponential in axes: for final figures.
* :meth:`ScenarioProblem.hill_climb` — cyclic coordinate descent over
  the axes: hold all knobs, try every candidate on one axis, keep the
  argmax, move to the next axis, repeat until a full cycle improves
  nothing.  Converges in O(axes x candidates x cycles) evaluations and
  is exactly the right shape for serving knobs, whose conditional
  structure (shed deadline only matters once the fetch budget binds) is
  mostly separable.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Mapping, Sequence

from repro_torch.scenarios.registry import REGISTRY, Scenario, ScenarioError
from repro_torch.scenarios.runner import run_scenario


class SearchError(ScenarioError):
    pass


@dataclasses.dataclass(frozen=True)
class KnobAxis:
    """One searched dimension: a ``ShelbyConfig`` field name and the
    discrete candidate values to try (include the default explicitly if
    the search should be able to keep it)."""

    name: str
    candidates: tuple

    def __post_init__(self):
        if not self.candidates:
            raise SearchError(f"axis {self.name!r} has no candidates")


@dataclasses.dataclass(frozen=True)
class EvalPoint:
    """One evaluated knob assignment: its objective value, feasibility
    (every declared SLO honored), the SLO messages when not, and the
    replay digest that makes the number reproducible."""

    knobs: Mapping[str, object]
    value: float
    feasible: bool
    violations: tuple[str, ...]
    digest: str | None
    payload: Mapping

    def score(self, maximize: bool) -> float:
        """Feasible points compare on the objective; infeasible points
        always lose (but remain in the history for the writeup)."""
        if not self.feasible:
            return -math.inf if maximize else math.inf
        return self.value

    def summary(self) -> dict:
        return {
            "knobs": dict(self.knobs),
            "value": self.value,
            "feasible": self.feasible,
            "violations": list(self.violations),
            "digest": self.digest,
        }


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """What a driver returns: the winning point, the full evaluation
    history in evaluation order, and the baseline (all-default) point
    for the improvement claim."""

    problem: "ScenarioProblem"
    best: EvalPoint
    baseline: EvalPoint
    history: tuple[EvalPoint, ...]

    @property
    def improved(self) -> bool:
        m = self.problem.maximize
        return self.best.score(m) > self.baseline.score(m)

    def to_json(self) -> dict:
        return {
            "scenario": self.problem.scenario.name,
            "objective": self.problem.objective,
            "maximize": self.problem.maximize,
            "axes": {a.name: list(a.candidates) for a in self.problem.axes},
            "evaluations": len(self.history),
            "baseline": self.baseline.summary(),
            "best": self.best.summary(),
            "improved": self.improved,
            "history": [p.summary() for p in self.history],
        }

    def dump(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")


def _freeze(knobs: Mapping[str, object]) -> tuple:
    return tuple(sorted(knobs.items()))


class ScenarioProblem:
    """max (or min) ``objective`` over the axes' cartesian knob space,
    subject to the scenario's declared SLOs."""

    def __init__(self, scenario: str | Scenario, axes: Sequence[KnobAxis],
                 objective: str, *, maximize: bool = True,
                 smoke: bool | None = None, verbose: bool = True,
                 device=None):
        self.scenario = (scenario if isinstance(scenario, Scenario)
                         else REGISTRY.get(scenario))
        if not axes:
            raise SearchError("no axes to search")
        names = [a.name for a in axes]
        if len(set(names)) != len(names):
            raise SearchError(f"duplicate axes: {names}")
        # axis names are validated as real knobs the same way scenario
        # registration validates its overrides — a typo fails here, not
        # after an hour of evaluations
        from repro_torch.scenarios.registry import validate_knobs
        validate_knobs({n: None for n in names},
                       where=f"problem over {self.scenario.name!r}")
        self.axes = tuple(axes)
        self.objective = objective
        self.maximize = maximize
        self.smoke = smoke
        self.verbose = verbose
        self.device = device  # of every evaluation's layouts (None: the card)
        self._memo: dict[tuple, EvalPoint] = {}
        self.history: list[EvalPoint] = []

    # -- objective -----------------------------------------------------------

    def evaluate(self, knobs: Mapping[str, object]) -> EvalPoint:
        """Run the scenario at one knob assignment (memoized)."""
        key = _freeze(knobs)
        if key in self._memo:
            return self._memo[key]
        result = run_scenario(self.scenario, overrides=dict(knobs),
                              smoke=self.smoke, emit=False,
                              raise_on_violation=False, device=self.device)
        from repro_torch.scenarios.report import metric_path
        value = float(metric_path(result.payload, self.objective))
        violations = tuple(r.message() for r in result.slo_results if not r.ok)
        digest = result.digest
        if digest is None:
            raise SearchError(
                f"scenario {self.scenario.name!r} payload carries no "
                f"'digest' — sweep evaluations must be replay-reproducible"
            )
        point = EvalPoint(knobs=dict(knobs), value=value,
                          feasible=not violations, violations=violations,
                          digest=digest, payload=result.payload)
        self._memo[key] = point
        self.history.append(point)
        if self.verbose:
            status = "ok" if point.feasible else "INFEASIBLE"
            print(f"# eval[{self.scenario.name}] {dict(knobs)} -> "
                  f"{self.objective}={value:.4g} [{status}] "
                  f"digest={digest}")
        return point

    def baseline(self) -> EvalPoint:
        """The all-default point: the scenario's registered knobs with no
        overrides — what the improvement claim is measured against."""
        return self.evaluate({})

    # -- drivers -------------------------------------------------------------

    def _best(self, points: Sequence[EvalPoint]) -> EvalPoint:
        return max(points, key=lambda p: (p.score(self.maximize)
                                          if self.maximize
                                          else -p.score(self.maximize)))

    def sweep(self) -> TuneResult:
        """Exhaustive cartesian grid over the axes."""
        base = self.baseline()
        assignments = [{}]
        for axis in self.axes:
            assignments = [dict(a, **{axis.name: c})
                           for a in assignments for c in axis.candidates]
        points = [self.evaluate(a) for a in assignments]
        return TuneResult(problem=self, best=self._best(points + [base]),
                          baseline=base, history=tuple(self.history))

    def hill_climb(self, start: Mapping[str, object] | None = None,
                   max_cycles: int = 4) -> TuneResult:
        """Cyclic coordinate descent from ``start`` (default: the first
        candidate on every axis).  Each step holds every other knob and
        takes the argmax over one axis' candidates; a full cycle with no
        improvement terminates."""
        current = dict(start) if start is not None else {
            a.name: a.candidates[0] for a in self.axes
        }
        missing = [a.name for a in self.axes if a.name not in current]
        if missing:
            raise SearchError(f"start point missing axes: {missing}")
        base = self.baseline()
        best = self.evaluate(current)
        for _ in range(max_cycles):
            improved = False
            for axis in self.axes:
                trials = [self.evaluate(dict(best.knobs, **{axis.name: c}))
                          for c in axis.candidates]
                cand = self._best(trials + [best])
                if cand.score(self.maximize) > best.score(self.maximize) or (
                        not best.feasible and cand.feasible):
                    improved = improved or cand.knobs != best.knobs
                    best = cand
            if not improved:
                break
        return TuneResult(problem=self, best=self._best([best, base]),
                          baseline=base, history=tuple(self.history))
