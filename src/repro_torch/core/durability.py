"""Durability & availability closed forms (paper Appendix A).

Reproduces the paper's worked example exactly:

    P(data loss) ~= (16 * 0.50) * C(15,6) * (0.50 * (24+12)/8760)^6
                 ~= 3.01e-12                    (11+ nines durability)

    P(unavail)   ~= P(loss) + 30/525600 + P(<3 of 5 DCs online)
                 ~= 1.35e-4                     (~3 nines availability)

plus general-form functions used by the repair planner and the SP failure
injector (drive/host/rack/DC failure rates from the appendix).
"""
from __future__ import annotations

import dataclasses
import math

HOURS_PER_YEAR = 8760
MINUTES_PER_YEAR = 525_600


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Appendix-A hardware failure assumptions."""

    drive_afr: float = 0.02  # 2 %/yr
    latent_sector_lifetime: float = 0.0345  # 3.45 % of drives, lifetime
    host_afr: float = 0.03  # 1-5 %/yr
    rack_afr: float = 0.05  # availability only
    dc_afr: float = 0.02  # availability only
    systemic_events_per_year: float = 1.0
    systemic_mttr_minutes: float = 30.0


@dataclasses.dataclass(frozen=True)
class DurabilityParams:
    """The appendix's worked example for a (10, 6) code."""

    k: int = 10
    m: int = 6
    chunk_loss_prob: float = 0.50  # "nodes have a (very high) 50% likelihood"
    mttd_hours: float = 24.0
    mttr_hours: float = 12.0

    @property
    def n(self) -> int:
        return self.k + self.m


def p_data_loss(p: DurabilityParams) -> float:
    """Appendix A: first trigger * P(m more of remaining n-1 inside T_crit)."""
    t_crit = (p.mttd_hours + p.mttr_hours) / HOURS_PER_YEAR
    per_node = p.chunk_loss_prob * t_crit
    trigger = p.n * p.chunk_loss_prob
    return trigger * math.comb(p.n - 1, p.m) * per_node**p.m


def durability_nines(p: DurabilityParams) -> float:
    return -math.log10(p_data_loss(p))


def p_fewer_than_k_dcs(num_dcs: int = 5, dc_uptime: float = 0.98, need: int = 3) -> float:
    """P(< `need` of `num_dcs` online), iid uptime."""
    p_ok = 0.0
    for up in range(need, num_dcs + 1):
        p_ok += math.comb(num_dcs, up) * dc_uptime**up * (1 - dc_uptime) ** (num_dcs - up)
    return 1.0 - p_ok


def p_unavailable(
    p: DurabilityParams,
    num_dcs: int = 5,
    dc_uptime: float = 0.98,
    need_dcs: int = 3,
    systemic_minutes: float = 30.0,
) -> float:
    return (
        p_data_loss(p)
        + systemic_minutes / MINUTES_PER_YEAR
        + p_fewer_than_k_dcs(num_dcs, dc_uptime, need_dcs)
    )


def availability(p: DurabilityParams, **kw) -> float:
    return 1.0 - p_unavailable(p, **kw)


# ---------------------------------------------------------------------------
# churn durability: measured series + analytic per-epoch reference
# ---------------------------------------------------------------------------
def p_chunkset_loss_per_epoch(n: int, k: int, p_node_loss: float) -> float:
    """Analytic per-epoch chunkset-loss probability under iid node churn.

    A chunkset with an (n, k) code dies in an epoch when MORE than n-k of
    its n holders are lost before repair: the binomial tail
    ``sum_{j=m+1..n} C(n,j) p^j (1-p)^(n-j)`` with m = n-k.  This is the
    no-repair bound the *measured* series (a churned simulation with the
    re-dispersal backlog racing the failures) is compared against.
    """
    if not 0.0 <= p_node_loss <= 1.0:
        raise ValueError("p_node_loss must be a probability")
    m = n - k
    return sum(
        math.comb(n, j) * p_node_loss**j * (1.0 - p_node_loss) ** (n - j)
        for j in range(m + 1, n + 1)
    )


@dataclasses.dataclass(frozen=True)
class ChurnPoint:
    """One measured point of the lost-chunksets-vs-churn-rate curve.

    Produced by running a seeded churn process against a real simulated
    world (``repro_torch.storage.membership.measure_durability``) and *counting*
    chunksets that fell below k live holders — not by evaluating a formula.
    ``analytic_no_repair`` carries the matching closed-form tail for the
    same (n, k, rate) so benchmarks can plot measured vs analytic.
    """

    churn_rate: float  # per-SP per-epoch loss probability driven
    epochs: int
    seeds: int
    chunksets: int  # total chunksets exposed across all runs
    lost: int  # chunksets measured below k live holders
    analytic_no_repair: float = 0.0

    @property
    def loss_probability(self) -> float:
        return self.lost / self.chunksets if self.chunksets else 0.0


def measured_loss_series(points: list[ChurnPoint]) -> dict:
    """JSON-shaped summary of a measured churn sweep (benchmark emission)."""
    return {
        "churn_rates": [p.churn_rate for p in points],
        "loss_probability": [p.loss_probability for p in points],
        "lost": [p.lost for p in points],
        "chunksets": [p.chunksets for p in points],
        "analytic_no_repair": [p.analytic_no_repair for p in points],
    }
