"""Closed-form economics from §5 ("Economic Opportunity") + §5.4.

Every inequality the paper states as a design constraint is a function here,
so the parameter calibration is executable and testable against the paper's
own numerical examples:

* Lemma 1 bound:            p_a >= c_s / c_r
* AWS-number instantiation: p_a >= 0.0076 / day (k = 5 helper reads)
* on-chain detection:       P_Sa >= 1 - (1-pf)^((1-(1-pf)^2) * C)   (> 0.63
                            at pf = 0.1, C = 50)
* audit-the-auditor:        S_ata >= rwd_au / (p_ata * eps)
* fee normalization:        rwd_st + n_a * rwd_au = W
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Reference costs (defaults = the paper's AWS S3 numbers, §5.4)."""

    storage_per_mb_day: float = 0.023 / 1024 / 30  # $0.023/GB/mo ~ 7.7e-7/MB/day
    read_per_mb: float = 0.02 / 1024  # $0.02/GB ~ 2e-5/MB
    k_reads_for_repair: int = 5  # ">= k = 5 distinct Chunks to read"


def min_audit_probability(costs: CostModel, chunk_mb: float = 1.0) -> float:
    """Lemma 1 / §5.4: smallest per-day audit probability making
    delete-and-refetch irrational:  p_a >= c_s / c_r."""
    c_s = costs.storage_per_mb_day * chunk_mb
    c_r = costs.k_reads_for_repair * costs.read_per_mb * chunk_mb
    return c_s / c_r


def retrieval_strategy_cost(p_a: float, costs: CostModel, chunk_mb: float = 1.0) -> float:
    """Expected per-day cost of the deviant delete-and-refetch strategy."""
    return p_a * costs.k_reads_for_repair * costs.read_per_mb * chunk_mb


def storage_strategy_cost(costs: CostModel, chunk_mb: float = 1.0) -> float:
    return costs.storage_per_mb_day * chunk_mb


def expected_onchain_samples(prct_fake: float, C: int) -> float:
    """§5.4(3): expected on-chain sample size for score = 1 - prct_fake."""
    score = 1.0 - prct_fake
    return (1.0 - score**2) * C


def detection_probability(prct_fake: float, C: int) -> float:
    """§5.4(3): P_Sa >= 1 - (1 - pf)^samples  (sampling w/o replacement bound)."""
    if prct_fake <= 0:
        return 0.0
    samples = expected_onchain_samples(prct_fake, C)
    return 1.0 - (1.0 - prct_fake) ** samples


def fake_storage_slashing_bound(
    p_a: float, rwd_st: float, prct_fake: float, total_committed: float, C: int
) -> float:
    """Minimum slashing penalty S_a so faking `prct_fake` is irrational:
    P_Sa * S_a > (1 - p_a) * rwd_st * prct_fake * total_committed."""
    p_det = detection_probability(prct_fake, C)
    rhs = (1.0 - p_a) * rwd_st * prct_fake * total_committed
    return rhs / max(p_det, 1e-12)


def min_ata_slashing(rwd_au: float, p_ata: float, eps: float) -> float:
    """§4.4 / §5.4(4): S_ata >= rwd_au / (p_ata * eps)."""
    return rwd_au / (p_ata * eps)


def fee_split(W: float, n_a: float, rwd_au: float) -> float:
    """§5.1: rwd_st from  rwd_st + n_a * rwd_au = W  (per GB per month)."""
    rwd_st = W - n_a * rwd_au
    if rwd_st < 0:
        raise ValueError("audit rewards exceed the storage fee")
    return rwd_st


def audits_per_gb_month(
    p_a_per_epoch: float, chunks_per_gb: float, auditors_per_audit: int, epochs_per_month: float
) -> float:
    """§5.1: n_a = (p_a * chunks/GB) * auditors-per-audit * epochs/month."""
    return p_a_per_epoch * chunks_per_gb * auditors_per_audit * epochs_per_month
