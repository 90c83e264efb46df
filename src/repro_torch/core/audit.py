"""Hybrid audit protocol (§4): internal audits + on-chain audit-the-auditor.

Three cooperating pieces:

1. **Challenge derivation** — publicly verifiable randomness (an epoch seed
   from the coordination layer) deterministically maps to (auditee, chunk,
   sample, auditors) tuples, so every honest party derives the same schedule.
2. **Scoreboards + BFT aggregation** (§4.1/§4.3) — each SP keeps an
   (n-1)-row bit-vector scoreboard of its peers' audit outcomes; epoch close
   aggregates per-auditee columns with a *trimmed mean* (drop top f and
   bottom f evaluations, f = floor((n-1)/3)) so Byzantine raters cannot move
   an honest SP's score outside the honest range.
3. **On-chain layer** (§4.2) — auditees with low scores get
   ``ceil((1 - score^2) * C)`` direct challenges; every published '1' entry
   is re-verified with probability ``p_ata`` (audit-the-auditor); failures
   slash; peer-submitted invalid-proof evidence slashes and rewards the
   reporter.

The module is deliberately free of I/O: the smart-contract sim
(``contract.py``) and the storage nodes (``storage/sp.py``) drive it, and the
game-theoretic property tests (``tests/test_audit_ic.py``) instantiate it
with adversarial strategies.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


# ---------------------------------------------------------------------------
# challenge derivation (publicly verifiable randomness -> schedule)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Challenge:
    epoch: int
    auditee: int  # SP id
    blob_id: int
    chunkset: int
    chunk: int  # real chunk index within chunkset
    sample: int  # sample index within chunk
    auditors: tuple[int, ...]  # SP ids assigned to verify the broadcast proof


def _rng_from(seed: bytes, *tags) -> np.random.Generator:
    h = hashlib.sha256(seed + b"|" + b"|".join(str(t).encode() for t in tags)).digest()
    return np.random.default_rng(np.frombuffer(h[:8], dtype=np.uint64)[0])


def derive_challenges(
    epoch_seed: bytes,
    epoch: int,
    holdings: list[tuple[int, int, int, int, int]],  # (sp, blob, chunkset, chunk, num_samples)
    sp_ids: list[int],
    p_a: float,
    auditors_per_audit: int,
) -> list[Challenge]:
    """Each stored chunk is challenged i.i.d. w.p. ``p_a`` per epoch (§4.1)."""
    out = []
    for sp, blob, cs, ck, nsamp in holdings:
        rng = _rng_from(epoch_seed, epoch, sp, blob, cs, ck)
        if rng.random() >= p_a:
            continue
        sample = int(rng.integers(nsamp))
        pool = [s for s in sp_ids if s != sp]
        k = min(auditors_per_audit, len(pool))
        auditors = tuple(int(x) for x in rng.choice(pool, size=k, replace=False))
        out.append(Challenge(epoch, sp, blob, cs, ck, sample, auditors))
    return out


# ---------------------------------------------------------------------------
# scoreboards
# ---------------------------------------------------------------------------
class Scoreboard:
    """One auditor's per-epoch record: auditee -> list of 0/1 outcomes.

    Published on-chain at epoch end; §4.1 notes the bit vectors are highly
    regular — ``packed()`` returns the compressed submission and its size so
    benchmarks can report the on-chain footprint.
    """

    def __init__(self, owner: int):
        self.owner = owner
        self.bits: dict[int, list[int]] = {}

    def record(self, auditee: int, ok: bool):
        self.bits.setdefault(auditee, []).append(1 if ok else 0)

    def ones(self) -> list[tuple[int, int]]:
        """(auditee, position) of every claimed success."""
        return [(a, i) for a, v in self.bits.items() for i, b in enumerate(v) if b == 1]

    def packed(self) -> tuple[bytes, int]:
        """Compressed on-chain form (run-length of the regular bit vectors)."""
        payload = bytearray()
        for auditee in sorted(self.bits):
            vec = np.asarray(self.bits[auditee], dtype=np.uint8)
            packed = np.packbits(vec).tobytes()
            payload += auditee.to_bytes(4, "little") + len(vec).to_bytes(4, "little") + packed
        raw = bytes(payload)
        return raw, len(raw)


def trim_f(num_evaluators: int) -> int:
    """f = floor((n-1)/3): max Byzantine raters tolerated (§4.3)."""
    return num_evaluators // 3


def aggregate_scores(
    per_auditor_rates: dict[int, dict[int, float]],
    sp_ids: list[int],
) -> dict[int, float]:
    """Trimmed-mean audit score per SP (§4.1/§4.3).

    per_auditor_rates[auditor][auditee] = fraction of that auditee's
    challenges the auditor observed as successful (missing '1' counts 0 —
    an auditor that saw no challenge for an auditee simply has no entry).
    SPs never rate themselves.  SPs with no evaluations score 1.0 (nothing
    was asked of them).
    """
    scores: dict[int, float] = {}
    for j in sp_ids:
        evals = [
            rates[j]
            for auditor, rates in per_auditor_rates.items()
            if auditor != j and j in rates
        ]
        if not evals:
            scores[j] = 1.0
            continue
        evals.sort()
        f = trim_f(len(evals))
        kept = evals[f : len(evals) - f] if len(evals) > 2 * f else evals
        scores[j] = float(np.mean(kept))
    return scores


# ---------------------------------------------------------------------------
# on-chain layer (§4.2)
# ---------------------------------------------------------------------------
def num_auditee_challenges(score: float, C: int) -> int:
    """(1 - score^2) * C — the quadratic scrutiny schedule."""
    return int(np.ceil((1.0 - score**2) * C))


def select_ata_entries(
    epoch_seed: bytes, epoch: int, auditor: int, ones: list[tuple[int, int]], p_ata: float
) -> list[tuple[int, int]]:
    """Sample the '1' entries the auditor must re-prove on-chain."""
    out = []
    for auditee, pos in ones:
        rng = _rng_from(epoch_seed, b"ata", epoch, auditor, auditee, pos)
        if rng.random() < p_ata:
            out.append((auditee, pos))
    return out


@dataclasses.dataclass
class EpochOutcome:
    scores: dict[int, float]
    storage_rewards: dict[int, float]
    auditor_rewards: dict[int, float]
    slashed: dict[int, float]
    onchain_challenges: dict[int, int]
    evidence_rewards: dict[int, float]
    # on-chain publication fees: gas debited per auditor for landing its
    # packed scoreboard bytes on the coordination layer (§4.3 cost story)
    publish_costs: dict[int, float] = dataclasses.field(default_factory=dict)

    def utility(self, sp: int) -> float:
        return (
            self.storage_rewards.get(sp, 0.0)
            + self.auditor_rewards.get(sp, 0.0)
            + self.evidence_rewards.get(sp, 0.0)
            - self.slashed.get(sp, 0.0)
            - self.publish_costs.get(sp, 0.0)
        )


@dataclasses.dataclass(frozen=True)
class AuditParams:
    """Calibration knobs; defaults satisfy every §5.4 inequality (validated
    in tests/test_audit_ic.py)."""

    p_a: float = 0.05  # per-epoch chunk audit probability
    auditors_per_audit: int = 4
    C: int = 50  # on-chain challenge budget scale
    p_ata: float = 0.02  # audit-the-auditor sampling rate
    eps: float = 0.01  # auditor certainty threshold
    rwd_st_per_chunk: float = 1.0  # storage reward / chunk / epoch
    rwd_au: float = 0.01  # per successful reported audit
    S_a: float = 2000.0  # slash: failed on-chain storage audit
    S_ata: float = 100.0  # slash: failed audit-the-auditor (>= rwd_au/(p_ata*eps)=50)
    r_slash: float = 5.0  # reporter's share for valid evidence
    proof_retention_epochs: int = 2
    # gas per packed scoreboard byte at publication (§4.3: submissions are
    # "highly regular" and cheap — a fee small enough that honest auditing
    # stays profitable, but real enough that the §5.4 inequalities hold NET
    # of publication; rwd_au=0.01/report vs ~10 packed bytes/report here)
    gas_per_scoreboard_byte: float = 1e-4
