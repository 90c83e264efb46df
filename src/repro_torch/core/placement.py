"""Chunk placement (§2.5): randomized, failure-domain-aware assignment.

"The smart contract randomly assigns Chunks to SPs" — with the Appendix-A
availability model in mind we spread the n chunks of each chunkset across as
many distinct (datacenter, rack) failure domains as the SP set allows, and we
randomize *within* that constraint using the contract's verifiable
randomness (so no SP controls which data it can censor — Appendix A).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from collections import Counter

import numpy as np


@dataclasses.dataclass(frozen=True)
class SPInfo:
    sp_id: int
    stake: float
    dc: str = "dc0"
    rack: str = "r0"
    capacity_chunks: int = 1 << 30


def _rng(seed: bytes, *tags) -> np.random.Generator:
    h = hashlib.sha256(seed + b"|" + b"|".join(str(t).encode() for t in tags)).digest()
    return np.random.default_rng(np.frombuffer(h[:8], dtype=np.uint64)[0])


def assign_chunkset(
    seed: bytes,
    blob_id: int,
    chunkset: int,
    sps: list[SPInfo],
    n: int,
    used: dict[int, int] | None = None,
) -> list[int]:
    """Assign the n chunks of one chunkset to n distinct SPs.

    Greedy spread: iterate domains (dc, then rack) round-robin in a seeded
    random order, skipping SPs that are at capacity.  Raises if fewer than n
    SPs have room (the contract rejects the write — §2.5).
    """
    used = used or {}
    rng = _rng(seed, blob_id, chunkset)
    eligible = [s for s in sps if used.get(s.sp_id, 0) < s.capacity_chunks]
    if len(eligible) < n:
        raise ValueError(f"placement needs {n} SPs, only {len(eligible)} eligible")

    # two-level spread: round-robin across DCs first, racks within a DC
    by_dc: dict[str, list[SPInfo]] = {}
    for s in eligible:
        by_dc.setdefault(s.dc, []).append(s)
    dcs = list(by_dc)
    rng.shuffle(dcs)
    for dc in dcs:
        # within a DC, interleave racks (randomized) for rack-level spread
        by_rack: dict[str, list[SPInfo]] = {}
        for s in by_dc[dc]:
            by_rack.setdefault(s.rack, []).append(s)
        racks = list(by_rack)
        rng.shuffle(racks)
        for r in racks:
            rng.shuffle(by_rack[r])
        ordered = []
        for layer in itertools.count():
            got = False
            for r in racks:
                if layer < len(by_rack[r]):
                    ordered.append(by_rack[r][layer])
                    got = True
            if not got:
                break
        by_dc[dc] = ordered

    picked: list[int] = []
    for layer in itertools.count():
        progressed = False
        for dc in dcs:
            if len(picked) == n:
                return picked
            if layer < len(by_dc[dc]):
                picked.append(by_dc[dc][layer].sp_id)
                progressed = True
        if not progressed:
            break
    assert len(picked) == n
    return picked


def replacement_sp(
    seed: bytes,
    blob_id: int,
    chunkset: int,
    chunk: int,
    candidates: list[SPInfo],
    holders: list[SPInfo],
) -> int | None:
    """Pick ONE replacement SP for a chunk displaced by churn.

    Same failure-domain objective as :func:`assign_chunkset`, applied
    incrementally: among `candidates` (already filtered to live non-holders)
    prefer SPs whose datacenter — then rack — holds the fewest of the
    chunkset's surviving chunks, breaking ties with the contract's seeded
    randomness so no SP controls where displaced data lands.  Returns
    ``None`` when no candidate exists (the chunk stays on its dead SP until
    the fleet grows — the "unplaced" backlog).
    """
    if not candidates:
        return None
    rng = _rng(seed, b"reassign", blob_id, chunkset, chunk)
    dc_load = Counter(h.dc for h in holders)
    rack_load = Counter((h.dc, h.rack) for h in holders)
    order = [int(i) for i in rng.permutation(len(candidates))]
    best = min(
        order,
        key=lambda i: (dc_load[candidates[i].dc],
                       rack_load[(candidates[i].dc, candidates[i].rack)]),
    )
    return candidates[best].sp_id
