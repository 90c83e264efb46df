"""The Shelby smart contract (coordination layer, §2.5) — simulated.

Owns exactly the state the paper assigns to it: SP/RPC participation, blob
metadata + lifecycle (PENDING -> READY -> EXPIRED), chunk placement, epoch
randomness, audit schedules, scoreboard submissions, on-chain verification,
slashing and reward settlement.  It never touches bulk data — only
commitments and proofs — preserving the control-plane/data-plane split that
the paper inherits from Web2 storage design.

Epoch randomness is a hash chain (a stand-in for Aptos's native randomness):
``seed(e+1) = H(seed(e))`` — deterministic, publicly derivable, and
unpredictable to SPs at commitment time in the real system.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
from collections import defaultdict

from repro_torch.core import audit as audit_mod
from repro_torch.core import commitments as cm
from repro_torch.core import placement as placement_mod
from repro_torch.core.audit import AuditParams, Challenge, EpochOutcome, Scoreboard
from repro_torch.core.placement import SPInfo


class BlobState(enum.Enum):
    PENDING = "pending"
    READY = "ready"
    EXPIRED = "expired"


@dataclasses.dataclass
class BlobMetadata:
    blob_id: int
    owner: str
    size_bytes: int
    num_chunksets: int
    n: int  # chunks per chunkset (erasure-coded)
    k: int
    blob_root: bytes
    chunkset_roots: list[bytes]
    chunk_roots: dict[tuple[int, int], bytes]  # (chunkset, chunk) -> root
    chunk_num_samples: dict[tuple[int, int], int]
    placement: dict[tuple[int, int], int]  # (chunkset, chunk) -> sp_id
    state: BlobState = BlobState.PENDING
    paid_epochs: int = 0


@dataclasses.dataclass(frozen=True)
class Reassignment:
    """One chunk remapped off a dead SP at an epoch boundary."""

    blob_id: int
    chunkset: int
    chunk: int
    old_sp: int
    new_sp: int


@dataclasses.dataclass(frozen=True)
class DASRecord:
    """On-chain record of a blob's 2-D DAS extension (see core/extend2d.py).

    Only the DAS root and the share placement live on chain — the row and
    column trees stay with the storage providers, who attach per-share
    Merkle paths to sampled reads.  ``proof_bytes`` is the fixed modeled
    wire size of one share proof (constant for a given ``side``), used by
    transports to bill proof bandwidth without shipping the object graph.
    """

    blob_id: int
    side: int  # 2k
    share_bytes: int
    das_root: bytes
    placement: dict[tuple[int, int], int]  # (row, col) -> sp_id
    proof_bytes: int


class ShelbyContract:
    """All critical state … recorded and enforced via the Shelby smart
    contract (§1)."""

    def __init__(self, params: AuditParams | None = None, genesis: bytes = b"shelby-genesis"):
        self.params = params or AuditParams()
        self._seed0 = hashlib.sha256(genesis).digest()
        self.sps: dict[int, SPInfo] = {}
        self.rpcs: set[str] = set()
        self.balances: dict[int, float] = defaultdict(float)
        self.stakes: dict[int, float] = {}
        self.blobs: dict[int, BlobMetadata] = {}
        self._next_blob = 0
        self.epoch = 0
        self.treasury = 0.0
        self.ejected: set[int] = set()
        # membership lifecycle (epoch reconfiguration): an SP that ANNOUNCES
        # departure keeps serving until the next epoch boundary finalizes it
        # into `departed`; both sets stay keyed in `sps`/`stakes` forever so
        # history (placement, channels, scores) still resolves
        self.departing: set[int] = set()
        self.departed: set[int] = set()
        # (blob_id, chunkset) -> bump count: incremented on every placement
        # remap so RPC hot caches can version-check entries cheaply instead
        # of re-reading the whole placement map
        self.placement_version: dict[tuple[int, int], int] = defaultdict(int)
        self.unplaced_chunks = 0  # displaced chunks no live SP could take
        # per-epoch submissions
        self._scoreboards: dict[int, dict[int, Scoreboard]] = defaultdict(dict)
        self.outcomes: dict[int, EpochOutcome] = {}
        # blob_id -> DAS extension record (data-availability sampling)
        self.das: dict[int, DASRecord] = {}

    # -- participation ---------------------------------------------------------
    def register_sp(self, info: SPInfo):
        if info.stake <= 0:
            raise ValueError("SP must stake")
        self.sps[info.sp_id] = info
        self.stakes[info.sp_id] = info.stake

    def register_rpc(self, rpc_id: str):
        self.rpcs.add(rpc_id)

    def register_das(self, record: DASRecord):
        """Publish a blob's DAS root + share placement (tiny: roots only)."""
        if record.blob_id not in self.blobs:
            raise KeyError(f"unknown blob {record.blob_id}")
        self.das[record.blob_id] = record

    def active_sps(self) -> list[SPInfo]:
        dead = self.ejected | self.departed
        return [s for i, s in sorted(self.sps.items()) if i not in dead]

    # -- membership lifecycle (epoch reconfiguration) ---------------------------
    def announce_departure(self, sp_id: int) -> None:
        """An SP signals intent to leave; it serves until the boundary."""
        if sp_id not in self.sps:
            raise KeyError(f"unknown SP {sp_id}")
        self.departing.add(sp_id)

    def finalize_departure(self, sp_id: int) -> None:
        """Epoch boundary: the SP is out of the active set for good."""
        if sp_id not in self.sps:
            raise KeyError(f"unknown SP {sp_id}")
        self.departing.discard(sp_id)
        self.departed.add(sp_id)

    def slash(self, sp_id: int, amount: float) -> bool:
        """Protocol-violation slashing entry (outside `close_epoch`, e.g. a
        membership plane ejecting a provably-misbehaving SP); the stake
        burns to the treasury.  Returns True when the SP was ejected."""
        burn = min(amount, max(self.stakes.get(sp_id, 0.0), 0.0))
        self.treasury += burn
        self._slash(sp_id, amount)
        return sp_id in self.ejected

    def dead_sps(self) -> set[int]:
        """SPs whose chunks need re-dispersal: ejected or departed."""
        return self.ejected | self.departed

    def reconfigure_epoch(
        self,
        epoch: int,
        extra_dead: set[int] | frozenset[int] = frozenset(),
        skip_chunksets: set[tuple[int, int]] | frozenset = frozenset(),
    ) -> list[Reassignment]:
        """Epoch-boundary reassignment: remap every READY placement entry
        sitting on a dead SP (ejected ∪ departed ∪ `extra_dead`, e.g.
        crashes detected this epoch) to a surviving/new SP, failure-domain
        aware and seeded by the epoch randomness.

        Only metadata moves here — the data itself is rebuilt by the repair
        backlog the caller enqueues from the returned list.  Chunksets in
        `skip_chunksets` ((blob_id, chunkset) keys, e.g. already counted as
        lost) are left untouched; a chunk with no eligible candidate stays
        put and is counted in ``unplaced_chunks``.  Every remap bumps the
        chunkset's ``placement_version`` so serving caches invalidate.
        """
        dead = self.dead_sps() | set(extra_dead)
        seed = self.epoch_seed(epoch)
        live = [s for s in self.active_sps() if s.sp_id not in dead]
        out: list[Reassignment] = []
        for blob_id in sorted(self.blobs):
            meta = self.blobs[blob_id]
            if meta.state is not BlobState.READY:
                continue
            for (cs, ck) in sorted(meta.placement):
                old_sp = meta.placement[(cs, ck)]
                if old_sp not in dead or (blob_id, cs) in skip_chunksets:
                    continue
                holders = {
                    meta.placement[(cs, c)]
                    for c in range(meta.n)
                    if (cs, c) in meta.placement
                }
                new_sp = placement_mod.replacement_sp(
                    seed, blob_id, cs, ck,
                    [s for s in live if s.sp_id not in holders],
                    [self.sps[h] for h in holders if h not in dead],
                )
                if new_sp is None:
                    self.unplaced_chunks += 1
                    continue
                meta.placement[(cs, ck)] = new_sp
                self.placement_version[(blob_id, cs)] += 1
                out.append(Reassignment(blob_id, cs, ck, old_sp, new_sp))
        return out

    # -- randomness --------------------------------------------------------------
    def epoch_seed(self, epoch: int) -> bytes:
        s = self._seed0
        for _ in range(epoch):
            s = hashlib.sha256(s).digest()
        return s

    # -- blob lifecycle (writes, §2.5) --------------------------------------------
    def begin_write(
        self,
        owner: str,
        size_bytes: int,
        n: int,
        k: int,
        blob_root: bytes,
        chunkset_roots: list[bytes],
        chunk_roots: dict[tuple[int, int], bytes],
        chunk_num_samples: dict[tuple[int, int], int],
        payment: float,
        epochs: int,
    ) -> BlobMetadata:
        """Client submits payment + commitments; contract assigns placement."""
        if payment <= 0 or epochs <= 0:
            raise ValueError("storage must be paid for a positive duration")
        blob_id = self._next_blob
        self._next_blob += 1
        placement: dict[tuple[int, int], int] = {}
        used: dict[int, int] = defaultdict(int)
        for key, sp in self._holdings_count().items():
            used[key] = sp
        sps = self.active_sps()
        for cs in range(len(chunkset_roots)):
            assigned = placement_mod.assign_chunkset(
                self.epoch_seed(self.epoch), blob_id, cs, sps, n, used
            )
            for ck, sp_id in enumerate(assigned):
                placement[(cs, ck)] = sp_id
                used[sp_id] += 1
        meta = BlobMetadata(
            blob_id=blob_id,
            owner=owner,
            size_bytes=size_bytes,
            num_chunksets=len(chunkset_roots),
            n=n,
            k=k,
            blob_root=blob_root,
            chunkset_roots=list(chunkset_roots),
            chunk_roots=dict(chunk_roots),
            chunk_num_samples=dict(chunk_num_samples),
            placement=placement,
        )
        self.blobs[blob_id] = meta
        self.treasury += payment
        meta.paid_epochs = epochs
        return meta

    def mark_ready(self, blob_id: int, rpc_id: str):
        if rpc_id not in self.rpcs:
            raise PermissionError("unknown RPC node")
        self.blobs[blob_id].state = BlobState.READY

    def reassign_chunk(self, blob_id: int, chunkset: int, chunk: int) -> int:
        """Move a chunk off an ejected/failed SP (repair placement)."""
        meta = self.blobs[blob_id]
        current = set(
            meta.placement[(chunkset, c)]
            for c in range(meta.n)
            if (chunkset, c) in meta.placement
        )
        candidates = [s for s in self.active_sps() if s.sp_id not in current]
        if not candidates:
            raise ValueError("no SP available for repair placement")
        rng = placement_mod._rng(self.epoch_seed(self.epoch), b"repair", blob_id, chunkset, chunk)
        new_sp = int(rng.choice([s.sp_id for s in candidates]))
        meta.placement[(chunkset, chunk)] = new_sp
        self.placement_version[(blob_id, chunkset)] += 1
        return new_sp

    # -- catalog (read path never mutates; RPCs mirror this locally, §5.2) --------
    def catalog(self) -> dict[int, BlobMetadata]:
        return dict(self.blobs)

    def _holdings_count(self) -> dict[int, int]:
        c: dict[int, int] = defaultdict(int)
        for meta in self.blobs.values():
            for sp in meta.placement.values():
                c[sp] += 1
        return c

    def holdings(self) -> list[tuple[int, int, int, int, int]]:
        """(sp, blob, chunkset, chunk, num_samples) for every READY chunk."""
        out = []
        for meta in self.blobs.values():
            if meta.state is not BlobState.READY:
                continue
            for (cs, ck), sp in meta.placement.items():
                out.append((sp, meta.blob_id, cs, ck, meta.chunk_num_samples[(cs, ck)]))
        return out

    # -- audit epoch machinery (§4) ------------------------------------------------
    def internal_challenges(self, epoch: int) -> list[Challenge]:
        sp_ids = [s.sp_id for s in self.active_sps()]
        return audit_mod.derive_challenges(
            self.epoch_seed(epoch),
            epoch,
            self.holdings(),
            sp_ids,
            self.params.p_a,
            self.params.auditors_per_audit,
        )

    def submit_scoreboard(self, epoch: int, sb: Scoreboard):
        self._scoreboards[epoch][sb.owner] = sb

    def chunk_root(self, blob_id: int, chunkset: int, chunk: int) -> bytes:
        return self.blobs[blob_id].chunk_roots[(chunkset, chunk)]

    def verify_possession_proof(
        self, blob_id: int, chunkset: int, chunk: int, sample: bytes, proof: cm.MerkleProof
    ) -> bool:
        """On-chain Merkle verification (cheap enough for consensus, §3.4)."""
        return cm.verify(self.chunk_root(blob_id, chunkset, chunk), sample, proof)

    def submit_evidence(
        self, reporter: int, accused: int, blob_id: int, chunkset: int, chunk: int,
        sample: bytes, proof: cm.MerkleProof,
    ) -> bool:
        """Peer-submitted invalid-proof evidence (§4.2): reporter is rewarded
        iff the proof indeed fails verification against on-chain roots."""
        valid = self.verify_possession_proof(blob_id, chunkset, chunk, sample, proof)
        if valid:
            return False  # evidence rejected; honest peers are safe
        self._slash(accused, self.params.S_ata)
        self.balances[reporter] += self.params.r_slash
        return True

    def _slash(self, sp: int, amount: float):
        self.stakes[sp] = self.stakes.get(sp, 0.0) - amount
        if self.stakes[sp] <= 0:
            self.ejected.add(sp)

    def close_epoch(
        self,
        epoch: int,
        respond_onchain_storage,  # (sp, blob, cs, ck, sample_idx) -> (bytes, proof)|None
        respond_ata,  # (auditor, auditee, position) -> (blob, cs, ck, bytes, proof)|None
    ) -> EpochOutcome:
        """§4.2: score aggregation, quadratic auditee challenges, ATA checks,
        slashing, and reward distribution — all 'on-chain'."""
        p = self.params
        sp_ids = [s.sp_id for s in self.active_sps()]
        boards = self._scoreboards.get(epoch, {})

        # 1) trimmed-mean scores from published scoreboards
        rates: dict[int, dict[int, float]] = {}
        for auditor, sb in boards.items():
            rates[auditor] = {
                a: (sum(v) / len(v)) for a, v in sb.bits.items() if len(v) > 0
            }
        scores = audit_mod.aggregate_scores(rates, sp_ids)

        slashed: dict[int, float] = defaultdict(float)
        onchain: dict[int, int] = {}
        seed = self.epoch_seed(epoch)

        # 2) auditee audits: (1 - score^2) * C randomized storage challenges
        holdings_by_sp: dict[int, list] = defaultdict(list)
        for h in self.holdings():
            holdings_by_sp[h[0]].append(h)
        for sp in sp_ids:
            nch = audit_mod.num_auditee_challenges(scores[sp], p.C)
            onchain[sp] = nch
            held = holdings_by_sp.get(sp, [])
            if not held or nch == 0:
                continue
            rng = placement_mod._rng(seed, b"auditee", epoch, sp)
            for _ in range(nch):
                _, blob, cs, ck, nsamp = held[int(rng.integers(len(held)))]
                sidx = int(rng.integers(nsamp))
                resp = respond_onchain_storage(sp, blob, cs, ck, sidx)
                ok = (
                    resp is not None
                    and resp[1].index == sidx
                    and self.verify_possession_proof(blob, cs, ck, resp[0], resp[1])
                )
                if not ok:
                    slashed[sp] += p.S_a
                    self._slash(sp, p.S_a)

        # 3) audit-the-auditor: reproduce sampled '1' entries
        for auditor, sb in boards.items():
            picked = audit_mod.select_ata_entries(seed, epoch, auditor, sb.ones(), p.p_ata)
            for auditee, pos in picked:
                resp = respond_ata(auditor, auditee, pos)
                ok = resp is not None and self.verify_possession_proof(
                    resp[0], resp[1], resp[2], resp[3], resp[4]
                )
                if not ok:
                    slashed[auditor] += p.S_ata
                    self._slash(auditor, p.S_ata)

        # 4) rewards: storage (volume * score) + auditor (per reported success)
        held_count = self._holdings_count()
        storage_rwd = {
            sp: held_count.get(sp, 0) * p.rwd_st_per_chunk * scores[sp] for sp in sp_ids
        }
        auditor_rwd = {
            auditor: p.rwd_au * sum(sum(v) for v in sb.bits.values())  # simlint: ok SIM007 integer bit counts, order-exact
            for auditor, sb in boards.items()
        }
        for sp, amt in storage_rwd.items():
            self.balances[sp] += amt
        for sp, amt in auditor_rwd.items():
            self.balances[sp] += amt

        # 5) scoreboard publication gas (§4.3): landing the packed bit
        # vectors on chain costs each auditor gas proportional to its
        # compressed submission size — debited to the treasury, so the
        # audit economy nets publication out of auditor profit
        publish_costs: dict[int, float] = {}
        for auditor, sb in boards.items():
            _, nbytes = sb.packed()
            cost = nbytes * p.gas_per_scoreboard_byte
            if cost > 0:
                publish_costs[auditor] = cost
                self.balances[auditor] -= cost
                self.treasury += cost

        outcome = EpochOutcome(
            scores=scores,
            storage_rewards=storage_rwd,
            auditor_rewards=auditor_rwd,
            slashed=dict(slashed),
            onchain_challenges=onchain,
            evidence_rewards={},
            publish_costs=publish_costs,
        )
        self.outcomes[epoch] = outcome
        self.epoch = max(self.epoch, epoch + 1)
        return outcome
