"""Storage-provider node simulation (§2.4).

An SP stores assigned chunks, serves *paid* chunk reads, answers audit
challenges with Merkle possession proofs, audits peers (recording a
scoreboard and retaining proofs for two epochs — §4.1), and can misbehave
in every way the paper's adversary model contemplates:

* ``crashed``           — stops answering (availability fault)
* ``drop_fraction``     — silently deletes a fraction of assigned chunks
                          (the §5.4 "fake storage" adversary)
* ``corrupt``           — serves bit-flipped data (detected via commitments)
* ``lazy_auditor``      — reports '1' without verifying / without retaining
                          proofs (the audit-the-auditor target, Thm 2)
* ``latency_ms``        — per-request latency for hedging/straggler tests
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from repro_torch.core import commitments as cm
from repro_torch.core.audit import Challenge, Scoreboard
from repro_torch.core.contract import ShelbyContract


@dataclasses.dataclass
class SPBehavior:
    crashed: bool = False
    drop_fraction: float = 0.0
    corrupt: bool = False
    lazy_auditor: bool = False
    retain_proofs: bool = True
    latency_ms: float = 1.0


@dataclasses.dataclass(frozen=True)
class BackgroundSpec:
    """Per-SP budget for the background planes (§4 audits + §3.3 repair).

    Background work — audit proof generation, repair helper reads,
    re-dispersal writes — runs on the same event loop and the same disk
    slots as paid serving, but in a deferrable scheduling class:

    * ``slot_share`` — the max fraction of the SP's ``ServiceSpec.slots``
      background work may hold concurrently (at least 1 slot, so the
      planes always make progress).  Free slots beyond the share are left
      idle for foreground reads rather than soaked up by audits.
    * ``pace_ms``   — minimum gap between background operations a plane
      launches (token pacing: audits/repairs trickle instead of bursting).
    * ``priority``  — event-loop scheduling class (foreground is 0);
      queued foreground reads always wake ahead of background waiters.

    The net effect is the paper's "auditing without compromising
    performance": audits and repair brown out before serving does.
    """

    slot_share: float = 0.5
    pace_ms: float = 2.0
    priority: int = 1

    def max_slots(self, slots: int) -> int:
        """Concurrent disk slots background work may hold on this SP."""
        return max(1, min(slots, int(round(slots * self.slot_share))))


@dataclasses.dataclass
class ServiceSpec:
    """The SP's service model on the event engine (§2.4 serving).

    ``disk_ms_per_chunk`` is the per-chunk-read service time (``None``
    defers to ``SPBehavior.latency_ms`` so straggler injection keeps
    working); ``slots`` is how many chunk reads the SP's disks serve
    concurrently.  On a shared event loop the slots are a FIFO resource
    — a hot SP *queues* excess requests instead of answering every one
    after a flat latency, so tail latency under load comes from queueing
    theory, not from a constant.

    ``audit_ms_per_proof`` is the disk time to pull an audit sample and
    build its Merkle proof (``None`` = one chunk-read service interval);
    ``background`` budgets how audit/repair work shares the slots with
    paid reads (see :class:`BackgroundSpec`).
    """

    disk_ms_per_chunk: float | None = None
    slots: int = 4
    audit_ms_per_proof: float | None = None
    background: BackgroundSpec = dataclasses.field(default_factory=BackgroundSpec)


@dataclasses.dataclass(frozen=True)
class AuditProof:
    """What an auditee broadcasts (§4.1): the sample + its Merkle proof."""

    auditee: int
    blob_id: int
    chunkset: int
    chunk: int
    sample_index: int
    sample: bytes
    proof: cm.MerkleProof


class StorageProvider:
    def __init__(self, sp_id: int, behavior: SPBehavior | None = None, tree_cache: int = 256,
                 service: ServiceSpec | None = None):
        self.sp_id = sp_id
        self.behavior = behavior or SPBehavior()
        self.service = service or ServiceSpec()
        self._chunks: dict[tuple[int, int, int], np.ndarray] = {}
        # DAS share plane (core/extend2d.py): shares are stored alongside —
        # not inside — `_chunks`, so chunk audits and repair accounting are
        # untouched by the sampling regime.  Withheld coordinates keep their
        # bytes (the adversary HAS the data, it just won't serve it — the
        # case chunk-possession audits structurally cannot catch).
        self._das_shares: dict[tuple[int, int, int], np.ndarray] = {}
        self._das_proofs: dict[tuple[int, int, int], object] = {}
        self._das_withheld: set[tuple[int, int, int]] = set()
        self._trees: OrderedDict[tuple[int, int, int], cm.MerkleTree] = OrderedDict()
        self._tree_cache = tree_cache
        self._rng = np.random.default_rng(sp_id * 7919 + 13)
        # auditor state
        self.scoreboard = Scoreboard(owner=sp_id)
        self.retained: dict[tuple[int, int], AuditProof] = {}  # (auditee,pos)->proof
        # serving income, channel-accounted (§3.2): `earned_reads` is the
        # accrued micropayment balance (refunds held but not broadcast);
        # `settled_income` is what channel settlement actually realized.
        self.earned_reads = 0.0
        self.settled_income = 0.0

    # -- write path -------------------------------------------------------------
    def store_chunk(self, blob_id: int, chunkset: int, chunk: int, data: np.ndarray) -> bool:
        if self.behavior.crashed:
            return False
        key = (blob_id, chunkset, chunk)
        if self.behavior.drop_fraction > 0 and self._rng.random() < self.behavior.drop_fraction:
            # pretends to store (acks) but drops the bytes — §5.4 adversary
            return True
        self._chunks[key] = np.array(data, dtype=np.uint8)
        return True

    def has_chunk(self, blob_id: int, chunkset: int, chunk: int) -> bool:
        return (blob_id, chunkset, chunk) in self._chunks

    def stored_chunks(self) -> int:
        return len(self._chunks)

    def _tree(self, key: tuple[int, int, int]) -> cm.MerkleTree:
        if key in self._trees:
            self._trees.move_to_end(key)
            return self._trees[key]
        _, tree = cm.commit_chunk(self._chunks[key])
        self._trees[key] = tree
        if len(self._trees) > self._tree_cache:
            self._trees.popitem(last=False)
        return tree

    # -- read path (paid, §2.4) ----------------------------------------------------
    def service_ms(self) -> float:
        """Per-chunk disk service time (the event engine sleeps this long
        while holding one of the SP's `service.slots`)."""
        if self.service.disk_ms_per_chunk is not None:
            return self.service.disk_ms_per_chunk
        return self.behavior.latency_ms

    def audit_service_ms(self) -> float:
        """Disk time to answer one audit challenge (sample read + proof)."""
        if self.service.audit_ms_per_proof is not None:
            return self.service.audit_ms_per_proof
        return self.service_ms()

    def bg_slots(self) -> int:
        """Disk slots the background class may hold concurrently here."""
        return self.service.background.max_slots(self.service.slots)

    def serve_chunk(self, blob_id: int, chunkset: int, chunk: int):
        """Returns (chunk_bytes, latency_ms) or None.

        Payment is NOT taken here: the reader pays on delivery, after the
        chunk verified against its commitment (see `receive_payment`) — a
        crashed or corrupt SP earns nothing.
        """
        if self.behavior.crashed:
            return None
        key = (blob_id, chunkset, chunk)
        if key not in self._chunks:
            return None
        data = self._chunks[key]
        if self.behavior.corrupt:
            data = data.copy()
            data.reshape(-1)[0] ^= 0xFF
        return data, self.service_ms()

    # -- DAS share plane (paid tiny reads, core/extend2d.py) -----------------------
    def store_share(self, blob_id: int, row: int, col: int, share: np.ndarray,
                    proof) -> bool:
        """Accept one DAS share + its pre-built commitment proof."""
        if self.behavior.crashed:
            return False
        key = (blob_id, row, col)
        self._das_shares[key] = np.array(share, dtype=np.uint8)
        self._das_proofs[key] = proof
        return True

    def withhold_share(self, blob_id: int, row: int, col: int) -> None:
        """Go silent on one coordinate (data retained — withholding, not loss)."""
        self._das_withheld.add((blob_id, row, col))

    def stored_shares(self) -> int:
        return len(self._das_shares)

    def serve_share(self, blob_id: int, row: int, col: int):
        """Returns (share_bytes, proof, latency_ms) or None.

        Same pay-on-delivery contract as `serve_chunk`: the sampler pays
        only after the share verifies against the blob's DAS root, so a
        withholding or corrupting SP earns nothing from the sample — and
        the refusal itself IS the availability signal.
        """
        if self.behavior.crashed:
            return None
        key = (blob_id, row, col)
        if key not in self._das_shares or key in self._das_withheld:
            return None
        data = self._das_shares[key]
        if self.behavior.corrupt:
            data = data.copy()
            data.reshape(-1)[0] ^= 0xFF
        return data, self._das_proofs[key], self.service_ms()

    def serve_subchunks(self, blob_id: int, chunkset: int, chunk: int, ids: list[int]):
        """MSR repair helper read: only the requested sub-chunks (planes)."""
        if self.behavior.crashed:
            return None
        key = (blob_id, chunkset, chunk)
        if key not in self._chunks:
            return None
        return self._chunks[key][ids], self.service_ms()

    def receive_payment(self, amount: float) -> None:
        """A channel micropayment arrived (fresh refund signed over to us)."""
        self.earned_reads += amount

    def credit_settlement(self, amount: float) -> None:
        """An RPC->SP channel settled on-chain; income is now realized."""
        self.settled_income += amount

    # -- auditee role (§4.1) ---------------------------------------------------------
    def respond_challenge(self, ch: Challenge) -> AuditProof | None:
        if self.behavior.crashed:
            return None
        key = (ch.blob_id, ch.chunkset, ch.chunk)
        if key not in self._chunks:
            return None  # cannot fabricate a valid Merkle proof (§4.4)
        tree = self._tree(key)
        samples = cm.chunk_samples(self._chunks[key])
        idx = ch.sample % len(samples)
        return AuditProof(
            auditee=self.sp_id,
            blob_id=ch.blob_id,
            chunkset=ch.chunkset,
            chunk=ch.chunk,
            sample_index=idx,
            sample=samples[idx],
            proof=tree.prove(idx),
        )

    # -- auditor role (§4.1) ----------------------------------------------------------
    def audit_peer(self, ch: Challenge, proof: AuditProof | None, contract: ShelbyContract):
        """Verify a broadcast proof, record the outcome, retain the proof."""
        if self.behavior.lazy_auditor:
            # rational deviation candidate: blind '1', no verification
            self.scoreboard.record(ch.auditee, True)
            if self.behavior.retain_proofs and proof is not None:
                self._retain(ch.auditee, proof)
            return
        ok = (
            proof is not None
            and proof.sample_index == proof.proof.index
            and contract.verify_possession_proof(
                ch.blob_id, ch.chunkset, ch.chunk, proof.sample, proof.proof
            )
        )
        self.scoreboard.record(ch.auditee, ok)
        if ok and self.behavior.retain_proofs:
            self._retain(ch.auditee, proof)
        if proof is not None and not ok:
            # provably invalid proof -> submit slashing evidence (§4.2)
            contract.submit_evidence(
                self.sp_id, ch.auditee, ch.blob_id, ch.chunkset, ch.chunk,
                proof.sample, proof.proof,
            )

    def _retain(self, auditee: int, proof: AuditProof):
        # position = index of the just-recorded entry in THIS auditor's
        # scoreboard bit vector for the auditee — the same coordinate
        # `select_ata_entries` samples from `Scoreboard.ones()`, so
        # audit-the-auditor lookups land on the right proof even when the
        # auditee's history mixes successes and failures (failed audits
        # occupy a bit position but retain nothing)
        pos = len(self.scoreboard.bits[auditee]) - 1
        self.retained[(auditee, pos)] = proof

    def reproduce_proof(self, auditee: int, position: int):
        """Audit-the-auditor response (§4.2)."""
        p = self.retained.get((auditee, position))
        if p is None:
            return None
        return (p.blob_id, p.chunkset, p.chunk, p.sample, p.proof)

    # -- failure injection --------------------------------------------------------------
    def crash(self):
        self.behavior.crashed = True

    def decommission(self):
        """Graceful exit (announced departure finalized at an epoch
        boundary): the node powers off — same serving behavior as a crash,
        but the distinction matters upstream (a departure was re-dispersed
        proactively; a crash races the repair plane)."""
        self.behavior.crashed = True

    def recover(self):
        self.behavior.crashed = False

    def wipe(self):
        self._chunks.clear()
        self._trees.clear()
        self._das_shares.clear()
        self._das_proofs.clear()
        self._das_withheld.clear()
