"""Background planes on the shared event loop (§4 audits + §3.3 repair).

Shelby's headline claim is an audit protocol with "strong cryptoeconomic
guarantees without compromising performance".  That claim is only
measurable when audit and repair traffic *competes* with paid serving:
before this module, both ran synchronously off-band — proof broadcasts
never crossed a backbone NIC, helper reads never occupied an SP disk slot,
and serving p99 could not possibly move.  Here they become spawned
generator tasks on the same :class:`~repro_torch.net.events.EventLoop` as the
read path:

* :class:`AuditPlane` — one task per challenge: the auditee pulls the
  sample and builds its Merkle proof holding one of its disk slots in the
  *background* scheduling class (capped by the SP's
  :class:`~repro_torch.storage.sp.BackgroundSpec` slot share), then broadcasts
  the proof to every auditor as concurrent ``Transfer`` legs over the
  backbone (NIC + trunk reservation), and each auditor verifies and
  records its scoreboard bit in event order.
* :class:`RepairPlane` — one task per lost chunk, delegating to
  :meth:`~repro_torch.storage.repair.RepairCoordinator.repair_chunk_task`
  (helper reads + re-dispersal as background transfers and disk holds);
  per-chunk failures are recorded, never propagated — a dead chunk must
  not take the serving plane down with it.

Both planes *pace* their task launches (``BackgroundSpec.pace_ms``) so
audits and repair trickle instead of bursting, and both append a
:class:`~repro_torch.net.workloads.BackgroundRecord` per operation — the
records ride the replay's determinism digest, so "same seed ⇒ same
foreground AND background schedule" is testable.
"""
from __future__ import annotations

from repro_torch.net.events import (
    Acquire, EventLoop, Join, Release, Sleep, Transfer, safe_release,
)
from repro_torch.net.workloads import BackgroundRecord
from repro_torch.storage.repair import RepairCoordinator, RepairError
from repro_torch.storage.rpc import NACK_BYTES

# wire overhead alongside a broadcast proof: challenge coordinates, sample
# index, auditee signature — the payload is dominated by sample + Merkle path
PROOF_OVERHEAD_BYTES = 96


class AuditPlane:
    """Drives one epoch's challenge→proof→broadcast→verify flow as paced
    background tasks on a shared loop.

    ``nodes`` maps sp_id -> backbone node id; without it (or without a
    network on the loop) the plane still costs auditee disk time but moves
    no bytes — the ``run_sim`` direct-transport case.
    """

    def __init__(self, contract, sps, challenges, *, nodes=None,
                 pace_ms: float | None = None):
        self.contract = contract
        self.sps = sps
        self.challenges = list(challenges)
        self.nodes = nodes
        self.pace_ms = pace_ms  # None: each auditee's own BackgroundSpec pace
        self.records: list[BackgroundRecord] = []
        self.proof_bytes = 0  # proof bytes that actually crossed the network

    def spawn(self, loop: EventLoop) -> None:
        t = loop.now
        for i, ch in enumerate(self.challenges):
            loop.spawn(
                self._challenge_task(loop, ch),
                at_ms=t,
                label=f"audit/e{ch.epoch}/a{ch.auditee}/{i}",
            )
            sp = self.sps.get(ch.auditee)
            pace = self.pace_ms
            if pace is None:
                pace = sp.service.background.pace_ms if sp is not None else 2.0
            t += pace

    def _challenge_task(self, loop: EventLoop, ch):
        t0 = loop.now
        sp = self.sps.get(ch.auditee)
        proof = None
        if sp is not None and not sp.behavior.crashed:
            # proof generation = one disk read on the auditee (sample +
            # Merkle path), in the background class under its slot share
            prio = sp.service.background.priority
            yield Acquire(("sp", ch.auditee), sp.service.slots, priority=prio,
                          limit=sp.bg_slots())
            try:
                yield Sleep(sp.audit_service_ms())
            finally:
                yield from safe_release(
                    Release(("sp", ch.auditee), priority=prio))
            proof = sp.respond_challenge(ch)
        payload = (
            len(proof.sample) + proof.proof.nbytes + PROOF_OVERHEAD_BYTES
            if proof is not None else NACK_BYTES
        )
        moved = 0
        legs = []
        for auditor in ch.auditors:
            if auditor in self.contract.ejected or auditor not in self.sps:
                continue
            legs.append(loop.spawn(
                self._broadcast_leg(loop, ch, proof, auditor, payload),
                label=f"audit/e{ch.epoch}/a{ch.auditee}->{auditor}",
            ))
        for h in legs:
            moved += yield Join(h)
        self.records.append(BackgroundRecord(
            kind="audit",
            key=f"e{ch.epoch}/a{ch.auditee}/b{ch.blob_id}/c{ch.chunkset}"
                f"/k{ch.chunk}/s{ch.sample}",
            t_ms=t0, finish_ms=loop.now, ok=proof is not None, nbytes=moved,
        ))

    def _broadcast_leg(self, loop: EventLoop, ch, proof, auditor: int,
                       payload: int):
        """Ship the proof to ONE auditor and let it verify + record."""
        src = self.nodes.get(ch.auditee) if self.nodes else None
        dst = self.nodes.get(auditor) if self.nodes else None
        moved = 0
        if src is not None and dst is not None and loop.network is not None:
            yield Transfer(src, dst, payload)
            moved = payload
            self.proof_bytes += payload
        # Merkle verification is CPU, not disk — free on the sim clock
        self.sps[auditor].audit_peer(ch, proof, self.contract)
        return moved


class RepairPlane:
    """Scan-and-repair as paced background tasks.

    Wraps a :class:`RepairCoordinator` (which carries the network identity
    and the spot-check policy); ``lost`` pins the work-list explicitly,
    otherwise the plane scans at spawn time.  Unrecoverable chunks land in
    ``failures`` — the plane never raises into the serving loop.
    """

    def __init__(self, coordinator: RepairCoordinator, *,
                 lost: list[tuple[int, int, int]] | None = None,
                 pace_ms: float | None = None):
        self.rc = coordinator
        self._lost = lost
        self.pace_ms = pace_ms
        self.records: list[BackgroundRecord] = []
        self.failures: list[tuple[tuple[int, int, int], str]] = []
        # re-dispersal backlog accounting (membership plane): how many
        # repairs were queued over the plane's lifetime, and the live task
        # handles of the most recent batch (drain-time measurement)
        self.enqueued_total = 0
        self.handles: list = []

    def spawn(self, loop: EventLoop) -> None:
        lost = self._lost if self._lost is not None else self.rc.scan_lost_chunks()
        self.enqueue(loop, lost)

    def enqueue(self, loop: EventLoop, lost: list[tuple[int, int, int]]) -> list:
        """Queue a batch of repairs as paced background tasks starting NOW.

        The membership plane calls this at each epoch boundary with the
        chunks its reconfiguration displaced — the re-dispersal backlog.
        Returns the batch's task handles (``finished_ms`` gives the drain
        time once the loop runs); they are also appended to ``handles``.
        """
        t = loop.now
        batch = []
        for blob_id, cs, ck in lost:
            batch.append(loop.spawn(
                self._repair_task(loop, blob_id, cs, ck),
                at_ms=t,
                label=f"repair/b{blob_id}/c{cs}/k{ck}",
            ))
            pace = self.pace_ms
            if pace is None:
                sp = self.rc.sps.get(
                    self.rc.contract.blobs[blob_id].placement[(cs, ck)]
                )
                pace = sp.service.background.pace_ms if sp is not None else 2.0
            t += pace
        self.enqueued_total += len(batch)
        self.handles.extend(batch)
        return batch

    def backlog(self) -> int:
        """Enqueued repairs that have not yet finished (either way)."""
        return self.enqueued_total - len(self.records)

    def _repair_task(self, loop: EventLoop, blob_id: int, cs: int, ck: int):
        t0 = loop.now
        key = f"b{blob_id}/c{cs}/k{ck}"
        try:
            rep = yield from self.rc.repair_chunk_task(
                loop, blob_id, cs, ck, label=f"repair/{key}"
            )
        except RepairError as e:
            self.failures.append(((blob_id, cs, ck), str(e)))
            self.records.append(BackgroundRecord(
                kind="repair", key=key, t_ms=t0, finish_ms=loop.now,
                ok=False, nbytes=0,
            ))
            return
        # helper reads in + rebuilt chunk out (re-dispersal) — network
        # bytes only: without a backbone nothing crossed a link (the
        # record contract matches the audit plane's)
        networked = self.rc.nodes is not None and loop.network is not None
        moved = (rep.helper_bytes_read + self.rc.layout.chunk_bytes
                 if networked else 0)
        self.records.append(BackgroundRecord(
            kind="repair", key=key, t_ms=t0, finish_ms=loop.now,
            ok=True, nbytes=moved,
        ))
