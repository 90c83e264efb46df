"""Multi-epoch audit/economics simulation (§4.4 theorems, §5 calibration).

Builds a full simulated deployment (contract + SPs + RPC + blobs), runs
audit epochs end to end — internal challenges, proof broadcast, peer
verification, scoreboard publication, epoch close with on-chain challenges,
audit-the-auditor and slashing — and accounts each SP's *total utility*:

The data-plane half of each epoch runs on the shared event engine: the
audit challenge→proof→verify flow is a paced background plane
(:class:`~repro_torch.storage.background.AuditPlane`) spawned on the SAME loop
as the epoch's paid-read storm, so audit work holds real SP disk slots
(background class, capped by :class:`~repro_torch.storage.sp.BackgroundSpec`)
and contends with serving instead of being free.

    utility = storage rewards + auditor rewards + evidence rewards
              - slashing - storage costs (+ saved costs for cheaters)

This is the engine behind the empirical checks of Theorem 1 (honest is a
Nash equilibrium), Theorem 2 (mutual dishonesty is not), Theorem 3
(coalition resistance) and the §5.4 parameter calibration.

The layout's byte work (encode, decodes, repairs) runs on ``device``: the
card unless ``device="cpu"`` (the DAS extension of each blob included).
The simsan sanitizer (``sanitize`` or ``SHELBY_SIMSAN``) is not part of
this package yet and raises :class:`NotImplementedError` rather than being
ignored.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.core.audit import AuditParams, Challenge
from repro_torch.core.contract import ShelbyContract
from repro_torch.core.placement import SPInfo
from repro_torch.net.events import EventLoop
from repro_torch.net.fleet import CacheAffinityPolicy, RPCFleet
from repro_torch.net.workloads import zipf_hotset
from repro_torch.storage.background import AuditPlane
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.membership import ChurnSpec, MembershipPlane
from repro_torch.storage.repair import RepairCoordinator
from repro_torch.storage.rpc import RPCNode
from repro_torch.storage.sdk import ShelbyClient
from repro_torch.storage.sp import BackgroundSpec, SPBehavior, ServiceSpec, StorageProvider


@dataclasses.dataclass
class SimResult:
    utilities: dict[int, float]
    scores: dict[int, float]  # last-epoch scores
    slashed: dict[int, float]
    ejected: set[int]
    bytes_served: int = 0  # read traffic through the RPC fleet (if any)
    read_p99_ms: float = 0.0  # simulated, from the fleet's request log
    # paid-read economics ("reads are paid", §2.2/§3.2): serving income
    # flows client->RPC->SP through settled micropayment channels only
    sp_serving_income: dict[int, float] = dataclasses.field(default_factory=dict)
    rpc_serving_income: dict[str, float] = dataclasses.field(default_factory=dict)
    client_read_payments: float = 0.0  # sum over ReadReceipt payments
    # overload outcomes of the per-epoch read storms (admission control +
    # single-flight dedup): shed reads debit nothing; coalesced misses rode
    # another request's in-flight fetch
    reads_shed: int = 0
    reads_coalesced: int = 0
    # the audit plane on the event loop: challenge→proof→verify tasks that
    # ran CONCURRENTLY with the paid-read storm, holding auditee disk slots
    # in the background class (a failed op = no proof, e.g. a dropped chunk)
    audit_ops: int = 0
    audit_failures: int = 0
    # membership plane (churn != None): epoch-scale joins/departures/crashes,
    # boundary reconfigurations and the re-dispersal backlog they queued
    membership_events: int = 0
    chunksets_lost: int = 0
    repairs_enqueued: int = 0
    repairs_completed: int = 0
    sps_joined: int = 0
    sps_departed: int = 0
    # DAS sampling plane (das != None): per-epoch light-client sampling
    # rounds over every blob's 2-D extension — pay-per-sample through the
    # same session channels, detections = blobs flagged unavailable
    das_samples: int = 0
    das_detections: int = 0
    das_proof_bytes: int = 0

    def utility(self, sp: int) -> float:
        return self.utilities[sp]


def run_sim(
    behaviors: dict[int, SPBehavior],
    *,
    params: AuditParams | None = None,
    epochs: int = 2,
    num_blobs: int = 6,
    blob_bytes: int = 200_000,
    storage_cost_per_chunk_epoch: float = 0.05,
    layout: BlobLayout | None = None,
    seed: int = 0,
    num_rpcs: int = 1,
    read_requests_per_epoch: int = 0,
    device=None,  # the layout's device: None = the card, "cpu" = plain path
    admission=None,  # storage.rpc.AdmissionSpec: shed past saturation
    single_flight: bool = True,  # collapse concurrent same-chunkset misses
    background: BackgroundSpec | None = None,  # per-SP audit/repair budget
    churn: ChurnSpec | None = None,  # epoch-scale membership churn plane
    epoch_ms: float = 250.0,  # simulated wall span of one churned epoch
    das=None,  # storage.das.DASSpec: extend blobs + sample every epoch
    engine: str | None = None,  # event-queue discipline (calendar|heap)
    sanitize: bool | None = None,  # simsan: not ported (must stay off)
) -> SimResult:
    if sanitize is None:
        sanitize = bool(os.environ.get("SHELBY_SIMSAN"))
    if sanitize:
        raise NotImplementedError(
            "run_sim(sanitize) needs the simsan sanitizer (SHELBY_SIMSAN), not ported yet")
    params = params or AuditParams(p_a=0.5, auditors_per_audit=4, C=50, p_ata=0.3)
    layout = layout or BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024,
                                  device=device)
    background = background or BackgroundSpec()
    n = len(behaviors)
    contract = ShelbyContract(params)
    sps: dict[int, StorageProvider] = {}
    for i in range(n):
        contract.register_sp(SPInfo(sp_id=i, stake=10_000.0, dc=f"dc{i % 3}"))
        sps[i] = StorageProvider(i, behaviors.get(i, SPBehavior()),
                                 service=ServiceSpec(background=background))
    rpcs = [
        RPCNode(f"rpc{r}", contract, sps, layout,
                admission=admission, single_flight=single_flight)
        for r in range(num_rpcs)
    ]
    fleet = RPCFleet(rpcs, CacheAffinityPolicy())
    client = ShelbyClient(contract, fleet, deposit=1e9, das=das)

    # crashes take effect AFTER the write phase (the contract would never
    # assign chunks to an SP that is already down)
    crashed_later = [i for i, b in behaviors.items() if b.crashed]
    for i in crashed_later:
        sps[i].behavior.crashed = False

    rng = np.random.default_rng(seed)
    for _ in range(num_blobs):
        client.put(rng.integers(0, 256, blob_bytes, dtype=np.uint8).tobytes())

    for i in crashed_later:
        sps[i].behavior.crashed = True

    utilities = {i: 0.0 for i in range(n)}
    reads_shed = 0
    audit_ops = 0
    audit_failures = 0
    # storage costs: cheaters with drop_fraction save proportionally
    held = {}
    for meta in contract.blobs.values():
        for sp in meta.placement.values():
            held[sp] = held.get(sp, 0) + 1

    # membership churn: ONE repair coordinator and ONE permanent lost-set
    # span all epochs (losses must never be double counted across the
    # per-epoch replay loops); each epoch gets a one-epoch plane slice
    repair_coord = RepairCoordinator(contract, sps, layout) if churn else None
    lost_chunksets: set[tuple[int, int]] = set()
    membership_events = 0
    repairs_enqueued = 0
    repairs_completed = 0
    sps_joined = 0
    sps_departed = 0

    das_samples = 0
    das_detections = 0
    das_proof_bytes = 0

    last = None
    for epoch in range(epochs):
        # the audit plane: challenge→proof→verify as paced background tasks
        # on the event loop — CONCURRENT with the epoch's paid-read storm,
        # holding auditee disk slots in the background class, instead of the
        # old zero-cost serial pass
        challenges = contract.internal_challenges(epoch)
        plane = AuditPlane(contract, sps, challenges)
        mplane = None
        planes: list = [plane]
        if churn is not None:
            mplane = MembershipPlane(
                contract, sps, layout, churn,
                repair=repair_coord, fleet=fleet,
                epochs=1, epoch_ms=epoch_ms, start_epoch=epoch,
                service_factory=lambda: ServiceSpec(background=background),
                lost=lost_chunksets,
            )
            planes.extend(mplane.planes())
        if read_requests_per_epoch:
            # paid Zipf read traffic through the client session, replayed as
            # a CONCURRENT open-loop Poisson process on the shared event
            # heap: in-flight requests' hedge timers and SP disk queues
            # interleave — and now contend with the audit plane.  The client
            # pays serving RPC nodes on delivery ("reads are paid"); a
            # dropped request debits nothing.
            metas = list(contract.blobs.values())
            reqs = zipf_hotset(
                metas,
                clients=["user"],
                num_requests=read_requests_per_epoch,
                seed=seed * 1009 + epoch,
                arrival="poisson",
            )
            _, replay = client.replay(reqs, background=planes, engine=engine)
            reads_shed += replay.shed
        else:
            loop = EventLoop(engine=engine)
            for p in planes:
                p.spawn(loop)
            loop.run()
        audit_ops += len(plane.records)
        audit_failures += sum(1 for r in plane.records if not r.ok)
        if mplane is not None:
            membership_events += len(mplane.events)
            sps_joined += len(mplane.joined)
            sps_departed += sum(
                1 for e in mplane.events if e.kind in ("leave", "crash", "slash")
            )
            if mplane.repair is not None:
                repairs_enqueued += mplane.repair.enqueued_total
                repairs_completed += sum(
                    1 for r in mplane.repair.records if r.ok
                )
        if das is not None and das.extension and contract.das:
            # the light-client sampling round: every blob's extension is
            # probed with s seeded coordinates through the same session —
            # pay-per-sample flows through settlement conservation below
            verdicts = client.current_session.sample_availability(
                epoch=epoch, seed=seed * 733 + epoch
            )
            das_samples += sum(v.verified + v.failures for v in verdicts)
            das_detections += sum(1 for v in verdicts if not v.available)
            das_proof_bytes += sum(v.proof_bytes for v in verdicts)
        for i, sp in sps.items():
            if i not in contract.dead_sps():
                contract.submit_scoreboard(epoch, sp.scoreboard)

        def respond_storage(sp, blob, cs, ck, sidx):
            pr = sps[sp].respond_challenge(Challenge(epoch, sp, blob, cs, ck, sidx, ()))
            return (pr.sample, pr.proof) if pr else None

        def respond_ata(auditor, auditee, pos):
            return sps[auditor].reproduce_proof(auditee, pos)

        last = contract.close_epoch(epoch, respond_storage, respond_ata)
        for i in sorted(sps):  # sps may have grown mid-epoch (joiners)
            utilities[i] = utilities.get(i, 0.0) + last.utility(i)
            stored = sps[i].stored_chunks()
            utilities[i] -= stored * storage_cost_per_chunk_epoch
        for sp in sps.values():  # fresh scoreboards next epoch
            sp.scoreboard.bits.clear()

    # settle the read session: client->RPC channels broadcast their freshest
    # refunds and the RPC->SP channels cascade, so serving income reaches SP
    # utilities exclusively through settled channels (no earned_reads shortcut)
    session = client.current_session
    receipts = list(session.receipts)
    settlement = client.settle()
    for i, amt in settlement.sp_income.items():
        utilities[i] = utilities.get(i, 0.0) + amt

    slashed_total = {i: 10_000.0 - contract.stakes.get(i, 10_000.0) for i in range(n)}
    p99 = fleet.latency_percentiles(99.0)[0] if fleet.request_latencies_ms else 0.0
    return SimResult(
        utilities=utilities,
        scores=last.scores if last else {},
        slashed=slashed_total,
        ejected=set(contract.ejected),
        bytes_served=fleet.bytes_served,
        read_p99_ms=p99,
        sp_serving_income=dict(settlement.sp_income),
        rpc_serving_income=dict(settlement.node_income),
        client_read_payments=sum(r.total_paid for r in receipts),
        reads_shed=reads_shed,
        reads_coalesced=fleet.coalesced(),
        audit_ops=audit_ops,
        audit_failures=audit_failures,
        membership_events=membership_events,
        chunksets_lost=len(lost_chunksets),
        repairs_enqueued=repairs_enqueued,
        repairs_completed=repairs_completed,
        sps_joined=sps_joined,
        sps_departed=sps_departed,
        das_samples=das_samples,
        das_detections=das_detections,
        das_proof_bytes=das_proof_bytes,
    )


def honest_population(n: int) -> dict[int, SPBehavior]:
    return {i: SPBehavior() for i in range(n)}
