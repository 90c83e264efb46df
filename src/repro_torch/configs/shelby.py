"""The paper's own system configuration (not an LM arch): the production
Shelby deployment parameters used across the port's write/read path,
overload control, background planes and DAS, with the JAX package's
defaults (``repro/configs/shelby.py``).  There is no GF-backend knob: the
device of the layout picks the CUDA kernel or its plain version."""
import dataclasses

from repro_torch.core.audit import AuditParams
from repro_torch.storage.blob import BlobLayout


@dataclasses.dataclass(frozen=True)
class ShelbyConfig:
    layout: BlobLayout = BlobLayout(k=10, m=6, chunkset_bytes_target=10 * 1024 * 1024)
    audit: AuditParams = AuditParams()
    num_sps: int = 24
    num_dcs: int = 5  # Appendix A availability model
    racks_per_dc: int = 4
    rpc_hedge: int = 2
    # hedge deadline = max(min_deadline, factor x slowest primary's
    # estimated latency); lower fires hedges sooner (see net/scheduler.py)
    rpc_hedge_deadline_factor: float = 3.0
    # fleet routing policy by name: latency | affinity | p2c
    # (net.fleet.POLICY_FACTORIES; scenarios build fleets through this)
    routing_policy: str = "affinity"
    price_per_chunk_read: float = 1e-6
    storage_fee_per_gb_month: float = 0.023  # W, benchmarked against S3
    epochs_per_month: float = 30.0
    # hot-cache policy per RPC node (LRU always; these add expiry/admission)
    rpc_cache_ttl_ms: float | None = None  # sim-clock TTL for decoded entries
    rpc_cache_admit_bytes: int | None = None  # skip caching decodes larger than this
    # overload control per RPC node (all off -> no AdmissionSpec attached;
    # see storage.rpc.AdmissionSpec for exact semantics)
    rpc_single_flight: bool = True  # collapse concurrent same-chunkset misses
    rpc_max_queued_requests: int | None = None  # admitted reads per node
    rpc_max_inflight_fetches: int | None = None  # live SP fetch tasks per node
    rpc_shed_deadline_ms: float | None = None  # brownout SLO on EWMA fetch ms
    # event-engine service/network model
    # event-queue discipline: "calendar" (O(1) amortized calendar queue,
    # the default) or "heap" (the binary-heap baseline); pop order — and
    # therefore every determinism digest — is identical on both
    event_engine: str = "calendar"
    sp_service_slots: int = 4  # concurrent disk reads per SP (FIFO queue beyond)
    # per-node NIC line rate wherever a Backbone is built from this config
    # (the concurrent serving bench); None = unlimited nodes
    nic_gbps: float | None = 10.0
    # background planes (audits + repair) per SP: the share of disk slots
    # background work may hold concurrently, the pacing between background
    # ops, the audit proof disk time (None = one chunk-read interval), and
    # the serving-p99 inflation budget the bench/tests assert under full
    # audit+repair load (loaded p99 <= bg_p99_budget * quiescent p99)
    bg_slot_share: float = 0.5
    bg_pace_ms: float = 2.0
    sp_audit_ms_per_proof: float | None = None
    bg_p99_budget: float = 1.5
    # membership plane (epoch-scale churn + reconfiguration): simulated
    # wall span of one epoch, default per-SP per-epoch churn probabilities,
    # the drain budget the bench asserts on each boundary's re-dispersal
    # backlog, and the serving-p99 inflation budget asserted through a
    # membership change (churned p99 <= churn_p99_budget * quiescent p99)
    churn_epoch_ms: float = 300.0
    churn_p_crash: float = 0.0
    churn_p_leave: float = 0.0
    churn_joins_per_epoch: int = 0
    churn_drain_budget_ms: float = 300.0
    churn_p99_budget: float = 1.8
    # data-availability sampling (storage/das.py): the 2-D extension's data
    # square side (k x k -> 2k x 2k shares), per-share byte size, samples a
    # light client draws per blob per epoch, the master switch, an optional
    # override of the modeled per-share proof wire size (None = the true
    # Merkle-path size), and the streaming-p99 inflation budget the bench
    # asserts under a concurrent DAS storm
    das_k: int = 4
    das_share_bytes: int = 512
    das_samples_per_epoch: int = 16
    das_extension: bool = True
    das_proof_bytes_per_share: int | None = None
    das_p99_budget: float = 1.8

    def background(self):
        """The per-SP BackgroundSpec these knobs describe."""
        from repro_torch.storage.sp import BackgroundSpec

        return BackgroundSpec(slot_share=self.bg_slot_share,
                              pace_ms=self.bg_pace_ms)

    def service(self, slots: int | None = None):
        """A ServiceSpec carrying the background budget + audit disk time."""
        from repro_torch.storage.sp import ServiceSpec

        return ServiceSpec(slots=slots if slots is not None else self.sp_service_slots,
                           audit_ms_per_proof=self.sp_audit_ms_per_proof,
                           background=self.background())

    def churn(self, *, seed: int = 0, scripted=(), min_active: int | None = None):
        """The ChurnSpec these knobs describe (plus run-specific scripted
        events / seed / fleet floor)."""
        from repro_torch.storage.membership import ChurnSpec

        return ChurnSpec(
            p_crash=self.churn_p_crash,
            p_leave=self.churn_p_leave,
            joins_per_epoch=self.churn_joins_per_epoch,
            min_active=min_active,
            seed=seed,
            scripted=tuple(scripted),
        )

    def nic(self):
        from repro_torch.net.backbone import NICSpec

        if self.nic_gbps is None:
            return None
        return NICSpec(egress_gbps=self.nic_gbps, ingress_gbps=self.nic_gbps)

    def policy(self):
        """A fresh routing-policy instance for the ``routing_policy`` knob."""
        from repro_torch.net.fleet import make_policy

        return make_policy(self.routing_policy)

    def scheduler(self):
        """The per-RPC-node HedgedScheduler these knobs describe."""
        from repro_torch.net.scheduler import HedgedScheduler

        return HedgedScheduler(hedge=self.rpc_hedge,
                               deadline_factor=self.rpc_hedge_deadline_factor)

    def admission(self):
        """The per-RPC-node AdmissionSpec these knobs describe, or None
        when every limit is off (the node then never sheds)."""
        from repro_torch.storage.rpc import AdmissionSpec

        if (self.rpc_max_queued_requests is None
                and self.rpc_max_inflight_fetches is None
                and self.rpc_shed_deadline_ms is None):
            return None
        return AdmissionSpec(
            max_queued_requests=self.rpc_max_queued_requests,
            max_inflight_fetches=self.rpc_max_inflight_fetches,
            deadline_ms=self.rpc_shed_deadline_ms,
        )

    def das(self):
        """The DASSpec these knobs describe, or None when the 2-D
        extension is switched off (no dispersal, no sampling plane)."""
        from repro_torch.storage.das import DASSpec

        if not self.das_extension:
            return None
        return DASSpec(
            k=self.das_k,
            share_bytes=self.das_share_bytes,
            samples_per_epoch=self.das_samples_per_epoch,
            extension=True,
            proof_bytes_per_share=self.das_proof_bytes_per_share,
        )


CONFIG = ShelbyConfig()
SMOKE = ShelbyConfig(
    layout=BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024),
    num_sps=8,
    num_dcs=3,
    racks_per_dc=2,
)


# Machine-readable documentation for EVERY public knob: unit, default,
# and the scenario / SLO of the JAX package that exercises it.  The table
# covers exactly the fields of ShelbyConfig (tests/test_torch_overload.py
# holds it to them), so a new knob without a doc line fails tier-1.
KNOB_DOCS: dict[str, str] = {
    "layout": (
        "unit: BlobLayout; default: k=10, m=6, 10 MiB chunksets. The Clay "
        "erasure layout every world stores blobs under; scenario worlds "
        "shrink it to k=4/m=2/64 KiB for CI. Exercised by: every scenario."
    ),
    "audit": (
        "unit: AuditParams; default: paper §4 schedule. Audit sampling "
        "probability, fines, and gas. Exercised by: background (audit "
        "plane pacing), run_sim epochs."
    ),
    "num_sps": (
        "unit: count; default: 24. Fleet size for config-built clusters "
        "(build_cluster); scenario worlds size their own fleets. "
        "Exercised by: run_sim integration tests."
    ),
    "num_dcs": (
        "unit: count; default: 5. Datacenters in config-built topologies "
        "(Appendix A availability model). Exercised by: durability bench."
    ),
    "racks_per_dc": (
        "unit: count; default: 4. Failure-domain granularity below a DC "
        "for placement spreading. Exercised by: churn (replacement_sp "
        "domain spreading)."
    ),
    "rpc_hedge": (
        "unit: count; default: 2. Extra chunk requests the hedged "
        "scheduler may launch past k when the deadline fires. Exercised "
        "by: serve_grid (straggler-shield SLO: zipf p99 < 250 ms)."
    ),
    "rpc_hedge_deadline_factor": (
        "unit: multiplier; default: 3.0. Hedge deadline = max(min_deadline, "
        "factor x slowest primary's estimated latency); lower hedges "
        "sooner (more waste, tighter tail). Exercised by: serve_grid SLOs; "
        "tunable in tune_admission sweeps."
    ),
    "routing_policy": (
        "unit: name in net.fleet.POLICY_FACTORIES (latency|affinity|p2c); "
        "default: affinity. The fleet routing policy scenario fleets are "
        "built with. Exercised by: every scenario fleet; serve_grid "
        "iterates all three explicitly."
    ),
    "price_per_chunk_read": (
        "unit: tokens/chunk; default: 1e-6. Pay-on-delivery price a "
        "client owes per served chunk. Exercised by: settlement "
        "conservation asserts in every paid scenario."
    ),
    "storage_fee_per_gb_month": (
        "unit: $/GB-month; default: 0.023 (S3-benchmarked W). Storage "
        "fee in the economics model. Exercised by: incentives bench."
    ),
    "epochs_per_month": (
        "unit: epochs; default: 30. Converts per-epoch fees to monthly "
        "economics. Exercised by: incentives bench."
    ),
    "rpc_cache_ttl_ms": (
        "unit: sim ms | None; default: None (no expiry). Sim-clock TTL "
        "on decoded hot-cache entries per RPC node. Exercised by: "
        "tune_admission sweeps (TTL axis); TTL tests in test_events.py."
    ),
    "rpc_cache_admit_bytes": (
        "unit: bytes | None; default: None (admit all). Skip caching "
        "decoded chunksets larger than this. Exercised by: cache "
        "admission tests; tunable in sweeps."
    ),
    "rpc_single_flight": (
        "unit: bool; default: True. Collapse concurrent same-chunkset "
        "cache misses onto one SP fetch (coalesced followers). Exercised "
        "by: concurrent SLO (5000rps.admitted.coalesced > 0)."
    ),
    "rpc_max_queued_requests": (
        "unit: count | None; default: None (unbounded). Admission cap on "
        "concurrently admitted reads per RPC node; past it the node "
        "sheds with a typed Overloaded NACK. Exercised by: tune_admission "
        "sweeps; overload tests."
    ),
    "rpc_max_inflight_fetches": (
        "unit: count | None; default: None (unbounded). Fetch budget per "
        "RPC node (coalesced waiters are free); the concurrent scenario "
        "sets 6 for its admitted ramp. Exercised by: concurrent SLOs "
        "(admitted p99 < free p99, shed_rate > 0 at 3x saturation)."
    ),
    "rpc_shed_deadline_ms": (
        "unit: sim ms | None; default: None (off). Brownout SLO: shed "
        "while the EWMA of observed fetch latency exceeds it. Exercised "
        "by: tune_admission sweeps; brownout tests in test_overload.py."
    ),
    "event_engine": (
        "unit: calendar|heap; default: calendar. Event-queue discipline; "
        "pop order and every determinism digest are identical on both. "
        "Exercised by: engine scenario (fast-vs-heap digest equality)."
    ),
    "sp_service_slots": (
        "unit: slots; default: 4. Concurrent disk reads per SP; FIFO "
        "queue beyond. Exercised by: concurrent (SP queueing past the "
        "knee), background (slot contention with audits)."
    ),
    "nic_gbps": (
        "unit: Gbps | None; default: 10.0. Per-node full-duplex NIC line "
        "rate wherever a Backbone is built from this config; None = "
        "unlimited. Exercised by: concurrent/background/churn/das worlds."
    ),
    "bg_slot_share": (
        "unit: fraction; default: 0.5. Max share of an SP's disk slots "
        "background work may hold concurrently. Exercised by: background "
        "SLO (p99_inflation <= bg_p99_budget)."
    ),
    "bg_pace_ms": (
        "unit: sim ms; default: 2.0. Min gap between background op "
        "launches per SP (no bursts). Exercised by: background SLO."
    ),
    "sp_audit_ms_per_proof": (
        "unit: sim ms | None; default: None (one chunk-read interval). "
        "Disk time an audit proof generation holds the auditee's slot. "
        "Exercised by: background (audit plane)."
    ),
    "bg_p99_budget": (
        "unit: multiplier; default: 1.5. Serving-p99 inflation bound "
        "under full audit+repair load. Exercised by: background SLO "
        "(p99_inflation <= bg_p99_budget)."
    ),
    "churn_epoch_ms": (
        "unit: sim ms; default: 300. Simulated wall span of one "
        "membership epoch. Exercised by: churn scenario."
    ),
    "churn_p_crash": (
        "unit: probability/SP/epoch; default: 0.0. Seeded crash draw for "
        "the churn process. Exercised by: churn durability series."
    ),
    "churn_p_leave": (
        "unit: probability/SP/epoch; default: 0.0. Seeded announced-"
        "departure draw. Exercised by: churn durability series."
    ),
    "churn_joins_per_epoch": (
        "unit: count; default: 0. New SPs registered per epoch. "
        "Exercised by: churn (join-expands-fleet path)."
    ),
    "churn_drain_budget_ms": (
        "unit: sim ms; default: 300. Bound on each boundary's "
        "re-dispersal backlog drain. Exercised by: churn (per-epoch "
        "drain assert)."
    ),
    "churn_p99_budget": (
        "unit: multiplier; default: 1.8. Serving-p99 inflation bound "
        "through a membership change. Exercised by: churn SLO "
        "(p99_inflation <= churn_p99_budget)."
    ),
    "das_k": (
        "unit: shares/axis; default: 4. Data-square side (k x k extends "
        "to 2k x 2k). Exercised by: das scenario."
    ),
    "das_share_bytes": (
        "unit: bytes; default: 512. Per-share payload size. Exercised "
        "by: das (bytes_to_detect < full_chunk_audit_bytes SLO)."
    ),
    "das_samples_per_epoch": (
        "unit: samples/blob/epoch; default: 16. Coordinates a light "
        "client draws per blob per epoch. Exercised by: das detection "
        "curve (1-(1-q)^s)."
    ),
    "das_extension": (
        "unit: bool; default: True. Master switch for the 2-D extension "
        "(dispersal + sampling plane). Exercised by: das scenario; "
        "extension-off tests."
    ),
    "das_proof_bytes_per_share": (
        "unit: bytes | None; default: None (true Merkle-path size). "
        "Override of the modeled per-share proof wire size. Exercised "
        "by: das proof-size tests."
    ),
    "das_p99_budget": (
        "unit: multiplier; default: 1.8. Streaming-p99 inflation bound "
        "under a concurrent DAS storm. Exercised by: das (streaming "
        "tail assert)."
    ),
}


def knob_doc(name: str) -> str:
    """The documented unit/default/scenario line for a knob, raising on
    unknown names so doc drift fails loudly."""
    try:
        return KNOB_DOCS[name]
    except KeyError:
        raise KeyError(
            f"knob {name!r} has no KNOB_DOCS entry (configs/shelby.py)"
        ) from None
