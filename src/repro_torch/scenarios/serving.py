"""The serving scenarios (§2.3 + §3.5 + §4 + §2.5): registry entries for
the five backbone regimes plus the admission-tuning target.

Each ``run_*`` body is the JAX package's (``repro/scenarios/serving.py``)
on the port's modules: every knob it reads comes from ``ctx.config``
(defaults < scenario.knobs < sweep overrides), traffic shrinks under
``ctx.smoke``, every layout it builds lives on ``ctx.device`` (the card
unless ``"cpu"``: decodes, repairs and DAS extensions go through
``gf_matmul`` there), and the metrics payload is *returned* — the runner
asserts the declared SLOs against it and merges it into the BENCH sidecar
under the scenario's section.  Headline numeric bars are declared as
:class:`SLO`s on the registrations at the bottom of this module
(violations name the scenario); structural invariants (determinism
digests, settlement conservation, counterfactual comparisons) stay inline
where the evidence lives.

Adversity baked in: heterogeneous SP service latencies, one 250 ms
straggler, one SP crashed after the write phase — the paper's serving
claims are only interesting under failures.  Latencies are workload-driven
sums on the simulated clock; wall time only bounds how long a scenario
itself runs.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.configs.shelby import ShelbyConfig
from repro_torch.core import audit as audit_mod
from repro_torch.core import durability
from repro_torch.core.contract import ShelbyContract
from repro_torch.core.placement import SPInfo
from repro_torch.net.backbone import Backbone, NICSpec
from repro_torch.net.events import engine_counters
from repro_torch.net.fleet import POLICY_FACTORIES, RPCFleet
from repro_torch.net.workloads import (
    analytics_scan,
    das_storm,
    training_epoch,
    video_streaming,
    zipf_hotset,
)
from repro_torch.scenarios.registry import SLO, register
from repro_torch.scenarios.report import row
from repro_torch.scenarios.runner import ScenarioContext
from repro_torch.storage.background import AuditPlane, RepairPlane
from repro_torch.storage.blob import BlobLayout
from repro_torch.storage.das import DASSpec, extend_and_disperse_many, measure_detection
from repro_torch.storage.membership import ChurnSpec, MembershipPlane, measure_durability
from repro_torch.storage.repair import RepairCoordinator
from repro_torch.storage.rpc import AdmissionSpec, BackboneTransport, RPCNode
from repro_torch.storage.sdk import ShelbyClient
from repro_torch.storage.sp import StorageProvider

NUM_SPS = 12
NUM_RPCS = 3


def _num_blobs(smoke: bool) -> int:
    return 4 if smoke else 6


def _zipf_requests(smoke: bool) -> int:
    return 80 if smoke else 250


def _engine_stats(counters0: tuple[int, float]) -> dict:
    """Engine throughput over a section: the delta of the module-wide
    (events, wall_s) counters since ``counters0`` — sections with many
    private loops (sequential grid, sweeps) get honest totals without
    threading every loop's telemetry out by hand."""
    ev0, w0 = counters0
    ev1, w1 = engine_counters()
    d_ev, d_w = ev1 - ev0, w1 - w0
    return {
        "events": d_ev,
        "wall_s": d_w,
        "events_per_sec": d_ev / d_w if d_w > 0 else 0.0,
    }


def _world(cfg: ShelbyConfig, smoke: bool,
           nic: NICSpec | None = None, sp_slots: int | None = None,
           device=None):
    """Contract + SPs + stored blobs + backbone — shared across combos.

    `nic`/`sp_slots` turn on the event engine's contention model (NIC
    serialization per node, FIFO disk-slot queues per SP) for the
    concurrent regimes; the sequential grid keeps them off so its numbers
    stay comparable across PRs.  Contended SPs carry the config's
    background budget (`cfg.bg_slot_share` / `bg_pace_ms` /
    `sp_audit_ms_per_proof`), which the `background` scenario exercises.
    The layout lives on ``device`` (``None``: the card).
    """
    layout = BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024,
                        device=device)
    contract = ShelbyContract()
    bb = Backbone.mesh(3, base_latency_ms=6.0, gbps=25.0)
    rng = np.random.default_rng(42)
    sps = {}
    for i in range(NUM_SPS):
        dc = f"dc{i % 3}"
        contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=dc, rack=f"r{i % 4}"))
        service = cfg.service(slots=sp_slots) if sp_slots else None
        sps[i] = StorageProvider(i, service=service)
        sps[i].behavior.latency_ms = float(rng.uniform(1.0, 12.0))
        bb.register_node(f"sp{i}", dc, nic=nic)
    for c in range(3):
        bb.register_node(f"client{c}", f"dc{c}")
    # a throwaway writer node disperses the blobs
    bb.register_node("writer", "dc0")
    writer = RPCNode("writer", contract, sps, layout)
    client = ShelbyClient(contract, writer, deposit=1e9)
    metas = []
    datas = []  # original bytes, for bit-exact decode checks after churn
    for b in range(_num_blobs(smoke)):
        size = (8 if b == 0 else 4) * layout.chunkset_bytes  # blob 0: the "video"
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        datas.append(data)
        metas.append(client.put(data))
    # adversity AFTER the write phase
    sps[0].behavior.latency_ms = 250.0  # straggler
    sps[1].crash()
    return layout, contract, bb, sps, metas, datas


def _workloads(metas, smoke: bool):
    return {
        "streaming": lambda: video_streaming(
            metas[0], client="client0", segment_bytes=64 * 1024, bitrate_mbps=25.0
        ),
        "training": lambda: training_epoch(
            metas, client="client1", sample_bytes=64 * 1024, epochs=1, seed=3
        ),
        "zipf": lambda: zipf_hotset(
            metas,
            clients=["client0", "client1", "client2"],
            num_requests=_zipf_requests(smoke),
            seed=5,
        ),
        "analytics": lambda: analytics_scan(
            metas, client="client2", scan_bytes=128 * 1024
        ),
    }


def _fresh_fleet(cfg: ShelbyConfig, layout, contract, bb, sps, policy=None, *,
                 nic: NICSpec | None = None, cache_chunksets: int = 16,
                 admission: AdmissionSpec | None = None,
                 single_flight: bool = True):
    """A fleet built from the resolved config: routing policy, hedge
    deadline and cache TTL/admission all come off ``cfg`` so a sweep that
    moves a knob moves the fleet (the layout's device picks the decode's
    kernel)."""
    rpcs = []
    for r in range(NUM_RPCS):
        node = f"rpc{r}"
        if node not in bb._node_dc:
            bb.register_node(node, f"dc{r}", nic=nic)
        rpcs.append(
            RPCNode(
                node, contract, sps, layout,
                cache_chunksets=cache_chunksets,
                transport=BackboneTransport(sps, bb, node),
                scheduler=cfg.scheduler(),
                cache_ttl_ms=cfg.rpc_cache_ttl_ms,
                cache_admit_bytes=cfg.rpc_cache_admit_bytes,
                admission=admission, single_flight=single_flight,
            )
        )
    bb.reset_accounting()
    return RPCFleet(rpcs, policy if policy is not None else cfg.policy(),
                    backbone=bb)


# --------------------------------------------------------------------------
# serve_grid: routing policy x workload sequential grid
# --------------------------------------------------------------------------

def run_serve_grid(ctx: ScenarioContext) -> dict:
    cfg, smoke = ctx.config, ctx.smoke
    layout, contract, bb, sps, metas, _ = _world(cfg, smoke,
                                                 device=ctx.device)
    c0 = engine_counters()
    grid_json = {}
    for pname, policy_factory in POLICY_FACTORIES.items():
        for wname, workload in _workloads(metas, smoke).items():
            fleet = _fresh_fleet(cfg, layout, contract, bb, sps,
                                 policy_factory())
            reader = ShelbyClient(contract, fleet, deposit=1e9)
            reqs = workload()
            t0 = time.perf_counter()
            span_end = 0.0
            with reader.session() as session:
                for req in reqs:
                    receipt = session.read(
                        req.blob_id, req.offset, req.length,
                        client=req.client, t_ms=req.t_ms,
                    )
                    assert len(receipt.data) == min(
                        req.length, contract.blobs[req.blob_id].size_bytes - req.offset
                    )
                    span_end = max(span_end, req.t_ms + receipt.latency_ms)
            settlement = session.settlement
            # per-serving-node settlement matches the receipts (float-tol)
            assert abs(settlement.total_node_income
                       - sum(r.total_paid for r in session.receipts)) < 1e-3
            wall = time.perf_counter() - t0
            span_ms = span_end - reqs[0].t_ms
            goodput_mbps = fleet.bytes_served * 8e-3 / span_ms
            p50, p99 = fleet.latency_percentiles(50.0, 99.0)
            row(
                f"backbone_serve/{pname}_{wname}",
                wall * 1e6 / len(reqs),
                f"goodput={goodput_mbps:.1f}Mbps;p50={p50:.1f}ms;p99={p99:.1f}ms;"
                f"hedges={fleet.hedges_launched()};waste={fleet.hedged_wasted()};"
                f"cache_hit={fleet.cache_hit_rate():.2f}",
            )
            grid_json[f"{pname}_{wname}"] = {
                "goodput_mbps": goodput_mbps,
                "p50_ms": p50,
                "p99_ms": p99,
                "hedges_launched": fleet.hedges_launched(),
                "hedged_wasted": fleet.hedged_wasted(),
                "cache_hit_rate": fleet.cache_hit_rate(),
                "coalesced": fleet.coalesced(),
                "shed_rate": 0.0,  # sequential grid never saturates a node
            }
    grid_json["engine"] = _engine_stats(c0)
    # the straggler-shield bars (zipf p99 < 250 ms per policy) are the
    # scenario's declared SLOs — asserted by the runner against this payload
    return grid_json


# --------------------------------------------------------------------------
# concurrent: open-loop Poisson storm, free vs admitted ramp
# --------------------------------------------------------------------------

CONCURRENT_RATES_RPS = (200, 1000, 5000)  # offered load ramp


def run_concurrent(ctx: ScenarioContext) -> dict:
    """Open-loop Poisson Zipf storm through the SHARED event engine.

    All requests of a run live on one heap: hedge timers interleave, SPs
    queue on their disk slots, nodes serialize on 10 Gbps NICs.  Asserts
    the determinism digest (two identical runs on fresh fleets -> byte-
    identical per-request timings and link utilization), then ramps the
    offered load TWICE — once with no admission control, once with the
    overload controller described by ``cfg.admission()`` — so the bench
    trajectory shows the paper's serving story under stress: the
    free-running fleet's p99 explodes past the saturation knee, the
    admission-controlled fleet sheds the excess (typed NACKs that debit
    nothing) and keeps the admitted tail bounded, while single-flight
    dedup collapses hot-object stampedes (the declared SLOs).
    """
    cfg, smoke = ctx.config, ctx.smoke
    nic = cfg.nic()  # 10 Gbps full-duplex per node by default
    layout, contract, bb, sps, metas, _ = _world(cfg, smoke, nic=nic,
                                                 sp_slots=2, device=ctx.device)
    num_requests = 100 if smoke else 400
    # past the fetch budget a node sheds instead of queueing; the scenario
    # registers rpc_max_inflight_fetches=6 — sweeps move it
    admitted_spec = cfg.admission()

    def one_run(rate_rps, admission=None, single_flight=True):
        fleet = _fresh_fleet(cfg, layout, contract, bb, sps,
                             nic=nic, cache_chunksets=8, admission=admission,
                             single_flight=single_flight)
        reader = ShelbyClient(contract, fleet, deposit=1e9)
        reqs = zipf_hotset(
            metas, clients=["client0", "client1", "client2"],
            num_requests=num_requests, interarrival_ms=1000.0 / rate_rps,
            seed=11, arrival="poisson",
        )
        with reader.session() as session:
            receipts, result = session.replay(reqs)
        settlement = session.settlement
        assert abs(settlement.total_node_income
                   - sum(r.total_paid for r in session.receipts)) < 1e-3
        return fleet, result

    # determinism gate: identical workload on a fresh fleet, twice
    _, a = one_run(CONCURRENT_RATES_RPS[0])
    _, b = one_run(CONCURRENT_RATES_RPS[0])
    assert a.digest() == b.digest(), (
        f"determinism violated: {a.digest()[:16]} != {b.digest()[:16]}"
    )
    print(f"# concurrent determinism digest: {a.digest()[:16]} OK")

    ramp_json = {}
    c0 = engine_counters()
    for rate in CONCURRENT_RATES_RPS:
        per_rate = {"offered_rps": rate}
        # "free" is the PR-3 fleet (no dedup, no admission — queues grow
        # without bound); "admitted" is the overload-safe serving path
        # (single-flight stampede collapse + per-node fetch budget)
        for mode, admission, single_flight in (
            ("free", None, False),
            ("admitted", admitted_spec, cfg.rpc_single_flight),
        ):
            t0 = time.perf_counter()
            fleet, result = one_run(rate, admission, single_flight)
            wall = time.perf_counter() - t0
            p50, p99 = result.percentile(50.0), result.percentile(99.0)
            row(
                f"backbone_serve/concurrent_{mode}_{rate}rps",
                wall * 1e6 / num_requests,
                f"goodput={result.goodput_mbps:.1f}Mbps;p50={p50:.1f}ms;"
                f"p99={p99:.1f}ms;shed={result.shed};dropped={result.dropped};"
                f"hedges={fleet.hedges_launched()};waste={fleet.hedged_wasted()};"
                f"coalesced={fleet.coalesced()}",
            )
            per_rate[mode] = {
                "goodput_mbps": result.goodput_mbps,
                "p50_ms": p50,
                "p99_ms": p99,
                "shed_rate": result.shed_rate,
                "dropped": result.dropped,
                "hedges_launched": fleet.hedges_launched(),
                "hedged_wasted": fleet.hedged_wasted(),
                "coalesced": fleet.coalesced(),
                "retried_legs": fleet.retried_legs,
                "engine_events_per_sec": result.engine_events_per_sec,
            }
        ramp_json[f"{rate}rps"] = per_rate
    ramp_json["engine"] = _engine_stats(c0)
    # the saturation story is declared as SLOs on the registration below:
    # free p99 grows with offered load, single-flight coalesces the hot
    # set, the admitted fleet sheds past the knee and keeps its tail
    # below the free-running one
    return ramp_json


# --------------------------------------------------------------------------
# background: serving tail under full audit+repair load
# --------------------------------------------------------------------------

def run_background(ctx: ScenarioContext) -> dict:
    """Serving p50/p99 quiescent vs. under FULL audit+repair load — the
    quantitative "auditing does not compromise performance" reproduction.

    Two replays of the same Poisson Zipf storm on fresh fleets over one
    world: *quiescent* (foreground only), then *loaded* — every stored
    chunk is audit-challenged (p_a=1.0: proof generation holds auditee
    disk slots in the background class, proof broadcasts cross NICs and
    trunks to 3 auditors each) while the repair plane rebuilds every chunk
    of the crashed SP (helper reads + re-dispersal as background
    transfers).  The paced background must keep serving p99 inflation
    within ``cfg.bg_p99_budget`` (the declared SLO) and audit/repair
    bytes must actually show up in the NIC/link counters (no free
    background work — asserted inline).
    """
    cfg, smoke = ctx.config, ctx.smoke
    nic = cfg.nic()
    layout, contract, bb, sps, metas, _ = _world(cfg, smoke, nic=nic,
                                                 sp_slots=2, device=ctx.device)
    c0 = engine_counters()
    bb.register_node("repairer", "dc0", nic=nic)
    num_requests = 80 if smoke else 300
    rate_rps = 400.0  # busy but below the knee: contention is measurable
    sp_nodes = {i: f"sp{i}" for i in sps}

    def one_run(background=None):
        fleet = _fresh_fleet(cfg, layout, contract, bb, sps,
                             nic=nic, cache_chunksets=8)
        reader = ShelbyClient(contract, fleet, deposit=1e9)
        reqs = zipf_hotset(
            metas, clients=["client0", "client1", "client2"],
            num_requests=num_requests, interarrival_ms=1000.0 / rate_rps,
            seed=7, arrival="poisson",
        )
        t0 = time.perf_counter()
        with reader.session() as session:
            _, result = session.replay(reqs, background=background)
        return fleet, result, time.perf_counter() - t0

    # quiescent baseline FIRST (repairs mutate placement for later runs)
    _, quiet, wall_q = one_run()
    q50, q99 = quiet.percentile(50.0), quiet.percentile(99.0)
    row(
        "backbone_serve/background_quiescent",
        wall_q * 1e6 / num_requests,
        f"goodput={quiet.goodput_mbps:.1f}Mbps;p50={q50:.1f}ms;p99={q99:.1f}ms",
    )

    # full audit pressure: challenge EVERY stored chunk this epoch
    sp_ids = [s.sp_id for s in contract.active_sps()]
    challenges = audit_mod.derive_challenges(
        contract.epoch_seed(0), 0, contract.holdings(), sp_ids,
        p_a=1.0, auditors_per_audit=3,
    )
    audits = AuditPlane(contract, sps, challenges, nodes=sp_nodes)
    rc = RepairCoordinator(contract, sps, layout, nodes=sp_nodes,
                           coordinator_node="repairer")
    repairs = RepairPlane(rc)  # scans at spawn: the crashed SP's chunks
    _, loaded, wall_l = one_run(background=[audits, repairs])
    l50, l99 = loaded.percentile(50.0), loaded.percentile(99.0)
    audit_recs = [b for b in loaded.background if b.kind == "audit"]
    repair_recs = [b for b in loaded.background if b.kind == "repair"]
    repaired_ok = sum(1 for b in repair_recs if b.ok)
    row(
        "backbone_serve/background_loaded",
        wall_l * 1e6 / num_requests,
        f"goodput={loaded.goodput_mbps:.1f}Mbps;p50={l50:.1f}ms;p99={l99:.1f}ms;"
        f"audits={len(audit_recs)};repairs={repaired_ok};"
        f"bg_bytes={loaded.background_bytes}",
    )

    # background work is real: it moved bytes over NICs and trunks …
    assert audits.proof_bytes > 0, "audit proofs crossed no link"
    assert repaired_ok > 0 and sum(b.nbytes for b in repair_recs) > 0, (
        "repair plane moved no bytes"
    )
    repairer_in = bb.nic_bytes.get(("in", "repairer"), 0)
    assert repairer_in > 0, "helper bytes never crossed the repairer's NIC"
    link_delta = sum(loaded.link_bytes.values()) - sum(quiet.link_bytes.values())
    bg_net_bytes = audits.proof_bytes + repairer_in
    assert link_delta >= 0.5 * bg_net_bytes, (
        f"background bytes missing from link counters: delta={link_delta} "
        f"vs bg={bg_net_bytes}"
    )
    # … and every foreground read was still served (background never
    # starves paid traffic: bg waiters yield to queued reads)
    assert loaded.dropped == quiet.dropped == 0, (
        f"reads dropped: loaded={loaded.dropped} quiescent={quiet.dropped}"
    )
    # the paper's bar — paced audits+repair inflate serving p99 only
    # within the configured budget — is the declared p99_inflation SLO

    return {
        "quiescent": {"goodput_mbps": quiet.goodput_mbps, "p50_ms": q50,
                      "p99_ms": q99,
                      "engine_events_per_sec": quiet.engine_events_per_sec},
        "loaded": {"goodput_mbps": loaded.goodput_mbps, "p50_ms": l50,
                   "p99_ms": l99,
                   "engine_events_per_sec": loaded.engine_events_per_sec},
        "p99_inflation": l99 / q99 if q99 > 0 else 1.0,
        "p99_budget": cfg.bg_p99_budget,
        "audit_ops": len(audit_recs),
        "audit_proof_bytes": audits.proof_bytes,
        "repairs_ok": repaired_ok,
        "repair_failures": len(repairs.failures),
        "background_bytes": loaded.background_bytes,
        "bg_p99_ms": loaded.background_percentile(99.0),
        "repairer_nic_in_bytes": repairer_in,
        "engine": _engine_stats(c0),
    }


# --------------------------------------------------------------------------
# churn: serving through a membership change + measured durability
# --------------------------------------------------------------------------

def run_churn(ctx: ScenarioContext) -> dict:
    """Serving p99 THROUGH a membership change, plus the reproduction's
    two durability metrics — the §2.5 epoch-reconfiguration story.

    A scripted tolerable churn scenario (never more than m simultaneous
    failures per chunkset: one SP is already crashed from the write phase,
    then one announced departure / crash per epoch plus a mid-epoch join)
    runs UNDER a live Poisson Zipf storm: the membership plane finalizes
    departures at epoch boundaries, the contract remaps the displaced
    placement entries, and the re-dispersal backlog drains through the
    repair plane while paid reads keep flowing.  Declared SLOs: zero lost
    chunksets, zero repair failures, p99 inflation through the change
    within ``cfg.churn_p99_budget``.  Inline: bit-exact decode through
    the SAME fleet, departed-never-paid, per-epoch drain within
    ``cfg.churn_drain_budget_ms``, same-seed digest equality, and the
    monotone measured-durability series.
    """
    cfg, smoke = ctx.config, ctx.smoke
    nic = cfg.nic()
    c0 = engine_counters()
    num_requests = 80 if smoke else 300
    rate_rps = 400.0
    epochs = 3
    epoch_ms = cfg.churn_epoch_ms
    # tolerable by construction: sp1 is crashed from the write phase, so
    # at most one scripted removal lands per epoch (<= m=2 concurrent
    # failures per chunkset), each AFTER the previous boundary's backlog
    # drained; a joiner arrives mid-run and is eligible for re-dispersal
    scripted = (
        (0, "announce", 2, 0.2),
        (1, "join", -1, 0.3),
        (1, "crash", 3, 0.6),
        (2, "announce", 4, 0.3),
    )

    def reqs_for(metas):
        return zipf_hotset(
            metas, clients=["client0", "client1", "client2"],
            num_requests=num_requests, interarrival_ms=1000.0 / rate_rps,
            seed=13, arrival="poisson",
        )

    def churn_world():
        """The shared world minus the 250 ms straggler: repair helpers
        sleep their full service time holding ONE background slot, so a
        straggler trivially dominates the drain-time metric this scenario
        asserts (the straggler story stays covered by the serve grid and
        the background scenario).  The post-write crashed SP stays — its
        chunks are exactly what the first boundary must re-disperse."""
        layout, contract, bb, sps, metas, datas = _world(cfg, smoke, nic=nic,
                                                         sp_slots=2,
                                                         device=ctx.device)
        sps[0].behavior.latency_ms = 12.0
        bb.register_node("repairer", "dc0", nic=nic)
        return layout, contract, bb, sps, metas, datas

    def churn_run():
        """Fresh world + fleet + membership plane, storm replayed through
        the churn.  Returns everything the asserts below need."""
        layout, contract, bb, sps, metas, datas = churn_world()
        fleet = _fresh_fleet(cfg, layout, contract, bb, sps,
                             nic=nic, cache_chunksets=8)
        sp_nodes = {i: f"sp{i}" for i in sps}
        rc = RepairCoordinator(contract, sps, layout, nodes=sp_nodes,
                               coordinator_node="repairer")
        mplane = MembershipPlane(
            contract, sps, layout, ChurnSpec(seed=0, scripted=scripted),
            repair=rc, fleet=fleet, backbone=bb, nodes=sp_nodes, nic=nic,
            epochs=epochs, epoch_ms=epoch_ms,
            service_factory=lambda: cfg.service(slots=2),
        )
        reader = ShelbyClient(contract, fleet, deposit=1e9)
        t0 = time.perf_counter()
        with reader.session() as session:
            _, result = session.replay(reqs_for(metas),
                                       background=mplane.planes())
        wall = time.perf_counter() - t0
        return dict(contract=contract, bb=bb, sps=sps, metas=metas,
                    datas=datas, fleet=fleet, mplane=mplane, result=result,
                    reader=reader, wall=wall)

    # quiescent baseline FIRST: same world shape, same storm, no churn
    layout, contract, bb, sps, metas, _ = churn_world()
    fleet = _fresh_fleet(cfg, layout, contract, bb, sps,
                         nic=nic, cache_chunksets=8)
    reader = ShelbyClient(contract, fleet, deposit=1e9)
    with reader.session() as session:
        _, quiet = session.replay(reqs_for(metas))
    q50, q99 = quiet.percentile(50.0), quiet.percentile(99.0)
    row("backbone_serve/churn_quiescent", 0.0,
        f"goodput={quiet.goodput_mbps:.1f}Mbps;p50={q50:.1f}ms;p99={q99:.1f}ms")

    a = churn_run()
    mplane, res = a["mplane"], a["result"]
    c50, c99 = res.percentile(50.0), res.percentile(99.0)
    drains = [st.drain_ms() for st in mplane.epoch_stats]
    row(
        "backbone_serve/churn_loaded",
        a["wall"] * 1e6 / num_requests,
        f"goodput={res.goodput_mbps:.1f}Mbps;p50={c50:.1f}ms;p99={c99:.1f}ms;"
        f"events={len(mplane.events)};reassigned={mplane.reassigned_total};"
        f"lost={mplane.lost_chunksets};"
        f"drain={max(drains):.0f}ms",
    )

    # (a) at tolerable churn the backlog was real work and every blob
    # decodes bit-exact through the SAME fleet that served through the
    # reconfigurations (stale hot-cache entries must have version-
    # invalidated; no read resolves to a departed SP); zero lost
    # chunksets / zero repair failures are the declared SLOs
    assert mplane.repair is not None and mplane.repair.enqueued_total > 0
    assert res.dropped == 0 and res.shed == 0
    departed = sorted(a["contract"].dead_sps())
    assert departed, "scenario churned nobody"
    paid_before = {i: a["sps"][i].earned_reads for i in departed}
    with a["reader"].session() as session:
        for meta, data in zip(a["metas"], a["datas"]):
            got = session.read(meta.blob_id, 0, meta.size_bytes,
                               client="client0")
            assert got.data == data, f"blob {meta.blob_id} not bit-exact"
    for i in departed:
        assert a["sps"][i].earned_reads == paid_before[i], (
            f"departed sp{i} was paid after reconfiguration"
        )

    # (b) every boundary's re-dispersal backlog drained inside the budget
    assert mplane.repair.backlog() == 0, f"backlog stuck: {mplane.repair.backlog()}"
    for st, d in zip(mplane.epoch_stats, drains):
        assert d == d and d <= cfg.churn_drain_budget_ms, (
            f"epoch {st.epoch} backlog ({st.enqueued} chunks) drained in "
            f"{d:.0f}ms > budget {cfg.churn_drain_budget_ms:.0f}ms"
        )
    # re-dispersal moved real bytes through the repairer's NIC
    repairer_in = a["bb"].nic_bytes.get(("in", "repairer"), 0)
    assert repairer_in > 0, "re-dispersal crossed no link"

    # (c) serving p99 through the membership change: the p99_inflation SLO

    # (d) same-seed determinism: a fresh world + fleet churned identically
    # produces the SAME digest (membership + repair records ride it)
    b = churn_run()
    assert a["result"].digest() == b["result"].digest(), (
        f"churn determinism violated: {a['result'].digest()[:16]} != "
        f"{b['result'].digest()[:16]}"
    )
    print(f"# churn determinism digest: {res.digest()[:16]} OK")

    # measured durability series: lost-chunkset probability vs churn rate
    # (tiny seeded worlds, losses COUNTED by the boundary census, repair
    # racing the failures) — zero at tolerable rates, nonzero beyond the
    # redundancy budget, monotone under the per-seed coupling
    rates = (0.0, 0.15, 0.3, 0.5)
    seeds = (0, 1) if smoke else (0, 1, 2, 3)
    points = measure_durability(rates, seeds=seeds, epochs=2, repair=True,
                                device=ctx.device)
    series = durability.measured_loss_series(points)
    probs = series["loss_probability"]
    for pt in points:
        print(f"# churn_rate={pt.churn_rate:.2f} "
              f"loss={pt.loss_probability:.3f} ({pt.lost}/{pt.chunksets}) "
              f"analytic_no_repair={pt.analytic_no_repair:.3f}")
    assert probs[0] == 0.0, "lost chunksets with zero churn"
    assert probs[-1] > 0.0, "no measured loss beyond the redundancy budget"
    assert all(x <= y + 1e-12 for x, y in zip(probs, probs[1:])), (
        f"loss probability not monotone in churn rate: {probs}"
    )

    return {
        "quiescent": {"goodput_mbps": quiet.goodput_mbps, "p50_ms": q50,
                      "p99_ms": q99,
                      "engine_events_per_sec": quiet.engine_events_per_sec},
        "churned": {"goodput_mbps": res.goodput_mbps, "p50_ms": c50,
                    "p99_ms": c99,
                    "engine_events_per_sec": res.engine_events_per_sec},
        "p99_inflation": c99 / q99 if q99 > 0 else 1.0,
        "p99_budget": cfg.churn_p99_budget,
        "epochs": epochs,
        "epoch_ms": epoch_ms,
        "membership_events": len(mplane.events),
        "sps_joined": len(mplane.joined),
        "sps_departed": len(departed),
        "reassigned": mplane.reassigned_total,
        "repairs_enqueued": mplane.repair.enqueued_total,
        "repair_failures": len(mplane.repair.failures),
        "drain_ms_per_epoch": drains,
        "drain_budget_ms": cfg.churn_drain_budget_ms,
        "lost_chunksets": mplane.lost_chunksets,
        "repairer_nic_in_bytes": repairer_in,
        "durability": series,
        "digest": res.digest()[:16],
        "engine": _engine_stats(c0),
    }


# --------------------------------------------------------------------------
# das: the proof-carrying light-client read regime
# --------------------------------------------------------------------------

def run_das(ctx: ScenarioContext) -> dict:
    """The proof-carrying light-client read regime (§2.3's missing corner):
    millions of tiny random reads instead of few large streams.

    Three verifiable claims:

    * **Detection math.** Over clean mini-worlds with seeded exact-count
      withholding adversaries (including a zero-withholding control), the
      measured per-epoch detection rate matches ``1-(1-q)^s`` within
      Monte-Carlo tolerance for every (fraction, seed) cell — the formula
      is exact because coordinates are drawn with replacement and the
      adversary withholds an exact share count (asserted inline per cell).
    * **Sampling beats auditing on bytes.** A withholding SP retains the
      data, so chunk-possession audits are structurally blind; the mean
      wire bytes a sampler spends until its first detection stay below
      ONE full-chunk audit read (the declared bytes_to_detect SLO).
    * **Cache steering.** A cache-hostile uniform DAS storm rides the
      shared event engine CONCURRENTLY with the Zipf streaming workload.
      With the ``cache_bypass`` hint (the default) the streaming fleet
      cache hit rate is untouched and streaming p99 stays inside
      ``cfg.das_p99_budget``; a counterfactual storm that ignores the
      hint pollutes the LRU and measurably drops the hit rate.  Two
      same-seed combined runs produce identical determinism digests
      (sample records ride the digest like reads).

    The storm runs over the shared adversity world — shares dispersed
    before the post-write straggler/crash, so samples landing on the
    crashed SP surface as detections (a crashed holder IS unavailable).
    """
    cfg, smoke = ctx.config, ctx.smoke
    spec = DASSpec(k=cfg.das_k, share_bytes=cfg.das_share_bytes,
                   samples_per_epoch=cfg.das_samples_per_epoch,
                   proof_bytes_per_share=cfg.das_proof_bytes_per_share)
    c0 = engine_counters()

    # -- (a) measured detection vs the analytic curve ------------------------
    fractions = (0.0, 0.05, 0.15, 0.30)
    seeds = (0, 1, 2)
    rounds, num_blobs = (8, 8) if smoke else (12, 12)
    tol = 0.20 if smoke else 0.15  # ~3.5 sigma of a 64/144-trial Bernoulli mean
    t0 = time.perf_counter()
    points = measure_detection(fractions, seeds, spec=spec,
                               num_blobs=num_blobs, rounds=rounds,
                               device=ctx.device)
    wall_det = time.perf_counter() - t0
    for pt in points:
        print(f"# das q={pt.q_effective:.3f} s={pt.samples} "
              f"measured={pt.measured:.3f} analytic={pt.analytic:.3f} "
              f"({pt.detected}/{pt.trials})")
        assert abs(pt.measured - pt.analytic) <= tol, (
            f"detection off the analytic curve: q={pt.q_effective:.3f} "
            f"measured={pt.measured:.3f} vs {pt.analytic:.3f} (tol {tol})"
        )
        if pt.q_effective == 0.0:
            assert pt.detected == 0, "false positive with nothing withheld"

    # -- (b) a withholding SP costs fewer bytes to catch than one audit ------
    layout = BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024,
                        device=ctx.device)
    worst = [pt for pt in points if pt.fraction == max(fractions) and pt.detected]
    assert worst, "no detections at the highest withholding fraction"
    detect_bytes = [pt.mean_samples_to_detect * pt.mean_sample_bytes for pt in worst]
    mean_detect_bytes = sum(detect_bytes) / len(detect_bytes)
    # mean_detect_bytes < one full-chunk audit read is the declared SLO

    # -- (c) the concurrent storm: cache steering + tail + determinism -------
    nic = cfg.nic()
    layout, contract, bb, sps, metas, datas = _world(cfg, smoke, nic=nic,
                                                     sp_slots=2,
                                                     device=ctx.device)
    sps[1].recover()  # shares disperse BEFORE the post-write adversity,
    records = extend_and_disperse_many(  # exactly like the blobs themselves
        contract, sps, [(m.blob_id, d) for m, d in zip(metas, datas)], spec,
        device=ctx.device,
    )
    sps[1].crash()
    assert all(r.proof_bytes > 0 for r in records)
    num_fg = 80 if smoke else 300
    num_das = 120 if smoke else 400
    clients = ["client0", "client1", "client2"]

    def foreground():
        return zipf_hotset(metas, clients=clients, num_requests=num_fg,
                           interarrival_ms=1000.0 / 400.0, seed=19,
                           arrival="poisson")

    def storm(cache_bypass=True):
        return das_storm(records, clients=clients, num_requests=num_das,
                         interarrival_ms=0.5, seed=17,
                         cache_bypass=cache_bypass)

    def one_run(reqs, label):
        fleet = _fresh_fleet(cfg, layout, contract, bb, sps,
                             nic=nic, cache_chunksets=8)
        reader = ShelbyClient(contract, fleet, deposit=1e9, das=spec)
        t0 = time.perf_counter()
        with reader.session() as session:
            _, result = session.replay(reqs)
        settlement = session.settlement
        # pay-per-sample rides the same conservation check as paid reads
        assert abs(settlement.total_node_income
                   - sum(r.total_paid for r in session.receipts)) < 1e-3
        return fleet, result, time.perf_counter() - t0

    def fetches(f):
        return sum(n.stats.chunkset_fetches for n in f.rpcs)

    def effective_hit_rate(f):
        # a coalesced miss rides another request's in-flight fetch — like a
        # hit, it costs the SPs nothing; storm contention only shifts hits
        # into the coalesced bucket (and hedged legs may add/skip a fetch),
        # never evicts streaming entries
        hits = sum(n.stats.cache_hits for n in f.rpcs)
        total = hits + fetches(f) + f.coalesced()
        return (hits + f.coalesced()) / total if total else 0.0

    fg_only = foreground()
    combined = sorted(fg_only + storm(), key=lambda r: r.t_ms)
    polluted = sorted(fg_only + storm(cache_bypass=False), key=lambda r: r.t_ms)

    base_fleet, base, wall_b = one_run(fg_only, "baseline")
    h0, p99_0 = base_fleet.cache_hit_rate(), base.percentile(99.0, kind="read")
    fleet, res, wall_c = one_run(combined, "combined")
    h1, p99_1 = fleet.cache_hit_rate(), res.percentile(99.0, kind="read")
    pol_fleet, pol, _ = one_run(polluted, "polluted")
    h2 = pol_fleet.cache_hit_rate()

    served = fleet.samples_served()
    proof_bytes = fleet.sample_proof_bytes()
    row(
        "backbone_serve/das_storm",
        wall_c * 1e6 / len(combined),
        f"samples={served};withheld={fleet.samples_withheld()};"
        f"detections={res.das_detections};shed={res.shed};"
        f"proof_bytes={proof_bytes};stream_p99={p99_1:.1f}ms;"
        f"cache_hit={h1:.2f}(base {h0:.2f}, polluted {h2:.2f})",
    )

    assert served > 0 and proof_bytes > 0, "storm verified no proof-carrying reads"
    # the cache_bypass hint keeps the streaming hot cache untouched: the
    # storm never evicts streaming entries, so the cache's absorption
    # (hits + coalesced per lookup) is conserved and the SP fetch count
    # moves only by hedged legs firing differently under contention
    eff0, eff1 = effective_hit_rate(base_fleet), effective_hit_rate(fleet)
    assert abs(eff1 - eff0) <= 0.01, (
        f"DAS storm cost streaming cache absorption: {eff1:.4f} vs "
        f"baseline {eff0:.4f}"
    )
    assert abs(fetches(fleet) - fetches(base_fleet)) <= 2 + fleet.hedges_launched(), (
        f"DAS storm changed cache contents: {fetches(fleet)} fetches "
        f"vs baseline {fetches(base_fleet)}"
    )
    assert abs(h1 - h0) <= 0.05, (
        f"DAS storm perturbed the streaming cache hit rate: {h1:.3f} vs {h0:.3f}"
    )
    # … while ignoring the hint measurably pollutes the LRU: extra SP
    # fetches for streaming chunksets the storm evicted, a lower hit rate
    assert fetches(pol_fleet) > fetches(fleet), (
        f"cache-hostile storm without bypass did not pollute: "
        f"{fetches(pol_fleet)} fetches !> {fetches(fleet)}"
    )
    assert h2 < h1 - 0.05, (
        f"cache-hostile storm without bypass did not pollute: {h2:.3f} !< {h1:.3f}"
    )
    # streaming tail stays inside the DAS budget under the concurrent storm
    bound = cfg.das_p99_budget * p99_0 + 5.0
    assert p99_1 <= bound, (
        f"DAS storm blew the streaming tail: p99 {p99_1:.1f}ms > "
        f"bound {bound:.1f}ms (baseline {p99_0:.1f}ms)"
    )
    # same-seed determinism: the interleaved storm rides the digest
    _, res2, _ = one_run(sorted(fg_only + storm(), key=lambda r: r.t_ms), "redo")
    assert res.digest() == res2.digest(), (
        f"das determinism violated: {res.digest()[:16]} != {res2.digest()[:16]}"
    )
    print(f"# das determinism digest: {res.digest()[:16]} OK")

    share_bytes_served = served * spec.share_bytes
    return {
        "spec": {"k": spec.k, "side": spec.side, "share_bytes": spec.share_bytes,
                 "samples_per_epoch": spec.samples_per_epoch,
                 "proof_bytes_per_share": records[0].proof_bytes},
        "detection": [
            {"fraction": pt.fraction, "q_effective": pt.q_effective,
             "samples": pt.samples, "trials": pt.trials,
             "measured": pt.measured, "analytic": pt.analytic,
             "mean_samples_to_detect": (
                 pt.mean_samples_to_detect
                 if pt.mean_samples_to_detect != float("inf") else None),
             "mean_sample_bytes": pt.mean_sample_bytes}
            for pt in points
        ],
        "detection_tolerance": tol,
        "detection_wall_s": wall_det,
        "bytes_to_detect": mean_detect_bytes,
        "full_chunk_audit_bytes": layout.chunk_bytes,
        "storm": {
            "requests": num_das,
            "samples_served": served,
            "samples_withheld": fleet.samples_withheld(),
            "detections": res.das_detections,
            "shed": res.shed,
            "proof_bytes": proof_bytes,
            "proof_overhead": (proof_bytes / share_bytes_served
                               if share_bytes_served else 0.0),
            "sample_p99_ms": res.percentile(99.0, kind="das"),
            "goodput_mbps": res.goodput_mbps,
            "engine_events_per_sec": res.engine_events_per_sec,
        },
        "streaming": {
            "p99_baseline_ms": p99_0, "p99_under_storm_ms": p99_1,
            "p99_budget": cfg.das_p99_budget,
            "cache_hit_baseline": h0, "cache_hit_under_storm": h1,
            "cache_hit_polluted": h2,
            "chunkset_fetches_baseline": fetches(base_fleet),
            "chunkset_fetches_under_storm": fetches(fleet),
            "chunkset_fetches_polluted": fetches(pol_fleet),
            "effective_hit_baseline": eff0,
            "effective_hit_under_storm": eff1,
        },
        "digest": res.digest()[:16],
        "engine": _engine_stats(c0),
    }


# --------------------------------------------------------------------------
# tune_admission: the sweep/hill-climb target
# --------------------------------------------------------------------------

def run_tune_admission(ctx: ScenarioContext) -> dict:
    """ONE admitted Poisson Zipf storm at 3x saturation — the cheapest
    run whose outcome genuinely depends on the overload knobs, built as
    the optimiser's objective function.

    Every knob the overload controller owns comes off ``ctx.config``
    (``cfg.admission()``, ``cfg.rpc_single_flight``, cache TTL, hedge
    deadline, routing policy), so a sweep point IS a config.  The payload
    carries the replay determinism digest: every evaluated point is
    reproducible bit-for-bit from (scenario, knobs, seed).

    Objective shape (see ``scenarios/sweep.py``): maximize ``goodput_mbps`` subject to
    the declared SLOs — with admission OFF (the ShelbyConfig default)
    the storm's p99 blows past the 150 ms SLO and the point is
    infeasible; the registered knobs (fetch budget 6) are a feasible
    default the optimiser must beat or match.
    """
    cfg, smoke = ctx.config, ctx.smoke
    nic = cfg.nic()
    layout, contract, bb, sps, metas, _ = _world(cfg, smoke, nic=nic,
                                                 sp_slots=2, device=ctx.device)
    num_requests = 60 if smoke else 300
    rate_rps = 5000.0  # 3x past the knee: admission is the story
    c0 = engine_counters()

    fleet = _fresh_fleet(cfg, layout, contract, bb, sps,
                         nic=nic, cache_chunksets=8,
                         admission=cfg.admission(),
                         single_flight=cfg.rpc_single_flight)
    reader = ShelbyClient(contract, fleet, deposit=1e9)
    reqs = zipf_hotset(
        metas, clients=["client0", "client1", "client2"],
        num_requests=num_requests, interarrival_ms=1000.0 / rate_rps,
        seed=29, arrival="poisson",
    )
    t0 = time.perf_counter()
    with reader.session() as session:
        _, result = session.replay(reqs)
    wall = time.perf_counter() - t0
    settlement = session.settlement
    assert abs(settlement.total_node_income
               - sum(r.total_paid for r in session.receipts)) < 1e-3
    p50, p99 = result.percentile(50.0), result.percentile(99.0)
    row(
        "backbone_serve/tune_admission",
        wall * 1e6 / num_requests,
        f"goodput={result.goodput_mbps:.1f}Mbps;p50={p50:.1f}ms;"
        f"p99={p99:.1f}ms;shed={result.shed};coalesced={fleet.coalesced()}",
    )
    return {
        "offered_rps": rate_rps,
        "requests": num_requests,
        "goodput_mbps": result.goodput_mbps,
        "p50_ms": p50,
        "p99_ms": p99,
        "shed_rate": result.shed_rate,
        "dropped": result.dropped,
        "coalesced": fleet.coalesced(),
        "hedges_launched": fleet.hedges_launched(),
        "hedged_wasted": fleet.hedged_wasted(),
        "knobs": {
            "rpc_max_inflight_fetches": cfg.rpc_max_inflight_fetches,
            "rpc_max_queued_requests": cfg.rpc_max_queued_requests,
            "rpc_shed_deadline_ms": cfg.rpc_shed_deadline_ms,
            "rpc_single_flight": cfg.rpc_single_flight,
            "rpc_cache_ttl_ms": cfg.rpc_cache_ttl_ms,
            "rpc_hedge_deadline_factor": cfg.rpc_hedge_deadline_factor,
            "routing_policy": cfg.routing_policy,
        },
        "digest": result.digest()[:16],
        "engine": _engine_stats(c0),
    }


# --------------------------------------------------------------------------
# registrations
# --------------------------------------------------------------------------

register(
    name="serve_grid",
    description=("Sequential routing-policy x workload serving grid over "
                 "the adversity world (straggler + crashed SP)"),
    workload="video/training/zipf/analytics, one request at a time",
    section="serve_grid",
    run=run_serve_grid,
    slos=(
        SLO("latency_zipf.p99_ms", "<", 250.0,
            description="hedging shields the zipf tail from the 250 ms "
                        "straggler (latency policy)"),
        SLO("affinity_zipf.p99_ms", "<", 250.0,
            description="straggler shield, affinity policy"),
        SLO("p2c_zipf.p99_ms", "<", 250.0,
            description="straggler shield, power-of-two policy"),
    ),
    tunable=("rpc_hedge", "rpc_hedge_deadline_factor", "routing_policy"),
    headline=("affinity_zipf.goodput_mbps", "affinity_zipf.p99_ms",
              "affinity_zipf.cache_hit_rate"),
    budget_s=600,
)

register(
    name="concurrent",
    description=("Open-loop Poisson Zipf storm ramped 200/1000/5000 rps, "
                 "free-running vs admission-controlled, on the shared "
                 "event engine (NICs + SP disk queues live)"),
    workload="zipf_hotset, poisson arrivals, 3-rate ramp x {free, admitted}",
    section="concurrent_ramp",
    run=run_concurrent,
    knobs={"rpc_max_inflight_fetches": 6},
    slos=(
        SLO("5000rps.free.p99_ms", ">=", "200rps.free.p99_ms",
            description="free-running tail grows with offered load"),
        SLO("5000rps.admitted.coalesced", ">", 0,
            description="single-flight collapses the hot-set stampede"),
        SLO("5000rps.admitted.shed_rate", ">", 0.0,
            description="admission sheds past the knee (typed NACKs)"),
        SLO("5000rps.admitted.p99_ms", "<", "5000rps.free.p99_ms",
            description="admitted tail bounded below free-running at 3x "
                        "saturation"),
    ),
    tunable=("rpc_max_inflight_fetches", "rpc_max_queued_requests",
             "rpc_shed_deadline_ms", "rpc_single_flight"),
    headline=("5000rps.admitted.p99_ms", "5000rps.free.p99_ms",
              "5000rps.admitted.shed_rate", "5000rps.admitted.goodput_mbps"),
    budget_s=180,
)

register(
    name="background",
    description=("Serving tail quiescent vs under FULL audit+repair load "
                 "on one world — audits hold SP disk slots in the "
                 "deferrable class, proofs broadcast over real NICs"),
    workload="zipf_hotset 400 rps + p_a=1.0 audit plane + crashed-SP repair",
    section="background",
    run=run_background,
    slos=(
        SLO("p99_inflation", "<=", "bg_p99_budget", atol=0.1,
            description="paced background keeps serving p99 inflation "
                        "within the configured budget (+slack for tiny "
                        "quiescent tails)"),
    ),
    tunable=("bg_slot_share", "bg_pace_ms", "sp_audit_ms_per_proof"),
    headline=("p99_inflation", "audit_ops", "repairs_ok",
              "background_bytes"),
    budget_s=180,
)

register(
    name="churn",
    description=("Epoch-scale membership change under a live storm: "
                 "scripted departures/crashes/joins, boundary census + "
                 "reconfiguration, re-dispersal backlog draining under "
                 "the background budget"),
    workload="zipf_hotset 400 rps through 3 epochs of scripted churn",
    section="churn",
    run=run_churn,
    slos=(
        SLO("lost_chunksets", "<=", 0,
            description="zero data loss at tolerable churn"),
        SLO("repair_failures", "<=", 0,
            description="every re-dispersal succeeded"),
        SLO("p99_inflation", "<=", "churn_p99_budget", atol=0.1,
            description="serving p99 through the membership change stays "
                        "inside the configured budget"),
    ),
    tunable=("churn_epoch_ms", "churn_drain_budget_ms", "bg_slot_share"),
    headline=("p99_inflation", "lost_chunksets", "sps_departed",
              "repairs_enqueued"),
    budget_s=240,
)

register(
    name="das",
    description=("Proof-carrying light-client sampling: measured "
                 "withholding detection on the analytic curve, plus a "
                 "cache-hostile uniform storm riding the engine "
                 "concurrently with streaming"),
    workload="das_storm (uniform, cache_bypass) + zipf streaming, interleaved",
    section="das",
    run=run_das,
    slos=(
        SLO("bytes_to_detect", "<", "full_chunk_audit_bytes",
            description="catching a withholder costs fewer wire bytes "
                        "than ONE full-chunk audit read"),
        SLO("streaming.cache_hit_polluted", "<",
            "streaming.cache_hit_under_storm",
            description="the no-bypass counterfactual measurably pollutes "
                        "the streaming LRU"),
    ),
    tunable=("das_samples_per_epoch", "das_share_bytes", "das_k"),
    headline=("bytes_to_detect", "storm.detections",
              "streaming.cache_hit_under_storm", "streaming.p99_under_storm_ms"),
    budget_s=180,
)

register(
    name="tune_admission",
    description=("One admitted Zipf storm at 3x saturation — the "
                 "optimiser's objective: max goodput s.t. p99 <= 150 ms, "
                 "every evaluated point digest-reproducible"),
    workload="zipf_hotset, poisson arrivals, 5000 rps, admitted fleet",
    section="tune_admission",
    run=run_tune_admission,
    knobs={"rpc_max_inflight_fetches": 6},
    slos=(
        SLO("p99_ms", "<=", 150.0,
            description="the tuning constraint: admitted tail at 3x "
                        "saturation stays under 150 ms"),
        SLO("goodput_mbps", ">", 0.0,
            description="the fleet actually served"),
    ),
    tunable=("rpc_max_inflight_fetches", "rpc_max_queued_requests",
             "rpc_shed_deadline_ms", "rpc_single_flight",
             "rpc_cache_ttl_ms", "rpc_hedge_deadline_factor",
             "routing_policy", "bg_slot_share"),
    headline=("goodput_mbps", "p99_ms", "shed_rate", "digest"),
    budget_s=120,
)
