"""The port's background planes and replay drivers, held against the JAX package.

Audits and repairs run as paced background tasks on the same event loop as
a paid open-loop replay (``AuditPlane``, ``RepairPlane``,
``net/workloads.py::replay_open_loop``, ``ShelbySession.replay``).  The same
seeded backbone world is built in both packages; every background record,
every request record and the replay digest (per-request and per-operation
timings plus per-link byte counters) must be equal: the simulated clock's
float arithmetic is copied op for op, and repair's bytes are exact.
"""
import dataclasses
import importlib

import numpy as np
import pytest

PACKAGES = ("repro", "repro_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _bg_world(pkg, *, num_sps=10, service_ms=4.0, slots=2, num_rpcs=2, seed=0):
    """tests/test_background.py's world: 10 SPs on a 3-DC backbone, two RPC
    nodes, four 150 KB blobs, SP 5 crashed after the writes."""
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    layout = _mod(pkg, "storage.blob").BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024, **kw)
    sp_mod, rpc_mod, fleet_mod = (_mod(pkg, n) for n in ("storage.sp", "storage.rpc", "net.fleet"))
    contract = _mod(pkg, "core.contract").ShelbyContract()
    bb = _mod(pkg, "net.backbone").Backbone.mesh(3, base_latency_ms=4.0, gbps=10.0)
    sps = {}
    for i in range(num_sps):
        dc = f"dc{i % 3}"
        contract.register_sp(_mod(pkg, "core.placement").SPInfo(
            sp_id=i, stake=1000.0, dc=dc, rack=f"r{i % 4}"))
        sps[i] = sp_mod.StorageProvider(i, service=sp_mod.ServiceSpec(
            disk_ms_per_chunk=service_ms, slots=slots, background=sp_mod.BackgroundSpec()))
        bb.register_node(f"sp{i}", dc)
    rpcs = []
    for r in range(num_rpcs):
        node = f"rpc{r}"
        bb.register_node(node, f"dc{r % 3}")
        rpcs.append(rpc_mod.RPCNode(node, contract, sps, layout, cache_chunksets=8,
                                    transport=rpc_mod.BackboneTransport(sps, bb, node)))
    bb.register_node("client", "dc0")
    bb.register_node("repairer", "dc1")
    fleet = fleet_mod.RPCFleet(rpcs, fleet_mod.CacheAffinityPolicy(), backbone=bb)
    client = _mod(pkg, "storage.sdk").ShelbyClient(contract, fleet, deposit=1e9)
    rng = np.random.default_rng(seed)
    datas = [rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes() for _ in range(4)]
    metas = [client.put(d) for d in datas]
    sps[5].crash()  # AFTER the writes: its chunks become repair work
    return layout, contract, bb, sps, fleet, client, metas, datas


def _bg_planes(pkg, layout, contract, sps, *, auditors=3):
    sp_nodes = {i: f"sp{i}" for i in sps}
    challenges = _mod(pkg, "core.audit").derive_challenges(
        contract.epoch_seed(0), 0, contract.holdings(),
        [s.sp_id for s in contract.active_sps()], p_a=1.0, auditors_per_audit=auditors,
    )
    bg = _mod(pkg, "storage.background")
    audits = bg.AuditPlane(contract, sps, challenges, nodes=sp_nodes)
    rc = _mod(pkg, "storage.repair").RepairCoordinator(
        contract, sps, layout, nodes=sp_nodes, coordinator_node="repairer")
    return audits, bg.RepairPlane(rc)


def _reqs(pkg, metas, n=60):
    return _mod(pkg, "net.workloads").zipf_hotset(
        metas, clients=["client"], num_requests=n, interarrival_ms=2.0, seed=3,
        arrival="poisson")


def replay_view(result):
    return (result.digest(), [dataclasses.astuple(r) for r in result.records],
            [dataclasses.astuple(b) for b in result.background], result.span_ms,
            result.dropped, result.shed, result.background_bytes,
            result.background_failures, result.percentile(99.0),
            result.background_percentile(50.0), result.goodput_mbps)


def _both(scenario):
    return {pkg: scenario(pkg) for pkg in PACKAGES}


def test_replay_with_audit_and_repair_planes_matches_reference():
    def scenario(pkg):
        layout, contract, bb, sps, fleet, client, metas, datas = _bg_world(pkg)
        audits, repairs = _bg_planes(pkg, layout, contract, sps)
        result = _mod(pkg, "net.workloads").replay_open_loop(
            fleet, _reqs(pkg, metas), background=[audits, repairs])
        assert result.dropped == 0
        assert {"audit", "repair"} <= {b.kind for b in result.background}
        ok_repairs = [b for b in result.background if b.kind == "repair" and b.ok]
        assert ok_repairs and audits.proof_bytes > 0 and not repairs.failures
        reports = [dataclasses.astuple(r) for r in repairs.rc.reports]
        stored = {(i, key): arr.tobytes() for i, sp in sps.items()
                  for key, arr in sp._chunks.items()}
        return (replay_view(result), audits.proof_bytes, reports, repairs.backlog(),
                stored, bb.utilization())

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_session_replay_with_background_matches_reference():
    """``ShelbySession.replay``: the same digest, receipts and settlement."""
    def scenario(pkg):
        layout, contract, bb, sps, fleet, client, metas, datas = _bg_world(pkg)
        audits, repairs = _bg_planes(pkg, layout, contract, sps)
        reqs = _reqs(pkg, metas, n=40)
        with client.session() as session:
            receipts, result = session.replay(reqs, background=[audits, repairs])
        by_id = {m.blob_id: d for m, d in zip(metas, datas)}
        for req, r in zip(reqs, receipts):
            assert r is not None and r.data == by_id[req.blob_id][req.offset:req.offset + req.length]
        view = [(r.blob_id, r.offset, r.length, r.latency_ms, r.payments, r.cache_hits,
                 r.hedges_launched, r.hedged_wasted, r.coalesced) for r in receipts]
        s = session.settlement
        return replay_view(result), view, (s.deposits, s.client_refunds, s.node_income,
                                           s.sp_income)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_audit_plane_outcomes_match_reference():
    """An SP that silently dropped one chunk fails exactly the challenges
    on it; every auditor's scoreboard bits are equal across packages."""
    def scenario(pkg):
        layout, contract, bb, sps, fleet, client, metas, datas = _bg_world(pkg)
        victim = metas[0].placement[(0, 0)]
        del sps[victim]._chunks[(metas[0].blob_id, 0, 0)]
        challenges = _mod(pkg, "core.audit").derive_challenges(
            contract.epoch_seed(0), 0, contract.holdings(),
            [s.sp_id for s in contract.active_sps()], p_a=1.0, auditors_per_audit=3)
        plane = _mod(pkg, "storage.background").AuditPlane(
            contract, sps, challenges, nodes={i: f"sp{i}" for i in sps})
        loop = _mod(pkg, "net.events").EventLoop(network=bb)
        plane.spawn(loop)
        loop.run()
        failed = sum(1 for r in plane.records if not r.ok)
        assert len(plane.records) == len(challenges) and failed > 0
        bits = {i: {a: list(b) for a, b in sp.scoreboard.bits.items()} for i, sp in sps.items()}
        return [dataclasses.astuple(r) for r in plane.records], plane.proof_bytes, bits, loop.now

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_repair_plane_moves_msr_bytes_as_in_the_reference():
    def scenario(pkg):
        layout, contract, bb, sps, fleet, client, metas, datas = _bg_world(pkg)
        rc = _mod(pkg, "storage.repair").RepairCoordinator(
            contract, sps, layout, nodes={i: f"sp{i}" for i in sps}, coordinator_node="repairer")
        lost = rc.scan_lost_chunks()
        assert lost
        loop = _mod(pkg, "net.events").EventLoop(network=bb)
        plane = _mod(pkg, "storage.background").RepairPlane(rc, lost=lost[:3])
        plane.spawn(loop)
        loop.run()
        expect = (layout.n - 1) * layout.chunk_bytes // layout.code.q
        assert not plane.failures
        assert all(r.helper_bytes_read == expect and r.mode == "msr" and r.sim_ms > 0
                   for r in rc.reports)
        assert sum(bb.link_bytes.values()) >= 3 * expect
        return ([dataclasses.astuple(r) for r in rc.reports],
                [dataclasses.astuple(r) for r in plane.records], dict(bb.link_bytes))

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_closed_loop_replay_with_repair_matches_reference():
    def scenario(pkg):
        layout, contract, bb, sps, fleet, client, metas, datas = _bg_world(pkg)
        _, repairs = _bg_planes(pkg, layout, contract, sps)
        schedules = [("client", [(m.blob_id, 1000 * i, 70_000) for i, m in enumerate(metas)])]
        result = _mod(pkg, "net.workloads").replay_closed_loop(
            fleet, schedules, think_ms=1.5, background=repairs)
        return replay_view(result)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_workload_generators_match_reference():
    def scenario(pkg):
        layout, contract, bb, sps, fleet, client, metas, datas = _bg_world(pkg, num_rpcs=1)
        wl = _mod(pkg, "net.workloads")
        batch = wl.zipf_hotset_batch(metas, clients=["a", "b"], num_requests=50, seed=4,
                                     arrival="poisson")
        return ([dataclasses.astuple(r) for r in wl.video_streaming(metas[0], client="a")],
                [dataclasses.astuple(r) for r in wl.training_epoch(metas, client="a", seed=2)],
                [dataclasses.astuple(r) for r in wl.analytics_scan(metas, client="a")],
                [dataclasses.astuple(r) for r in wl.zipf_hotset(
                    metas, clients=["a", "b"], num_requests=30, seed=5)],
                [dataclasses.astuple(r) for r in batch.to_requests()])

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_unported_replay_paths_raise():
    """A batch replays through the cohort fast path, and the sanitizer is
    ported: no replay option is refused any more."""
    from repro_torch.net.events import EventLoop
    from repro_torch.net.workloads import SampleRequest, replay_open_loop, zipf_hotset_batch
    from repro_torch.storage.sdk import ReceiptBatch

    layout, contract, bb, sps, fleet, client, metas, datas = _bg_world("repro_torch", num_rpcs=1)
    batch = zipf_hotset_batch(metas, clients=["client"], num_requests=5, seed=1)
    rb, fast = client.replay(batch)
    assert isinstance(rb, ReceiptBatch) and fast.cohort is not None
    assert EventLoop(sanitize=True)._san is not None
    # a sample of a blob without a DAS extension replays as a detection
    result = replay_open_loop(fleet, [SampleRequest(0.0, "client", metas[0].blob_id, 0, 0)])
    assert (result.das_samples, result.das_detections) == (1, 1)
    # the same batch replays through the task drivers as a request list
    receipts, result = client.replay(batch.to_requests())
    assert result.dropped == 0 and all(r is not None for r in receipts)
