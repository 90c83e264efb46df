"""The port's membership plane, durability measurement and audit simulation,
held against the JAX package.

Churn (crashes, departures, slashes, joins), the boundary census, the
contract's reconfiguration and the re-dispersal backlog drained by repairs
on the layout's device (``MembershipPlane``), the measured durability series
(``measure_durability``) and the multi-epoch audit/economics simulation
(``run_sim``) are driven with the same seeds in both packages: events,
``EpochStats``, lost chunksets, ``ChurnPoint``s, ``SimResult`` fields and
replay digests must be equal.  Floats are compared with ``==``: the
simulated clock's arithmetic is copied op for op.
"""
import dataclasses
import importlib

import numpy as np
import pytest

PACKAGES = ("repro", "repro_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _world(pkg, *, num_sps=10, num_blobs=2, seed=0, blob_bytes=160_000, service_ms=2.0,
           num_rpcs=1):
    """tests/test_membership.py's world: 10 SPs in 3 DCs, Clay (4,2), two blobs."""
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    layout = _mod(pkg, "storage.blob").BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024, **kw)
    sp_mod, fleet_mod = _mod(pkg, "storage.sp"), _mod(pkg, "net.fleet")
    contract = _mod(pkg, "core.contract").ShelbyContract()
    sps = {}
    for i in range(num_sps):
        contract.register_sp(_mod(pkg, "core.placement").SPInfo(
            sp_id=i, stake=1000.0, dc=f"dc{i % 3}", rack=f"r{i % 2}"))
        sps[i] = sp_mod.StorageProvider(i, service=sp_mod.ServiceSpec(
            disk_ms_per_chunk=service_ms, slots=2))
    rpcs = [_mod(pkg, "storage.rpc").RPCNode(f"rpc{r}", contract, sps, layout, cache_chunksets=8)
            for r in range(num_rpcs)]
    fleet = fleet_mod.RPCFleet(rpcs, fleet_mod.CacheAffinityPolicy())
    client = _mod(pkg, "storage.sdk").ShelbyClient(contract, fleet, deposit=1e9)
    rng = np.random.default_rng(seed)
    datas = [rng.integers(0, 256, blob_bytes, dtype=np.uint8).tobytes() for _ in range(num_blobs)]
    metas = [client.put(d) for d in datas]
    return layout, contract, sps, fleet, client, metas, datas


def _plane(pkg, contract, sps, layout, spec_kw, *, repair=True, fleet=None, epochs=2,
           epoch_ms=100.0):
    mem = _mod(pkg, "storage.membership")
    rc = _mod(pkg, "storage.repair").RepairCoordinator(contract, sps, layout) if repair else None
    return mem.MembershipPlane(contract, sps, layout, mem.ChurnSpec(**spec_kw), repair=rc,
                               fleet=fleet, epochs=epochs, epoch_ms=epoch_ms)


def _run(pkg, plane):
    loop = _mod(pkg, "net.events").EventLoop()
    for p in plane.planes():
        p.spawn(loop)
    loop.run()
    return loop


def plane_view(plane, contract, sps):
    stats = [(s.epoch, s.boundary_ms, s.joins, s.crashes, s.departures, s.slashes,
              s.reassigned, s.enqueued, s.lost_new, s.drain_ms()) for s in plane.epoch_stats]
    repair = None
    if plane.repair is not None:
        repair = ([dataclasses.astuple(r) for r in plane.repair.records],
                  [dataclasses.astuple(r) for r in plane.repair.rc.reports],
                  plane.repair.failures, plane.repair.enqueued_total, plane.repair.backlog())
    stored = {(i, key): arr.tobytes() for i, sp in sps.items() for key, arr in sp._chunks.items()}
    return ([dataclasses.astuple(e) for e in plane.events],
            [dataclasses.astuple(r) for r in plane.records], stats, sorted(plane.lost),
            plane.lost_chunksets, plane.joined, plane.reassigned_total, repair, stored,
            {b: dict(m.placement) for b, m in contract.blobs.items()},
            sorted(contract.dead_sps()), sorted(contract.ejected), dict(contract.stakes))


def _both(scenario):
    return {pkg: scenario(pkg) for pkg in PACKAGES}


SPECS = {
    # an announced departure and a crash, drained by the backlog
    "scripted": dict(scripted=((0, "announce", 2, 0.3), (0, "crash", 5, 0.5))),
    # crashes, leaves, slashes (ejected at once) and joins, no floor
    "mixed": dict(p_crash=0.1, p_leave=0.1, p_slash=0.05, joins_per_epoch=1, seed=4),
    # p_crash = 1 held back by the floor
    "floor": dict(p_crash=1.0, min_active=7, seed=1),
    # beyond the redundancy budget: losses counted by the census
    "heavy": dict(p_crash=0.45, seed=2),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_membership_plane_matches_reference(name):
    def scenario(pkg):
        layout, contract, sps, fleet, client, metas, datas = _world(pkg, seed=len(name))
        plane = _plane(pkg, contract, sps, layout, SPECS[name], fleet=fleet, epochs=3)
        _run(pkg, plane)
        if name in ("scripted", "floor"):  # churn within the redundancy budget
            assert plane.lost_chunksets == 0
            for meta, data in zip(metas, datas):
                assert client.get(meta.blob_id) == data
        return plane_view(plane, contract, sps)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]
    if name == "heavy":
        assert got["repro"][4] > 0  # losses were measured, not computed


def test_membership_without_repair_matches_reference():
    def scenario(pkg):
        layout, contract, sps, fleet, client, metas, datas = _world(pkg)
        plane = _plane(pkg, contract, sps, layout, dict(p_crash=0.3, seed=3), repair=False)
        _run(pkg, plane)
        return plane_view(plane, contract, sps)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_joiners_are_servable_as_in_the_reference():
    def scenario(pkg):
        layout, contract, sps, fleet, client, metas, datas = _world(pkg, num_sps=8)
        plane = _plane(pkg, contract, sps, layout, dict(joins_per_epoch=2), fleet=fleet,
                       epochs=1)
        _run(pkg, plane)
        assert len(plane.joined) == 2
        for sp_id in plane.joined:
            for rpc in fleet.rpcs:
                assert sp_id in rpc.sps and str(sp_id) in rpc.ledger.channels
        data = np.random.default_rng(9).integers(0, 256, 160_000, dtype=np.uint8).tobytes()
        meta = client.put(data)
        assert client.get(meta.blob_id) == data
        return plane_view(plane, contract, sps), dict(meta.placement)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_joiner_gets_a_backbone_route():
    """A joiner on a backbone world: the node registered, the transport of
    every RPC node routes to it (``BackboneTransport.admit_sp``)."""
    from repro_torch.net.backbone import Backbone
    from repro_torch.storage.membership import ChurnSpec, MembershipPlane
    from repro_torch.storage.rpc import BackboneTransport

    layout, contract, sps, fleet, client, metas, datas = _world("repro_torch")
    bb = Backbone.mesh(3)
    for rpc in fleet.rpcs:
        bb.register_node(rpc.rpc_id, "dc0")
        rpc.transport = BackboneTransport(sps, bb, rpc.rpc_id)
    nodes = {i: f"sp{i}" for i in sps}
    for i in sps:
        bb.register_node(nodes[i], contract.sps[i].dc)
    plane = MembershipPlane(contract, sps, layout, ChurnSpec(joins_per_epoch=1), fleet=fleet,
                            backbone=bb, nodes=nodes, epochs=1)
    _run("repro_torch", plane)
    (joiner,) = plane.joined
    assert nodes[joiner] == f"sp{joiner}"
    assert all(rpc.transport.sp_node[joiner] == f"sp{joiner}" for rpc in fleet.rpcs)


def test_churn_replay_digest_matches_reference():
    """Churn + re-dispersal + paid Zipf reads on one loop through
    ``session.replay``: the same digest (membership records included)."""
    def scenario(pkg):
        layout, contract, sps, fleet, client, metas, datas = _world(pkg, num_rpcs=2)
        rc = _mod(pkg, "storage.repair").RepairCoordinator(contract, sps, layout)
        mem = _mod(pkg, "storage.membership")
        plane = mem.MembershipPlane(
            contract, sps, layout,
            mem.ChurnSpec(p_crash=0.1, p_leave=0.1, joins_per_epoch=1, seed=4),
            repair=rc, fleet=fleet, epochs=2, epoch_ms=60.0)
        reqs = _mod(pkg, "net.workloads").zipf_hotset(
            metas, clients=["u"], num_requests=40, interarrival_ms=3.0, seed=8,
            arrival="poisson")
        with client.session() as session:
            receipts, result = session.replay(reqs, background=plane.planes())
        assert result.membership_events > 0
        by_id = {m.blob_id: d for m, d in zip(metas, datas)}
        for req, r in zip(reqs, receipts):
            if r is not None:
                assert r.data == by_id[req.blob_id][req.offset:req.offset + req.length]
        return (result.digest(), result.membership_events, result.dropped,
                [None if r is None else (r.latency_ms, r.payments) for r in receipts],
                plane_view(plane, contract, sps))

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


@pytest.mark.parametrize("repair", [False, True])
def test_measure_durability_matches_reference(repair):
    def scenario(pkg):
        kw = {"device": "cpu"} if pkg == "repro_torch" else {}
        pts = _mod(pkg, "storage.membership").measure_durability(
            (0.0, 0.2, 0.5), seeds=(0, 1), epochs=2, repair=repair, **kw)
        return [dataclasses.astuple(p) for p in pts], [p.loss_probability for p in pts]

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]
    probs = got["repro"][1]
    assert probs[0] == 0.0 and all(a <= b + 1e-12 for a, b in zip(probs, probs[1:]))


def sim_view(res):
    return dataclasses.asdict(res)


@pytest.mark.parametrize("case", ["churn", "quiet", "cheaters"])
def test_run_sim_matches_reference(case):
    def scenario(pkg):
        sim = _mod(pkg, "core.simulation")
        kw = {"device": "cpu"} if pkg == "repro_torch" else {}
        if case == "churn":
            churn = _mod(pkg, "storage.membership").ChurnSpec(
                p_crash=0.05, p_leave=0.05, joins_per_epoch=1, seed=3, min_active=6)
            res = sim.run_sim(sim.honest_population(10), epochs=3, num_blobs=3,
                              blob_bytes=100_000, read_requests_per_epoch=30, churn=churn, **kw)
            assert res.membership_events > 0 and res.sps_joined == 3
            assert res.chunksets_lost == 0 and res.repairs_completed == res.repairs_enqueued > 0
        elif case == "quiet":
            res = sim.run_sim(sim.honest_population(6), epochs=2, num_blobs=2, **kw)
            assert res.membership_events == 0 and res.repairs_enqueued == 0
        else:
            behaviors = sim.honest_population(8)
            sp_mod = _mod(pkg, "storage.sp")
            behaviors[2] = sp_mod.SPBehavior(drop_fraction=0.5)
            behaviors[5] = sp_mod.SPBehavior(crashed=True)
            res = sim.run_sim(behaviors, epochs=2, num_blobs=3, blob_bytes=80_000,
                              read_requests_per_epoch=20, seed=1, **kw)
        return sim_view(res)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_run_sim_refuses_unported_planes():
    from repro_torch.core.simulation import honest_population, run_sim

    pop = honest_population(6)
    # overload control and simsan are both ported: no plane is refused, and
    # the per-epoch conservation check changes nothing
    kw = dict(epochs=1, read_requests_per_epoch=10, device="cpu")
    assert run_sim(pop, sanitize=True, **kw) == run_sim(pop, sanitize=False, **kw)


def test_closed_forms_match_reference():
    """``core/durability.py`` and ``core/economics.py`` are copies: the
    paper's worked examples and the analytic tails give the same floats."""
    from repro.core import durability as jd
    from repro.core import economics as je
    from repro_torch.core import durability as d
    from repro_torch.core import economics as e

    for p in (d.DurabilityParams(), d.DurabilityParams(k=4, m=2, chunk_loss_prob=0.1)):
        jp = jd.DurabilityParams(**dataclasses.asdict(p))
        assert d.p_data_loss(p) == jd.p_data_loss(jp)
        assert d.durability_nines(p) == jd.durability_nines(jp)
        assert d.availability(p) == jd.availability(jp)
    assert d.p_fewer_than_k_dcs() == jd.p_fewer_than_k_dcs()
    for n, k, q in ((6, 4, 0.1), (16, 10, 0.3), (2, 1, 0.3)):
        assert d.p_chunkset_loss_per_epoch(n, k, q) == jd.p_chunkset_loss_per_epoch(n, k, q)
    with pytest.raises(ValueError):
        d.p_chunkset_loss_per_epoch(6, 4, 1.5)
    costs, jcosts = e.CostModel(), je.CostModel()
    assert e.min_audit_probability(costs) == je.min_audit_probability(jcosts)
    assert e.retrieval_strategy_cost(0.01, costs) == je.retrieval_strategy_cost(0.01, jcosts)
    assert e.storage_strategy_cost(costs) == je.storage_strategy_cost(jcosts)
    for pf, c in ((0.1, 50), (0.3, 10)):
        assert e.expected_onchain_samples(pf, c) == je.expected_onchain_samples(pf, c)
        assert e.detection_probability(pf, c) == je.detection_probability(pf, c)
    assert e.detection_probability(0.1, 50) > 0.63  # the paper's §5.4 example
    assert e.min_ata_slashing(1.0, 0.3, 0.1) == je.min_ata_slashing(1.0, 0.3, 0.1)
    assert e.fee_split(100.0, 4, 5.0) == je.fee_split(100.0, 4, 5.0)
