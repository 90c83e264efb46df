"""The port's paid write/read path as a whole, held against the JAX package.

The same seeded deployment is built in both packages (the quickstart world:
Clay (4,2), 256 KiB chunksets, 8 SPs in 3 DCs; and a backbone world with a
two-node fleet, stragglers and a dead SP) and driven through the same
calls.  Placement, commitments, stored bytes, receipts (data, simulated
latency, payments, cache hits, hedges), read statistics and settlement must
be equal: GF coding is exact and the simulated clock's float arithmetic is
copied op for op, so equality is exact.
"""
import dataclasses
import importlib

import numpy as np
import pytest

PACKAGES = ("repro", "repro_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _layout(pkg, **kw):
    if pkg == "repro_torch":
        kw["device"] = "cpu"
    return _mod(pkg, "storage.blob").BlobLayout(**kw)


def quickstart_world(pkg):
    """examples/quickstart.py's deployment, in package `pkg`."""
    SPInfo = _mod(pkg, "core.placement").SPInfo
    layout = _layout(pkg, k=4, m=2, chunkset_bytes_target=256 * 1024)
    contract = _mod(pkg, "core.contract").ShelbyContract()
    sps = {}
    for i in range(8):
        contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 3}", rack=f"r{i % 4}"))
        sps[i] = _mod(pkg, "storage.sp").StorageProvider(i)
    rpc = _mod(pkg, "storage.rpc").RPCNode("rpc0", contract, sps, layout)
    client = _mod(pkg, "storage.sdk").ShelbyClient(contract, rpc)
    return contract, sps, rpc, client


def backbone_world(pkg):
    """Two RPC nodes on a 3-DC backbone, 10 SPs with seeded disk latencies."""
    rpc_mod = _mod(pkg, "storage.rpc")
    fleet_mod = _mod(pkg, "net.fleet")
    backbone = _mod(pkg, "net.backbone").Backbone.mesh(3, base_latency_ms=6.0, gbps=25.0)
    layout = _layout(pkg, k=4, m=2, chunkset_bytes_target=64 * 1024)
    contract = _mod(pkg, "core.contract").ShelbyContract()
    rng = np.random.default_rng(7)
    sps = {}
    for i in range(10):
        dc = f"dc{i % 3}"
        contract.register_sp(_mod(pkg, "core.placement").SPInfo(
            sp_id=i, stake=1000.0, dc=dc, rack=f"r{i % 4}"))
        sps[i] = _mod(pkg, "storage.sp").StorageProvider(i)
        sps[i].behavior.latency_ms = float(rng.uniform(1.0, 10.0))
        backbone.register_node(f"sp{i}", dc)
    for c in range(2):
        backbone.register_node(f"client{c}", f"dc{c}")
    rpcs = []
    for r in range(2):
        node = f"rpc{r}"
        backbone.register_node(node, f"dc{r}")
        rpcs.append(rpc_mod.RPCNode(node, contract, sps, layout, cache_chunksets=4,
                                    transport=rpc_mod.BackboneTransport(sps, backbone, node)))
    fleet = fleet_mod.RPCFleet(rpcs, fleet_mod.CacheAffinityPolicy(), backbone=backbone)
    client = _mod(pkg, "storage.sdk").ShelbyClient(contract, fleet, deposit=1e9)
    return contract, sps, fleet, client


def receipt_view(r):
    # overload control is not in the port: the reference never sheds here
    assert not getattr(r, "shed", False) and not getattr(r, "retried_nodes", {})
    return (r.blob_id, r.offset, r.length, r.data, r.latency_ms, r.payments,
            r.chunksets_by_node, r.cache_hits, r.hedges_launched, r.hedged_wasted,
            r.prefetched, r.prefetches_launched, r.coalesced)


def stats_view(stats):
    """The port's ReadStats fields; the reference's others (overload
    control, DAS) are for planes the port lacks and must stay zero."""
    from repro_torch.storage.rpc import ReadStats

    ported = [f.name for f in dataclasses.fields(ReadStats)]
    others = {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
              if f.name not in ported}
    assert not any(others.values()), others
    return {name: getattr(stats, name) for name in ported}


def settlement_view(s):
    return (s.deposits, s.client_refunds, s.node_income, s.sp_income,
            s.total_deposited, s.total_refunded, s.total_node_income)


def _blob(n, seed=7):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _both(scenario):
    return {pkg: scenario(pkg) for pkg in PACKAGES}


def test_put_places_commits_and_stores_identically():
    def scenario(pkg):
        contract, sps, rpc, client = quickstart_world(pkg)
        meta = client.put(_blob(1_000_000), payment=1.0, epochs=12)
        stored = {(i, key): arr.tobytes() for i, sp in sps.items()
                  for key, arr in sp._chunks.items()}
        return (meta.blob_id, meta.size_bytes, meta.num_chunksets, meta.placement,
                meta.chunk_roots, meta.chunk_num_samples, meta.chunkset_roots,
                meta.blob_root, meta.state.value, contract.treasury), stored

    got = _both(scenario)
    assert got["repro_torch"][0] == got["repro"][0]
    assert got["repro_torch"][1] == got["repro"][1]
    assert len(got["repro"][1]) == 4 * 6


def test_reads_receipts_and_settlement_match():
    def scenario(pkg):
        contract, sps, rpc, client = quickstart_world(pkg)
        data = _blob(1_000_000)
        meta = client.put(data, payment=1.0, epochs=12)
        cs = client.layout.chunkset_bytes
        seen = []
        with client.session(deposit_per_node=5.0) as session:
            seen.append(session.read(meta.blob_id))  # whole blob
            seen.append(session.read(meta.blob_id))  # hot cache
            rpc._cache.clear()
            seen.append(session.read(meta.blob_id, cs - 100, 300))  # across one boundary
            seen.extend(session.get_many([(meta.blob_id, 2 * cs - 5, cs + 10),
                                          (meta.blob_id, 123_456, 789),
                                          (meta.blob_id, 3 * cs, None)]))
            reader = session.open(meta.blob_id, readahead=2)
            reader.seek(cs // 2)
            seen.append(reader.read(cs // 3))
            seen.append(reader.read(cs // 3))
            seen.extend(r.data for r in session.stream(meta.blob_id, cs + 1))
        for r in seen:
            if not isinstance(r, bytes):
                assert r.data == data[r.offset : r.offset + r.length]
        return ([receipt_view(r) if not isinstance(r, bytes) else r for r in seen],
                [receipt_view(r) for r in session.receipts],
                settlement_view(session.settlement), stats_view(rpc.stats),
                {sp_id: ch.paid for sp_id, ch in rpc.ledger.channels.items()},
                {i: (sp.earned_reads, sp.settled_income) for i, sp in sps.items()})

    got = _both(scenario)
    for a, b in zip(got["repro_torch"], got["repro"]):
        assert a == b


def test_degraded_and_corrupt_reads_match():
    def scenario(pkg):
        contract, sps, rpc, client = quickstart_world(pkg)
        data = _blob(1_000_000)
        meta = client.put(data, payment=1.0, epochs=12)
        out = []
        sps[meta.placement[(0, 0)]].crash()
        rpc._cache.clear()
        r = client.read(meta.blob_id)
        assert r.data == data
        out.append((receipt_view(r), stats_view(rpc.stats)))
        sps[meta.placement[(0, 1)]].behavior.corrupt = True
        rpc._cache.clear()
        r = client.read(meta.blob_id, 200_000, 500_000)
        assert r.data == data[200_000:700_000]
        out.append((receipt_view(r), stats_view(rpc.stats)))
        assert rpc.stats.chunks_bad > 0
        out.append(settlement_view(client.settle()))
        return out

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_backbone_fleet_with_stragglers_matches():
    def scenario(pkg):
        contract, sps, fleet, client = backbone_world(pkg)
        blobs = {}
        for b in range(3):
            data = _blob(3 * client.layout.chunkset_bytes + 1000 * b, seed=b)
            blobs[client.put(data).blob_id] = data
        by_speed = sorted(sps, key=lambda i: sps[i].behavior.latency_ms)
        for i in by_speed[:2]:  # the SPs the scheduler asks first go dark
            sps[i].crash()
        sps[by_speed[2]].behavior.latency_ms = 250.0  # straggler
        rng = np.random.default_rng(11)
        views = []
        with client.session() as session:
            for i in range(12):
                blob_id = int(rng.integers(0, 3))
                size = len(blobs[blob_id])
                off = int(rng.integers(0, size - 1))
                ln = int(rng.integers(1, size - off + 1))
                r = session.read(blob_id, off, ln, client=f"client{i % 2}", t_ms=10.0 * i)
                assert r.data == blobs[blob_id][off : off + ln]
                views.append(receipt_view(r))
        return (views, settlement_view(session.settlement), fleet.routed,
                fleet.latency_percentiles(50.0, 99.0), fleet.hedged_wasted(),
                fleet.hedges_launched(), [stats_view(r.stats) for r in fleet.rpcs],
                fleet.backbone.utilization())

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][4] + got["repro"][5] > 0  # the world does exercise hedging


def test_blob_written_by_the_jax_package_reads_through_the_port():
    from repro_torch.storage.state import import_blobs

    contract, sps, rpc, client = quickstart_world("repro")
    data = _blob(700_000, seed=3)
    meta = client.put(data, payment=1.0, epochs=12)
    blobs = [dataclasses.asdict(meta)]
    chunks = {(i, *key): arr for i, sp in sps.items() for key, arr in sp._chunks.items()}
    want = client.read(meta.blob_id, 100_000, 400_000)

    pcontract, psps, prpc, pclient = quickstart_world("repro_torch")
    imported = import_blobs(pcontract, psps, blobs, chunks)
    assert [m.blob_id for m in imported] == [meta.blob_id]
    assert pcontract.blobs[meta.blob_id].state.value == "ready"
    got = pclient.read(meta.blob_id, 100_000, 400_000)
    assert receipt_view(got) == receipt_view(want)
    assert pclient.get(meta.blob_id) == data
    # the carried-over blob is counted: a new put takes the next id
    assert pclient.put(b"x" * 10).blob_id == meta.blob_id + 1


def test_import_blobs_rejects_a_chunk_that_does_not_match_its_root():
    from repro_torch.storage.state import import_blobs

    contract, sps, rpc, client = quickstart_world("repro")
    meta = client.put(_blob(300_000), payment=1.0, epochs=12)
    chunks = {(i, *key): arr.copy() for i, sp in sps.items() for key, arr in sp._chunks.items()}
    next(iter(chunks.values()))[0, 0] ^= 1
    pcontract, psps, _, _ = quickstart_world("repro_torch")
    with pytest.raises(ValueError, match="does not match"):
        import_blobs(pcontract, psps, [dataclasses.asdict(meta)], chunks)


def test_build_cluster_round_trip_on_cpu():
    from repro_torch.launch.cluster import build_cluster

    contract, sps, rpc, client = build_cluster(num_sps=8, device="cpu")
    data = _blob(600_000, seed=5)
    meta = client.put(data)
    assert client.get(meta.blob_id) == data
    assert client.get(meta.blob_id, 300_000, 10) == data[300_000:300_010]
    settlement = client.settle()
    assert abs(settlement.total_deposited
               - (settlement.total_refunded + settlement.total_node_income)) < 1e-6


def test_config_defaults_match_reference():
    from repro.configs.shelby import CONFIG as REF
    from repro_torch.configs.shelby import CONFIG

    for f in dataclasses.fields(CONFIG):
        if f.name == "layout":
            lay, ref = CONFIG.layout, REF.layout
            assert (lay.k, lay.m, lay.chunkset_bytes_target, lay.device) == (
                ref.k, ref.m, ref.chunkset_bytes_target, None)
        else:
            assert getattr(CONFIG, f.name) == getattr(REF, f.name), f.name
    assert REF.admission() is None  # the reference's overload control is off
