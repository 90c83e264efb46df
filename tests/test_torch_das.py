"""The port's data-availability sampling plane, held against the JAX package.

Each test mirrors one of ``tests/test_das.py`` and runs the same seeded
world in both packages: ``repro`` (numpy ``gf.matmul_np``) and
``repro_torch`` on the CPU (the plain version of the ``gf_matmul`` kernel).
Coordinates, DAS records, the SPs' shares and proofs, withheld sets,
verdicts, receipts, settlements, detection points, replay digests and
``SimResult``s must be equal: the copied modules keep the simulated clock's
float arithmetic op for op, so floats compare with ``==``.
"""
import dataclasses
import importlib

import numpy as np
import pytest

PACKAGES = ("repro", "repro_torch")
SPEC = dict(k=4, share_bytes=64, samples_per_epoch=16)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _both(scenario):
    return {pkg: scenario(pkg) for pkg in PACKAGES}


def _cpu(pkg) -> dict:
    return {"device": "cpu"} if pkg == "repro_torch" else {}


def _mini(pkg, num_blobs, spec=SPEC, num_sps=6, seed=0):
    das = _mod(pkg, "storage.das")
    return das._mini_world(num_sps, das.DASSpec(**spec), num_blobs, seed, **_cpu(pkg))


def record_view(rec):
    return dataclasses.asdict(rec)


def sps_view(sps):
    """Every SP's shares (bytes), proofs and withheld coordinates."""
    return {i: ({key: sp._das_shares[key].tobytes() for key in sorted(sp._das_shares)},
                {key: dataclasses.asdict(sp._das_proofs[key]) for key in sorted(sp._das_proofs)},
                sorted(sp._das_withheld), sp.stored_shares())
            for i, sp in sorted(sps.items())}


def rows(items):
    return [dataclasses.asdict(x) for x in items]


def test_draw_coords_matches_reference():
    def scenario(pkg):
        draw = _mod(pkg, "storage.das").draw_coords
        return [draw(seed, blob, epoch, s, side) for seed, blob, epoch, s, side in
                ((5, 1, 3, 32, 8), (5, 1, 4, 32, 8), (0, 0, 0, 16, 4), (-3, 9, 2, 7, 16))]

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]
    assert all(0 <= r < 8 and 0 <= c < 8 for r, c in got["repro"][0])


def test_put_disperses_shares_like_reference():
    def scenario(pkg):
        contract, sps, client, blob_ids = _mini(pkg, 3)
        rec = contract.das[blob_ids[0]]
        assert set(rec.placement) == {(r, c) for r in range(rec.side) for c in range(rec.side)}
        assert sum(sp.stored_shares() for sp in sps.values()) == 3 * rec.side ** 2
        return [record_view(contract.das[b]) for b in blob_ids], sps_view(sps)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_batch_dispersal_equals_single_puts_like_reference():
    """One ``extend_and_disperse_many`` over the blobs registers what their
    puts did (placement draws from the epoch seed and the blob id)."""
    def scenario(pkg):
        contract, sps, client, blob_ids = _mini(pkg, 4)
        singles = [record_view(contract.das[b]) for b in blob_ids]
        rng = np.random.default_rng(0)  # the blobs _mini_world wrote
        datas = [rng.integers(0, 256, 4 * 4 * 64, dtype=np.uint8).tobytes() for _ in blob_ids]
        das = _mod(pkg, "storage.das")
        batch = das.extend_and_disperse_many(contract, sps, list(zip(blob_ids, datas)),
                                             das.DASSpec(**SPEC), **_cpu(pkg))
        assert rows(batch) == singles
        return singles, sps_view(sps)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_proof_bytes_override_matches_reference():
    def scenario(pkg):
        contract, sps, client, blob_ids = _mini(
            pkg, 1, spec=dict(k=2, share_bytes=32, proof_bytes_per_share=1234))
        return record_view(contract.das[blob_ids[0]])

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]
    assert got["repro"]["proof_bytes"] == 1234


def test_config_das_spec_matches_reference():
    def scenario(pkg):
        cfg = _mod(pkg, "configs.shelby").ShelbyConfig
        spec = cfg(das_k=2, das_share_bytes=128, das_samples_per_epoch=4,
                   das_proof_bytes_per_share=99).das()
        assert spec == _mod(pkg, "storage.das").DASSpec(
            k=2, share_bytes=128, samples_per_epoch=4, proof_bytes_per_share=99)
        assert cfg(das_extension=False).das() is None
        return (dataclasses.asdict(spec), dataclasses.asdict(cfg().das()),
                spec.detection_probability(0.25), spec.side)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_sample_availability_pays_and_conserves_like_reference():
    def scenario(pkg):
        contract, sps, client, blob_ids = _mini(pkg, 2)
        session = client.current_session
        verdicts = session.sample_availability(blob_ids, epoch=0, samples=8, seed=1)
        assert all(v.available and v.verified == 8 for v in verdicts)
        receipts = rows(session.receipts)
        settlement = client.settle()  # conservation checked inside close()
        node = client.fleet.primary.stats
        return (rows(verdicts), receipts, dataclasses.asdict(settlement),
                (node.samples_served, node.samples_withheld, node.samples_bad,
                 node.sample_proof_bytes, node.payments, node.bytes_paid_for),
                client.fleet.samples_routed, client.fleet.samples_served(),
                client.fleet.sample_proof_bytes(),
                {i: sp.settled_income for i, sp in sorted(sps.items())})

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_withheld_samples_detect_and_debit_nothing_like_reference():
    def scenario(pkg):
        das = _mod(pkg, "storage.das")
        contract, sps, client, blob_ids = _mini(pkg, 2)
        w_all = das.seed_withholding(contract, sps, blob_ids[0], 1.0)
        w_part = das.seed_withholding(contract, sps, blob_ids[1], 0.2, seed=3)
        (v0,) = client.current_session.sample_availability(blob_ids[:1], epoch=0, samples=4,
                                                           seed=2)
        assert not v0.available and v0.failures == 4 and v0.paid == 0.0
        verdicts = client.current_session.sample_availability(blob_ids, epoch=1, seed=5)
        settlement = client.settle()
        return (w_all, w_part, sps_view(sps), dataclasses.asdict(v0), rows(verdicts),
                dataclasses.asdict(settlement), client.fleet.samples_withheld())

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][:2] == (64, 13)


def test_cache_bypass_steers_the_hot_cache_like_reference():
    def scenario(pkg):
        out = []
        for bypass in (True, False):
            contract, sps, client, blob_ids = _mini(pkg, 1)
            session = client.current_session
            for _ in range(2):
                session.sample_availability(blob_ids, epoch=0, samples=6, seed=3,
                                            cache_bypass=bypass)
            node = client.fleet.primary
            out.append((node.stats.das_cache_hits, rows(session.receipts),
                        dataclasses.asdict(client.settle())))
        assert out[0][0] == 0 and out[1][0] > 0
        return out

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_light_client_sampler_detections_like_reference():
    def scenario(pkg):
        das = _mod(pkg, "storage.das")
        contract, sps, client, blob_ids = _mini(pkg, 2)
        das.seed_withholding(contract, sps, blob_ids[1], 0.5)
        sampler = das.LightClientSampler(client.current_session, das.DASSpec(**SPEC), seed=0)
        verdicts = sampler.sample_epoch(0, blob_ids) + sampler.sample_epoch(1)
        client.settle()
        return rows(verdicts), sampler.detections

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][1] == 2  # q = 0.5, s = 16: the withholder is caught twice


def test_das_storm_matches_reference():
    def scenario(pkg):
        contract, sps, client, blob_ids = _mini(pkg, 2)
        storm = _mod(pkg, "net.workloads").das_storm
        recs = [contract.das[b] for b in blob_ids]
        a = storm(recs, clients=["c0", "c1"], num_requests=40, seed=9)
        assert a == storm(recs, clients=["c0", "c1"], num_requests=40, seed=9)
        b = storm(recs, clients=["c0"], num_requests=20, seed=10, arrival="fixed",
                  cache_bypass=False)
        return [dataclasses.astuple(r) for r in a + b]

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def replay_view(receipts, result):
    return (result.digest(), result.das_samples, result.das_detections,
            [dataclasses.astuple(r) for r in result.records],
            [None if r is None else dataclasses.asdict(r) for r in receipts])


def test_session_replay_counts_das_records_like_reference():
    def scenario(pkg):
        das = _mod(pkg, "storage.das")
        contract, sps, client, blob_ids = _mini(pkg, 2)
        das.seed_withholding(contract, sps, blob_ids[0], 0.25, seed=1)
        reqs = _mod(pkg, "net.workloads").das_storm(
            [contract.das[b] for b in blob_ids], clients=["c0"], num_requests=30, seed=4)
        with client.session() as session:
            receipts, result = session.replay(reqs)
        assert result.das_samples == 30 and result.das_detections > 0
        return replay_view(receipts, result), dataclasses.asdict(session.settlement)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- the das_storm replay of tests/test_engine_equivalence.py::_family_das -------------
def _bb_world(pkg, *, num_sps=9, num_rpcs=2, cache=8, seed=0, num_blobs=4,
              blob_bytes=150_000):
    kw = _cpu(pkg)
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
            disk_ms_per_chunk=1.0, slots=2, background=sp_mod.BackgroundSpec()))
        bb.register_node(f"sp{i}", dc)
    rpcs = []
    for r in range(num_rpcs):
        node = f"rpc{r}"
        bb.register_node(node, f"dc{r % 3}")
        rpcs.append(rpc_mod.RPCNode(node, contract, sps, layout, cache_chunksets=cache,
                                    transport=rpc_mod.BackboneTransport(sps, bb, node)))
    bb.register_node("client", "dc0")
    bb.register_node("repairer", "dc1")
    fleet = fleet_mod.RPCFleet(rpcs, fleet_mod.CacheAffinityPolicy(), backbone=bb)
    client = _mod(pkg, "storage.sdk").ShelbyClient(contract, fleet, deposit=1e9)
    rng = np.random.default_rng(seed)
    metas = [client.put(rng.integers(0, 256, blob_bytes, dtype=np.uint8).tobytes())
             for _ in range(num_blobs)]
    return contract, sps, fleet, metas


@pytest.mark.parametrize("engine", ["heap", "calendar"])
def test_das_storm_replay_digest_matches_reference(engine):
    def scenario(pkg):
        das = _mod(pkg, "storage.das")
        contract, sps, fleet, metas = _bb_world(pkg)
        spec = das.DASSpec(k=4, share_bytes=512, samples_per_epoch=8)
        rng = np.random.default_rng(1)
        records = das.extend_and_disperse_many(
            contract, sps,
            [(m.blob_id, rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
             for m in metas[:2]],
            spec, **_cpu(pkg))
        reqs = _mod(pkg, "net.workloads").das_storm(
            records, clients=["client"], num_requests=60, seed=9, interarrival_ms=1.0)
        reader = _mod(pkg, "storage.sdk").ShelbyClient(contract, fleet, deposit=1e9, das=spec)
        with reader.session() as session:
            receipts, result = session.replay(reqs, engine=engine)
        return replay_view(receipts, result), fleet.samples_routed, fleet.sample_proof_bytes()

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][0][1] == 60


# -- detection: measured against the analytic curve ------------------------------------
@pytest.mark.parametrize("case", ["analytic", "zero", "cheap"])
def test_detection_points_match_reference(case):
    kw = {"analytic": dict(fractions=(0.05, 0.15, 0.30), seeds=(0, 1, 2), num_blobs=8, rounds=8),
          "zero": dict(fractions=(0.0,), seeds=(0,), num_blobs=4, rounds=4),
          "cheap": dict(fractions=(0.30,), seeds=(0,), num_blobs=6, rounds=6)}[case]

    def scenario(pkg):
        das = _mod(pkg, "storage.das")
        return rows(das.measure_detection(spec=das.DASSpec(**SPEC), **kw, **_cpu(pkg)))

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]
    for pt in got["repro"]:
        assert pt["analytic"] == 1.0 - (1.0 - pt["q_effective"]) ** pt["samples"]
    if case == "zero":
        assert got["repro"][0]["detected"] == 0
    if case == "cheap":
        assert got["repro"][0]["detected"] > 0


# -- run_sim with the DAS plane ---------------------------------------------------------
def test_run_sim_with_das_plane_matches_reference():
    def scenario(pkg):
        sim = _mod(pkg, "core.simulation")
        spec = _mod(pkg, "storage.das").DASSpec(k=2, share_bytes=64, samples_per_epoch=4)
        res = sim.run_sim(sim.honest_population(6), epochs=2, num_blobs=2,
                          blob_bytes=2 * 2 * 64, das=spec, seed=1, **_cpu(pkg))
        assert res.das_samples == 2 * 2 * 4 and res.das_detections == 0
        off = sim.run_sim(sim.honest_population(6), epochs=1, num_blobs=2,
                          blob_bytes=2 * 2 * 64, das=None, seed=1, **_cpu(pkg))
        assert off.das_samples == 0 and off.das_proof_bytes == 0
        return dataclasses.asdict(res), dataclasses.asdict(off)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- the port's build_cluster carries the reference's DAS plane -------------------------
def test_build_cluster_state_after_a_put_matches_reference():
    from repro.launch.train import build_cluster as ref_build_cluster
    from repro_torch.launch.cluster import build_cluster

    data = np.random.default_rng(7).integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    views = {}
    for pkg, (contract, sps, rpc, client) in (("repro", ref_build_cluster()),
                                              ("repro_torch", build_cluster(device="cpu"))):
        meta = client.put(data)
        assert len(contract.das[meta.blob_id].placement) == 64
        views[pkg] = ({b: record_view(r) for b, r in contract.das.items()}, sps_view(sps),
                      {i: sp.stored_shares() for i, sp in sps.items()})
    assert views["repro_torch"] == views["repro"]


# -- a square written by the JAX package, sampled through the port ----------------------
def _reference_square():
    contract, sps, client, blob_ids = _mini("repro", 1)
    meta = contract.blobs[blob_ids[0]]
    blobs = [dataclasses.asdict(meta)]
    chunks = {(i, *key): arr for i, sp in sps.items() for key, arr in sp._chunks.items()}
    records = [dataclasses.asdict(contract.das[blob_ids[0]])]
    shares = {(i, *key): (sp._das_shares[key], dataclasses.asdict(sp._das_proofs[key]))
              for i, sp in sps.items() for key in sp._das_shares}
    verdicts = client.current_session.sample_availability(blob_ids, epoch=0, seed=6)
    return blob_ids, blobs, chunks, records, shares, rows(verdicts)


def test_import_das_samples_a_reference_square_through_the_port():
    from repro_torch.storage.state import import_blobs, import_das

    blob_ids, blobs, chunks, records, shares, want = _reference_square()
    contract, sps, client, _ = _mini("repro_torch", 0)
    import_blobs(contract, sps, blobs, chunks)
    imported = import_das(contract, sps, records, shares)
    assert rows(imported) == records
    assert sum(sp.stored_shares() for sp in sps.values()) == len(shares) == 64
    verdicts = client.current_session.sample_availability(blob_ids, epoch=0, seed=6)
    assert rows(verdicts) == want and verdicts[0].available
    client.settle()


def test_import_das_rejects_a_share_with_a_flipped_byte():
    from repro_torch.storage.state import import_blobs, import_das

    blob_ids, blobs, chunks, records, shares, _ = _reference_square()
    key = sorted(shares)[5]
    share, proof = shares[key]
    bad = share.copy()
    bad[0] ^= 1
    contract, sps, client, _ = _mini("repro_torch", 0)
    import_blobs(contract, sps, blobs, chunks)
    with pytest.raises(ValueError, match="does not match its DAS root"):
        import_das(contract, sps, records, {**shares, key: (bad, proof)})
    with pytest.raises(KeyError):  # a record for a blob the contract does not hold
        import_das(contract, sps, [{**records[0], "blob_id": 99}], {})
