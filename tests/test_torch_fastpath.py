"""The port's cohort fast path, held against the JAX package.

Each test mirrors one of ``tests/test_engine_equivalence.py``'s fast-path
and batched-settlement tests and runs the same seeded world in both
packages: ``repro`` and ``repro_torch`` on the CPU (the plain version of
the ``gf_matmul`` kernel decodes the de-opted reads).  Digests,
``CohortStats`` counts, fleet and node counters and the settled
``paid_by_node`` floats must be equal: ``net/fastpath.py`` keeps the
reference's numpy operations in their order, so floats compare with ``==``.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

PACKAGES = ("repro", "repro_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain CPU path runs small tensors, where an intra-op thread pool
    costs far more than it saves: one thread per module, then restored."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
ENGINE_DIGEST_10K = "5cb923036ace9559"


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _both(scenario):
    return {pkg: scenario(pkg) for pkg in PACKAGES}


def _layout(pkg):
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    return _mod(pkg, "storage.blob").BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024, **kw)


def _fast_world(pkg, *, num_rpcs=2, cache=64, **node_kw):
    """Single-chunkset blobs + whole-blob reads: the float-exact regime."""
    rpc = _mod(pkg, "storage.rpc")
    sp = _mod(pkg, "storage.sp")
    fleet_mod = _mod(pkg, "net.fleet")
    layout = _layout(pkg)
    contract = _mod(pkg, "core.contract").ShelbyContract()
    bb = _mod(pkg, "net.backbone").Backbone.mesh(3, base_latency_ms=4.0, gbps=10.0)
    sps = {}
    for i in range(8):
        dc = f"dc{i % 3}"
        contract.register_sp(_mod(pkg, "core.placement").SPInfo(
            sp_id=i, stake=1000.0, dc=dc, rack=f"r{i % 4}"))
        sps[i] = sp.StorageProvider(i, service=sp.ServiceSpec(disk_ms_per_chunk=0.5, slots=4))
        bb.register_node(f"sp{i}", dc)
    rpcs = []
    for r in range(num_rpcs):
        node = f"rpc{r}"
        bb.register_node(node, f"dc{r % 3}")
        rpcs.append(rpc.RPCNode(node, contract, sps, layout, cache_chunksets=cache,
                                transport=rpc.BackboneTransport(sps, bb, node), **node_kw))
    bb.register_node("client", "dc0")
    fleet = fleet_mod.RPCFleet(rpcs, fleet_mod.CacheAffinityPolicy(), backbone=bb)
    client = _mod(pkg, "storage.sdk").ShelbyClient(contract, fleet, deposit=1e9)
    rng = np.random.default_rng(7)
    metas = [client.put(rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes())
             for _ in range(12)]
    for n in rpcs:
        n._cache.clear()  # cold start: the PUT path warmed the writer's cache
    return fleet, client, metas


def _fast_batch(pkg, metas, n=1500, seed=3):
    return _mod(pkg, "net.workloads").zipf_hotset_batch(
        metas, clients=["client"], num_requests=n, read_bytes=64 * 1024,
        interarrival_ms=0.2, seed=seed, arrival="poisson")


def cohort_view(co):
    return {f.name: (getattr(co, f.name).tolist() if isinstance(getattr(co, f.name), np.ndarray)
                     else getattr(co, f.name)) for f in dataclasses.fields(co)}


def fleet_view(fleet):
    return (list(fleet.routed), fleet.chunkset_reads, fleet.bytes_served,
            [n.stats.cache_hits for n in fleet.rpcs], [n.stats.coalesced for n in fleet.rpcs],
            sorted(fleet.request_latencies_ms))


def test_fast_path_digest_and_counters_match_task_mode():
    def scenario(pkg):
        wl = _mod(pkg, "net.workloads")
        fast = _mod(pkg, "net.fastpath")
        fleet_t, _, metas = _fast_world(pkg)
        batch = _fast_batch(pkg, metas)
        r_task = wl.replay_open_loop(fleet_t, batch.to_requests())
        fleet_f, _, _ = _fast_world(pkg)
        r_fast = fast.replay_open_loop_fast(fleet_f, batch)
        co = r_fast.cohort
        assert co.fallback_reason is None
        assert co.vec_requests > 0 and co.deopt_requests > 0  # cold keys de-opted
        assert r_task.digest() == r_fast.digest()
        assert fleet_view(fleet_t) == fleet_view(fleet_f)
        return r_fast.digest(), cohort_view(co), fleet_view(fleet_f)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_fast_path_is_deterministic_across_replays():
    def scenario(pkg):
        _, _, metas = _fast_world(pkg)
        batch = _fast_batch(pkg, metas, n=600)
        digests = set()
        for _ in range(2):
            fleet, _, _ = _fast_world(pkg)
            digests.add(_mod(pkg, "net.fastpath").replay_open_loop_fast(fleet, batch).digest())
        assert len(digests) == 1
        return digests

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_fast_path_falls_back_with_a_reason():
    def scenario(pkg):
        spec = _mod(pkg, "storage.rpc").AdmissionSpec(max_queued_requests=64)
        fast = _mod(pkg, "net.fastpath")
        fleet, _, metas = _fast_world(pkg, admission=spec)
        batch = _fast_batch(pkg, metas, n=200)
        reason = fast.fastpath_fallback_reason(fleet, batch)
        assert reason is not None and "admission" in reason
        res = fast.replay_open_loop_fast(fleet, batch)
        assert res.cohort.fallback_reason == reason
        assert (res.cohort.vec_requests, res.cohort.deopt_requests) == (0, len(batch))
        # the fallback replay is the task path: digest matches it exactly
        fleet_t, _, _ = _fast_world(pkg, admission=spec)
        task = _mod(pkg, "net.workloads").replay_open_loop(fleet_t, batch.to_requests())
        assert res.digest() == task.digest()
        return reason, res.digest()

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


@pytest.mark.parametrize("policy", ["p2c", "latency"])
def test_fast_path_fallback_on_stateful_policy(policy):
    def scenario(pkg):
        fleet, _, metas = _fast_world(pkg)
        fleet.policy = _mod(pkg, "net.fleet").make_policy(policy)
        reason = _mod(pkg, "net.fastpath").fastpath_fallback_reason(
            fleet, _fast_batch(pkg, metas, n=50))
        assert reason is not None and "stateful" in reason
        return reason

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


@pytest.mark.parametrize("knob, word", [
    (dict(cache_ttl_ms=50.0), "TTL"),
    (dict(cache_admit_bytes=16), "admission filter"),
    (dict(single_flight=False), "single-flight"),
    (dict(cache=0), "cache disabled"),
    (dict(cache=3), "eviction"),
    ("zero-length", "zero-length"),
    ("ttl-entry", "TTL-stamped"),
    ("empty", "empty batch"),
])
def test_every_fallback_reason_matches_reference(knob, word):
    """World checks, the batch check and the cache scans: each names its
    reason and replays request-per-task, as the reference does."""
    def scenario(pkg):
        fast = _mod(pkg, "net.fastpath")
        wl = _mod(pkg, "net.workloads")
        fleet, _, metas = _fast_world(pkg, **(knob if isinstance(knob, dict) else {}))
        batch = _fast_batch(pkg, metas, n=120)
        if knob == "zero-length":
            batch.length[5] = 0
            reason = fast.fastpath_fallback_reason(fleet, batch)
            assert word in reason, reason
            with pytest.raises(ValueError, match="positive"):  # the task path refuses it
                fast.replay_open_loop_fast(fleet, batch)
            return reason
        if knob == "ttl-entry":
            key = (metas[0].blob_id, 0)
            node = fleet.rpcs[fleet.policy.pick(key, None, fleet)]
            node.read_items_detailed([key])
            decoded, _, version = node._cache[key]
            node._cache[key] = (decoded, 1e9, version)
        elif knob == "empty":
            batch = wl.RequestBatch(
                t_ms=batch.t_ms[:0], client_idx=batch.client_idx[:0],
                blob_id=batch.blob_id[:0], offset=batch.offset[:0],
                length=batch.length[:0], clients=batch.clients)
        res = fast.replay_open_loop_fast(fleet, batch)
        reason = res.cohort.fallback_reason
        assert word in reason, reason
        assert (res.cohort.vec_requests, res.cohort.deopt_requests) == (0, len(batch))
        return reason, res.digest(), len(res.records)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_batched_settlement_conserves_value_vs_task_path():
    def scenario(pkg):
        fleet_t, client_t, metas = _fast_world(pkg)
        batch = _fast_batch(pkg, metas, n=1000, seed=11)
        with client_t.session(deposit_per_node=1e6) as s_task:
            _, r_task = s_task.replay(batch.to_requests())
            paid_task = s_task.total_paid
        set_task = s_task.settlement
        fleet_f, client_f, _ = _fast_world(pkg)
        with client_f.session(deposit_per_node=1e6) as s_fast:
            rb, r_fast = s_fast.replay(batch)
            paid_fast = s_fast.total_paid
        set_fast = s_fast.settlement
        assert r_task.digest() == r_fast.digest()
        assert len(rb) == r_fast.cohort.vec_requests
        assert paid_fast == pytest.approx(paid_task, rel=1e-9)
        for nid, income in set_task.node_income.items():
            assert set_fast.node_income.get(nid, 0.0) == pytest.approx(income, rel=1e-9)
        assert (rb.total_paid + sum(r.total_paid for r in s_fast.receipts)
                == pytest.approx(set_fast.total_node_income, abs=1e-9))
        assert np.all(rb.paid > 0.0) and np.all(rb.latency_ms >= 0.0)
        return (rb.paid_by_node, rb.req_idx.tolist(), rb.paid.tolist(),
                rb.latency_ms.tolist(), rb.nbytes.tolist(), paid_fast,
                set_fast.node_income, [r.total_paid for r in s_fast.receipts])

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_session_replay_of_a_batch_settles_shed_receipts():
    """A batch on an admission-controlled fleet falls back to task mode;
    its shed requests land ``shed=True`` receipts that debit nothing."""
    def scenario(pkg):
        spec = _mod(pkg, "storage.rpc").AdmissionSpec(max_inflight_fetches=1)
        fleet, client, metas = _fast_world(pkg, num_rpcs=1, admission=spec, single_flight=False)
        batch = _fast_batch(pkg, metas, n=80)
        with client.session(deposit_per_node=1e6) as s:
            rb, res = s.replay(batch)
        shed = [r for r in s.receipts if r.shed]
        assert res.shed == len(shed) > 0 and len(rb) == 0
        assert all(r.total_paid == 0.0 and r.data == b"" for r in shed)
        return res.digest(), res.shed, s.settlement.node_income

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- the engine scenario's world at its 10k rung -------------------------------------
def _engine_world(pkg):
    """``src/repro/scenarios/engine.py``'s world: 500 SPs on a 5-DC mesh,
    192 single-chunkset blobs, 50 RPC nodes with 16-chunkset caches."""
    rpc = _mod(pkg, "storage.rpc")
    sp = _mod(pkg, "storage.sp")
    layout = _layout(pkg)
    contract = _mod(pkg, "core.contract").ShelbyContract()
    bb = _mod(pkg, "net.backbone").Backbone.mesh(5, base_latency_ms=6.0, gbps=25.0)
    rng = np.random.default_rng(99)
    sps = {}
    for i in range(500):
        dc = f"dc{i % 5}"
        contract.register_sp(_mod(pkg, "core.placement").SPInfo(
            sp_id=i, stake=1000.0, dc=dc, rack=f"r{i % 20}"))
        sps[i] = sp.StorageProvider(i, service=sp.ServiceSpec(disk_ms_per_chunk=0.5, slots=4))
        sps[i].behavior.latency_ms = float(rng.uniform(1.0, 8.0))
        bb.register_node(f"sp{i}", dc)
    for c in range(3):
        bb.register_node(f"client{c}", f"dc{c}")
    bb.register_node("writer", "dc0")
    writer = rpc.RPCNode("writer", contract, sps, layout)
    put_client = _mod(pkg, "storage.sdk").ShelbyClient(contract, writer, deposit=1e9)
    metas = [put_client.put(rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes())
             for _ in range(192)]
    rpcs = []
    for r in range(50):
        node = f"rpc{r}"
        bb.register_node(node, f"dc{r % 5}")
        rpcs.append(rpc.RPCNode(node, contract, sps, layout, cache_chunksets=16,
                                transport=rpc.BackboneTransport(sps, bb, node)))
    bb.reset_accounting()
    policy = _mod(pkg, "configs.shelby").ShelbyConfig().policy()
    fleet = _mod(pkg, "net.fleet").RPCFleet(rpcs, policy, backbone=bb)
    return contract, fleet, metas


def test_engine_world_10k_digest_matches_reference():
    def scenario(pkg):
        contract, fleet, metas = _engine_world(pkg)
        batch = _mod(pkg, "net.workloads").zipf_hotset_batch(
            metas, clients=["client0", "client1", "client2"], num_requests=10_000,
            read_bytes=64 * 1024, interarrival_ms=0.05, seed=23, arrival="poisson")
        reader = _mod(pkg, "storage.sdk").ShelbyClient(contract, fleet, deposit=1e9)
        with reader.session(deposit_per_node=1e6) as s:
            rb, fast = s.replay(batch)
        co = fast.cohort
        assert co.fallback_reason is None
        assert (co.vec_requests, co.deopt_requests) == (9808, 192)
        assert fast.digest()[:16] == ENGINE_DIGEST_10K
        assert abs(s.settlement.total_node_income
                   - (rb.total_paid + sum(r.total_paid for r in s.receipts))) < 1e-6
        return (fast.digest(), co.coalesced, co.hits, rb.paid_by_node,
                fast.percentile(50.0), fast.percentile(99.0), fast.goodput_mbps)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]
