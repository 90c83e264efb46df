"""The port's overload control and the RPC node's remaining options and read
paths, held against the JAX package.

Each test mirrors one of the reference's tests and runs the same seeded
world in both packages: ``repro`` (numpy GF) and ``repro_torch`` on the CPU
(the plain version of the ``gf_matmul`` kernel).  Mirrored here:

* every test of ``tests/test_overload.py`` (single-flight, admission
  shedding, sibling retry, fetch budget, brownout, digests);
* the hedge-gate re-arm tests of ``tests/test_background.py``;
* the cache TTL and admit-bytes tests of ``tests/test_events.py``;
* ``tests/test_read_range.py`` and the batched-decode tests of
  ``tests/test_batched_decode.py`` (``batch_decode`` on and off);
* the scheduler's synchronous ``fetch``, routing-policy and ``run_sim``
  fleet tests of ``tests/test_net.py``, plus ``run_sim(admission=...)`` and
  ``run_sim(single_flight=False)``;
* the full ``ShelbyConfig``: fields, defaults, ``KNOB_DOCS`` and helpers.

Digests, receipts, stats, settlements, bytes and ``SimResult``s must be
equal: the copied modules keep the simulated clock's float arithmetic op
for op, so floats compare with ``==``.
"""
import dataclasses
import importlib
from types import SimpleNamespace

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


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _both(scenario):
    return {pkg: scenario(pkg) for pkg in PACKAGES}


def _cpu(pkg) -> dict:
    return {"device": "cpu"} if pkg == "repro_torch" else {}


def _ns(pkg):
    """The names the reference tests import, from one package."""
    rpc = _mod(pkg, "storage.rpc")
    ev = _mod(pkg, "net.events")
    fleet = _mod(pkg, "net.fleet")
    wl = _mod(pkg, "net.workloads")
    sp = _mod(pkg, "storage.sp")
    return SimpleNamespace(
        pkg=pkg, rpc=rpc, AdmissionSpec=rpc.AdmissionSpec, Overloaded=rpc.Overloaded,
        RPCNode=rpc.RPCNode, BackboneTransport=rpc.BackboneTransport,
        EventLoop=ev.EventLoop, Join=ev.Join, SingleFlight=ev.SingleFlight, Sleep=ev.Sleep,
        fleet=fleet, wl=wl, ReadRequest=wl.ReadRequest,
        HedgedScheduler=_mod(pkg, "net.scheduler").HedgedScheduler,
        ShelbyClient=_mod(pkg, "storage.sdk").ShelbyClient,
        StorageProvider=sp.StorageProvider, ServiceSpec=sp.ServiceSpec,
        ShelbyContract=_mod(pkg, "core.contract").ShelbyContract,
        SPInfo=_mod(pkg, "core.placement").SPInfo,
        Backbone=_mod(pkg, "net.backbone").Backbone,
        layout=_mod(pkg, "storage.blob").BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024,
                                                     **_cpu(pkg)),
    )


class _AlwaysFirst:
    """Routing policy pinning every chunkset on node 0 (retry tests)."""

    def pick(self, key, client, fleet):
        return 0


def _world(P, num_sps=8, *, slots=4, service_ms=None, num_rpcs=1, cache=16,
           scheduler_kw=None, single_flight=True, admission=None, policy=None):
    """``tests/test_overload.py``'s backbone world, in package ``P``."""
    contract = P.ShelbyContract()
    bb = P.Backbone.mesh(3, base_latency_ms=4.0, gbps=10.0)
    sps = {}
    for i in range(num_sps):
        dc = f"dc{i % 3}"
        contract.register_sp(P.SPInfo(sp_id=i, stake=1000.0, dc=dc, rack=f"r{i % 4}"))
        sps[i] = P.StorageProvider(i, service=P.ServiceSpec(disk_ms_per_chunk=service_ms,
                                                            slots=slots))
        bb.register_node(f"sp{i}", dc)
    specs = admission if isinstance(admission, list) else [admission] * num_rpcs
    rpcs = []
    for r in range(num_rpcs):
        node = f"rpc{r}"
        bb.register_node(node, f"dc{r % 3}")
        rpcs.append(P.RPCNode(node, contract, sps, P.layout, cache_chunksets=cache,
                              transport=P.BackboneTransport(sps, bb, node),
                              scheduler=P.HedgedScheduler(**(scheduler_kw or {})),
                              single_flight=single_flight, admission=specs[r]))
    bb.register_node("client", "dc0")
    fleet = P.fleet.RPCFleet(rpcs, policy or P.fleet.CacheAffinityPolicy(), backbone=bb)
    client = P.ShelbyClient(contract, fleet, deposit=1e9)
    return contract, bb, sps, fleet, client


def _blob(seed, n=60_000):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def receipt_view(r):
    if r is None:
        return None
    return (r.blob_id, r.offset, r.length, r.data, r.latency_ms, r.payments,
            r.chunksets_by_node, r.cache_hits, r.hedges_launched, r.hedged_wasted,
            r.coalesced, r.shed, r.retried_nodes)


def records_view(result):
    return [dataclasses.astuple(r) for r in result.records]


def stats_view(fleet):
    return [dataclasses.asdict(n.stats) for n in fleet.rpcs]


def settlement_view(s):
    return (s.deposits, s.client_refunds, s.node_income, s.sp_income)


# -- the SingleFlight primitive ----------------------------------------------------
def test_single_flight_leader_and_followers_share_one_task():
    def scenario(pkg):
        P = _ns(pkg)
        loop = P.EventLoop()
        sf = P.SingleFlight(loop)
        runs, got, late_calls = [], [], []

        def work():
            runs.append(loop.now)
            yield P.Sleep(10.0)
            return "payload"

        def caller(name):
            h, leader = sf.flight("key", work)
            res = yield P.Join(h)
            got.append((name, leader, res, loop.now))

        for name in ("a", "b", "c"):
            loop.spawn(caller(name))
        loop.run()
        assert runs == [0.0] and [g[1] for g in got] == [True, False, False]
        assert all(g[2] == "payload" and g[3] == 10.0 for g in got)
        assert sf.launched == 1 and sf.coalesced == 2

        def late():
            h, leader = sf.flight("key", work)
            late_calls.append(leader)
            yield P.Join(h)

        loop.spawn(late())
        loop.run()
        assert late_calls == [True] and sf.launched == 2
        return runs, got

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_single_flight_propagates_leader_error_to_all():
    def scenario(pkg):
        P = _ns(pkg)
        loop = P.EventLoop()
        sf = P.SingleFlight(loop)
        errs = []

        def boom():
            yield P.Sleep(1.0)
            raise ValueError("fetch died")

        def caller(name):
            h, _ = sf.flight("k", boom)
            try:
                yield P.Join(h)
            except ValueError as e:
                errs.append((name, str(e)))

        loop.spawn(caller("a"))
        loop.spawn(caller("b"))
        loop.run()
        assert errs == [("a", "fetch died"), ("b", "fetch died")] and not sf.live("k")
        return errs

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- single-flight through the read path -------------------------------------------
def test_concurrent_same_chunkset_misses_fetch_once():
    def scenario(pkg):
        P = _ns(pkg)
        contract, bb, sps, fleet, client = _world(P, num_sps=6, cache=16)
        meta = client.put(_blob(0))
        node = fleet.primary
        node._cache.clear()
        node.stats.chunks_requested = 0
        paid_before = node.stats.payments
        reqs = [P.ReadRequest(0.0, "client", meta.blob_id, 0, 1000) for _ in range(5)]
        receipts, result = client.replay(reqs)
        assert all(r.ok for r in result.records)
        assert (node.stats.chunkset_fetches, node.stats.coalesced,
                node.stats.chunks_requested) == (1, 4, 4)
        assert node.stats.payments - paid_before == pytest.approx(4 * node.price_per_chunk)
        assert sum(r.coalesced for r in receipts) == 4
        assert all(len(r.data) == 1000 and r.total_paid > 0 for r in receipts)
        settlement = client.settle()
        return ([receipt_view(r) for r in receipts], records_view(result),
                stats_view(fleet), settlement_view(settlement))

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_coalesced_waiter_latency_is_residual():
    def scenario(pkg):
        P = _ns(pkg)
        contract, bb, sps, fleet, client = _world(P, num_sps=6, cache=0,
                                                  service_ms=40.0, slots=1)
        meta = client.put(_blob(1))
        fleet.primary._cache.clear()
        reqs = [P.ReadRequest(0.0, "client", meta.blob_id, 0, 1000),
                P.ReadRequest(30.0, "client", meta.blob_id, 0, 1000)]
        result = P.wl.replay_open_loop(fleet, reqs)
        r0, r1 = result.records
        assert r0.ok and r1.ok and fleet.coalesced() == 1
        assert r1.latency_ms < r0.latency_ms and r1.finish_ms == pytest.approx(r0.finish_ms)
        return records_view(result), result.digest()

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- admission control / load shedding ---------------------------------------------
def test_shed_requests_debit_nothing_and_settle_cleanly():
    def scenario(pkg):
        P = _ns(pkg)
        contract, bb, sps, fleet, client = _world(
            P, num_sps=6, slots=1, service_ms=20.0, cache=0, single_flight=False,
            admission=P.AdmissionSpec(max_queued_requests=1))
        metas = [client.put(_blob(2 + 10 * i)) for i in range(4)]
        reqs = [P.ReadRequest(0.0, "client", m.blob_id, 0, 1000) for m in metas]
        receipts, result = client.replay(reqs)
        assert result.shed > 0 and result.shed == fleet.requests_shed()
        assert 0.0 < result.shed_rate <= 0.75
        served = [r for r in result.records if r.ok]
        shed = [r for r in result.records if r.shed]
        assert served and shed and len(served) + len(shed) == 4
        for rec in shed:
            assert not rec.ok and rec.nbytes == 0
            r = receipts[rec.index]
            assert r.shed and r.data == b"" and r.total_paid == 0.0
        settlement = client.settle()
        assert client._session is None  # settle() cleared the implicit session
        served_paid = sum(receipts[r.index].total_paid for r in served)
        assert settlement.total_node_income == pytest.approx(served_paid, abs=1e-5)
        return ([receipt_view(r) for r in receipts], records_view(result),
                stats_view(fleet), settlement_view(settlement))

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_overloaded_is_a_typed_read_error():
    def scenario(pkg):
        rpc = _mod(pkg, "storage.rpc")
        err = rpc.Overloaded("rpc0", "queue")
        assert isinstance(err, rpc.ReadError)
        return err.rpc_id, err.reason, str(err)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"] == ("rpc0", "queue", "rpc rpc0 overloaded (queue)")


def test_shed_leg_retries_on_sibling():
    def scenario(pkg):
        P = _ns(pkg)
        contract, bb, sps, fleet, client = _world(
            P, num_rpcs=2, admission=[P.AdmissionSpec(max_queued_requests=0), None],
            policy=_AlwaysFirst())
        data = _blob(3)
        meta = client.put(data)
        receipt = client.read(meta.blob_id, 0, 2000, client="client")
        assert receipt.data == data[:2000]
        assert receipt.chunksets_by_node == {"rpc1": 1}
        assert receipt.retried_nodes == {"rpc1": 1}
        assert receipt.payments.keys() == {"rpc1"}
        assert (fleet.shed_legs, fleet.retried_legs, fleet.retried_chunksets) == (1, 1, 1)
        assert fleet.rpcs[0].stats.shed_requests == 1
        settlement = client.settle()
        return receipt_view(receipt), stats_view(fleet), settlement_view(settlement)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_whole_fleet_overloaded_drops_request_as_shed():
    def scenario(pkg):
        P = _ns(pkg)
        contract, bb, sps, fleet, client = _world(
            P, num_rpcs=2, admission=[P.AdmissionSpec(max_queued_requests=0)] * 2,
            policy=_AlwaysFirst())
        meta = client.put(_blob(4))
        with pytest.raises(P.Overloaded):
            client.read(meta.blob_id, 0, 1000, client="client")
        receipts, result = client.replay([P.ReadRequest(0.0, "client", meta.blob_id, 0, 1000)])
        assert result.shed == 1 and not result.records[0].ok
        assert receipts[0].shed and receipts[0].total_paid == 0.0
        settlement = client.settle()
        return receipt_view(receipts[0]), records_view(result), settlement_view(settlement)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_admitted_p99_bounded_under_saturation_storm():
    def scenario(pkg):
        P = _ns(pkg)
        data = [_blob(5 + i) for i in range(8)]

        def storm(admission):
            contract, bb, sps, fleet, client = _world(
                P, num_sps=6, slots=1, service_ms=20.0, cache=0,
                single_flight=False, admission=admission)
            metas = [client.put(d) for d in data]
            reqs = [P.ReadRequest(i * 4.5, "client", metas[i % len(metas)].blob_id, 0, 1000)
                    for i in range(60)]
            return fleet, P.wl.replay_open_loop(fleet, reqs)

        _, free = storm(None)
        assert free.shed == 0
        fleet, capped = storm(P.AdmissionSpec(max_inflight_fetches=4))
        assert capped.shed > 0 and all(r.ok or r.shed for r in capped.records)
        assert capped.percentile(99.0) * 2 < free.percentile(99.0)
        assert len(capped.latencies_ms()) >= 10
        return free.digest(), capped.digest(), capped.shed, stats_view(fleet)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_sweep_open_loop_traces_the_saturation_knee():
    def scenario(pkg):
        P = _ns(pkg)
        data = [_blob(60 + i) for i in range(6)]
        metas = []

        def make_fleet():
            contract, bb, sps, fleet, client = _world(
                P, num_sps=6, slots=1, service_ms=10.0, cache=0, single_flight=False,
                admission=P.AdmissionSpec(max_inflight_fetches=4))
            metas[:] = [client.put(d) for d in data]
            return fleet

        def make_requests(rate_rps):
            gap = 1e3 / rate_rps
            return [P.ReadRequest(i * gap, "client", metas[i % len(data)].blob_id, 0, 1000)
                    for i in range(40)]

        sweep = P.wl.sweep_open_loop(make_fleet, make_requests, [20.0, 400.0])
        assert sweep.shed_rate[0] == 0.0 and sweep.shed_rate[1] > 0.0
        assert sweep.p99_ms()[1] < 10 * max(sweep.p99_ms()[0], 1.0)
        assert len(sweep.goodput_mbps) == 2
        return list(sweep.shed_rate), list(sweep.p99_ms()), list(sweep.goodput_mbps)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_hedges_shed_first_at_the_fetch_budget():
    def scenario(pkg):
        P = _ns(pkg)

        def run(admission):
            contract, bb, sps, fleet, client = _world(
                P, num_sps=6, slots=1, service_ms=25.0, cache=0, single_flight=False,
                scheduler_kw=dict(hedge=2, deadline_factor=0.3, min_deadline_ms=1.0),
                admission=admission)
            metas = [client.put(_blob(7 + i)) for i in range(4)]
            reqs = [P.ReadRequest(i * 1.0, "client", metas[i].blob_id, 0, 1000)
                    for i in range(4)]
            return fleet, P.wl.replay_open_loop(fleet, reqs)

        free_fleet, free = run(None)
        assert free_fleet.hedges_launched() > 0
        capped_fleet, capped = run(P.AdmissionSpec(max_inflight_fetches=4))
        assert capped_fleet.hedges_suppressed() > 0
        assert capped_fleet.hedges_launched() < free_fleet.hedges_launched()
        return (free.digest(), capped.digest(), stats_view(free_fleet),
                stats_view(capped_fleet))

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_fetch_budget_holds_for_simultaneous_arrivals():
    def scenario(pkg):
        P = _ns(pkg)
        contract, bb, sps, fleet, client = _world(
            P, num_sps=6, slots=1, service_ms=20.0, cache=0, single_flight=False,
            admission=P.AdmissionSpec(max_inflight_fetches=1))
        metas = [client.put(_blob(10 + i)) for i in range(3)]
        reqs = [P.ReadRequest(0.0, "client", m.blob_id, 0, 1000) for m in metas]
        result = P.wl.replay_open_loop(fleet, reqs)
        assert sum(1 for r in result.records if r.ok) == 1
        assert result.shed == 2  # the budget saw the first flight immediately
        assert fleet.primary._inflight_fetches == 0 and fleet.primary._admitted == 0
        return records_view(result), stats_view(fleet)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_brownout_recovers_when_idle():
    def scenario(pkg):
        P = _ns(pkg)
        contract, bb, sps, fleet, client = _world(
            P, num_sps=6, slots=1, service_ms=30.0, cache=0, single_flight=False,
            admission=P.AdmissionSpec(deadline_ms=1.0))
        meta = client.put(_blob(11))
        r1 = client.read(meta.blob_id, 0, 1000, client="client")
        assert fleet.primary._ewma_fetch_ms > 1.0
        r2 = client.read(meta.blob_id, 0, 2000, client="client")
        assert len(r2.data) == 2000 and fleet.primary.stats.shed_requests == 0
        reqs = [P.ReadRequest(0.0, "client", meta.blob_id, 0, 1000),
                P.ReadRequest(1.0, "client", meta.blob_id, 4000, 1000)]
        result = P.wl.replay_open_loop(fleet, reqs)
        assert result.shed == 1
        settlement = client.settle()
        return (receipt_view(r1), receipt_view(r2), records_view(result),
                fleet.primary._ewma_fetch_ms, settlement_view(settlement))

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_dropped_excludes_shed():
    def scenario(pkg):
        P = _ns(pkg)
        contract, bb, sps, fleet, client = _world(
            P, admission=P.AdmissionSpec(max_queued_requests=0))
        meta = client.put(_blob(12))
        receipts, result = client.replay([P.ReadRequest(0.0, "client", meta.blob_id, 0, 1000)])
        assert result.shed == 1 and result.dropped == 0
        return receipt_view(receipts[0]), records_view(result)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_admission_leaves_sub_saturation_digest_unchanged():
    def scenario(pkg):
        P = _ns(pkg)

        def run_once(admission):
            contract, bb, sps, fleet, client = _world(P, num_sps=6, admission=admission)
            rng = np.random.default_rng(8)
            metas = [client.put(rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes())
                     for _ in range(3)]
            bb.reset_accounting()
            reqs = P.wl.zipf_hotset(metas, clients=["client"], num_requests=30,
                                    interarrival_ms=25.0, arrival="poisson", seed=9)
            receipts, result = client.replay(reqs)
            client.settle()
            return result

        generous = P.AdmissionSpec(max_queued_requests=10_000, max_inflight_fetches=10_000,
                         deadline_ms=1e9)
        a, b, c = run_once(None), run_once(generous), run_once(generous)
        assert a.shed == b.shed == 0
        assert a.digest() == b.digest() == c.digest()
        return a.digest()

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- hedge-timer re-arm after overload-gate suppression (net/scheduler.py) ---------
def test_hedge_rearms_after_gate_recovers():
    def scenario(pkg):
        P = _ns(pkg)
        gate_answers = [False, True, True]  # brownout, then recovered

        def gate():
            return gate_answers.pop(0) if gate_answers else True

        def issue_task(key, sp_id):
            yield P.Sleep(500.0 if key == 0 else 5.0)
            return f"shard{key}"

        loop = P.EventLoop()
        sched = P.HedgedScheduler(hedge=1, deadline_factor=2.0, min_deadline_ms=10.0)
        candidates = [(0, 0, 1.0), (1, 1, 2.0), (2, 2, 30.0)]
        h = loop.spawn(sched.fetch_task(loop, 2, candidates, issue_task, hedge_gate=gate))
        res = loop.run_until(h)
        assert res.hedges_suppressed >= 1 and res.hedges == 1
        assert len(res.shards) == 2 and res.latency_ms < 500.0
        return dataclasses.asdict(res)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_suppressed_hedge_without_recovery_never_hedges():
    def scenario(pkg):
        P = _ns(pkg)

        def issue_task(key, sp_id):
            yield P.Sleep(200.0 if key == 0 else 5.0)
            return f"shard{key}"

        loop = P.EventLoop()
        sched = P.HedgedScheduler(hedge=1, deadline_factor=2.0, min_deadline_ms=10.0)
        candidates = [(0, 0, 1.0), (1, 1, 2.0), (2, 2, 30.0)]
        h = loop.spawn(sched.fetch_task(loop, 2, candidates, issue_task,
                                        hedge_gate=lambda: False))
        res = loop.run_until(h)
        assert res.hedges == 0 and res.hedges_suppressed >= 1
        assert res.latency_ms == pytest.approx(200.0)
        return dataclasses.asdict(res)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- the scheduler's synchronous fetch (tests/test_net.py) -------------------------
def _issue_from(latencies, fail=()):
    def issue(key, sp_id, t_ms):
        if key in fail:
            return None, t_ms + latencies[key]
        return f"shard{key}", t_ms + latencies[key]

    return issue


@pytest.mark.parametrize("case", ["healthy", "straggler", "failures", "partial"])
def test_scheduler_sync_fetch_matches_reference(case):
    def scenario(pkg):
        HS = _mod(pkg, "net.scheduler").HedgedScheduler
        est = [(i, i, 1.0) for i in range(6)]
        actual = {i: 1.0 for i in range(6)}
        if case == "healthy":
            res = HS(hedge=2).fetch(4, est, _issue_from(actual))
            assert res.issued == 4 and res.wasted == 0 and res.latency_ms == 1.0
        elif case == "straggler":
            actual[0] = 500.0
            res = HS(hedge=2, min_deadline_ms=5.0).fetch(4, est, _issue_from(actual))
            assert len(res.shards) == 4 and res.hedges >= 1 and res.latency_ms < 10.0
            assert res.wasted >= 1
        elif case == "failures":
            res = HS(hedge=2).fetch(4, est, _issue_from(actual, fail={0, 1}))
            assert len(res.shards) == 4 and res.failed == 2
            assert res.latency_ms == pytest.approx(2.0)
        else:
            res = HS().fetch(4, est[:5], _issue_from(actual, fail={0, 1, 2}))
            assert len(res.shards) == 2
        return dataclasses.asdict(res)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- cache TTL / admit-bytes (tests/test_events.py) ---------------------------------
def _cluster(P):
    """``tests/conftest.py``'s ``cluster`` fixture, in package ``P``."""
    contract = P.ShelbyContract()
    sps = {}
    for i in range(8):
        contract.register_sp(P.SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 3}", rack=f"r{i % 4}"))
        sps[i] = P.StorageProvider(i)
    rpc = P.RPCNode("rpc0", contract, sps, P.layout, cache_chunksets=16)
    client = P.ShelbyClient(contract, rpc, deposit=1e9)
    return contract, sps, rpc, client


def test_cache_ttl_expires_on_sim_clock():
    def scenario(pkg):
        P = _ns(pkg)
        contract, sps, rpc, client = _cluster(P)
        meta = client.put(np.random.default_rng(0).integers(0, 256, 100_000, dtype=np.uint8)
                          .tobytes())
        node = P.RPCNode("rpc_ttl", contract, sps, P.layout, cache_ttl_ms=50.0)
        node.read_items_detailed([(meta.blob_id, 0)], start_ms=0.0)
        assert node.stats.cache_hits == 0
        node.read_items_detailed([(meta.blob_id, 0)], start_ms=10.0)
        assert node.stats.cache_hits == 1  # fresh entry
        _, expires, _ = node._cache[(meta.blob_id, 0)]
        node.read_items_detailed([(meta.blob_id, 0)], start_ms=120.0)
        assert node.stats.cache_hits == 1  # TTL lapsed on the sim clock -> refetch
        return expires, dataclasses.asdict(node.stats)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_cache_admission_threshold_skips_large_objects():
    def scenario(pkg):
        P = _ns(pkg)
        contract, sps, rpc, client = _cluster(P)
        meta = client.put(np.random.default_rng(0).integers(0, 256, 100_000, dtype=np.uint8)
                          .tobytes())
        tiny = P.RPCNode("rpc_adm", contract, sps, P.layout, cache_admit_bytes=16)
        tiny.read_items_detailed([(meta.blob_id, 0)], start_ms=0.0)
        tiny.read_items_detailed([(meta.blob_id, 0)], start_ms=0.0)
        assert tiny.stats.cache_hits == 0 and len(tiny._cache) == 0
        # a bar of exactly one decoded chunkset admits it
        fits = P.RPCNode("rpc_fit", contract, sps, P.layout,
                         cache_admit_bytes=P.layout.chunkset_bytes)
        fits.read_items_detailed([(meta.blob_id, 0)], start_ms=0.0)
        fits.read_items_detailed([(meta.blob_id, 0)], start_ms=0.0)
        assert fits.stats.cache_hits == 1
        return dataclasses.asdict(tiny.stats), dataclasses.asdict(fits.stats)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- RPCNode.read_range boundary conditions (tests/test_read_range.py) -------------
def _stored(P):
    contract, sps, rpc, client = _cluster(P)
    cs = rpc.layout.chunkset_bytes
    data = np.random.default_rng(0).integers(0, 256, int(2.5 * cs), dtype=np.uint8).tobytes()
    meta = client.put(data)
    return rpc, client, meta, data


@pytest.mark.parametrize("case", ["boundary", "padded_end", "single_bytes", "full_blob",
                                  "bad_length"])
def test_read_range_matches_reference(case):
    def scenario(pkg):
        rpc, client, meta, data = _stored(_ns(pkg))
        cs = rpc.layout.chunkset_bytes
        got = []
        if case == "boundary":
            for off, ln in [(cs - 1, 2), (cs - 100, 200), (2 * cs - 1, 2), (0, 2 * cs)]:
                got.append(rpc.read_range_timed(meta.blob_id, off, ln))
                assert got[-1][0] == data[off: off + ln]
        elif case == "padded_end":
            off = 2 * cs + 100
            got.append(rpc.read_range(meta.blob_id, off, 10_000))
            assert got[-1] == data[off: off + 10_000]
            got.append(rpc.read_range(meta.blob_id, len(data) - 50, 10_000))
            assert got[-1] == data[-50:]
        elif case == "single_bytes":
            got.append(rpc.read_range(meta.blob_id, len(data) - 1, 1))
            assert got[-1] == data[-1:]
            for off in (0, cs - 1, cs, 2 * cs):
                got.append(rpc.read_range(meta.blob_id, off, 1))
                assert got[-1] == data[off: off + 1]
        elif case == "full_blob":
            got.append(rpc.read_blob(meta.blob_id))
            assert got[-1] == data and client.get(meta.blob_id) == data
        else:
            with pytest.raises(ValueError):
                rpc.read_range(meta.blob_id, 0, 0)
        return got, dataclasses.asdict(rpc.stats)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_read_chunkset_returns_the_decoded_chunkset():
    """``read_chunkset(_timed)``: one chunkset's (k, alpha, w) bytes."""
    def scenario(pkg):
        rpc, client, meta, data = _stored(_ns(pkg))
        part, ms = rpc.read_chunkset_timed(meta.blob_id, 1, start_ms=5.0)
        again = rpc.read_chunkset(meta.blob_id, 1)
        raw = np.asarray(part if pkg == "repro" else part.numpy()).tobytes()
        cs = rpc.layout.chunkset_bytes
        assert raw == data[cs: 2 * cs]
        assert np.asarray(again if pkg == "repro" else again.numpy()).tobytes() == raw
        return tuple(part.shape), ms, dataclasses.asdict(rpc.stats)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- batched decode (tests/test_batched_decode.py) ----------------------------------
def _codeword_sets(pkg, k, m, trials, w=16, seed=0):
    """Shard sets of seeded codewords: numpy arrays in both packages."""
    rng = np.random.default_rng(seed)
    ref = _mod("repro", "core.clay").ClayCode(k=k, m=m)
    sets = []
    for _ in range(trials):
        data = rng.integers(0, 256, (k, ref.alpha, w), dtype=np.uint8)
        cw = np.asarray(ref.encode(data))
        drop = rng.choice(ref.n, size=int(rng.integers(0, m + 1)), replace=False)
        sets.append({i: cw[i] for i in range(ref.n) if i not in drop})
    return sets


def _code(pkg, k, m):
    return _mod(pkg, "core.clay").ClayCode(k=k, m=m, **_cpu(pkg))


def _as_bytes(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x).tobytes()


@pytest.mark.parametrize("k, m, trials, w", [(4, 2, 8, 16), (3, 3, 10, 8)],
                         ids=["one_pattern_family", "mixed_erasure_patterns"])
def test_decode_batch_matches_per_chunkset(k, m, trials, w):
    def scenario(pkg):
        code = _code(pkg, k, m)
        sets = _codeword_sets(pkg, k, m, trials, w)
        if (k, m) == (3, 3):
            assert len({frozenset(s) for s in sets}) > 1  # grouping exercised
        singles = [_as_bytes(code.decode(s)) for s in sets]
        batched = [_as_bytes(x) for x in code.decode_batch(sets)]
        assert batched == singles
        return batched

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_decode_batch_through_the_kernel_wrapper():
    """The reference's Pallas ``gf_matmul`` (interpret mode) against the
    port's ``ops.gf_matmul`` wrapper, which takes its plain version here."""
    from repro.kernels import ops as jops

    sets = _codeword_sets("repro", 4, 2, trials=4, w=8)
    ref = [_as_bytes(x) for x in
           _code("repro", 4, 2).decode_batch(sets, matmul=jops.gf_matmul_np)]
    got = [_as_bytes(x) for x in _code("repro_torch", 4, 2).decode_batch(sets)]
    assert got == ref


def test_decode_batch_rejects_too_few_shards():
    for pkg in PACKAGES:
        code = _code(pkg, 4, 2)
        sets = _codeword_sets(pkg, 4, 2, trials=1)
        sets[0] = {k: v for k, v in list(sets[0].items())[: code.k - 1]}
        with pytest.raises(ValueError):
            code.decode_batch(sets)


def test_rpc_batched_path_byte_identical():
    """``batch_decode`` on and off: the same bytes as the put's input, and
    the same stats as the reference, with a crashed and a corrupt SP."""
    def scenario(pkg):
        contract, sps, rpc, client = _cluster(_ns(pkg))
        data = np.random.default_rng(0).integers(0, 256, 300_000, dtype=np.uint8).tobytes()
        meta = client.put(data)
        sps[meta.placement[(0, 0)]].crash()
        sps[meta.placement[(1, 1)]].behavior.corrupt = True
        out = []
        for batch in (True, False):
            rpc.batch_decode = batch
            rpc._cache.clear()
            out.append(rpc.read_blob(meta.blob_id))
        assert out[0] == out[1] == data
        return dataclasses.asdict(rpc.stats)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- fleet routing and run_sim (tests/test_net.py) ----------------------------------
def _backbone_cluster(P, policy, num_rpcs=3):
    contract = P.ShelbyContract()
    bb = P.Backbone.mesh(3, base_latency_ms=4.0, gbps=10.0)
    sps = {}
    for i in range(8):
        dc = f"dc{i % 3}"
        contract.register_sp(P.SPInfo(sp_id=i, stake=1000.0, dc=dc, rack=f"r{i % 4}"))
        sps[i] = P.StorageProvider(i)
        bb.register_node(f"sp{i}", dc)
    rpcs = []
    for r in range(num_rpcs):
        node = f"rpc{r}"
        bb.register_node(node, f"dc{r % 3}")
        rpcs.append(P.RPCNode(node, contract, sps, P.layout,
                              transport=P.BackboneTransport(sps, bb, node)))
    bb.register_node("client", "dc0")
    fleet = P.fleet.RPCFleet(rpcs, policy, backbone=bb)
    client = P.ShelbyClient(contract, rpcs[0], deposit=1e9)
    return contract, bb, sps, rpcs, fleet, client


def test_backbone_transport_read_range_timed_matches_reference():
    def scenario(pkg):
        P = _ns(pkg)
        contract, bb, sps, rpcs, fleet, client = _backbone_cluster(
            P, P.fleet.CacheAffinityPolicy(), num_rpcs=1)
        data = np.random.default_rng(0).integers(0, 256, 200_000, dtype=np.uint8).tobytes()
        meta = client.put(data)
        sps[meta.placement[(0, 0)]].crash()
        sps[meta.placement[(0, 1)]].behavior.latency_ms = 500.0
        rpcs[0]._cache.clear()
        got, ms = rpcs[0].read_range_timed(meta.blob_id, 0, len(data))
        assert got == data and 0.0 < ms < 500.0  # the straggler never gated the read
        return ms, bb.transfers, dict(bb.link_bytes)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


@pytest.mark.parametrize("policy", ["affinity", "p2c", "latency"])
def test_routing_policies_match_reference(policy):
    """The three named policies through ``RPCFleet.read_range``: cache
    affinity routes stably and hits, power-of-two balances, latency-aware
    prefers the client's own DC."""
    def scenario(pkg):
        P = _ns(pkg)
        pol = P.fleet.make_policy(policy)
        assert type(pol) is P.fleet.POLICY_FACTORIES[policy]().__class__
        contract, bb, sps, rpcs, fleet, client = _backbone_cluster(P, pol)
        data = np.random.default_rng(1).integers(0, 256, 200_000, dtype=np.uint8).tobytes()
        meta = client.put(data)
        for r in rpcs:
            r._cache.clear()
            r.stats.cache_hits = 0
        out = []
        if policy == "affinity":
            assert fleet.read_range(meta.blob_id, 0, len(data), client="client")[0] == data
            before = fleet.chunkset_reads
            got, ms = fleet.read_range(meta.blob_id, 0, len(data), client="client")
            assert got == data
            assert sum(r.stats.cache_hits for r in rpcs) == fleet.chunkset_reads - before
            out.append(ms)
        else:
            for _ in range(30 if policy == "p2c" else 10):
                out.append(fleet.read_range(meta.blob_id, 0, 1000, client="client")[1])
            if policy == "p2c":
                assert max(fleet.routed) - min(fleet.routed) <= 10
            else:
                assert fleet.routed[0] > fleet.routed[1] and fleet.routed[0] > fleet.routed[2]
        return out, list(fleet.routed), fleet.latency_percentiles(50.0, 99.0)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_policy_static_flags_and_unknown_name():
    for pkg in PACKAGES:
        fleet = _mod(pkg, "net.fleet")
        assert (fleet.LatencyAwarePolicy.static, fleet.CacheAffinityPolicy.static,
                fleet.PowerOfTwoPolicy.static) == (False, True, False)
        assert sorted(fleet.POLICY_FACTORIES) == ["affinity", "latency", "p2c"]
        with pytest.raises(ValueError, match="routing_policy"):
            fleet.make_policy("random")


@pytest.mark.parametrize("case", ["fleet", "admission", "no_single_flight"])
def test_run_sim_overload_options_match_reference(case):
    """``run_sim`` over a three-node fleet, with an admission spec or with
    single-flight off: the ``SimResult``s are equal."""
    def scenario(pkg):
        sim = _mod(pkg, "core.simulation")
        kw = dict(_cpu(pkg))
        if case == "admission":
            kw["admission"] = _mod(pkg, "storage.rpc").AdmissionSpec(max_queued_requests=1)
        elif case == "no_single_flight":
            kw["single_flight"] = False
        res = sim.run_sim(sim.honest_population(8), epochs=1, num_blobs=2,
                          blob_bytes=40_000, num_rpcs=3, read_requests_per_epoch=10, **kw)
        assert res.bytes_served > 0
        assert all(u > 0 for u in res.utilities.values())  # honest SPs profit
        if case == "admission":
            assert res.reads_shed > 0
        return dataclasses.asdict(res)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


# -- the full ShelbyConfig ----------------------------------------------------------
def test_config_fields_defaults_and_knob_docs_match_reference():
    from repro.configs import shelby as ref
    from repro_torch.configs import shelby as port

    names = [f.name for f in dataclasses.fields(port.ShelbyConfig)]
    assert names == [f.name for f in dataclasses.fields(ref.ShelbyConfig)
                     if f.name != "decode_matmul"]  # the layout's device picks the kernel
    assert sorted(port.KNOB_DOCS) == sorted(names)
    for name in names:
        assert port.knob_doc(name) == ref.knob_doc(name), name
    with pytest.raises(KeyError, match="KNOB_DOCS"):
        port.knob_doc("decode_matmul")
    for cfg, rcfg in ((port.CONFIG, ref.CONFIG), (port.SMOKE, ref.SMOKE)):
        for name in names:
            a, b = getattr(cfg, name), getattr(rcfg, name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                if name == "layout":  # the port's layout also names its device
                    b["device"] = None
            assert a == b, name


def test_config_helpers_build_the_same_specs():
    from repro.configs.shelby import ShelbyConfig as Ref
    from repro_torch.configs.shelby import ShelbyConfig as Port

    knobs = dict(rpc_max_inflight_fetches=6, rpc_hedge=3, rpc_hedge_deadline_factor=2.0,
                 routing_policy="p2c", churn_p_crash=0.1, churn_joins_per_epoch=2)
    for kw in ({}, knobs, dict(nic_gbps=None, rpc_shed_deadline_ms=40.0)):
        port, ref = Port(**kw), Ref(**kw)
        for method in ("admission", "background", "service", "nic", "das"):
            a, b = getattr(port, method)(), getattr(ref, method)()
            assert (a is None) == (b is None), method
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b), method
        assert dataclasses.asdict(port.churn(seed=4)) == dataclasses.asdict(ref.churn(seed=4))
        s, r = port.scheduler(), ref.scheduler()
        assert (s.hedge, s.deadline_factor, s.min_deadline_ms) == (
            r.hedge, r.deadline_factor, r.min_deadline_ms)
        assert type(port.policy()).__name__ == type(ref.policy()).__name__
    assert Port(rpc_max_inflight_fetches=6).admission() == \
        _mod("repro_torch", "storage.rpc").AdmissionSpec(max_inflight_fetches=6)


# -- the `concurrent` scenario's world (src/repro/scenarios/serving.py) -------------
def _concurrent_run(pkg, rate, mode):
    """One replay of the scenario's 400 Poisson Zipf reads on a fresh
    3-node fleet over its world (12 SPs, a 250 ms straggler, a crashed SP,
    10 Gbps NICs, 2 disk slots): ``mode`` "default" (no admission),
    "admitted" (a fetch budget of 6)."""
    P = _ns(pkg)
    cfg = _mod(pkg, "configs.shelby").ShelbyConfig(rpc_max_inflight_fetches=6)
    nic = cfg.nic()
    contract = P.ShelbyContract()
    bb = P.Backbone.mesh(3, base_latency_ms=6.0, gbps=25.0)
    rng = np.random.default_rng(42)
    sps = {}
    for i in range(12):
        contract.register_sp(P.SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 3}", rack=f"r{i % 4}"))
        sps[i] = P.StorageProvider(i, service=cfg.service(slots=2))
        sps[i].behavior.latency_ms = float(rng.uniform(1.0, 12.0))
        bb.register_node(f"sp{i}", f"dc{i % 3}", nic=nic)
    for c in range(3):
        bb.register_node(f"client{c}", f"dc{c}")
    bb.register_node("writer", "dc0")
    writer = P.ShelbyClient(contract, P.RPCNode("writer", contract, sps, P.layout), deposit=1e9)
    metas = [writer.put(rng.integers(0, 256, (8 if b == 0 else 4) * P.layout.chunkset_bytes,
                                     dtype=np.uint8).tobytes()) for b in range(6)]
    sps[0].behavior.latency_ms = 250.0
    sps[1].crash()
    rpcs = []
    for r in range(3):
        bb.register_node(f"rpc{r}", f"dc{r}", nic=nic)
        rpcs.append(P.RPCNode(f"rpc{r}", contract, sps, P.layout, cache_chunksets=8,
                              transport=P.BackboneTransport(sps, bb, f"rpc{r}"),
                              scheduler=cfg.scheduler(),
                              admission=cfg.admission() if mode == "admitted" else None))
    bb.reset_accounting()
    fleet = P.fleet.RPCFleet(rpcs, cfg.policy(), backbone=bb)
    reqs = P.wl.zipf_hotset(metas, clients=["client0", "client1", "client2"],
                            num_requests=400, interarrival_ms=1000.0 / rate, seed=11,
                            arrival="poisson")
    with P.ShelbyClient(contract, fleet, deposit=1e9).session() as session:
        receipts, result = session.replay(reqs)
    assert abs(session.settlement.total_node_income
               - sum(r.total_paid for r in session.receipts)) < 1e-3
    return (result.digest(), result.shed, result.percentile(50.0), result.percentile(99.0),
            result.goodput_mbps, fleet.coalesced(), fleet.retried_legs, stats_view(fleet))


@pytest.mark.parametrize("rate, mode, digest, shed, coalesced, p99", [
    (200, "default", "f691cbe9e5a3bbdf", 0, 28, 68.7),
    (1000, "admitted", None, 3, 77, 68.7),
    (5000, "admitted", None, 26, 313, 67.0),
])
def test_concurrent_world_matches_reference(rate, mode, digest, shed, coalesced, p99):
    """The numbers ``chip_smoke.py``'s overload phase pins: equal to the
    reference's, live."""
    got = _both(lambda pkg: _concurrent_run(pkg, rate, mode))
    assert got["repro_torch"] == got["repro"]
    run = got["repro_torch"]
    assert (run[1], run[5], round(run[3], 1)) == (shed, coalesced, p99)
    assert digest is None or run[0][:16] == digest
