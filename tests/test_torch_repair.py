"""The port's MSR repair and repair coordinator, held against the JAX package.

``ClayCode.repair`` runs on the layout's device (here the CPU plain path:
``gf_matmul_ref`` for its one GF matmul); the JAX package's runs its numpy
loops.  The same seeded worlds are built in both packages and driven through
the same calls: rebuilt bytes, ``RepairReport``s (mode, helper bytes,
placement, rejected helpers, simulated ms), what the SPs store and the
contract's placement must be equal.  GF coding is exact and the simulated
clock's float arithmetic is copied op for op, so equality is exact.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro.core.clay import ClayCode as JClayCode
from repro_torch.core.clay import ClayCode
from repro_torch.kernels import ops

PACKAGES = ("repro", "repro_torch")
# (k, m, w): w = 8 (mod 16) at every code; (6,3) with an odd w makes the
# repair product's N = 9w odd, the kernel's byte path on the card
REPAIR_CASES = [(4, 2, 24), (6, 3, 8), (10, 6, 8), (6, 3, 7)]


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _layout(pkg, **kw):
    if pkg == "repro_torch":
        kw["device"] = "cpu"
    return _mod(pkg, "storage.blob").BlobLayout(**kw)


def _world(pkg, *, k=4, m=2, chunkset=64 * 1024, num_sps=8, blob_bytes=200_000):
    """The reference tests' ``cluster`` fixture world plus one seeded blob."""
    SPInfo = _mod(pkg, "core.placement").SPInfo
    layout = _layout(pkg, k=k, m=m, chunkset_bytes_target=chunkset)
    contract = _mod(pkg, "core.contract").ShelbyContract()
    sps = {}
    for i in range(num_sps):
        contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 3}", rack=f"r{i % 4}"))
        sps[i] = _mod(pkg, "storage.sp").StorageProvider(i)
    rpc = _mod(pkg, "storage.rpc").RPCNode("rpc0", contract, sps, layout, cache_chunksets=16)
    client = _mod(pkg, "storage.sdk").ShelbyClient(contract, rpc, deposit=1e9)
    data = np.random.default_rng(0).integers(0, 256, blob_bytes, dtype=np.uint8).tobytes()
    meta = client.put(data)
    return layout, contract, sps, rpc, client, meta, data


def _coordinator(pkg, contract, sps, layout, **kw):
    return _mod(pkg, "storage.repair").RepairCoordinator(contract, sps, layout, **kw)


def report_view(r):
    return dataclasses.astuple(r)


def world_view(contract, sps):
    stored = {(i, key): arr.tobytes() for i, sp in sps.items() for key, arr in sp._chunks.items()}
    placement = {b: dict(meta.placement) for b, meta in contract.blobs.items()}
    return stored, placement, dict(contract.placement_version)


def _flip(sp, key):
    sp._chunks[key] = sp._chunks[key].copy()
    sp._chunks[key].reshape(-1)[0] ^= 0xFF


def _both(scenario):
    return {pkg: scenario(pkg) for pkg in PACKAGES}


# ---------------------------------------------------------------------------
# ClayCode.repair
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,m,w", REPAIR_CASES, ids=lambda v: str(v))
def test_repair_equals_reference_for_every_node(k, m, w, monkeypatch):
    ref, port = JClayCode(k=k, m=m), ClayCode(k=k, m=m, device="cpu")
    cw = ref.encode(np.random.default_rng(k * 100 + w).integers(
        0, 256, (k, ref.alpha, w), dtype=np.uint8))
    calls = []
    real = ops.gf_matmul
    monkeypatch.setattr(ops, "gf_matmul", lambda a, b: calls.append((a.shape, b.shape))
                        or real(a, b))
    for failed in range(k + m):
        ids = ref.repair_subchunk_ids(failed)
        assert ids == port.repair_subchunk_ids(failed)
        helpers = {i: cw[i][ids] for i in range(k + m) if i != failed}
        calls.clear()
        got = port.repair(failed, helpers)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert got.dtype == torch.uint8 and got.shape == (ref.alpha, w)
        np.testing.assert_array_equal(got.numpy(), ref.repair(failed, helpers))
        np.testing.assert_array_equal(got.numpy(), cw[failed])
        # one GF product per repair: (q x (N-q)) over every repair plane
        r = ref.alpha // ref.q
        assert calls == [((m, ref.N - m), (ref.N - m, r * w))]
        # tensors are taken as well as numpy arrays
        as_tensors = {i: torch.from_numpy(a) for i, a in helpers.items()}
        assert torch.equal(port.repair(failed, as_tensors), got)


def test_repair_needs_every_helper():
    port = ClayCode(k=4, m=2, device="cpu")
    r = port.alpha // port.q
    helpers = {i: np.zeros((r, 8), np.uint8) for i in range(1, 5)}
    with pytest.raises(ValueError, match="all n-1 helpers"):
        port.repair(0, helpers)
    helpers[5] = np.zeros((r, 8), np.uint8)
    port.repair(0, helpers)
    with pytest.raises(ValueError, match="alpha/q"):
        port.repair(0, {i: np.zeros((r + 1, 8), np.uint8) for i in range(1, 6)})


def test_repair_bandwidth_is_the_msr_optimum():
    for k, m in ((4, 2), (10, 6)):
        ref, port = JClayCode(k=k, m=m), ClayCode(k=k, m=m, device="cpu")
        chunk = ref.alpha * 4856
        assert port.repair_bandwidth_bytes(chunk) == ref.repair_bandwidth_bytes(chunk)
    # the production (10,6) chunk: 15 helpers x 36 planes x 4856 bytes
    assert ClayCode(10, 6, device="cpu").repair_bandwidth_bytes(216 * 4856) == 2_622_240


# ---------------------------------------------------------------------------
# RepairCoordinator on mirrored worlds
# ---------------------------------------------------------------------------
def test_repair_all_matches_reference():
    """examples/quickstart.py step 4 and then some: an SP loses all its
    chunks (restored in place), then a second SP crashes (its chunks move to
    new SPs); every report, the stored bytes and the placement are equal."""
    def scenario(pkg):
        layout, contract, sps, rpc, client, meta, data = _world(pkg)
        out = []
        victim = meta.placement[(0, 0)]
        sps[victim].crash()
        sps[victim].recover()
        sps[victim].wipe()
        rc = _coordinator(pkg, contract, sps, layout)
        reports = rc.repair_all()
        assert reports and all(r.mode == "msr" and r.verified for r in reports)
        assert all(r.new_sp == victim for r in reports)  # restored in place
        expect = (layout.n - 1) * layout.chunk_bytes // layout.code.q
        assert all(r.helper_bytes_read == expect for r in reports)
        assert not rc.scan_lost_chunks()
        out.append(([report_view(r) for r in reports], world_view(contract, sps)))
        second = meta.placement[(1, 3)]
        sps[second].crash()
        reports = rc.repair_all()
        assert reports and all(r.verified and r.new_sp != second for r in reports)
        out.append(([report_view(r) for r in reports], world_view(contract, sps), rc.failures))
        rpc._cache.clear()
        assert client.get(meta.blob_id) == data
        return out

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_mds_fallback_matches_reference():
    """Two losses in one chunkset: the optimal pattern is impossible, so the
    chunk is rebuilt by an MDS decode of k verified helpers."""
    def scenario(pkg):
        layout, contract, sps, rpc, client, meta, data = _world(pkg)
        sps[meta.placement[(0, 0)]].wipe()
        sps[meta.placement[(0, 1)]].crash()
        rc = _coordinator(pkg, contract, sps, layout)
        rep = rc.repair_chunk(meta.blob_id, 0, 0)
        assert rep.mode == "mds" and rep.verified
        expect = layout.k * layout.chunk_bytes
        assert rep.helper_bytes_read == expect
        rpc._cache.clear()
        assert client.get(meta.blob_id) == data
        return report_view(rep), world_view(contract, sps)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_corrupt_helper_is_rejected_as_in_the_reference():
    """An at-rest-corrupted helper fails its commitment: MSR's candidate
    fails verification, and the MDS fallback skips the helper and reads the
    next one."""
    def scenario(pkg):
        layout, contract, sps, rpc, client, meta, data = _world(pkg)
        del sps[meta.placement[(0, 0)]]._chunks[(meta.blob_id, 0, 0)]
        _flip(sps[meta.placement[(0, 1)]], (meta.blob_id, 0, 1))
        rc = _coordinator(pkg, contract, sps, layout)
        rep = rc.repair_chunk(meta.blob_id, 0, 0)
        assert rep.mode == "mds" and rep.verified and rep.helpers_rejected == 1
        rpc._cache.clear()
        assert client.get(meta.blob_id) == data
        return report_view(rep), world_view(contract, sps)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_serve_time_corrupt_helper_is_rejected_as_in_the_reference():
    """MDS fallback (a crashed SP rules out MSR) with a corrupt=True helper
    among the first k candidates, at a (2,3) layout."""
    def scenario(pkg):
        layout, contract, sps, rpc, client, meta, data = _world(
            pkg, k=2, m=3, chunkset=32 * 1024, blob_bytes=90_000)
        del sps[meta.placement[(0, 0)]]._chunks[(meta.blob_id, 0, 0)]
        sps[meta.placement[(0, 1)]].crash()
        sps[meta.placement[(0, 2)]].behavior.corrupt = True
        rc = _coordinator(pkg, contract, sps, layout)
        rep = rc.repair_chunk(meta.blob_id, 0, 0)
        assert rep.mode == "mds" and rep.verified and rep.helpers_rejected == 1
        return report_view(rep), world_view(contract, sps)

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_unrecoverable_chunk_raises(pkg):
    layout, contract, sps, rpc, client, meta, data = _world(pkg)
    for ck in range(3):  # m + 1 chunks of chunkset 0 gone
        sps[meta.placement[(0, ck)]].crash()
    rc = _coordinator(pkg, contract, sps, layout)
    with pytest.raises(_mod(pkg, "storage.repair").RepairError, match="unrecoverable"):
        rc.repair_chunk(meta.blob_id, 0, 3)


def test_repair_all_records_per_chunk_failures_as_in_the_reference():
    def scenario(pkg):
        layout, contract, sps, rpc, client, meta, data = _world(pkg)
        # chunkset 0: target lost and 3 of its 5 helpers corrupt -> unrecoverable
        del sps[meta.placement[(0, 0)]]._chunks[(meta.blob_id, 0, 0)]
        for ck in (1, 2, 3):
            _flip(sps[meta.placement[(0, ck)]], (meta.blob_id, 0, ck))
        # chunkset 1: a plain loss, repairable at MSR bandwidth
        del sps[meta.placement[(1, 2)]]._chunks[(meta.blob_id, 1, 2)]
        rc = _coordinator(pkg, contract, sps, layout)
        reports = rc.repair_all()
        assert [(r.blob_id, r.chunkset, r.chunk) for r in reports] == [(meta.blob_id, 1, 2)]
        assert len(rc.failures) == 1 and rc.failures[0][0] == (meta.blob_id, 0, 0)
        assert "unrecoverable" in rc.failures[0][1]
        return [report_view(r) for r in reports], rc.failures, rc.failures_total

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_spot_check_finds_a_bit_flip_as_in_the_reference():
    def scenario(pkg):
        layout, contract, sps, rpc, client, meta, data = _world(pkg)
        key = (meta.blob_id, 0, 2)
        _flip(sps[meta.placement[(0, 2)]], key)
        rc = _coordinator(pkg, contract, sps, layout)
        assert rc.scan_lost_chunks() == []  # liveness alone misses it
        lost = rc.scan_lost_chunks(spot_check_rate=1.0)
        assert lost == [key] and rc.spot_checks > 0
        assert rc.repair_all() == []
        rep = rc.repair_chunk(*key)
        assert rep.verified
        assert rc.scan_lost_chunks(spot_check_rate=1.0) == []
        rpc._cache.clear()
        assert client.get(meta.blob_id) == data
        # a sampled scan draws from the coordinator's seeded stream
        sampled = _coordinator(pkg, contract, sps, layout, spot_check_rate=0.5, seed=3)
        sampled.scan_lost_chunks()
        return (report_view(rep), rc.spot_checks, rc.spot_check_bytes,
                sampled.spot_checks, sampled.spot_check_bytes, world_view(contract, sps))

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]


def test_risk_order_matches_reference():
    def scenario(pkg):
        layout, contract, sps, rpc, client, meta, data = _world(pkg)
        b0 = meta.blob_id
        sps[meta.placement[(0, 0)]]._chunks.pop((b0, 0, 0))
        for ck in range(3):
            sps[meta.placement[(1, ck)]]._chunks.pop((b0, 1, ck))
        rc = _coordinator(pkg, contract, sps, layout)
        items = [(b0, 0, 0), (b0, 1, 0), (b0, 1, 1), (b0, 1, 2)]
        ordered = rc.risk_order(list(reversed(items)))
        assert ordered == [(b0, 1, 0), (b0, 1, 1), (b0, 1, 2), (b0, 0, 0)]
        return ordered, [rc.live_holders(b0, cs) for cs in range(meta.num_chunksets)]

    got = _both(scenario)
    assert got["repro_torch"] == got["repro"]
