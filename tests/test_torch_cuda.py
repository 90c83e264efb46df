"""The port's CUDA kernels and their callers on the card.

These need an NVIDIA GPU and skip without one (the kernels have no CPU mode).
On a GPU machine, which need not have jax:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version on the same inputs:
``gf_matmul`` (and the device Clay path against the CPU plain path) and
``sample_hash`` with exact equality (their arithmetic is exact);
``flash_attention`` in f32 to summation order (atol = rtol = 1e-4 on O(1)
outputs), in bf16 to one rounding step of the output (2^-7 relative and
absolute): both round an f32 result to bf16, and the tensor-core kernels
also round P to bf16 before the P V product (2^-9 relative per term).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.clay import ClayCode
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gf_matmul as gk
from repro_torch.kernels import ops
from repro_torch.kernels import sample_hash as sh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [
    (6, 12, 216 * 4856), (6, 12, 3 * 216 * 4856 + 17), (6, 12, 6 * 4856), (4, 4, 4096),
    (1, 4, 4095), (1, 1, 1), (32, 32, 10_001), (1, 17, 4856), (6, 12, 3),
    # every access width: N = 0, 8, 4 (mod 16) and odd; N < 16
    (6, 12, 5 * 4856), (6, 12, 4100), (6, 12, 4097), (2, 4, 15), (3, 5, 8), (5, 13, 12),
    # the serving path's Clay (4,2): M 2, K 4, plane groups of w = 8192
    (2, 4, 8 * 8192), (2, 4, 8 * 8192 * 3), (2, 4, 4 * 8192 + 4),
    # row tiles past 8 and K past one group
    (9, 31, 4104), (17, 5, 1000),
])
def test_kernel_matches_plain_version(cuda, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(m * 1000 + k)
    a = torch.randint(0, 256, (m, k), dtype=torch.uint8, device=cuda, generator=gen)
    a[m // 2] = 0
    b = torch.randint(0, 256, (k, n), dtype=torch.uint8, device=cuda, generator=gen)
    launches = gk.gf_matmul.launches
    out = ops.gf_matmul(a, b)
    torch.cuda.synchronize()
    assert gk.gf_matmul.launches == launches + 1
    assert torch.equal(out, gk.gf_matmul_ref(a, b))


@pytest.mark.parametrize("n", [4096, 3 * 4856, 4100, 4097])
@pytest.mark.parametrize("offset", [1, 4, 8])
def test_kernel_takes_misaligned_views(cuda, offset, n):
    """B a contiguous view whose data starts 1, 4 or 8 bytes into its
    storage: the kernel drops to the widest access the pointer allows."""
    gen = torch.Generator(device=cuda).manual_seed(offset * 7 + n)
    a = torch.randint(0, 256, (6, 12), dtype=torch.uint8, device=cuda, generator=gen)
    flat = torch.randint(0, 256, (offset + 12 * n,), dtype=torch.uint8, device=cuda,
                         generator=gen)
    b = flat[offset:].view(12, n)
    assert b.is_contiguous() and b.storage_offset() == offset
    launches = gk.gf_matmul.launches
    out = ops.gf_matmul(a, b)
    torch.cuda.synchronize()
    assert gk.gf_matmul.launches == launches + 1
    assert torch.equal(out, gk.gf_matmul_ref(a, b))


def test_odd_plane_groups_go_through_the_kernel(cuda, monkeypatch):
    """A Clay (10,6) decode of one chunkset at the production w = 4856
    (8 mod 16) whose plane groups are odd (erasures 0, 7 and 13: groups of
    125, 75, 15 and 1 planes): every solve has N = 8 (mod 16), the kernel's
    8-byte path, and the decode gives back the codeword."""
    code = ClayCode(10, 6, device=cuda)
    data = np.random.default_rng(13).integers(0, 256, (1, 10, code.alpha, 4856), dtype=np.uint8)
    coded = code.encode_batch(data)[0]
    widths = []
    real = gk.gf_matmul

    def spy(a, b):
        widths.append(b.shape[1])
        return real(a, b)

    spy.launches = 0  # the wrapper counts on the name it is bound to: here, the spy
    monkeypatch.setattr(gk, "gf_matmul", spy)
    shards = {i: coded[i].cpu().numpy() for i in range(code.n) if i not in (0, 7, 13)}
    got = code.decode_batch([shards])[0]
    torch.cuda.synchronize()
    assert widths and all(n % 16 == 8 for n in widths)
    assert spy.launches == len(widths)
    assert torch.equal(got, coded)


def test_kernel_raises_instead_of_falling_back(cuda):
    a = torch.zeros((33, 4), dtype=torch.uint8, device=cuda)
    b = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)
    launches = gk.gf_matmul.launches
    with pytest.raises(ValueError):
        ops.gf_matmul(a, b)
    assert gk.gf_matmul.launches == launches


@pytest.mark.parametrize("k,m", [(4, 2), (10, 6)])
def test_clay_on_the_card_matches_the_cpu_path(cuda, k, m):
    dev, cpu = ClayCode(k, m, device=cuda), ClayCode(k, m, device="cpu")
    rng = np.random.default_rng(k + m)
    batch = rng.integers(0, 256, (3, k, dev.alpha, 12), dtype=np.uint8)
    coded = dev.encode_batch(batch).cpu()
    assert torch.equal(coded, cpu.encode_batch(batch))
    sets = []
    for b in range(3):
        erased = set(rng.choice(k + m, m - b % 2, replace=False).tolist())
        sets.append({i: coded[b, i].numpy() for i in range(k + m) if i not in erased})
    for got, want in zip(dev.decode_batch(sets), cpu.decode_batch(sets)):
        assert torch.equal(got.cpu(), want)


def _repair_case(k, m, w, seed):
    cpu = ClayCode(k, m, device="cpu")
    rng = np.random.default_rng(seed)
    codeword = cpu.encode(rng.integers(0, 256, (k, cpu.alpha, w), dtype=np.uint8)).numpy()
    return cpu, codeword


# (k, m, w) -> the repair product's N = alpha/q * w: (10,6) at the production
# w = 4856 (N = 36w, 16-byte path); (4,2) with N = 4w = 0, 8, 4 (mod 16);
# (6,3) with N = 9w odd, the byte path (4w is never odd)
REPAIR_WIDTHS = [(10, 6, 4856), (4, 2, 8192), (4, 2, 4858), (4, 2, 4857), (6, 3, 4857)]


@pytest.mark.parametrize("k,m,w", REPAIR_WIDTHS)
def test_repair_on_the_card_matches_the_cpu_path(cuda, k, m, w):
    """``ClayCode.repair`` on the card: one ``gf_matmul`` launch per repair,
    the chunk equal to the CPU plain path's and to the codeword's."""
    cpu, codeword = _repair_case(k, m, w, seed=k * 7 + w)
    dev = ClayCode(k, m, device=cuda)
    for failed in range(k + m):
        ids = dev.repair_subchunk_ids(failed)
        helpers = {i: codeword[i][ids] for i in range(k + m) if i != failed}
        launches = gk.gf_matmul.launches
        got = dev.repair(failed, helpers)
        torch.cuda.synchronize()
        assert gk.gf_matmul.launches == launches + 1
        assert got.device.type == "cuda" and got.shape == (dev.alpha, w)
        assert torch.equal(got.cpu(), cpu.repair(failed, helpers))
        assert np.array_equal(got.cpu().numpy(), codeword[failed])
    # helpers already on the card are taken as they are
    on_card = {i: torch.as_tensor(codeword[i][ids], device=cuda) for i in helpers}
    assert torch.equal(dev.repair(k + m - 1, on_card).cpu(), torch.as_tensor(codeword[-1]))


def test_repair_coordinator_on_the_card(cuda):
    """Wipe an SP of the serving cluster and repair it: every MSR repair
    is one kernel launch, every report verified, the blob reads back."""
    from repro_torch.launch.cluster import build_cluster
    from repro_torch.storage.repair import RepairCoordinator

    contract, sps, rpc, client = build_cluster(device=cuda)
    data = np.random.default_rng(5).bytes(1_500_000)
    meta = client.put(data)
    sps[meta.placement[(0, 0)]].wipe()
    sps[meta.placement[(1, 2)]].crash()
    rc = RepairCoordinator(contract, sps, rpc.layout)
    launches = gk.gf_matmul.launches
    reports = rc.repair_all()
    torch.cuda.synchronize()
    assert reports and not rc.failures and all(r.verified for r in reports)
    msr = [r for r in reports if r.mode == "msr"]
    mds = len(reports) - len(msr)
    assert msr and all(r.helper_bytes_read ==
                       rpc.layout.code.repair_bandwidth_bytes(rpc.layout.chunk_bytes) for r in msr)
    if not mds:
        assert gk.gf_matmul.launches == launches + len(msr)
    rpc._cache.clear()
    assert client.get(meta.blob_id) == data


def test_put_and_read_go_through_the_kernel(cuda):
    from repro_torch.launch.cluster import build_cluster

    contract, sps, rpc, client = build_cluster(device=cuda)
    data = np.random.default_rng(3).bytes(900_000)
    launches = gk.gf_matmul.launches
    meta = client.put(data)
    torch.cuda.synchronize()
    assert gk.gf_matmul.launches > launches
    launches = gk.gf_matmul.launches
    assert client.get(meta.blob_id) == data
    assert gk.gf_matmul.launches > launches
    assert rpc._cache  # decoded chunksets stay on the card
    assert all(t.device.type == "cuda" for t, _expires, _version in rpc._cache.values())


def _fast_world(device, **node_kw):
    """Two RPC nodes on a 3-DC backbone, 8 SPs, 12 single-chunkset blobs of
    a Clay (4,2) 64 KiB layout on ``device``; caches cold after the puts."""
    from repro_torch.core.contract import ShelbyContract
    from repro_torch.core.placement import SPInfo
    from repro_torch.net.backbone import Backbone
    from repro_torch.net.fleet import CacheAffinityPolicy, RPCFleet
    from repro_torch.storage.blob import BlobLayout
    from repro_torch.storage.rpc import BackboneTransport, RPCNode
    from repro_torch.storage.sdk import ShelbyClient
    from repro_torch.storage.sp import ServiceSpec, StorageProvider

    layout = BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024, device=device)
    contract = ShelbyContract()
    bb = Backbone.mesh(3, base_latency_ms=4.0, gbps=10.0)
    sps = {}
    for i in range(8):
        contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 3}", rack=f"r{i % 4}"))
        sps[i] = StorageProvider(i, service=ServiceSpec(disk_ms_per_chunk=0.5, slots=4))
        bb.register_node(f"sp{i}", f"dc{i % 3}")
    rpcs = []
    for r in range(2):
        bb.register_node(f"rpc{r}", f"dc{r}")
        rpcs.append(RPCNode(f"rpc{r}", contract, sps, layout, cache_chunksets=64,
                            transport=BackboneTransport(sps, bb, f"rpc{r}"), **node_kw))
    bb.register_node("client", "dc0")
    client = ShelbyClient(contract, RPCFleet(rpcs, CacheAffinityPolicy(), backbone=bb),
                          deposit=1e9)
    rng = np.random.default_rng(7)
    metas = [client.put(rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes())
             for _ in range(12)]
    for node in rpcs:
        node._cache.clear()
    return client, metas


def test_fast_path_deopt_decodes_on_the_card_match_the_cpu(cuda):
    """A cohort fast-path replay whose de-opted cold-key reads decode through
    ``gf_matmul`` on the card: digest, cohort and settlement of the CPU's."""
    from repro_torch.net.workloads import zipf_hotset_batch

    got = []
    for device in (cuda, "cpu"):
        client, metas = _fast_world(device)
        batch = zipf_hotset_batch(metas, clients=["client"], num_requests=1500,
                                  read_bytes=64 * 1024, interarrival_ms=0.2, seed=3,
                                  arrival="poisson")
        launches = gk.gf_matmul.launches
        with client.session(deposit_per_node=1e6) as session:
            rb, fast = session.replay(batch)
        co = fast.cohort
        assert co.fallback_reason is None and co.deopt_requests > 0
        if device == cuda:
            torch.cuda.synchronize()
            assert gk.gf_matmul.launches >= launches + co.deopt_requests
            assert all(t.device.type == cuda.type for node in client.fleet.rpcs
                       for t, _expires, _version in node._cache.values())
        got.append((fast.digest(), co.vec_requests, co.deopt_requests, co.coalesced,
                    rb.paid_by_node, session.settlement.node_income))
    assert got[0] == got[1]


def test_batch_decode_read_on_the_card_matches_the_plain_path(cuda):
    """Several chunksets of one node's read: one stacked decode
    (``batch_decode``) against one decode per chunkset, and the CPU."""
    from repro_torch.launch.cluster import build_cluster

    data = np.random.default_rng(5).bytes(5 * 256 * 1024 + 999)  # 6 chunksets
    out = {}
    for device in (cuda, "cpu"):
        contract, sps, rpc, client = build_cluster(device=device)
        meta = client.put(data)
        sps[meta.placement[(0, 0)]].crash()  # two erasure patterns in the batch
        for batch in (True, False):
            rpc.batch_decode = batch
            rpc._cache.clear()
            launches = gk.gf_matmul.launches
            out[(str(device), batch)] = rpc.read_blob(meta.blob_id)
            if device == cuda:
                torch.cuda.synchronize()
                out[("launches", batch)] = gk.gf_matmul.launches - launches
    assert len(set(v for key, v in out.items() if key[0] != "launches")) == 1
    assert out[(str(cuda), True)] == data
    # stacked: one launch per plane group and erasure pattern, not per chunkset
    assert 0 < out[("launches", True)] < out[("launches", False)]


def test_read_range_across_a_chunkset_boundary_on_the_card(cuda):
    from repro_torch.launch.cluster import build_cluster

    contract, sps, rpc, client = build_cluster(device=cuda)
    data = np.random.default_rng(6).bytes(int(2.5 * rpc.layout.chunkset_bytes))
    meta = client.put(data)
    cs = rpc.layout.chunkset_bytes
    for off, ln in [(cs - 1, 2), (cs - 100, 200), (2 * cs - 1, 2), (0, 2 * cs),
                    (len(data) - 50, 10_000)]:
        rpc._cache.clear()
        launches = gk.gf_matmul.launches
        got, ms = rpc.read_range_timed(meta.blob_id, off, ln)
        torch.cuda.synchronize()
        assert got == data[off: off + ln] and gk.gf_matmul.launches > launches
    assert rpc.read_blob(meta.blob_id) == data


def test_extend_batch_on_the_card_matches_the_cpu(cuda):
    """4,096 squares of 512-byte shares: two launches, the CPU's bytes."""
    from repro_torch.core.extend2d import Extend2D

    lay = Extend2D(4)
    squares = list(np.random.default_rng(9).integers(0, 256, (4096, 4, 4, 512), dtype=np.uint8))
    launches = gk.gf_matmul.launches
    got = lay.extend_batch(squares, device=cuda)
    torch.cuda.synchronize()
    assert gk.gf_matmul.launches == launches + 2
    assert got.device.type == "cuda" and tuple(got.shape) == (4096, 8, 8, 512)
    assert torch.equal(got.cpu(), lay.extend_batch(squares, device="cpu"))


def test_reconstruct_on_the_card_equals_the_extended_square(cuda):
    from repro_torch.core.extend2d import Extend2D

    lay = Extend2D(4)
    square = np.random.default_rng(4).integers(0, 256, (4, 4, 512), dtype=np.uint8)
    ext = lay.extend(square, device=cuda)
    for lines in ((0, 1, 2, 3), (4, 5, 6, 7), (1, 3, 5, 7)):
        launches = gk.gf_matmul.launches
        by_rows = lay.reconstruct_from_rows({r: ext[r] for r in lines}, device=cuda)
        by_cols = lay.reconstruct_from_cols({c: ext[:, c] for c in lines}, device=cuda)
        torch.cuda.synchronize()
        assert gk.gf_matmul.launches == launches + 2  # one product per axis
        assert torch.equal(by_rows, ext) and torch.equal(by_cols, ext)


def test_put_on_the_card_registers_the_cpu_das_record(cuda):
    import dataclasses

    from repro_torch.launch.cluster import build_cluster

    data = np.random.default_rng(8).bytes(300_000)
    records = []
    for device in (cuda, "cpu"):
        contract, sps, rpc, client = build_cluster(device=device)
        launches = gk.gf_matmul.launches
        meta = client.put(data)
        if device == cuda:
            torch.cuda.synchronize()
            assert gk.gf_matmul.launches >= launches + 2
        records.append(dataclasses.astuple(contract.das[meta.blob_id]))
    assert records[0] == records[1]


@pytest.mark.parametrize("leaves,words,seed", [
    (1, 4, 0), (7, 256, 0), (1000, 16, 1), (257, 64, 2**32 + 9), (5, 3, 0), (1_000_003, 256, 1),
])
def test_sample_hash_matches_plain_version(cuda, leaves, words, seed):
    gen = torch.Generator(device=cuda).manual_seed(leaves + words)
    w = torch.randint(-2**31, 2**31, (leaves, words), dtype=torch.int32, device=cuda,
                      generator=gen).view(torch.uint32)
    launches = sh.sample_hash.launches
    out = ops.sample_hash(w, seed=seed)
    torch.cuda.synchronize()
    assert sh.sample_hash.launches == launches + 1
    assert torch.equal(out.view(torch.int32), sh.sample_hash_ref(w, seed=seed).view(torch.int32))


def test_bulk_sample_digests_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.core.commitments import bulk_sample_digests

    samples = np.random.default_rng(4).integers(0, 256, (1025, 1024), dtype=np.uint8)
    np.testing.assert_array_equal(bulk_sample_digests(samples), bulk_sample_digests(samples,
                                                                                    device="cpu"))


ATTN_CASES = [  # b, sq, sk, h, hkv, hd, causal, window, q_offset
    (1, 64, 64, 2, 2, 16, True, 0, 0), (2, 128, 128, 4, 2, 32, True, 0, 0),
    (1, 96, 96, 3, 1, 8, False, 0, 0), (2, 64, 64, 8, 8, 64, True, 0, 0),
    (1, 300, 300, 32, 4, 128, True, 0, 0), (16, 1, 4096, 32, 4, 128, True, 0, 2047),
    (4, 1, 25, 32, 4, 128, True, 0, 11), (2, 23, 41, 4, 4, 16, False, 0, 0),
    (1, 9, 50, 6, 3, 256, True, 12, 41), (3, 70, 130, 8, 2, 96, True, 33, 60),
    # head dims 64 / 96 / 128 / 256 at Sq 1, 17, 64, 300 and 2048, both variants
    (2, 1, 300, 8, 2, 64, True, 0, 299), (1, 17, 200, 8, 2, 64, True, 0, 100),
    (2, 64, 512, 16, 2, 64, True, 0, 448), (1, 64, 64, 4, 4, 96, True, 0, 0),
    (3, 17, 130, 8, 8, 96, False, 0, 0), (2, 1, 77, 12, 4, 96, True, 16, 70),
    (1, 2048, 2048, 8, 1, 128, True, 0, 0), (1, 17, 1000, 32, 4, 128, True, 0, 983),
    (1, 17, 77, 4, 2, 256, True, 20, 60), (1, 300, 333, 4, 4, 256, False, 0, 0),
    (2, 1, 2048, 16, 2, 256, True, 0, 2047), (1, 64, 200, 2, 2, 256, True, 0, 136),
    # decode split over keys with whole splits hidden (slots past pos 1000)
    (16, 1, 4096, 32, 4, 128, True, 0, 1000),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(cuda, case, dtype):
    b, sq, sk, h, hkv, hd, causal, window, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, sk, hkv, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, sk, hkv, hd), generator=gen, device=cuda).to(dtype)
    qpos = torch.arange(q_offset, q_offset + sq, device=cuda)
    kpos = torch.randperm(sk, generator=gen, device=cuda) if window else torch.arange(sk,
                                                                                      device=cuda)
    kw = dict(q_positions=qpos, k_positions=kpos, causal=causal, window=window)
    variant = fa.choose_variant(dtype, sq, h, hkv, hd)
    launches, by_variant = fa.flash_attention.launches, dict(fa.flash_attention.variant_launches)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 1
    by_variant[variant] += 1
    assert fa.flash_attention.variant_launches == by_variant
    ref = fa.flash_attention_ref(q, k, v, **kw)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=2**-7, rtol=2**-7)
    torch.testing.assert_close(out, ref, **tol)


@pytest.mark.parametrize("case,variant", [
    ((1, 2048, 2048, 32, 4, 128, True), "tile"), ((16, 1, 4096, 32, 4, 128, True), "split"),
    ((4, 1, 25, 32, 4, 128, True), "split"), ((2, 1000, 1537, 8, 8, 128, False), "tile"),
    ((1, 7, 64, 8, 1, 128, True), "split"), ((1, 8, 64, 8, 1, 128, True), "tile"),
    ((1, 7, 64, 8, 1, 64, True), "split"),
])
def test_dispatch_rule_on_the_card(cuda, case, variant):
    """Each variant's counter moves where the rule sends the case."""
    b, sq, sk, h, hkv, hd, causal = case
    if sq * (h // hkv) < fa.TILE_ROWS:
        assert variant == "split"
    q = torch.randn((b, sq, h, hd), device=cuda).bfloat16()
    k = torch.randn((b, sk, hkv, hd), device=cuda).bfloat16()
    before = dict(fa.flash_attention.variant_launches)
    ops.flash_attention(q, k, k, q_positions=torch.arange(sk - sq, sk, device=cuda),
                        causal=causal)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.flash_attention.variant_launches.items()} == {
        n: int(n == variant) for n in fa.VARIANTS}


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128), (torch.float32, 64),
                                      (torch.bfloat16, 8), (torch.bfloat16, 24)])
def test_f32_and_odd_head_dims_keep_the_general_kernel(cuda, dtype, hd):
    for sq, sk in [(1, 300), (300, 300)]:
        q = torch.randn((2, sq, 8, hd), device=cuda).to(dtype)
        k = torch.randn((2, sk, 2, hd), device=cuda).to(dtype)
        before = dict(fa.flash_attention.variant_launches)
        out = ops.flash_attention(q, k, k, q_positions=torch.arange(sk - sq, sk, device=cuda))
        torch.cuda.synchronize()
        assert fa.flash_attention.variant_launches["general"] == before["general"] + 1
        assert fa.flash_attention.variant_launches["tile"] == before["tile"]
        assert fa.flash_attention.variant_launches["split"] == before["split"]
        tol = 1e-4 if dtype == torch.float32 else 2**-7
        ref = fa.flash_attention_ref(q, k, k, q_positions=torch.arange(sk - sq, sk, device=cuda))
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,qpos", [
    (1, 128, 256, 8, 1, 64, list(range(-64, 64))),  # tile: half the rows see no key
    (2, 1, 25, 8, 1, 128, [-1]),                    # split, one split
    (2, 1, 700, 8, 1, 128, [-5]),                   # split, every split hidden
    (1, 3, 700, 8, 2, 128, [-5, 3, 650]),           # split: some rows see keys
])
def test_row_that_sees_no_key_averages_v_on_the_card(cuda, b, sq, sk, h, hkv, hd, qpos):
    """Tile skipping keeps the JAX semantics: a row that sees no key averages V."""
    gen = torch.Generator(device=cuda).manual_seed(sk)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, sk, hkv, hd), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, sk, hkv, hd), generator=gen, device=cuda).bfloat16()
    qp = torch.tensor(qpos, dtype=torch.int32, device=cuda)
    out = ops.flash_attention(q, k, v, q_positions=qp)
    ref = fa.flash_attention_ref(q, k, v, q_positions=qp)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=2**-7, rtol=2**-7)
    blind = qp < 0
    mean = v.float().mean(1).repeat_interleave(h // hkv, dim=1)  # (b, h, hd)
    torch.testing.assert_close(out[:, blind].float(),
                               mean[:, None].expand(b, int(blind.sum()), h, hd),
                               atol=2**-7, rtol=2**-7)


def test_split_decode_is_the_same_from_run_to_run(cuda):
    q = torch.randn((16, 1, 32, 128), device=cuda).bfloat16()
    k = torch.randn((16, 4096, 4, 128), device=cuda).bfloat16()
    v = torch.randn((16, 4096, 4, 128), device=cuda).bfloat16()
    qp = torch.tensor([3000], dtype=torch.int32, device=cuda)
    assert fa.split_plan(4096, 16, 4, 8, torch.cuda.get_device_properties(0)
                         .multi_processor_count)[0] > 1
    first = ops.flash_attention(q, k, v, q_positions=qp)
    for _ in range(3):
        assert torch.equal(ops.flash_attention(q, k, v, q_positions=qp), first)


def test_kernels_raise_instead_of_falling_back(cuda):
    launches = (sh.sample_hash.launches, fa.flash_attention.launches)
    with pytest.raises(TypeError):
        ops.sample_hash(torch.zeros((2, 4), dtype=torch.int32, device=cuda))
    big = torch.zeros((1, 4, 2, 288), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros((1, 4, 8, 2), device=cuda).transpose(2, 3)
        ops.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="tile"):
        x = torch.zeros((1, 64, 2, 128), device=cuda)  # f32: not for the tensor-core kernels
        fa.flash_attention_variant("tile", x, x, x)
    assert (sh.sample_hash.launches, fa.flash_attention.launches) == launches


def test_decode_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build
    from repro_torch.sharding import init_params

    cfg = get_smoke("starcoder2-3b")
    model = build(cfg)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(3), device="cpu")
    on_card = {k: t.to(cuda) for k, t in params.items()}
    caches = [{k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
               for k, s in model.cache_specs(2, 9).items()} for dev in ("cpu", cuda)]
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(4))
    launches, split = fa.flash_attention.launches, fa.flash_attention.variant_launches["split"]
    for pos in range(8):
        want, caches[0] = model.decode_step(params, caches[0], toks[:, pos:pos + 1], pos)
        got, caches[1] = model.decode_step(on_card, caches[1], toks[:, pos:pos + 1].to(cuda), pos)
        # bf16 compute on both: rounding differs between CPU and card kernels
        torch.testing.assert_close(got.float().cpu(), want.float(), atol=0.15, rtol=0)
    assert fa.flash_attention.launches == launches + 8 * cfg.num_layers
    if cfg.head_dim_ % 16 == 0:  # bf16 decode: the split kernel on every layer of every step
        assert fa.flash_attention.variant_launches["split"] == split + 8 * cfg.num_layers


def test_serve_goes_through_both_kernels(cuda):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import serve

    launches = (gk.gf_matmul.launches, fa.flash_attention.launches)
    run = serve(get_smoke("yi-9b"), kill_sp=True, device=cuda)
    assert gk.gf_matmul.launches > launches[0]
    assert fa.flash_attention.launches == launches[1] + 23 * get_smoke("yi-9b").num_layers
    assert all(torch.equal(run.served[k], run.published[k]) for k in run.published)


def test_tune_admission_on_the_card_equals_the_cpu(cuda):
    """A registered regime run on the card gives the CPU plain path's
    payload, digest and SLO values, and its reads decode through the kernel."""
    from repro_torch.scenarios import run_scenario

    launches = gk.gf_matmul.launches
    card = run_scenario("tune_admission", smoke=True, emit=False, device=cuda)
    assert gk.gf_matmul.launches > launches
    cpu = run_scenario("tune_admission", smoke=True, emit=False, device="cpu")
    assert card.digest == cpu.digest == "42db0c083314839d"  # the JAX package's smoke digest
    assert [r.value for r in card.slo_results] == [r.value for r in cpu.slo_results]
    assert card.slos_ok


def test_sanitized_loop_on_the_card_keeps_the_digest(cuda, monkeypatch):
    """simsan observes and never moves an event: a sanitized replay whose
    reads decode on the card has the unsanitized digest."""
    from repro_torch.analysis.simsan import Sanitizer
    from repro_torch.net.events import EventLoop
    from repro_torch.scenarios import run_scenario

    digests = []
    for armed in (False, True):
        if armed:
            monkeypatch.setenv("SHELBY_SIMSAN", "1")
        else:
            monkeypatch.delenv("SHELBY_SIMSAN", raising=False)
        assert isinstance(EventLoop()._san, Sanitizer) == armed
        digests.append(run_scenario("churn", smoke=True, emit=False, device=cuda).digest)
    assert digests[0] == digests[1] == "4b71c434b103b010"  # the JAX package's smoke digest
