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
``flash_attention_bwd`` (bf16 only) within 2^-6 of each gradient's largest
entry: the kernel rounds P and dS to bf16 as tensor-core operands (2^-9
relative per term) and each gradient to bf16 once (observed <= 0.78%).
A training step on the card against the CPU plain path, bf16 on both
(rounded at different places): loss within 0.02; the gradients (one vector
of every parameter) within three times bf16's own error on the CPU (bf16
against f32 compute there) plus 1% of their norm.  At the initial weights
the attention scores are one-hot to bf16 precision (ROADMAP Queue 3 item
5), so the q/k gradients are rounding noise in any bf16 computation.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.clay import ClayCode
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
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
    # hymba (a GQA group of 5: a "tile" block's 64 rows cross query boundaries) and qwen3
    (2, 512, 512, 25, 5, 64, True, 0, 0), (4, 1, 25, 25, 5, 64, True, 0, 22),
    (1, 512, 512, 32, 4, 128, True, 0, 0),
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


# -- attention's backward kernel and training -------------------------------------------
BWD_REL = 2**-6  # of each gradient's largest entry (see the module docstring)

# (b, sq, sk, h, hkv, hd, causal, window, q_offset): causal GQA, window, Sq != Sk with a
# ragged last tile, g = 1, rows that see no key (q_offset < 0), hd 16 / 64 / 96 / 128 / 256;
# a window that crosses key tiles, Sk not a multiple of 128, phase 15's S and heads at B 1
BWD_CASES = [
    (2, 37, 37, 8, 2, 16, True, 0, 0), (1, 50, 50, 4, 2, 16, True, 7, 0),
    (2, 19, 45, 4, 4, 16, False, 0, 0), (1, 33, 33, 3, 3, 32, True, 0, 0),
    (2, 16, 46, 6, 2, 16, True, 0, 30), (1, 16, 24, 4, 2, 16, True, 0, -5),
    (2, 21, 70, 12, 4, 16, True, 9, 49), (2, 300, 300, 24, 2, 128, True, 0, 0),
    (1, 130, 200, 4, 2, 256, False, 0, 0), (2, 100, 333, 8, 2, 64, True, 0, 233),
    (1, 1000, 1000, 24, 2, 128, True, 0, 0),
    (2, 200, 260, 8, 2, 96, True, 0, 60), (2, 190, 190, 6, 3, 64, True, 0, 0),
    (1, 520, 520, 8, 2, 128, True, 150, 0), (2, 150, 333, 6, 2, 128, False, 0, 0),
    (1, 300, 450, 4, 2, 80, True, 0, -100),
    (1, 4096, 4096, 24, 2, 128, True, 0, 0),
    # hymba's training shape at S 512 (a GQA group of 5, hd 64) and qwen3's (hd 128)
    (2, 512, 512, 25, 5, 64, True, 0, 0), (1, 512, 512, 32, 4, 128, True, 0, 0),
]


def _bwd_inputs(case, device):
    b, sq, sk, h, hkv, hd, causal, window, q_offset = case
    gen = torch.Generator(device=device).manual_seed(sum(map(abs, case)))
    q = torch.randn((b, sq, h, hd), generator=gen, device=device).bfloat16()
    k = torch.randn((b, sk, hkv, hd), generator=gen, device=device).bfloat16()
    v = torch.randn((b, sk, hkv, hd), generator=gen, device=device).bfloat16()
    do = torch.randn((b, sq, h, hd), generator=gen, device=device).bfloat16()
    kw = dict(q_positions=torch.arange(q_offset, q_offset + sq, device=device),
              causal=causal, window=window)
    return q, k, v, do, kw


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_backward_kernel_matches_plain_version(cuda, case):
    q, k, v, do, kw = _bwd_inputs(case, cuda)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    b, sq, h, hd = q.shape  # the lse call takes the kernel the dispatch rule names
    assert torch.equal(o, fa.flash_attention_variant(
        fa.choose_variant(q.dtype, sq, h, k.shape[2], hd), q, k, v, **kw))
    o_ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-5)
    launches = fab.flash_attention_bwd.launches
    got = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert fab.flash_attention_bwd.launches == launches + 1
    want = fab.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_REL * float(w.float().abs().max()), (name, err)


def test_attention_backward_is_deterministic(cuda):
    """No atomics: two calls give the same bits (dQ written once by its owner)."""
    q, k, v, do, kw = _bwd_inputs((2, 520, 520, 24, 2, 128, True, 0, 0), cuda)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    first = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    second = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("hd,design", [(16, "wgmma"), (64, "wgmma"), (96, "wgmma"),
                                       (128, "wgmma"), (192, "mma"), (256, "mma")])
def test_attention_backward_design_by_head_dim(cuda, hd, design):
    """The launcher's rule at hd_v = hd: the wgmma kernels up to 128 (hd_v's
    limit), the mma ones above."""
    q, k, v, do, kw = _bwd_inputs((1, 70, 70, 4, 2, hd, True, 0, 0), cuda)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    before = dict(fab.flash_attention_bwd.design_launches)
    fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    after = fab.flash_attention_bwd.design_launches
    assert {d: after[d] - before[d] for d in after} == {d: int(d == design) for d in after}
    assert fab.design(hd) == design == fab.kernel_config(hd)["design"]


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,hd_v,q_offset,variant", [
    (1, 1024, 1024, 16, 16, 192, 128, 0, "tile"), (1, 256, 512, 8, 2, 192, 128, -128, "tile"),
    (2, 200, 200, 4, 4, 32, 16, 0, "tile"), (1, 300, 300, 8, 2, 128, 64, 0, "tile"),
    (1, 20, 300, 16, 16, 192, 128, 280, "split"), (1, 4, 512, 4, 4, 192, 128, -2, "split"),
    (2, 10, 100, 4, 4, 32, 16, 90, "split"), (1, 3, 500, 8, 2, 128, 64, 497, "split"),
])
def test_forward_at_hd_v_below_hd_matches_plain_version(cuda, b, sq, sk, h, hkv, hd, hd_v,
                                                        q_offset, variant):
    """Every forward kernel with V at hd_v < hd, causal: "tile" on its (192,
    128), (64, 64) and (128, 128) instances, "split" with one and several
    splits (and rows that see no key), and "general" in f32; O at hd_v
    within one rounding step (bf16; 1e-4 in f32) of the plain version, lse
    within 1e-3, the launch without lse equal to the one with it."""
    gen = torch.Generator(device=cuda).manual_seed(hd + hd_v + sq)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda)
    k = torch.randn((b, sk, hkv, hd), generator=gen, device=cuda)
    v = torch.randn((b, sk, hkv, hd_v), generator=gen, device=cuda)
    kw = dict(q_positions=torch.arange(q_offset, q_offset + sq, device=cuda))
    for dtype, want in ((torch.bfloat16, variant), (torch.float32, "general")):
        qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
        before = dict(fa.flash_attention.variant_launches)
        out, lse = fa.flash_attention_lse(qd, kd, vd, **kw)
        again = fa.flash_attention(qd, kd, vd, **kw)
        ran = {n: c - before[n] for n, c in fa.flash_attention.variant_launches.items()}
        ref, lse_ref = fa.flash_attention_lse_ref(qd, kd, vd, **kw)
        torch.cuda.synchronize()
        assert ran == {n: 2 * int(n == want) for n in ran}
        assert out.shape == (b, sq, h, hd_v) and torch.equal(out, again)
        tol = 1e-4 if dtype == torch.float32 else 2**-7
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-5)


# (b, sq, sk, h, hkv, hd, hd_v, causal, window, q_offset): the "wgmma" (192, 128) instance
# MLA takes under a window with g = 4, at Sq != Sk with ragged tiles, with rows that see no
# key, at g = 5 and at a runtime hd of 160; (48, 32) on (64, 64); "mma" at (256, 128)
HDV_BWD_CASES = [
    (2, 300, 300, 8, 2, 192, 128, True, 64, 0), (2, 100, 333, 8, 2, 192, 128, True, 0, 233),
    (1, 16, 24, 4, 2, 192, 128, True, 0, -5), (1, 257, 257, 5, 1, 192, 128, True, 0, 0),
    (1, 200, 200, 4, 2, 160, 128, False, 0, 0), (2, 150, 150, 4, 2, 48, 32, True, 0, 0),
    (1, 130, 200, 4, 2, 256, 128, False, 0, 0),
]


@pytest.mark.parametrize("case", HDV_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_backward_at_hd_v_below_hd_matches_plain_version(cuda, case):
    """V, O and dO at hd_v < hd: the gradients within 2^-6 of the plain
    version's, two calls equal bit for bit, each counted as its design."""
    b, sq, sk, h, hkv, hd, hd_v, causal, window, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(sum(map(abs, case)))
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, sk, hkv, hd), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, sk, hkv, hd_v), generator=gen, device=cuda).bfloat16()
    do = torch.randn((b, sq, h, hd_v), generator=gen, device=cuda).bfloat16()
    kw = dict(q_positions=torch.arange(q_offset, q_offset + sq, device=cuda), causal=causal,
              window=window)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    assert o.shape == (b, sq, h, hd_v)
    before = dict(fab.flash_attention_bwd.design_launches)
    first = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    second = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    design = fab.design(hd, hd_v)
    assert design == ("mma" if hd > 192 else "wgmma") == fab.kernel_config(hd, hd_v)["design"]
    assert {d: c - before[d] for d, c in fab.flash_attention_bwd.design_launches.items()} == {
        d: 2 * int(d == design) for d in before}
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))
    want = fab.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), first, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_REL * float(w.float().abs().max()), (name, err)


def test_autograd_through_ops_launches_the_backward_kernel(cuda):
    """Gradients through ``ops.flash_attention`` on the card (forward "tile"
    with lse, backward the kernel) against autograd through the plain
    version in f32 on the CPU, from the same bf16 inputs."""
    q, k, v, do, kw = _bwd_inputs((2, 64, 64, 8, 2, 64, True, 0, 0), cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    launches, tile = fab.flash_attention_bwd.launches, fa.flash_attention.variant_launches["tile"]
    ops.flash_attention(*leaves, **kw).backward(do)
    torch.cuda.synchronize()
    assert fab.flash_attention_bwd.launches == launches + 1
    assert fa.flash_attention.variant_launches["tile"] == tile + 1
    ref = [t.detach().cpu().float().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention_ref(*ref, **{**kw, "q_positions": kw["q_positions"].cpu()}).backward(
        do.cpu().float())
    for leaf, r in zip(leaves, ref):
        err = float((leaf.grad.float().cpu() - r.grad).abs().max())
        assert err <= BWD_REL * float(r.grad.abs().max())


def test_attention_backward_raises_instead_of_falling_back(cuda):
    launches = fab.flash_attention_bwd.launches
    for dtype, hd in ((torch.float32, 64), (torch.bfloat16, 8)):
        x = torch.zeros((1, 64, 2, hd), device=cuda, dtype=dtype)
        lse = torch.zeros((1, 2, 64), device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            fab.flash_attention_bwd(x, x, x, x, x, lse)
        leaf = x.clone().requires_grad_(True)
        with pytest.raises(ValueError, match="head_dim"):
            ops.flash_attention(leaf, x, x).sum().backward()
    assert fab.flash_attention_bwd.launches == launches


def test_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build
    from repro_torch.sharding import flatten, init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_loss_fn, make_train_step

    from repro_torch.models import layers

    cfg = get_smoke("starcoder2-3b")
    params = init_params(build(cfg).param_specs(), torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, cfg.vocab, (4, 33), generator=torch.Generator().manual_seed(4))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for dev, dtype in ((cuda, torch.bfloat16), ("cpu", torch.bfloat16), ("cpu", torch.float32)):
        p = {k: t.to(dev).requires_grad_(True) for k, t in params.items()}
        layers.COMPUTE_DTYPE = dtype
        try:
            loss, _ = make_loss_fn(cfg)(p, {k: t.to(dev) for k, t in batch.items()})
            grads = torch.autograd.grad(loss, list(p.values()))
        finally:
            layers.COMPUTE_DTYPE = torch.bfloat16
        out.append((float(loss.detach()), torch.cat([g.float().cpu().reshape(-1) for g in grads])))
    (l_card, g_card), (l_cpu, g_cpu), (_, g_f32) = out
    assert abs(l_card - l_cpu) <= 0.02
    noise = float((g_cpu - g_f32).norm())  # bf16's own error on the CPU
    assert float((g_card - g_cpu).norm()) <= 3 * noise + 0.01 * float(g_f32.norm())
    launches = (fab.flash_attention_bwd.launches, gk.gf_matmul.launches)
    step = make_train_step(cfg, num_microbatches=2)
    state, metrics = step(opt.init_state({k: t.to(cuda) for k, t in params.items()}),
                          {k: t.to(cuda) for k, t in batch.items()})
    torch.cuda.synchronize()
    assert fab.flash_attention_bwd.launches == launches[0] + 2 * cfg.num_layers
    assert int(state["step"]) == 1 and bool(torch.isfinite(metrics["loss"]))
    assert all(bool(torch.isfinite(t).all()) for t in flatten(state).values())


def test_train_driver_goes_through_every_kernel(cuda):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import train

    cfg = get_smoke("granite-8b")
    launches = (gk.gf_matmul.launches, fa.flash_attention.launches,
                fab.flash_attention_bwd.launches)
    run = train(cfg, steps=16, batch=4, seq=48, ckpt_every=4, fail_at=6, device=cuda)
    assert gk.gf_matmul.launches > launches[0] and fa.flash_attention.launches > launches[1]
    assert fab.flash_attention_bwd.launches == launches[2] + cfg.num_layers * len(run.losses)
    assert run.restored_equal and not run.repair_failures


def test_prefetch_thread_decodes_on_the_card(cuda):
    """The data pipeline's worker thread reads (and decodes on the card) the
    batches the loop's thread would, in the same order."""
    from repro_torch.data.pipeline import BlobTokenDataset, write_token_corpus
    from repro_torch.launch.cluster import build_cluster

    _, sps, rpc, client = build_cluster(device=cuda)
    bid = write_token_corpus(client, np.arange(300_000, dtype=np.int32) % 49_152)
    sps[client.contract.blobs[bid].placement[(0, 0)]].crash()  # every read decodes
    fore = [x for x, _ in BlobTokenDataset(client, bid, batch=4, seq_len=500, seed=2)
            .batches(6, background=False)]
    rpc._cache.clear()
    launches = gk.gf_matmul.launches
    back = [x for x, _ in BlobTokenDataset(client, bid, batch=4, seq_len=500, seed=2)
            .batches(6)]
    torch.cuda.synchronize()
    assert gk.gf_matmul.launches > launches
    assert all(np.array_equal(a, b) for a, b in zip(fore, back)) and len(back) == 6


# -- the MoE, SSM, hybrid and embedding-input families -------------------------------------
@pytest.mark.parametrize("pos", [1500, 2047, 2048, 2099, 4095 + 64])
def test_split_decode_over_a_wrapped_ring(cuda, pos):
    """hymba's long-mode decode: 2,048 ring slots, window 2048, H 25 / Hkv 5,
    hd 64; before the ring fills (slots at UNWRITTEN), at the wrap and past
    it (tiles holding positions out of slot order): "split", as the plain
    version."""
    from repro_torch.models.attention import UNWRITTEN, ring_positions

    gen = torch.Generator(device=cuda).manual_seed(pos)
    q = torch.randn((1, 1, 25, 64), generator=gen, device=cuda).bfloat16()
    k = torch.randn((1, 2048, 5, 64), generator=gen, device=cuda).bfloat16()
    v = torch.randn((1, 2048, 5, 64), generator=gen, device=cuda).bfloat16()
    kpos = ring_positions(pos, 2048, cuda)
    assert bool((kpos == UNWRITTEN).any()) == (pos < 2047)
    kw = dict(q_positions=torch.tensor([pos], dtype=torch.int32, device=cuda), k_positions=kpos,
              causal=True, window=2048)
    split = fa.flash_attention.variant_launches["split"]
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.variant_launches["split"] == split + 1
    torch.testing.assert_close(out, fa.flash_attention_ref(q, k, v, **kw), atol=2**-7, rtol=2**-7)


def test_qk_norm_attention_on_the_card_matches_the_cpu(cuda):
    """qwen3's attention at its widths (d 2048, H 32 / Hkv 4, hd 128) with its
    per-head q/k RMSNorm, forward and gradient, on the card ("tile" and the
    backward kernel) against the CPU plain path from the same bf16 inputs:
    the output and the gradients (one vector) each within three times bf16's
    own error on the CPU (bf16 against f32 compute there) plus 1% of its norm."""
    from repro_torch.configs import get
    from repro_torch.models import attention as A
    from repro_torch.models import layers
    from repro_torch.sharding import ParamSpec, init_params

    cfg = get("qwen3-moe-30b-a3b")
    specs = {**A.attn_specs(cfg), "q_norm": ParamSpec((cfg.head_dim_,), ("head_dim",), init="ones"),
             "k_norm": ParamSpec((cfg.head_dim_,), ("head_dim",), init="ones")}
    gen = torch.Generator().manual_seed(5)
    params = init_params(specs, gen, device="cpu")
    params["q_norm"] += 0.1 * torch.randn(cfg.head_dim_, generator=gen)
    params["k_norm"] += 0.1 * torch.randn(cfg.head_dim_, generator=gen)
    x = torch.randn((1, 256, cfg.d_model), generator=gen).bfloat16()
    outs = []
    for dev, dtype in ((cuda, torch.bfloat16), ("cpu", torch.bfloat16), ("cpu", torch.float32)):
        p = {k: t.to(dev).requires_grad_(True) for k, t in params.items()}
        layers.COMPUTE_DTYPE = dtype
        try:
            out = A.attn_full(p, x.to(dev).to(dtype), cfg)
            grads = torch.autograd.grad(out.float().square().mean(), list(p.values()))
        finally:
            layers.COMPUTE_DTYPE = torch.bfloat16
        outs.append((out.detach().float().cpu(), torch.cat([g.float().cpu().reshape(-1)
                                                            for g in grads])))
    (o_card, g_card), (o_cpu, g_cpu), (o_f32, g_f32) = outs
    for card, cpu, exact in ((o_card, o_cpu, o_f32), (g_card, g_cpu, g_f32)):
        noise = float((cpu - exact).norm())
        assert float((card - cpu).norm()) <= 3 * noise + 0.01 * float(exact.norm())


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
                                  "hymba-1.5b"])
def test_family_decode_on_the_card_matches_the_cpu(cuda, arch):
    """Each family's decode step at smoke widths, teacher-forced over 40
    positions (in long mode: hymba-smoke's 32-slot ring wraps), on the card
    and on the CPU plain path: bf16 logits within 0.15, caches updated in
    place on both."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build
    from repro_torch.sharding import init_params

    cfg = get_smoke(arch)
    model = build(cfg)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(3), device="cpu")
    on_card = {k: t.to(cuda) for k, t in params.items()}
    caches = [{k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
               for k, s in model.cache_specs(2, 40, long_mode=True).items()} for dev in ("cpu", cuda)]
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(4))
    for pos in range(40):
        want, caches[0] = model.decode_step(params, caches[0], toks[:, pos:pos + 1], pos,
                                            long_mode=True)
        got, caches[1] = model.decode_step(on_card, caches[1], toks[:, pos:pos + 1].to(cuda), pos,
                                           long_mode=True)
        torch.testing.assert_close(got.float().cpu(), want.float(), atol=0.15, rtol=0)
    for name, c in caches[1].items():
        assert bool(torch.isfinite(c).all()) and c.abs().sum() > 0, name


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "qwen3-moe-30b-a3b", "falcon-mamba-7b",
                                  "hymba-1.5b"])
def test_family_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Each family's loss and gradient at smoke widths on the card against the
    CPU plain path, bf16 on both: loss within 0.02, gradients within three
    times bf16's own error on the CPU plus 1% of their norm."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import layers
    from repro_torch.models.model import build
    from repro_torch.sharding import init_params
    from repro_torch.train.loop import stub_embeddings
    from repro_torch.train.step import make_loss_fn

    cfg = get_smoke(arch)
    params = init_params(build(cfg).param_specs(), torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=torch.Generator().manual_seed(4))
    out = []
    for dev, dtype in ((cuda, torch.bfloat16), ("cpu", torch.bfloat16), ("cpu", torch.float32)):
        p = {k: t.to(dev).requires_grad_(True) for k, t in params.items()}
        x, y = toks[:, :-1].to(dev), toks[:, 1:].to(dev)
        batch = ({"embeddings": stub_embeddings(x, cfg.d_model), "labels": y}
                 if cfg.input_mode == "embeddings" else {"tokens": x, "labels": y})
        layers.COMPUTE_DTYPE = dtype
        try:
            loss, _ = make_loss_fn(cfg)(p, batch)
            grads = torch.autograd.grad(loss, list(p.values()), materialize_grads=True)
        finally:
            layers.COMPUTE_DTYPE = torch.bfloat16
        out.append((float(loss.detach()), torch.cat([g.float().cpu().reshape(-1) for g in grads])))
    (l_card, g_card), (l_cpu, g_cpu), (_, g_f32) = out
    assert abs(l_card - l_cpu) <= 0.02
    noise = float((g_cpu - g_f32).norm())
    assert float((g_card - g_cpu).norm()) <= 3 * noise + 0.01 * float(g_f32.norm())


# -- MLA (deepseek-v2-lite) and the encoder-decoder (whisper-tiny) -------------------------
@pytest.mark.parametrize("b,s,h,hd,hd_v", [(1, 1024, 16, 192, 128), (2, 200, 4, 24, 16),
                                            (2, 200, 4, 32, 16)])
def test_padded_v_attention_on_the_card_matches_the_plain_version(cuda, b, s, h, hd, hd_v):
    """``layers.flash_attention`` at MLA's hd 192 / hd_v 128 and at (32, 16)
    (MLA-smoke's 24 / 16 reaches the kernels as 32 / 16), causal, MHA, bf16,
    V at its own width (nothing pads it any more; the name is the test's
    first subject's): forward ("tile") within one rounding step of the plain
    version on the same inputs, and the gradients through
    ``ops.FlashAttention`` (the "wgmma" backward at (192, 128) and (32, 16))
    within 2^-6 of the CPU's f32 autograd of the plain version."""
    from repro_torch.models import layers

    gen = torch.Generator(device=cuda).manual_seed(hd)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, s, h, hd), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, s, h, hd_v), generator=gen, device=cuda).bfloat16()
    do = torch.randn((b, s, h, hd_v), generator=gen, device=cuda).bfloat16()
    mask, scale = layers.MaskSpec(causal=True), hd ** -0.5
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    tile = fa.flash_attention.variant_launches["tile"]
    designs = dict(fab.flash_attention_bwd.design_launches)
    out = layers.flash_attention(*leaves, mask=mask, scale=scale)
    out.backward(do)
    torch.cuda.synchronize()
    assert out.shape == (b, s, h, hd_v)
    assert fa.flash_attention.variant_launches["tile"] == tile + 1
    assert fab.design(-(-hd // 16) * 16, hd_v) == "wgmma"
    assert {d: c - designs[d] for d, c in fab.flash_attention_bwd.design_launches.items()} == {
        d: int(d == "wgmma") for d in designs}
    ref = [t.detach().cpu().float().requires_grad_(True) for t in (q, k, v)]
    want = layers.flash_attention(*ref, mask=mask, scale=scale)
    want.backward(do.cpu().float())
    torch.testing.assert_close(out.detach().float().cpu(), want.detach(), atol=2**-7, rtol=2**-7)
    for leaf, r in zip(leaves, ref):
        assert leaf.grad.shape == r.grad.shape
        err = float((leaf.grad.float().cpu() - r.grad).abs().max())
        assert err <= BWD_REL * float(r.grad.abs().max())


@pytest.mark.parametrize("b,sq,sk,h,variant", [
    (2, 1500, 1500, 6, "tile"),  # whisper's encoder
    (2, 448, 1500, 6, "tile"),  # its cross-attention in training
    (4, 1, 1500, 6, "split"),  # and in a decode step
])
def test_noncausal_whisper_attention_on_the_card(cuda, b, sq, sk, h, variant):
    """Non-causal attention over whisper's 1,500 frames (a ragged last tile
    of 28 keys), hd 64, bf16, against the plain version: the kernel the rule
    picks, within one rounding step; keys past Sk stay out of the softmax."""
    gen = torch.Generator(device=cuda).manual_seed(sq)
    q = torch.randn((b, sq, h, 64), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, sk, h, 64), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, sk, h, 64), generator=gen, device=cuda).bfloat16()
    before = dict(fa.flash_attention.variant_launches)
    out = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.flash_attention.variant_launches.items()} == {
        n: int(n == variant) for n in fa.VARIANTS}
    ref = fa.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(out, ref, atol=2**-7, rtol=2**-7)


def _smoke_model(arch):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build
    from repro_torch.sharding import init_params

    cfg = get_smoke(arch)
    model = build(cfg)
    return cfg, model, init_params(model.param_specs(), torch.Generator().manual_seed(3),
                                   device="cpu")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "whisper-tiny"])
def test_mla_and_encdec_decode_on_the_card_matches_the_cpu(cuda, arch):
    """deepseek-smoke's absorbed decode (its latent caches) and whisper-smoke's
    (self-attention over its cache, cross-attention over the encoded frames)
    teacher-forced over 16 positions on the card and on the CPU plain path:
    bf16 logits within 0.15, caches finite and written."""
    cfg, model, params = _smoke_model(arch)
    on_card = {k: t.to(cuda) for k, t in params.items()}
    caches = [{k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
               for k, s in model.cache_specs(2, 16).items()} for dev in ("cpu", cuda)]
    if cfg.is_encdec:
        frames = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            enc = model.encode(params, frames).to(torch.bfloat16)
            enc_card = model.encode(on_card, frames.to(cuda)).to(torch.bfloat16)
        torch.testing.assert_close(enc_card.float().cpu(), enc.float(), atol=0.15, rtol=0)
        caches[0]["enc_out"], caches[1]["enc_out"] = enc, enc.to(cuda)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        for pos in range(16):
            want, caches[0] = model.decode_step(params, caches[0], toks[:, pos:pos + 1], pos)
            got, caches[1] = model.decode_step(on_card, caches[1], toks[:, pos:pos + 1].to(cuda),
                                               pos)
            torch.testing.assert_close(got.float().cpu(), want.float(), atol=0.15, rtol=0)
    for name, c in caches[1].items():
        assert bool(torch.isfinite(c).all()) and c.abs().sum() > 0, name


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "whisper-tiny"])
def test_mla_and_encdec_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """The loss and gradient at smoke widths (whisper over zero frames, as
    the trainer feeds it) on the card against the CPU plain path, bf16 on
    both: loss within 0.02, gradients within three times bf16's own error on
    the CPU plus 1% of their norm; the backward kernel ran."""
    from repro_torch.models import layers
    from repro_torch.train.step import make_loss_fn

    cfg, _, params = _smoke_model(arch)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=torch.Generator().manual_seed(4))
    out = []
    launches = fab.flash_attention_bwd.launches
    for dev, dtype in ((cuda, torch.bfloat16), ("cpu", torch.bfloat16), ("cpu", torch.float32)):
        p = {k: t.to(dev).requires_grad_(True) for k, t in params.items()}
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        if cfg.is_encdec:
            batch["frames"] = torch.zeros((2, cfg.enc_seq, cfg.d_model), device=dev)
        layers.COMPUTE_DTYPE = dtype
        try:
            loss, _ = make_loss_fn(cfg)(p, batch)
            grads = torch.autograd.grad(loss, list(p.values()), materialize_grads=True)
        finally:
            layers.COMPUTE_DTYPE = torch.bfloat16
        out.append((float(loss.detach()), torch.cat([g.float().cpu().reshape(-1) for g in grads])))
    assert fab.flash_attention_bwd.launches > launches
    (l_card, g_card), (l_cpu, g_cpu), (_, g_f32) = out
    assert abs(l_card - l_cpu) <= 0.02
    noise = float((g_cpu - g_f32).norm())
    assert float((g_card - g_cpu).norm()) <= 3 * noise + 0.01 * float(g_f32.norm())


@pytest.mark.parametrize("b,sq,sk,h,hd,hd_v", [(4, 4096, 4096, 24, 128, 128),
                                               (2, 300, 700, 8, 64, 64), (1, 129, 260, 16, 192, 128),
                                               (1, 129, 260, 16, 192, 192), (3, 64, 64, 5, 16, 16)])
def test_bwd_scratch_mirror_equals_the_launcher(cuda, b, sq, sk, h, hd, hd_v):
    """The dry-run's meta path sizes the backward's scratch by a Python mirror
    of the launcher's ``flash_attention_bwd_scratch_bytes``: equal."""
    assert fab.scratch_bytes(b, sq, sk, h, hd, hd_v) == \
        fab._lib().flash_attention_bwd_scratch_bytes(b, sq, sk, h, hd, hd_v)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dryrun_prediction_against_the_cards_peak(cuda, kind):
    """``launch/dryrun.py::estimate`` on the meta device against the card:
    a step of granite-smoke (a train step, 8 x 1024 in 2 microbatches, or a
    decode step of batch 16 over 4,096 slots) run once warm, then again
    after ``reset_peak_memory_stats``; the arguments plus what the step
    allocated above the memory held at the reset within 15% of the
    predicted peak, the temporaries (that less the arguments) within 5% of
    the predicted ones or 256 KiB (512 blocks' rounding by the caching
    allocator), and the same attention launches as the trace declared."""
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import estimate
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shapes import serve_param_specs
    from repro_torch.models.model import build
    from repro_torch.sharding import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_decode_step, make_train_step

    cfg = get_smoke("granite-8b")
    model = build(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if kind == "train":
        shape = ShapeCell("train_4k", 1024, 8, "train")
        pred = estimate(cfg, shape, make_local_mesh(), microbatch_override=2)
        state = opt.init_state(init_params(model.param_specs(), gen, device=cuda))
        toks = torch.randint(0, cfg.vocab, (8, 1025), generator=gen, device=cuda,
                             dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        step = make_train_step(cfg, num_microbatches=2)
        args = [*state["params"].values(), *state["m"].values(), *state["v"].values(),
                state["step"], *batch.values()]
        run = lambda: step(state, batch)  # noqa: E731
    else:
        shape = ShapeCell("decode_32k", 4096, 16, "decode")
        pred = estimate(cfg, shape, make_local_mesh())
        params = init_params(serve_param_specs(model), gen, device=cuda, dtype=torch.bfloat16)
        cache = {k: torch.zeros(sp.shape, dtype=sp.dtype, device=cuda)
                 for k, sp in model.cache_specs(16, 4096).items()}
        tokens = torch.ones((16, 1), dtype=torch.int32, device=cuda)
        step = make_decode_step(cfg)
        args = [*params.values(), *cache.values(), tokens]
        run = lambda: step(params, cache, tokens, 4095)  # noqa: E731
    arg_bytes = sum(t.numel() * t.element_size() for t in args) + (4 if kind == "decode" else 0)
    assert arg_bytes == pred["memory"]["argument_bytes"]
    out = run()
    torch.cuda.synchronize()
    del out
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    launches = fa.flash_attention.launches
    out = run()
    torch.cuda.synchronize()
    measured = arg_bytes + torch.cuda.max_memory_allocated() - held
    assert fa.flash_attention.launches - launches == pred["kernels"]["flash_attention"]["launches"]
    assert abs(measured / pred["memory"]["peak_bytes"] - 1) <= 0.15, (measured, pred["memory"])
    temp_gap = measured - arg_bytes - pred["memory"]["temp_bytes"]
    assert abs(temp_gap) <= max(0.05 * pred["memory"]["temp_bytes"], 256 * 1024), (
        measured, pred["memory"])


# -- the mesh: "split" with lse, the Gloo card route, a 2 x 2 world on one card ------------
@pytest.mark.parametrize("b,sk,h,hkv,hd,pos,kpos", [
    (4, 16, 4, 2, 16, 3, "arange"),          # the CPU mesh test's decode, one split
    (2, 2048, 32, 8, 128, 1000, "arange"),   # granite-8b, a 2,048-slot shard: several splits
    (2, 2048, 32, 8, 128, 1000, "shard1"),   # the second model rank's shard: no visible key
    (16, 4096, 32, 4, 128, 3000, "arange"),  # yi-9b widths, 4,096 slots
    (1, 2048, 25, 5, 64, 1500, "ring"),      # hymba's ring before it fills (UNWRITTEN slots)
])
def test_split_with_lse_matches_plain_version(cuda, b, sk, h, hkv, hd, pos, kpos):
    """Decode rows (< 64 per kv head) take "split", which writes the row
    log-sum-exp when asked: o as without it, lse as the plain version's
    (-1e30 exactly for a row that sees no key)."""
    from repro_torch.models.attention import ring_positions

    gen = torch.Generator(device=cuda).manual_seed(sk + pos)
    q = torch.randn((b, 1, h, hd), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, sk, hkv, hd), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, sk, hkv, hd), generator=gen, device=cuda).bfloat16()
    kp = {"arange": torch.arange(sk, dtype=torch.int32, device=cuda),
          "shard1": torch.arange(sk, 2 * sk, dtype=torch.int32, device=cuda),
          "ring": ring_positions(pos, sk, cuda)}[kpos]
    kw = dict(q_positions=torch.tensor([pos], dtype=torch.int32, device=cuda), k_positions=kp,
              causal=True, window=sk if kpos == "ring" else 0)
    split = fa.flash_attention.variant_launches["split"]
    o, lse = ops.flash_attention_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.variant_launches["split"] == split + 1
    assert torch.equal(o, ops.flash_attention(q, k, v, **kw))
    o_ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(o, o_ref, atol=2**-7, rtol=2**-7)
    if kpos == "shard1":
        assert bool((lse == fa.NEG_INF).all())
    else:
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("pos", [1000, 1500, 2040, 2047, 2048, 2060, 3071])
def test_split_with_lse_over_a_ring_shard(cuda, pos):
    """hymba's long mode on a 2-rank mesh: each rank attends over its 1,024
    slots of the 2,048-slot ring (H 25, Hkv 5, hd 64) under a window of
    2,048 -- twice its slots -- at its slice of ``ring_positions``, not a
    ring of its own.  Each shard's "split" with lse equals the plain
    version (a shard whose slots are all unwritten, as the second one's at
    position 1000, sees no key: lse -1e30), and the two shards' partials
    combined by their lse equal attention over the whole ring."""
    from repro_torch.models.attention import ring_positions

    ring, half = 2048, 1024
    gen = torch.Generator(device=cuda).manual_seed(pos)
    q = torch.randn((1, 1, 25, 64), generator=gen, device=cuda).bfloat16()
    k = torch.randn((1, ring, 5, 64), generator=gen, device=cuda).bfloat16()
    v = torch.randn((1, ring, 5, 64), generator=gen, device=cuda).bfloat16()
    qpos = torch.tensor([pos], dtype=torch.int32, device=cuda)
    kpos = ring_positions(pos, ring, cuda)
    parts = []
    for r in range(2):
        sl = slice(r * half, (r + 1) * half)
        kw = dict(q_positions=qpos, k_positions=kpos[sl].contiguous(), causal=True, window=ring)
        split = fa.flash_attention.variant_launches["split"]
        o, lse = ops.flash_attention_lse(q, k[:, sl].contiguous(), v[:, sl].contiguous(), **kw)
        torch.cuda.synchronize()
        assert fa.flash_attention.variant_launches["split"] == split + 1
        o_ref, lse_ref = fa.flash_attention_lse_ref(q, k[:, sl], v[:, sl], **kw)
        torch.testing.assert_close(o, o_ref, atol=2**-7, rtol=2**-7)
        if bool((kpos[sl] > pos).all()):  # every slot unwritten (UNWRITTEN > any position)
            assert bool((lse == fa.NEG_INF).all())
        else:
            torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-5)
        parts.append((o.float(), lse))
    m = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(lse - m).transpose(1, 2)[..., None] for _, lse in parts]
    combined = (w[0] * parts[0][0] + w[1] * parts[1][0]) / (w[0] + w[1])
    whole = fa.flash_attention_ref(q, k, v, q_positions=qpos, k_positions=kpos, causal=True,
                                   window=ring)
    torch.testing.assert_close(combined, whole.float(), atol=2**-7, rtol=2**-7)


def _gloo_card_rank(mesh):
    """Each collective on card tensors (the route built from all_reduce)
    against the sum written out from both ranks' inputs."""
    from repro_torch import distributed as D

    ax = mesh.axis("model")
    xs = [torch.randn((3, 4, 5), generator=torch.Generator().manual_seed(r)).to(mesh.device)
          for r in range(2)]
    xs[0][0, 0, 0] = -0.0
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        mine = xs[ax.index].to(dtype)
        want = torch.cat([x.to(dtype) for x in xs], 1)
        got = D.all_gather(mine, ax, 1)
        out[f"gather.{dtype}"] = bool(torch.equal(got, want)
                                      and torch.equal(torch.signbit(got), torch.signbit(want)))
        total = (xs[0].to(dtype).float() + xs[1].to(dtype).float()).to(dtype)
        out[f"scatter.{dtype}"] = bool(torch.equal(D.reduce_scatter(mine, ax, 1),
                                                   total.narrow(1, ax.index * 2, 2)))
        out[f"sum.{dtype}"] = bool(torch.equal(D.all_reduce(mine, ax), total))
        out[f"device.{dtype}"] = got.device.type
    out["route"] = D.ROUTES[(torch.distributed.get_backend(ax.group), "cuda")]
    return out


def test_gloo_collectives_on_card_tensors(cuda):
    from repro_torch.launch.mesh import launch

    for rank in launch(_gloo_card_rank, data=1, model=2, device="cuda", timeout=300):
        assert rank.pop("route") == "all_reduce"
        assert {k: v for k, v in rank.items() if not k.startswith("device")} == {
            k: True for k in rank if not k.startswith("device")}
        assert {v for k, v in rank.items() if k.startswith("device")} == {"cuda"}


def _mesh_card_rank(mesh, params, cache, toks, batch):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build
    from repro_torch.sharding import DECODE_RULES, TRAIN_RULES, MeshCtx, unshard
    from repro_torch.train.optimizer import init_state
    from repro_torch.train.step import make_train_step

    dev = mesh.device
    cfg = get_smoke("granite-8b")
    model = build(cfg)
    to = lambda tree: {k: torch.from_numpy(v).to(dev) for k, v in tree.items()}  # noqa: E731
    params = to(params)
    cache_specs = model.cache_specs(4, 16)
    dctx = MeshCtx(DECODE_RULES, mesh, cfg).for_cache(16)
    c = dctx.shard({k: v.bfloat16() for k, v in to(cache).items()}, cache_specs)
    fa.reset_launches()
    with torch.no_grad():
        lg, nc = model.decode_step(dctx.shard(params, model.param_specs()), c,
                                   torch.from_numpy(toks).to(dev), 3, dctx)
    split = fa.flash_attention.variant_launches["split"]
    tctx = MeshCtx(TRAIN_RULES, mesh, cfg)
    step = make_train_step(cfg, tctx, num_microbatches=2, shard_grad_accum=True)
    _, met = step(init_state(tctx.shard(params, model.param_specs())), to(batch))
    return {"logits": lg, "cache": unshard(nc, cache_specs, dctx.rules, mesh), "split": split,
            "loss": met["loss"], "device": lg.device.type}


def _mesh_on_one_card(cuda, world: dict, train_rows: int):
    """``_mesh_card_rank`` on a ``world`` of ranks on the one card (granite-smoke,
    decode batch 4, a train batch of ``train_rows`` x 16 in 2 microbatches)
    held against one process on the card."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import launch
    from repro_torch.models.model import build
    from repro_torch.sharding import init_params
    from repro_torch.train.optimizer import init_state
    from repro_torch.train.step import make_train_step

    cfg = get_smoke("granite-8b")
    model = build(cfg)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(0)
    cache = {k: rng.normal(size=s.shape).astype(np.float32)
             for k, s in model.cache_specs(4, 16).items()}
    toks = rng.integers(0, cfg.vocab, (4, 1))
    batch = {k: rng.integers(0, cfg.vocab, (train_rows, 16)) for k in ("tokens", "labels")}
    ranks = launch(_mesh_card_rank, {k: v.numpy() for k, v in params.items()}, cache, toks, batch,
                   device="cuda", timeout=600, **world)
    p = {k: v.to(cuda) for k, v in params.items()}
    c = {k: torch.from_numpy(v).to(cuda).bfloat16() for k, v in cache.items()}
    with torch.no_grad():
        lg, nc = model.decode_step(p, c, torch.from_numpy(toks).to(cuda), 3)
    _, met = make_train_step(cfg, num_microbatches=2)(
        init_state(p), {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()})
    for r in ranks:
        assert r["device"] == "cuda" and r["split"] == cfg.num_layers
        assert np.abs(r["logits"] - lg.float().cpu().numpy()).max() < 0.05
        for k in nc:
            want = nc[k].float().cpu().numpy()
            assert np.abs(r["cache"][k] - want).max() <= 2**-4 * np.abs(want).max()
        assert abs(float(r["loss"]) - float(met["loss"])) < 0.02
    return ranks


def test_mesh_on_one_card_matches_one_process(cuda):
    """A 2 x 2 Gloo world of four processes on the one card: granite-smoke's
    decode over a cache split over model ("split" with lse in every rank)
    and a train step with shard_grad_accum, against one process on the card."""
    _mesh_on_one_card(cuda, {"data": 2, "model": 2}, train_rows=4)


def test_pod_world_on_one_card_matches_one_process(cuda):
    """The same on a 2 x 2 x 2 ("pod", "data", "model") world of eight
    processes on the one card: the decode's batch a row a ``(pod, data)``
    rank, the train step's 8 rows and FSDP over ``("pod", "data")``, whose
    collectives take the card route (a Gloo sum of each rank's slot)."""
    _mesh_on_one_card(cuda, {"pod": 2, "data": 2, "model": 2}, train_rows=8)


def test_quickstart_example_on_the_card_prints_what_the_cpu_prints(cuda):
    """``examples/torch/quickstart.py`` on the card (its default) and with
    ``--device cpu``: every printed line equal (receipts, payments, repair
    bytes), and the card run through ``gf_matmul``'s kernel."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    script = str(root / "examples" / "torch" / "quickstart.py")
    runs = [subprocess.run([sys.executable, script, *extra], capture_output=True, text=True,
                           env=env, timeout=300) for extra in ([], ["--device", "cpu"])]
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    assert runs[0].stdout.splitlines() == runs[1].stdout.splitlines()
    assert runs[0].stdout.startswith("stored blob 0: 1000000 bytes")


def _moved_rank(mesh):
    """One all_gather and one reduce_scatter on card tensors and on CPU
    tensors over the same Gloo group: what ``distributed.moved`` and
    ``calls`` count for each."""
    from repro_torch import distributed as D

    ax = mesh.axis("model")
    out = {}
    for dev in ("cuda", "cpu"):
        x = torch.randn((6, 4, 5), generator=torch.Generator().manual_seed(ax.index)).to(dev)
        before = dict(D.moved), dict(D.calls)
        D.all_gather(x.bfloat16(), ax, 1)
        D.reduce_scatter(x.bfloat16(), ax, 0)
        out[dev] = {k: (D.moved[k] - before[0][k], D.calls[k] - before[1][k]) for k in D.KINDS}
    return out


def test_moved_counts_the_payload_on_both_routes(cuda):
    """The card's route (a sum of a zero buffer) and the CPU's native ops
    count the same: an all-gather its own part, a reduce-scatter its f32 input."""
    from repro_torch.launch.mesh import launch

    for rank in launch(_moved_rank, data=1, model=2, device="cuda", timeout=300):
        assert rank["cuda"] == rank["cpu"]
        assert rank["cuda"]["all_gather"] == (6 * 4 * 5 * 2, 1)
        assert rank["cuda"]["reduce_scatter"] == (6 * 4 * 5 * 4, 1)


def _mesh_prefill_rank(mesh, params, tokens):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build
    from repro_torch.sharding import SERVE_RULES, MeshCtx, unshard

    dev = mesh.device
    cfg = get_smoke("granite-8b")
    model = build(cfg)
    ctx = MeshCtx(SERVE_RULES, mesh, cfg)
    shards = ctx.shard({k: torch.from_numpy(v).to(dev) for k, v in params.items()},
                       model.param_specs())
    fa.reset_launches()
    with torch.no_grad():
        lg, cache = model.prefill(shards, {"tokens": torch.from_numpy(tokens).to(dev)}, ctx)
    tile = fa.flash_attention.variant_launches["tile"]
    specs = model.cache_specs(*tokens.shape)
    return {"logits": lg, "cache": unshard(cache, specs, SERVE_RULES, mesh), "tile": tile,
            "device": lg.device.type}


def test_mesh_prefill_on_one_card_matches_the_cpu(cuda):
    """A 2 x 2 Gloo world on the card: granite-smoke's prefill of 4 x 64
    tokens under SERVE_RULES ("tile" once per layer in every rank), against
    the port's prefill in one process on the CPU plain path, both bf16:
    logits within 0.15 (the card-vs-CPU bound of chip_smoke.py), caches
    within 2^-4 of their largest entry."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import launch
    from repro_torch.models.model import build
    from repro_torch.sharding import init_params

    cfg = get_smoke("granite-8b")
    model = build(cfg)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(3), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (4, 64))
    ranks = launch(_mesh_prefill_rank, {k: v.numpy() for k, v in params.items()}, tokens,
                   data=2, model=2, device="cuda", timeout=600)
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    for r in ranks:
        assert r["device"] == "cuda" and r["tile"] == cfg.num_layers
        assert np.abs(r["logits"] - lg.float().numpy()).max() < 0.15
        for k, want in cache.items():
            want = want.float().numpy()
            assert np.abs(r["cache"][k] - want).max() <= 2**-4 * np.abs(want).max(), k


# The forward's "tile" designs: (b, sq, sk, h, hkv, hd, hd_v, causal, window, q_offset,
# k_order) with k_order "arange" or "perm" (a ring buffer's permuted positions)
WGMMA_FWD_CASES = [
    (2, 256, 256, 8, 2, 64, 64, True, 0, 0, "arange"),  # (64, 64)
    (1, 300, 300, 6, 2, 128, 128, True, 0, 0, "arange"),  # (128, 128), ragged Sq and Sk
    (1, 513, 513, 4, 4, 192, 128, True, 0, 0, "arange"),  # (192, 128): MLA's widths
    (2, 200, 333, 8, 2, 160, 128, True, 0, 133, "arange"),  # hd 160 on (192, 128)
    (1, 400, 400, 8, 2, 128, 128, True, 100, 0, "arange"),  # a sliding window
    # a window over ragged tiles at two stages: a warpgroup skips a tile after one it computed
    (3, 200, 260, 8, 2, 96, 96, True, 33, 60, "arange"),
    (2, 448, 1500, 6, 6, 64, 64, False, 0, 0, "arange"),  # non-causal, Sk = 1500: a tail tile
    (1, 300, 512, 8, 2, 128, 128, True, 200, 300, "perm"),  # permuted keys under a window
    (1, 256, 512, 8, 2, 128, 128, True, 0, -200, "arange"),  # a block that sees no key
    (1, 64, 64, 2, 2, 16, 16, True, 0, 0, "arange"),  # Sq at the rule's 64, hd 16
]


@pytest.mark.parametrize("case", WGMMA_FWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_wgmma_forward_design_matches_plain_version(cuda, case):
    """The "wgmma" design of "tile" against ``flash_attention_lse_ref``: O
    within one bf16 rounding step (2^-7), the row log-sum-exp within 1e-3,
    a row that sees no key the mean of V and lse -1e30; two calls equal bit
    for bit; each launch counted as "wgmma"."""
    b, sq, sk, h, hkv, hd, hd_v, causal, window, q_offset, k_order = case
    gen = torch.Generator(device=cuda).manual_seed(sq * 7 + sk)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, sk, hkv, hd), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, sk, hkv, hd_v), generator=gen, device=cuda).bfloat16()
    qpos = torch.arange(q_offset, q_offset + sq, dtype=torch.int32, device=cuda)
    kpos = (torch.randperm(sk, generator=gen, device=cuda).int() if k_order == "perm"
            else torch.arange(sk, dtype=torch.int32, device=cuda))
    kw = dict(q_positions=qpos, k_positions=kpos, causal=causal, window=window)
    assert fa.choose_variant(q.dtype, sq, h, hkv, hd, hd_v=hd_v) == "tile"
    assert fa.tile_design(q.dtype, hd, hd_v, sq) == "wgmma"
    before = dict(fa.flash_attention.design_launches)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    o2, lse2 = fa.flash_attention_lse(q, k, v, **kw)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {d: c - before[d] for d, c in fa.flash_attention.design_launches.items()} == {
        "wgmma": 3, "mma": 0}
    assert torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(o, out)
    o_ref, lse_ref = fa.flash_attention_lse_ref(q, k, v, **kw)
    torch.testing.assert_close(o, o_ref, atol=2**-7, rtol=2**-7)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    blind = ~fa.visible(qpos, kpos, causal, window).any(1)
    if blind.any():
        assert bool((lse[:, :, blind] == fa.NEG_INF).all())
        mean = v.float().mean(1).repeat_interleave(h // hkv, dim=1)  # (b, h, hd_v)
        torch.testing.assert_close(o[:, blind].float(),
                                   mean[:, None].expand(b, int(blind.sum()), h, hd_v),
                                   atol=2**-7, rtol=2**-7)


@pytest.mark.parametrize("case,design", [
    ((1, 300, 300, 4, 2, 256, 256), "mma"),  # hd 256: no "wgmma" instance
    ((4, 8, 8, 32, 4, 128, 128), "mma"),  # 8-token prompts at a GQA group of 8
    ((2, 63, 100, 8, 1, 128, 128), "mma"),  # one query short of a warpgroup's rows
    ((2, 64, 100, 8, 1, 128, 128), "wgmma"),
])
def test_tile_design_rule_on_the_card(cuda, case, design):
    """Each "tile" call goes to the design ``tile_design`` names and is
    counted there, within 2^-7 of the plain version; the "mma" design takes
    any "tile" call it is asked for, "wgmma" raises where it does not fit."""
    b, sq, sk, h, hkv, hd, hd_v = case
    gen = torch.Generator(device=cuda).manual_seed(sq + hd)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, sk, hkv, hd), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, sk, hkv, hd_v), generator=gen, device=cuda).bfloat16()
    qpos = torch.arange(sk - sq, sk, device=cuda)
    assert fa.choose_variant(q.dtype, sq, h, hkv, hd, hd_v=hd_v) == "tile"
    assert fa.tile_design(q.dtype, hd, hd_v, sq) == design
    before = dict(fa.flash_attention.design_launches)
    out = ops.flash_attention(q, k, v, q_positions=qpos)
    forced = fa.flash_attention_variant("tile", q, k, v, q_positions=qpos, design="mma")
    torch.cuda.synchronize()
    assert {d: c - before[d] for d, c in fa.flash_attention.design_launches.items()} == {
        d: int(d == design) + int(d == "mma") for d in fa.DESIGNS}
    ref = fa.flash_attention_ref(q, k, v, q_positions=qpos)
    for got in (out, forced):
        torch.testing.assert_close(got, ref, atol=2**-7, rtol=2**-7)
    if design == "mma":
        with pytest.raises(ValueError, match="wgmma"):
            fa.flash_attention_variant("tile", q, k, v, q_positions=qpos, design="wgmma")


def test_a_marked_train_step_on_the_card_equals_an_unmarked_one(cuda):
    """Two steps of a small MLA + MoE model under a profiler, its spans
    marked on the stream and its backward intervals marked from the autograd
    graph, leave the loss and the state bit for bit as two unmarked steps."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import build
    from repro_torch.sharding import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_smoke("deepseek-v2-lite-16b"), num_layers=2)
    step = make_train_step(cfg, num_microbatches=2)
    toks = torch.randint(0, cfg.vocab, (2, 4, 65), generator=torch.Generator().manual_seed(3))

    def run(prof):
        gen = torch.Generator(device=cuda).manual_seed(0)
        state = opt.init_state(init_params(build(cfg).param_specs(), gen, device=cuda))
        if prof is not None:
            prof.__enter__()
        for t in toks.to(cuda):
            state, metrics = step(state, {"tokens": t[:, :-1], "labels": t[:, 1:]})
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
        return metrics["loss"], state

    trace.mark_library()
    loss0, state0 = run(None)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    loss1, state1 = run(prof)
    assert torch.equal(loss0, loss1)
    for part in ("params", "m", "v"):
        for k in state0[part]:
            assert torch.equal(state0[part][k], state1[part][k]), (part, k)
    marks = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA and "trace_mark_kernel" in e.name()]
    bwd = 2 * trace.NUMBER["moe.combine.bwd"]
    assert sum(f"trace_mark_kernel<{bwd}>" in n for n in marks) == 2 * 2  # 2 steps x 2 microbatches
