"""The port's CUDA kernel and its callers on the card.

These need an NVIDIA GPU and skip without one (the kernel has no CPU mode).
On a GPU machine, which need not have jax:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel is held to its plain PyTorch version, and the device Clay path
to the CPU plain path, with exact equality (GF(2^8) arithmetic is exact).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.clay import ClayCode
from repro_torch.kernels import gf_matmul as gk
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [
    (6, 12, 216 * 4856), (6, 12, 3 * 216 * 4856 + 17), (6, 12, 6 * 4856), (4, 4, 4096),
    (1, 4, 4095), (1, 1, 1), (32, 32, 10_001), (1, 17, 4856), (6, 12, 3),
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
    assert all(t.device.type == "cuda" for t, _version in rpc._cache.values())
