"""GF(2^8) arithmetic and the gf_matmul kernel module of the PyTorch port,
held byte-identical to the JAX package (Pallas interpret mode and numpy).

GF(2^8) arithmetic is exact, so every comparison is exact equality.
"""
import numpy as np
import pytest
import torch

from repro.core import gf as jgf
from repro.core.rs import MDSCode as JMDSCode
from repro.kernels import gf_matmul as jgk
from repro_torch.core import gf
from repro_torch.core.rs import MDSCode
from repro_torch.kernels import gf_matmul as gk
from repro_torch.kernels import ops


def _operands(m, k, n, seed, zero_row=False):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (m, k), dtype=np.uint8)
    if zero_row:
        a[m // 2] = 0
    b = rng.integers(0, 256, (k, n), dtype=np.uint8)
    return a, b


_WIDE_N = (1, 2047, 2049, 5000)  # around the Pallas kernel's 2048-column block


@pytest.fixture(scope="module")
def pallas_6x12():
    """Pallas (interpret mode) products for the Clay (10,6) coefficient shape.

    Interpret mode compiles once per operand shape, and that compile is
    most of its cost, so every width is one slice of a single wide B: a
    product's columns depend only on the same columns of B.  A random A and
    one with an all-zero row share that shape and so that compile.
    """
    rng = np.random.default_rng(612)
    b = rng.integers(0, 256, (12, sum(_WIDE_N)), dtype=np.uint8)
    a = rng.integers(0, 256, (6, 12), dtype=np.uint8)
    a_zero = a.copy()
    a_zero[3] = 0
    return b, {z: (x, np.asarray(jgk.gf_matmul(x, b, interpret=True)))
               for z, x in ((False, a), (True, a_zero))}


@pytest.mark.parametrize("zero_row", [False, True])
@pytest.mark.parametrize("n", _WIDE_N)
def test_gf_matmul_ref_matches_pallas_and_numpy_6x12(pallas_6x12, n, zero_row):
    b_all, products = pallas_6x12
    a, c_all = products[zero_row]
    lo = sum(_WIDE_N[: _WIDE_N.index(n)])
    b = np.ascontiguousarray(b_all[:, lo : lo + n])
    out = gk.gf_matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(out, c_all[:, lo : lo + n])
    np.testing.assert_array_equal(out, jgf.matmul_np(a, b))


@pytest.mark.parametrize("m,k,n", [(4, 4, 300), (1, 4, 257), (1, 1, 33)])
def test_gf_matmul_ref_matches_pallas_and_numpy_small(m, k, n):
    a, b = _operands(m, k, n, seed=m * 100_000 + k * 10_000 + n)
    out = gk.gf_matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jgk.gf_matmul(a, b, interpret=True)))
    np.testing.assert_array_equal(out, jgf.matmul_np(a, b))


def test_ops_dispatch_takes_plain_version_on_cpu():
    a, b = _operands(6, 12, 4856, seed=1)
    launches = gk.gf_matmul.launches
    out = ops.gf_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert out.device.type == "cpu" and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), jgf.matmul_np(a, b))
    assert gk.gf_matmul.launches == launches  # the plain version launches nothing


def test_kernel_wrapper_refuses_cpu_tensors():
    a, b = (torch.from_numpy(x) for x in _operands(2, 3, 8, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        gk.gf_matmul(a, b)


@pytest.mark.parametrize("bad", [
    "dtype", "ndim", "inner", "contiguous", "m_too_big", "k_too_big", "n_zero",
])
def test_checks_raise_on_inputs_the_kernel_does_not_take(bad):
    a = torch.zeros((6, 12), dtype=torch.uint8)
    b = torch.zeros((12, 64), dtype=torch.uint8)
    if bad == "dtype":
        a = a.to(torch.int32)
    elif bad == "ndim":
        b = b[None]
    elif bad == "inner":
        b = b[:11]
    elif bad == "contiguous":
        b = torch.zeros((64, 12), dtype=torch.uint8).t()
    elif bad == "m_too_big":
        a = torch.zeros((33, 12), dtype=torch.uint8)
    elif bad == "k_too_big":
        a, b = torch.zeros((6, 33), dtype=torch.uint8), torch.zeros((33, 64), dtype=torch.uint8)
    elif bad == "n_zero":
        b = b[:, :0]
    with pytest.raises((TypeError, ValueError)):
        ops.gf_matmul(a, b)


def test_mul_torch_and_mul_const_exhaustive():
    x = np.arange(256, dtype=np.uint8)
    table = jgf.mul(x[:, None], x[None, :])
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(gf.mul_torch(xt[:, None], xt[None, :]).numpy(), table)
    for c in range(256):
        np.testing.assert_array_equal(gf.mul_const(c, xt).numpy(), table[c])


def test_numpy_tables_are_the_reference_tables():
    np.testing.assert_array_equal(gf.EXP_TABLE, jgf.EXP_TABLE)
    np.testing.assert_array_equal(gf.LOG_TABLE, jgf.LOG_TABLE)
    np.testing.assert_array_equal(gf.vandermonde(6, 18), jgf.vandermonde(6, 18))
    m = gf.vandermonde(5, 5)
    np.testing.assert_array_equal(gf.mat_inv(m), jgf.mat_inv(m))


@pytest.mark.parametrize("n,k", [(6, 4), (16, 10)])
def test_mds_code_matches_reference(n, k):
    rng = np.random.default_rng(n * 31 + k)
    data = rng.integers(0, 256, (k, 777), dtype=np.uint8)
    ref, port = JMDSCode(n=n, k=k), MDSCode(n=n, k=k)
    coded = port.encode(torch.from_numpy(data))
    np.testing.assert_array_equal(coded.numpy(), ref.encode(data))
    erased = set(rng.choice(n, n - k, replace=False).tolist())
    shards = {i: coded[i] for i in range(n) if i not in erased}
    np.testing.assert_array_equal(
        port.decode(shards).numpy(),
        ref.decode({i: v.numpy() for i, v in shards.items()}),
    )
