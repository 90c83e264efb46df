"""GF(2^8) arithmetic for erasure coding.

Two execution paths share one semantic:

* ``numpy`` path (``mul``, ``matmul_np``…)  — small setup-time linear algebra
  (matrix inversion for decode plans) and the numpy-only repair path.
* ``torch`` path (``mul_torch``, ``mul_const``, ``matmul_torch``) — branchless
  shift/xor arithmetic on uint8 tensors on any device: the plain version of
  the CUDA ``gf_matmul`` kernel and the constant multiplies of Clay's
  couple/uncouple steps.

Field: GF(2^8) with the polynomial x^8+x^4+x^3+x^2+1 (0x11D), the standard
choice of ISA-L / jerasure / Ceph's clay plugin.
"""
from __future__ import annotations

import numpy as np
import torch

POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1 (primitive)
GENERATOR = 2


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]  # wraparound so exp[(la+lb)] needs no mod
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()


# ---------------------------------------------------------------------------
# numpy path
# ---------------------------------------------------------------------------
def mul(a, b):
    """Element-wise GF(2^8) multiply on uint8 numpy arrays (broadcasting)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = EXP_TABLE[LOG_TABLE[a] + LOG_TABLE[b]]
    return np.where((a == 0) | (b == 0), np.uint8(0), out)


def inv(a):
    """Multiplicative inverse (a must be nonzero)."""
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("gf.inv(0)")
    return EXP_TABLE[255 - LOG_TABLE[a]]


def div(a, b):
    return mul(a, inv(b))


def pow_(a: int, e: int) -> int:
    if e == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(int(LOG_TABLE[a]) * e) % 255])


def matmul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product: (M,K) x (K,N) -> (M,N), uint8."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[0]
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for k in range(a.shape[1]):
        col = a[:, k : k + 1]  # (M,1)
        if not col.any():
            continue
        out ^= mul(col, b[k : k + 1, :])
    return out


def mat_inv(a: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination."""
    a = np.array(a, dtype=np.uint8)
    n = a.shape[0]
    assert a.shape == (n, n)
    aug = np.concatenate([a, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = None
        for r in range(col, n):
            if aug[r, col] != 0:
                piv = r
                break
        if piv is None:
            raise np.linalg.LinAlgError("singular GF(256) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = mul(aug[col], inv(aug[col, col]))
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= mul(aug[r, col], aug[col])
    return aug[:, n:]


def solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve a @ x = b over GF(2^8) (a square, invertible)."""
    return matmul_np(mat_inv(a), b)


def vandermonde(rows: int, cols: int, points: np.ndarray | None = None) -> np.ndarray:
    """Vandermonde matrix V[i,j] = points[j]^i; any `rows` distinct columns of a
    row-prefix are invertible, so it serves as an MDS parity-check."""
    if points is None:
        points = np.arange(1, cols + 1, dtype=np.uint8)  # distinct nonzero
    points = np.asarray(points, dtype=np.uint8)
    assert len(points) == cols and len(np.unique(points)) == cols
    v = np.zeros((rows, cols), dtype=np.uint8)
    v[0, :] = 1
    for i in range(1, rows):
        v[i] = mul(v[i - 1], points)
    return v


# ---------------------------------------------------------------------------
# torch path (plain version of the CUDA kernel; carry-less multiply, no tables)
# ---------------------------------------------------------------------------
_RED = POLY & 0xFF  # low 8 bits of the field polynomial


def xtime(b: torch.Tensor) -> torch.Tensor:
    """Multiply every byte of a uint8 tensor by x (= 2) in GF(2^8)."""
    return (b << 1) ^ ((b >> 7) * _RED)


def mul_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Branchless GF(2^8) multiply of uint8 tensors (broadcasting).

    The 8-step shift/xor (Russian peasant) multiply: no tables, no gathers,
    so no index tensor the size of the operands.
    """
    a = torch.as_tensor(a, dtype=torch.uint8)
    b = torch.as_tensor(b, dtype=torch.uint8)
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape), dtype=torch.uint8,
                      device=b.device)
    for _ in range(8):
        acc ^= b * (a & 1)  # a & 1 is 0 or 1: multiply = select, no branch
        a = a >> 1
        b = xtime(b)
    return acc


def mul_const(a: int, x: torch.Tensor) -> torch.Tensor:
    """GF(2^8) multiply of a uint8 tensor by the constant byte ``a``."""
    a = int(a) & 0xFF
    acc = torch.zeros_like(x)
    while a:
        if a & 1:
            acc ^= x
        a >>= 1
        if a:
            x = xtime(x)
    return acc


def matmul_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matrix product on uint8 tensors: (M,K) x (K,N) -> (M,N)."""
    assert a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[0], (a.shape, b.shape)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.uint8, device=b.device)
    for k in range(a.shape[1]):
        out ^= mul_torch(a[:, k : k + 1], b[k : k + 1, :])
    return out
