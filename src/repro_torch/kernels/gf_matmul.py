"""GF(2^8) matrix multiply for erasure coding: the Hopper kernel and its plain version.

    C (M, N) = A (M, K)  (x)  B (K, N)      over GF(2^8), polynomial 0x11D

``gf_matmul`` launches ``csrc/gf_matmul.cu`` (CUDA C++ for ``sm_90a``, built
by ``kernels/_build.py`` and bound with ``ctypes``) on PyTorch's current
stream; it replaces the JAX package's Pallas kernel
``repro/kernels/gf_matmul.py::gf_matmul``.  ``gf_matmul_ref`` is the plain
PyTorch version of the same function (the 8-step shift/xor multiply of
``core/gf.py``); ``kernels/ops.py`` takes it for CPU tensors only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import gf
from repro_torch.kernels import _build

MAX_DIM = 32  # largest M and K the kernel accepts


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"gf_matmul: {name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dtype != torch.uint8:
            raise TypeError(f"gf_matmul: {name} must be uint8, got {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"gf_matmul: {name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"gf_matmul: {name} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"gf_matmul: a on {a.device} but b on {b.device}")
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"gf_matmul: inner dimensions differ: {tuple(a.shape)} x {tuple(b.shape)}")
    if not (1 <= m <= MAX_DIM and 1 <= k <= MAX_DIM and n >= 1):
        raise ValueError(
            f"gf_matmul: needs 1 <= M, K <= {MAX_DIM} and N >= 1, got M={m} K={k} N={n}"
        )


@functools.cache  # the one cache of the loaded library
def _lib() -> ctypes.CDLL:
    lib = _build.load("gf_matmul")
    lib.gf_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.gf_matmul_launch.restype = ctypes.c_int
    lib.gf_matmul_error_string.argtypes = [ctypes.c_int]
    lib.gf_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _allocate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """What a launch allocates, on the card and on the meta device alike: C."""
    return torch.empty((a.shape[0], b.shape[1]), dtype=torch.uint8, device=b.device)


def flops(m: int, k: int, n: int) -> float:
    """The operations of C = A (x) B: a GF(2^8) multiply and an xor per term."""
    return 2.0 * m * k * n


def gf_matmul_meta(a: torch.Tensor, b: torch.Tensor):
    """The launch on the meta device: the same checks and allocation as
    :func:`gf_matmul`, no kernel.  Returns (C, operations by :func:`flops`)."""
    _check(a, b)
    if b.device.type != "meta":
        raise ValueError(f"gf_matmul_meta takes meta tensors; got tensors on {b.device}")
    return _allocate(a, b), flops(a.shape[0], a.shape[1], b.shape[1])


def gf_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A (x) B on the card: a (M, K), b (K, N) contiguous uint8 CUDA tensors.

    Launches on the current stream without synchronising; raises on any
    input the kernel does not take (never falls back).
    """
    _check(a, b)
    if b.device.type != "cuda":
        raise ValueError(f"gf_matmul launches a CUDA kernel; got tensors on {b.device}")
    (m, k), n = a.shape, b.shape[1]
    lib = _lib()
    c = _allocate(a, b)
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        sms = torch.cuda.get_device_properties(b.device).multi_processor_count
        err = lib.gf_matmul_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, k, n, sms, stream)
    if err:
        raise RuntimeError(f"gf_matmul launch failed: {lib.gf_matmul_error_string(err).decode()}")
    gf_matmul.launches += 1
    return c


gf_matmul.launches = 0


def gf_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gf_matmul` (same checks, any device)."""
    _check(a, b)
    return gf.matmul_torch(a, b)
