"""Bulk audit-sample digests: the Hopper kernel and its plain version.

    out (L,) = mix(words (L, W))        xxhash32-style, uint32 wraparound

``sample_hash`` launches ``csrc/sample_hash.cu`` (CUDA C++ for ``sm_90a``,
built by ``kernels/_build.py`` and bound with ``ctypes``) on PyTorch's
current stream; it replaces the JAX package's Pallas kernel
``repro/kernels/sample_hash.py::sample_hash``.  ``sample_hash_ref`` is the
plain PyTorch version of the same function.  PyTorch has no ``+``, ``<<``
or ``>>`` for ``torch.uint32`` on the CPU, so it computes in int64 and
masks to 32 bits; ``kernels/ops.py`` takes it for CPU tensors only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

P1, P2, P3, P4 = 2654435761, 2246822519, 3266489917, 668265263
MASK = 0xFFFFFFFF


def _check(words: torch.Tensor) -> None:
    if not isinstance(words, torch.Tensor):
        raise TypeError(f"sample_hash: words must be a torch.Tensor, got {type(words).__name__}")
    if words.dtype != torch.uint32:
        raise TypeError(f"sample_hash: words must be uint32, got {words.dtype}")
    if words.ndim != 2 or words.shape[0] < 1 or words.shape[1] < 1:
        raise ValueError(f"sample_hash: words must be (L >= 1, W >= 1), got {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError("sample_hash: words must be contiguous")


@functools.cache  # the one cache of the loaded library
def _lib() -> ctypes.CDLL:
    lib = _build.load("sample_hash")
    lib.sample_hash_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_uint, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.sample_hash_launch.restype = ctypes.c_int
    lib.sample_hash_error_string.argtypes = [ctypes.c_int]
    lib.sample_hash_error_string.restype = ctypes.c_char_p
    return lib


def sample_hash(words: torch.Tensor, *, seed: int = 0) -> torch.Tensor:
    """Digests on the card: words (L, W) contiguous uint32 CUDA tensor -> (L,) uint32.

    ``seed`` is taken mod 2^32.  Launches on the current stream without
    synchronising; raises on any input the kernel does not take.
    """
    _check(words)
    if words.device.type != "cuda":
        raise ValueError(f"sample_hash launches a CUDA kernel; got a tensor on {words.device}")
    leaves, w = words.shape
    lib = _lib()
    out = torch.empty(leaves, dtype=torch.uint32, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        sms = torch.cuda.get_device_properties(words.device).multi_processor_count
        err = lib.sample_hash_launch(words.data_ptr(), out.data_ptr(), leaves, w,
                                     seed & MASK, sms, stream)
    if err:
        raise RuntimeError(f"sample_hash launch failed: {lib.sample_hash_error_string(err).decode()}")
    sample_hash.launches += 1
    return out


sample_hash.launches = 0


def _rotl13(acc: torch.Tensor) -> torch.Tensor:
    return ((acc << 13) | (acc >> 19)) & MASK


def sample_hash_ref(words: torch.Tensor, *, seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`sample_hash` (same checks, any device)."""
    _check(words)
    cols = words.view(torch.int32).to(torch.int64) & MASK
    acc = torch.full((words.shape[0],), ((seed & MASK) + P4) & MASK, dtype=torch.int64,
                     device=words.device)
    for i in range(words.shape[1]):
        acc = (acc + cols[:, i] * P2) & MASK  # int64 wraps mod 2^64: low 32 bits exact
        acc = (_rotl13(acc) * P1) & MASK
    acc ^= acc >> 15
    acc = (acc * P2) & MASK
    acc ^= acc >> 13
    acc = (acc * P3) & MASK
    acc ^= acc >> 16
    # to uint32 through int32's two's complement (CPU torch has no int64 -> uint32 wrap)
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32).view(torch.uint32)
