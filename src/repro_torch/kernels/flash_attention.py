"""Fused attention with explicit positions: the Hopper kernel and its plain version.

    o (B, Sq, H, hd) = softmax(scale * q k^T + mask) v,   k, v: (B, Sk, Hkv, hd)

Query head ``h`` reads kv head ``h // (H // Hkv)`` (GQA).  Query ``i`` sees key
``j`` when ``(not causal or qpos[i] >= kpos[j])`` and, for ``window > 0``,
``qpos[i] - kpos[j] < window``; a hidden score is -1e30, as in the JAX
package.  Positions default to ``arange``: then ``causal=True`` is the
Pallas kernel's causal mask, and a one-token decode against a cache is
``Sq = 1`` with ``q_positions = [pos]``.

``flash_attention`` launches ``csrc/flash_attention.cu`` (CUDA C++ for
``sm_90a``, built by ``kernels/_build.py`` and bound with ``ctypes``) on
PyTorch's current stream; it replaces the JAX package's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_fused`` and computes the
attention of ``repro/models/layers.py::flash_attention`` and
``::decode_attention``.  ``flash_attention_ref`` is the plain PyTorch version
(naive softmax in f32, as ``repro/kernels/ref.py::flash_attention_ref``,
extended by positions and window); ``kernels/ops.py`` takes it for CPU
tensors only.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
DTYPES = (torch.bfloat16, torch.float32)


def _positions(pos: torch.Tensor | None, n: int, device: torch.device) -> torch.Tensor:
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    pos = torch.as_tensor(pos, device=device)
    if pos.shape != (n,):
        raise ValueError(f"flash_attention: positions must have shape ({n},), got {tuple(pos.shape)}")
    if pos.dtype.is_floating_point or pos.dtype == torch.bool:
        raise TypeError(f"flash_attention: positions must be integers, got {pos.dtype}")
    return pos.to(torch.int32).contiguous()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention: {name} must be a torch.Tensor, got {type(t).__name__}")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got shape {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype must be one of {DTYPES}, got {q.dtype}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes differ: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} (hd_v != hd is not supported)")
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"flash_attention: {h} query heads are not a multiple of {hkv} kv heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim must be in [1, {MAX_HEAD_DIM}], got {hd}")


@functools.cache  # the one cache of the loaded library
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions=None, k_positions=None, causal: bool = True,
                    window: int = 0, scale: float | None = None) -> torch.Tensor:
    """Attention on the card: contiguous bf16 or f32 CUDA tensors, any Sq and Sk.

    Launches on the current stream without synchronising; raises on any
    input the kernel does not take (never falls back).
    """
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches a CUDA kernel; got tensors on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qp = _positions(q_positions, sq, q.device)
    kp = _positions(k_positions, sk, q.device)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    lib = _lib()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(),
            out.data_ptr(), b, sq, sk, h, hkv, hd, scale, int(causal), int(window),
            int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.flash_attention_error_string(err).decode()}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def visible(q_positions: torch.Tensor, k_positions: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """(Sq, Sk) bool: which key each query sees."""
    diff = q_positions.to(torch.int64)[:, None] - k_positions.to(torch.int64)[None, :]
    vis = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
    if window > 0:
        vis &= diff < window
    return vis


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_positions=None, k_positions=None, causal: bool = True,
                        window: int = 0, scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention` (same checks, any device)."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qp = _positions(q_positions, sq, q.device)
    kp = _positions(k_positions, sk, q.device)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qr = q.reshape(b, sq, hkv, g, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) * scale
    s = s.masked_fill(~visible(qp, kp, causal, window), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)
