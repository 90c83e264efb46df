"""The gradient of fused attention: the Hopper kernel and its plain version.

    dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, ...)

for ``o = flash_attention(q, k, v, ...)`` (``kernels/flash_attention.py``)
with the same positions, mask and scale, and ``lse`` (B, H, Sq) f32 the
forward's row log-sum-exp of the scaled, masked scores (-1e30 for a row that
sees no key).  ``dk`` and ``dv`` of kv head j sum over its g query heads.

The JAX package has no backward kernel: it differentiates its pure-JAX
chunked attention (``repro/models/layers.py::flash_attention``) with XLA's
autodiff.  The port's forward is a hand-written kernel, so its gradient is
one too: ``csrc/flash_attention_bwd.cu`` (CUDA C++ for ``sm_90a``, built by
``kernels/_build.py``, bound with ``ctypes``), launched on PyTorch's current
stream by :func:`flash_attention_bwd` for bf16 inputs with head_dim a
multiple of 16 (at most 256), which covers every configuration of the repo;
it raises on anything else and never falls back.  Its C launcher picks the
design by head_dim: ``"wgmma"`` (TMA-fed warpgroup products, head_dim up to
``WGMMA_MAX_HEAD_DIM``) or ``"mma"`` (the first design, above it); each
launch is counted in ``flash_attention_bwd.design_launches``.
``flash_attention_bwd_ref`` is the plain PyTorch version (P recomputed from
``lse`` in f32); ``kernels/ops.py`` takes it for CPU tensors only.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (MAX_HEAD_DIM, _check, _live_keys, _positions,
                                                 visible)


DESIGNS = ("wgmma", "mma")  # csrc/flash_attention_bwd.cu's flash_attention_bwd_design(hd)
WGMMA_MAX_HEAD_DIM = 128  # the launcher's kWgmmaMaxHeadDim


def design(hd: int) -> str:
    """The design the launcher takes for head dim ``hd``: ``"wgmma"`` up to
    ``WGMMA_MAX_HEAD_DIM`` (every configuration of the repo), ``"mma"`` above."""
    return DESIGNS[0] if hd <= WGMMA_MAX_HEAD_DIM else DESIGNS[1]


def kernel_takes(dtype: torch.dtype, hd: int) -> bool:
    """Whether the backward kernel takes such inputs: bf16, head_dim a
    multiple of 16 and at most ``MAX_HEAD_DIM``."""
    return dtype == torch.bfloat16 and hd % 16 == 0 and 16 <= hd <= MAX_HEAD_DIM


@functools.cache  # the one cache of the loaded library
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    # q k v o do lse qpos kpos dq dk dv scratch, b sq sk h hkv hd scale causal window, stream
    lib.flash_attention_bwd_launch.argtypes = [p] * 12 + [i] * 6 + [ctypes.c_float, i, i, p]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_scratch_bytes.argtypes = [i] * 5  # b sq sk h hd
    lib.flash_attention_bwd_scratch_bytes.restype = ctypes.c_longlong
    lib.flash_attention_bwd_design.argtypes = [i]
    lib.flash_attention_bwd_design.restype = i
    lib.flash_attention_bwd_config.argtypes = [i, ctypes.POINTER(i)]
    lib.flash_attention_bwd_config.restype = None
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_bwd(q, k, v, o, do, lse) -> None:
    _check(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, q is {tuple(q.shape)} {q.dtype} on {q.device}")
    b, sq, h, _ = q.shape
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be ({b}, {h}, {sq}) float32 on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on {lse.device}")


ROW_TILE = 64  # the launcher's kRowTile: queries per statistics tile
KEY_TILE = 64  # kKeyTile: keys per wgmma warpgroup and per dQ stage
DKDV_KEYS = 128  # kDkdvKeys: keys per dK/dV block
DQ_ROWS = 128  # kDqRows: queries per dQ block
STAT_WORDS = 3 * ROW_TILE  # kStatWords: a query tile's lse in base 2, D, positions


def scratch_bytes(b: int, sq: int, sk: int, h: int, hd: int) -> int:
    """``flash_attention_bwd_scratch_bytes`` of the launcher, mirrored for the
    meta device: for "wgmma" the statistics of every (batch, head, query
    tile), their ranges and blindness (16 bytes each), the key positions
    and every key tile's range (8 bytes); for "mma" D (b, h, sq) f32."""
    if design(hd) != "wgmma":
        return 4 * b * h * sq
    tiles = b * h * -(-sq // ROW_TILE)
    key_tiles = -(-sk // KEY_TILE)
    return tiles * STAT_WORDS * 4 + tiles * 16 + key_tiles * KEY_TILE * 4 + key_tiles * 8


def _allocate(q, k, v, q_positions, k_positions, nbytes: int):
    """What a launch allocates, on the card and (for the dry-run) on the meta
    device alike: the positions (int32), dq, dk, dv and ``nbytes`` of scratch
    (rowsum(dO * O) and the tiles' statistics, written by the launch's first
    kernel).  Returns (qpos, kpos, dq, dk, dv, scratch)."""
    qp = _positions(q_positions, q.shape[1], q.device)
    kp = _positions(k_positions, k.shape[1], q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
    return qp, kp, dq, dk, dv, scratch


def flops(b: int, sq: int, sk: int, h: int, hkv: int, hd: int, causal: bool,
          window: int) -> float:
    """The operations a launch performs: 2 * hd per product for every
    (query, key) pair and query head of each tile pair it walks, 4 products
    (S, dP, dV, dK) in the dK/dV kernel over blocks of ``DKDV_KEYS`` keys and
    query tiles of ``ROW_TILE``, 3 (S, dP, dQ) in the dQ kernel over blocks of
    ``DQ_ROWS`` queries and key tiles of ``KEY_TILE`` (the "mma" design: 64 x
    64 for both), with the queries at the last Sq of Sk positions.  A tile
    pair that every pair hides is skipped, as the kernels skip it; masked
    pairs inside a walked tile pair count."""
    def walked(q_block: int, k_block: int) -> float:
        q0 = np.arange(0, sq, q_block, dtype=np.int64)
        n = np.minimum(q_block, sq - q0)
        keys = _live_keys(sk - sq + q0, sk - sq + q0 + n - 1, sk, causal, window, k_block)
        return float((n * keys).sum())

    if design(hd) == "wgmma":
        pairs = 4 * walked(ROW_TILE, DKDV_KEYS) + 3 * walked(DQ_ROWS, KEY_TILE)
    else:
        pairs = 7 * walked(64, 64)
    return 2.0 * hd * b * h * pairs


def flash_attention_bwd_meta(q, k, v, o, do, lse, *, q_positions=None, k_positions=None,
                             causal: bool = True, window: int = 0, scale: float | None = None):
    """The launch on the meta device, for the dry-run: the same checks and the
    same allocations as :func:`flash_attention_bwd` (scratch by
    :func:`scratch_bytes`), and no kernel.  Returns (dq, dk, dv, operations
    by :func:`flops`)."""
    _check_bwd(q, k, v, o, do, lse)
    if q.device.type != "meta":
        raise ValueError(f"flash_attention_bwd_meta takes meta tensors; got {q.device}")
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if not kernel_takes(q.dtype, hd):
        raise ValueError(f"flash_attention_bwd takes bf16 with head_dim a multiple of 16 in "
                         f"[16, {MAX_HEAD_DIM}]; got {q.dtype}, head_dim {hd}")
    _, _, dq, dk, dv, _ = _allocate(q, k, v, q_positions, k_positions,
                                    scratch_bytes(b, sq, sk, h, hd))
    return dq, dk, dv, flops(b, sq, sk, h, hkv, hd, causal, window)


def flash_attention_bwd(q, k, v, o, do, lse, *, q_positions=None, k_positions=None,
                        causal: bool = True, window: int = 0, scale: float | None = None):
    """(dq, dk, dv) on the card: contiguous, 16-byte aligned bf16 CUDA tensors
    with head_dim a multiple of 16.  Launches the kernels on the current
    stream without synchronising; raises on any input they do not take."""
    _check_bwd(q, k, v, o, do, lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd launches a CUDA kernel; got tensors on {q.device}")
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if not kernel_takes(q.dtype, hd):
        raise ValueError(f"flash_attention_bwd takes bf16 with head_dim a multiple of 16 in "
                         f"[16, {MAX_HEAD_DIM}]; got {q.dtype}, head_dim {hd}")
    tensors = (q, k, v, o, do, lse)
    for name, t in zip(("q", "k", "v", "o", "do", "lse"), tensors):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be 16-byte aligned")
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    lib = _lib()
    qp, kp, dq, dk, dv, scratch = _allocate(q, k, v, q_positions, k_positions,
                                            lib.flash_attention_bwd_scratch_bytes(b, sq, sk, h, hd))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_launch(
            *(t.data_ptr() for t in tensors), qp.data_ptr(), kp.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, sq, sk, h, hkv, hd, scale,
            int(causal), int(window), stream)
    if err:
        raise RuntimeError("flash_attention_bwd launch failed: "
                           f"{lib.flash_attention_bwd_error_string(err).decode()}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.design_launches[DESIGNS[lib.flash_attention_bwd_design(hd)]] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0  # one per call: the three kernels of a design together
flash_attention_bwd.design_launches = dict.fromkeys(DESIGNS, 0)


def reset_launches() -> None:
    """Set the backward's launch counts to 0."""
    flash_attention_bwd.launches = 0
    flash_attention_bwd.design_launches = dict.fromkeys(DESIGNS, 0)


def kernel_config(hd: int) -> dict:
    """The launcher's tiles at head dim ``hd`` (builds the library): the design,
    keys per dK/dV block, queries per tile it walks and its stages, rows per
    dQ block, keys per tile it walks and its stages, threads per block."""
    out = (ctypes.c_int * 8)()
    _lib().flash_attention_bwd_config(hd, out)
    keys = ("design", "dkdv_keys", "dkdv_query_tile", "dkdv_stages", "dq_rows", "dq_key_tile",
            "dq_stages", "threads")
    cfg = dict(zip(keys, out))
    cfg["design"] = DESIGNS[cfg["design"]]
    return cfg


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, q_positions=None, k_positions=None,
                            causal: bool = True, window: int = 0, scale: float | None = None):
    """Plain PyTorch version of :func:`flash_attention_bwd` (same checks, any
    device): P = exp(s - lse) in f32 over the visible pairs, 1/Sk over every
    key for a row that sees none (no score gradient there)."""
    _check_bwd(q, k, v, o, do, lse)
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qp = _positions(q_positions, sq, q.device)
    kp = _positions(k_positions, sk, q.device)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    vis = visible(qp, kp, causal, window)  # (Sq, Sk)
    blind = ~vis.any(1)  # rows that see no key
    qf = q.reshape(b, sq, hkv, g, hd).float()
    kf, vf = k.float(), v.float()
    dof = do.reshape(b, sq, hkv, g, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    lse_r = lse.reshape(b, hkv, g, sq, 1)
    p = torch.where(vis, torch.exp(s - lse_r), torch.zeros((), device=q.device))
    p = torch.where(blind[:, None], torch.full((), 1.0 / sk, device=q.device), p)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    delta = (do.float() * o.float()).sum(-1)  # (B, Sq, H)
    delta = delta.reshape(b, sq, hkv, g).permute(0, 2, 3, 1)[..., None]
    ds = torch.where(vis & ~blind[:, None], p * (dp - delta), torch.zeros((), device=q.device))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
