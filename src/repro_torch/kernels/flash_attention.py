"""Fused attention with explicit positions: the Hopper kernel and its plain version.

    o (B, Sq, H, hd) = softmax(scale * q k^T + mask) v,   k, v: (B, Sk, Hkv, hd)

Query head ``h`` reads kv head ``h // (H // Hkv)`` (GQA).  Query ``i`` sees key
``j`` when ``(not causal or qpos[i] >= kpos[j])`` and, for ``window > 0``,
``qpos[i] - kpos[j] < window``; a hidden score is -1e30, as in the JAX
package.  Positions default to ``arange``: then ``causal=True`` is the
Pallas kernel's causal mask, and a one-token decode against a cache is
``Sq = 1`` with ``q_positions = [pos]``.

``flash_attention`` launches one of the kernels of ``csrc/flash_attention.cu``
(CUDA C++ for ``sm_90a``, built by ``kernels/_build.py`` and bound with
``ctypes``) on PyTorch's current stream, as :func:`choose_variant` rules:
``"tile"`` (tensor-core tiles of 64 (query, head) rows: prefill-shaped
calls), ``"split"`` (split over keys with a combine: decode) or
``"general"`` (the CUDA-core kernel: f32, other head dims).  It replaces
the JAX package's Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_fused`` and computes the
attention of ``repro/models/layers.py::flash_attention`` and
``::decode_attention``.  ``flash_attention_ref`` is the plain PyTorch version
(naive softmax in f32, as ``repro/kernels/ref.py::flash_attention_ref``,
extended by positions and window); ``kernels/ops.py`` takes it for CPU
tensors only.

For training, :func:`flash_attention_lse` also returns each row's
log-sum-exp (B, H, Sq) f32, the statistics the backward kernel
(``kernels/flash_attention_bwd.py``) recomputes P from: the kernel that
:func:`choose_variant` names writes it ("tile"; "split" for decode's few
rows, whose partial attention over a rank's shard of a sequence-sharded
cache combines across ranks by it; "general" for what the tensor-core
kernels do not take); ``flash_attention_lse_ref`` is its plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
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


# The dispatch rule between the hand-written kernels (csrc/flash_attention.cu)
VARIANTS = ("tile", "split", "general")
KV_TILE = 64      # keys per K/V tile of "tile" and "split"
TILE_ROWS = 64    # (query, head) rows of a "tile" block; fewer rows per kv head go to "split"
SPLIT_ROWS = 16   # rows of a "split" block
BLOCKS_PER_SM = 2  # "split" aims at this many blocks on each SM ...
MAX_TILES_PER_SPLIT = 4  # ... and at most this many tiles per block: one per warp, whose skip
                         # states the split kernel works out up front (it refuses more)


def tensor_cores_take(dtype: torch.dtype, hd: int, aligned: bool = True) -> bool:
    """Whether the tensor-core kernels ("tile", "split") take such inputs:
    bf16, head_dim a multiple of 16, 16-byte aligned tensors."""
    return dtype == torch.bfloat16 and hd % 16 == 0 and hd <= MAX_HEAD_DIM and aligned


def choose_variant(dtype: torch.dtype, sq: int, h: int, hkv: int, hd: int,
                   aligned: bool = True) -> str:
    """Which kernel takes the call: ``"tile"`` (tensor cores, many queries),
    ``"split"`` (tensor cores, split over keys: fewer than ``TILE_ROWS``
    (query, head) rows per kv head, as in decode) or ``"general"`` (the
    CUDA-core kernel, for what the tensor-core kernels do not take)."""
    if not tensor_cores_take(dtype, hd, aligned):
        return "general"
    return "split" if sq * (h // hkv) < TILE_ROWS else "tile"


def split_plan(sk: int, b: int, hkv: int, rows: int, sms: int) -> tuple[int, int]:
    """(splits, tiles per split) of a "split" call: enough splits that the
    grid puts ``BLOCKS_PER_SM`` blocks on every SM and no block walks more
    than ``MAX_TILES_PER_SPLIT`` tiles (a block keeps one tile in flight, so
    a long walk is latency-bound), no more splits than tiles; each split a
    contiguous run of ``KV_TILE``-key tiles."""
    tiles = -(-sk // KV_TILE)
    blocks = b * hkv * -(-rows // SPLIT_ROWS)
    want = min(tiles, max(-(-BLOCKS_PER_SM * sms // blocks), -(-tiles // MAX_TILES_PER_SPLIT)))
    per = -(-tiles // want)
    return -(-tiles // per), per


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache  # the one cache of the loaded library
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    shape = [i, i, i, i, i, i, ctypes.c_float, i, i]  # b sq sk h hkv hd scale causal window
    lib.flash_attention_launch.argtypes = [p] * 7 + shape + [i, p]  # q k v qpos kpos o lse
    lib.flash_attention_tile_launch.argtypes = [p] * 7 + shape + [p]
    lib.flash_attention_split_launch.argtypes = [p] * 10 + shape + [i, i, p]  # ... acc lse
    for fn in (lib.flash_attention_launch, lib.flash_attention_tile_launch,
               lib.flash_attention_split_launch):
        fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _variant(q: torch.Tensor, k: torch.Tensor, aligned: bool = True) -> str:
    """The kernel a call without a named variant takes (each writes lse when asked)."""
    b, sq, h, hd = q.shape
    return choose_variant(q.dtype, sq, h, k.shape[2], hd, aligned)


def _allocate(variant: str, q: torch.Tensor, k: torch.Tensor, q_positions, k_positions,
              with_lse: bool, sms: int):
    """What a launch allocates, on the card and (for the dry-run) on the meta
    device alike: the positions (int32), the output, the row log-sum-exp
    (training) and, for a "split" call over more than one split, the (m, l)
    and accumulator partials of every split that the combine kernel merges.
    Returns (qpos, kpos, out, lse or None, (splits, tiles per split, ml, acc))."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qp = _positions(q_positions, sq, q.device)
    kp = _positions(k_positions, sk, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    splits = per = 0
    ml = acc = None
    if variant == "split":
        rows = sq * (h // hkv)
        splits, per = split_plan(sk, b, hkv, rows, sms)
        if splits > 1:  # (m, l, acc) of every split, merged by the combine kernel
            ml = torch.empty((2, b, hkv, splits, rows), dtype=torch.float32, device=q.device)
            acc = torch.empty((b, hkv, splits, rows, hd), dtype=torch.float32, device=q.device)
    return qp, kp, out, lse, (splits, per, ml, acc)


BLOCK_ROWS = {"tile": 64, "split": SPLIT_ROWS, "general": 16}  # (query, head) rows per block
H100_SMS = 132  # the H100 SXM's SMs: "split"'s plan on the meta device


def _live_keys(qmin, qmax, sk: int, causal: bool, window: int, tile: int = KV_TILE):
    """Keys in the tiles of ``tile`` keys a block whose queries sit at
    positions [qmin, qmax] walks (numpy arrays over blocks), keys at
    positions 0 .. sk - 1: a tile is skipped when every pair in it is
    hidden, by the causal mask (its first key after qmax) or the window
    (its last key at or before qmin - window)."""
    tiles = -(-sk // tile)
    last = np.full_like(qmax, tiles - 1)
    if causal:
        last = np.minimum(last, qmax // tile)
    first = np.zeros_like(qmin)
    if window > 0:
        first = np.maximum(first, (qmin - window + 1) // tile)
    keys = np.minimum(sk, (last + 1) * tile) - first * tile
    return np.where(last >= first, keys, 0)


def flops(variant: str, b: int, sq: int, sk: int, h: int, hkv: int, hd: int, causal: bool,
          window: int) -> float:
    """The operations a forward launch performs: 4 * hd (Q K^T and P V) for
    every (query, head) row and every key of each K/V tile the row's block
    walks, with the queries at the last Sq of Sk positions and the keys at
    0 .. Sk - 1 (training, prefill, and decode at the cache's last slot).
    "tile" and "split" skip a tile that every pair of the block hides, as
    ``csrc/flash_attention.cu``'s ``next_live`` does; "general" walks every
    tile.  Masked pairs inside a walked tile count; rows a partial block
    pads with do not."""
    g = h // hkv
    rows = sq * g
    per = BLOCK_ROWS[variant]
    r0 = np.arange(0, rows, per, dtype=np.int64)
    n = np.minimum(per, rows - r0)
    qmin = sk - sq + r0 // g
    qmax = sk - sq + (r0 + n - 1) // g
    if variant == "general":
        keys = np.full_like(r0, sk)
    else:
        keys = _live_keys(qmin, qmax, sk, causal, window)
    return 4.0 * hd * b * hkv * float((n * keys).sum())


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         q_positions=None, k_positions=None, causal: bool = True,
                         window: int = 0, scale: float | None = None, with_lse: bool = False):
    """The launch on the meta device, for the dry-run: the same checks and the
    same allocations as :func:`flash_attention` (or :func:`flash_attention_lse`),
    "split"'s planned for an H100's ``H100_SMS``, and no kernel.  Returns
    (out, lse or None, operations by :func:`flops`)."""
    _check(q, k, v)
    if q.device.type != "meta":
        raise ValueError(f"flash_attention_meta takes meta tensors; got tensors on {q.device}")
    b, sq, h, hd = q.shape
    variant = _variant(q, k)
    _, _, out, lse, _ = _allocate(variant, q, k, q_positions, k_positions, with_lse, H100_SMS)
    return out, lse, flops(variant, b, sq, k.shape[1], h, k.shape[2], hd, causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions=None, k_positions=None, causal: bool = True,
                    window: int = 0, scale: float | None = None) -> torch.Tensor:
    """Attention on the card: contiguous bf16 or f32 CUDA tensors, any Sq and Sk.

    Launches the kernel that :func:`choose_variant` names on the current
    stream without synchronising; raises on any input the kernels do not
    take (never falls back).
    """
    return _launch(None, q, k, v, q_positions, k_positions, causal, window, scale)


def flash_attention_variant(variant: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            q_positions=None, k_positions=None, causal: bool = True,
                            window: int = 0, scale: float | None = None) -> torch.Tensor:
    """:func:`flash_attention` through the named kernel, one of ``VARIANTS``;
    raises if that kernel does not take the input."""
    if variant not in VARIANTS:
        raise ValueError(f"flash_attention: variant must be one of {VARIANTS}, got {variant!r}")
    return _launch(variant, q, k, v, q_positions, k_positions, causal, window, scale)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_positions=None, k_positions=None, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """(o, lse) on the card: :func:`flash_attention` through the kernel
    :func:`choose_variant` names ("tile", "split" or "general"), which also
    writes each row's log-sum-exp, lse (B, H, Sq) f32 (-1e30 for a row that
    sees no key)."""
    return _launch(None, q, k, v, q_positions, k_positions, causal, window, scale,
                   with_lse=True)


def _launch(variant, q, k, v, q_positions, k_positions, causal, window, scale,
            with_lse: bool = False):
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches a CUDA kernel; got tensors on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    aligned = (ptrs[0] | ptrs[1] | ptrs[2]) % 16 == 0
    if variant is None:
        variant = _variant(q, k, aligned)
    elif variant != "general" and not tensor_cores_take(q.dtype, hd, aligned):
        raise ValueError(f"flash_attention: the {variant!r} kernel takes 16-byte aligned bf16 "
                         f"with head_dim a multiple of 16; got {q.dtype}, head_dim {hd}")
    qp, kp, out, lse, (splits, per, ml, acc) = _allocate(
        variant, q, k, q_positions, k_positions, with_lse, _sm_count(q.device.index or 0))
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    lib = _lib()
    args = (*ptrs, qp.data_ptr(), kp.data_ptr(), out.data_ptr())
    lse_ptr = None if lse is None else lse.data_ptr()  # null: no lse (serving)
    shape = (b, sq, sk, h, hkv, hd, scale, int(causal), int(window))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "tile":
            err = lib.flash_attention_tile_launch(*args, lse_ptr, *shape, stream)
        elif variant == "split":
            part = (0, 0, 0)
            if ml is not None:
                part = (ml[0].data_ptr(), ml[1].data_ptr(), acc.data_ptr())
            err = lib.flash_attention_split_launch(*args, *part, lse_ptr, *shape, splits, per,
                                                   stream)
        else:
            err = lib.flash_attention_launch(*args, lse_ptr, *shape,
                                             int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.flash_attention_error_string(err).decode()}")
    flash_attention.launches += 1
    flash_attention.variant_launches[variant] += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0  # every launch; the sum of variant_launches
flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)


def reset_launches() -> None:
    """Set every launch count of the attention kernels to 0."""
    flash_attention.launches = 0
    flash_attention.variant_launches = dict.fromkeys(VARIANTS, 0)


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
    return flash_attention_lse_ref(q, k, v, q_positions=q_positions, k_positions=k_positions,
                                   causal=causal, window=window, scale=scale)[0]


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            q_positions=None, k_positions=None, causal: bool = True,
                            window: int = 0, scale: float | None = None):
    """Plain PyTorch version of :func:`flash_attention_lse`: (o, lse)."""
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
    lse = torch.logsumexp(s, dim=-1).reshape(b, h, sq)  # -1e30 (rounded) where no key is seen
    return o.reshape(b, sq, h, hd).to(q.dtype), lse
