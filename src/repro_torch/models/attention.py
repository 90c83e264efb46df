"""GQA/MHA attention module: parameter specs and the train, prefill and
decode paths, as in ``repro/models/attention.py``.

The q/k/v/o projections are plain products (``torch.einsum``); the
attention itself is ``layers.flash_attention`` (full sequences, with a
hand-written backward kernel under autograd) or ``layers.decode_attention``,
both of which run the hand-written kernels on the card.  The KV cache is
updated in place (the JAX package donates the cache buffer to the same
effect).  Cross-attention (the encoder-decoder's) takes its keys and values
from ``kv_source`` and runs non-causal with Sq != Sk.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (MaskSpec, apply_norm, apply_rope, cast, decode_attention,
                                       flash_attention)
from repro_torch.sharding import ParamSpec

UNWRITTEN = 2**30  # the position of a ring-buffer slot not written yet


def attn_specs(cfg, layers: int | None = None, cross: bool = False) -> dict[str, ParamSpec]:
    """q/k/v/o projections (and biases); ``cross`` changes nothing, as in the
    JAX package: cross-attention's tree has the same leaves."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    lead = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    out = {
        "wq": ParamSpec(lead + (d, h, hd), lax_ + ("embed", "heads", "head_dim"), init="scaled"),
        "wk": ParamSpec(lead + (d, hkv, hd), lax_ + ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wv": ParamSpec(lead + (d, hkv, hd), lax_ + ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wo": ParamSpec(lead + (h, hd, d), lax_ + ("heads", "head_dim", "embed"), init="scaled"),
    }
    if cfg.use_bias:
        out["bq"] = ParamSpec(lead + (h, hd), lax_ + ("heads", "head_dim"), init="zeros")
        out["bk"] = ParamSpec(lead + (hkv, hd), lax_ + ("kv_heads", "head_dim"), init="zeros")
        out["bv"] = ParamSpec(lead + (hkv, hd), lax_ + ("kv_heads", "head_dim"), init="zeros")
        out["bo"] = ParamSpec(lead + (d,), lax_ + ("embed_act",), init="zeros")
    return out


def _qkv(params, x: torch.Tensor, kv_source=None):
    kv_in = x if kv_source is None else kv_source
    q = torch.einsum("bsd,dhk->bshk", x, cast(params["wq"]))
    k = torch.einsum("bsd,dhk->bshk", kv_in, cast(params["wk"]))
    v = torch.einsum("bsd,dhk->bshk", kv_in, cast(params["wv"]))
    if "bq" in params:
        q = q + cast(params["bq"])
        k = k + cast(params["bk"])
        v = v + cast(params["bv"])
    if "q_norm" in params:  # qwen3-style per-head q/k RMSNorm, over head_dim
        q = apply_norm({"scale": params["q_norm"]}, q, "rmsnorm")
        k = apply_norm({"scale": params["k_norm"]}, k, "rmsnorm")
    return q, k, v


def _out(params, o: torch.Tensor) -> torch.Tensor:
    res = torch.einsum("bshk,hkd->bsd", o, cast(params["wo"]))
    if "bo" in params:
        res = res + cast(params["bo"])
    return res


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)  # int32: the kernel's type


def attn_full(params, x: torch.Tensor, cfg, *, positions=None, mask: MaskSpec | None = None,
              rope: bool = True, kv_source=None, kv_positions=None, ctx=None) -> torch.Tensor:
    """Training / encoder path over a full sequence: x (B, S, D) -> (B, S, D).
    ``kv_source`` (B, Sk, D): cross-attention, keys and values projected from
    it (the JAX package passes ``rope=False`` and a non-causal mask).  The
    query heads read the K and V heads that ``ctx.kv_heads`` gives (all)."""
    s = x.shape[1]
    mask = mask or MaskSpec(causal=True)
    q, k, v = _qkv(params, x, kv_source)
    positions = _arange(s, x.device) if positions is None else positions
    kv_positions = _arange(k.shape[1], x.device) if kv_positions is None else kv_positions
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    if ctx is not None:
        k, v = ctx.kv_heads(q, k, v)
    o = flash_attention(q, k, v, mask=mask, q_positions=positions, k_positions=kv_positions)
    return _out(params, o)


def attn_prefill(params, x: torch.Tensor, cfg, *, mask: MaskSpec | None = None,
                 rope: bool = True, ctx=None):
    """Like :func:`attn_full`, also returning the populated KV cache
    ``{"k", "v"}`` (B, S, Hkv, hd), k after RoPE, as the JAX package's."""
    mask = mask or MaskSpec(causal=True)
    q, k, v = _qkv(params, x)
    positions = _arange(x.shape[1], x.device)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    ka, va = (k, v) if ctx is None else ctx.kv_heads(q, k, v)
    o = flash_attention(q, ka, va, mask=mask, q_positions=positions, k_positions=positions)
    return _out(params, o), {"k": k, "v": v}


def cache_update(cache: torch.Tensor, new: torch.Tensor, slot: int) -> torch.Tensor:
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at ``slot``, in place."""
    cache[:, slot] = new[:, 0]
    return cache


def init_cache_shape(cfg, batch: int, cache_len: int) -> tuple[int, int, int, int]:
    return (batch, cache_len, cfg.num_kv_heads, cfg.head_dim_)


def ring_positions(pos: int, s_cache: int, device) -> torch.Tensor:
    """Absolute position held in each slot of a ring buffer after writing
    ``pos`` at slot ``pos % s_cache``; ``UNWRITTEN`` for a slot not written yet."""
    idx = torch.arange(s_cache, dtype=torch.int32, device=device)  # int32: the kernel's type
    k_positions = idx + s_cache * ((pos - idx + s_cache) // s_cache) - s_cache
    return torch.where(k_positions < 0, UNWRITTEN, k_positions)


def attn_decode(params, x: torch.Tensor, cache, pos: int, cfg, *, window: int = 0, ctx=None):
    """x: (B, 1, D); cache: {'k','v'}: (B, S, Hkv, hd); pos: the current position.

    Uses a ring buffer when ``window > 0`` (slot = pos % S), otherwise writes
    at ``pos``.  Returns (out, cache), the cache updated in place.
    """
    q, k, v = _qkv(params, x)
    posv = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    s_cache = cache["k"].shape[1]
    slot = pos % s_cache if window else pos
    k_new = cache_update(cache["k"], k, slot)
    v_new = cache_update(cache["v"], v, slot)
    if window:
        k_positions = ring_positions(pos, s_cache, x.device)
    else:
        k_positions = torch.arange(s_cache, dtype=torch.int32, device=x.device)
    ka, va = (k_new, v_new) if ctx is None else ctx.kv_heads(q, k_new, v_new)
    o = decode_attention(q, ka, va, k_positions, pos, window=window)
    return _out(params, o), {"k": k_new, "v": v_new}
