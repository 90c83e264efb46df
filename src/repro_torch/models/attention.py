"""GQA/MHA attention module: parameter specs and the decode path, as in
``repro/models/attention.py``.

The q/k/v/o projections are plain products (``torch.einsum``); the
attention itself is ``layers.decode_attention``, which runs the
hand-written kernel on the card.  The KV cache is updated in place (the JAX
package donates the cache buffer to the same effect).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, cast, decode_attention
from repro_torch.sharding import ParamSpec

UNWRITTEN = 2**30  # the position of a ring-buffer slot not written yet


def attn_specs(cfg, layers: int | None = None) -> dict[str, ParamSpec]:
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


def _qkv(params, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, cast(params["wq"]))
    k = torch.einsum("bsd,dhk->bshk", x, cast(params["wk"]))
    v = torch.einsum("bsd,dhk->bshk", x, cast(params["wv"]))
    if "bq" in params:
        q = q + cast(params["bq"])
        k = k + cast(params["bk"])
        v = v + cast(params["bv"])
    return q, k, v


def _out(params, o: torch.Tensor) -> torch.Tensor:
    res = torch.einsum("bshk,hkd->bsd", o, cast(params["wo"]))
    if "bo" in params:
        res = res + cast(params["bo"])
    return res


def cache_update(cache: torch.Tensor, new: torch.Tensor, slot: int) -> torch.Tensor:
    """Write ``new`` (B, 1, ...) into ``cache`` (B, S, ...) at ``slot``, in place."""
    cache[:, slot] = new[:, 0]
    return cache


def init_cache_shape(cfg, batch: int, cache_len: int) -> tuple[int, int, int, int]:
    return (batch, cache_len, cfg.num_kv_heads, cfg.head_dim_)


def ring_positions(pos: int, s_cache: int, device) -> torch.Tensor:
    """Absolute position held in each slot of a ring buffer after writing
    ``pos`` at slot ``pos % s_cache``; ``UNWRITTEN`` for a slot not written yet."""
    idx = torch.arange(s_cache, device=device)
    k_positions = idx + s_cache * ((pos - idx + s_cache) // s_cache) - s_cache
    return torch.where(k_positions < 0, UNWRITTEN, k_positions)


def attn_decode(params, x: torch.Tensor, cache, pos: int, cfg, *, window: int = 0):
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
        k_positions = torch.arange(s_cache, device=x.device)
    o = decode_attention(q, k_new, v_new, k_positions, pos, window=window)
    return _out(params, o), {"k": k_new, "v": v_new}
