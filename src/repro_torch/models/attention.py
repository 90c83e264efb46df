"""GQA/MHA attention module: parameter specs and the train, prefill and
decode paths, as in ``repro/models/attention.py``.

The q/k/v/o projections are products through ``layers.linear``; the
attention itself is ``layers.flash_attention`` (full sequences, with a
hand-written backward kernel under autograd) or ``layers.decode_attention``,
both of which run the hand-written kernels on the card.  The KV cache is
updated in place (the JAX package donates the cache buffer to the same
effect).  Cross-attention (the encoder-decoder's) takes its keys and values
from ``kv_source`` and runs non-causal with Sq != Sk.
"""
from __future__ import annotations

import torch

from repro_torch import distributed
from repro_torch.models.layers import (MaskSpec, apply_norm, apply_rope, cast, decode_attention,
                                       flash_attention, linear)
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


def _qkv(params, x: torch.Tensor, kv_source=None, ctx=None):
    kv_in = x if kv_source is None else kv_source
    q = linear(x, params["wq"], "wq", ctx, "bsd,dhk->bshk")
    k = linear(kv_in, params["wk"], "wk", ctx, "bsd,dhk->bshk")
    v = linear(kv_in, params["wv"], "wv", ctx, "bsd,dhk->bshk")
    if "bq" in params:
        q = q + cast(params["bq"])
        k = k + cast(params["bk"])
        v = v + cast(params["bv"])
    if "q_norm" in params:  # qwen3-style per-head q/k RMSNorm, over head_dim
        q = apply_norm({"scale": params["q_norm"]}, q, "rmsnorm")
        k = apply_norm({"scale": params["k_norm"]}, k, "rmsnorm")
    return q, k, v


def _out(params, o: torch.Tensor, ctx=None) -> torch.Tensor:
    res = linear(o, params["wo"], "wo", ctx, "bshk,hkd->bsd")
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
    q, k, v = _qkv(params, x, kv_source, ctx)
    positions = _arange(s, x.device) if positions is None else positions
    kv_positions = _arange(k.shape[1], x.device) if kv_positions is None else kv_positions
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    if ctx is not None:
        k, v = ctx.kv_heads(q, k, v)
    o = flash_attention(q, k, v, mask=mask, q_positions=positions, k_positions=kv_positions)
    return _out(params, o, ctx)


def attn_prefill(params, x: torch.Tensor, cfg, *, mask: MaskSpec | None = None,
                 rope: bool = True, ctx=None):
    """Like :func:`attn_full`, also returning the populated KV cache
    ``{"k", "v"}`` (B, S, Hkv, hd), k after RoPE, as the JAX package's.  Over
    a mesh: the rank's rows and all S positions, with the kv heads its
    products computed (its share where they split over ``model``); the
    prefill cuts them to its shard (``MeshCtx.cache_part``)."""
    mask = mask or MaskSpec(causal=True)
    q, k, v = _qkv(params, x, ctx=ctx)
    positions = _arange(x.shape[1], x.device)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    ka, va = (k, v) if ctx is None else ctx.kv_heads(q, k, v)
    o = flash_attention(q, ka, va, mask=mask, q_positions=positions, k_positions=positions)
    return _out(params, o, ctx), {"k": k, "v": v}


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
    at ``pos``.  Returns (out, cache), the cache updated in place.  A cache
    whose slots are split over a mesh axis (``ctx.seq_shard``) is this rank's
    shard: see :func:`_decode_sharded`.
    """
    q, k, v = _qkv(params, x, ctx=ctx)
    posv = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    s_cache = cache["k"].shape[1]
    shard = None if ctx is None else ctx.seq_shard(s_cache)
    if shard is not None:
        o = _decode_sharded(q, k, v, cache, pos, shard, ctx, window)
        return _out(params, o, ctx), cache
    slot = pos % s_cache if window else pos
    k_new = cache_update(cache["k"], k, slot)
    v_new = cache_update(cache["v"], v, slot)
    if window:
        k_positions = ring_positions(pos, s_cache, x.device)
    else:
        k_positions = torch.arange(s_cache, dtype=torch.int32, device=x.device)
    ka, va = (k_new, v_new) if ctx is None else ctx.kv_heads(q, k_new, v_new)
    o = decode_attention(q, ka, va, k_positions, pos, window=window)
    return _out(params, o, ctx), {"k": k_new, "v": v_new}


def _decode_sharded(q, k, v, cache, pos: int, shard, ctx, window: int = 0) -> torch.Tensor:
    """Decode attention over a cache whose slots [shard.start, shard.stop)
    this rank holds: the owning rank writes slot ``pos`` (``pos % S`` of a
    ring of S slots when ``window``; every other rank's shard is left as it
    was, as the JAX package's ``shard_map`` update); each rank attends over
    its shard with the row log-sum-exp, its slots at their positions (for a
    ring, its slice of :func:`ring_positions`, ``UNWRITTEN`` for a slot not
    written yet, under the window), and the ranks' partial outputs combine
    by :func:`combine_partials`: a shard that sees no key weighs 0."""
    slots = shard.stop - shard.start
    ring = slots * shard.axis.size
    slot = pos % ring if window else pos
    if shard.start <= slot < shard.stop:
        cache_update(cache["k"], k, slot - shard.start)
        cache_update(cache["v"], v, slot - shard.start)
    if window:
        k_positions = ring_positions(pos, ring, q.device)[shard.start:shard.stop]
    else:
        k_positions = torch.arange(shard.start, shard.stop, dtype=torch.int32, device=q.device)
    ka, va = ctx.kv_heads(q, cache["k"], cache["v"])
    o, lse = decode_attention(q, ka, va, k_positions.contiguous(), pos, window=window,
                              with_lse=True)
    return combine_partials(o, lse, shard.axis)


def combine_partials(o: torch.Tensor, lse: torch.Tensor, axis) -> torch.Tensor:
    """The attention over all ranks' keys from each rank's over its own:
    o (B, Sq, H, hd) and lse (B, H, Sq) f32 per rank; with m the max of the
    lse, o = sum e^(lse - m) o / sum e^(lse - m), in f32.  A rank that saw
    no key (lse -1e30) weighs 0; if none saw one, the ranks' outputs (each
    the mean of its V) average to the mean of all V, as one kernel gives."""
    m = distributed.all_reduce(lse, axis, "max")
    w = torch.exp(lse - m).transpose(1, 2)[..., None]  # (B, Sq, H, 1)
    both = distributed.all_reduce(torch.cat([o.float() * w, w], dim=-1), axis)
    return (both[..., :-1] / both[..., -1:]).to(o.dtype)
