"""Multi-head Latent Attention (DeepSeek-V2), as in ``repro/models/mla.py``:
the expanded training / prefill path and the absorbed decode.

The KV cache holds only the low-rank latent ``c_kv`` (kv_lora_rank) and one
shared RoPE key per position.  The expanded path builds per-head keys of
``qk_nope_head_dim + qk_rope_head_dim`` (192 at deepseek-v2-lite's widths)
and values of ``v_head_dim`` (128) and runs ``layers.flash_attention``,
whose kernels take V at its own head dim.  Decode folds
``W_uk`` into the query and ``W_uv`` into the output, so its scores run over
the latent cache directly; that is plain products and a softmax, as the JAX
package's is plain JAX outside any Pallas kernel (its K would be
kv_lora_rank + rope = 576 wide, past the kernels' 256).

Every product goes through ``layers.linear`` under its leaf name.  Over a
mesh (``sharding.MeshCtx``) the expanded path splits heads as attention
does (the shared RoPE key, whole on every rank, is read by its heads:
``ctx.split_read``); ``kv_lora`` stays whole in every rule table.  The
absorbed decode over a latent cache split over ``model`` (``ctx.seq_shard``)
takes each rank's scores over its slots, a softmax with the row log-sum-exp
and its partial latent context, which the ranks combine
(``attention.combine_partials``) before ``W_uv``.
"""
from __future__ import annotations

import math

import torch

from repro_torch import trace
from repro_torch.models.attention import cache_update, combine_partials
from repro_torch.models.layers import MaskSpec, apply_norm, apply_rope, flash_attention, linear
from repro_torch.sharding import ParamSpec

NEG_INF = -1e30


def mla_specs(cfg, layers: int) -> dict[str, ParamSpec]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    la = ("layers",)
    lead = (layers,)
    return {
        "wq": ParamSpec(lead + (d, h, qk), la + ("embed", "heads", "head_dim"), init="scaled"),
        "w_dkv": ParamSpec(lead + (d, m.kv_lora_rank + m.qk_rope_head_dim),
                           la + ("embed", "kv_lora"), init="scaled"),
        "kv_norm": ParamSpec(lead + (m.kv_lora_rank,), la + ("kv_lora",), init="ones"),
        "w_uk": ParamSpec(lead + (m.kv_lora_rank, h, m.qk_nope_head_dim),
                          la + ("kv_lora", "heads", "head_dim"), init="scaled"),
        "w_uv": ParamSpec(lead + (m.kv_lora_rank, h, m.v_head_dim),
                          la + ("kv_lora", "heads", "head_dim"), init="scaled"),
        "wo": ParamSpec(lead + (h, m.v_head_dim, d), la + ("heads", "head_dim", "embed"),
                        init="scaled"),
    }


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)


def _latents(p, x: torch.Tensor, cfg, ctx=None):
    """x -> (c_kv normed (B, S, rank), k_rope (B, S, rope), before RoPE)."""
    dkv = linear(x, p["w_dkv"], "w_dkv", ctx)
    c_kv, k_rope = dkv.split([cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim], dim=-1)
    return apply_norm({"scale": p["kv_norm"]}, c_kv, "rmsnorm"), k_rope


def _queries(p, x: torch.Tensor, cfg, positions: torch.Tensor, ctx=None):
    m = cfg.mla
    q = linear(x, p["wq"], "wq", ctx, "bsd,dhk->bshk")
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def apply_mla_full(p, x: torch.Tensor, cfg, positions=None, ctx=None):
    """Training / prefill path (expanded keys and values): x (B, S, D) ->
    (out (B, S, D), cache ``{"c_kv" (B, S, rank), "k_rope" (B, S, rope)}``).
    Over a mesh the latents are whole on every ``model`` rank (``kv_lora``
    is whole in every rule table); the prefill keeps the rank's slots."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    with trace.span("attn.mla", x) as sp:
        x = sp.inputs(x)
        c_kv, k_rope = _latents(p, x, cfg, ctx)
        k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)  # (B, S, 1, rope)
        q_nope, q_rope = _queries(p, x, cfg, positions, ctx)
        k_nope = linear(c_kv, p["w_uk"], "w_uk", ctx, "bsr,rhk->bshk")
        v = linear(c_kv, p["w_uv"], "w_uv", ctx, "bsr,rhk->bshk")
        k_shared = k_rope if ctx is None else ctx.split_read(k_rope, "heads", cfg.num_heads)
        k = torch.cat([k_nope, k_shared.expand(-1, -1, k_nope.shape[2], -1)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        o = flash_attention(q, k, v, mask=MaskSpec(causal=True), scale=_scale(cfg))
        out = sp.outputs(linear(o, p["wo"], "wo", ctx, "bshk,hkd->bsd"))
    return out, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0]}


def init_mla_cache_shape(cfg, batch: int, cache_len: int) -> dict[str, tuple[int, ...]]:
    m = cfg.mla
    return {"c_kv": (batch, cache_len, m.kv_lora_rank),
            "k_rope": (batch, cache_len, m.qk_rope_head_dim)}


def apply_mla_decode(p, x: torch.Tensor, cache, pos: int, cfg, ctx=None):
    """Absorbed one-token decode: x (B, 1, D); cache ``{"c_kv", "k_rope"}``
    (B, S, *), written at ``pos`` in place; slots past ``pos`` are masked.
    A cache whose slots are split over a mesh axis (``ctx.seq_shard``) is
    this rank's shard: the owning rank writes slot ``pos``, every rank takes
    its slots' partial latent context with the row log-sum-exp, and the
    ranks combine them.  Returns (out (B, 1, D), cache)."""
    plan = getattr(ctx, "plans", {}).get("w_uk")
    if plan is not None and (plan.copy_f or plan.reduce_g or plan.gather or plan.cut_output):
        # the absorbed product contracts w_uk's head_dim, not the kv_lora of its plan
        raise NotImplementedError(f"the absorbed decode with w_uk split over a mesh ({plan})")
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    c_kv_new, k_rope_new = _latents(p, x, cfg, ctx)  # (B, 1, rank), (B, 1, rope)
    k_rope_new = apply_rope(k_rope_new[:, :, None, :], posv, cfg.rope_theta)[:, :, 0]
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    slots = c_cache.shape[1]
    shard = None if ctx is None else ctx.seq_shard(slots)
    start = 0 if shard is None else shard.start
    if start <= pos < start + slots:
        cache_update(c_cache, c_kv_new, pos - start)
        cache_update(r_cache, k_rope_new, pos - start)

    q_nope, q_rope = _queries(p, x, cfg, posv, ctx)  # (B, 1, H, *)
    # W_uk folded into the query: the scores run in the latent space
    q_lat = linear(q_nope, p["w_uk"], "w_uk", ctx, "bshk,rhk->bshr")  # (B, 1, H, rank)
    s_lat = torch.einsum("bshr,btr->bhst", q_lat, c_cache)  # (B, H, 1, S)
    s_rope = torch.einsum("bshk,btk->bhst", q_rope, r_cache)
    s = (s_lat + s_rope).float() * _scale(cfg)
    valid = torch.arange(start, start + slots, device=x.device) <= pos
    s = s.masked_fill(~valid, NEG_INF)
    if shard is None:
        probs = torch.softmax(s, dim=-1)
    else:  # this shard's partial softmax, by its row log-sum-exp (NEG_INF: no key seen)
        lse = torch.logsumexp(s, dim=-1)  # (B, H, 1)
        probs = torch.exp(s - lse[..., None])
    ctx_lat = torch.einsum("bhst,btr->bshr", probs.to(c_cache.dtype), c_cache)  # (B, 1, H, rank)
    if shard is not None:
        ctx_lat = combine_partials(ctx_lat, lse, shard.axis)
    o = linear(ctx_lat, p["w_uv"], "w_uv", ctx, "bshr,rhk->bshk")  # W_uv folded in
    out = linear(o, p["wo"], "wo", ctx, "bshk,hkd->bsd")
    return out, {"c_kv": c_cache, "k_rope": r_cache}
