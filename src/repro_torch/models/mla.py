"""Multi-head Latent Attention (DeepSeek-V2), as in ``repro/models/mla.py``:
the expanded training / prefill path and the absorbed decode.

The KV cache holds only the low-rank latent ``c_kv`` (kv_lora_rank) and one
shared RoPE key per position.  The expanded path builds per-head keys of
``qk_nope_head_dim + qk_rope_head_dim`` (192 at deepseek-v2-lite's widths)
and values of ``v_head_dim`` (128) and runs ``layers.flash_attention``,
which zero-pads V to the keys' head dim for the kernels.  Decode folds
``W_uk`` into the query and ``W_uv`` into the output, so its scores run over
the latent cache directly; that is plain products and a softmax, as the JAX
package's is plain JAX outside any Pallas kernel (its K would be
kv_lora_rank + rope = 576 wide, past the kernels' 256).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.attention import cache_update
from repro_torch.models.layers import MaskSpec, apply_norm, apply_rope, cast, flash_attention
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


def _latents(p, x: torch.Tensor, cfg):
    """x -> (c_kv normed (B, S, rank), k_rope (B, S, rope), before RoPE)."""
    dkv = x @ cast(p["w_dkv"])
    c_kv, k_rope = dkv.split([cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim], dim=-1)
    return apply_norm({"scale": p["kv_norm"]}, c_kv, "rmsnorm"), k_rope


def _queries(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    m = cfg.mla
    q = torch.einsum("bsd,dhk->bshk", x, cast(p["wq"]))
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def apply_mla_full(p, x: torch.Tensor, cfg, positions=None):
    """Training / prefill path (expanded keys and values): x (B, S, D) ->
    (out (B, S, D), cache ``{"c_kv" (B, S, rank), "k_rope" (B, S, rope)}``)."""
    m = cfg.mla
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
    c_kv, k_rope = _latents(p, x, cfg)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)  # (B, S, 1, rope)
    q_nope, q_rope = _queries(p, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, cast(p["w_uk"]))
    v = torch.einsum("bsr,rhk->bshk", c_kv, cast(p["w_uv"]))
    k = torch.cat([k_nope, k_rope.expand(-1, -1, k_nope.shape[2], -1)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = flash_attention(q, k, v, mask=MaskSpec(causal=True), scale=_scale(cfg))
    out = torch.einsum("bshk,hkd->bsd", o, cast(p["wo"]))
    return out, {"c_kv": c_kv, "k_rope": k_rope[:, :, 0]}


def init_mla_cache_shape(cfg, batch: int, cache_len: int) -> dict[str, tuple[int, ...]]:
    m = cfg.mla
    return {"c_kv": (batch, cache_len, m.kv_lora_rank),
            "k_rope": (batch, cache_len, m.qk_rope_head_dim)}


def apply_mla_decode(p, x: torch.Tensor, cache, pos: int, cfg):
    """Absorbed one-token decode: x (B, 1, D); cache ``{"c_kv", "k_rope"}``
    (B, S, *), written at ``pos`` in place; slots past ``pos`` are masked.
    Returns (out (B, 1, D), cache)."""
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    c_kv_new, k_rope_new = _latents(p, x, cfg)  # (B, 1, rank), (B, 1, rope)
    k_rope_new = apply_rope(k_rope_new[:, :, None, :], posv, cfg.rope_theta)[:, :, 0]
    c_cache = cache_update(cache["c_kv"], c_kv_new, pos)
    r_cache = cache_update(cache["k_rope"], k_rope_new, pos)

    q_nope, q_rope = _queries(p, x, cfg, posv)  # (B, 1, H, *)
    # W_uk folded into the query: the scores run in the latent space
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, cast(p["w_uk"]))  # (B, 1, H, rank)
    s_lat = torch.einsum("bshr,btr->bhst", q_lat, c_cache)  # (B, H, 1, S)
    s_rope = torch.einsum("bshk,btk->bhst", q_rope, r_cache)
    s = (s_lat + s_rope).float() * _scale(cfg)
    valid = torch.arange(c_cache.shape[1], device=x.device) <= pos
    s = s.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    ctx_lat = torch.einsum("bhst,btr->bshr", probs.to(c_cache.dtype), c_cache)  # (B, 1, H, rank)
    o = torch.einsum("bshr,rhk->bshk", ctx_lat, cast(p["w_uv"]))  # W_uv folded in
    out = torch.einsum("bshk,hkd->bsd", o, cast(p["wo"]))
    return out, {"c_kv": c_cache, "k_rope": r_cache}
