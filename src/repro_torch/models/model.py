"""Model assembly for the port: the dense decoder-only LM, as in ``repro/models/model.py``.

``build(cfg)`` returns a model object exposing:

* ``param_specs()``                               — flat dict of ParamSpec
* ``cache_specs(batch, cache_len)``               — flat dict of ParamSpec for the KV cache
* ``decode_step(params, cache, tokens, pos)``     — one-token serve step

Parameters are the port's flat dict (``sharding.py``): every layer's weights
stacked on a leading ``layers`` axis, as the JAX package scans them, so
checkpoints are byte-identical across packages; the layers run in a Python
loop over that axis.  Only ``family == "dense"`` with token inputs is ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm, cast, mlp_specs, norm_specs
from repro_torch.sharding import ParamSpec, flatten, unflatten


def _embed_specs(cfg: ArchConfig) -> dict[str, ParamSpec]:
    v = cfg.padded_vocab
    out = {"embed": ParamSpec((v, cfg.d_model), ("vocab", "embed"), init="normal")}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((v, cfg.d_model), ("vocab", "embed"), init="scaled")
    return out


def _logits(params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,vd->bsv", h, cast(table))
    if cfg.padded_vocab != cfg.vocab:  # mask padding ids out of the softmax
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter or cache tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class DecoderLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.family != "dense" or cfg.input_mode != "tokens" or cfg.use_qk_norm:
            raise NotImplementedError(
                f"{cfg.name}: the port builds dense token-input models only "
                f"(family {cfg.family!r}; ROADMAP Queue 1 item 8)")
        self.cfg = cfg

    def param_specs(self) -> dict[str, ParamSpec]:
        cfg, L = self.cfg, self.cfg.num_layers
        block = {
            "ln1": norm_specs(cfg.d_model, cfg.norm, layers=L),
            "attn": attn.attn_specs(cfg, layers=L),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp, layers=L, bias=cfg.use_bias),
        }
        if not cfg.parallel_block:  # command-r shares ln1 across attn+mlp
            block["ln2"] = norm_specs(cfg.d_model, cfg.norm, layers=L)
        return flatten({**_embed_specs(cfg), "final_norm": norm_specs(cfg.d_model, cfg.norm),
                        "blocks": block})

    def param_count(self) -> int:
        return sum(math.prod(s.shape) for s in self.param_specs().values())

    def cache_specs(self, batch: int, cache_len: int) -> dict[str, ParamSpec]:
        cfg = self.cfg
        shape = (cfg.num_layers,) + attn.init_cache_shape(cfg, batch, cache_len)
        axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        return {name: ParamSpec(shape, axes, dtype=torch.bfloat16, init="zeros")
                for name in ("k", "v")}

    def decode_step(self, params: dict[str, torch.Tensor], cache: dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: int, ctx=None):
        """tokens: (B, 1) integer tensor on the parameters' device; pos: the
        current position.  Returns (logits (B, 1, padded_vocab) bf16, cache),
        the cache updated in place."""
        cfg = self.cfg
        p = unflatten(params)
        h = cast(p["embed"][tokens])
        for i in range(cfg.num_layers):
            lp = _layer(p["blocks"], i)
            x = apply_norm(lp["ln1"], h, cfg.norm)
            a_out, _ = attn.attn_decode(lp["attn"], x, _layer(cache, i), pos, cfg)
            if cfg.parallel_block:  # command-r: attn and mlp read the same norm
                h = h + a_out + apply_mlp(lp["mlp"], x, cfg.mlp)
                continue
            h = h + a_out
            h = h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg.norm), cfg.mlp)
        h = apply_norm(p["final_norm"], h, cfg.norm)
        return _logits(p, h, cfg), cache


def build(cfg: ArchConfig) -> DecoderLM:
    return DecoderLM(cfg)
