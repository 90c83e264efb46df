"""Model assembly for the port: the decoder-only LM families of ``repro/models/model.py``.

``build(cfg)`` returns a model object exposing:

* ``param_specs()``                               — flat dict of ParamSpec
* ``loss(params, batch)``                         — training loss (+metrics)
* ``prefill(params, batch)``                      — full forward, returns the cache
* ``cache_specs(batch, cache_len, long_mode=)``   — flat dict of ParamSpec for the cache
* ``decode_step(params, cache, tokens, pos, long_mode=)`` — one-token serve step

Families ``dense`` (attention + MLP), ``moe`` (attention + routed experts,
``models/moe.py``), ``ssm`` (Mamba blocks alone, ``models/mamba.py``) and
``hybrid`` (attention and Mamba side by side, their normed outputs
averaged, + MLP), with token or embedding inputs (a stub frontend's
vectors; decode embeds the generated tokens).  ``mla_moe`` and ``encdec``
raise ``NotImplementedError`` (ROADMAP Queue 1 item 4).

Parameters are the port's flat dict (``sharding.py``): every layer's weights
stacked on a leading ``layers`` axis, as the JAX package scans them, so
checkpoints are byte-identical across packages; the layers run in a Python
loop over that axis.  Under autograd each layer is recomputed in the
backward pass (``torch.utils.checkpoint``, the JAX package's per-layer
``jax.checkpoint``); the MoE aux loss is summed over the layers.

Long mode (``long_window > 0``): the KV cache holds ``min(cache_len,
long_window)`` slots, written as a ring, and attention sees a sliding window
of ``long_window`` positions; the SSM state is carried whole.  Prefill, as
the JAX package's, returns no SSM state (ROADMAP Queue 3 item 6): its cache
is ``{"k", "v"}`` for the attention families and empty for ``ssm``.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as ssm_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import MaskSpec, apply_mlp, apply_norm, cast, mlp_specs, norm_specs
from repro_torch.sharding import ParamSpec, flatten, unflatten

FAMILIES = ("dense", "moe", "ssm", "hybrid")
ATTENTION_FAMILIES = ("dense", "moe", "hybrid")
SSM_FAMILIES = ("ssm", "hybrid")


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


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; logits (B, S, V) bf16 -> f32 statistics."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    return (lse - gold).mean()


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter or cache tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class DecoderLM:
    def __init__(self, cfg: ArchConfig):
        if cfg.family not in FAMILIES or cfg.input_mode not in ("tokens", "embeddings"):
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} with {cfg.input_mode} inputs is not ported "
                f"(the port builds {', '.join(FAMILIES)}; ROADMAP Queue 1 item 4, the LM stack)")
        if cfg.moe is not None and cfg.moe.first_dense_layers:
            raise NotImplementedError(f"{cfg.name}: leading dense layers (MLA's) are not ported "
                                      "(ROADMAP Queue 1 item 4e)")
        self.cfg = cfg

    # -- parameter tree ------------------------------------------------------------
    def _block_specs(self, layers: int) -> dict:
        cfg = self.cfg
        fam = cfg.family
        out = {"ln1": norm_specs(cfg.d_model, cfg.norm, layers=layers)}
        if fam in ATTENTION_FAMILIES:
            out["attn"] = attn.attn_specs(cfg, layers=layers)
            if cfg.use_qk_norm:
                hd = cfg.head_dim_
                out["attn"]["q_norm"] = ParamSpec((layers, hd), ("layers", "head_dim"), init="ones")
                out["attn"]["k_norm"] = ParamSpec((layers, hd), ("layers", "head_dim"), init="ones")
        if fam in SSM_FAMILIES:
            out["ssm"] = ssm_mod.ssm_specs(cfg, layers=layers)
        if fam == "hybrid":
            out["ln_attn_out"] = norm_specs(cfg.d_model, cfg.norm, layers=layers)
            out["ln_ssm_out"] = norm_specs(cfg.d_model, cfg.norm, layers=layers)
        # second half: MLP / MoE (the ssm family has none: pure Mamba blocks)
        if fam in ("dense", "hybrid"):
            if not cfg.parallel_block:  # command-r shares ln1 across attn+mlp
                out["ln2"] = norm_specs(cfg.d_model, cfg.norm, layers=layers)
            out["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp, layers=layers, bias=cfg.use_bias)
        elif fam == "moe":
            out["ln2"] = norm_specs(cfg.d_model, cfg.norm, layers=layers)
            out["moe"] = moe_mod.moe_specs(cfg, layers)
        return out

    def param_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        return flatten({**_embed_specs(cfg), "final_norm": norm_specs(cfg.d_model, cfg.norm),
                        "blocks": self._block_specs(cfg.num_layers)})

    def param_count(self) -> int:
        return sum(math.prod(s.shape) for s in self.param_specs().values())

    # -- one block ------------------------------------------------------------------
    def _mix(self, block, a_out, s_out) -> torch.Tensor:
        """The token mixer's output: attention's, the SSM's, or (hybrid) the
        mean of the two, each normed."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return s_out
        if cfg.family == "hybrid":
            return 0.5 * (apply_norm(block["ln_attn_out"], a_out, cfg.norm)
                          + apply_norm(block["ln_ssm_out"], s_out, cfg.norm))
        return a_out

    def _second_half(self, block, h: torch.Tensor, x: torch.Tensor, mixed: torch.Tensor, ctx):
        """The residual stream after the block: (h, aux), given the block's
        input ``h``, its normed input ``x`` and the mixer's output; aux is the
        MoE's aux loss, None for the other families."""
        cfg = self.cfg
        aux = None
        if cfg.parallel_block:  # command-r: attn and mlp read the same norm
            return h + mixed + apply_mlp(block["mlp"], x, cfg.mlp), aux
        h = h + mixed
        if cfg.family == "ssm":
            return h, aux
        x2 = apply_norm(block["ln2"], h, cfg.norm)
        if cfg.family == "moe":
            m_out, aux = moe_mod.apply_moe(block["moe"], x2, cfg, ctx)
        else:
            m_out = apply_mlp(block["mlp"], x2, cfg.mlp)
        return h + m_out, aux

    def _block_full(self, block, h: torch.Tensor, mask: MaskSpec, ctx):
        cfg = self.cfg
        x = apply_norm(block["ln1"], h, cfg.norm)
        a_out = s_out = None
        if cfg.family in ATTENTION_FAMILIES:
            a_out = attn.attn_full(block["attn"], x, cfg, mask=mask)
        if cfg.family in SSM_FAMILIES:
            s_out = ssm_mod.apply_ssm(block["ssm"], x, cfg)
        return self._second_half(block, h, x, self._mix(block, a_out, s_out), ctx)

    def _run_stack(self, blocks, h: torch.Tensor, mask: MaskSpec, ctx):
        """Every layer over the full sequence, returning (h, summed aux); under
        autograd each layer's activations are recomputed in the backward pass
        (the JAX package's ``_ckpt``), so one layer's are held at a time."""
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(self.cfg.num_layers):
            lp = _layer(blocks, i)
            if torch.is_grad_enabled():
                h, aux_i = checkpoint(self._block_full, lp, h, mask, ctx, use_reentrant=False)
            else:
                h, aux_i = self._block_full(lp, h, mask, ctx)
            if aux_i is not None:
                aux = aux + aux_i
        return h, aux

    def _inputs_to_h(self, params, batch) -> torch.Tensor:
        if self.cfg.input_mode == "embeddings":
            return cast(batch["embeddings"])
        return cast(params["embed"])[batch["tokens"]]

    # -- public: train loss ------------------------------------------------------------
    def loss(self, params: dict[str, torch.Tensor], batch, ctx=None):
        """batch: ``{"tokens" | "embeddings", "labels"}`` on the parameters'
        device (tokens, labels (B, S) integers; embeddings (B, S, d_model)).
        Returns (loss, metrics): the mean cross-entropy, plus for MoE
        ``router_aux_weight`` times the aux loss per layer."""
        cfg = self.cfg
        p = unflatten(params)
        h, aux = self._run_stack(p["blocks"], self._inputs_to_h(p, batch), MaskSpec(causal=True),
                                 ctx)
        h = apply_norm(p["final_norm"], h, cfg.norm)
        loss = _xent(_logits(p, h, cfg), batch["labels"])
        if cfg.moe:
            loss = loss + cfg.moe.router_aux_weight * aux / max(cfg.num_layers, 1)
        return loss, {"xent": loss, "aux": aux}

    # -- public: prefill ------------------------------------------------------------------
    def prefill(self, params: dict[str, torch.Tensor], batch, ctx=None):
        """Returns (last-position logits (B, 1, padded_vocab), cache): ``{"k",
        "v"}`` (layers, B, S, Hkv, hd) for the attention families, ``{}`` for
        ``ssm`` (no SSM state, as the JAX package's prefill)."""
        cfg = self.cfg
        p = unflatten(params)
        h = self._inputs_to_h(p, batch)
        mask = MaskSpec(causal=True)
        ks, vs = [], []
        for i in range(cfg.num_layers):
            lp = _layer(p["blocks"], i)
            x = apply_norm(lp["ln1"], h, cfg.norm)
            a_out = s_out = None
            if cfg.family in ATTENTION_FAMILIES:
                a_out, kv = attn.attn_prefill(lp["attn"], x, cfg, mask=mask)
                ks.append(kv["k"])
                vs.append(kv["v"])
            if cfg.family in SSM_FAMILIES:
                s_out = ssm_mod.apply_ssm(lp["ssm"], x, cfg)
            h, _ = self._second_half(lp, h, x, self._mix(lp, a_out, s_out), ctx)
        h = apply_norm(p["final_norm"], h, cfg.norm)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if ks else {}
        return _logits(p, h[:, -1:], cfg), cache

    # -- public: decode -------------------------------------------------------------------
    def cache_specs(self, batch: int, cache_len: int, *,
                    long_mode: bool = False) -> dict[str, ParamSpec]:
        """The decode cache: ``k``/``v`` (layers, B, slots, Hkv, hd) bf16 with
        ``slots = min(cache_len, long_window)`` in long mode; ``conv`` (layers,
        B, conv_width - 1, d_inner) bf16 and ``h_ssm`` (layers, B, d_inner,
        state) f32 for the SSM families."""
        cfg = self.cfg
        L = cfg.num_layers
        out = {}
        eff_len = min(cache_len, cfg.long_window) if (long_mode and cfg.long_window) else cache_len
        if cfg.family in ATTENTION_FAMILIES:
            shape = (L,) + attn.init_cache_shape(cfg, batch, eff_len)
            axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
            for name in ("k", "v"):
                out[name] = ParamSpec(shape, axes, dtype=torch.bfloat16, init="zeros")
        if cfg.family in SSM_FAMILIES:
            shapes = ssm_mod.init_ssm_cache_shape(cfg, batch)
            out["conv"] = ParamSpec((L,) + shapes["conv"], ("layers", "batch", "conv", "ssm_inner"),
                                    dtype=torch.bfloat16, init="zeros")
            out["h_ssm"] = ParamSpec((L,) + shapes["h"], ("layers", "batch", "ssm_inner", "ssm_state"),
                                     dtype=torch.float32, init="zeros")
        return out

    def decode_step(self, params: dict[str, torch.Tensor], cache: dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: int, ctx=None, *, long_mode: bool = False):
        """tokens: (B, 1) integer tensor on the parameters' device (tokens
        also for embedding-input models, as the JAX package decodes); pos: the
        current position.  Returns (logits (B, 1, padded_vocab) bf16, cache),
        the cache updated in place."""
        cfg = self.cfg
        window = cfg.long_window if (long_mode and cfg.long_window) else 0
        p = unflatten(params)
        h = cast(p["embed"][tokens])
        for i in range(cfg.num_layers):
            lp, lc = _layer(p["blocks"], i), _layer(cache, i)
            x = apply_norm(lp["ln1"], h, cfg.norm)
            a_out = s_out = None
            if cfg.family in ATTENTION_FAMILIES:
                a_out, _ = attn.attn_decode(lp["attn"], x, {"k": lc["k"], "v": lc["v"]}, pos, cfg,
                                            window=window)
            if cfg.family in SSM_FAMILIES:
                s_out, _ = ssm_mod.apply_ssm_decode(lp["ssm"], x,
                                                    {"conv": lc["conv"], "h": lc["h_ssm"]}, cfg)
            h, _ = self._second_half(lp, h, x, self._mix(lp, a_out, s_out), ctx)
        h = apply_norm(p["final_norm"], h, cfg.norm)
        return _logits(p, h, cfg), cache


def build(cfg: ArchConfig) -> DecoderLM:
    return DecoderLM(cfg)
