"""Model assembly for the port: every architecture of ``repro/models/model.py``.

``build(cfg)`` returns a model object exposing:

* ``param_specs()``                               — flat dict of ParamSpec
* ``loss(params, batch)``                         — training loss (+metrics)
* ``prefill(params, batch)``                      — full forward, returns the cache
* ``cache_specs(batch, cache_len, long_mode=)``   — flat dict of ParamSpec for the cache
* ``decode_step(params, cache, tokens, pos, long_mode=)`` — one-token serve step

``DecoderLM`` builds the families ``dense`` (attention + MLP), ``moe``
(attention + routed experts, ``models/moe.py``), ``mla_moe`` (Multi-head
Latent Attention, ``models/mla.py``, + routed and shared experts, after
``first_dense_layers`` MLA + MLP layers kept apart as ``dense0``), ``ssm``
(Mamba blocks alone, ``models/mamba.py``) and ``hybrid`` (attention and
Mamba side by side, their normed outputs averaged, + MLP), with token or
embedding inputs (a stub frontend's vectors; decode embeds the generated
tokens).  ``EncDecLM`` is the encoder-decoder (whisper): a non-causal
encoder over the stub frontend's frames, a decoder of causal
self-attention, cross-attention to the encoder's output and an MLP.

Parameters are the port's flat dict (``sharding.py``): every layer's weights
stacked on a leading ``layers`` axis, as the JAX package scans them, so
checkpoints are byte-identical across packages; the layers run in a Python
loop over that axis.  Under autograd each layer is recomputed in the
backward pass (``torch.utils.checkpoint``, the JAX package's per-layer
``jax.checkpoint``); the MoE aux loss is summed over the MoE layers.

Long mode (``long_window > 0``): the KV cache holds ``min(cache_len,
long_window)`` slots, written as a ring, and attention sees a sliding window
of ``long_window`` positions; the SSM state is carried whole.  Prefill, as
the JAX package's, returns no SSM state and no cache of the leading dense
layers (ROADMAP Queue 3 items 6, 7): its cache is ``{"k", "v"}`` for the
attention families, ``{"c_kv", "k_rope"}`` of the MoE layers for
``mla_moe`` and empty for ``ssm``.  Each layer's entries are written in
place into a stacked cache allocated once, so the cache is held once.  Over
a mesh (``sharding.MeshCtx``, SERVE_RULES) the prefill takes the global
batch, runs the rank's rows, and returns the last position's logits whole
and the rank's shard of the cache as ``logical_to_spec`` lays out
``cache_specs`` (``MeshCtx.cache_part``: its rows, its slots).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import distributed, trace
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as ssm_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (MaskSpec, apply_mlp, apply_norm, cast, linear, mlp_specs,
                                       norm_specs)
from repro_torch.sharding import ParamSpec, flatten, unflatten

FAMILIES = ("dense", "moe", "mla_moe", "ssm", "hybrid")
ATTENTION_FAMILIES = ("dense", "moe", "hybrid")
SSM_FAMILIES = ("ssm", "hybrid")
MOE_FAMILIES = ("moe", "mla_moe")


def _embed_specs(cfg: ArchConfig) -> dict[str, ParamSpec]:
    v = cfg.padded_vocab
    out = {"embed": ParamSpec((v, cfg.d_model), ("vocab", "embed"), init="normal")}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((v, cfg.d_model), ("vocab", "embed"), init="scaled")
    return out


def _weight(params, name: str, ctx) -> torch.Tensor:
    """A weight outside the layer stacks, as the products read it (``ctx.gather``)."""
    return params[name] if ctx is None else ctx.gather(name, params[name])


def _head(cfg: ArchConfig) -> str:
    return "embed" if cfg.tie_embeddings else "lm_head"


def _lookup(params, tokens: torch.Tensor, ctx=None, cast_first: bool = False) -> torch.Tensor:
    """The embedding rows of ``tokens`` (in the compute dtype).  A table whose
    vocab is split over a mesh axis (``ctx.vocab_shard``) is looked up
    vocab-parallel: each rank its own ids' rows, zeros for the others, summed
    over the axis ("g")."""
    table = _weight(params, "embed", ctx)
    with trace.span("model.embed", table) as sp:
        table = sp.inputs(table)
        shard = None if ctx is None else ctx.vocab_shard("embed")
        if shard is None:
            return sp.outputs(cast(table)[tokens] if cast_first else cast(table[tokens]))
        local = tokens - shard.start
        mine = (local >= 0) & (local < shard.stop - shard.start)
        rows = cast(table)[torch.where(mine, local, 0)]
        return sp.outputs(distributed.reduce_g(torch.where(mine[..., None], rows, 0.0),
                                               shard.axis))


def _logits(params, h: torch.Tensor, cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """The logits over this rank's ids of the vocab (all of them off a mesh)."""
    name = _head(cfg)
    weight = _weight(params, name, ctx)
    with trace.span("model.head", h) as sp:
        logits = linear(sp.inputs(h), weight, name, ctx, "bsd,vd->bsv")
        if cfg.padded_vocab != cfg.vocab:  # mask padding ids out of the softmax
            # the ids of the logits' columns: from this rank's first id over a
            # mesh, from 0 in the dry-run's per-device trace (the first rank's)
            ids = torch.arange(logits.shape[-1], device=logits.device)
            shard = None if ctx is None else ctx.vocab_shard(name)
            if shard is not None:
                ids = ids + shard.start
            logits = logits.masked_fill(ids >= cfg.vocab, -1e30)
        return sp.outputs(logits)


def _whole_logits(logits: torch.Tensor, cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """Logits of every id of the vocab for the global batch (decode and
    prefill give them whole, as the JAX package's steps)."""
    if ctx is None:
        return logits
    shard = ctx.vocab_shard(_head(cfg))
    if shard is not None:
        logits = distributed.gather_out(logits, shard.axis, -1)
    return ctx.whole_batch(logits)


def _xent(logits: torch.Tensor, labels: torch.Tensor, cfg: ArchConfig | None = None,
          ctx=None) -> torch.Tensor:
    """Mean cross-entropy; logits (B, S, V) bf16 -> f32 statistics.  Over a
    mesh whose ``model`` axis splits the vocab, vocab-parallel: each rank's
    log-sum-exp over its ids and its gold logit combine over the axis, so the
    (B, S, V) logits are never gathered."""
    with trace.span("model.xent", logits) as sp:
        logits = sp.inputs(logits).float()
        lse = torch.logsumexp(logits, dim=-1)
        shard = None if ctx is None else ctx.vocab_shard(_head(cfg))
        if shard is None:
            gold = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
            return sp.outputs((lse - gold).mean())
        lse = torch.logsumexp(distributed.gather_out(lse[..., None], shard.axis, -1), dim=-1)
        local = labels.long() - shard.start
        mine = (local >= 0) & (local < shard.stop - shard.start)
        gold = torch.take_along_dim(logits, torch.where(mine, local, 0)[..., None],
                                    dim=-1)[..., 0]
        gold = distributed.reduce_g(torch.where(mine, gold, 0.0), shard.axis)
        return sp.outputs((lse - gold).mean())


def _local_batch(batch: dict, ctx) -> dict:
    return batch if ctx is None else {k: ctx.local_batch(v) for k, v in batch.items()}


def _write_cache(cache: dict, i: int, entries: dict, specs: dict, layers: int, ctx) -> None:
    """Layer ``i``'s ``entries`` (the rank's shard of each, ``ctx.cache_part``)
    written in place into the stacked ``cache``, each stack allocated at the
    first layer that writes it: the cache is held once."""
    for name, t in entries.items():
        part = t if ctx is None else ctx.cache_part(t, specs[name])
        if name not in cache:
            cache[name] = part.new_empty((layers,) + tuple(part.shape))
        cache[name][i].copy_(part)


def _layer(tree: dict, i: int, ctx=None, prefix: str = "") -> dict:
    """Layer ``i`` of a stacked parameter or cache tree (views, no copies);
    with a ``ctx``, each weight as ``ctx.gather`` gives it (``prefix``: the
    stack's dotted path)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _layer(v, i, ctx, f"{prefix}{k}.")
        else:
            out[k] = v[i] if ctx is None else ctx.gather(prefix + k, v[i])
    return out


def _layers(tree: dict) -> int:
    """The depth of a stacked tree: its leaves' leading axis."""
    leaf = next(iter(tree.values()))
    return _layers(leaf) if isinstance(leaf, dict) else leaf.shape[0]


def _per_layer(fn, *args):
    """``fn(*args)``, recomputed in the backward pass when grad is on (the JAX
    package's per-layer ``jax.checkpoint``): one layer's activations held."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class _Model:
    """What both model classes share: the config and the parameter count."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    def param_count(self) -> int:
        return sum(math.prod(s.shape) for s in self.param_specs().values())


class DecoderLM(_Model):
    def __init__(self, cfg: ArchConfig):
        if cfg.family not in FAMILIES or cfg.input_mode not in ("tokens", "embeddings"):
            raise ValueError(f"{cfg.name}: DecoderLM builds the families {', '.join(FAMILIES)} "
                             f"with token or embedding inputs, not {cfg.family!r} with "
                             f"{cfg.input_mode} inputs (build() gives encdec its EncDecLM)")
        super().__init__(cfg)
        self.n_dense0 = cfg.moe.first_dense_layers if cfg.moe else 0

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
        if fam == "mla_moe":
            out["mla"] = mla_mod.mla_specs(cfg, layers)
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
        elif fam in MOE_FAMILIES:
            out["ln2"] = norm_specs(cfg.d_model, cfg.norm, layers=layers)
            out["moe"] = moe_mod.moe_specs(cfg, layers)
        return out

    def param_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        specs = {**_embed_specs(cfg), "final_norm": norm_specs(cfg.d_model, cfg.norm),
                 "blocks": self._block_specs(cfg.num_layers - self.n_dense0)}
        if self.n_dense0:  # MLA + a SwiGLU MLP of first_dense_d_ff
            d0 = self.n_dense0
            specs["dense0"] = {
                "ln1": norm_specs(cfg.d_model, cfg.norm, layers=d0),
                "mla": mla_mod.mla_specs(cfg, d0),
                "ln2": norm_specs(cfg.d_model, cfg.norm, layers=d0),
                "mlp": mlp_specs(cfg.d_model, cfg.moe.first_dense_d_ff, "swiglu", layers=d0),
            }
        return flatten(specs)

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

    def _second_half(self, block, h: torch.Tensor, x: torch.Tensor, mixed: torch.Tensor, ctx,
                     dense: bool = False):
        """The residual stream after the block: (h, aux), given the block's
        input ``h``, its normed input ``x`` and the mixer's output; aux is the
        MoE's aux loss, None for the other families and for a leading dense
        layer (``dense``: MLA + MLP)."""
        cfg = self.cfg
        aux = None
        if cfg.parallel_block:  # command-r: attn and mlp read the same norm
            return h + mixed + apply_mlp(block["mlp"], x, cfg.mlp, ctx), aux
        h = h + mixed
        if cfg.family == "ssm":
            return h, aux
        x2 = apply_norm(block["ln2"], h, cfg.norm)
        if cfg.family in MOE_FAMILIES and not dense:
            m_out, aux = moe_mod.apply_moe(block["moe"], x2, cfg, ctx)
        else:
            m_out = apply_mlp(block["mlp"], x2, cfg.mlp, ctx)
        return h + m_out, aux

    def _mixer_full(self, block, x: torch.Tensor, mask: MaskSpec, cache: bool, ctx):
        """The token mixer over the full sequence: (output, cache entries of
        the layer, empty unless ``cache``)."""
        cfg = self.cfg
        kv: dict = {}
        a_out = s_out = None
        if cfg.family == "mla_moe":  # also the leading dense layers
            a_out, kv = mla_mod.apply_mla_full(block["mla"], x, cfg, ctx=ctx)
        elif cfg.family in ATTENTION_FAMILIES and cache:
            a_out, kv = attn.attn_prefill(block["attn"], x, cfg, mask=mask, ctx=ctx)
        elif cfg.family in ATTENTION_FAMILIES:
            a_out = attn.attn_full(block["attn"], x, cfg, mask=mask, ctx=ctx)
        if cfg.family in SSM_FAMILIES:
            s_out = ssm_mod.apply_ssm(block["ssm"], x, cfg, ctx)
        return self._mix(block, a_out, s_out), kv if cache else {}

    def _block_full(self, block, h: torch.Tensor, mask: MaskSpec, ctx, dense: bool = False):
        with trace.span("model.block", h):  # also its recomputation in the backward pass
            x = apply_norm(block["ln1"], h, self.cfg.norm)
            mixed, _ = self._mixer_full(block, x, mask, cache=False, ctx=ctx)
            return self._second_half(block, h, x, mixed, ctx, dense)

    def _block_at(self, stack, prefix: str, i: int, h: torch.Tensor, mask: MaskSpec, ctx,
                  dense: bool = False):
        """:meth:`_block_full` of layer ``i`` of a stack: the layer's weights
        are taken inside, so that recomputation takes them again."""
        return self._block_full(_layer(stack, i, ctx, prefix), h, mask, ctx, dense)

    def _run_dense0(self, p, h: torch.Tensor, mask: MaskSpec, ctx) -> torch.Tensor:
        """The leading dense layers (MLA + MLP), recomputed under autograd."""
        for i in range(self.n_dense0):
            h, _ = _per_layer(self._block_at, p["dense0"], "dense0.", i, h, mask, ctx, True)
        return h

    def _run_stack(self, p, h: torch.Tensor, mask: MaskSpec, ctx):
        """Every layer over the full sequence, returning (h, aux summed over
        the MoE layers); under autograd each layer's activations are
        recomputed in the backward pass (the JAX package's ``_ckpt``), so one
        layer's are held at a time."""
        h = self._run_dense0(p, h, mask, ctx)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(_layers(p["blocks"])):
            h, aux_i = _per_layer(self._block_at, p["blocks"], "blocks.", i, h, mask, ctx)
            if aux_i is not None:
                aux = aux + aux_i
        return h, aux

    def _inputs_to_h(self, params, batch, ctx) -> torch.Tensor:
        if self.cfg.input_mode == "embeddings":
            return cast(batch["embeddings"])
        return _lookup(params, batch["tokens"], ctx, cast_first=True)

    # -- public: train loss ------------------------------------------------------------
    def loss(self, params: dict[str, torch.Tensor], batch, ctx=None):
        """batch: ``{"tokens" | "embeddings", "labels"}`` on the parameters'
        device (tokens, labels (B, S) integers; embeddings (B, S, d_model)).
        Returns (loss, metrics): the mean cross-entropy, plus for MoE
        ``router_aux_weight`` times the aux loss per layer."""
        cfg = self.cfg
        p = unflatten(params)
        batch = _local_batch(batch, ctx)
        h, aux = self._run_stack(p, self._inputs_to_h(p, batch, ctx), MaskSpec(causal=True), ctx)
        h = apply_norm(p["final_norm"], h, cfg.norm)
        loss = _xent(_logits(p, h, cfg, ctx), batch["labels"], cfg, ctx)
        if cfg.moe:
            loss = loss + cfg.moe.router_aux_weight * aux / max(cfg.num_layers, 1)
        if ctx is not None:  # the mean over the batch's data shards
            loss = ctx.pmean(loss, ("pod", "data"))
        return loss, {"xent": loss, "aux": aux}

    # -- public: prefill ------------------------------------------------------------------
    def prefill(self, params: dict[str, torch.Tensor], batch, ctx=None):
        """Returns (last-position logits (B, 1, padded_vocab), cache): ``{"k",
        "v"}`` (layers, B, S, Hkv, hd) for the attention families, ``{"c_kv",
        "k_rope"}`` (layers, B, S, *) of the MoE layers for ``mla_moe`` (none
        of the leading dense layers), ``{}`` for ``ssm`` (no SSM state), as
        the JAX package's prefill; over a mesh the rank's shard of it."""
        cfg = self.cfg
        rows, seq = batch["embeddings" if cfg.input_mode == "embeddings" else "tokens"].shape[:2]
        specs = self.cache_specs(rows, seq)
        batch = _local_batch(batch, ctx)
        p = unflatten(params)
        mask = MaskSpec(causal=True)
        h = self._run_dense0(p, self._inputs_to_h(p, batch, ctx), mask, ctx)
        layers = _layers(p["blocks"])
        cache: dict[str, torch.Tensor] = {}
        for i in range(layers):
            lp = _layer(p["blocks"], i, ctx, "blocks.")
            x = apply_norm(lp["ln1"], h, cfg.norm)
            mixed, kv = self._mixer_full(lp, x, mask, cache=True, ctx=ctx)
            _write_cache(cache, i, kv, specs, layers, ctx)
            h, _ = self._second_half(lp, h, x, mixed, ctx)
        h = apply_norm(p["final_norm"], h, cfg.norm)
        return _whole_logits(_logits(p, h[:, -1:], cfg, ctx), cfg, ctx), cache

    # -- public: decode -------------------------------------------------------------------
    def cache_specs(self, batch: int, cache_len: int, *,
                    long_mode: bool = False) -> dict[str, ParamSpec]:
        """The decode cache: ``k``/``v`` (layers, B, slots, Hkv, hd) bf16 with
        ``slots = min(cache_len, long_window)`` in long mode; ``c_kv``/
        ``k_rope`` (layers, B, cache_len, *) bf16 for MLA, with ``c_kv0``/
        ``k_rope0`` for the leading dense layers; ``conv`` (layers, B,
        conv_width - 1, d_inner) bf16 and ``h_ssm`` (layers, B, d_inner,
        state) f32 for the SSM families."""
        cfg = self.cfg
        L = cfg.num_layers - self.n_dense0
        out = {}
        eff_len = min(cache_len, cfg.long_window) if (long_mode and cfg.long_window) else cache_len
        if cfg.family in ATTENTION_FAMILIES:
            shape = (L,) + attn.init_cache_shape(cfg, batch, eff_len)
            axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
            for name in ("k", "v"):
                out[name] = ParamSpec(shape, axes, dtype=torch.bfloat16, init="zeros")
        if cfg.family == "mla_moe":
            shapes = mla_mod.init_mla_cache_shape(cfg, batch, cache_len)
            axes = {"c_kv": ("layers", "batch", "cache_seq", "kv_lora"),
                    "k_rope": ("layers", "batch", "cache_seq", None)}
            for suffix, n in (("", L), ("0", self.n_dense0)):
                if n:
                    for name in ("c_kv", "k_rope"):
                        out[name + suffix] = ParamSpec((n,) + shapes[name], axes[name],
                                                       dtype=torch.bfloat16, init="zeros")
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
        h = _lookup(p, tokens if ctx is None else ctx.local_batch(tokens), ctx)
        for i in range(self.n_dense0):
            lp = _layer(p["dense0"], i, ctx, "dense0.")
            x = apply_norm(lp["ln1"], h, cfg.norm)
            a_out, _ = mla_mod.apply_mla_decode(
                lp["mla"], x, {"c_kv": cache["c_kv0"][i], "k_rope": cache["k_rope0"][i]}, pos, cfg,
                ctx)
            h, _ = self._second_half(lp, h, x, a_out, ctx, dense=True)
        main = {k: v for k, v in cache.items() if not k.endswith("0")}
        for i in range(_layers(p["blocks"])):
            lp, lc = _layer(p["blocks"], i, ctx, "blocks."), _layer(main, i)
            x = apply_norm(lp["ln1"], h, cfg.norm)
            a_out = s_out = None
            if cfg.family in ATTENTION_FAMILIES:
                a_out, _ = attn.attn_decode(lp["attn"], x, {"k": lc["k"], "v": lc["v"]}, pos, cfg,
                                            window=window, ctx=ctx)
            if cfg.family == "mla_moe":
                a_out, _ = mla_mod.apply_mla_decode(
                    lp["mla"], x, {"c_kv": lc["c_kv"], "k_rope": lc["k_rope"]}, pos, cfg, ctx)
            if cfg.family in SSM_FAMILIES:
                s_out, _ = ssm_mod.apply_ssm_decode(lp["ssm"], x,
                                                    {"conv": lc["conv"], "h": lc["h_ssm"]}, cfg, ctx)
            h, _ = self._second_half(lp, h, x, self._mix(lp, a_out, s_out), ctx)
        h = apply_norm(p["final_norm"], h, cfg.norm)
        return _whole_logits(_logits(p, h, cfg, ctx), cfg, ctx), cache


class EncDecLM(_Model):
    """The encoder-decoder (whisper-style; the stub audio frontend supplies
    the frames' embeddings), as ``repro/models/model.py::EncDecLM``.

    ``encode`` runs the non-causal encoder over the frames (B, enc_seq,
    d_model); every decoder layer attends causally to its own tokens, then,
    non-causal and without RoPE, to the encoder's output.  The decode cache
    holds the self-attention's ``k``/``v`` and the encoder's output
    ``enc_out``; each step recomputes cross-attention's keys and values from
    ``enc_out`` in every layer, as the JAX package does."""

    def param_specs(self) -> dict[str, ParamSpec]:
        cfg = self.cfg
        el, dl = cfg.enc_layers, cfg.num_layers
        enc = {
            "ln1": norm_specs(cfg.d_model, cfg.norm, layers=el),
            "attn": attn.attn_specs(cfg, layers=el),
            "ln2": norm_specs(cfg.d_model, cfg.norm, layers=el),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp, layers=el, bias=cfg.use_bias),
        }
        dec = {
            "ln1": norm_specs(cfg.d_model, cfg.norm, layers=dl),
            "self_attn": attn.attn_specs(cfg, layers=dl),
            "ln_x": norm_specs(cfg.d_model, cfg.norm, layers=dl),
            "cross_attn": attn.attn_specs(cfg, layers=dl, cross=True),
            "ln2": norm_specs(cfg.d_model, cfg.norm, layers=dl),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp, layers=dl, bias=cfg.use_bias),
        }
        return flatten({**_embed_specs(cfg), "enc_blocks": enc,
                        "enc_norm": norm_specs(cfg.d_model, cfg.norm), "dec_blocks": dec,
                        "final_norm": norm_specs(cfg.d_model, cfg.norm)})

    def _enc_layer(self, stack, i: int, h: torch.Tensor, ctx) -> torch.Tensor:
        cfg = self.cfg
        lp = _layer(stack, i, ctx, "enc_blocks.")
        x = apply_norm(lp["ln1"], h, cfg.norm)
        h = h + attn.attn_full(lp["attn"], x, cfg, mask=MaskSpec(causal=False), ctx=ctx)
        return h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg.norm), cfg.mlp, ctx)

    def _encode(self, p, frames: torch.Tensor, ctx=None) -> torch.Tensor:
        h = cast(frames)
        for i in range(self.cfg.enc_layers):
            h = _per_layer(self._enc_layer, p["enc_blocks"], i, h, ctx)
        return apply_norm(p["enc_norm"], h, self.cfg.norm)

    def encode(self, params: dict[str, torch.Tensor], frames: torch.Tensor,
               ctx=None) -> torch.Tensor:
        """frames: (B, S_enc, D), the stub frontend's output -> the encoder's
        states (B, S_enc, D) in the compute dtype (over a mesh: the rank's
        rows of the batch in, the same rows out)."""
        return self._encode(unflatten(params), frames, ctx)

    def _cross(self, lp, h: torch.Tensor, enc_out: torch.Tensor, ctx) -> torch.Tensor:
        """Cross-attention and the MLP: the second and third parts of a decoder layer."""
        cfg = self.cfg
        xx = apply_norm(lp["ln_x"], h, cfg.norm)
        h = h + attn.attn_full(lp["cross_attn"], xx, cfg, mask=MaskSpec(causal=False),
                               rope=False, kv_source=enc_out, ctx=ctx)
        return h + apply_mlp(lp["mlp"], apply_norm(lp["ln2"], h, cfg.norm), cfg.mlp, ctx)

    def _dec_layer(self, stack, i: int, h: torch.Tensor, enc_out: torch.Tensor,
                   ctx) -> torch.Tensor:
        lp = _layer(stack, i, ctx, "dec_blocks.")
        x = apply_norm(lp["ln1"], h, self.cfg.norm)
        h = h + attn.attn_full(lp["self_attn"], x, self.cfg, mask=MaskSpec(causal=True), ctx=ctx)
        return self._cross(lp, h, enc_out, ctx)

    def loss(self, params: dict[str, torch.Tensor], batch, ctx=None):
        """batch: ``{"frames" (B, S_enc, D), "tokens", "labels" (B, S)}``.
        Returns (loss, metrics): the mean cross-entropy (aux 0)."""
        cfg = self.cfg
        p = unflatten(params)
        batch = _local_batch(batch, ctx)
        enc_out = self._encode(p, batch["frames"], ctx)
        h = _lookup(p, batch["tokens"], ctx, cast_first=True)
        for i in range(cfg.num_layers):
            h = _per_layer(self._dec_layer, p["dec_blocks"], i, h, enc_out, ctx)
        h = apply_norm(p["final_norm"], h, cfg.norm)
        loss = _xent(_logits(p, h, cfg, ctx), batch["labels"], cfg, ctx)
        if ctx is not None:  # the mean over the batch's data shards
            loss = ctx.pmean(loss, ("pod", "data"))
        return loss, {"xent": loss, "aux": torch.zeros((), dtype=torch.float32, device=h.device)}

    def prefill(self, params: dict[str, torch.Tensor], batch, ctx=None):
        """The encoder over ``batch["frames"]`` and the decoder over one BOS
        token (id 0): (logits (B, 1, padded_vocab), cache ``{"k", "v"}``
        (layers, B, 1, Hkv, hd) and ``"enc_out"``), as the JAX package's; over
        a mesh the rank's shard of the cache (``enc_out``: its rows)."""
        cfg = self.cfg
        specs = self.cache_specs(batch["frames"].shape[0], 1)
        p = unflatten(params)
        enc_out = self._encode(p, _local_batch(batch, ctx)["frames"], ctx)
        h = _lookup(p, torch.zeros((enc_out.shape[0], 1), dtype=torch.int64,
                                   device=enc_out.device), ctx, cast_first=True)
        cache: dict[str, torch.Tensor] = {}
        for i in range(cfg.num_layers):
            lp = _layer(p["dec_blocks"], i, ctx, "dec_blocks.")
            x = apply_norm(lp["ln1"], h, cfg.norm)
            a_out, kv = attn.attn_prefill(lp["self_attn"], x, cfg, mask=MaskSpec(causal=True),
                                          ctx=ctx)
            _write_cache(cache, i, kv, specs, cfg.num_layers, ctx)
            h = self._cross(lp, h + a_out, enc_out, ctx)
        h = apply_norm(p["final_norm"], h, cfg.norm)
        return _whole_logits(_logits(p, h[:, -1:], cfg, ctx), cfg, ctx), {**cache,
                                                                          "enc_out": enc_out}

    def cache_specs(self, batch: int, cache_len: int, *,
                    long_mode: bool = False) -> dict[str, ParamSpec]:
        """``k``/``v`` (layers, B, cache_len, Hkv, hd) and ``enc_out`` (B,
        enc_seq, d_model), all bf16."""
        cfg = self.cfg
        shape = (cfg.num_layers,) + attn.init_cache_shape(cfg, batch, cache_len)
        axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        return {
            "k": ParamSpec(shape, axes, dtype=torch.bfloat16, init="zeros"),
            "v": ParamSpec(shape, axes, dtype=torch.bfloat16, init="zeros"),
            "enc_out": ParamSpec((batch, cfg.enc_seq, cfg.d_model),
                                 ("batch", "frames", "embed_act"), dtype=torch.bfloat16,
                                 init="zeros"),
        }

    def decode_step(self, params: dict[str, torch.Tensor], cache: dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: int, ctx=None, *, long_mode: bool = False):
        """tokens (B, 1); the cache's ``enc_out`` set by the caller (the
        engine encodes the frames into it; over a mesh, the rank's rows).
        Returns (logits, cache), ``k``/``v`` updated in place."""
        cfg = self.cfg
        p = unflatten(params)
        h = _lookup(p, tokens if ctx is None else ctx.local_batch(tokens), ctx)
        enc_out = cache["enc_out"]
        for i in range(cfg.num_layers):
            lp = _layer(p["dec_blocks"], i, ctx, "dec_blocks.")
            x = apply_norm(lp["ln1"], h, cfg.norm)
            a_out, _ = attn.attn_decode(lp["self_attn"], x,
                                        {"k": cache["k"][i], "v": cache["v"][i]}, pos, cfg,
                                        ctx=ctx)
            h = self._cross(lp, h + a_out, enc_out, ctx)
        h = apply_norm(p["final_norm"], h, cfg.norm)
        return _whole_logits(_logits(p, h, cfg, ctx), cfg, ctx), cache


def build(cfg: ArchConfig) -> DecoderLM | EncDecLM:
    return EncDecLM(cfg) if cfg.is_encdec else DecoderLM(cfg)
