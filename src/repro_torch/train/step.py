"""train_step / serve_step builders, as ``repro/train/step.py``.

``make_train_step`` returns a (state, batch) -> (state, metrics) function
with microbatched gradient accumulation (one microbatch's activations held
at a time, f32 gradients summed in order and averaged) and AdamW.
``make_prefill_step`` / ``make_decode_step`` are the serving entry points.

Over a mesh (``sharding.MeshCtx``, which every step requires there) the
state, weights and caches are the rank's shards and the batch global.  The
backward of every FSDP gather (``distributed.fsdp_gather``)
reduce-scatters that leaf's gradient onto the rank's shard in each
microbatch, so the accumulator holds shards only: what the JAX package's
``shard_grad_accum`` asks of XLA with a sharding constraint on the
accumulator holds here with or without the flag, which is accepted for the
same signature.  The replicated leaves are summed over the ``data`` ranks
once, after the last microbatch (``MeshCtx.reduce_grads``); AdamW then
updates each rank's shard, its clipping norm counting every leaf once.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import build
from repro_torch.sharding import require_mesh_ctx
from repro_torch.train import optimizer as opt


def make_loss_fn(cfg: ArchConfig, ctx=None):
    model = build(cfg)

    def loss_fn(params, batch):
        return model.loss(params, batch, ctx)

    return loss_fn


def make_train_step(cfg: ArchConfig, ctx=None, adamw: opt.AdamWConfig | None = None,
                    num_microbatches: int = 1, shard_grad_accum: bool = False):
    """``shard_grad_accum`` changes nothing here: the FSDP gathers' backward
    already accumulates onto the shard (module docstring)."""
    adamw = adamw or opt.AdamWConfig()
    if getattr(ctx, "mesh", None) is not None:
        require_mesh_ctx(ctx, "make_train_step")
    reduce = (lambda g: g) if ctx is None else ctx.reduce_grads
    loss_fn = make_loss_fn(cfg, ctx)

    def grad_fn(params, batch):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        with torch.enable_grad():
            loss, _ = loss_fn(leaves, batch)
            # a parameter the loss never reads (an embedding-input model's
            # table, read by decode only) gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True)
        return loss.detach(), dict(zip(leaves, grads))

    def train_step(state, batch):
        params = state["params"]
        if num_microbatches == 1:
            loss, grads = grad_fn(params, batch)
            grads = reduce(grads)
        else:
            def split(x):
                return x.reshape((num_microbatches, x.shape[0] // num_microbatches) + x.shape[1:])

            mbs = {k: split(x) for k, x in batch.items()}
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
            losses = []
            for i in range(num_microbatches):
                loss_i, g = grad_fn(params, {k: x[i] for k, x in mbs.items()})
                for k, acc in grads.items():
                    acc.add_(g[k])  # in place: one f32 accumulator per parameter
                losses.append(loss_i)
            grads = reduce(grads)
            grads = {k: g / num_microbatches for k, g in grads.items()}
            loss = torch.stack(losses).mean()
        new_state, opt_metrics = opt.update(state, grads, adamw, ctx)
        return new_state, {"loss": loss, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig, ctx=None):
    """Over a mesh (a ``MeshCtx``, SERVE_RULES) the batch is global; the step
    gives the last logits whole and this rank's shard of the cache."""
    if getattr(ctx, "mesh", None) is not None:
        require_mesh_ctx(ctx, "make_prefill_step")
    model = build(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, ctx)

    return prefill_step


def make_decode_step(cfg: ArchConfig, ctx=None, *, long_mode: bool = False):
    if getattr(ctx, "mesh", None) is not None:
        require_mesh_ctx(ctx, "make_decode_step")
    model = build(cfg)

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, ctx, long_mode=long_mode)

    return decode_step
