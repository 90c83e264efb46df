"""train_step / serve_step builders, as ``repro/train/step.py``.

``make_train_step`` returns a (state, batch) -> (state, metrics) function
with microbatched gradient accumulation (one microbatch's activations held
at a time, f32 gradients summed in order and averaged) and AdamW.
``make_prefill_step`` / ``make_decode_step`` are the serving entry points.
There is no mesh: ``shard_grad_accum`` with one raises.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import build
from repro_torch.train import optimizer as opt

_NOT_PORTED = "is not ported (ROADMAP Queue 1 item 4)"


def make_loss_fn(cfg: ArchConfig, ctx=None):
    model = build(cfg)

    def loss_fn(params, batch):
        return model.loss(params, batch, ctx)

    return loss_fn


def make_train_step(cfg: ArchConfig, ctx=None, adamw: opt.AdamWConfig | None = None,
                    num_microbatches: int = 1, shard_grad_accum: bool = False):
    if shard_grad_accum and getattr(ctx, "mesh", None) is not None:
        raise NotImplementedError(f"make_train_step: shard_grad_accum over a mesh {_NOT_PORTED}")
    adamw = adamw or opt.AdamWConfig()
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
            grads = {k: g / num_microbatches for k, g in grads.items()}
            loss = torch.stack(losses).mean()
        new_state, opt_metrics = opt.update(state, grads, adamw)
        return new_state, {"loss": loss, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig, ctx=None):
    model = build(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, ctx)

    return prefill_step


def make_decode_step(cfg: ArchConfig, ctx=None, *, long_mode: bool = False):
    model = build(cfg)

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, ctx, long_mode=long_mode)

    return decode_step
