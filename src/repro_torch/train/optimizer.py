"""AdamW with global-norm clipping over the port's flat parameter dict, as
``repro/train/optimizer.py``.

Moments are f32, one per parameter, keyed like the parameters; the state is
``{"params", "m", "v", "step"}`` with ``step`` a 0-d int32 tensor, so a
train state serializes to the same checkpoint bytes as the JAX package's.
:func:`update` takes the reference's operations in the reference's order,
so equal gradients give equal states up to rounding.  It is functional (a
new state each step, the old one left intact), as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.sharding import flatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_state(params: dict[str, torch.Tensor]) -> dict:
    """The train state of ``params``: zero f32 moments, step 0 (on the
    parameters' device)."""
    device = next(iter(params.values())).device
    return {
        "params": params,
        "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def global_norm(tree, ctx=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaves in the JAX
    package's order.  Over a mesh the leaves are the rank's shards, and
    ``ctx.sum_once`` counts each leaf's whole once: a leaf replicated over an
    axis is not counted once per replica."""
    leaves = {k: x.float().square().sum() for k, x in flatten(tree).items()}
    total = torch.stack(list(leaves.values())).sum() if ctx is None else ctx.sum_once(leaves)
    return torch.sqrt(total)


@torch.no_grad()
def update(state: dict, grads: dict[str, torch.Tensor], cfg: AdamWConfig, ctx=None):
    """One AdamW step (with global-norm clipping). Returns (new_state, metrics).
    Over a mesh (``ctx``) each rank updates its shards."""
    step = state["step"] + 1
    gnorm = global_norm(grads, ctx)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mhat = m2 / bc1
        vhat = v2 / bc2
        step_vec = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * step_vec).to(p.dtype), m2, v2

    new_p, new_m, new_v = {}, {}, {}
    for k, p in state["params"].items():
        new_p[k], new_m[k], new_v[k] = upd(p, grads[k], state["m"][k], state["v"][k])
    return ({"params": new_p, "m": new_m, "v": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})
