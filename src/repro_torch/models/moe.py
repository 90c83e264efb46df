"""Routed mixture-of-experts (GShard/Switch-style top-k with capacity), as
``repro/models/moe.py``'s local path.

Dispatch is sort-free *scatter-by-position*: positions inside each expert
come from a stable argsort of the (token, k) expert assignments; an
assignment past an expert's capacity is dropped (the token keeps its other
experts and the residual), the GShard capacity-factor semantics.  Routing,
dispatch and the expert products are plain PyTorch, as the JAX package
computes them outside any Pallas kernel.

Over a mesh with a ``model`` axis (``sharding.MeshCtx``), the JAX package's
expert-parallel ``shard_map`` path (:func:`_moe_ep`): each rank routes its
data shard of the tokens over all experts and runs its own experts, whose
weights ``MeshCtx.gather`` all-gathers over ``data`` where they are FSDP
shards; the ranks' partial outputs are summed over ``model`` and the aux
loss averaged over every rank.  The dry-run (``launch/dryrun.py``) traces
that path on rank 0 of a trace mesh.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import distributed, trace
from repro_torch.models.layers import cast, linear
from repro_torch.sharding import ParamSpec, require_mesh_ctx


def moe_specs(cfg, layers: int) -> dict[str, ParamSpec]:
    m = cfg.moe
    d = cfg.d_model
    out = {
        "router": ParamSpec((layers, d, m.num_experts), ("layers", "embed_act", None), init="scaled"),
        "gate": ParamSpec(
            (layers, m.num_experts, d, m.expert_d_ff),
            ("layers", "experts", "expert_embed", "expert_mlp"), init="scaled",
        ),
        "up": ParamSpec(
            (layers, m.num_experts, d, m.expert_d_ff),
            ("layers", "experts", "expert_embed", "expert_mlp"), init="scaled",
        ),
        "down": ParamSpec(
            (layers, m.num_experts, m.expert_d_ff, d),
            ("layers", "experts", "expert_mlp", "expert_embed"), init="scaled",
        ),
    }
    if m.num_shared:
        f_sh = m.shared_d_ff or m.expert_d_ff * m.num_shared
        out["shared_gate"] = ParamSpec((layers, d, f_sh), ("layers", "embed", "mlp"), init="scaled")
        out["shared_up"] = ParamSpec((layers, d, f_sh), ("layers", "embed", "mlp"), init="scaled")
        out["shared_down"] = ParamSpec((layers, f_sh, d), ("layers", "mlp", "embed"), init="scaled")
    return out


def _route(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """(T, D) -> (idx (T, k), weights (T, k), aux_loss scalar, counts (E,):
    the assignments each expert received).

    The top k by a stable descending sort: of equal probabilities the lower
    expert id comes first, as ``jax.lax.top_k`` orders them."""
    logits = x_flat.float() @ router_w.float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :top_k], idx[:, :top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux: E * sum_e(fraction_e * prob_e)
    e = probs.shape[-1]
    flat = idx.reshape(-1)  # counts by a scatter: bincount's length depends on the data
    counts = torch.zeros(e, dtype=torch.int64, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    frac = counts.float() / idx.numel()
    aux = e * torch.sum(frac * probs.mean(0))
    return idx, weights.to(x_flat.dtype), aux, counts


def _routed(x_flat: torch.Tensor, router_w: torch.Tensor, cfg, lo: int, hi: int,
            capacity: int):
    """:func:`_route` (idx, weights, aux) under its span; while a profiler
    records, experts [lo, hi)'s assignments, the slots they fill and those
    dropped past ``capacity`` are counted on the device."""
    with trace.span("moe.route", x_flat) as sp:
        idx, weights, aux, counts = _route(sp.inputs(x_flat), router_w, cfg.moe.top_k)
        weights, aux = sp.outputs(weights, aux)
        if trace.counting():
            mine = counts[lo:hi]
            assigned, filled = mine.sum(), mine.clamp(max=capacity).sum()
            trace.count("moe.assignments", assigned)
            trace.count("moe.slots_filled", filled)
            trace.count("moe.dropped", assigned - filled)
            trace.count("moe.slots", (hi - lo) * capacity)
    return idx, weights, aux


def _dispatch_indices(idx: torch.Tensor, num_experts: int, capacity: int, lo: int, hi: int):
    """(T, k) expert ids -> scatter destinations into an (hi-lo)*C buffer.

    Entries routed to experts outside [lo, hi) or beyond capacity map to the
    drop slot (= size).  Returns (dest (T*k,), src_token (T*k,)).
    """
    t, k = idx.shape
    dev = idx.device
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(num_experts, dtype=sorted_e.dtype, device=dev))
    pos_in_e = torch.arange(t * k, device=dev) - first[sorted_e]
    local = (sorted_e >= lo) & (sorted_e < hi) & (pos_in_e < capacity)
    size = (hi - lo) * capacity
    dest_sorted = torch.where(local, (sorted_e - lo) * capacity + pos_in_e, size)
    inv = torch.argsort(order, stable=True)
    dest = dest_sorted[inv]  # back to (token, k) order
    src_token = torch.arange(t * k, device=dev) // k
    return dest, src_token


def _expert_ffn(buf: torch.Tensor, gate_w, up_w, down_w) -> torch.Tensor:
    """buf: (E_loc, C, D) -> (E_loc, C, D) via per-expert SwiGLU."""
    g = torch.einsum("ecd,edf->ecf", buf, cast(gate_w))
    u = torch.einsum("ecd,edf->ecf", buf, cast(up_w))
    h = F.silu(g) * u
    return torch.einsum("ecf,efd->ecd", h, cast(down_w))


def _moe_local(x_flat: torch.Tensor, params_l, cfg, lo: int, hi: int, capacity: int):
    """Token dispatch + expert FFN for experts [lo, hi) of those ``params_l`` holds."""
    experts = tuple(params_l[name][lo:hi] for name in ("gate", "up", "down"))
    idx, weights, aux = _routed(x_flat, params_l["router"], cfg, lo, hi, capacity)
    return _experts(x_flat, idx, weights, cfg, lo, hi, capacity, experts), aux


def _experts(x_flat: torch.Tensor, idx, weights, cfg, lo: int, hi: int, capacity: int,
             experts) -> torch.Tensor:
    """The routed tokens' outputs of experts [lo, hi): dispatch, FFN, combine."""
    m = cfg.moe
    t, d = x_flat.shape
    e_loc = hi - lo
    size = e_loc * capacity
    with trace.span("moe.dispatch", x_flat) as sp:
        xs = sp.inputs(x_flat)
        dest, src = _dispatch_indices(idx, m.num_experts, capacity, lo, hi)
        # row `size` is the drop slot: every dropped assignment lands there (which
        # write wins is unspecified) and it is cut off before anything reads it
        buf = xs.new_zeros((size + 1, d)).index_put((dest,), xs[src])
        buf = sp.outputs(buf[:size].reshape(e_loc, capacity, d))
    with trace.span("moe.experts", buf) as sp:
        out_buf = sp.outputs(_expert_ffn(sp.inputs(buf), *experts))
    with trace.span("moe.combine", out_buf) as sp:
        out_buf, weights = sp.inputs(out_buf, weights)
        padded = torch.cat([out_buf.reshape(size, d), x_flat.new_zeros((1, d))])
        vals = padded[torch.clamp(dest, max=size)]
        vals = torch.where((dest < size)[:, None], vals, 0.0)
        return sp.outputs((vals.reshape(t, m.top_k, d) * weights[..., None]).sum(1))


def capacity_of(tokens: int, cfg) -> int:
    """Slots per expert for ``tokens`` routed tokens, the JAX package's
    expression (a Python float product, rounded up, at least top_k)."""
    m = cfg.moe
    return max(int(math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor)), m.top_k)


def _moe_ep(x_flat: torch.Tensor, params_l, cfg, ctx):
    """The expert-parallel path (``repro/models/moe.py``'s ``shard_map``) on
    this rank: its ``t_local`` tokens ``x_flat`` routed over all experts, its
    experts' outputs (``params_l`` holds their weights, gathered whole over
    ``data``), summed over ``model`` ("g"; the JAX package's ``psum``); the
    aux loss averaged over every rank (``pmean``).  The dispatched tokens and
    the routing weights pass "f", so each rank's partial gradient is summed
    before it meets the router's, which every rank holds whole."""
    ax = ctx.mesh.axis("model")
    e_loc = cfg.moe.num_experts // ax.size
    lo = ax.index * e_loc
    capacity = capacity_of(x_flat.shape[0], cfg)
    idx, weights, aux = _routed(x_flat, params_l["router"], cfg, lo, lo + e_loc, capacity)
    experts = tuple(params_l[name] for name in ("gate", "up", "down"))
    y = _experts(distributed.copy_f(x_flat, ax), idx, distributed.copy_f(weights, ax), cfg,
                 lo, lo + e_loc, capacity, experts)
    return distributed.reduce_g(y, ax), ctx.pmean(aux, tuple(ctx.mesh.shape))


def apply_moe(params_l, x: torch.Tensor, cfg, ctx=None):
    """x: (B, S, D) -> (out, aux_loss).  params_l: this layer's slice.

    Over a mesh with a ``model`` axis (``sharding.MeshCtx``: x is the rank's
    data shard) the expert-parallel path :func:`_moe_ep`."""
    m = cfg.moe
    b, s, d = x.shape
    mesh = getattr(ctx, "mesh", None)
    x_flat = x.reshape(-1, d)
    if mesh is not None and "model" in mesh.shape:
        require_mesh_ctx(ctx, "the expert-parallel MoE")
        y, aux = _moe_ep(x_flat, params_l, cfg, ctx)
    else:
        y, aux = _moe_local(x_flat, params_l, cfg, 0, m.num_experts,
                            capacity_of(x_flat.shape[0], cfg))
    out = y.reshape(b, s, d)
    # shared experts (DeepSeek): a dense SwiGLU alongside the routed path
    if m.num_shared:
        with trace.span("moe.shared", x) as sp:
            xs = sp.inputs(x)
            g = linear(xs, params_l["shared_gate"], "shared_gate", ctx)
            u = linear(xs, params_l["shared_up"], "shared_up", ctx)
            shared = sp.outputs(linear(F.silu(g) * u, params_l["shared_down"], "shared_down",
                                       ctx))
        out = out + shared
    return out, aux
