"""Shared layers: norms, RoPE, MLPs and attention, as in ``repro/models/layers.py``.

Functions over explicit parameter dicts.  Compute dtype is bf16 (parameters
f32, cast at use — the JAX package's mixed precision); norm and RoPE
statistics in f32.  Attention goes through ``kernels/ops.py``: the
hand-written kernel on the card, its plain version on the CPU, both with
f32 scores, softmax and accumulation (the JAX package rounds scores and
probabilities to bf16 on the way; see ``tests/test_torch_attention.py`` for
the tolerance that costs).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.kernels import ops
from repro_torch.sharding import ParamSpec

COMPUTE_DTYPE = torch.bfloat16
HEAD_DIM_GRANULE = 16  # bf16 head dims the tensor-core attention kernels take: multiples of this


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def linear(x: torch.Tensor, w: torch.Tensor, name: str, ctx=None,
           eq: str | None = None) -> torch.Tensor:
    """``x @ cast(w)``, or ``einsum(eq, x, cast(w))``: the activation ``x``
    times the weight whose leaf name is ``name``; over a mesh, ``ctx.linear``
    places the collectives around the product (``sharding.product_plans``)."""
    w = cast(w)
    product = torch.matmul if eq is None else functools.partial(torch.einsum, eq)
    return product(x, w) if ctx is None else ctx.linear(name, x, w, product)


# -- norms ---------------------------------------------------------------------
def norm_specs(d: int, kind: str, layers: int | None = None) -> dict[str, ParamSpec]:
    shape = ((layers,) if layers else ()) + (d,)
    axes = (("layers",) if layers else ()) + ("embed_act",)
    out = {"scale": ParamSpec(shape, axes, init="ones")}
    if kind == "layernorm":
        out["bias"] = ParamSpec(shape, axes, init="zeros")
    return out


def apply_norm(params, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"].float()
        out = out + params["bias"].float()
    return out.to(x.dtype)


# -- rotary position embeddings --------------------------------------------------
def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) broadcastable to x.shape[:-2]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    angles = angles[..., None, :]  # heads axis
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLPs -------------------------------------------------------------------------
def mlp_specs(d: int, f: int, kind: str, layers: int | None = None,
              bias: bool = False) -> dict[str, ParamSpec]:
    lead = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    out = {}
    if kind == "swiglu":
        out["gate"] = ParamSpec(lead + (d, f), lax_ + ("embed", "mlp"), init="scaled")
        out["up"] = ParamSpec(lead + (d, f), lax_ + ("embed", "mlp"), init="scaled")
        out["down"] = ParamSpec(lead + (f, d), lax_ + ("mlp", "embed"), init="scaled")
    else:  # gelu
        out["up"] = ParamSpec(lead + (d, f), lax_ + ("embed", "mlp"), init="scaled")
        out["down"] = ParamSpec(lead + (f, d), lax_ + ("mlp", "embed"), init="scaled")
        if bias:
            out["up_b"] = ParamSpec(lead + (f,), lax_ + ("mlp",), init="zeros")
            out["down_b"] = ParamSpec(lead + (d,), lax_ + ("embed_act",), init="zeros")
    return out


def apply_mlp(params, x: torch.Tensor, kind: str, ctx=None) -> torch.Tensor:
    with trace.span("mlp", x) as sp:
        x = sp.inputs(x)
        if kind == "swiglu":
            h = F.silu(linear(x, params["gate"], "gate", ctx)) * linear(x, params["up"], "up", ctx)
        else:
            h = linear(x, params["up"], "up", ctx)
            if "up_b" in params:
                h = h + cast(params["up_b"])
            h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
        out = linear(h, params["down"], "down", ctx)
        if "down_b" in params:
            out = out + cast(params["down_b"])
        return sp.outputs(out)


# -- attention ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MaskSpec:
    causal: bool = True
    window: int = 0  # 0 = unlimited; >0 = sliding window


def flash_attention(q, k, v, *, mask: MaskSpec, q_positions=None, k_positions=None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k: (B, Sk, Hkv, hd); v: (B, Sk, Hkv, hd_v) with
    H % Hkv == 0 and hd_v <= hd -> (B, Sq, H, hd_v).

    Positions default to ``arange``; the scale to 1/sqrt(hd).  The kernels
    take V at its own head dim (MLA: hd 192, hd_v 128); the tensor-core ones
    (and the backward kernel) take bf16 head dims that are multiples of
    ``HEAD_DIM_GRANULE``, so in bf16 each head dim is zero-padded to the next
    multiple of the granule (MLA-smoke's q/k 24 -> 32; its hd_v 16 stays 16)
    and the output sliced back.  Zero columns change no score and give output
    columns of P 0 = 0; under autograd the padding's gradient is dropped.
    Differentiable: under autograd the gradient is the backward kernel on the
    card (``kernels/ops.py::FlashAttention``), where the JAX package lets XLA
    differentiate its chunked attention.
    """
    hd, hd_v = q.shape[-1], v.shape[-1]
    if hd_v > hd:
        raise ValueError(f"flash_attention: hd_v {hd_v} exceeds the q/k head dim {hd}")
    width, width_v = hd, hd_v
    if q.dtype == torch.bfloat16:
        width = -(-hd // HEAD_DIM_GRANULE) * HEAD_DIM_GRANULE
        width_v = -(-hd_v // HEAD_DIM_GRANULE) * HEAD_DIM_GRANULE
    if width != hd:
        q, k = F.pad(q, (0, width - hd)), F.pad(k, (0, width - hd))
        scale = 1.0 / math.sqrt(hd) if scale is None else scale
    if width_v != hd_v:
        v = F.pad(v, (0, width_v - hd_v))
    with trace.span("attn.kernel", q) as sp:
        q, k, v = sp.inputs(q.contiguous(), k.contiguous(), v.contiguous())
        o = ops.flash_attention(q, k, v, q_positions=q_positions, k_positions=k_positions,
                                causal=mask.causal, window=mask.window, scale=scale)
        return sp.outputs(o)[..., :hd_v]


def decode_attention(q, k_cache, v_cache, k_positions, cur_pos: int, *, window: int = 0,
                     scale: float | None = None, with_lse: bool = False):
    """Single-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S, Hkv, hd); k_positions: (S,) absolute
    positions held in each cache slot (ring buffers permute them); cur_pos:
    the current position.  Masked to k_pos <= cur_pos (and the sliding
    window if set): the causal mask at ``q_positions = [cur_pos]``.
    ``with_lse``: (o, lse (B, H, 1) f32), the rows' log-sum-exp, -1e30 for a
    row that sees no key of this cache (a shard of a sequence-sharded one).
    """
    q_positions = torch.full((1,), cur_pos, dtype=torch.int32, device=q.device)
    fn = ops.flash_attention_lse if with_lse else ops.flash_attention
    return fn(q.contiguous(), k_cache, v_cache, q_positions=q_positions,
              k_positions=k_positions, causal=True, window=window, scale=scale)
