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

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding import ParamSpec

COMPUTE_DTYPE = torch.bfloat16


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


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


def apply_mlp(params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ cast(params["gate"])) * (x @ cast(params["up"]))
    else:
        h = x @ cast(params["up"])
        if "up_b" in params:
            h = h + cast(params["up_b"])
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    out = h @ cast(params["down"])
    if "down_b" in params:
        out = out + cast(params["down_b"])
    return out


# -- attention ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MaskSpec:
    causal: bool = True
    window: int = 0  # 0 = unlimited; >0 = sliding window


def flash_attention(q, k, v, *, mask: MaskSpec, q_positions=None, k_positions=None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd) with H % Hkv == 0 -> (B, Sq, H, hd).

    Positions default to ``arange``.  ``hd_v != hd`` (MLA) is not ported.
    """
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               q_positions=q_positions, k_positions=k_positions,
                               causal=mask.causal, window=mask.window, scale=scale)


def decode_attention(q, k_cache, v_cache, k_positions, cur_pos: int, *, window: int = 0,
                     scale: float | None = None) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S, Hkv, hd); k_positions: (S,) absolute
    positions held in each cache slot (ring buffers permute them); cur_pos:
    the current position.  Masked to k_pos <= cur_pos (and the sliding
    window if set): the causal mask at ``q_positions = [cur_pos]``.
    """
    q_positions = torch.full((1,), cur_pos, dtype=torch.int32, device=q.device)
    return ops.flash_attention(q.contiguous(), k_cache, v_cache, q_positions=q_positions,
                               k_positions=k_positions, causal=True, window=window, scale=scale)
