"""Mamba-1 selective SSM (falcon-mamba, hymba's SSM heads), as ``repro/models/mamba.py``.

Training path: a depthwise causal conv, then the selective scan
``h_t = A_t h_{t-1} + B_t`` as an associative scan over the sequence, the
composition ``(a1, b1) . (a2, b2) = (a2 a1, a2 b1 + b2)`` combined in the
order of ``jax.lax.associative_scan`` (pairs reduced, the half-length scan
recursed, the even elements filled in and the two interleaved): log2(S)
levels of whole-tensor products, not S steps.  The JAX package has no Pallas
kernel here; neither has the port.

Decode path: O(1) per token, carrying (conv_state, ssm_state), updated in
place in the caller's cache.

The four products go through ``layers.linear`` under their leaf names, so
over a mesh (``sharding.MeshCtx``) each rank runs its share of the
``ssm_inner`` channels: ``in_proj`` gives it its channels of x and of z (a
part-wise split, ``sharding.FUSED``), the conv, ``dt``, the scan and the
skip act per channel with no communication, ``x_proj`` sums the ranks'
partial (dt_r, B, C) ("g"), ``dt_proj`` maps the whole dt_r onto the rank's
channels and ``out_proj`` sums again.  B and C, whole on every rank, are
read by its channels alone (``ctx.split_read``).  The channels a rank
computes are those of its shard of the decode cache's ``conv`` and ``h``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cast, linear
from repro_torch.sharding import ParamSpec


def ssm_specs(cfg, layers: int | None = None, d_override: int | None = None) -> dict[str, ParamSpec]:
    s = cfg.ssm
    d = d_override or cfg.d_model
    di, n, cw = s.d_inner, s.state, s.conv_width
    r = s.dt_rank or max(cfg.d_model // 16, 1)
    lead = (layers,) if layers else ()
    la = ("layers",) if layers else ()
    return {
        "in_proj": ParamSpec(lead + (d, 2 * di), la + ("embed", "ssm_inner"), init="scaled"),
        "conv_w": ParamSpec(lead + (cw, di), la + ("conv", "ssm_inner"), init="scaled"),
        "conv_b": ParamSpec(lead + (di,), la + ("ssm_inner",), init="zeros"),
        "x_proj": ParamSpec(lead + (di, r + 2 * n), la + ("ssm_inner", None), init="scaled"),
        "dt_proj": ParamSpec(lead + (r, di), la + ("ssm_dt", "ssm_inner"), init="scaled"),
        "dt_bias": ParamSpec(lead + (di,), la + ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec(lead + (di, n), la + ("ssm_inner", "ssm_state"), init="ones"),
        "d_skip": ParamSpec(lead + (di,), la + ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec(lead + (di, d), la + ("ssm_inner", "embed"), init="scaled"),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, di), w (cw, di)."""
    cw = w.shape[0]
    s = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(cw):  # tap i multiplies x[t - (cw-1-i)]
        shifted = F.pad(x, (0, 0, cw - 1 - i, 0))[:, :s]
        out = out + shifted * w[i]
    return out + b


def _ssm_params(p, x_in: torch.Tensor, cfg, ctx=None):
    """Common projections: returns (dt, a, b_in, c_out) for scan/step.

    ``F.softplus`` returns x itself above x = 20 where ``jax.nn.softplus``
    adds log1p(exp(-x)) < 2.1e-9: below the rounding of either dtype."""
    s = cfg.ssm
    r = s.dt_rank or max(cfg.d_model // 16, 1)
    xdb = linear(x_in, p["x_proj"], "x_proj", ctx)  # (..., r + 2n)
    dt_r, b_ssm, c_ssm = torch.split(xdb, [r, s.state, s.state], dim=-1)
    if ctx is not None:  # whole on every rank, read by its channels
        b_ssm = ctx.split_read(b_ssm, "ssm_inner", s.d_inner)
        c_ssm = ctx.split_read(c_ssm, "ssm_inner", s.d_inner)
    dt = F.softplus(linear(dt_r, p["dt_proj"], "dt_proj", ctx) + cast(p["dt_bias"]))  # (..., di)
    a = -torch.exp(p["a_log"].float())  # (di, n)
    return dt, a, b_ssm, c_ssm


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 1 (``even`` one longer
    at most)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1) if even.shape[1] > n else out


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``(a, b)`` pairs under :func:`_combine` along dim 1,
    in ``jax.lax.associative_scan``'s order of combination."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def apply_ssm(p, x: torch.Tensor, cfg, ctx=None) -> torch.Tensor:
    """Full-sequence selective scan. x: (B, S, D_in) -> (B, S, D_in)."""
    xz = linear(x, p["in_proj"], "in_proj", ctx)  # (B, S, 2di)
    x_in, z = xz.chunk(2, dim=-1)
    x_in = F.silu(_causal_conv(x_in, cast(p["conv_w"]), cast(p["conv_b"])))
    dt, a, b_ssm, c_ssm = _ssm_params(p, x_in, cfg, ctx)

    # linear recurrence h_t = A_t h_{t-1} + B_t, associative over t
    a_bar = torch.exp(dt[..., None].float() * a)  # (B, S, di, n)
    # b_ssm: (B, S, n) -> (B, S, 1, n); dt*x: (B, S, di) -> (B, S, di, 1)
    b_bar = (dt * x_in).float()[..., None] * b_ssm.float()[..., None, :]
    _, h = associative_scan(a_bar, b_bar)
    y = (h * c_ssm.float()[..., None, :]).sum(-1)  # (B, S, di)
    y = y.to(x.dtype) + cast(p["d_skip"]) * x_in
    y = y * F.silu(z)
    return linear(y, p["out_proj"], "out_proj", ctx)


def init_ssm_cache_shape(cfg, batch: int) -> dict[str, tuple[int, ...]]:
    s = cfg.ssm
    return {
        "conv": (batch, s.conv_width - 1, s.d_inner),
        "h": (batch, s.d_inner, s.state),
    }


def apply_ssm_decode(p, x: torch.Tensor, cache, cfg, ctx=None):
    """One-token step. x: (B, 1, D_in); cache: {'conv', 'h'}, updated in
    place.  Returns (out (B, 1, D_in), cache)."""
    xz = linear(x, p["in_proj"], "in_proj", ctx)
    x_in, z = xz[:, 0].chunk(2, dim=-1)  # (B, di)
    # conv ring: window = [conv_state, x_in]
    win = torch.cat([cache["conv"], x_in[:, None]], dim=1)  # (B, cw, di)
    conv_out = (win * cast(p["conv_w"])[None]).sum(1) + cast(p["conv_b"])
    x_c = F.silu(conv_out)
    dt, a, b_ssm, c_ssm = _ssm_params(p, x_c, cfg, ctx)
    a_bar = torch.exp(dt[..., None].float() * a)  # (B, di, n)
    b_bar = (dt * x_c).float()[..., None] * b_ssm.float()[..., None, :]
    h = a_bar * cache["h"] + b_bar  # (B, di, n)
    y = (h * c_ssm.float()[..., None, :]).sum(-1).to(x.dtype)
    y = y + cast(p["d_skip"]) * x_c
    y = y * F.silu(z)
    out = linear(y, p["out_proj"], "out_proj", ctx)[:, None]
    cache["conv"].copy_(win[:, 1:])
    cache["h"].copy_(h)
    return out, cache
