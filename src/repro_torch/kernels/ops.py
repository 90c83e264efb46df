"""Public entry to the port's kernels: dispatch on the operands' device.

``repro_torch.core``/``repro_torch.storage``/``repro_torch.models`` call only
these wrappers.  A CUDA tensor goes to the hand-written kernel (which raises
on what it does not take); the plain PyTorch version runs only because a
tensor lies on the CPU.

``flash_attention`` is differentiable: when autograd records (grad enabled
and q, k or v requires grad) it runs as :class:`FlashAttention`, whose
forward keeps the row log-sum-exp and whose backward is the hand-written
backward kernel on the card (``kernels/flash_attention_bwd.py``), the plain
versions on the CPU.  Calls without a gradient (serving) take the path they
always took.

On the meta device (the dry-run, ``launch/dryrun.py``) each wrapper runs its
kernel's checks and allocations (the code the card path allocates with) and
neither the kernel nor the plain version, and declares the operations and
bytes of the launch to every open cost analysis (``launch/cost_analysis.py``
registers itself in ``COST_LISTENERS``): those are not aten ops, so the
analysis would not see them otherwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import gf_matmul as _gf
from repro_torch.kernels import sample_hash as _sh


COST_LISTENERS: list = []  # open cost analyses: told each kernel's launch on the meta device


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _declare(name: str, flops: float, nbytes: int) -> None:
    for listener in COST_LISTENERS:
        listener.kernel(name, flops, nbytes)


def gf_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matmul: the CUDA kernel on the card, the plain version on the CPU."""
    if b.device.type == "meta":
        c, flops = _gf.gf_matmul_meta(a, b)
        _declare("gf_matmul", flops, _nbytes(a, b, c))
        return c
    if b.device.type == "cpu":
        return _gf.gf_matmul_ref(a, b)
    return _gf.gf_matmul(a, b)


def sample_hash(words: torch.Tensor, *, seed: int = 0) -> torch.Tensor:
    """Bulk sample digests: the CUDA kernel on the card, the plain version on the CPU."""
    if words.device.type == "meta":
        out, flops = _sh.sample_hash_meta(words, seed=seed)
        _declare("sample_hash", flops, _nbytes(words, out))
        return out
    if words.device.type == "cpu":
        return _sh.sample_hash_ref(words, seed=seed)
    return _sh.sample_hash(words, seed=seed)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions=None, k_positions=None, causal: bool = True,
                    window: int = 0, scale: float | None = None) -> torch.Tensor:
    """Attention with explicit positions: the CUDA kernel on the card, the
    plain version on the CPU (see ``kernels/flash_attention.py``); under
    autograd, :class:`FlashAttention`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_positions, k_positions, causal, window, scale)
    if q.device.type == "meta":
        return _attention_meta(q, k, v, dict(q_positions=q_positions, k_positions=k_positions,
                                             causal=causal, window=window, scale=scale))[0]
    fn = _fa.flash_attention_ref if q.device.type == "cpu" else _fa.flash_attention
    return fn(q, k, v, q_positions=q_positions, k_positions=k_positions, causal=causal,
              window=window, scale=scale)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_positions=None, k_positions=None, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """(o, lse (B, H, Sq) f32) without a gradient: the CUDA kernel on the card
    ("split" for decode's few rows, with its log-sum-exp), the plain version
    on the CPU.  A sequence-sharded cache's partial attentions combine by it."""
    kw = dict(q_positions=q_positions, k_positions=k_positions, causal=causal, window=window,
              scale=scale)
    if q.device.type == "meta":
        return _attention_meta(q, k, v, kw, with_lse=True)
    fn = _fa.flash_attention_lse_ref if q.device.type == "cpu" else _fa.flash_attention_lse
    return fn(q, k, v, **kw)


class FlashAttention(torch.autograd.Function):
    """Attention whose gradient is the backward kernel: the forward saves
    (q, k, v, o, lse), v and o at v's own head dim; the backward computes
    (dq, dk, dv) from them and dO, on the card by the kernels, on the CPU by
    the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, k_positions, causal, window, scale):
        kw = dict(q_positions=q_positions, k_positions=k_positions, causal=causal,
                  window=window, scale=scale)
        if q.device.type == "meta":
            o, lse = _attention_meta(q, k, v, kw, with_lse=True)
        else:
            cpu = q.device.type == "cpu"
            fn = _fa.flash_attention_lse_ref if cpu else _fa.flash_attention_lse
            o, lse = fn(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "meta":
            dq, dk, dv, flops = _fab.flash_attention_bwd_meta(q, k, v, o, do, lse, **ctx.kw)
            _declare("flash_attention_bwd", flops, _nbytes(q, k, v, o, do, lse, dq, dk, dv))
        else:
            fn = _fab.flash_attention_bwd_ref if q.device.type == "cpu" else _fab.flash_attention_bwd
            dq, dk, dv = fn(q, k, v, o, do, lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def _attention_meta(q, k, v, kw: dict, with_lse: bool = False):
    """The attention launch on the meta device: (o, lse or None), declared."""
    o, lse, flops = _fa.flash_attention_meta(q, k, v, with_lse=with_lse, **kw)
    _declare("flash_attention", flops, _nbytes(q, k, v, o, lse))
    return o, lse
