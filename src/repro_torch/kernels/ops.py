"""Public entry to the port's kernels: dispatch on the operands' device.

``repro_torch.core``/``repro_torch.storage``/``repro_torch.models`` call only
these wrappers.  A CUDA tensor goes to the hand-written kernel (which raises
on what it does not take); the plain PyTorch version runs only because a
tensor lies on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gf_matmul as _gf
from repro_torch.kernels import sample_hash as _sh


def gf_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matmul: the CUDA kernel on the card, the plain version on the CPU."""
    if b.device.type == "cpu":
        return _gf.gf_matmul_ref(a, b)
    return _gf.gf_matmul(a, b)


def sample_hash(words: torch.Tensor, *, seed: int = 0) -> torch.Tensor:
    """Bulk sample digests: the CUDA kernel on the card, the plain version on the CPU."""
    if words.device.type == "cpu":
        return _sh.sample_hash_ref(words, seed=seed)
    return _sh.sample_hash(words, seed=seed)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions=None, k_positions=None, causal: bool = True,
                    window: int = 0, scale: float | None = None) -> torch.Tensor:
    """Attention with explicit positions: the CUDA kernel on the card, the
    plain version on the CPU (see ``kernels/flash_attention.py``)."""
    fn = _fa.flash_attention_ref if q.device.type == "cpu" else _fa.flash_attention
    return fn(q, k, v, q_positions=q_positions, k_positions=k_positions, causal=causal,
              window=window, scale=scale)
