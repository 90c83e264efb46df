"""Public entry to the port's kernels: dispatch on the operands' device.

``repro_torch.core``/``repro_torch.storage`` call only these wrappers.  A
CUDA tensor goes to the hand-written kernel (which raises on what it does
not take); the plain PyTorch version runs only because a tensor lies on
the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gf_matmul as _gf


def gf_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matmul: the CUDA kernel on the card, the plain version on the CPU."""
    if b.device.type == "cpu":
        return _gf.gf_matmul_ref(a, b)
    return _gf.gf_matmul(a, b)
