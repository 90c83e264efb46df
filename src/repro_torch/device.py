"""Device selection for the port's entry points.

Everything runs on the card by default.  The CPU is used only when a caller
asks for it by name (the tests do), and the meta device (shapes and dtypes,
nothing allocated) only when the dry-run (``launch/dryrun.py``) asks for it;
a missing GPU is an error, never a silent fallback.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card.  Raise if the card asked for is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
