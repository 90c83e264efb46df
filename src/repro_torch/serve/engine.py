"""Batched serving engine: greedy decode with a KV cache on one device.

The read-optimized half of the system: weights arrive through Shelby
verified reads (see ``launch/serve.py``), then a batch of prompts is decoded
step by step from position 0 (the JAX package's prefill-free flow of
``repro/serve/engine.py``).  Every step's attention runs the hand-written
kernel on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import build
from repro_torch.sharding import AxisCtx


@dataclasses.dataclass
class ServeStats:
    decoded_tokens: int = 0


class ServeEngine:
    """``params`` is the port's flat parameter dict; the engine runs on its device."""

    def __init__(self, cfg: ArchConfig, params: dict[str, torch.Tensor], *,
                 ctx: AxisCtx | None = None, max_len: int = 256):
        self.cfg = cfg
        self.params = params
        self.ctx = ctx or AxisCtx()
        self.max_len = max_len
        self.model = build(cfg)
        self.device = next(iter(params.values())).device
        self.stats = ServeStats()

    def _empty_cache(self, batch: int) -> dict[str, torch.Tensor]:
        specs = self.model.cache_specs(batch, self.max_len)
        return {name: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for name, s in specs.items()}

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, num_tokens: int) -> np.ndarray:
        """prompts: (B, P) int -> (B, P + num_tokens) int32.  Greedy decoding via
        the decode path from position 0."""
        b, p = prompts.shape
        cache = self._empty_cache(b)
        given = torch.as_tensor(np.asarray(prompts, np.int64), device=self.device)
        out = [given[:, i] for i in range(p)]
        tok = given[:, :1]
        for pos in range(p + num_tokens - 1):
            logits, cache = self.model.decode_step(self.params, cache, tok, pos, self.ctx)
            if pos + 1 < p:
                tok = given[:, pos + 1 : pos + 2]
            else:
                nxt = logits[:, -1].argmax(-1).clamp_(max=self.cfg.vocab - 1)
                out.append(nxt)
                tok = nxt[:, None]
            self.stats.decoded_tokens += b
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
