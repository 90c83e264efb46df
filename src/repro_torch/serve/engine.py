"""Batched serving engine: greedy decode with a KV cache.

The read-optimized half of the system: weights arrive through Shelby
verified reads (see ``launch/serve.py``), then a batch of prompts is decoded
step by step from position 0 (the JAX package's prefill-free flow of
``repro/serve/engine.py``); an encoder-decoder first encodes its frames
into the cache.  Every step's attention runs the hand-written kernel on the
card.  Given a ``sharding.MeshCtx``, each rank holds its shard of the
weights and builds its shard of the cache (``ctx.local_shape``; an
encoder-decoder encodes its rows of the frames into it); prompts and
frames go in and tokens come out whole on every rank.
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
                 ctx: AxisCtx | None = None, max_len: int = 256, long_mode: bool = False):
        self.cfg = cfg
        self.params = params
        self.ctx = ctx or AxisCtx()
        self.max_len = max_len
        self.long_mode = long_mode
        self.model = build(cfg)
        self.device = next(iter(params.values())).device
        self.stats = ServeStats()

    def _empty_cache(self, batch: int) -> dict[str, torch.Tensor]:
        specs = self.model.cache_specs(batch, self.max_len, long_mode=self.long_mode)
        return {name: torch.zeros(self.ctx.local_shape(s), dtype=s.dtype, device=self.device)
                for name, s in specs.items()}

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, num_tokens: int, *, frames=None) -> np.ndarray:
        """prompts: (B, P) int -> (B, P + num_tokens) int32.  Greedy decoding via
        the decode path from position 0.  ``frames`` (B, enc_seq, d_model):
        an encoder-decoder's input, encoded once into the cache's ``enc_out``
        (bf16), as the JAX package's engine does."""
        b, p = prompts.shape
        cache = self._empty_cache(b)
        if self.cfg.is_encdec:
            if frames is None:
                raise ValueError(f"{self.cfg.name} is an encoder-decoder: generate needs frames")
            frames = self.ctx.local_batch(torch.as_tensor(frames, device=self.device))
            enc_out = self.model.encode(self.params, frames, self.ctx)
            cache["enc_out"] = enc_out.to(torch.bfloat16)
        given = torch.as_tensor(np.asarray(prompts, np.int64), device=self.device)
        out = [given[:, i] for i in range(p)]
        tok = given[:, :1]
        for pos in range(p + num_tokens - 1):
            logits, cache = self.model.decode_step(self.params, cache, tok, pos, self.ctx,
                                                   long_mode=self.long_mode)
            if pos + 1 < p:
                tok = given[:, pos + 1 : pos + 2]
            else:
                nxt = logits[:, -1].argmax(-1).clamp_(max=self.cfg.vocab - 1)
                out.append(nxt)
                tok = nxt[:, None]
            self.stats.decoded_tokens += b
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
