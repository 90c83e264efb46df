"""Fault-tolerant training loop over the Shelby storage plane, as
``repro/train/loop.py``.

* **Coded checkpointing**: every ``ckpt_every`` steps the full train state
  is serialized (the JAX package's ``SHLBYCKP1`` bytes), Clay-encoded on the
  card, Merkle-committed and dispersed to SPs through the Shelby client.
* **Restart**: ``restore_latest`` rebuilds the state from any k-of-n chunks
  per chunkset (decoded on the card) and moves it to the trainer's device.
* **In-loop repair**: on the same cadence ``repair_all`` MSR-repairs lost
  chunks; an unrecoverable chunk raises ``RepairError``.

The step is ``train/step.py``'s on the trainer's device; ``run`` also
records each step's wall time (ended by reading the loss, which waits for
the card), the time spent waiting for the next batch and the checkpoint
writes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import build
from repro_torch.sharding import AxisCtx, init_params
from repro_torch.storage.checkpoint import CheckpointManager
from repro_torch.storage.repair import RepairCoordinator, RepairError
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainReport:
    steps_run: int
    final_loss: float
    losses: list[float]
    restarts: int
    repairs: int
    wall_s: float
    step_s: list[float] = dataclasses.field(default_factory=list)  # each step, data excluded
    data_s: list[float] = dataclasses.field(default_factory=list)  # waiting for each batch
    ckpt_s: float = 0.0  # checkpoint writes
    ckpt_bytes: int = 0
    repair_s: float = 0.0


class Trainer:
    def __init__(self, cfg: ArchConfig, *, ctx: AxisCtx | None = None,
                 adamw: opt_mod.AdamWConfig | None = None, num_microbatches: int = 1,
                 ckpt: CheckpointManager | None = None, repair: RepairCoordinator | None = None,
                 ckpt_every: int = 50, device=None):
        if getattr(ctx, "mesh", None) is not None and (ckpt is not None or repair is not None):
            raise NotImplementedError("checkpoints of a train state sharded over a mesh are not "
                                      "ported (ROADMAP Queue 1 item 4h)")
        self.cfg = cfg
        self.ctx = ctx or AxisCtx()
        self.device = resolve_device(device)
        self.adamw = adamw or opt_mod.AdamWConfig(warmup_steps=10)
        self.step_fn = make_train_step(cfg, self.ctx, self.adamw, num_microbatches)
        self.ckpt = ckpt
        self.repair = repair
        self.ckpt_every = ckpt_every
        self.restarts = 0

    def init_state(self, seed: int = 0) -> dict:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed`` on
        the trainer's device (the JAX package's init rules, other numbers);
        over a mesh, this rank's shard of them."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        specs = build(self.cfg).param_specs()
        params = self.ctx.shard(init_params(specs, gen, device=self.device), specs)
        return opt_mod.init_state(params)

    def restore_latest(self, template_state):
        assert self.ckpt is not None
        step = self.ckpt.latest_step()
        if step is None:
            return None, 0
        state = self.ckpt.restore(step, template_state)
        self.restarts += 1
        return _to_device(state, self.device), step

    def run(self, state, batches: Iterator, num_steps: int, *, start_step: int = 0,
            on_step: Callable | None = None) -> tuple[dict, TrainReport]:
        losses, step_s, data_s = [], [], []
        repairs, ckpt_s, ckpt_bytes, repair_s = 0, 0.0, 0, 0.0
        t0 = time.perf_counter()
        step = start_step
        for _ in range(num_steps):
            t = time.perf_counter()
            x, y = next(batches)
            batch = self._to_batch(x, y)
            t1 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step's kernels
            data_s.append(t1 - t)
            step_s.append(time.perf_counter() - t1)
            losses.append(loss)
            step += 1
            if self.ckpt is not None and step % self.ckpt_every == 0:
                t = time.perf_counter()
                ckpt_bytes += self.ckpt.save(step, state).total_bytes
                ckpt_s += time.perf_counter() - t
            if self.repair is not None and step % self.ckpt_every == 0:
                t = time.perf_counter()
                repairs += len(self.repair.repair_all())
                repair_s += time.perf_counter() - t
                if self.repair.failures:
                    # checkpoint durability is the whole point of repairing
                    # mid-run: an unrecoverable chunk must abort loudly
                    raise RepairError(
                        f"{len(self.repair.failures)} chunk(s) unrecoverable "
                        f"at step {step}: {self.repair.failures[:3]}")
            if on_step:
                on_step(step, state, loss)
        report = TrainReport(
            steps_run=num_steps, final_loss=losses[-1] if losses else float("nan"),
            losses=losses, restarts=self.restarts, repairs=repairs,
            wall_s=time.perf_counter() - t0, step_s=step_s, data_s=data_s, ckpt_s=ckpt_s,
            ckpt_bytes=ckpt_bytes, repair_s=repair_s)
        return state, report

    def _to_batch(self, x: np.ndarray, y: np.ndarray) -> dict[str, torch.Tensor]:
        tokens = torch.as_tensor(x, dtype=torch.int64, device=self.device)
        labels = torch.as_tensor(y, dtype=torch.int64, device=self.device)
        if self.cfg.is_encdec:  # the stub audio frontend: zero frames, as the JAX package's
            frames = torch.zeros((tokens.shape[0], self.cfg.enc_seq, self.cfg.d_model),
                                 dtype=torch.float32, device=self.device)
            return {"frames": frames, "tokens": tokens, "labels": labels}
        if self.cfg.input_mode == "embeddings":
            return {"embeddings": stub_embeddings(tokens, self.cfg.d_model), "labels": labels}
        return {"tokens": tokens, "labels": labels}


def stub_embeddings(tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    """The JAX package's stub frontend (``repro/train/loop.py``): each token id
    as the f32 value ``(id % 17) / 17`` broadcast to ``d_model``, made on the
    tokens' device; the bytes equal the reference's numpy array's."""
    emb = (tokens[..., None] % 17).to(torch.float32) / 17.0
    return emb.expand(*tokens.shape, d_model)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
