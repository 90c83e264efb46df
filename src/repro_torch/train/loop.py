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

Over a mesh (``ctx`` a ``sharding.MeshCtx``) the state is each rank's
shards and world rank 0 holds the Shelby client: ``ckpt`` and ``repair``
are given there and None on the other ranks, which follow rank 0 (whether
it checkpoints and repairs is broadcast once).  A save gathers the state to
rank 0 one leaf at a time (``sharding.root_from_shards``) and writes the
bytes one process would write of the whole state, so the JAX package and a
trainer on any other mesh restore them; a restore reads them on rank 0 and
hands every rank its shards under this trainer's rules
(``sharding.shards_from_root``): elastic, as the JAX package's.  Rank 0
repairs after a save while the others wait; the checkpoint bytes, the
repairs and the restarts reach every rank's report.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch import distributed as D
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import build
from repro_torch.sharding import (AxisCtx, init_params, require_mesh_ctx, root_from_shards,
                                  shards_from_root)
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
        self.cfg = cfg
        self.ctx = ctx or AxisCtx()
        self.mesh = getattr(self.ctx, "mesh", None)
        self.device = resolve_device(device) if self.mesh is None else self.mesh.device
        self.adamw = adamw or opt_mod.AdamWConfig(warmup_steps=10)
        self.step_fn = make_train_step(cfg, self.ctx, self.adamw, num_microbatches)
        self.ckpt = ckpt
        self.repair = repair
        self.ckpt_every = ckpt_every
        self.restarts = 0
        self.specs = build(cfg).param_specs()
        self.saves, self.repairs = ckpt is not None, repair is not None
        if self.mesh is not None:
            require_mesh_ctx(self.ctx, "Trainer")
            if self.mesh.rank != 0 and (self.saves or self.repairs):
                raise ValueError("on a mesh the Shelby client is world rank 0's: pass ckpt and "
                                 "repair there only")
            self.saves, self.repairs = (bool(f) for f in self._from_root([self.saves,
                                                                           self.repairs]))

    def init_state(self, seed: int = 0) -> dict:
        """Parameters drawn from a ``torch.Generator`` seeded with ``seed`` on
        the trainer's device (the JAX package's init rules, other numbers);
        over a mesh, this rank's shard of them."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        specs = build(self.cfg).param_specs()
        params = self.ctx.shard(init_params(specs, gen, device=self.device), specs)
        return opt_mod.init_state(params)

    def _from_root(self, values: list[int]) -> list[int]:
        """World rank 0's ``values`` (integers) on every rank."""
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        return [int(v) for v in D.broadcast(t, self.mesh.world, 0).cpu()]

    def restore_latest(self, template_state):
        """(the state of the latest checkpoint on the trainer's device, its
        step), or (None, 0) when there is none.  Over a mesh rank 0 reads it
        whole and every rank gets its shards (``template_state`` is not read)."""
        assert self.saves
        if self.mesh is None:
            step = self.ckpt.latest_step()
            if step is None:
                return None, 0
            state = self.ckpt.restore(step, template_state)
            self.restarts += 1
            return _to_device(state, self.device), step
        root = self.mesh.rank == 0
        step = self._from_root([-1 if not root or self.ckpt.latest_step() is None
                                else self.ckpt.latest_step()])[0]
        if step < 0:
            return None, 0
        whole = None
        if root:
            meta = {k: torch.empty(sp.shape, dtype=sp.dtype, device="meta")
                    for k, sp in self.specs.items()}
            whole = self.ckpt.restore(step, {"params": meta, "m": meta, "v": meta,
                                             "step": torch.zeros((), dtype=torch.int32)})
        state = {k: shards_from_root(None if whole is None else whole[k], self.specs,
                                     [self.ctx.rules], self.mesh)[0] for k in ("params", "m", "v")}
        state["step"] = torch.tensor(self._from_root([int(whole["step"]) if root else 0])[0],
                                     dtype=torch.int32, device=self.device)
        self.restarts += 1
        return state, step

    def _save(self, step: int, state) -> int:
        """Checkpoint ``state`` at ``step``: its bytes, on every rank."""
        if self.mesh is None:
            return self.ckpt.save(step, state).total_bytes
        whole = {k: root_from_shards(state[k], self.specs, self.ctx.rules, self.mesh)
                 for k in ("params", "m", "v")}
        nbytes = 0
        if self.mesh.rank == 0:
            nbytes = self.ckpt.save(step, {**whole, "step": state["step"].cpu()}).total_bytes
        del whole
        return self._from_root([nbytes])[0]

    def _repair_all(self) -> tuple[int, int, list]:
        """(chunks repaired, chunks unrecoverable, the first failures): rank 0
        repairs, the counts reach every rank."""
        if self.mesh is None:
            return len(self.repair.repair_all()), len(self.repair.failures), self.repair.failures
        done = failed = 0
        if self.mesh.rank == 0:
            done, failed = len(self.repair.repair_all()), len(self.repair.failures)
        done, failed = self._from_root([done, failed])
        return done, failed, self.repair.failures if self.mesh.rank == 0 else []

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
            if self.saves and step % self.ckpt_every == 0:
                t = time.perf_counter()
                ckpt_bytes += self._save(step, state)
                ckpt_s += time.perf_counter() - t
            if self.repairs and step % self.ckpt_every == 0:
                t = time.perf_counter()
                done, failed, failures = self._repair_all()
                repairs += done
                repair_s += time.perf_counter() - t
                if failed:
                    # checkpoint durability is the whole point of repairing
                    # mid-run: an unrecoverable chunk must abort loudly
                    raise RepairError(
                        f"{failed} chunk(s) unrecoverable at step {step}: {failures[:3]}")
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
