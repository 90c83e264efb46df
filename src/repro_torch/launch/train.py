"""End-to-end training driver: Shelby storage plane + the PyTorch compute plane.

Builds a simulated Shelby deployment (``launch/cluster.py``: contract, 8
SPs, an RPC fleet), writes a seeded token corpus into it, then trains with
coded checkpoints, paid hedged data reads, an SP failure, a restart from
the checkpoint and MSR repair, as the JAX package's ``repro/launch/train.py``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --smoke \\
      --steps 40 --fail-at 25 [--device cpu]

``--device`` defaults to the card and raises without one; ``cpu`` runs the
plain path.  ``main`` checks, as the JAX package's does, that the loss falls
from the first quarter of the steps to the last.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get, get_smoke
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import BlobTokenDataset, write_token_corpus
from repro_torch.device import resolve_device
from repro_torch.launch.cluster import build_cluster
from repro_torch.sharding import flatten
from repro_torch.storage.checkpoint import CheckpointManager
from repro_torch.storage.repair import RepairCoordinator
from repro_torch.train.loop import TrainReport, Trainer


@dataclasses.dataclass
class TrainRun:
    """What one :func:`train` run did."""

    losses: list[float]
    reports: list[TrainReport]  # before the failure, after the restart (or the one run)
    trainer: Trainer
    dataset: BlobTokenDataset
    state: dict  # the final train state
    corpus_put_s: float
    victim: int | None = None  # the SP crashed at --fail-at
    restored_step: int | None = None
    restored_equal: bool | None = None  # restored state == the state saved at that step
    restore_s: float = 0.0
    restore_bytes: int = 0
    repairs: list = dataclasses.field(default_factory=list)  # after the restart
    repair_failures: list = dataclasses.field(default_factory=list)
    repair_s: float = 0.0
    settlement: object = None


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: ArchConfig, *, steps: int = 40, batch: int = 4, seq: int = 64,
          ckpt_every: int = 10, fail_at: int = 0, num_microbatches: int = 1,
          corpus_tokens: int = 200_000, device=None, seed: int = 0) -> TrainRun:
    dev = resolve_device(device)
    contract, sps, rpc, client = build_cluster(device=dev)

    # the corpus lives in Shelby; the pipeline is a paying, hedged read client
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, corpus_tokens, dtype=np.int32)
    t = time.perf_counter()
    corpus = write_token_corpus(client, tokens)
    corpus_put_s = time.perf_counter() - t
    ds = BlobTokenDataset(client, corpus, batch=batch, seq_len=seq)

    ckpt = CheckpointManager(client, num_host_shards=2)
    repair = RepairCoordinator(contract, sps, rpc.layout)
    trainer = Trainer(cfg, ckpt=ckpt, repair=repair, ckpt_every=ckpt_every,
                      num_microbatches=num_microbatches, device=dev)
    state = trainer.init_state(seed)
    saved = {}  # step -> the state checkpointed there (the update is functional: no copy)

    def keep(step, st, loss):
        if step % ckpt_every == 0:
            saved.clear()
            saved[step] = st

    # read in the loop's thread, as the JAX package's driver does: the checkpoint
    # writes go through the same client, which one thread at a time may use
    batches = ds.batches(steps * 2, background=False)
    run = None
    try:
        if fail_at and fail_at < steps:
            state, rep1 = trainer.run(state, batches, fail_at, on_step=keep)
            print(f"[driver] step {fail_at}: loss={rep1.final_loss:.4f} — injecting SP failure",
                  flush=True)
            victim = next(iter(sps))
            sps[victim].crash()
            # restart: restore from the coded checkpoint (k-of-n reads absorb the loss)
            t = time.perf_counter()
            restored, step0 = trainer.restore_latest(state)
            _synchronize(dev)
            restore_s = time.perf_counter() - t
            nbytes = ckpt.records[step0].total_bytes if step0 in ckpt.records else 0
            equal = None
            if restored is None:
                restored, step0 = state, fail_at
            else:
                equal = step0 in saved and all(
                    torch.equal(a, b) for a, b in zip(_leaves(restored), _leaves(saved[step0])))
                print(f"[driver] restarted from step {step0} with SP {victim} down "
                      f"({restore_s:.2f}s; restored == saved: {equal})", flush=True)
            saved.clear()
            sps[victim].recover()
            sps[victim].wipe()
            t = time.perf_counter()
            reports = repair.repair_all()
            repair_s = time.perf_counter() - t
            print(f"[driver] repaired {len(reports)} chunks (MSR where possible)"
                  + (f"; {len(repair.failures)} UNRECOVERABLE" if repair.failures else ""),
                  flush=True)
            state, rep2 = trainer.run(restored, batches, steps - step0, start_step=step0)
            run = TrainRun(rep1.losses + rep2.losses, [rep1, rep2], trainer, ds, state,
                           corpus_put_s, victim, step0, equal, restore_s, nbytes, reports,
                           list(repair.failures), repair_s)
        else:
            state, rep = trainer.run(state, batches, steps)
            run = TrainRun(rep.losses, [rep], trainer, ds, state, corpus_put_s)
    finally:
        batches.close()

    run.settlement = client.settle()  # broadcast refunds; SPs realize income
    losses = run.losses
    print(f"[driver] done: steps={len(losses)} first={losses[0]:.4f} last={losses[-1]:.4f} "
          f"reads_paid=${run.settlement.total_node_income:.6f} "
          f"sp_income=${sum(run.settlement.sp_income.values()):.6f} "
          f"cache_hits={rpc.stats.cache_hits} on {dev}", flush=True)
    return run


def loss_fell(losses: list[float]) -> bool:
    """Whether the mean of the last quarter of ``losses`` is below the first's
    (head/tail means: single steps are noisy)."""
    k = max(len(losses) // 4, 1)
    return sum(losses[-k:]) / k < sum(losses[:k]) / k


def _leaves(state: dict) -> list[torch.Tensor]:
    return list(flatten(state).values())


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="crash an SP + restart from coded checkpoint at this step")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    losses = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                   ckpt_every=args.ckpt_every, fail_at=args.fail_at, device=args.device).losses
    assert loss_fell(losses), "loss must decrease"
    return losses


if __name__ == "__main__":
    main()
