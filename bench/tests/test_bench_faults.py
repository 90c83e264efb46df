"""A run with the timed path broken underneath comes out not correct: the
driver run on the CPU at the SMOKE presets, the harness's look for a chip
skipped, once sound (its readings set the limits here, five times each) and
once for each fault a training cell can have on one chip."""
from __future__ import annotations

import numpy as np
import pytest
import smoke_cell
import torch

CELLS = ["starcoder2-3b.train_4k", "deepseek-v2-lite-16b.train_16k"]
SEED = 3_000_000_019
ROOM = 5.0  # limits at five times the sound run's readings


@pytest.fixture(autouse=True)
def _one_thread():
    old = smoke_cell.one_thread()
    yield
    torch.set_num_threads(old)


def _limits(out) -> dict:
    return {c.name: ROOM * c.value for c in out.checks if c.name != "tokens_wrong"}


def _unchanged_state(monkeypatch):
    from repro_torch.train import optimizer

    def update(state, grads, cfg, ctx=None):
        return state, {"grad_norm": optimizer.global_norm(grads), "lr": torch.zeros(())}

    monkeypatch.setattr(optimizer, "update", update)


def _half_batch(monkeypatch):
    from repro_torch.models.model import DecoderLM

    loss = DecoderLM.loss

    def half(self, params, batch, ctx=None):
        return loss(self, params, {k: v[: max(v.shape[0] // 2, 1)] if v.shape[0] > 1
                                   else v[:, : v.shape[1] // 2] for k, v in batch.items()}, ctx)

    monkeypatch.setattr(DecoderLM, "loss", half)


def _token_altered(monkeypatch):
    from repro_torch.data.pipeline import BlobTokenDataset

    read = BlobTokenDataset._next_batch

    def altered(self):
        x, y = read(self)
        x = np.array(x)
        x[0, 0] = (x[0, 0] + 1) % 256
        return x, y

    monkeypatch.setattr(BlobTokenDataset, "_next_batch", altered)


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _token_altered])
def test_a_broken_step_comes_out_not_correct(cell_name, fault, monkeypatch):
    cell = smoke_cell.smoke_cell(cell_name)
    sound = smoke_cell.run_smoke(cell, SEED, seconds=0.2)
    limits = _limits(sound)
    assert all(c.ok for c in sound.checks if c.name == "tokens_wrong")
    fault(monkeypatch)
    broken = smoke_cell.run_smoke(cell, SEED, seconds=0.2, limits=limits)
    failed = [c.name for c in broken.checks if not c.ok]
    assert failed, [(c.name, c.value, c.limit) for c in broken.checks]
