"""The control, the reference computed in fp8 in the program's place, comes
out not correct where the program does: on the CPU at the SMOKE presets,
the limits set at five times a sound run's readings (on the chip, at the
cells' sizes, the limits of ``bench/limits`` come from the same two
readings)."""
from __future__ import annotations

import pytest
import smoke_cell
import torch
from control import control_readings


@pytest.fixture(autouse=True)
def _one_thread():
    old = smoke_cell.one_thread()
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("cell_name", ["starcoder2-3b.train_4k",
                                       "deepseek-v2-lite-16b.train_4k"])
@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_the_control_fails_a_number_the_program_passes(cell_name, seed):
    cell = smoke_cell.smoke_cell(cell_name)
    sound = smoke_cell.run_smoke(cell, seed, seconds=0.2)
    limits = {c.name: 5.0 * c.value for c in sound.checks if c.name != "tokens_wrong"}
    got = control_readings(cell, seed, torch.device("cpu"), lim=limits)
    assert any(got["control"][k] > limits[k] for k in limits), (got["control"], limits)
    assert any(got["half_batch"][k] > limits[k] for k in limits), (got["half_batch"], limits)
    assert got["control_correct"] is False and got["half_batch_correct"] is False
    assert set(got["control_checks"]) == set(limits)


def test_the_token_embedding_reads_its_own_gap_not_the_leaf_gap():
    from checks import readings

    ref = {"loss": [1.0], "grad_norm": [1.0],
           "leaf_grad_norms": {"embed": 1.0, "a": 1.0, "b": 1.0},
           "leaf_change_norms": {"embed": 1.0, "a": 1.0, "b": 1.0}}
    prog = dict(ref, leaf_grad_norms={"embed": 0.8, "a": 1.01, "b": 1.0})
    got = readings(prog, ref)
    assert got["embed_grad_gap"] == pytest.approx(0.2)
    assert got["grad_leaf_gap"] == pytest.approx(0.01)
