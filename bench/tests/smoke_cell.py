"""A cell of the benchmark cut to the port's SMOKE presets, run on the CPU
through the driver: the harness's look for a chip skipped, everything else
as a run takes it."""
from __future__ import annotations

import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import torch  # noqa: E402

SMOKE_WIDTHS = {
    "starcoder2": dict(hidden_size=64, intermediate_size=256, num_attention_heads=4,
                       num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
                       rope_theta=10000.0),
    "deepseek_v2": dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                        intermediate_size=128, vocab_size=256, num_hidden_layers=3,
                        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                        n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
                        n_shared_experts=2, rope_theta=10000.0),
}


def file_cell(name: str):
    """The cell ``<config>.<traffic>`` from its files alone, with the metrics
    of the benchmark's first cell: also a configuration that no cell of
    ``BENCHMARK.json`` runs yet (starcoder2-3b)."""
    import json

    from cells import Cell, load_cell

    config, traffic = name.split(".", 1)
    first = load_cell(json.loads((BENCH.parent / "BENCHMARK.json").read_text())
                      ["workloads"][0]["name"])
    return Cell(name, 1, json.loads((BENCH / "configs" / f"{config}.json").read_text()),
                json.loads((BENCH / "traffic" / f"{traffic}.json").read_text()),
                first.end_to_end, first.per_layer)


def smoke_cell(name: str):
    """``name``'s cell (from its files) with the widths of its port's SMOKE
    preset, a 256 KiB corpus and batches of 4 rows of 32 tokens (64 for a 16k
    mix)."""
    cell = file_cell(name)
    cell.config = {**cell.config, **SMOKE_WIDTHS[cell.config["reference"]]}
    cell.traffic = {**cell.traffic, "corpus_bytes": 256 * 1024, "batch": 4, "microbatches": 2,
                    "seq": 64 if cell.traffic["seq"] > 4096 else 32}
    return cell


READ = {"loss_gap": 1.0, "grad_leaf_gap": 1.0, "change_leaf_gap": 1.0}  # read, none failing


def run_smoke(cell, seed: int, seconds: float = 0.5, trace: bool = False, limits=None):
    """One run of ``cell`` on the CPU; ``limits`` replaces the cell's (at the
    SMOKE presets a cell's own, set at its chip sizes, do not apply), by
    default ``READ``."""
    import checks
    import drivers.train as driver
    from repro_torch.configs import get_smoke
    from repro_torch.storage.blob import BlobLayout

    arch = get_smoke(cell.config["port"]["arch"])
    saved = driver.port_config, checks.limits
    driver.port_config = lambda config: arch
    checks.limits = lambda name: READ if limits is None else limits
    try:
        return driver.run(cell, seed, seconds, trace, t_start=time.perf_counter(), device="cpu",
                          layout=BlobLayout(k=10, m=6, chunkset_bytes_target=64 * 1024))
    finally:
        driver.port_config, checks.limits = saved


def one_thread():
    """torch's CPU pool on a shared machine makes small shapes far slower."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    return old
