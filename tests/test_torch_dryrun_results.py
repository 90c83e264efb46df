"""The port's recorded dry-run matrix (``results/dryrun_h100``) is complete,
fits the card and is current: the counterpart of ``tests/test_dryrun_results.py``.

Every (arch x shape x mesh) cell has a record; none failed; the skipped
cells are the JAX package's (long_500k for every pure full-attention
architecture); an ``ok`` cell names 256 or 512 devices, fits one H100's
memory (``launch/dryrun.py::H100_BUDGET_BYTES``) and carries the
collectives its trace through ``MeshCtx`` made (bytes and calls of each
kind, every kind the JAX package names, an all-reduce in every cell); and
two cells traced again here give their committed records exactly, so the
matrix cannot go stale.
"""
import json
import pathlib

import pytest

from repro_torch.configs import ALL_ARCHS, get
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun

RESULTS = pathlib.Path(__file__).resolve().parent.parent / "results" / "dryrun_h100"
RERUN = [("whisper-tiny", "train_4k", "single"), ("hymba-1.5b", "long_500k", "multi")]


@pytest.fixture(scope="module")
def records() -> dict:
    recs = {}
    for p in RESULTS.glob("*.json"):
        r = json.loads(p.read_text())
        assert p.stem == dryrun._cell_id(r["arch"], r["shape"], r["mesh"])
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def test_matrix_is_complete(records):
    want = {(a, s.name, m) for a in ALL_ARCHS for s in SHAPES for m in ("single", "multi")}
    assert set(records) == want
    assert len(records) == 80


def test_all_cells_green(records):
    bad = [k for k, r in records.items() if r["status"] == "error"]
    assert not bad, f"failed cells: {bad}"
    assert sum(r["status"] == "ok" for r in records.values()) == 64


def test_expected_skips_only(records):
    skipped = {k for k, r in records.items() if r["status"] == "skipped"}
    expect_skip = {
        (a, "long_500k", m)
        for a in ALL_ARCHS if a not in ("hymba-1.5b", "falcon-mamba-7b")
        for m in ("single", "multi")
    }
    assert skipped == expect_skip
    assert all(not get(a).supports_long for a, _, _ in skipped)


def test_devices_and_microbatches(records):
    for (a, s, m), r in records.items():
        if r["status"] != "ok":
            continue
        assert r["devices"] == (512 if m == "multi" else 256), (a, s, m)
        assert r["num_microbatches"] >= 1


def test_memory_within_the_cards_budget(records):
    over = []
    for key, r in records.items():
        if r["status"] != "ok":
            continue
        mem = r["memory"]
        assert mem["budget_bytes"] == dryrun.H100_BUDGET_BYTES
        assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
        if mem["peak_bytes"] > mem["budget_bytes"]:
            over.append((key, mem["peak_bytes"] / 1e9))
    assert not over, f"cells over the card's memory: {over}"


def test_costs_recorded(records):
    for key, r in records.items():
        if r["status"] != "ok":
            continue
        assert r["cost"]["flops"] > 0 and r["cost"]["bytes"] > 0, key
        coll = r["collectives"]
        assert {"all-reduce", "all-gather", "reduce-scatter"} <= set(coll), key
        assert all(c["bytes"] >= 0 and c["count"] >= 0 and (c["bytes"] > 0) == (c["count"] > 0)
                   for c in coll.values()), key
        assert coll["all-reduce"]["count"] > 0, key
        assert (coll["reduce-scatter"]["count"] > 0) == (r["shape"] == "train_4k"), key
        # attention runs in a kernel but in the SSM family and MLA's absorbed decode
        family = get(r["arch"]).family
        kernel = not (family == "ssm" or (family == "mla_moe" and r["shape"] == "decode_32k"))
        assert (r["kernels"].get("flash_attention", {}).get("launches", 0) > 0) == kernel, key


@pytest.mark.parametrize("cell", RERUN, ids=lambda c: "__".join(c))
def test_rerun_reproduces_the_committed_record(records, cell):
    got = json.loads(json.dumps(dryrun.run_cell(*cell)))
    assert got == records[cell]
