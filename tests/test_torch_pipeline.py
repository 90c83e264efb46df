"""The port's blob-backed data pipeline and fault-tolerant trainer, held
against the JAX package on the CPU (mirroring tests/test_pipeline_and_loop.py).

Twin deployments are built in both packages (tests/conftest.py's cluster:
Clay (4,2), 64 KiB chunksets, 8 SPs in 3 DCs) and driven through the same
calls.  GF coding is exact and the simulated clock's float arithmetic is
copied op for op, so batches, payments and settlements compare with ``==``.
The trainer's losses are the port's own (its weights come from a
``torch.Generator``), so they are checked for what the reference's test
checks: the loss falls, the restore lands on the last checkpoint.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import BlobTokenDataset, write_token_corpus
from repro_torch.storage.checkpoint import CheckpointManager
from repro_torch.storage.repair import RepairCoordinator
from repro_torch.train.loop import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU thread pool makes these small shapes slower, not faster."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def twin(pkg: str):
    """tests/conftest.py's ``cluster`` in package ``pkg``: (contract, sps, rpc, client)."""
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    layout = _mod(pkg, "storage.blob").BlobLayout(k=4, m=2, chunkset_bytes_target=64 * 1024, **kw)
    contract = _mod(pkg, "core.contract").ShelbyContract()
    SPInfo = _mod(pkg, "core.placement").SPInfo
    sps = {}
    for i in range(8):
        contract.register_sp(SPInfo(sp_id=i, stake=1000.0, dc=f"dc{i % 3}", rack=f"r{i % 4}"))
        sps[i] = _mod(pkg, "storage.sp").StorageProvider(i)
    rpc = _mod(pkg, "storage.rpc").RPCNode("rpc0", contract, sps, layout, cache_chunksets=16)
    client = _mod(pkg, "storage.sdk").ShelbyClient(contract, rpc, deposit=1e9)
    return contract, sps, rpc, client


def _settlement(s) -> dict:
    return {"deposited": s.total_deposited, "refunded": s.total_refunded,
            "node_income": s.total_node_income, "sp_income": dict(s.sp_income)}


def _both(scenario):
    """Run ``scenario(pkg)`` in each package: (reference's result, port's result)."""
    return scenario("repro"), scenario("repro_torch")


@pytest.mark.parametrize("shards", [1, 2])
def test_batches_and_payments_equal_the_reference(shards):
    """Every batch of every shard, epoch wraps included, and what the reads
    paid: equal in both packages."""
    def scenario(pkg):
        _, _, rpc, client = twin(pkg)
        toks = np.random.default_rng(2).integers(0, 50_000, 30_000, dtype=np.int32)
        bid = _mod(pkg, "data.pipeline").write_token_corpus(client, toks)
        out = []
        for shard in range(shards):
            ds = _mod(pkg, "data.pipeline").BlobTokenDataset(
                client, bid, batch=3, seq_len=40, shard=shard, num_shards=shards, seed=5)
            out += [(x.copy(), y.copy()) for x, y in ds.batches(90, background=False)]
        return out, _settlement(client.settle()), rpc.stats.cache_hits

    (want, want_paid, want_hits), (got, paid, hits) = _both(scenario)
    assert len(got) == len(want) == 90 * shards
    for (x, y), (wx, wy) in zip(got, want):
        assert x.dtype == np.int32 and np.array_equal(x, wx) and np.array_equal(y, wy)
    assert paid == want_paid and hits == want_hits


def test_dataset_batches_shift_labels():
    _, _, _, client = twin("repro_torch")
    toks = np.arange(50_000, dtype=np.int32) % 97
    bid = write_token_corpus(client, toks)
    ds = BlobTokenDataset(client, bid, batch=4, seq_len=16)
    for x, y in ds.batches(5, background=False):
        assert x.shape == (4, 16) and y.shape == (4, 16)
        assert np.array_equal(x[:, 1:], y[:, :-1])


def test_dataset_sharding_disjoint():
    _, _, _, client = twin("repro_torch")
    bid = write_token_corpus(client, np.arange(50_000, dtype=np.int32))
    d0 = BlobTokenDataset(client, bid, batch=2, seq_len=8, shard=0, num_shards=2)
    d1 = BlobTokenDataset(client, bid, batch=2, seq_len=8, shard=1, num_shards=2)
    x0, _ = next(d0.batches(1, background=False))
    x1, _ = next(d1.batches(1, background=False))
    assert not np.array_equal(x0, x1)


def test_dataset_survives_sp_crash_as_the_reference():
    """An SP holding the corpus's first chunk is down: hedged k-of-n reads
    give the same batches, the same payments, in both packages."""
    def scenario(pkg):
        contract, sps, rpc, client = twin(pkg)
        bid = _mod(pkg, "data.pipeline").write_token_corpus(
            client, np.arange(50_000, dtype=np.int32))
        sps[contract.blobs[bid].placement[(0, 0)]].crash()
        rpc._cache.clear()
        ds = _mod(pkg, "data.pipeline").BlobTokenDataset(client, bid, batch=2, seq_len=8)
        out = [(x.copy(), y.copy()) for x, y in ds.batches(4, background=False)]
        return out, _settlement(client.settle()), rpc.stats.chunks_requested

    (want, want_paid, want_req), (got, paid, req) = _both(scenario)
    assert all(np.array_equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w))
    assert got[0][0].shape == (2, 8) and paid == want_paid and req == want_req


def test_prefetch_thread_gives_the_foreground_batches():
    """The background worker reads the same batches in the same order; a
    consumer that stops early stops it; an error in it reaches the consumer."""
    _, _, _, client = twin("repro_torch")
    bid = write_token_corpus(client, np.random.default_rng(4).integers(0, 999, 20_000,
                                                                        dtype=np.int32))
    fore = [x for x, _ in BlobTokenDataset(client, bid, batch=2, seq_len=30, seed=1)
            .batches(12, background=False)]
    ds = BlobTokenDataset(client, bid, batch=2, seq_len=30, seed=1, prefetch=2)
    back = [x for x, _ in ds.batches(12)]
    assert all(np.array_equal(a, b) for a, b in zip(fore, back)) and len(back) == 12
    gen = ds.batches(50)
    next(gen)
    gen.close()
    assert not ds._thread.is_alive()
    broken = BlobTokenDataset(client, bid, batch=2, seq_len=30)
    broken.blob_id = 10**6  # no such blob
    with pytest.raises(KeyError):  # raised in the worker, re-raised here
        next(broken.batches(3))


def test_trainer_loss_decreases_and_restarts():
    contract, sps, rpc, client = twin("repro_torch")
    cfg = get_smoke("granite-8b")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, 100_000, dtype=np.int32)
    bid = write_token_corpus(client, toks)
    ds = BlobTokenDataset(client, bid, batch=4, seq_len=32)
    ckpt = CheckpointManager(client, num_host_shards=2)
    repair = RepairCoordinator(contract, sps, rpc.layout)
    tr = Trainer(cfg, ckpt=ckpt, repair=repair, ckpt_every=4, device="cpu")

    state = tr.init_state()
    batches = ds.batches(40, background=False)
    state, rep = tr.run(state, batches, 10)
    assert rep.losses[-1] < rep.losses[0]
    assert sorted(ckpt.records) == [4, 8] and rep.ckpt_bytes > 0

    # crash an SP, restore from the coded checkpoint, keep training
    victim = next(iter(sps))
    sps[victim].crash()
    rpc._cache.clear()
    restored, step0 = tr.restore_latest(state)
    assert restored is not None and step0 == 8 and int(restored["step"]) == 8
    sps[victim].recover()
    sps[victim].wipe()
    assert len(repair.repair_all()) > 0 and not repair.failures
    state2, rep2 = tr.run(restored, batches, 4, start_step=step0)
    assert np.isfinite(rep2.final_loss) and int(state2["step"]) == 12
    assert tr.restarts == 1


def test_trainer_raises_on_an_unrecoverable_chunk():
    """More SPs lost than the code tolerates: the in-loop repair aborts the run."""
    contract, sps, rpc, client = twin("repro_torch")
    cfg = get_smoke("yi-9b")
    bid = write_token_corpus(client, np.arange(20_000, dtype=np.int32) % cfg.vocab)
    ds = BlobTokenDataset(client, bid, batch=2, seq_len=16)
    repair = RepairCoordinator(contract, sps, rpc.layout)
    tr = Trainer(cfg, repair=repair, ckpt_every=2, device="cpu")
    state = tr.init_state()
    batches = iter(list(ds.batches(2, background=False)))  # read before the SPs go
    state, _ = tr.run(state, batches, 1)
    meta = contract.blobs[bid]
    for c in range(3):  # three chunks of one chunkset of a (4,2) code
        sps[meta.placement[(0, c)]].wipe()
    from repro_torch.storage.repair import RepairError

    with pytest.raises(RepairError, match="unrecoverable"):
        tr.run(state, batches, 1, start_step=1)
