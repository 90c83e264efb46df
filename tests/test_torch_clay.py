"""The port's Clay code and blob layout, held byte-identical to the JAX package.

Every comparison is exact: Clay coding is GF(2^8) arithmetic.
"""
import numpy as np
import pytest
import torch

from repro.core.clay import ClayCode as JClayCode
from repro.kernels import ops as jops
from repro.storage.blob import BlobLayout as JBlobLayout
from repro_torch.core import clay
from repro_torch.core.clay import ClayCode
from repro_torch.storage.blob import BlobLayout

CODES = [(4, 2), (10, 6)]
W = 8  # small sub-chunk width: the plane schedule, not the bytes, is under test


def _codes(k, m):
    return JClayCode(k=k, m=m), ClayCode(k=k, m=m, device="cpu")


def _data(ref, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (ref.k, ref.alpha, w), dtype=np.uint8)


def _shards(codeword, erased):
    return {i: codeword[i] for i in range(len(codeword)) if i not in erased}


@pytest.mark.parametrize("k,m", CODES)
def test_encode_matches_reference(k, m):
    ref, port = _codes(k, m)
    data = _data(ref, W, seed=k)
    out = port.encode(data)
    assert out.device.type == "cpu" and out.shape == (k + m, ref.alpha, W)
    np.testing.assert_array_equal(out.numpy(), ref.encode(data))


@pytest.mark.parametrize("k,m,erased", [(k, m, e) for k, m in CODES for e in range(k + m)])
def test_decode_every_single_erasure(k, m, erased):
    ref, port = _codes(k, m)
    cw = ref.encode(_data(ref, W, seed=100 + erased))
    shards = _shards(cw, {erased})
    np.testing.assert_array_equal(port.decode(shards).numpy(), ref.decode(shards))
    np.testing.assert_array_equal(port.decode(shards).numpy(), cw)


@pytest.mark.parametrize("kind", ["data_only", "mixed"])
@pytest.mark.parametrize("k,m", CODES)
def test_decode_random_patterns(k, m, kind):
    ref, port = _codes(k, m)
    rng = np.random.default_rng(k * 7 + m + len(kind))
    cw = ref.encode(_data(ref, W, seed=3))
    pool = k if kind == "data_only" else k + m
    for e in range(1, m + 1):
        erased = set(rng.choice(pool, min(e, pool), replace=False).tolist())
        shards = _shards(cw, erased)
        np.testing.assert_array_equal(port.decode(shards).numpy(), ref.decode(shards))
        np.testing.assert_array_equal(
            port.reconstruct_data(shards).numpy(), ref.reconstruct_data(shards))


def _mixed_sets(ref, rng, count, w):
    sets = []
    for i in range(count):
        cw = ref.encode(_data(ref, w, seed=1000 + i))
        erased = set(rng.choice(ref.n, rng.integers(0, ref.m + 1), replace=False).tolist())
        sets.append(_shards(cw, erased))
    sets.append(dict(sets[0]))  # a repeated erasure pattern stacks with its twin
    return sets


@pytest.mark.parametrize("k,m", CODES)
def test_decode_batch_across_mixed_patterns(k, m):
    ref, port = _codes(k, m)
    sets = _mixed_sets(ref, np.random.default_rng(k + m), 6, W)
    got = port.decode_batch(sets)
    for g, want in zip(got, ref.decode_batch(sets)):
        np.testing.assert_array_equal(g.numpy(), want)
    for g, want in zip(port.reconstruct_data_batch(sets), ref.reconstruct_data_batch(sets)):
        np.testing.assert_array_equal(g.numpy(), want)


def test_decode_batch_matches_pallas_reference():
    """Reference decoded through the Pallas kernel (interpret mode)."""
    ref, port = _codes(4, 2)
    sets = _mixed_sets(ref, np.random.default_rng(42), 3, 4)
    want = ref.decode_batch(sets, matmul=jops.gf_matmul_np)
    for g, w in zip(port.decode_batch(sets), want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("k,m", CODES)
def test_stacked_solves_are_cut_to_the_memory_bound(monkeypatch, k, m):
    ref, port = _codes(k, m)
    monkeypatch.setattr(clay, "STACK_BYTES", 2 * port.N * port.alpha * W)  # two per solve
    assert port.stack_limit(W) == 2
    batch = np.stack([_data(ref, W, seed=s) for s in range(5)])
    out = port.encode_batch(batch)
    for b in range(5):
        np.testing.assert_array_equal(out[b].numpy(), ref.encode(batch[b]))
    sets = _mixed_sets(ref, np.random.default_rng(9), 4, W) + [
        _shards(ref.encode(batch[b]), set()) for b in range(3)]
    for g, want in zip(port.decode_batch(sets), ref.decode_batch(sets)):
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("k,m", CODES)
def test_repair_matches_reference(k, m):
    ref, port = _codes(k, m)
    cw = ref.encode(_data(ref, W, seed=77))
    failed = k - 1
    ids = ref.repair_subchunk_ids(failed)
    assert ids == port.repair_subchunk_ids(failed)
    helpers = {i: cw[i][ids] for i in range(ref.n) if i != failed}
    np.testing.assert_array_equal(port.repair(failed, helpers), ref.repair(failed, helpers))
    np.testing.assert_array_equal(port.repair(failed, helpers), cw[failed])


def test_code_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClayCode(k=4, m=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlobLayout(k=4, m=2).code


@pytest.mark.parametrize("k,m,target", [(10, 6, 10 * 1024 * 1024), (4, 2, 256 * 1024),
                                        (4, 2, 64 * 1024)])
def test_blob_geometry_and_framing_match_reference(k, m, target):
    ref = JBlobLayout(k=k, m=m, chunkset_bytes_target=target)
    port = BlobLayout(k=k, m=m, chunkset_bytes_target=target, device="cpu")
    assert (port.w, port.chunk_bytes, port.chunkset_bytes, port.replication_overhead) == (
        ref.w, ref.chunk_bytes, ref.chunkset_bytes, ref.replication_overhead)
    if target > 1 << 20:
        return  # geometry only at the production size
    blob_len = 2 * ref.chunkset_bytes + 12_345
    data = np.random.default_rng(k + target).bytes(blob_len)
    parts = port.partition(data)
    want = ref.partition(data)
    assert parts.shape == (len(want), k, ref.code.alpha, ref.w)
    for got, w in zip(parts, want):
        np.testing.assert_array_equal(got.numpy(), w)
    chunksets = list(parts)
    assert port.assemble(chunksets, blob_len) == ref.assemble(want, blob_len) == data
    cs = ref.chunkset_bytes
    for offset, length in [(0, 1), (cs - 3, 10), (cs + 5, cs), (2 * cs + 12_000, 10_000)]:
        first, last = port.byte_range_to_chunksets(offset, length)
        assert (first, last) == ref.byte_range_to_chunksets(offset, length)
        sub = chunksets[first : last + 1]
        assert port.extract_range(sub, first, offset, length, blob_len) == ref.extract_range(
            want[first : last + 1], first, offset, length, blob_len)
