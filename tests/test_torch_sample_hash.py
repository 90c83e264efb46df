"""The port's bulk sample digests held against the JAX package.

``sample_hash``'s plain version (the CPU path of ``kernels/ops.py``) and
``core.commitments.bulk_sample_digests`` must be bit-identical to the JAX
package's Pallas kernel (interpret mode on the CPU, as tests/test_kernels.py
runs it) on the same seeded inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import commitments as jcm
from repro.kernels import ops as jops
from repro_torch.core import commitments as tcm
from repro_torch.kernels import ops
from repro_torch.kernels import sample_hash as sh


def _digests(words: np.ndarray, seed: int = 0) -> np.ndarray:
    return ops.sample_hash(torch.from_numpy(words), seed=seed).numpy()


@pytest.mark.parametrize("leaves,words", [(1, 4), (7, 256), (300, 256), (1000, 16), (257, 64)])
def test_sample_hash_matches_pallas(leaves, words):
    rng = np.random.default_rng(leaves * 7 + words)
    w = rng.integers(0, 2**32, (leaves, words), dtype=np.uint32)
    want = np.asarray(jops.sample_hash(jnp.asarray(w)))
    got = _digests(w)
    assert got.dtype == np.uint32 and got.shape == (leaves,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jops.sample_hash_ref(jnp.asarray(w))))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 + 7])
def test_seeds_match_pallas(seed):
    w = np.random.default_rng(seed % 97).integers(0, 2**32, (33, 8), dtype=np.uint32)
    np.testing.assert_array_equal(_digests(w, seed),
                                  np.asarray(jops.sample_hash(jnp.asarray(w), seed=seed)))


def test_seed_wraps_mod_2_32():
    w = np.random.default_rng(5).integers(0, 2**32, (9, 12), dtype=np.uint32)
    np.testing.assert_array_equal(_digests(w, 2**32 + 3), _digests(w, 3))


def test_seed_sensitivity():
    w = np.zeros((10, 8), np.uint32)
    assert not np.array_equal(_digests(w, 0), _digests(w, 1))


def test_avalanche():
    """Flipping one input bit changes the digest (for every tested leaf)."""
    w = np.random.default_rng(3).integers(0, 2**32, (64, 32), dtype=np.uint32)
    w2 = w.copy()
    w2[:, 17] ^= 1
    assert (_digests(w) != _digests(w2)).all()


@pytest.mark.parametrize("leaves", [33, 257])
def test_bulk_sample_digests_match_jax(leaves):
    samples = np.random.default_rng(leaves).integers(0, 256, (leaves, tcm.SAMPLE_BYTES),
                                                     dtype=np.uint8)
    got = tcm.bulk_sample_digests(samples, device="cpu")
    assert got.dtype == np.uint32 and got.shape == (leaves,)
    np.testing.assert_array_equal(got, jcm.bulk_sample_digests(samples))
    assert len(np.unique(got)) == leaves  # distinct samples -> distinct digests


def test_bulk_sample_digests_read_little_endian_words():
    samples = np.random.default_rng(9).integers(0, 256, (5, 16), dtype=np.uint8)
    words = np.array([[int.from_bytes(bytes(row[i:i + 4]), "little") for i in range(0, 16, 4)]
                      for row in samples], dtype=np.uint32)
    np.testing.assert_array_equal(tcm.bulk_sample_digests(samples, seed=2, device="cpu"),
                                  _digests(words, 2))


@pytest.mark.parametrize("bad", [np.zeros((4, 1022), np.uint8), np.zeros((4, 256), np.uint32),
                                 np.zeros(1024, np.uint8)])
def test_bulk_sample_digests_reject_bad_samples(bad):
    with pytest.raises(ValueError):
        tcm.bulk_sample_digests(bad, device="cpu")


def test_wrapper_checks_and_never_runs_the_plain_version():
    with pytest.raises(TypeError):
        sh.sample_hash_ref(torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        sh.sample_hash_ref(torch.zeros((4, 2), dtype=torch.uint32).t())
    launches = sh.sample_hash.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        sh.sample_hash(torch.zeros((2, 4), dtype=torch.uint32))
    assert sh.sample_hash.launches == launches


def test_bulk_sample_digests_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcm.bulk_sample_digests(np.zeros((2, 1024), np.uint8))
