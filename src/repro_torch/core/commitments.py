"""Vector commitments (§3.4): Merkle trees over erasure-coded chunks.

* Protocol-grade path: SHA-256 (hashlib), used for everything whose digest
  is bound on-chain — chunk roots, blob roots, audit-proof verification by
  the smart contract.
* Bulk path: ``bulk_sample_digests``, xxhash32-style digests of many 1 KiB
  samples at once through the ``sample_hash`` kernel, for high-volume
  off-chain sample checks.

Layout (paper §2.1 + Figure 2):
  Chunk  = alpha x w bytes  ->  SAMPLE_BYTES samples  ->  Merkle root_chunk
  Chunkset -> n chunks      ->  Merkle over chunk roots  ->  root_chunkset
  Blob   -> chunksets       ->  Merkle over chunkset roots -> root_blob
Audit proofs are (sample bytes, path-to-chunk-root) plus the chunk->blob
binding kept in on-chain metadata.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

SAMPLE_BYTES = 1024  # "around 1 KiB" (§2.1)


def h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def _pair(a: bytes, b: bytes) -> bytes:
    return h(b"\x01" + a + b)


def _leaf(data: bytes) -> bytes:
    return h(b"\x00" + data)


@dataclasses.dataclass(frozen=True)
class MerkleProof:
    index: int
    path: tuple[bytes, ...]  # sibling hashes, leaf -> root

    @property
    def nbytes(self) -> int:
        return 4 + sum(len(p) for p in self.path)


class MerkleTree:
    """Binary Merkle tree with duplicate-last padding to a power of two."""

    def __init__(self, leaves: list[bytes]):
        if not leaves:
            raise ValueError("empty tree")
        hashes = [_leaf(x) for x in leaves]
        self.num_leaves = len(hashes)
        size = 1
        while size < len(hashes):
            size *= 2
        hashes = hashes + [hashes[-1]] * (size - len(hashes))
        levels = [hashes]
        while len(levels[-1]) > 1:
            prev = levels[-1]
            levels.append([_pair(prev[i], prev[i + 1]) for i in range(0, len(prev), 2)])
        self.levels = levels

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    def prove(self, index: int) -> MerkleProof:
        assert 0 <= index < self.num_leaves
        path = []
        i = index
        for level in self.levels[:-1]:
            sib = i ^ 1
            path.append(level[sib])
            i //= 2
        return MerkleProof(index=index, path=tuple(path))


def verify(root: bytes, leaf_data: bytes, proof: MerkleProof) -> bool:
    node = _leaf(leaf_data)
    i = proof.index
    for sib in proof.path:
        node = _pair(node, sib) if i % 2 == 0 else _pair(sib, node)
        i //= 2
    return node == root


# -- chunk / chunkset / blob commitment stack ---------------------------------
def chunk_samples(chunk: np.ndarray) -> list[bytes]:
    """Split a chunk (uint8, any shape) into SAMPLE_BYTES-sized samples."""
    flat = np.ascontiguousarray(chunk, dtype=np.uint8).reshape(-1)
    pad = -flat.size % SAMPLE_BYTES
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
    return [flat[i : i + SAMPLE_BYTES].tobytes() for i in range(0, flat.size, SAMPLE_BYTES)]


@dataclasses.dataclass(frozen=True)
class ChunkCommitment:
    root: bytes
    num_samples: int


def commit_chunk(chunk: np.ndarray) -> tuple[ChunkCommitment, MerkleTree]:
    samples = chunk_samples(chunk)
    tree = MerkleTree(samples)
    return ChunkCommitment(root=tree.root, num_samples=len(samples)), tree


def commit_roots(roots: list[bytes]) -> tuple[bytes, MerkleTree]:
    tree = MerkleTree(list(roots))
    return tree.root, tree


# -- bulk (vectorized) sample digests ----------------------------------------
def bulk_sample_digests(samples: np.ndarray, seed: int = 0, device=None) -> np.ndarray:
    """samples: (L, SAMPLE_BYTES) uint8 -> (L,) uint32 through the ``sample_hash`` kernel.

    Each sample is read as little-endian uint32 words.  ``device=None``
    means the card (and raises without one); ``"cpu"`` runs the plain version.
    """
    samples = np.asarray(samples)
    if samples.dtype != np.uint8 or samples.ndim != 2 or samples.shape[1] % 4:
        raise ValueError("bulk_sample_digests: samples must be (L, 4*W) uint8, "
                         f"got {samples.dtype} {samples.shape}")
    words = np.ascontiguousarray(samples).view("<u4").astype(np.uint32, copy=False)
    digests = ops.sample_hash(torch.from_numpy(words).to(resolve_device(device)), seed=seed)
    return digests.cpu().numpy()
