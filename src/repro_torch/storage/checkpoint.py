"""Erasure-coded distributed checkpointing through Shelby (§6 "model weights,
checkpoints, logs"), in the JAX package's ``SHLBYCKP1`` format byte for byte.

A state tree (nested dicts/lists, or the port's flat parameter dict) is
serialized into a self-describing byte stream — magic, an 8-byte
little-endian header length, a JSON header with each leaf's shape and dtype,
then the raw little-endian buffers in leaf order (dict keys sorted, as
``jax.tree_util.tree_leaves`` orders them; no pickle) — split into per-host
shards, and each shard is written as a Shelby blob (Clay-coded,
Merkle-committed, dispersed to SPs).  A checkpoint written by either package
restores in the other.

Restore is template-based: the tree structure comes from the caller, the
bytes from Shelby.  Leaves come back as CPU tensors.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.sharding import flatten
from repro_torch.storage.sdk import ShelbyClient

_MAGIC = b"SHLBYCKP1"


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("serialize_pytree: bfloat16 leaves have no numpy dtype")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def serialize_pytree(tree) -> bytes:
    leaves = [np.asarray(_as_numpy(leaf), order="C") for leaf in flatten(tree).values()]
    metas = [{"shape": list(a.shape), "dtype": a.dtype.str} for a in leaves]
    header = json.dumps({"leaves": metas}).encode()
    return b"".join([_MAGIC, len(header).to_bytes(8, "little"), header,
                     *(a.reshape(-1).view(np.uint8) for a in leaves)])


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken from the iterator ``leaves``."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(t, leaves) for t in template)
    if template is None:
        return None
    return next(leaves)


def deserialize_pytree(data: bytes, template):
    if data[: len(_MAGIC)] != _MAGIC:
        raise ValueError("not a shelby checkpoint")
    off = len(_MAGIC)
    hlen = int.from_bytes(data[off : off + 8], "little")
    off += 8
    metas = json.loads(data[off : off + hlen].decode())["leaves"]
    off += hlen
    t_leaves = list(flatten(template).values())
    if len(t_leaves) != len(metas):
        raise ValueError(f"template has {len(t_leaves)} leaves, checkpoint {len(metas)}")
    buf = bytearray(data)  # writable, so the tensors below share it without a copy each
    leaves = []
    for meta, t in zip(metas, t_leaves):
        dt = np.dtype(meta["dtype"])
        shape = tuple(meta["shape"])
        count = int(np.prod(shape))
        arr = np.frombuffer(buf, dtype=dt, count=count, offset=off).reshape(shape)
        off += count * dt.itemsize
        t_shape = tuple(t.shape) if hasattr(t, "shape") else np.shape(t)
        if t_shape != shape:
            raise ValueError(f"shape mismatch: template {t_shape} vs ckpt {shape}")
        leaves.append(torch.from_numpy(arr))
    return _rebuild(template, iter(leaves))


def shard_bytes(data: bytes, num_shards: int) -> list[bytes]:
    per = -(-len(data) // num_shards)
    return [data[i * per : (i + 1) * per] for i in range(num_shards)]


@dataclasses.dataclass
class CheckpointRecord:
    step: int
    shard_blob_ids: list[int]
    total_bytes: int


class CheckpointManager:
    """Writes/reads checkpoints through the Shelby client; keeps last `keep`."""

    def __init__(self, client: ShelbyClient, keep: int = 3, num_host_shards: int = 1):
        self.client = client
        self.keep = keep
        self.num_host_shards = num_host_shards
        self.records: dict[int, CheckpointRecord] = {}

    def save(self, step: int, state) -> CheckpointRecord:
        data = serialize_pytree(state)
        shards = shard_bytes(data, self.num_host_shards)
        blob_ids = [self.client.put(s).blob_id for s in shards]
        rec = CheckpointRecord(step=step, shard_blob_ids=blob_ids, total_bytes=len(data))
        self.records[step] = rec
        for old in sorted(self.records)[: -self.keep]:
            del self.records[old]
        return rec

    def latest_step(self) -> int | None:
        return max(self.records) if self.records else None

    def restore(self, step: int, template, *, reading_hosts: int | None = None):
        """Elastic restore: `reading_hosts` may differ from writer shard count;
        each reading host pulls a byte range that may span writer shards."""
        rec = self.records[step]
        # all shards in one fleet pass: their chunksets batch-decode together
        receipts = self.client.get_many(
            [(bid, 0, None) for bid in rec.shard_blob_ids]
        )
        data = b"".join(r.data for r in receipts)[: rec.total_bytes]
        if reading_hosts is not None and reading_hosts != self.num_host_shards:
            # emulate: each reading host fetches its own byte range, then the
            # ranges concatenate to the full stream (any k chunks suffice).
            per = -(-len(data) // reading_hosts)
            parts = [data[i * per : (i + 1) * per] for i in range(reading_hosts)]
            data = b"".join(parts)
        return deserialize_pytree(data, template)
