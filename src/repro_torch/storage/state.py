"""Carry stored blobs into a port deployment.

For a storage system the state that moves between implementations is the
blobs: their on-chain metadata and the coded chunks the SPs hold.  A blob
written by the JAX package (or by an earlier port deployment) is imported
here and then read through the port like any other.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import commitments as cm
from repro_torch.core.contract import BlobMetadata, BlobState, ShelbyContract
from repro_torch.storage.sp import StorageProvider

_FIELDS = tuple(f.name for f in dataclasses.fields(BlobMetadata))


def import_blobs(
    contract: ShelbyContract,
    sps: dict[int, StorageProvider],
    blobs: list[dict],
    chunks: dict[tuple[int, int, int, int], np.ndarray],
) -> list[BlobMetadata]:
    """Register `blobs` on `contract` and hand `chunks` to `sps`.

    ``blobs``: plain dicts with :class:`BlobMetadata`'s fields (``state``
    may be any enum or string with the values of :class:`BlobState`).
    ``chunks``: ``(sp_id, blob_id, chunkset, chunk) -> uint8 array``, what
    the SPs hold.  Every chunk is checked against its committed Merkle root
    before it is stored; blob ids keep their values, and the contract's next
    id moves past them.
    """
    imported = []
    for rec in blobs:
        missing = set(_FIELDS) - set(rec)
        if missing:
            raise ValueError(f"blob record lacks {sorted(missing)}")
        fields = {name: rec[name] for name in _FIELDS}
        state = fields["state"]
        fields["state"] = BlobState(getattr(state, "value", state))
        fields["chunkset_roots"] = list(fields["chunkset_roots"])
        for key in ("chunk_roots", "chunk_num_samples", "placement"):
            fields[key] = {tuple(k): v for k, v in fields[key].items()}
        meta = BlobMetadata(**fields)
        if meta.blob_id in contract.blobs:
            raise ValueError(f"blob {meta.blob_id} already exists")
        contract.blobs[meta.blob_id] = meta
        contract._next_blob = max(contract._next_blob, meta.blob_id + 1)
        imported.append(meta)
    for (sp_id, blob_id, chunkset, chunk), data in sorted(chunks.items(), key=lambda kv: kv[0]):
        data = np.asarray(data, dtype=np.uint8)
        commit, _ = cm.commit_chunk(data)
        if commit.root != contract.blobs[blob_id].chunk_roots[(chunkset, chunk)]:
            raise ValueError(f"chunk ({blob_id},{chunkset},{chunk}) does not match its root")
        if not sps[sp_id].store_chunk(blob_id, chunkset, chunk, data):
            raise IOError(f"SP {sp_id} refused chunk ({blob_id},{chunkset},{chunk})")
    return imported
