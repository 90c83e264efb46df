"""Blob-backed training-data pipeline, as ``repro/data/pipeline.py``.

Token corpora live in Shelby as blobs of little-endian int32 token ids; the
pipeline is a *paying read client*: every batch is one ``client.get_many``
call, all of the batch's example ranges routed across the RPC fleet in a
single pass (hedged k-of-n fetches, so a slow or dead SP never stalls the
input, and the chunksets the batch misses decode together on the layout's
device, through ``gf_matmul`` on the card).

The example order, shard stride and epoch wrap are the JAX package's
(``np.random.default_rng(seed)``), so both packages read the same batches
and pay the same.  A background thread keeps ``prefetch`` batches ahead of
the training loop; its decodes run on PyTorch's default stream of the
layout's device, as the training loop's kernels do.  The client is not
thread-safe: while the thread runs it must be the client's only user (a
loop that checkpoints through the same client reads in its own thread,
``background=False``).
"""
from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch

from repro_torch.storage.sdk import ShelbyClient


def write_token_corpus(client: ShelbyClient, tokens: np.ndarray) -> int:
    """tokens: 1-D int32 array -> blob id."""
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    return client.put(tokens.tobytes()).blob_id


class BlobTokenDataset:
    """Deterministic, shardable batch iterator over a token blob."""

    def __init__(self, client: ShelbyClient, blob_id: int, batch: int, seq_len: int, *,
                 shard: int = 0, num_shards: int = 1, seed: int = 0, prefetch: int = 2):
        self.client = client
        self.blob_id = blob_id
        self.batch = batch
        self.seq_len = seq_len
        self.shard = shard
        self.num_shards = num_shards
        meta = client.contract.blobs[blob_id]
        self.num_tokens = meta.size_bytes // 4
        self.tokens_per_example = seq_len + 1  # inputs + shifted labels
        self.num_examples = self.num_tokens // self.tokens_per_example
        self._rng = np.random.default_rng(seed)
        self._order = self._rng.permutation(self.num_examples)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._cursor = shard * batch
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def _next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        ranges = []
        for _ in range(self.batch):
            if self._cursor >= self.num_examples:
                self._cursor = self.shard * self.batch  # wrap epoch
                self._order = self._rng.permutation(self.num_examples)
            off = int(self._order[self._cursor]) * self.tokens_per_example * 4
            ranges.append((self.blob_id, off, self.tokens_per_example * 4))
            self._cursor += self.num_shards  # stride across data-parallel shards
        # one fleet pass for the whole batch: cross-request batched decode
        receipts = self.client.get_many(ranges)
        arr = np.stack([np.frombuffer(r.data, dtype=np.int32) for r in receipts])
        return arr[:, :-1], arr[:, 1:]

    def _put(self, item) -> bool:
        """Queue ``item`` unless the consumer has gone; False if it has."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, n: int):
        device = torch.device(self.client.layout.device or "cpu")
        stream = (torch.cuda.stream(torch.cuda.default_stream(device))
                  if device.type == "cuda" else contextlib.nullcontext())
        try:
            with stream:
                for _ in range(n):
                    if not self._put(self._next_batch()):
                        return
        except BaseException as e:  # handed to the consumer, raised there
            self._put(e)

    def batches(self, n: int, *, background: bool = True):
        """Yield n (inputs, labels) batches, prefetching in a worker thread."""
        if not background:
            for _ in range(n):
                yield self._next_batch()
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, args=(n,), daemon=True)
        self._thread.start()
        try:
            for _ in range(n):
                item = self._q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:  # a consumer that stops early (or is closed) stops the worker
            self._stop.set()
            self._thread.join()
