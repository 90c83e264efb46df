"""User-data layout (§2.1 + Figure 2): Blobs -> Chunksets -> Chunks -> Samples.

* Blob: arbitrary bytes (immutable once stored).
* Chunkset: fixed-size slice of the blob, ~10 MiB; the last one zero-padded.
* Chunk: one of n Clay-coded shares of a chunkset (~1 MiB at (10,6)).
* Sample: 1 KiB slice of a chunk (audit granularity).

The Clay sub-packetization (alpha sub-chunks of w bytes) forces the chunkset
size to be a multiple of k*alpha*w; w is derived from the requested chunkset
size and kept 4-byte aligned.

The layout carries the device its chunksets live on: ``partition`` puts the
blob on it, the decoded chunksets the read path hands back stay on it, and
bytes leave it only when a range is extracted for a client.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings

import torch

from repro_torch.core.clay import ClayCode, sub_packetization

DEFAULT_CHUNKSET_BYTES = 10 * 1024 * 1024  # ~10 MiB (§2.1)


@dataclasses.dataclass(frozen=True)
class BlobLayout:
    """Byte-level geometry shared by SDK, RPC nodes and SPs.

    ``device=None`` means the card; the code (and so every data-path call)
    raises without one unless ``device="cpu"`` is given.
    """

    k: int = 10
    m: int = 6
    chunkset_bytes_target: int = DEFAULT_CHUNKSET_BYTES
    device: torch.device | str | None = None

    @functools.cached_property
    def code(self) -> ClayCode:
        return ClayCode(k=self.k, m=self.m, device=self.device)

    @property
    def n(self) -> int:
        return self.k + self.m

    @functools.cached_property
    def w(self) -> int:
        """Sub-chunk bytes: chunkset splits as (k, alpha, w)."""
        alpha = sub_packetization(self.k, self.m)
        raw = -(-self.chunkset_bytes_target // (self.k * alpha))  # ceil
        return raw + (-raw % 4)  # uint32-aligned

    @property
    def chunk_bytes(self) -> int:
        return sub_packetization(self.k, self.m) * self.w

    @property
    def chunkset_bytes(self) -> int:
        return self.k * self.chunk_bytes

    @property
    def replication_overhead(self) -> float:
        """Table 1's "replication overhead": stored bytes / user bytes."""
        return self.n / self.k

    # -- blob <-> chunkset framing ------------------------------------------------
    def partition(self, data: bytes) -> torch.Tensor:
        """Blob -> zero-padded chunksets: (num_chunksets, k, alpha, w) uint8
        on the layout's device."""
        if len(data) == 0:
            raise ValueError("empty blob")
        num = self.num_chunksets(len(data))
        out = torch.empty(num * self.chunkset_bytes, dtype=torch.uint8,
                          device=self.code.device)
        with warnings.catch_warnings():
            # `bytes` is read-only; the view is only ever read from
            warnings.simplefilter("ignore", UserWarning)
            src = torch.frombuffer(data, dtype=torch.uint8)
        out[: len(data)] = src
        out[len(data):] = 0  # "the final Chunkset is zero-padded" (§3.6)
        return out.view(num, self.k, self.code.alpha, self.w)

    def num_chunksets(self, blob_len: int) -> int:
        return -(-blob_len // self.chunkset_bytes)

    def assemble(self, chunksets: list[torch.Tensor], blob_len: int) -> bytes:
        return self.extract_range(chunksets, 0, 0, blob_len, blob_len)

    def byte_range_to_chunksets(self, offset: int, length: int) -> tuple[int, int]:
        """[offset, offset+length) -> (first_chunkset, last_chunkset_inclusive)."""
        if length <= 0:
            raise ValueError("length must be positive")
        first = offset // self.chunkset_bytes
        last = (offset + length - 1) // self.chunkset_bytes
        return first, last

    def extract_range(
        self,
        chunksets: list[torch.Tensor],
        first: int,
        offset: int,
        length: int,
        blob_len: int,
    ) -> bytes:
        """Bytes [offset, offset+length) from decoded chunksets `first`..,
        clipped at `blob_len` (the final chunkset's zero padding is never
        visible to readers).  Only the requested bytes leave the device."""
        cs = self.chunkset_bytes
        start = offset - first * cs
        end = min(start + length, blob_len - first * cs, len(chunksets) * cs)
        pieces = []
        for i, chunkset in enumerate(chunksets):
            lo, hi = max(start, i * cs), min(end, (i + 1) * cs)
            if lo < hi:
                pieces.append(chunkset.reshape(-1)[lo - i * cs : hi - i * cs])
        if not pieces:
            return b""
        return torch.cat(pieces).cpu().numpy().tobytes()
