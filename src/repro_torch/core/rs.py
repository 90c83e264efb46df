"""Systematic MDS base code over GF(2^8) with a Vandermonde parity check.

Both (a) the Reed-Solomon baseline Clay codes are compared against and
(b) the per-plane base code of the coupled-layer construction in
``clay.py``.  An ``[n, k]`` code with ``m = n - k`` parity symbols and a
Vandermonde parity-check matrix ``H`` (m x n): every ``m x m`` column
submatrix is invertible, so any ``k`` symbols determine the rest.

The small coefficient matrices are numpy (setup-time linear algebra); the
data path multiplies them into uint8 tensors through ``matmul=`` — by
default :func:`repro_torch.kernels.ops.gf_matmul`, the CUDA kernel for
tensors on the card and its plain version for tensors on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import gf
from repro_torch.kernels import ops


def _coeffs(mat: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(mat, np.uint8)).to(like.device)


@dataclasses.dataclass(frozen=True)
class MDSCode:
    n: int
    k: int

    @property
    def m(self) -> int:
        return self.n - self.k

    @functools.cached_property
    def parity_check(self) -> np.ndarray:
        """H: (m, n) Vandermonde parity-check matrix."""
        return gf.vandermonde(self.m, self.n)

    # -- encode -------------------------------------------------------------
    @functools.cached_property
    def encode_matrix(self) -> np.ndarray:
        """(m, k) matrix P with parity = P @ data (systematic encoding).

        From H = [Hd | Hp] (split at k): Hd @ d + Hp @ p = 0
        -> p = inv(Hp) @ Hd @ d.
        """
        h = self.parity_check
        hd, hp = h[:, : self.k], h[:, self.k :]
        return gf.matmul_np(gf.mat_inv(hp), hd)

    def encode(self, data: torch.Tensor, matmul=ops.gf_matmul) -> torch.Tensor:
        """data: (k, nbytes) uint8 tensor -> codeword (n, nbytes), systematic."""
        data = torch.as_tensor(data, dtype=torch.uint8).contiguous()
        assert data.shape[0] == self.k, (data.shape, self.k)
        parity = matmul(_coeffs(self.encode_matrix, data), data)
        return torch.cat([data, parity], dim=0)

    # -- erasure decode -----------------------------------------------------
    def decode_matrix(self, known: tuple[int, ...]) -> tuple[np.ndarray, tuple[int, ...]]:
        """Solve for the erased symbols from any >= k known symbols.

        Returns (R, erased) with erased values = R @ known_values, where
        ``known`` lists the available symbol indices (uses the first k).
        """
        known = tuple(sorted(known))[: self.k]
        if len(known) < self.k:
            raise ValueError(f"need >= k={self.k} known symbols, got {len(known)}")
        erased = tuple(i for i in range(self.n) if i not in set(known))
        e = len(erased)
        if e == 0:
            return np.zeros((0, self.k), np.uint8), erased
        h = self.parity_check[:e, :]  # e rows suffice (row-prefix Vandermonde)
        he = h[:, list(erased)]  # (e, e) invertible (MDS)
        hk = h[:, list(known)]  # (e, k)
        r = gf.matmul_np(gf.mat_inv(he), hk)  # (e, k)
        return r, erased

    def decode(self, shards: dict[int, torch.Tensor], matmul=ops.gf_matmul) -> torch.Tensor:
        """Reconstruct full codeword (n, nbytes) from any k of n shards."""
        known = tuple(sorted(shards))[: self.k]
        r, erased = self.decode_matrix(known)
        stacked = torch.stack([torch.as_tensor(shards[i], dtype=torch.uint8) for i in known])
        out = torch.zeros((self.n, stacked.shape[-1]), dtype=torch.uint8, device=stacked.device)
        out[list(known)] = stacked
        if erased:
            out[list(erased)] = matmul(_coeffs(r, stacked), stacked)
        return out

    def reconstruct_data(self, shards: dict[int, torch.Tensor], matmul=ops.gf_matmul) -> torch.Tensor:
        return self.decode(shards, matmul=matmul)[: self.k]

    # -- repair (RS has no better option than full decode) -------------------
    def repair_bandwidth_bytes(self, shard_bytes: int) -> int:
        """Bytes read from helpers to repair ONE lost shard (= k full shards)."""
        return self.k * shard_bytes
