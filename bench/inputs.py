"""What the benchmark makes from ``--seed`` and hands to the program and to the
reference alike: the weights and the token corpus.

Every leaf of the weights is drawn by a ``torch.Generator`` of its own,
seeded from (seed, leaf name), on the device and in float32: one call a
leaf (the layers' weights are stacked, so a model is a few dozen calls),
and any one leaf can be drawn again by itself (the check's parameter
change needs the first weights once the program's are gone).

The corpus: ``tokens`` int32 ids drawn by a Zipf law of exponent ``s``
over the vocabulary's ranks (P(rank r) proportional to r^-s), the ranks
mapped to ids by a permutation drawn from the seed, on the device.
"""
from __future__ import annotations

import hashlib

import torch


def derived_seed(seed: int, what: str) -> int:
    """A 63-bit seed for ``what`` from the run's seed (any integer)."""
    digest = hashlib.sha256(f"{seed}/{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def make_leaf(leaf, name: str, seed: int, device) -> torch.Tensor:
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=torch.float32, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, "weights/" + name))
    return torch.randn(leaf.shape, generator=gen, dtype=torch.float32, device=device).mul_(leaf.std)


def make_weights(table: dict, seed: int, device) -> dict[str, torch.Tensor]:
    return {name: make_leaf(leaf, name, seed, device) for name, leaf in table.items()}


def zipf_corpus(n_tokens: int, vocab: int, exponent: float, seed: int, device) -> torch.Tensor:
    """(n_tokens,) int32 token ids on ``device`` (module docstring)."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, "corpus"))
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow(-exponent), 0)
    cdf /= cdf[-1].clone()
    ids = torch.randperm(vocab, generator=gen, device=device)
    u = torch.rand(n_tokens, generator=gen, dtype=torch.float64, device=device)
    rank = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    del u
    return ids[rank].to(torch.int32)
