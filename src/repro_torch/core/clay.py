"""Clay (Coupled-LAYer) codes — the paper's storage code (§3.3), on the device.

The construction of Vajha et al., FAST'18: an ``(n = k+m, k, d = n-1)``
MSR+MDS code obtained by coupling ``alpha = q^t`` layers of an
``[N, N-m]`` scalar MDS base code, where

    q = d - k + 1 = m,      t = ceil(n / q),      N = q * t,

with ``s = N - n`` *shortened* (virtual, all-zero) nodes when q does not
divide n.  Every node is a point ``(x, y)`` on a q x t grid; every sub-chunk
of a node is indexed by ``z in [q]^t``; vertex ``(x, y, z)`` is *unpaired*
("diagonal") iff ``z_y == x`` and otherwise is coupled with its partner
``(z_y, y, z(y -> x))`` through the invertible pairwise transform

    C_a = U_a + g*U_b          U_a = th*(C_a + g*C_b)
    C_b = g*U_a + U_b          U_b = th*(g*C_a + C_b)        th = inv(1+g^2)

(char-2 field; g = GAMMA).  For every plane ``z`` the *uncoupled* symbols
across all N nodes form a codeword of the base MDS code.

The plane-schedule engine ``_solve`` (encode: unknowns = parity nodes;
decode: unknowns = erased nodes, any ``<= m``) works on one ``(N, alpha, W)``
uint8 tensor on the code's device, plane group by plane group in ascending
intersection score:

1. uncouple the known nodes — gathers through index tensors precomputed for
   the erasure pattern (partner flat, partner plane, diagonal or paired);
   the pairwise transform's two members, ``U_a = th*(C_a + g*C_b)`` and
   ``U_b = th*(g*C_a + C_b)``, are one expression in XOR, so the pair order
   drops out;
2. solve the base code for every plane of the group with ONE
   ``gf_matmul`` — the CUDA kernel on the card;
3. couple the unknown nodes, again by gathers.

The constant multiplies of steps 1 and 3 are plain shift/xor torch
(``gf.mul_const``); no index tensor the size of the codeword is built.
``_solve`` updates its argument in place (the callers pass a fresh
tensor), which saves a codeword-sized copy.

``repair`` (bandwidth-optimal single-node repair) runs the same three steps
on the repair planes only: the helpers' sub-chunks are copied to the device
once, uncoupled by gathers, the q column nodes' uncoupled values are solved
with ONE ``gf_matmul`` over every repair plane, and the lost chunk is
assembled by gathers over all alpha planes (``_RepairPlan``).

Storage layout: a chunk is ``(alpha, w)`` bytes; a codeword is ``(n, alpha, w)``.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch

from repro_torch.core import gf
from repro_torch.core.rs import MDSCode
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

GAMMA = 2  # gamma^2 != 1  ->  1 + gamma^2 = 5 != 0 in GF(256)
_THETA = int(gf.inv(np.uint8(1 ^ gf.pow_(GAMMA, 2))))  # inv(1 + g^2)
_ONE_PLUS_G2 = 1 ^ gf.pow_(GAMMA, 2)
_INV_GAMMA = int(gf.inv(np.uint8(GAMMA)))

#: codeword bytes one ``_solve`` may stack along the byte axis.  Batches of
#: chunksets (``encode_batch``, ``decode_batch``) larger than this are cut
#: into several solves, bounding device memory at a few times this size
#: (the codeword, its uncoupled copy and per-node temporaries).
STACK_BYTES = 2 << 30


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def sub_packetization(k: int, m: int) -> int:
    """alpha = q^t of the (k+m, k) Clay code (no device needed)."""
    return m ** _ceil_div(k + m, m)


@dataclasses.dataclass(frozen=True)
class _GroupPlan:
    """Index tensors for one intersection-score group of planes."""

    planes: torch.Tensor  # (G,) plane indices
    # known flat f: (f, diagonal planes, paired planes, partner flats, partner planes)
    known: tuple[tuple[int, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], ...]
    # unknown flat f: (f, diagonal planes,
    #                  planes paired with an unknown node, its flats, its planes,
    #                  planes paired with a known node, its flats, its planes)
    unknown: tuple[tuple[int, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor, torch.Tensor, torch.Tensor], ...]


@dataclasses.dataclass(frozen=True)
class _SolvePlan:
    r_mat: torch.Tensor  # (e, K) uint8 base-code solver
    known: torch.Tensor  # (K,) flats the solver reads
    unknown: torch.Tensor  # (e,) flats it solves for, ascending
    groups: tuple[_GroupPlan, ...]


@dataclasses.dataclass(frozen=True)
class _RepairPlan:
    """Index tensors of ``repair`` for one failed node.

    Repair planes are numbered locally (0..alpha/q-1, ``repair_planes``
    order); ``c`` below is the helpers' (N, alpha/q, w) coupled values.
    """

    r_mat: torch.Tensor  # (q, N-q) uint8: column nodes' U from the known nodes' U
    helpers: torch.Tensor  # (n-1,) flats of the helpers, ascending real index
    known: torch.Tensor  # (N-q,) the non-column flats, ascending
    # uncouple, over (known flat, repair plane): U = C if diagonal, else
    # theta*(C ^ g*C_partner); a diagonal vertex is its own "partner"
    u_flat: torch.Tensor  # (N-q, R) partner flat
    u_plane: torch.Tensor  # (N-q, R) partner's local plane
    u_diag: torch.Tensor  # (N-q, R, 1) bool
    # assembly, over all alpha planes: a repair plane is the failed vertex's
    # own U (diagonal); any other is paired with column node (z_y0, y0) on
    # local plane p: C = inv_g*(C_p ^ U_p) ^ g*U_p
    a_col: torch.Tensor  # (alpha,) column position x of the U read
    a_plane: torch.Tensor  # (alpha,) local plane of the U (and C) read
    a_flat: torch.Tensor  # (alpha,) flat of the C read
    a_rep: torch.Tensor  # (alpha, 1) bool: a repair plane


@dataclasses.dataclass(frozen=True)
class ClayCode:
    """(n=k+m, k, d=n-1) Clay code over GF(2^8) on one device.

    ``device=None`` means the card (raises without one); pass
    ``device="cpu"`` for the plain path.
    """

    k: int
    m: int
    device: torch.device | str | None = None

    def __post_init__(self):
        assert self.k >= 1 and self.m >= 1
        object.__setattr__(self, "device", resolve_device(self.device))

    # -- derived parameters ---------------------------------------------------
    @property
    def n(self) -> int:
        return self.k + self.m

    @property
    def d(self) -> int:
        return self.n - 1

    @property
    def q(self) -> int:
        return self.m

    @functools.cached_property
    def t(self) -> int:
        return _ceil_div(self.n, self.q)

    @property
    def N(self) -> int:  # extended (padded) code length
        return self.q * self.t

    @property
    def num_virtual(self) -> int:
        return self.N - self.n

    @functools.cached_property
    def alpha(self) -> int:  # sub-packetization
        return sub_packetization(self.k, self.m)

    @functools.cached_property
    def base(self) -> MDSCode:
        return MDSCode(n=self.N, k=self.N - self.m)

    # -- node indexing --------------------------------------------------------
    # Extended flat index f = y*q + x.  Real chunks occupy:
    #   data chunks   0..k-1        -> flats 0..k-1
    #   virtual zeros               -> flats k..K'-1   (K' = N - m)
    #   parity chunks k..n-1        -> flats K'..N-1
    @functools.cached_property
    def real_to_flat(self) -> tuple[int, ...]:
        kprime = self.N - self.m
        return tuple(range(self.k)) + tuple(range(kprime, self.N))

    @functools.cached_property
    def virtual_flats(self) -> tuple[int, ...]:
        return tuple(range(self.k, self.N - self.m))

    def _xy(self, flat: int) -> tuple[int, int]:
        return flat % self.q, flat // self.q

    def _flat(self, x: int, y: int) -> int:
        return y * self.q + x

    def _index(self, values) -> torch.Tensor:
        return torch.tensor(list(values), dtype=torch.long, device=self.device)

    # -- z-plane utilities ----------------------------------------------------
    @functools.cached_property
    def planes(self) -> list[tuple[int, ...]]:
        return [tuple(z) for z in itertools.product(range(self.q), repeat=self.t)]

    @functools.cached_property
    def plane_index(self) -> dict[tuple[int, ...], int]:
        return {z: i for i, z in enumerate(self.planes)}

    def _partner(self, x: int, y: int, z: tuple[int, ...]):
        """Partner vertex of (x,y,z) or None if diagonal (z_y == x)."""
        if z[y] == x:
            return None
        zp = list(z)
        zp[y] = x
        return z[y], y, tuple(zp)

    # -- the plane-schedule engine ------------------------------------------------
    def _is_score(self, z: tuple[int, ...], unknown: frozenset[int]) -> int:
        return sum(1 for y in range(self.t) if self._flat(z[y], y) in unknown)

    @functools.lru_cache(maxsize=64)
    def _decode_mats(self, unknown: tuple[int, ...]) -> tuple[np.ndarray, tuple[int, ...]]:
        """(R, known_used): per-plane solver U_unknown = R @ U_known_used."""
        e = len(unknown)
        known = tuple(i for i in range(self.N) if i not in set(unknown))
        h = self.base.parity_check[:e, :]
        he = h[:, list(unknown)]
        hk = h[:, list(known)]
        r = gf.matmul_np(gf.mat_inv(he), hk)
        return r, known

    @functools.lru_cache(maxsize=64)
    def _plan(self, unknown: tuple[int, ...]) -> _SolvePlan:
        """Groups and gather indices of ``_solve`` for one erasure pattern."""
        unknown_set = frozenset(unknown)
        r_mat, known_used = self._decode_mats(unknown)
        by_score: dict[int, list[int]] = {}
        for zi, z in enumerate(self.planes):
            by_score.setdefault(self._is_score(z, unknown_set), []).append(zi)

        def split(f: int, zis: list[int]):
            """Planes of `zis` where flat f is diagonal, and the paired ones
            with their partners' flats and planes."""
            x, y = self._xy(f)
            diag, pair = [], []
            for zi in zis:
                p = self._partner(x, y, self.planes[zi])
                if p is None:
                    diag.append(zi)
                else:
                    pair.append((zi, self._flat(p[0], p[1]), self.plane_index[p[2]]))
            return diag, pair

        groups = []
        for score in sorted(by_score):  # ascending intersection score
            zis = by_score[score]
            known = []
            for f in range(self.N):
                if f in unknown_set:
                    continue
                diag, pair = split(f, zis)
                known.append((
                    f, self._index(diag), self._index(p[0] for p in pair),
                    self._index(p[1] for p in pair), self._index(p[2] for p in pair),
                ))
            unk = []
            for f in unknown:
                diag, pair = split(f, zis)
                pu = [p for p in pair if p[1] in unknown_set]
                pk = [p for p in pair if p[1] not in unknown_set]
                unk.append((
                    f, self._index(diag),
                    self._index(p[0] for p in pu), self._index(p[1] for p in pu),
                    self._index(p[2] for p in pu),
                    self._index(p[0] for p in pk), self._index(p[1] for p in pk),
                    self._index(p[2] for p in pk),
                ))
            groups.append(_GroupPlan(self._index(zis), tuple(known), tuple(unk)))
        return _SolvePlan(
            r_mat=torch.from_numpy(np.ascontiguousarray(r_mat)).to(self.device),
            known=self._index(known_used),
            unknown=self._index(unknown),
            groups=tuple(groups),
        )

    def _solve(self, c: torch.Tensor, unknown_flats: frozenset[int]) -> torch.Tensor:
        """Fill in, in place, the coupled values of `unknown_flats`.

        c: (N, alpha, W) uint8 tensor on the code's device with the known
        nodes' coupled values populated (virtual nodes are zero).
        Precondition: len(unknown_flats) <= m.
        """
        assert len(unknown_flats) <= self.m, "more erasures than parities"
        if not unknown_flats:
            return c
        plan = self._plan(tuple(sorted(unknown_flats)))
        u = torch.zeros_like(c)  # uncoupled values
        e, kk = plan.r_mat.shape
        w = c.shape[2]
        for g in plan.groups:
            # 1) uncoupled values of all KNOWN nodes in these planes; a
            #    partner C is known: a known node, or an unknown node whose
            #    plane has IS score-1 (filled by an earlier group)
            for f, diag, pair, pf, pz in g.known:
                if diag.numel():
                    u[f, diag] = c[f, diag]
                if pair.numel():
                    u[f, pair] = gf.mul_const(
                        _THETA, c[f, pair] ^ gf.mul_const(GAMMA, c[pf, pz])
                    )
            # 2) solve the base code for every plane of the group: one GF matmul
            kn = u[plan.known[:, None], g.planes[None, :]].reshape(kk, -1)
            rec = ops.gf_matmul(plan.r_mat, kn)
            u[plan.unknown[:, None], g.planes[None, :]] = rec.view(e, -1, w)
            # 3) convert unknown nodes' U -> C
            for f, diag, pair_u, pf_u, pz_u, pair_k, pf_k, pz_k in g.unknown:
                if diag.numel():
                    c[f, diag] = u[f, diag]
                if pair_u.numel():  # partner unknown too: both U's are in hand
                    c[f, pair_u] = u[f, pair_u] ^ gf.mul_const(GAMMA, u[pf_u, pz_u])
                if pair_k.numel():  # C_self = (1+g^2)*U_self + g*C_partner
                    c[f, pair_k] = (gf.mul_const(_ONE_PLUS_G2, u[f, pair_k])
                                    ^ gf.mul_const(GAMMA, c[pf_k, pz_k]))
        return c

    # -- public API -------------------------------------------------------------
    def stack_limit(self, w: int) -> int:
        """Chunksets of sub-chunk width w that one solve may stack."""
        return max(1, STACK_BYTES // (self.N * self.alpha * w))

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.uint8).to(self.device)

    def encode(self, data) -> torch.Tensor:
        """data: (k, alpha, w) -> full codeword (n, alpha, w) on the code's device."""
        return self.encode_batch(self._tensor(data)[None])[0]

    def encode_batch(self, data) -> torch.Tensor:
        """data: (B, k, alpha, w) chunksets -> (B, n, alpha, w) codewords.

        The chunksets are stacked along the byte axis, so each plane group
        is one wide ``gf_matmul``; at most ``stack_limit(w)`` chunksets go
        through one solve (``STACK_BYTES``).  Byte-identical to ``encode``
        per chunkset.
        """
        data = self._tensor(data)
        b_all, k, alpha, w = data.shape
        assert (k, alpha) == (self.k, self.alpha), data.shape
        out = torch.empty((b_all, self.n, alpha, w), dtype=torch.uint8, device=self.device)
        unknown = frozenset(self.real_to_flat[self.k :])
        rows = self._index(self.real_to_flat)
        step = self.stack_limit(w)
        for s in range(0, b_all, step):
            part = data[s : s + step]
            b = part.shape[0]
            c = torch.zeros((self.N, alpha, b, w), dtype=torch.uint8, device=self.device)
            c[: self.k] = part.permute(1, 2, 0, 3)
            self._solve(c.view(self.N, alpha, b * w), unknown)
            out[s : s + b] = c[rows].permute(2, 0, 1, 3)
        return out

    def decode(self, shards: dict[int, object]) -> torch.Tensor:
        """Reconstruct all n chunks from any >= k of them (MDS property)."""
        return self.decode_batch([shards])[0]

    def reconstruct_data(self, shards: dict[int, object]) -> torch.Tensor:
        return self._decode([shards], range(self.k))[0]

    # -- batched decode (§3.5 erasure-coding acceleration) -------------------------
    def decode_batch(self, shard_sets: list[dict[int, object]]) -> list[torch.Tensor]:
        """Decode many chunksets' shard sets through few wide GF calls.

        Chunksets sharing an *erasure pattern* are stacked along the byte
        (w) axis and pushed through the plane-schedule engine once, so each
        IS-group linear solve is a single (e, K') x (K', G*B*w) ``gf_matmul``.
        Byte-identical to calling `decode` per chunkset.
        """
        return self._decode(shard_sets, range(self.n))

    def reconstruct_data_batch(self, shard_sets: list[dict[int, object]]) -> list[torch.Tensor]:
        return self._decode(shard_sets, range(self.k))

    def _decode(self, shard_sets: list[dict[int, object]], reals) -> list[torch.Tensor]:
        """Decoded rows `reals` (real chunk indices) of every shard set.

        All fetched shards (numpy on the host, as SPs hand them over) are
        stacked once and copied to the device in one transfer.
        """
        if not shard_sets:
            return []
        groups: dict[tuple[int, ...], list[int]] = {}
        for i, shards in enumerate(shard_sets):
            if len(shards) < self.k:
                raise ValueError(f"need >= k={self.k} shards, got {len(shards)}")
            erased = tuple(
                self.real_to_flat[r] for r in range(self.n) if r not in shards
            )
            groups.setdefault(erased, []).append(i)
        order = [(i, real) for i, shards in enumerate(shard_sets) for real in shards]
        arrays = [shard_sets[i][real] for i, real in order]
        if all(isinstance(a, np.ndarray) for a in arrays):
            fetched = torch.from_numpy(np.stack(arrays).astype(np.uint8, copy=False))
        else:
            fetched = torch.stack([self._tensor(a) for a in arrays])
        fetched = fetched.to(self.device)
        _, alpha, w = fetched.shape
        assert alpha == self.alpha, fetched.shape
        pos = {key: s for s, key in enumerate(order)}
        rows = self._index(self.real_to_flat[r] for r in reals)
        out: list[torch.Tensor | None] = [None] * len(shard_sets)
        for erased, idxs in groups.items():
            step = self.stack_limit(w)
            for s0 in range(0, len(idxs), step):
                part = idxs[s0 : s0 + step]
                c = torch.zeros((self.N, alpha, len(part), w), dtype=torch.uint8,
                                device=self.device)
                flat, col, src = [], [], []
                for b, i in enumerate(part):
                    for real in shard_sets[i]:
                        flat.append(self.real_to_flat[real])
                        col.append(b)
                        src.append(pos[(i, real)])
                c[self._index(flat), :, self._index(col), :] = fetched[self._index(src)]
                self._solve(c.view(self.N, alpha, len(part) * w), frozenset(erased))
                for b, i in enumerate(part):
                    out[i] = c[:, :, b, :].index_select(0, rows)
        return out

    # -- bandwidth-optimal single-node repair (§3.3 MSR) -------------------------------
    def repair_planes(self, failed_real: int) -> list[tuple[int, ...]]:
        x0, y0 = self._xy(self.real_to_flat[failed_real])
        return [z for z in self.planes if z[y0] == x0]

    def repair_subchunk_ids(self, failed_real: int) -> list[int]:
        """Sub-chunk indices every helper must transmit (alpha/q of them)."""
        return [self.plane_index[z] for z in self.repair_planes(failed_real)]

    def repair_bandwidth_bytes(self, chunk_bytes: int) -> int:
        """Helper bytes read to repair ONE chunk (MSR optimum, d = n-1)."""
        return (self.n - 1) * (chunk_bytes // self.q)

    @functools.lru_cache(maxsize=64)
    def _repair_plan(self, failed_real: int) -> _RepairPlan:
        """Gather indices and the base-code solver of ``repair`` for one node."""
        x0, y0 = self._xy(self.real_to_flat[failed_real])
        rplanes = self.repair_planes(failed_real)
        rp_index = {z: i for i, z in enumerate(rplanes)}
        # the base-code solve for the column nodes, row x = node (x, y0)
        r_mat, known = self._decode_mats(tuple(self._flat(x, y0) for x in range(self.q)))
        u_flat, u_plane, u_diag = [], [], []
        for f in known:  # a known node's partner stays on the repair planes
            x, y = self._xy(f)
            for ri, z in enumerate(rplanes):
                p = self._partner(x, y, z)
                u_diag.append(p is None)
                u_flat.append(f if p is None else self._flat(p[0], p[1]))
                u_plane.append(ri if p is None else rp_index[p[2]])
        a_col, a_plane, a_flat, a_rep = [], [], [], []
        for z in self.planes:
            pz = z[:y0] + (x0,) + z[y0 + 1 :]  # z itself on a repair plane
            a_col.append(z[y0])
            a_plane.append(rp_index[pz])
            a_flat.append(self._flat(z[y0], y0))
            a_rep.append(z[y0] == x0)
        helpers = [self.real_to_flat[r] for r in range(self.n) if r != failed_real]
        grid = (len(known), len(rplanes))
        return _RepairPlan(
            r_mat=torch.from_numpy(np.ascontiguousarray(r_mat)).to(self.device),
            helpers=self._index(helpers),
            known=self._index(known),
            u_flat=self._index(u_flat).view(grid),
            u_plane=self._index(u_plane).view(grid),
            u_diag=torch.tensor(u_diag, device=self.device).view(*grid, 1),
            a_col=self._index(a_col),
            a_plane=self._index(a_plane),
            a_flat=self._index(a_flat),
            a_rep=torch.tensor(a_rep, device=self.device).view(-1, 1),
        )

    def repair(self, failed_real: int, helper_subchunks: dict[int, object]) -> torch.Tensor:
        """Repair chunk `failed_real` from helpers' repair-plane sub-chunks.

        helper_subchunks: {real_idx: (alpha/q, w)} numpy arrays (as SPs hand
        them over) or tensors — ONLY the sub-chunks whose plane z satisfies
        z_{y0} == x0, in `repair_subchunk_ids` order.  Requires all d = n-1
        helpers (optimal-bandwidth regime); for fewer helpers fall back to
        `decode` (MDS path), as §3.3 prescribes.  Returns the (alpha, w)
        chunk on the code's device, after one host-to-device copy of the
        helpers and ONE ``gf_matmul`` (q x (N-q)) x (N-q, alpha/q * w).
        """
        if set(helper_subchunks) != set(range(self.n)) - {failed_real}:
            raise ValueError("optimal repair needs all n-1 helpers")
        plan = self._repair_plan(failed_real)
        arrays = [helper_subchunks[r] for r in sorted(helper_subchunks)]
        if all(isinstance(a, np.ndarray) for a in arrays):
            fetched = torch.from_numpy(np.stack(arrays).astype(np.uint8, copy=False))
        else:
            fetched = torch.stack([self._tensor(a) for a in arrays])
        fetched = fetched.to(self.device)
        _, r, w = fetched.shape
        if r != self.alpha // self.q:
            raise ValueError(f"each helper sends alpha/q = {self.alpha // self.q} "
                             f"sub-chunks, got {tuple(fetched.shape[1:])}")
        # coupled values on the repair planes by flat (virtual nodes and the
        # failed node: zeros)
        c = torch.zeros((self.N, r, w), dtype=torch.uint8, device=self.device)
        c[plan.helpers] = fetched
        # 1) uncouple the non-column nodes (symmetric in the pair order)
        c_known = c[plan.known]
        paired = gf.mul_const(_THETA, c_known ^ gf.mul_const(GAMMA, c[plan.u_flat, plan.u_plane]))
        u = torch.where(plan.u_diag, c_known, paired)
        # 2) the q column nodes' U on every repair plane: one GF matmul
        sol = ops.gf_matmul(plan.r_mat, u.view(len(plan.known), r * w)).view(self.q, r, w)
        # 3) assemble: C = U on a repair plane, else from the coupled partner
        u_p = sol[plan.a_col, plan.a_plane]
        c_p = c[plan.a_flat, plan.a_plane]
        coupled = gf.mul_const(_INV_GAMMA, c_p ^ u_p) ^ gf.mul_const(GAMMA, u_p)
        return torch.where(plan.a_rep, u_p, coupled)
