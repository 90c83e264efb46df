"""2-D Reed-Solomon extension for data-availability sampling (DAS).

A k x k *data square* of fixed-size shares is extended along both axes
with the systematic ``[2k, k]`` code of ``core/rs.py`` (extension factor 2
per axis), producing a 2k x 2k *extended square* in which

* every **row** is a codeword of the row code,
* every **column** is a codeword of the column code, and
* any k complete rows (or any k complete columns) determine the whole
  square, so hiding ANY share is detectable by uniform sampling.

Commitments bind the square for light clients: one Merkle tree per row
over its 2k share byte-strings, one per column, and a *DAS root* over the
2*side concatenated row+column roots.  A :class:`ShareProof` carries the
share's path inside its row (or column) tree plus that root's path inside
the DAS tree, so a sampler holding only ``das_root`` verifies a single
share in O(log side) hashes.  The Merkle work stays on the host
(hashlib, as in ``core/commitments.py``).

The byte work runs on the device through ``matmul=`` (by default
:func:`repro_torch.kernels.ops.gf_matmul`: the CUDA kernel for tensors on
the card, its plain version for tensors on the CPU).
:meth:`Extend2D.extend_batch` stacks MANY squares along the byte axis, so
thousands of per-square encodes become ONE small-and-wide
(k x k) (x) (k x B*k*S) product per axis: two launches in all.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import commitments as cm
from repro_torch.core.rs import MDSCode, _coeffs
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def detection_probability(q: float, s: int) -> float:
    """P[>= 1 of s uniform with-replacement samples hits a withheld share]
    when a fraction ``q`` of the extended square is withheld."""
    return 1.0 - (1.0 - q) ** s


@dataclasses.dataclass(frozen=True)
class ShareProof:
    """Proof that share (row, col) belongs to a square with a given DAS root.

    ``axis`` names the tree the leaf path runs through ("row" or "col");
    ``leaf_path`` authenticates the share inside that axis tree (whose
    root is ``axis_root``), and ``root_path`` authenticates ``axis_root``
    inside the DAS tree (row roots first, then column roots).  The
    coordinates are *bound*: verification checks the leaf index equals
    the in-axis coordinate and the root index equals the axis position,
    so a valid proof for share (r, c) cannot be replayed at (r', c').
    """

    row: int
    col: int
    axis: str  # "row" | "col"
    axis_root: bytes
    leaf_path: cm.MerkleProof  # share -> axis_root
    root_path: cm.MerkleProof  # axis_root -> das_root

    @property
    def nbytes(self) -> int:
        """Modeled wire size: coordinates + both paths + the axis root."""
        return 8 + self.leaf_path.nbytes + len(self.axis_root) + self.root_path.nbytes


@dataclasses.dataclass(frozen=True)
class SquareCommitment:
    side: int
    share_bytes: int
    row_roots: tuple[bytes, ...]
    col_roots: tuple[bytes, ...]
    das_root: bytes


class CommittedSquare:
    """An extended square (a host array) plus the Merkle machinery to prove
    its shares."""

    def __init__(self, ext: np.ndarray):
        side = ext.shape[0]
        assert ext.shape[1] == side and ext.ndim == 3
        self.ext = ext
        self.row_trees = [
            cm.MerkleTree([ext[r, c].tobytes() for c in range(side)])
            for r in range(side)
        ]
        self.col_trees = [
            cm.MerkleTree([ext[r, c].tobytes() for r in range(side)])
            for c in range(side)
        ]
        row_roots = tuple(t.root for t in self.row_trees)
        col_roots = tuple(t.root for t in self.col_trees)
        self.das_tree = cm.MerkleTree(list(row_roots) + list(col_roots))
        self.commitment = SquareCommitment(
            side=side,
            share_bytes=int(ext.shape[2]),
            row_roots=row_roots,
            col_roots=col_roots,
            das_root=self.das_tree.root,
        )

    def share(self, row: int, col: int) -> np.ndarray:
        return self.ext[row, col]

    def prove(self, row: int, col: int, axis: str = "row") -> ShareProof:
        side = self.commitment.side
        if axis == "row":
            leaf_path = self.row_trees[row].prove(col)
            axis_root = self.commitment.row_roots[row]
            root_path = self.das_tree.prove(row)
        elif axis == "col":
            leaf_path = self.col_trees[col].prove(row)
            axis_root = self.commitment.col_roots[col]
            root_path = self.das_tree.prove(side + col)
        else:
            raise ValueError(f"axis must be row|col, got {axis!r}")
        return ShareProof(row=row, col=col, axis=axis, axis_root=axis_root,
                          leaf_path=leaf_path, root_path=root_path)


def verify_share(das_root: bytes, side: int, share: bytes,
                 proof: ShareProof) -> bool:
    """Light-client share verification against the DAS root alone.

    Checks the coordinate binding (leaf/root indices match the claimed
    (row, col) and axis), the share's membership in its axis tree, and
    the axis root's membership in the DAS tree.
    """
    if proof.axis == "row":
        if proof.leaf_path.index != proof.col or proof.root_path.index != proof.row:
            return False
    elif proof.axis == "col":
        if (proof.leaf_path.index != proof.row
                or proof.root_path.index != side + proof.col):
            return False
    else:
        return False
    if not cm.verify(proof.axis_root, share, proof.leaf_path):
        return False
    return cm.verify(das_root, proof.axis_root, proof.root_path)


def _stack(items, device: torch.device) -> torch.Tensor:
    """Stack numpy arrays or uint8 tensors and move them to ``device`` with
    one copy (numpy is stacked on the host first)."""
    if all(isinstance(x, np.ndarray) for x in items):
        host = np.stack([np.asarray(x, np.uint8) for x in items])
        return torch.from_numpy(host).to(device)
    return torch.stack([torch.as_tensor(x, dtype=torch.uint8).to(device) for x in items])


@dataclasses.dataclass(frozen=True)
class Extend2D:
    """The 2-D extension layout: k x k data -> 2k x 2k shares."""

    k: int

    @property
    def side(self) -> int:
        return 2 * self.k

    @functools.cached_property
    def code(self) -> MDSCode:
        return MDSCode(n=self.side, k=self.k)

    # -- encode ---------------------------------------------------------------
    def pad_square(self, data: bytes, share_bytes: int) -> np.ndarray:
        """Zero-pad ``data`` into the (k, k, share_bytes) data square.

        Only the first k*k*share_bytes bytes of ``data`` enter the square
        (as in the JAX package); the rest of a longer blob is not covered."""
        need = self.k * self.k * share_bytes
        flat = np.frombuffer(data[:need], dtype=np.uint8)
        if flat.size < need:
            flat = np.concatenate([flat, np.zeros(need - flat.size, np.uint8)])
        return flat.reshape(self.k, self.k, share_bytes)

    def extend(self, square, matmul=ops.gf_matmul, device=None) -> torch.Tensor:
        """(k, k, S) data square -> (2k, 2k, S) extended square on ``device``."""
        return self.extend_batch([square], matmul=matmul, device=device)[0]

    def extend_batch(self, squares, matmul=ops.gf_matmul, device=None):
        """Extend MANY squares with TWO ``matmul`` calls in all.

        ``squares``: (k, k, S) numpy arrays or uint8 tensors; ``device=None``
        means the card.  Squares of one width are stacked as (B, k, k, S)
        and copied to the device once; the column stage is one product
        P (x) X with X = the data rows laid out as (k, B*k*S), the row stage
        one product over the (B, 2k, k, S) column extension laid out as
        (k, B*2k*S): the byte order of the JAX package's per-square
        concatenation.  Returns a (B, 2k, 2k, S) tensor on the device.

        Squares of different widths are grouped by width, and the groups'
        columns share the same two products (each output column depends
        only on its own input column, so no byte changes); the result is
        then a list of (2k, 2k, S_i) tensors in input order.
        """
        if not len(squares):
            return []
        dev = resolve_device(device)
        k = self.k
        groups: dict[int, list[int]] = {}
        for i, sq in enumerate(squares):
            if tuple(sq.shape[:2]) != (k, k) or len(sq.shape) != 3:
                raise ValueError(f"a square must be ({k}, {k}, S), got {tuple(sq.shape)}")
            groups.setdefault(int(sq.shape[2]), []).append(i)
        stacks = [_stack([squares[i] for i in idx], dev) for idx in groups.values()]
        coeffs = _coeffs(self.code.encode_matrix, stacks[0])
        # columns first: parity rows k..2k-1 of every column, from the k data rows
        flat = torch.cat([st.permute(1, 0, 2, 3).reshape(k, -1) for st in stacks], dim=1)
        parity = matmul(coeffs, flat.contiguous())
        col_ext, off = [], 0
        for st in stacks:
            b, _, _, s = st.shape
            bot = parity[:, off:off + b * k * s].reshape(k, b, k, s).permute(1, 0, 2, 3)
            col_ext.append(torch.cat([st, bot], dim=1))  # (B, 2k rows, k cols, S)
            off += b * k * s
        # then rows: each of the 2k rows extends from k to 2k shares, with the
        # column index as the symbol axis of one wide product
        flat = torch.cat([e.permute(2, 0, 1, 3).reshape(k, -1) for e in col_ext], dim=1)
        parity = matmul(coeffs, flat.contiguous())
        outs, off = [], 0
        for e in col_ext:
            b, side, _, s = e.shape
            right = parity[:, off:off + b * side * s].reshape(k, b, side, s).permute(1, 2, 0, 3)
            outs.append(torch.cat([e, right], dim=2))  # (B, 2k rows, 2k cols, S)
            off += b * side * s
        if len(outs) == 1:
            return outs[0]
        result: list[torch.Tensor | None] = [None] * len(squares)
        for idx, out in zip(groups.values(), outs):
            for j, i in enumerate(idx):
                result[i] = out[j]
        return result

    # -- reconstruct ----------------------------------------------------------
    def reconstruct_from_rows(self, rows: dict, matmul=ops.gf_matmul,
                              device=None) -> torch.Tensor:
        """Any k complete rows (each (2k, S)) -> the full (2k, 2k, S) square.

        Every column is a codeword of the column code with the same known
        symbol pattern, so ONE decode matrix applied to the stacked known
        rows recovers every missing row in one wide product.
        """
        return self._reconstruct_axis(rows, axis=0, matmul=matmul, device=device)

    def reconstruct_from_cols(self, cols: dict, matmul=ops.gf_matmul,
                              device=None) -> torch.Tensor:
        """Any k complete columns (each (2k, S)) -> the full square."""
        return self._reconstruct_axis(cols, axis=1, matmul=matmul, device=device)

    def _reconstruct_axis(self, lines: dict, axis: int, matmul=ops.gf_matmul,
                          device=None) -> torch.Tensor:
        dev = resolve_device(device)
        side = self.side
        known = tuple(sorted(lines))[: self.k]
        if len(known) < self.k:
            raise ValueError(f"need >= k={self.k} lines, got {len(lines)}")
        share_bytes = lines[known[0]].shape[-1]
        r, erased = self.code.decode_matrix(known)
        stacked = _stack([lines[i] for i in known], dev).reshape(self.k, -1)  # (k, 2k*S)
        out = torch.zeros((side, side * share_bytes), dtype=torch.uint8, device=dev)
        out[list(known)] = stacked
        if erased:
            out[list(erased)] = matmul(_coeffs(r, stacked), stacked.contiguous())
        out = out.reshape(side, side, share_bytes)
        if axis == 1:
            out = out.transpose(0, 1)
        return out.contiguous()


def commit_square(ext) -> CommittedSquare:
    """Row/column/DAS commitments over an extended square (host array;
    a tensor is copied to the host first)."""
    if isinstance(ext, torch.Tensor):
        ext = ext.cpu().numpy()
    return CommittedSquare(ext)
