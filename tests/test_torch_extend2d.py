"""The port's 2-D extension (``repro_torch/core/extend2d.py``), held against
the JAX package's ``repro/core/extend2d.py`` byte for byte.

One numpy seed feeds both packages.  The reference multiplies with numpy
``gf.matmul_np`` (its own ``tests/test_das.py`` holds numpy equal to the
Pallas kernel); the port runs on the CPU, where ``ops.gf_matmul`` is the
plain version of the CUDA kernel.  Extended squares, reconstructions,
commitments, proof sizes and verification verdicts must be equal.
"""
import numpy as np
import pytest
import torch

from repro.core import extend2d as jx
from repro_torch.core import extend2d as tx
from repro_torch.kernels import ops

WIDTHS = [(k, s) for k in (2, 4, 8) for s in (64, 512)]


def _squares(k, s, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (k, k, s), dtype=np.uint8) for _ in range(n)]


class _Counted:
    """``ops.gf_matmul`` with a call count, passed through ``matmul=``."""

    def __init__(self):
        self.calls = 0

    def __call__(self, a, b):
        self.calls += 1
        return ops.gf_matmul(a, b)


@pytest.mark.parametrize("k,s", WIDTHS)
def test_extend_matches_reference(k, s):
    (sq,) = _squares(k, s, 1, seed=k * s)
    ref = jx.Extend2D(k).extend(sq)
    got = tx.Extend2D(k).extend(sq, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2 * k, 2 * k, s)
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got[:k, :k].numpy(), sq)  # systematic: data in the corner


@pytest.mark.parametrize("batch", [1, 5, 64])
@pytest.mark.parametrize("k,s", WIDTHS)
def test_extend_batch_matches_reference_in_two_matmuls(k, s, batch):
    squares = _squares(k, s, batch, seed=batch + 7 * k + s)
    ref = jx.Extend2D(k).extend_batch(squares)
    counted = _Counted()
    got = tx.Extend2D(k).extend_batch(squares, matmul=counted, device="cpu")
    assert counted.calls == 2
    assert tuple(got.shape) == (batch, 2 * k, 2 * k, s)
    assert np.array_equal(got.numpy(), np.stack(ref))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_mixed_width_batch_matches_reference_in_two_matmuls(k):
    rng = np.random.default_rng(k)
    squares = [rng.integers(0, 256, (k, k, s), dtype=np.uint8) for s in (64, 512, 64, 8, 512, 64)]
    ref = jx.Extend2D(k).extend_batch(squares)
    counted = _Counted()
    got = tx.Extend2D(k).extend_batch(squares, matmul=counted, device="cpu")
    assert counted.calls == 2 and len(got) == len(squares)
    for r, g in zip(ref, got):
        assert np.array_equal(g.numpy(), r)


def test_extend_batch_takes_tensors_and_refuses_bad_squares():
    squares = _squares(4, 64, 3, seed=3)
    ref = jx.Extend2D(4).extend_batch(squares)
    got = tx.Extend2D(4).extend_batch([torch.from_numpy(x) for x in squares], device="cpu")
    assert np.array_equal(got.numpy(), np.stack(ref))
    assert tx.Extend2D(4).extend_batch([], device="cpu") == []
    with pytest.raises(ValueError):
        tx.Extend2D(4).extend_batch([np.zeros((4, 3, 8), np.uint8)], device="cpu")


@pytest.mark.parametrize("k,s", WIDTHS)
def test_reconstruct_from_rows_and_cols_matches_reference(k, s):
    (sq,) = _squares(k, s, 1, seed=11 * k + s)
    jlay, tlay = jx.Extend2D(k), tx.Extend2D(k)
    ext = jlay.extend(sq)
    rng = np.random.default_rng(k + s)
    for _ in range(3):
        rows = sorted(int(r) for r in rng.choice(2 * k, size=k, replace=False))
        lines = {r: np.ascontiguousarray(ext[r]) for r in rows}
        counted = _Counted()
        got = tlay.reconstruct_from_rows(lines, matmul=counted, device="cpu")
        assert counted.calls == 1  # every missing row in one product
        assert np.array_equal(got.numpy(), jlay.reconstruct_from_rows(lines))
        assert np.array_equal(got.numpy(), ext)
        cols = sorted(int(c) for c in rng.choice(2 * k, size=k, replace=False))
        lines = {c: np.ascontiguousarray(ext[:, c]) for c in cols}
        got = tlay.reconstruct_from_cols(lines, device="cpu")
        assert np.array_equal(got.numpy(), jlay.reconstruct_from_cols(lines))
        assert np.array_equal(got.numpy(), ext)
    # the k data rows alone: nothing erased among them, the parity rebuilt
    lines = {r: torch.from_numpy(np.ascontiguousarray(ext[r])) for r in range(k)}
    assert np.array_equal(tlay.reconstruct_from_rows(lines, device="cpu").numpy(), ext)
    with pytest.raises(ValueError):
        tlay.reconstruct_from_rows({0: ext[0]}, device="cpu")


@pytest.mark.parametrize("k,s", WIDTHS)
def test_commitments_and_proofs_match_reference(k, s):
    (sq,) = _squares(k, s, 1, seed=5 * k + s)
    ext = jx.Extend2D(k).extend(sq)
    jsq = jx.commit_square(ext)
    tsq = tx.commit_square(tx.Extend2D(k).extend(sq, device="cpu"))
    assert tsq.commitment.__dict__ == jsq.commitment.__dict__
    side = 2 * k
    for r in range(side):
        for c in range(side):
            for axis in ("row", "col"):
                jp, tp = jsq.prove(r, c, axis), tsq.prove(r, c, axis)
                assert (tp.row, tp.col, tp.axis, tp.axis_root) == (jp.row, jp.col, jp.axis,
                                                                   jp.axis_root)
                assert (tp.leaf_path.index, tp.leaf_path.path) == (jp.leaf_path.index,
                                                                   jp.leaf_path.path)
                assert (tp.root_path.index, tp.root_path.path) == (jp.root_path.index,
                                                                   jp.root_path.path)
                assert tp.nbytes == jp.nbytes
    with pytest.raises(ValueError):
        tsq.prove(0, 0, axis="diag")


@pytest.mark.parametrize("k", [2, 4, 8])
def test_verify_share_matches_reference(k):
    (sq,) = _squares(k, 64, 1, seed=k)
    ext = jx.Extend2D(k).extend(sq)
    jsq, tsq = jx.commit_square(ext), tx.commit_square(ext)
    root, side = tsq.commitment.das_root, 2 * k
    r, c = 1, side - 1
    share = tsq.share(r, c).tobytes()
    bad = bytearray(share)
    bad[0] ^= 0xFF
    cases = []
    for axis in ("row", "col"):
        tp, jp = tsq.prove(r, c, axis), jsq.prove(r, c, axis)
        forged = [tx.ShareProof(row=r + 1, col=c, axis=axis, axis_root=tp.axis_root,
                                leaf_path=tp.leaf_path, root_path=tp.root_path),
                  jx.ShareProof(row=r + 1, col=c, axis=axis, axis_root=jp.axis_root,
                                leaf_path=jp.leaf_path, root_path=jp.root_path)]
        wrong_axis = [tx.ShareProof(row=r, col=c, axis="diag", axis_root=tp.axis_root,
                                    leaf_path=tp.leaf_path, root_path=tp.root_path),
                      jx.ShareProof(row=r, col=c, axis="diag", axis_root=jp.axis_root,
                                    leaf_path=jp.leaf_path, root_path=jp.root_path)]
        cases += [
            ("valid", root, share, (tp, jp)),
            ("tampered", root, bytes(bad), (tp, jp)),
            ("replayed", root, share, forged),
            ("wrong_root", b"\x00" * 32, share, (tp, jp)),
            ("wrong_axis", root, share, wrong_axis),
        ]
    for name, das_root, data, (tp, jp) in cases:
        got = tx.verify_share(das_root, side, data, tp)
        assert got == jx.verify_share(das_root, side, data, jp), name
        assert got == (name == "valid"), name


def test_detection_probability_matches_reference():
    for q in (0.0, 3 / 64, 0.15, 0.5, 1.0):
        for s in (1, 8, 16):
            assert tx.detection_probability(q, s) == jx.detection_probability(q, s)


def test_pad_square_matches_reference():
    data = np.random.default_rng(0).integers(0, 256, 5000, dtype=np.uint8).tobytes()
    for k, s in ((4, 512), (4, 64), (2, 512)):
        assert np.array_equal(tx.Extend2D(k).pad_square(data, s),
                              jx.Extend2D(k).pad_square(data, s))
