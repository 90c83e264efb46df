"""The port's attention gradient held against the JAX package's, on the CPU.

The JAX package differentiates its chunked attention
(``repro.models.layers.flash_attention``) with ``jax.vjp``; the port's
gradient is ``kernels/flash_attention_bwd.py``: the CUDA kernel on the card
(``tests/test_torch_cuda.py``) and, here, its plain version
``flash_attention_bwd_ref`` (P recomputed from the forward's row
log-sum-exp), reached directly and through autograd on
``kernels/ops.py::flash_attention``.  Inputs are seeded numpy arrays handed
to both.

The JAX function runs at ``kv_chunk = Sk`` (one key chunk): with padded key
chunks its non-causal rows would also see the zero-padded keys (ROADMAP
Queue 3 item 3), which the port does not mirror.

Tolerances, f32 in both packages: the same algorithm up to summation order
and P taken as exp(s - lse) instead of the online softmax's running
rescaling: atol = rtol = 1e-4 on gradients up to 6.5 (observed <= 1.9e-6).  The row log-sum-exp
against a direct numpy computation in f32 with the JAX package's mask
value: 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops

TOL = dict(atol=1e-4, rtol=1e-4)
LSE_ATOL = 1e-5

# (name, b, sq, sk, h, hkv, hd, causal, window, q_positions, k_positions)
CASES = [
    ("causal_gqa", 2, 37, 37, 8, 2, 16, True, 0, None, None),
    ("window", 1, 50, 50, 4, 2, 16, True, 7, None, None),
    ("mha_noncausal_sq_ne_sk", 2, 19, 45, 4, 4, 16, False, 0, None, None),
    ("g1_causal", 1, 33, 33, 3, 3, 32, True, 0, None, None),
    # a query block at the end of a longer cache: queries at positions 30..45
    ("explicit_positions", 2, 16, 46, 6, 2, 16, True, 0, np.arange(30, 46), np.arange(46)),
    # queries -5..10: the first five see no key (uniform weights, no score gradient)
    ("rows_see_no_key", 1, 16, 24, 4, 2, 16, True, 0, np.arange(-5, 11), np.arange(24)),
    ("window_positions_ragged", 2, 21, 70, 12, 4, 16, True, 9, np.arange(49, 70), np.arange(70)),
]


def _inputs(case, seed=0):
    _, b, sq, sk, h, hkv, hd, *_ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, hd)).astype(np.float32)
    do = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    return q, k, v, do


@functools.cache
def _reference(name: str):
    """The case's inputs and the JAX package's output and (dq, dk, dv), once per case."""
    case = next(c for c in CASES if c[0] == name)
    _, b, sq, sk, h, hkv, hd, causal, window, qpos, kpos = case
    mask = JL.MaskSpec(causal=causal, window=window)
    qp = None if qpos is None else jnp.asarray(qpos, jnp.int32)
    kp = None if kpos is None else jnp.asarray(kpos, jnp.int32)

    def f(q_, k_, v_):
        return JL.flash_attention(q_, k_, v_, mask=mask, q_positions=qp, k_positions=kp,
                                  kv_chunk=sk)

    @jax.jit
    def vjp(q_, k_, v_, do_):
        o, back = jax.vjp(f, q_, k_, v_)
        return o, back(do_)

    q, k, v, do = _inputs(case)
    o, grads = vjp(q, k, v, do)
    return (q, k, v, do), np.asarray(o), [np.asarray(g) for g in grads]


def _kw(case):
    *_, causal, window, qpos, kpos = case
    return dict(causal=causal, window=window,
                q_positions=None if qpos is None else torch.from_numpy(qpos),
                k_positions=None if kpos is None else torch.from_numpy(kpos))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_backward_matches_jax_vjp(case):
    (q, k, v, do), o_want, grads_want = _reference(case[0])
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_lse_ref(tq, tk, tv, **_kw(case))
    np.testing.assert_allclose(o.numpy(), o_want, **TOL)
    got = fab.flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse, **_kw(case))
    for name, g, want in zip("qkv", got, grads_want):
        assert g.shape == want.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), want, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_autograd_through_ops_matches_jax_vjp(case):
    """``ops.flash_attention`` under autograd: the FlashAttention function,
    whose CPU backward is the plain version; no kernel is launched."""
    (q, k, v, do), _, grads_want = _reference(case[0])
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    launches = fab.flash_attention_bwd.launches
    out = ops.flash_attention(*leaves, **_kw(case))
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    assert fab.flash_attention_bwd.launches == launches
    for name, leaf, want in zip("qkv", leaves, grads_want):
        np.testing.assert_allclose(leaf.grad.numpy(), want, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_row_logsumexp_matches_direct_computation(case):
    """lse (B, H, Sq): the natural log of the sum of exp of the scaled,
    masked scores; -1e30 (the mask value, rounded) for a row that sees no key."""
    _, b, sq, sk, h, hkv, hd, causal, window, qpos, kpos = case
    q, k, v, _ = _inputs(case, seed=2)
    qp = np.arange(sq) if qpos is None else qpos
    kp = np.arange(sk) if kpos is None else kpos
    s = np.einsum("bqhgd,bkhd->bhgqk", q.reshape(b, sq, hkv, h // hkv, hd), k) / np.sqrt(hd)
    diff = qp[:, None] - kp[None, :]
    vis = (diff >= 0 if causal else np.ones_like(diff, bool)) & (diff < window if window else True)
    s = np.where(vis, s, np.float32(JL.NEG_INF))
    m = s.max(-1, keepdims=True)
    want = (m[..., 0] + np.log(np.exp(s - m).sum(-1))).reshape(b, h, sq)
    o, lse = fa.flash_attention_lse_ref(*(torch.from_numpy(a) for a in (q, k, v)), **_kw(case))
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=LSE_ATOL, rtol=LSE_ATOL)
    assert torch.equal(o, fa.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                                 **_kw(case)))


def test_bf16_plain_backward_keeps_dtypes_and_tracks_f32():
    """bf16 in, bf16 gradients out, computed in f32: within a few bf16
    rounding steps (2^-8 relative) of the f32 gradients of the same inputs."""
    case = CASES[0]
    q, k, v, do = _inputs(case, seed=3)
    f32 = [torch.from_numpy(a) for a in (q, k, v, do)]
    b16 = [t.bfloat16() for t in f32]
    o, lse = fa.flash_attention_lse_ref(*b16[:3], **_kw(case))
    got = fab.flash_attention_bwd_ref(*b16[:3], o, b16[3], lse, **_kw(case))
    ref_in = [t.float() for t in b16]
    o32, lse32 = fa.flash_attention_lse_ref(*ref_in[:3], **_kw(case))
    want = fab.flash_attention_bwd_ref(*ref_in[:3], o32, ref_in[3], lse32, **_kw(case))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert float((g.float() - w).norm() / w.norm()) < 2**-6


def test_kernel_wrapper_takes_only_what_the_kernel_takes():
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, 4, 1, 16))
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        fab.flash_attention_bwd(q, k, k, q, q, lse)
    with pytest.raises(ValueError, match="lse must be"):
        fab.flash_attention_bwd_ref(q, k, k, q, q, torch.zeros((1, 4, 2)))
    assert fab.kernel_takes(torch.bfloat16, 16) and fab.kernel_takes(torch.bfloat16, 256)
    for dtype, hd in ((torch.float32, 128), (torch.bfloat16, 8), (torch.bfloat16, 72),
                      (torch.bfloat16, 272)):
        assert not fab.kernel_takes(dtype, hd)


def test_no_grad_calls_keep_the_forward_path():
    """Serving (no gradient) does not record the autograd function."""
    q, k, v, _ = _inputs(CASES[0])
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    with torch.no_grad():
        out = ops.flash_attention(tq, tk, tv)
    assert out.grad_fn is None
    assert torch.equal(out, fa.flash_attention_ref(tq.detach(), tk.detach(), tv.detach()))
