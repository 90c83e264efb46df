"""Attention with V narrower than q and k (hd_v < hd, as MLA's 192 / 128), on the CPU.

The JAX package's ``repro.models.layers.flash_attention`` takes V at its own
head dim; so do the port's kernels, their plain versions
(``kernels/flash_attention.py::flash_attention_lse_ref``,
``kernels/flash_attention_bwd.py::flash_attention_bwd_ref``) and the layer
(``models/layers.py::flash_attention``), which pads no V.  Seeded numpy
inputs go to both packages; the JAX function runs at ``kv_chunk = Sk`` (one
key chunk: ROADMAP Queue 3 item 3 does not arise) and its gradient is
``jax.vjp``'s.

Tolerances:

* f32: the output, each gradient and the row log-sum-exp within
  ``ATTN_ATOL`` = 1e-5 absolute (``tests/test_torch_mla.py``'s; the same
  algorithm up to summation order, P as exp(s - lse) against the online
  softmax's rescaling); the lse against a direct numpy computation with the
  JAX package's mask value.
* bf16: the port's plain versions round once, at the end; the JAX package
  rounds P and its output on the way.  Each of the port's bf16 results
  (output, dq, dk, dv) against the JAX package's f32 result may be off by
  at most ``BF16_FACTOR`` (2) times the JAX package's own bf16 error there,
  plus ``BF16_FLOOR`` (2^-8) of the result's largest entry (one bf16
  rounding step of the largest entry, for results the JAX package happens
  to round exactly).
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
from repro_torch.models import layers as TL

ATTN_ATOL = 1e-5
BF16_FACTOR, BF16_FLOOR = 2.0, 2**-8

# (name, b, sq, sk, h, hkv, hd, hd_v, causal, window, q_positions, k_positions); None: arange
CASES = [
    ("mla_causal", 1, 48, 48, 2, 2, 192, 128, True, 0, None, None),
    ("mla_noncausal_gqa", 1, 40, 40, 2, 1, 192, 128, False, 0, None, None),
    ("mla_window_sq_ne_sk", 1, 16, 48, 2, 1, 192, 128, True, 8, np.arange(32, 48), np.arange(48)),
    ("mla_rows_see_no_key", 1, 16, 24, 2, 2, 192, 128, True, 0, np.arange(-3, 13), np.arange(24)),
    ("smoke_causal", 2, 24, 24, 4, 4, 24, 16, True, 0, None, None),
    ("smoke_gqa_window", 2, 30, 30, 4, 2, 24, 16, True, 5, None, None),
    ("w48_positions_sq_ne_sk", 2, 12, 40, 4, 2, 48, 32, True, 0, np.arange(28, 40), np.arange(40)),
    ("w48_noncausal_gqa", 1, 20, 33, 6, 3, 48, 32, False, 0, None, None),
]


def _inputs(case, seed: int = 0):
    _, b, sq, sk, h, hkv, hd, hd_v, *_ = case
    rng = np.random.default_rng([seed, sq, sk, hd, hd_v])
    shapes = ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd_v), (b, sq, h, hd_v))
    return [rng.normal(size=s).astype(np.float32) for s in shapes]  # q, k, v, do


def _kw(case):
    *_, causal, window, qpos, kpos = case
    return dict(causal=causal, window=window, q_positions=qpos, k_positions=kpos)


def _torch_kw(case):
    kw = _kw(case)
    for key in ("q_positions", "k_positions"):
        if kw[key] is not None:
            kw[key] = torch.from_numpy(kw[key])
    return kw


@functools.cache
def _jax_fn(name: str, dtype):
    """The JAX package's attention at kv_chunk = Sk, jitted once per case."""
    case = next(c for c in CASES if c[0] == name)
    kw = _kw(case)
    sk = case[3]
    qpos = None if kw["q_positions"] is None else jnp.asarray(kw["q_positions"])
    kpos = None if kw["k_positions"] is None else jnp.asarray(kw["k_positions"])

    def fn(q, k, v):
        return JL.flash_attention(q.astype(dtype), k.astype(dtype), v.astype(dtype),
                                  mask=JL.MaskSpec(causal=kw["causal"], window=kw["window"]),
                                  q_positions=qpos, k_positions=kpos, kv_chunk=sk)
    return jax.jit(fn)


def _jax(case, q, k, v, do, dtype=jnp.float32):
    """(output, (dq, dk, dv)) of the JAX package, as f32 numpy arrays."""
    out, vjp = jax.vjp(_jax_fn(case[0], dtype), q, k, v)
    grads = vjp(jnp.asarray(do).astype(out.dtype))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port(case, q, k, v, do, dtype=torch.float32):
    """(output, lse, (dq, dk, dv)) of the port's plain versions, reached as the
    models reach them: ``ops.flash_attention`` under autograd (the CPU's
    ``FlashAttention`` with ``flash_attention_lse_ref`` forward and
    ``flash_attention_bwd_ref`` backward)."""
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, **_torch_kw(case))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(dtype))
    _, lse = fa.flash_attention_lse_ref(*(t.detach() for t in leaves), **_torch_kw(case))
    return (out.detach().float().numpy(), lse.numpy(), [g.float().numpy() for g in grads])


def _lse_numpy(case, q, k):
    """The row log-sum-exp of the scaled, masked scores (mask value -1e30), in numpy."""
    _, b, sq, sk, h, hkv, hd, *_ = case
    kw = _kw(case)
    qpos = np.arange(sq) if kw["q_positions"] is None else kw["q_positions"]
    kpos = np.arange(sk) if kw["k_positions"] is None else kw["k_positions"]
    d = qpos[:, None] - kpos[None, :]
    vis = d >= 0 if kw["causal"] else np.ones_like(d, bool)
    if kw["window"]:
        vis &= d < kw["window"]
    kk = np.repeat(k, h // hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(hd)
    s = np.where(vis, s, JL.NEG_INF)
    m = s.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(s - m).sum(-1))).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_output_lse_and_gradients_match_jax_in_f32(case):
    q, k, v, do = _inputs(case)
    want, want_grads = _jax(case, q, k, v, do)
    got, lse, grads = _port(case, q, k, v, do)
    assert got.shape == want.shape == q.shape[:3] + (v.shape[3],)
    np.testing.assert_allclose(got, want, atol=ATTN_ATOL, rtol=0)
    np.testing.assert_allclose(lse, _lse_numpy(case, q, k), atol=ATTN_ATOL, rtol=0)
    for g, w, x in zip(grads, want_grads, (q, k, v)):
        assert g.shape == w.shape == x.shape
        np.testing.assert_allclose(g, w, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_bf16_stays_within_the_jax_packages_own_bf16_error(case):
    q, k, v, do = _inputs(case)
    exact, exact_grads = _jax(case, q, k, v, do)
    jax_bf16, jax_bf16_grads = _jax(case, q, k, v, do, jnp.bfloat16)
    got, _, grads = _port(case, q, k, v, do, torch.bfloat16)
    for name, g, j, w in zip(("out", "dq", "dk", "dv"), [got, *grads], [jax_bf16, *jax_bf16_grads],
                             [exact, *exact_grads]):
        own = float(np.abs(j - w).max())
        err = float(np.abs(g - w).max())
        assert err <= BF16_FACTOR * own + BF16_FLOOR * float(np.abs(w).max()), (name, err, own)


@pytest.mark.parametrize("dtype,hd,hd_v,width", [
    (torch.float32, 192, 128, 192), (torch.bfloat16, 192, 128, 192),
    (torch.float32, 24, 16, 24), (torch.bfloat16, 24, 16, 32),  # q/k padded to the granule
    (torch.bfloat16, 48, 32, 48),
])
def test_layer_hands_the_plain_versions_v_at_hd_v(monkeypatch, dtype, hd, hd_v, width):
    """``layers.flash_attention`` pads no V: the forward's and the backward's
    plain versions see V (and O, dO) at hd_v, q and k at hd (bf16: the
    granule's multiple), and the output and dv come back at hd_v."""
    seen = []
    fwd, bwd = fa.flash_attention_lse_ref, fab.flash_attention_bwd_ref

    def fwd_rec(q, k, v, **kw):
        seen.append(("fwd", q.shape[-1], k.shape[-1], v.shape[-1]))
        return fwd(q, k, v, **kw)

    def bwd_rec(q, k, v, o, do, lse, **kw):
        seen.append(("bwd", q.shape[-1], v.shape[-1], o.shape[-1], do.shape[-1]))
        return bwd(q, k, v, o, do, lse, **kw)

    monkeypatch.setattr(fa, "flash_attention_lse_ref", fwd_rec)
    monkeypatch.setattr(fab, "flash_attention_bwd_ref", bwd_rec)
    rng = np.random.default_rng(hd + hd_v)
    q, k = (torch.from_numpy(rng.normal(size=(1, 8, 2, hd)).astype(np.float32)).to(dtype)
            for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(1, 8, 2, hd_v)).astype(np.float32)).to(dtype)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    out = TL.flash_attention(*leaves, mask=TL.MaskSpec(causal=True))
    out.float().sum().backward()
    assert out.shape == (1, 8, 2, hd_v) and v.grad.shape == v.shape and q.grad.shape == q.shape
    assert seen == [("fwd", width, width, hd_v), ("bwd", width, hd_v, hd_v, hd_v)]


def test_flops_count_both_head_dims():
    """The forward counts 2 (hd + hd_v) operations per walked pair and head,
    the backward S, dK and dQ at hd and dP and dV at hd_v: 3 * 2 (hd + hd_v)
    + 2 hd per pair.  A non-causal call whose Sq and Sk are whole tiles walks
    every pair, so the counts are exact products."""
    b, sq, sk, h, hkv, hd, hd_v = 1, 128, 256, 4, 2, 192, 128
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")  # noqa: E731
    q, k, v = meta(b, sq, h, hd), meta(b, sk, hkv, hd), meta(b, sk, hkv, hd_v)
    out, lse, flops = fa.flash_attention_meta(q, k, v, causal=False, with_lse=True)
    assert out.shape == (b, sq, h, hd_v) and lse.shape == (b, h, sq)
    assert flops == 2 * (hd + hd_v) * b * h * sq * sk
    assert flops == fa.flops("tile", b, sq, sk, h, hkv, hd, False, 0, hd_v)
    assert fa.flops("tile", b, sq, sk, h, hkv, hd, False, 0) == 4 * hd * b * h * sq * sk
    o = meta(b, sq, h, hd_v)
    dq, dk, dv, bwd = fab.flash_attention_bwd_meta(q, k, v, o, o, lse, causal=False)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert bwd == (3 * 2 * (hd + hd_v) + 2 * hd) * b * h * sq * sk
    assert fab.flops(b, sq, sk, h, hkv, hd, False, 0) == 7 * 2 * hd * b * h * sq * sk


@pytest.mark.parametrize("hd,hd_v,takes,design", [
    (192, 128, True, "wgmma"), (160, 128, True, "wgmma"), (128, 64, True, "wgmma"),
    (32, 16, True, "wgmma"), (48, 32, True, "wgmma"), (192, 192, True, "mma"),
    (256, 128, True, "mma"), (256, 256, True, "mma"),
    (24, 16, False, None), (32, 24, False, None), (128, 192, False, None),
])
def test_backward_design_and_checks_by_both_head_dims(hd, hd_v, takes, design):
    """The launcher's rule mirrored in Python: "wgmma" for hd <= 192 with
    hd_v <= 128; both multiples of 16, hd_v <= hd, or no kernel."""
    assert fab.kernel_takes(torch.bfloat16, hd, hd_v) is takes
    if takes:
        assert fab.design(hd, hd_v) == design
        assert fa.tensor_cores_take(torch.bfloat16, hd, True, hd_v)
    x = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    q, k, v, o = x(1, 8, 2, hd), x(1, 8, 2, hd), x(1, 8, 2, hd_v), x(1, 8, 2, hd_v)
    if hd_v > hd:
        with pytest.raises(ValueError, match="hd_v"):
            fab.flash_attention_bwd_ref(q, k, v, o, o, torch.zeros((1, 2, 8)))
        return
    with pytest.raises(ValueError, match="CUDA kernel"):  # a CPU tensor never reaches a kernel
        fab.flash_attention_bwd(q, k, v, o, o, torch.zeros((1, 2, 8)))
    with pytest.raises(ValueError, match="do is"):  # dO at hd, not hd_v
        fab.flash_attention_bwd_ref(q, k, v, o, x(1, 8, 2, hd + 16), torch.zeros((1, 2, 8)))
