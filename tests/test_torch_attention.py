"""The port's attention held against the JAX package.

On the CPU the port's ``flash_attention`` is its plain version (naive
softmax in f32 with explicit positions), the function the CUDA kernel is
held to on the card (tests/test_torch_cuda.py).  It must match:

* the Pallas kernel ``ops.flash_attention`` (interpret mode), at the shapes
  and with the tolerances of tests/test_kernels.py;
* ``layers.flash_attention`` with explicit positions and a sliding window;
* ``layers.decode_attention`` and ``attention.attn_decode``, with and
  without a ring buffer.

Tolerances: f32 inputs agree to summation order (atol 2e-3, rtol 1e-2, as
tests/test_kernels.py).  In bf16 the JAX layers round scores and
probabilities to bf16 before the PV product while the port keeps them in
f32; outputs are O(1), so they differ by a few bf16 ulps (2^-8 relative):
atol 3e-2, rtol 5e-2, as the dtype sweep of tests/test_kernels.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget
from repro.kernels import ops as jops
from repro.models import attention as JA
from repro.models import layers as JL
from repro.sharding import AxisCtx, init_params as jinit
from repro_torch.configs import get_smoke as tget
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.sharding import params_from_numpy

F32_TOL = dict(atol=2e-3, rtol=1e-2)
BF16_TOL = dict(atol=3e-2, rtol=5e-2)


def _qkv(rng, b, sq, sk, h, hkv, hd):
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, hd)).astype(np.float32))


def _port(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,sq,sk,h,hkv,hd,causal,blk", [
    (1, 64, 64, 2, 2, 16, True, 32),
    (2, 128, 128, 4, 2, 32, True, 64),
    (1, 96, 96, 3, 1, 8, False, 32),
    (2, 64, 64, 8, 8, 64, True, 16),
])
def test_matches_pallas_kernel(b, sq, sk, h, hkv, hd, causal, blk):
    rng = np.random.default_rng(b * 100 + sq + h)
    q, k, v = _qkv(rng, b, sq, sk, h, hkv, hd)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, bq=blk, bk=blk)
    got = ops.flash_attention(*_port(q, k, v), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(
        _np(got), _np(jops.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               causal=causal)), **F32_TOL)


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
def test_dtype_sweep_matches_pallas_kernel(jdt, tdt):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 1, 64, 64, 2, 2, 16)
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), bq=32, bk=32)
    got = ops.flash_attention(*_port(q, k, v, dtype=tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


# (b, sq, sk, h, hkv, hd, causal, window, q_offset): queries at positions
# q_offset .. q_offset + sq - 1 against keys at 0 .. sk - 1
LAYER_CASES = [
    (2, 37, 37, 8, 4, 16, True, 0, 0),      # tests/test_models.py's ragged causal case
    (1, 32, 32, 2, 2, 8, True, 4, 0),       # sliding window
    (2, 7, 40, 4, 2, 16, True, 0, 33),      # a chunk of queries after a 33-token prefix
    (1, 9, 50, 6, 3, 8, True, 12, 41),      # the same, windowed
    (2, 23, 41, 4, 4, 16, False, 0, 0),     # ragged, non-causal, H == Hkv
]


@pytest.mark.parametrize("case", LAYER_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_matches_layers_flash_attention(case, dt):
    b, sq, sk, h, hkv, hd, causal, window, q_offset = case
    rng = np.random.default_rng(sum(case))
    q, k, v = _qkv(rng, b, sq, sk, h, hkv, hd)
    qpos, kpos = np.arange(q_offset, q_offset + sq), np.arange(sk)
    jdt, tdt, tol = ((jnp.float32, torch.float32, F32_TOL) if dt == "f32"
                     else (jnp.bfloat16, torch.bfloat16, BF16_TOL))
    want = JL.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              mask=JL.MaskSpec(causal=causal, window=window),
                              q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
                              q_chunk=16, kv_chunk=sk)
    got = TL.flash_attention(*_port(q, k, v, dtype=tdt),
                             mask=TL.MaskSpec(causal=causal, window=window),
                             q_positions=torch.from_numpy(qpos), k_positions=torch.from_numpy(kpos))
    assert got.dtype == tdt and got.shape == (b, sq, h, hd)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_window_hides_old_tokens():
    rng = np.random.default_rng(1)
    q, k, v = _port(*_qkv(rng, 1, 32, 32, 2, 2, 8))
    mask = TL.MaskSpec(causal=True, window=4)
    k2, v2 = k.clone(), v.clone()
    k2[:, :20] = 0.0
    v2[:, :20] = 0.0
    np.testing.assert_allclose(_np(TL.flash_attention(q, k, v, mask=mask)[:, -1]),
                               _np(TL.flash_attention(q, k2, v2, mask=mask)[:, -1]), atol=1e-6)


def test_row_that_sees_no_key_averages_v_as_in_jax():
    """A hidden score is -1e30, not -inf: a query before every key averages v."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 3, 5, 2, 1, 8)
    qpos, kpos = np.array([-4, -1, 2]), np.arange(5)
    want = JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask=JL.MaskSpec(causal=True), q_positions=jnp.asarray(qpos),
                              k_positions=jnp.asarray(kpos))
    got = ops.flash_attention(*_port(q, k, v), q_positions=torch.from_numpy(qpos),
                              k_positions=torch.from_numpy(kpos))
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(got)[0, 0], np.broadcast_to(v.mean(1)[0], (2, 8)), atol=1e-5)


@pytest.mark.parametrize("window,pos", [(0, 0), (0, 11), (0, 15), (6, 3), (6, 9), (6, 14)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_matches_decode_attention(window, pos, dt):
    """One query against a 16-slot cache (window > 0: a 6-slot ring buffer)."""
    b, s, h, hkv, hd = 3, 16 if not window else window, 8, 2, 16
    rng = np.random.default_rng(pos * 10 + window)
    q, kc, vc = _qkv(rng, b, 1, s, h, hkv, hd)
    kpos = np.arange(s) if not window else TA.ring_positions(pos, s, "cpu").numpy()
    jdt, tdt, tol = ((jnp.float32, torch.float32, F32_TOL) if dt == "f32"
                     else (jnp.bfloat16, torch.bfloat16, BF16_TOL))
    want = JL.decode_attention(*(jnp.asarray(a, jdt) for a in (q, kc, vc)), jnp.asarray(kpos),
                               pos, window=window)
    got = TL.decode_attention(*_port(q, kc, vc, dtype=tdt), torch.from_numpy(kpos), pos,
                              window=window)
    assert got.dtype == tdt and got.shape == (b, 1, h, hd)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("s_cache,pos", [(8, 0), (8, 5), (8, 8), (8, 13), (8, 100)])
def test_ring_positions_match_the_reference(s_cache, pos):
    idx = jnp.arange(s_cache)
    want = idx + s_cache * ((pos - idx + s_cache) // s_cache) - s_cache
    want = np.where(want < 0, 2**30, want)
    np.testing.assert_array_equal(TA.ring_positions(pos, s_cache, "cpu").numpy(), want)


@pytest.fixture
def f32_compute(monkeypatch):
    """Both packages computing in f32 (their layers cast parameters to
    ``COMPUTE_DTYPE`` at use): the comparison then checks the algorithm to
    summation order, free of the two frameworks' different bf16 roundings."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("window", [0, 8])
def test_attn_decode_matches_reference_step_by_step(window, f32_compute):
    """The attention block's decode path (projections, RoPE, cache write,
    ring positions) over 20 steps: past the ring buffer's wrap-around."""
    cfg = dataclasses.replace(jget("granite-8b"), long_window=window)
    tcfg = dataclasses.replace(tget("granite-8b"), long_window=window)
    jparams = jinit(JA.attn_specs(cfg), jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    b, steps = 2, 20
    s_cache = window or steps
    rng = np.random.default_rng(window)
    xs = rng.normal(size=(b, steps, cfg.d_model)).astype(np.float32)
    shape = JA.init_cache_shape(cfg, b, s_cache)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    step = jax.jit(lambda p, x, c, pos: JA.attn_decode(p, x, c, pos, cfg, AxisCtx(),
                                                       window=window))
    for pos in range(steps):
        x = xs[:, pos:pos + 1]
        want, jcache = step(jparams, jnp.asarray(x), jcache, jnp.int32(pos))
        got, tcache = TA.attn_decode(tparams, torch.from_numpy(x), tcache, pos, tcfg,
                                     window=window)
        np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]), **F32_TOL)


def test_visible_is_the_reference_mask():
    qpos, kpos = np.array([0, 3, 7, 7]), np.arange(9)
    for causal, window in [(True, 0), (True, 3), (False, 0), (False, 2)]:
        want = np.asarray(JL._block_mask(jnp.asarray(qpos), jnp.asarray(kpos),
                                         JL.MaskSpec(causal=causal, window=window)))
        got = fa.visible(torch.from_numpy(qpos), torch.from_numpy(kpos), causal, window)
        np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_and_never_runs_the_plain_version():
    q = torch.zeros((1, 4, 4, 8))
    kv = torch.zeros((1, 4, 3, 8))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_ref(q, kv, kv)
    with pytest.raises(TypeError):
        fa.flash_attention_ref(q.half(), kv.half()[:, :, :2], kv.half()[:, :, :2])
    with pytest.raises(ValueError, match="hd_v"):
        fa.flash_attention_ref(q, q, torch.zeros((1, 4, 4, 4)))
    with pytest.raises(ValueError, match="positions"):
        fa.flash_attention_ref(q, q, q, q_positions=torch.arange(3))
    launches = fa.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA kernel"):
        fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == launches
