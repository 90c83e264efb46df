"""The schedule of the port's tensor-core attention kernels, modelled on the CPU.

``csrc/flash_attention.cu`` computes attention in 64-key tiles, skips a tile
whose every (query, key) pair is hidden, splits a decode over contiguous
runs of tiles and merges the splits by the log-sum-exp rule, and gives a row
that sees no key the mean of V.  The kernels run only on the card; here a
plain PyTorch model of that schedule (``model_attention`` below: the same
blocks, tiles, skip predicate, partials and combine order) is held to

* ``flash_attention_ref``, the plain version the kernels are held to on the
  card: f32 within 1e-5 (summation order), bf16 inputs within ``ATTN_TOL``
  (2^-7 absolute and relative: one bf16 rounding step of the output);
* the JAX package's ``layers.decode_attention`` / ``layers.flash_attention``
  on the same numpy inputs, f32 within 1e-5.

The wrapper's rules (``choose_variant``, ``split_plan``) are pure Python
and tested as they are.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

F32_TOL = dict(atol=1e-5, rtol=1e-5)
ATTN_TOL = dict(atol=2**-7, rtol=2**-7)
H100_SMS = 132


def tile_state(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: int) -> int:
    """The kernel's skip predicate on a block's query positions and a tile's
    key positions: 0 every pair hidden, 1 some hidden, 2 every pair visible."""
    if not causal and window <= 0:
        return 2
    qmin, qmax = int(qpos.min()), int(qpos.max())
    kmin, kmax = int(kpos.min()), int(kpos.max())
    if (causal and kmin > qmax) or (window > 0 and qmin - kmax >= window):
        return 0
    full = (not causal or kmax <= qmin) and (window <= 0 or qmax - kmin < window)
    return 2 if full else 1


def model_attention(q, k, v, *, q_positions, k_positions, causal=True, window=0, scale=None,
                    block_rows=fa.TILE_ROWS, splits=1, per=None):
    """The kernels' schedule in f32: blocks of ``block_rows`` (query, head)
    rows of one kv head; ``splits`` runs of ``per`` 64-key tiles each;
    hidden tiles skipped; per-split (m, l, acc) merged in split order; a row
    that sees no key gets the mean of V."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    rows = sq * g
    tiles = -(-sk // fa.KV_TILE)
    per = tiles if per is None else per
    assert (splits - 1) * per < tiles <= splits * per
    scale = 1.0 / hd ** 0.5 if scale is None else scale
    qp, kp = q_positions.long(), k_positions.long()
    row_q = torch.arange(rows) // g  # row = query * g + head-in-group
    out = torch.empty((b, sq, h, hd), dtype=torch.float32)
    for bi in range(b):
        for kvh in range(hkv):
            qr = q[bi].float().reshape(sq, hkv, g, hd)[:, kvh].reshape(rows, hd)
            kk, vv = k[bi, :, kvh].float(), v[bi, :, kvh].float()
            res = torch.empty((rows, hd))
            for r0 in range(0, rows, block_rows):
                rr = torch.arange(r0, min(rows, r0 + block_rows))
                qpos = qp[row_q[rr]]
                parts = []
                for s in range(splits):
                    m = torch.full((len(rr),), fa.NEG_INF)
                    l = torch.zeros(len(rr))
                    acc = torch.zeros((len(rr), hd))
                    for t in range(s * per, min(tiles, (s + 1) * per)):
                        keys = torch.arange(t * fa.KV_TILE, min(sk, (t + 1) * fa.KV_TILE))
                        state = tile_state(qpos, kp[keys], causal, window)
                        if state == 0:
                            continue
                        sc = (qr[rr] @ kk[keys].T) * scale
                        if state == 1:
                            vis = fa.visible(qpos, kp[keys], causal, window)
                            sc = sc.masked_fill(~vis, fa.NEG_INF)
                        m_new = torch.maximum(m, sc.max(1).values)
                        p = torch.exp(sc - m_new[:, None])
                        corr = torch.exp(m - m_new)
                        l = l * corr + p.sum(1)
                        acc = acc * corr[:, None] + p @ vv[keys]
                        m = m_new
                    parts.append((m, l, acc))
                mx = torch.stack([p[0] for p in parts]).max(0).values
                lsum = torch.zeros(len(rr))
                asum = torch.zeros((len(rr), hd))
                for m, l, acc in parts:  # split 0, 1, ... in order
                    w = torch.exp(m - mx)
                    lsum = lsum + w * l
                    asum = asum + w[:, None] * acc
                blind = mx == fa.NEG_INF
                res[rr] = torch.where(blind[:, None], vv.mean(0),
                                      asum / lsum.clamp_min(1e-30)[:, None])
            out[bi, :, kvh * g:(kvh + 1) * g] = res.reshape(sq, g, hd)
    return out.to(q.dtype)


def _inputs(seed, b, sq, sk, h, hkv, hd, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd))]
    return arrays, [torch.from_numpy(a).to(dtype) for a in arrays]


# (b, sq, sk, h, hkv, hd, causal, window, q_positions, k_positions, splits): positions
# as ("arange", start) or ("ring", pos) for a ring buffer of sk slots after writing pos
SCHEDULE_CASES = [
    (2, 1, 25, 8, 2, 16, True, 0, 22, "arange", 1),       # the serve step's shape
    (2, 1, 41, 8, 2, 16, True, 0, 40, "arange", 1),
    (1, 1, 41, 4, 1, 16, True, 0, 17, "arange", 1),
    (2, 1, 4096, 8, 1, 16, True, 0, 2047, "arange", 2),   # second split wholly hidden
    (1, 1, 4096, 8, 2, 16, True, 0, 1000, "arange", 7),   # five splits wholly hidden
    (1, 1, 4096, 4, 1, 16, True, 0, 4095, "arange", 7),
    (2, 1, 130, 8, 2, 16, True, 0, 129, "arange", 2),
    (1, 1, 25, 4, 2, 16, True, 8, 500, "ring", 1),        # ring buffer, window = slots
    (1, 1, 200, 4, 2, 16, True, 64, 1000, "ring", 2),     # ring buffer, permuted kpos
    (1, 1, 200, 4, 2, 16, True, 64, 150, "ring", 3),      # ring buffer before it wraps
    (2, 1, 300, 4, 1, 16, True, 40, 299, "arange", 3),    # window hides the old splits
    (1, 1, 300, 4, 1, 16, True, 0, -3, "arange", 3),      # the row sees nothing
    (1, 9, 300, 8, 2, 16, True, 0, 200, "arange", 2),     # 36 rows: three 16-row blocks
    (1, 96, 200, 4, 4, 16, True, 0, 60, "arange", 1),     # many queries, one 128-row block
    (1, 200, 300, 2, 1, 256, True, 0, 100, "arange", 1),  # hd 256: 64-row blocks
    (1, 70, 150, 8, 2, 16, False, 0, 0, "arange", 1),     # non-causal, ragged
    (1, 40, 150, 4, 1, 16, True, 24, 100, "arange", 1),   # windowed chunk of queries
    (1, 80, 256, 4, 1, 16, True, 0, -40, "arange", 1),    # half the rows see nothing
]


def _positions(case):
    b, sq, sk, h, hkv, hd, causal, window, start, kind, splits = case
    qpos = torch.arange(start, start + sq, dtype=torch.int32)
    if kind == "ring":
        return qpos, TA.ring_positions(start, sk, "cpu")
    return qpos, torch.arange(sk, dtype=torch.int32)


def _schedule(case):
    b, sq, sk, h, hkv, hd, causal, window, start, kind, splits = case
    rows = sq * (h // hkv)
    # a "tile" block holds two 16-row m-tiles per warp up to hd 128, one at hd 256
    block_rows = fa.SPLIT_ROWS if rows < fa.TILE_ROWS else (128 if hd <= 128 else 64)
    tiles = -(-sk // fa.KV_TILE)
    per = -(-tiles // splits)
    return dict(block_rows=block_rows, splits=-(-tiles // per), per=per)


@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_schedule_matches_the_plain_version(case, dt):
    b, sq, sk, h, hkv, hd, causal, window = case[:8]
    dtype, tol = (torch.float32, F32_TOL) if dt == "f32" else (torch.bfloat16, ATTN_TOL)
    _, (q, k, v) = _inputs(sum(case[:6]), b, sq, sk, h, hkv, hd, dtype)
    qpos, kpos = _positions(case)
    kw = dict(q_positions=qpos, k_positions=kpos, causal=causal, window=window)
    got = model_attention(q, k, v, **kw, **_schedule(case))
    want = fa.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_schedule_matches_the_jax_layers(case):
    b, sq, sk, h, hkv, hd, causal, window, start = case[:9]
    (qn, kn, vn), (q, k, v) = _inputs(sum(case[:6]), b, sq, sk, h, hkv, hd)
    qpos, kpos = _positions(case)
    got = model_attention(q, k, v, q_positions=qpos, k_positions=kpos, causal=causal,
                          window=window, **_schedule(case))
    if sq == 1 and causal:
        want = JL.decode_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.asarray(kpos.numpy()), start, window=window)
    else:  # kv_chunk = Sk: the JAX layer pads a ragged last chunk (ROADMAP Queue 3)
        want = JL.flash_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                  mask=JL.MaskSpec(causal=causal, window=window),
                                  q_positions=jnp.asarray(qpos.numpy()),
                                  k_positions=jnp.asarray(kpos.numpy()), q_chunk=16, kv_chunk=sk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **F32_TOL)


def test_a_row_that_sees_no_key_averages_v_across_skipped_tiles():
    """Every tile is skipped for the first row; it still averages all of V."""
    _, (q, k, v) = _inputs(7, 1, 2, 300, 4, 1, 16)
    qpos, kpos = torch.tensor([-1, 70], dtype=torch.int32), torch.arange(300, dtype=torch.int32)
    got = model_attention(q, k, v, q_positions=qpos, k_positions=kpos, block_rows=16,
                          splits=3, per=2)
    torch.testing.assert_close(got[0, 0], v[0, :, 0].mean(0).expand(4, 16), **F32_TOL)
    torch.testing.assert_close(got, fa.flash_attention_ref(q, k, v, q_positions=qpos,
                                                           k_positions=kpos), **F32_TOL)


def test_splits_and_blocks_of_one_call_agree():
    """The merge is exact to summation order whatever the split count."""
    _, (q, k, v) = _inputs(8, 1, 1, 4096, 8, 2, 16)
    kw = dict(q_positions=torch.tensor([3001], dtype=torch.int32),
              k_positions=torch.arange(4096, dtype=torch.int32))
    one = model_attention(q, k, v, **kw, block_rows=16, splits=1)
    for splits, per in [(2, 32), (7, 10), (64, 1)]:
        torch.testing.assert_close(model_attention(q, k, v, **kw, block_rows=16, splits=splits,
                                                   per=per), one, **F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 7), (False, 0)])
def test_skip_predicate_is_exact(causal, window):
    """A tile is skipped only if no pair in it is visible, and called fully
    visible only if every pair is, for random (ring-like) positions."""
    rng = np.random.default_rng(int(causal) * 10 + window)
    for _ in range(300):
        qpos = torch.from_numpy(rng.integers(-20, 60, rng.integers(1, 9)))
        kpos = torch.from_numpy(rng.integers(-10, 70, rng.integers(1, 65)))
        vis = fa.visible(qpos, kpos, causal, window)
        state = tile_state(qpos, kpos, causal, window)
        assert state != 0 or not vis.any()
        assert state != 2 or vis.all()
        if window == 0 and causal:  # min/max bounds are tight for the causal mask alone
            assert (state == 0) == (not vis.any()) and (state == 2) == bool(vis.all())


def test_causal_prefill_skips_the_tiles_past_the_block():
    qpos = torch.arange(120, 128)
    states = [tile_state(qpos, torch.arange(t * 64, (t + 1) * 64), True, 0) for t in range(4)]
    assert states == [2, 1, 0, 0]


# -- the wrapper's rules ---------------------------------------------------------------
@pytest.mark.parametrize("dtype,sq,h,hkv,hd,aligned,want", [
    (torch.bfloat16, 1, 32, 4, 128, True, "split"),     # every decode step of the serving path
    (torch.bfloat16, 2048, 32, 4, 128, True, "tile"),   # the Pallas contract
    (torch.bfloat16, 1000, 8, 8, 128, True, "tile"),    # ragged non-causal MHA
    (torch.bfloat16, 7, 32, 4, 128, True, "split"),     # 56 rows
    (torch.bfloat16, 8, 32, 4, 128, True, "tile"),      # 64 rows
    (torch.bfloat16, 63, 4, 4, 64, True, "split"),
    (torch.bfloat16, 64, 4, 4, 256, True, "tile"),
    (torch.float32, 2048, 32, 4, 128, True, "general"),  # TF32 would break the f32 tolerance
    (torch.float32, 1, 32, 4, 128, True, "general"),
    (torch.bfloat16, 300, 6, 3, 8, True, "general"),    # the smoke configs' head dim
    (torch.bfloat16, 300, 6, 3, 24, True, "general"),
    (torch.bfloat16, 300, 6, 3, 288, True, "general"),
    (torch.bfloat16, 300, 32, 4, 128, False, "general"),  # rows not 16-byte aligned
])
def test_choose_variant(dtype, sq, h, hkv, hd, aligned, want):
    assert fa.choose_variant(dtype, sq, h, hkv, hd, aligned) == want


@pytest.mark.parametrize("sk,b,hkv,rows", [
    (4096, 16, 4, 8), (25, 4, 4, 8), (1024, 8, 4, 8), (41, 1, 1, 8), (4096, 1, 1, 56),
    (64, 1, 1, 8), (65, 1, 1, 8), (131072, 1, 8, 8), (100, 512, 8, 8), (1, 1, 1, 1),
])
def test_split_plan_covers_every_tile_once(sk, b, hkv, rows):
    splits, per = fa.split_plan(sk, b, hkv, rows, H100_SMS)
    tiles = -(-sk // fa.KV_TILE)
    assert 1 <= splits <= tiles and per >= 1
    assert (splits - 1) * per < tiles <= splits * per
    assert per <= fa.MAX_TILES_PER_SPLIT
    blocks = b * hkv * -(-rows // fa.SPLIT_ROWS)
    # within a factor 2 of the blocks aimed at (whole tiles per split round it down)
    assert 2 * blocks * splits >= min(fa.BLOCKS_PER_SM * H100_SMS, blocks * tiles)


def test_split_plan_at_the_main_shapes():
    # decode 16 x 4096: at least two blocks on each of the 132 SMs
    splits, per = fa.split_plan(4096, 16, 4, 8, H100_SMS)
    assert splits > 1 and 16 * 4 * splits >= 2 * H100_SMS and per <= fa.MAX_TILES_PER_SPLIT
    # the serve step's 25 slots: one split, so one launch and no combine
    assert fa.split_plan(25, 4, 4, 8, H100_SMS) == (1, 1)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_slot_positions_need_no_cast(window, monkeypatch):
    """attn_decode hands the kernel int32 slot positions, so the wrapper's
    ``_positions`` casts nothing (no extra launch on the card)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.sharding import init_params

    seen = []

    def capture(q, k_cache, v_cache, k_positions, cur_pos, **kw):
        seen.append(k_positions)
        return TL.decode_attention(q, k_cache, v_cache, k_positions, cur_pos, **kw)

    monkeypatch.setattr(TA, "decode_attention", capture)
    cfg = dataclasses.replace(get_smoke("granite-8b"), long_window=window)
    params = init_params(TA.attn_specs(cfg), torch.Generator().manual_seed(0), device="cpu")
    shape = TA.init_cache_shape(cfg, 2, window or 16)
    cache = {"k": torch.zeros(shape, dtype=TL.COMPUTE_DTYPE),
             "v": torch.zeros(shape, dtype=TL.COMPUTE_DTYPE)}
    for pos in range(12):
        x = torch.randn((2, 1, cfg.d_model), generator=torch.Generator().manual_seed(pos))
        x = x.to(TL.COMPUTE_DTYPE)
        _, cache = TA.attn_decode(params, x, cache, pos, cfg, window=window)
    assert all(kp.dtype == torch.int32 and fa._positions(kp, kp.shape[0], kp.device) is kp
               for kp in seen) and len(seen) == 12
