"""The tile walk of the port's Hopper forward kernel ("tile", "wgmma" design), on the CPU.

``src/repro_torch/kernels/csrc/flash_attention.cu`` runs only on the card,
so this file mirrors in Python how ``attn_fwd_wgmma_kernel`` shares out the
work and holds the mirror to ``kernels/flash_attention.py::visible``, to the
plain version and to the JAX package:

* a block owns 128 queries of one (batch, head); its producer warp works out
  each key tile's position range from ``k_pos`` and loads the tile when
  some pair of the block's queries may see it (``tile_state_of`` != 0);
  a tile holds ``kFwdKeys`` (128) keys;
* each of its two consumer warpgroups (64 rows) computes a loaded tile
  unless its own rows see none of it, without masks where every pair is
  visible and no key lies past Sk, pair by pair otherwise (-1e30 for a
  hidden score, nothing for a key past Sk);
* the online softmax runs in base 2 with the scale folded in; a row whose
  running max stays at -1e30 saw no key and gets the mean of V over all Sk
  keys, and lse -1e30.

The walk must reach every visible pair once and load no wholly hidden tile
(with key positions in order).  The cases are those of
``tests/test_torch_attention.py`` and wider ones that span several blocks
with ragged Sq and Sk.  A test pins the mirror's constants to the source
text, and the design rule by dtype, head dims and Sq is checked without a
card.  The text patches with which ``scripts/attn_fwd_ab.py`` and
``scripts/attn_fwd_clocks.py`` build their copies of the source must still
apply to it.
"""
import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as fa

SOURCE = (pathlib.Path(__file__).resolve().parents[1]
          / "src/repro_torch/kernels/csrc/flash_attention.cu")

FWD_ROWS = 128  # kFwdRows: queries per block
WG_ROWS = 64  # rows of a consumer warpgroup, the M of wgmma
FWD_KEYS = 128  # kFwdKeys: keys per K/V tile and stage, the N of S's wgmma
KEYS = 64  # kKeys: keys per tile of the "mma" design and of "split"
FWD_STAGES = 4  # kFwdStages: the most stages, fewer where they do not fit
WG_THREADS, THREADS = 128, 384  # kWgThreads, kWgmmaThreads
PRODUCER_REGS, CONSUMER_REGS = 24, 240  # kProducerRegs, kConsumerRegs
SMEM_PER_BLOCK = 232_448  # kMaxSmemBytes: shared memory a block may use on an H100
REGS_PER_SM = 65_536
MASKED = np.float32(-1e30)
LOG2E = 1.4426950408889634

# (name, sq, sk, h, hkv, causal, window, q_positions, k_positions); None: arange
LAYER_CASES = [  # tests/test_torch_attention.py's LAYER_CASES: queries after a prefix
    ("ragged_causal", 37, 37, 8, 4, True, 0, None, None),
    ("window", 32, 32, 2, 2, True, 4, None, None),
    ("chunk_after_prefix", 7, 40, 4, 2, True, 0, np.arange(33, 40), None),
    ("chunk_after_prefix_windowed", 9, 50, 6, 3, True, 12, np.arange(41, 50), None),
    ("ragged_noncausal_mha", 23, 41, 4, 4, False, 0, None, None),
    ("rows_see_no_key", 3, 5, 2, 1, True, 0, np.array([-4, -1, 2]), None),
]
WIDE_CASES = [  # several blocks and tiles each way, ragged edges
    ("causal_600", 600, 600, 12, 2, True, 0, None, None),
    ("two_blocks_exactly", 256, 256, 2, 1, True, 0, None, None),
    ("sq_64_one_warpgroup", 64, 64, 4, 4, True, 0, None, None),
    ("window_crossing_tiles", 520, 520, 4, 2, True, 150, None, None),
    ("end_of_cache_sq_ne_sk", 100, 333, 8, 2, True, 0, np.arange(233, 333), None),
    ("whisper_like_tail", 130, 1500, 2, 2, False, 0, None, None),
    ("blind_rows_span_tiles", 300, 450, 4, 2, True, 0, np.arange(-100, 200), None),
    ("blind_block", 256, 512, 2, 1, True, 0, np.arange(-200, 56), None),
    ("ring_buffer_window", 200, 256, 4, 1, True, 64, np.arange(300, 500),
     (np.arange(256) + 400) % 512),
    ("negative_positions_window", 150, 300, 2, 2, True, 40, np.arange(-20, 130),
     np.arange(-60, 240)),
]
CASES = LAYER_CASES + WIDE_CASES


def tile_state(kmin, kmax, qmin, qmax, causal, window):
    """attention_tiles.cuh::tile_state_of: 0 all hidden, 1 some, 2 all visible."""
    if not causal and window <= 0:
        return 2
    if (causal and kmin > qmax) or (window > 0 and qmin - kmax >= window):
        return 0
    full = (not causal or kmax <= qmin) and (window <= 0 or qmax - kmin < window)
    return 2 if full else 1


def _case(case):
    _, sq, sk, h, hkv, causal, window, qpos, kpos = case
    qp = np.arange(sq) if qpos is None else np.asarray(qpos)
    kp = np.arange(sk) if kpos is None else np.asarray(kpos)
    vis = fa.visible(torch.from_numpy(qp), torch.from_numpy(kp), causal, window).numpy()
    return sq, sk, h, hkv, causal, window, qp, kp, vis


def walk(sq, sk, h, causal, window, qp, kp):
    """attn_fwd_wgmma_kernel's walk over key tiles of ``FWD_KEYS`` keys: the
    (block, head, key tile) triples its producers load, and for each
    warpgroup that computes a loaded tile (head, block, warpgroup, rows,
    tile, state), in the order it runs them."""
    loaded, computed = [], []
    for qb in range(-(-sq // FWD_ROWS)):
        block = np.arange(qb * FWD_ROWS, min(sq, (qb + 1) * FWD_ROWS))
        qmin, qmax = qp[block].min(), qp[block].max()
        for head in range(h):
            for kt in range(-(-sk // FWD_KEYS)):
                keys = kp[kt * FWD_KEYS:(kt + 1) * FWD_KEYS]
                if not tile_state(keys.min(), keys.max(), qmin, qmax, causal, window):
                    continue
                loaded.append((qb, head, kt))
                for wg in range(FWD_ROWS // WG_ROWS):
                    rows = block[wg * WG_ROWS:(wg + 1) * WG_ROWS]
                    if not len(rows):  # every row past Sq
                        continue
                    state = tile_state(keys.min(), keys.max(), qp[rows].min(), qp[rows].max(),
                                       causal, window)
                    if state:
                        computed.append((head, qb, wg, rows, kt, state))
    return loaded, computed


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_walk_reaches_every_visible_pair_once(case):
    sq, sk, h, hkv, causal, window, qp, kp, vis = _case(case)
    _, computed = walk(sq, sk, h, causal, window, qp, kp)
    count = np.zeros((h, sq, sk), np.int64)
    for head, _, _, rows, kt, state in computed:
        keys = np.arange(kt * FWD_KEYS, min(sk, (kt + 1) * FWD_KEYS))
        sub = vis[np.ix_(rows, keys)]
        # state 2 skips the pair masks: only where every pair is visible
        assert state != 2 or sub.all()
        count[head][np.ix_(rows, keys)] += sub
    np.testing.assert_array_equal(count, np.broadcast_to(vis, (h, sq, sk)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_walk_loads_no_hidden_key_tile(case):
    """Every tile that holds a visible pair of the block is loaded, once;
    with key positions in order, no other tile.  The walk judges a tile by
    the range of its positions, so keys out of order (a ring buffer) can
    keep a tile whose pairs are all hidden: masked pair by pair."""
    sq, sk, h, hkv, causal, window, qp, kp, vis = _case(case)
    loaded, _ = walk(sq, sk, h, causal, window, qp, kp)
    want = {(qb, head, kt) for qb in range(-(-sq // FWD_ROWS)) for head in range(h)
            for kt in range(-(-sk // FWD_KEYS))
            if vis[qb * FWD_ROWS:(qb + 1) * FWD_ROWS, kt * FWD_KEYS:(kt + 1) * FWD_KEYS].any()}
    assert len(loaded) == len(set(loaded))
    assert want <= set(loaded)
    if np.all(np.diff(kp) > 0):
        assert set(loaded) == want


def ring_completes(computes, stages: int) -> bool:
    """The K/V ring of one block run to its end: ``computes[wg][i]`` whether
    consumer warpgroup ``wg`` computes ring entry i (a loaded tile; the
    entry after the last is the end marker).  The producer posts entry j
    once both warpgroups released entry j - stages (the stage's previous
    use).  A warpgroup that computes entry i releases the entry whose P V
    it still held and holds i; one that skips entry i releases the held
    entry and i; at the end marker it releases the held entry.  False if
    the three wait on each other (a deadlock).  The kernel frees a stage's
    K half (and its positions) earlier, after the tile's softmax: this is
    its V half, which the K half never outlasts."""
    n = len(computes[0])
    posted, pos, held = 0, [0, 0], [None, None]
    released = [set(), set()]
    moved = True
    while moved:
        moved = False
        if posted <= n and (posted < stages or all(posted - stages in r for r in released)):
            posted += 1
            moved = True
        for wg in range(2):
            i = pos[wg]
            if i > n or i >= posted:
                continue
            if held[wg] is not None:  # its P V is done before the warpgroup goes on
                released[wg].add(held[wg])
                held[wg] = None
            if i < n and computes[wg][i]:
                held[wg] = i
            elif i < n:
                released[wg].add(i)
            pos[wg] += 1
            moved = True
    return pos == [n + 1, n + 1]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_ring_runs_to_its_end_at_every_stage_count(case):
    """Every block's ring at 2, 3 and 4 stages (fwd_stages gives 2 at
    128-key tiles of (128, 128) and (192, 128)): no warpgroup waits on a
    stage it holds, however many tiles it skips."""
    sq, sk, h, hkv, causal, window, qp, kp, vis = _case(case)
    loaded, computed = walk(sq, sk, h, causal, window, qp, kp)
    done = {(qb, head, kt, wg) for head, qb, wg, _, kt, _ in computed}
    for qb, head in {(qb, head) for qb, head, _ in loaded}:
        tiles = [kt for b_, h_, kt in loaded if (b_, h_) == (qb, head)]
        computes = [[(qb, head, kt, wg) in done for kt in tiles] for wg in range(2)]
        for stages in (2, 3, 4):
            assert ring_completes(computes, stages), (qb, head, stages)


def forward_mirror(q, k, v, qp, kp, causal, window, scale):
    """The kernel's arithmetic in f32 numpy, one batch element: q (Sq, H,
    hd), k (Sk, Hkv, hd), v (Sk, Hkv, hd_v) -> (o (Sq, H, hd_v), lse (H, Sq)).
    Each computed tile holds ``FWD_KEYS`` key columns, zeros past Sk (the
    tensor map's fill) whose scores are -inf; P goes into O unrounded (the
    kernel rounds it to bf16, which the card's tests hold to)."""
    sq, h, _ = q.shape
    sk, hkv, hd_v = v.shape
    g = h // hkv
    pad = -(-sk // FWD_KEYS) * FWD_KEYS - sk
    kz = np.concatenate([k, np.zeros((pad,) + k.shape[1:], np.float32)])
    vz = np.concatenate([v, np.zeros((pad,) + v.shape[1:], np.float32)])
    o = np.zeros((sq, h, hd_v), np.float32)
    lse = np.zeros((h, sq), np.float32)
    state = {}  # (head, qb, wg) -> [m, l, acc]
    _, computed = walk(sq, sk, h, causal, window, qp, kp)
    scale_log2 = np.float32(scale * LOG2E)
    for head, qb, wg, rows, kt, st in computed:
        m, l, acc = state.setdefault((head, qb, wg), [np.full(len(rows), MASKED),
                                                     np.zeros(len(rows), np.float32),
                                                     np.zeros((len(rows), hd_v), np.float32)])
        cols = np.arange(kt * FWD_KEYS, (kt + 1) * FWD_KEYS)
        s = (q[rows, head] @ kz[cols, head // g].T) * scale_log2
        if not (st == 2 and cols[-1] < sk):
            seen = np.zeros(s.shape, bool)
            live = cols < sk
            seen[:, live] = fa.visible(torch.from_numpy(qp[rows]), torch.from_numpy(kp[cols[live]]),
                                       causal, window).numpy()
            s = np.where(seen, s, MASKED)
            s[:, ~live] = -np.inf
        mx = np.maximum(m, s.max(1))
        corr = np.exp2(m - mx)
        p = np.exp2(s - mx[:, None])
        l[:] = l * corr + p.sum(1)
        acc[:] = acc * corr[:, None] + p @ vz[cols, head // g]
        m[:] = mx
    mean_v = v.mean(0)  # (Hkv, hd_v)
    for qb in range(-(-sq // FWD_ROWS)):
        for wg in range(FWD_ROWS // WG_ROWS):
            rows = np.arange(qb * FWD_ROWS + wg * WG_ROWS, min(sq, qb * FWD_ROWS + (wg + 1) * WG_ROWS))
            for head in range(h):
                if not len(rows):
                    continue
                m, l, acc = state.get((head, qb, wg), [np.full(len(rows), MASKED), None, None])
                blind = m == MASKED  # the row saw no key
                out = np.broadcast_to(mean_v[head // g], (len(rows), hd_v)).copy()
                if acc is not None:
                    out[~blind] = acc[~blind] / l[~blind, None]
                    lse[head, rows] = np.where(blind, MASKED, (m + np.log2(l)) * np.log(2.0))
                else:
                    lse[head, rows] = MASKED
                o[rows, head] = out
    return o, lse


def _inputs(seed, b, sq, sk, h, hkv, hd, hd_v):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd_v)).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_mirror_matches_the_plain_version(case):
    """The walk's online softmax (skipped tiles, masks, the blind rows' mean
    of V, the lse in base 2 turned natural) gives the plain version's o and
    lse, V narrower than Q and K (hd 32, hd_v 16)."""
    sq, sk, h, hkv, causal, window, qp, kp, vis = _case(case)
    q, k, v = _inputs(sq * 7 + sk, 1, sq, sk, h, hkv, 32, 16)
    o, lse = forward_mirror(q[0], k[0], v[0], qp, kp, causal, window, 32 ** -0.5)
    o_ref, lse_ref = fa.flash_attention_lse_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), q_positions=torch.from_numpy(qp),
        k_positions=torch.from_numpy(kp), causal=causal, window=window)
    np.testing.assert_allclose(o, o_ref[0].numpy(), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(lse, lse_ref[0].numpy(), atol=1e-4, rtol=1e-5)
    blind = ~vis.any(1)
    np.testing.assert_array_equal(lse[:, blind], MASKED)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in (
    "ragged_causal", "window", "chunk_after_prefix_windowed", "ragged_noncausal_mha",
    "rows_see_no_key", "end_of_cache_sq_ne_sk", "blind_block", "negative_positions_window")],
    ids=lambda c: c[0])
def test_mirror_matches_the_jax_layer(case):
    """The same inputs through the JAX package's ``layers.flash_attention``
    (f32, explicit positions) and through the mirror, as
    tests/test_torch_attention.py holds the plain version (atol 2e-3, rtol
    1e-2: summation order)."""
    sq, sk, h, hkv, causal, window, qp, kp, _ = _case(case)
    q, k, v = _inputs(sq + sk, 1, sq, sk, h, hkv, 16, 16)
    want = JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask=JL.MaskSpec(causal=causal, window=window),
                              q_positions=jnp.asarray(qp), k_positions=jnp.asarray(kp))
    o, _ = forward_mirror(q[0], k[0], v[0], qp, kp, causal, window, 16 ** -0.5)
    np.testing.assert_allclose(o, np.asarray(want)[0], atol=2e-3, rtol=1e-2)


def _constant(name: str, text: str = None) -> int:
    text = SOURCE.read_text() if text is None else text
    m = re.search(rf"constexpr (?:int|uint32_t) {name} = ([^;]+);", text)
    assert m, name
    return int(eval(m.group(1), {"kWgThreads": WG_THREADS}))


def test_constants_match_the_source():
    names = ("kWgmmaMaxHeadDim", "kWgmmaMaxHeadDimV", "kWgmmaMinQueries", "kFwdRows", "kFwdKeys",
             "kFwdStages", "kKeys", "kWgThreads", "kWgmmaThreads", "kProducerRegs",
             "kConsumerRegs", "kMaxSmemBytes")
    assert {n: _constant(n) for n in names} == dict(zip(names, (
        fa.WGMMA_MAX_HEAD_DIM, fa.WGMMA_MAX_HEAD_DIM_V, fa.WGMMA_MIN_QUERIES, FWD_ROWS,
        FWD_KEYS, FWD_STAGES, KEYS, WG_THREADS, THREADS, PRODUCER_REGS, CONSUMER_REGS,
        SMEM_PER_BLOCK)))
    assert fa.KV_TILE == KEYS and FWD_ROWS == 2 * WG_ROWS and THREADS == 3 * WG_THREADS
    assert fa.WGMMA_MIN_QUERIES == WG_ROWS  # a warpgroup's rows: fewer go to "mma"
    header = SOURCE.with_name("attention_tiles.cuh").read_text()
    assert _constant("kBoxRows", header) == WG_ROWS == KEYS  # Q's and K/V's TMA boxes


@pytest.mark.parametrize("hd,hd_v,want_stages", [(64, 64, 4), (128, 128, 2), (192, 128, 2)])
def test_shared_memory_and_registers_fit_one_block_per_sm(hd, hd_v, want_stages):
    """FwdSmem of each "wgmma" instance (HD, HDV): Q (128 rows at HD), the
    stages (K at HD, V at HDV, the tile's positions, full and empty mbarriers
    of K and of V, 32 bytes of info), Q's mbarrier, each consumer warpgroup's mean of V, 1 KB of
    alignment slack, at ``FWD_STAGES`` where that fits and one stage fewer
    at a time where not (fwd_stages<HD, HDV>): 4 stages at (64, 64), 2 at
    the others.  And the registers a consumer holds beside what setmaxnreg
    moves."""
    def smem(stages):
        return (FWD_ROWS * hd * 2 + stages * (FWD_KEYS * (hd + hd_v) * 2 + FWD_KEYS * 4 + 64) + 8
                + 2 * hd_v * 4 + 1024)

    stages = FWD_STAGES
    while smem(stages) > SMEM_PER_BLOCK:
        stages -= 1
    assert stages == want_stages and stages >= 2
    # O (64 x HDV f32), S (64 x FWD_KEYS f32) and P (bf16) per thread, with room left for
    # addresses, positions and the softmax state
    assert hd_v // 2 + FWD_KEYS // 2 + FWD_KEYS // 4 <= CONSUMER_REGS - 48
    at_launch = REGS_PER_SM // THREADS // 8 * 8  # what __launch_bounds__(384, 1) allows
    assert WG_THREADS * PRODUCER_REGS + 2 * WG_THREADS * CONSUMER_REGS <= THREADS * at_launch


@pytest.mark.parametrize("dtype,hd,hd_v,sq,h,hkv,variant,design", [
    (torch.bfloat16, 128, 128, 4096, 24, 2, "tile", "wgmma"),  # the training microbatch
    (torch.bfloat16, 192, 128, 4096, 16, 16, "tile", "wgmma"),  # MLA
    (torch.bfloat16, 160, 128, 300, 8, 2, "tile", "wgmma"),  # hd_v < hd inside (192, 128)
    (torch.bfloat16, 64, 64, 1500, 6, 6, "tile", "wgmma"),  # whisper's encoder
    (torch.bfloat16, 16, 16, 64, 2, 2, "tile", "wgmma"),
    (torch.bfloat16, 128, 128, 64, 4, 4, "tile", "wgmma"),  # one warpgroup's rows
    (torch.bfloat16, 128, 128, 63, 4, 1, "tile", "mma"),
    (torch.bfloat16, 128, 128, 8, 32, 4, "tile", "mma"),  # 8-token prompts at a GQA group of 8
    (torch.bfloat16, 256, 256, 4096, 8, 2, "tile", "mma"),
    (torch.bfloat16, 192, 192, 512, 4, 4, "tile", "mma"),  # hd_v above 128
    (torch.bfloat16, 128, 128, 1, 32, 4, "split", None),
    (torch.bfloat16, 8, 8, 4096, 4, 4, "general", None),
    (torch.float32, 128, 128, 4096, 4, 4, "general", None),
])
def test_design_rule_by_dtype_head_dims_and_sq(dtype, hd, hd_v, sq, h, hkv, variant, design):
    assert fa.choose_variant(dtype, sq, h, hkv, hd, hd_v=hd_v) == variant
    if design:
        assert fa.tile_design(dtype, hd, hd_v, sq) == design
    q = torch.zeros((1, sq, h, hd), dtype=dtype)
    k, v = torch.zeros((1, 8, hkv, hd), dtype=dtype), torch.zeros((1, 8, hkv, hd_v), dtype=dtype)
    before = (fa.flash_attention.launches, dict(fa.flash_attention.design_launches))
    with pytest.raises(ValueError, match="CUDA kernel"):  # a CPU tensor never reaches a kernel
        fa.flash_attention_variant("tile", q, k, v, design=design)
    assert (fa.flash_attention.launches, fa.flash_attention.design_launches) == before


def test_a_design_is_named_only_for_tile():
    x = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    for variant, design in (("split", "wgmma"), ("tile", "fast"), ("general", "mma")):
        with pytest.raises(ValueError, match="design"):
            fa.flash_attention_variant(variant, x, x, x, design=design)


def test_reset_launches_zeroes_every_count():
    fa.flash_attention.launches = 3
    fa.flash_attention.variant_launches["tile"] = 3
    fa.flash_attention.design_launches["wgmma"] = 2
    fa.flash_attention.design_launches["mma"] = 1
    fa.reset_launches()
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention.variant_launches == dict.fromkeys(fa.VARIANTS, 0)
    assert fa.flash_attention.design_launches == dict.fromkeys(fa.DESIGNS, 0)


def _script(name: str):
    path = SOURCE.parents[4] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


AB_VARIANTS = ("keys64", "pingpong")


@pytest.mark.parametrize("variant", AB_VARIANTS)
def test_ab_variants_patch_the_source(variant):
    """Each alternative schedule that ``scripts/attn_fwd_ab.py --variant``
    times is a set of text patches, every one of which still finds its one
    place in the source; the tree's source itself holds neither."""
    ab = _script("attn_fwd_ab")
    assert sorted(ab.VARIANTS) == sorted(AB_VARIANTS)
    text = SOURCE.read_text()
    out = ab.patched(text, variant)
    assert out != text
    if variant == "keys64":
        assert _constant("kFwdKeys", out) == 64 and "wgmma_ss_n64(s, " in out
    else:
        assert out.count("turn_wait(wg);") == 2 and out.count("turn_pass(wg);") == 3
        assert "turn_" not in text


def test_clock_probes_patch_the_source():
    """``scripts/attn_fwd_clocks.py``'s probes each find their one place."""
    clocks = _script("attn_fwd_clocks")
    out = clocks.instrumented(SOURCE.read_text())
    assert out.count("clock64()") >= 12
