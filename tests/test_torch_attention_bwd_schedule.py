"""The tile walk of the port's Hopper backward kernels ("wgmma" design), on the CPU.

``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` runs only on the
card, so this file mirrors in Python how its kernels share out the work and
holds the mirror to ``kernels/flash_attention.py::visible``:

* the pass before the products gives each 64-query tile its position range
  and whether a row of it sees no key, each 64-key tile its position range;
* a dK/dV block owns 128 keys of one (batch, kv head): its producer keeps a
  (64-query tile, head) pair when some pair of the block is visible or a row
  of the tile sees no key, and each of its two consumer warpgroups (64 keys)
  computes a kept pair unless its own keys are all hidden and no row is blind;
* a dQ block owns 128 queries of one head: its producer keeps a 64-key tile
  when some pair of the block sees it, each warpgroup (64 rows) computes it
  unless its own rows see none of it.

Within a computed tile the kernels mask pair by pair (``visible``), so the
walk must reach every visible pair once, reach every key for a row that sees
no key (its weights 1/Sk go to every key's dV), and skip every tile whose
pairs are all hidden.  The cases are those of
``tests/test_torch_attention_bwd.py`` and larger ones that span several
blocks.  A test pins the mirror's constants to the source text, and the
wrapper's dispatch by dtype and head dim is checked without a card.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops

SOURCE = (pathlib.Path(__file__).resolve().parents[1]
          / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu")

ROW_TILE = 64  # kRowTile: queries per tile of the statistics and of the dK/dV walk
KEY_TILE = 64  # kKeyTile: keys per consumer warpgroup of dK/dV and per dQ stage
DKDV_KEYS = 128  # kDkdvKeys
DQ_ROWS = 128  # kDqRows
DKDV_STAGES, DQ_STAGES = 3, 4  # kDkdvStages, kDqStages (fewer where 4 do not fit)
WG_THREADS, THREADS = 128, 384  # kWgThreads, kWgmmaThreads
PRODUCER_REGS, CONSUMER_REGS = 24, 240  # kProducerRegs, kConsumerRegs
STAT_WORDS = 3 * ROW_TILE  # kStatWords: a query tile's lse in base 2, D and positions
SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block may use on an H100
REGS_PER_SM = 65_536

# (name, sq, sk, h, hkv, causal, window, q_positions, k_positions); None: arange
CPU_CASES = [  # tests/test_torch_attention_bwd.py's cases
    ("causal_gqa", 37, 37, 8, 2, True, 0, None, None),
    ("window", 50, 50, 4, 2, True, 7, None, None),
    ("mha_noncausal_sq_ne_sk", 19, 45, 4, 4, False, 0, None, None),
    ("g1_causal", 33, 33, 3, 3, True, 0, None, None),
    ("explicit_positions", 16, 46, 6, 2, True, 0, np.arange(30, 46), np.arange(46)),
    ("rows_see_no_key", 16, 24, 4, 2, True, 0, np.arange(-5, 11), np.arange(24)),
    ("window_positions_ragged", 21, 70, 12, 4, True, 9, np.arange(49, 70), np.arange(70)),
]
WIDE_CASES = [  # several blocks each way, ragged edges
    ("causal_600", 600, 600, 12, 2, True, 0, None, None),
    ("window_crossing_tiles", 520, 520, 4, 2, True, 150, None, None),
    ("end_of_cache_sq_ne_sk", 100, 333, 8, 2, True, 0, np.arange(233, 333), np.arange(333)),
    ("noncausal_sk_ragged", 150, 333, 6, 2, False, 0, None, None),
    ("blind_rows_span_tiles", 300, 450, 4, 2, True, 0, np.arange(-100, 200), np.arange(450)),
    ("ring_buffer_window", 200, 256, 4, 1, True, 64, np.arange(300, 500),
     (np.arange(256) + 400) % 512),
]
CASES = CPU_CASES + WIDE_CASES


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


def prep(qp, kp, vis):
    """attn_bwd_prep_kernel: (qmin, qmax, blind) per 64-query tile (the kernel
    writes it per batch and head: positions and blindness are the same for
    all), (kmin, kmax) per 64-key tile."""
    sq, sk = len(qp), len(kp)
    blind_rows = ~vis.any(1)  # the forward's lse = -1e30
    tinfo = [(qp[t:t + ROW_TILE].min(), qp[t:t + ROW_TILE].max(),
              bool(blind_rows[t:t + ROW_TILE].any())) for t in range(0, sq, ROW_TILE)]
    kinfo = [(kp[t:t + KEY_TILE].min(), kp[t:t + KEY_TILE].max()) for t in range(0, sk, KEY_TILE)]
    return tinfo, kinfo


def dkdv_walk(sq, sk, h, hkv, causal, window, qp, kp, vis):
    """The dK/dV kernel: for each (block, head, query tile, warpgroup) it
    computes, the pairs (query, key) whose P it adds (visible, or a row that
    sees no key); and the (block, head, query tile) pairs its producer loads."""
    g = h // hkv
    tinfo, kinfo = prep(qp, kp, vis)
    nqt = len(tinfo)
    computed, loaded = [], []
    for kb in range(-(-sk // DKDV_KEYS)):
        tiles = range(kb * DKDV_KEYS // KEY_TILE, min(len(kinfo), (kb + 1) * DKDV_KEYS // KEY_TILE))
        kmin, kmax = min(kinfo[t][0] for t in tiles), max(kinfo[t][1] for t in tiles)
        for kvh in range(hkv):
            for c in range(nqt * g):  # the producer's candidates, 32 at a time in the kernel
                qt, head = c // g, kvh * g + c % g
                qmin, qmax, blind = tinfo[qt]
                if not (blind or tile_state(kmin, kmax, qmin, qmax, causal, window)):
                    continue
                loaded.append((kb, head, qt))
                for wg in range(DKDV_KEYS // KEY_TILE):
                    key0 = kb * DKDV_KEYS + wg * KEY_TILE
                    if key0 >= sk:
                        continue
                    state = tile_state(*kinfo[key0 // KEY_TILE], qmin, qmax, causal, window)
                    if state == 0 and not blind:
                        continue
                    rows = np.arange(qt * ROW_TILE, min(sq, (qt + 1) * ROW_TILE))
                    keys = np.arange(key0, min(sk, key0 + KEY_TILE))
                    sub = vis[np.ix_(rows, keys)]
                    assert state != 2 or sub.all()  # state 2 skips the pair masks
                    reach = sub | ~vis[rows].any(1)[:, None]
                    computed.append((head, rows, keys, reach))
    return computed, loaded


def dq_walk(sq, sk, h, hkv, causal, window, qp, kp, vis):
    """The dQ kernel: for each (block, head, key tile, warpgroup) it computes,
    the pairs whose dS it adds (visible; a row that sees no key adds none)."""
    g = h // hkv
    tinfo, kinfo = prep(qp, kp, vis)
    computed, loaded = [], []
    for qb in range(-(-sq // DQ_ROWS)):
        tiles = range(qb * DQ_ROWS // ROW_TILE, min(len(tinfo), (qb + 1) * DQ_ROWS // ROW_TILE))
        qmin, qmax = min(tinfo[t][0] for t in tiles), max(tinfo[t][1] for t in tiles)
        for head in range(h):
            for kt, (kmin, kmax) in enumerate(kinfo):
                if not tile_state(kmin, kmax, qmin, qmax, causal, window):
                    continue
                loaded.append((qb, head // g, head, kt))
                for qt in tiles:
                    state = tile_state(kmin, kmax, *tinfo[qt][:2], causal, window)
                    if state == 0:
                        continue
                    rows = np.arange(qt * ROW_TILE, min(sq, (qt + 1) * ROW_TILE))
                    keys = np.arange(kt * KEY_TILE, min(sk, (kt + 1) * KEY_TILE))
                    sub = vis[np.ix_(rows, keys)]
                    assert state != 2 or sub.all()
                    computed.append((head, rows, keys, sub & vis[rows].any(1)[:, None]))
    return computed, loaded


def _cover(computed, h, sq, sk):
    count = np.zeros((h, sq, sk), np.int64)
    for head, rows, keys, reach in computed:
        count[head][np.ix_(rows, keys)] += reach
    return count


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_dkdv_walk_reaches_every_visible_pair_once(case):
    sq, sk, h, hkv, causal, window, qp, kp, vis = _case(case)
    computed, _ = dkdv_walk(sq, sk, h, hkv, causal, window, qp, kp, vis)
    want = vis | ~vis.any(1)[:, None]  # a row that sees no key reaches every key (P = 1/Sk)
    np.testing.assert_array_equal(_cover(computed, h, sq, sk), np.broadcast_to(want, (h, sq, sk)))


def _assert_walk(loaded: set, want: set, kp) -> None:
    """Every tile that holds a visible pair (or, for dK/dV, a row that sees no
    key) is loaded; with key positions in order, no other tile.  The walk
    judges a tile by the range of its positions, so keys out of order (a ring
    buffer) can keep a tile whose pairs are all hidden: masked pair by pair."""
    assert want <= loaded
    if np.all(np.diff(kp) > 0):
        assert loaded == want


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_dkdv_walk_visits_every_blind_tile_and_no_hidden_one(case):
    sq, sk, h, hkv, causal, window, qp, kp, vis = _case(case)
    _, loaded = dkdv_walk(sq, sk, h, hkv, causal, window, qp, kp, vis)
    blind = ~vis.any(1)
    want = set()
    for kb in range(-(-sk // DKDV_KEYS)):
        keys = slice(kb * DKDV_KEYS, (kb + 1) * DKDV_KEYS)
        for head in range(h):
            for qt in range(-(-sq // ROW_TILE)):
                rows = slice(qt * ROW_TILE, (qt + 1) * ROW_TILE)
                if blind[rows].any() or vis[rows, keys].any():
                    want.add((kb, head, qt))
    assert len(loaded) == len(set(loaded))  # each pair loaded once
    _assert_walk(set(loaded), want, kp)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_dq_walk_reaches_every_visible_pair_once(case):
    sq, sk, h, hkv, causal, window, qp, kp, vis = _case(case)
    computed, _ = dq_walk(sq, sk, h, hkv, causal, window, qp, kp, vis)
    np.testing.assert_array_equal(_cover(computed, h, sq, sk), np.broadcast_to(vis, (h, sq, sk)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_dq_walk_loads_no_hidden_key_tile(case):
    sq, sk, h, hkv, causal, window, qp, kp, vis = _case(case)
    _, loaded = dq_walk(sq, sk, h, hkv, causal, window, qp, kp, vis)
    want = {(qb, head // (h // hkv), head, kt)
            for qb in range(-(-sq // DQ_ROWS)) for head in range(h)
            for kt in range(-(-sk // KEY_TILE))
            if vis[qb * DQ_ROWS:(qb + 1) * DQ_ROWS, kt * KEY_TILE:(kt + 1) * KEY_TILE].any()}
    assert len(loaded) == len(set(loaded))
    _assert_walk(set(loaded), want, kp)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr (?:int|uint32_t) {name} = ([^;]+);", SOURCE.read_text())
    assert m, name
    return int(eval(m.group(1), {"kWgThreads": WG_THREADS, "kRowTile": ROW_TILE}))


def test_constants_match_the_source():
    assert {n: _constant(n) for n in (
        "kRowTile", "kKeyTile", "kDkdvKeys", "kDqRows", "kDkdvStages", "kDqStages",
        "kWgThreads", "kWgmmaThreads", "kProducerRegs", "kConsumerRegs", "kStatWords",
        "kWgmmaMaxHeadDim", "kWgmmaMaxHeadDimV", "kMaxSmemBytes")} == {
        "kRowTile": ROW_TILE, "kKeyTile": KEY_TILE, "kDkdvKeys": DKDV_KEYS, "kDqRows": DQ_ROWS,
        "kDkdvStages": DKDV_STAGES, "kDqStages": DQ_STAGES, "kWgThreads": WG_THREADS,
        "kWgmmaThreads": THREADS, "kProducerRegs": PRODUCER_REGS,
        "kConsumerRegs": CONSUMER_REGS, "kStatWords": STAT_WORDS,
        "kWgmmaMaxHeadDim": fab.WGMMA_MAX_HEAD_DIM,
        "kWgmmaMaxHeadDimV": fab.WGMMA_MAX_HEAD_DIM_V, "kMaxSmemBytes": SMEM_PER_BLOCK}
    # two consumer warpgroups of 64 rows each, the M of a wgmma
    assert DKDV_KEYS == 2 * KEY_TILE and DQ_ROWS == 2 * ROW_TILE and THREADS == 3 * WG_THREADS


@pytest.mark.parametrize("hd,hd_v,dq_stages", [(64, 64, 4), (128, 128, 4), (192, 128, 3)])
def test_shared_memory_and_registers_fit_one_block_per_sm(hd, hd_v, dq_stages):
    """The layouts of DkdvSmem and DqSmem of each "wgmma" instance (HD, HDV)
    (tiles of Q and K at HD, of V and dO at HDV, stages, statistics or key
    positions, mbarriers, stage info, 1 KB of alignment slack; the dQ ring
    at ``DQ_STAGES`` where that fits and one stage fewer at a time where not,
    as dq_stages<HD, HDV> rules) and the registers that setmaxnreg moves
    between the warpgroups."""
    def tile(rows, width):
        return rows * width * 2

    dkdv = (tile(DKDV_KEYS, hd) + tile(DKDV_KEYS, hd_v)
            + DKDV_STAGES * (tile(ROW_TILE, hd) + tile(ROW_TILE, hd_v) + STAT_WORDS * 4)
            + 8 * (2 * DKDV_STAGES + 1) + 32 * DKDV_STAGES + 1024)

    def dq(stages):
        return (tile(DQ_ROWS, hd) + tile(DQ_ROWS, hd_v)
                + stages * (tile(KEY_TILE, hd) + tile(KEY_TILE, hd_v) + KEY_TILE * 4)
                + 8 * (2 * stages + 1) + 32 * stages + 1024)

    assert dkdv <= SMEM_PER_BLOCK and dq(dq_stages) <= SMEM_PER_BLOCK
    assert dq_stages == DQ_STAGES or dq(dq_stages + 1) > SMEM_PER_BLOCK
    # the accumulators, S^T and dP^T of a dK/dV consumer: over 192 registers (kSerialPairs)
    # the pair's schedule holds P in bf16 and dP^T by halves instead
    serial = hd // 2 + hd_v // 2 + 64 > CONSUMER_REGS - 48
    assert serial == (hd + hd_v > 256)
    at_launch = REGS_PER_SM // THREADS // 8 * 8  # what __launch_bounds__(384, 1) allows
    assert PRODUCER_REGS % 8 == 0 == CONSUMER_REGS % 8 and 24 <= PRODUCER_REGS < CONSUMER_REGS <= 256
    assert WG_THREADS * PRODUCER_REGS + 2 * WG_THREADS * CONSUMER_REGS <= THREADS * at_launch


@pytest.mark.parametrize("dtype,hd,takes,design", [  # hd_v = hd
    (torch.bfloat16, 16, True, "wgmma"), (torch.bfloat16, 64, True, "wgmma"),
    (torch.bfloat16, 80, True, "wgmma"), (torch.bfloat16, 128, True, "wgmma"),
    (torch.bfloat16, 144, True, "mma"), (torch.bfloat16, 256, True, "mma"),
    (torch.bfloat16, 8, False, None), (torch.bfloat16, 72, False, None),
    (torch.float32, 64, False, None), (torch.float32, 128, False, None),
])
def test_wrapper_dispatch_by_dtype_and_head_dim(dtype, hd, takes, design):
    assert fab.kernel_takes(dtype, hd) is takes
    if takes:
        assert fab.design(hd) == design
    x = torch.zeros((1, 8, 2, hd), dtype=dtype)
    lse = torch.zeros((1, 2, 8))
    before = (fab.flash_attention_bwd.launches, dict(fab.flash_attention_bwd.design_launches))
    with pytest.raises(ValueError, match="CUDA kernel"):  # a CPU tensor never reaches a kernel
        fab.flash_attention_bwd(x, x, x, x, x, lse)
    leaf = x.clone().requires_grad_(True)  # the CPU path: the plain versions, no launch
    ops.flash_attention(leaf, x, x).sum().backward()
    assert leaf.grad.shape == x.shape
    assert (fab.flash_attention_bwd.launches, fab.flash_attention_bwd.design_launches) == before


def test_reset_launches_zeroes_every_count():
    fab.flash_attention_bwd.launches = 3
    fab.flash_attention_bwd.design_launches["wgmma"] = 2
    fab.reset_launches()
    assert fab.flash_attention_bwd.launches == 0
    assert fab.flash_attention_bwd.design_launches == dict.fromkeys(fab.DESIGNS, 0)
