"""The word-level arithmetic of the port's Hopper ``gf_matmul`` kernel, on the CPU.

``src/repro_torch/kernels/csrc/gf_matmul.cu`` multiplies a byte x by a
coefficient c as c*x = T0[x & 7] ^ T1[(x >> 3) & 7] ^ T2[x >> 6]: three split
product tables of 8, 8 and 4 bytes held in registers and looked up four
bytes at a time by PTX ``prmt``.  No CPU run can reach that code, so this
file mirrors its steps in numpy -- ``prmt`` in its default mode, the tables
of a coefficient as the kernel lays them out, the selector sequence (masks,
then ``mad.hi`` packing that leaves the bytes in the order 0, 2, 1, 3, put
back before the store), the 16-byte chunks with their masked tail, the
groups of K rows and the row tiles -- and holds the mirror to the JAX
package: exhaustively per (coefficient, byte) in every byte lane of a word,
and as a whole matmul against ``repro.kernels.gf_matmul.gf_matmul`` (Pallas,
interpret mode) and ``repro.core.gf.matmul_np``.  A test pins the mirror's
constants and steps to the source text.  GF(2^8) arithmetic is exact: every
comparison is exact equality.
"""
import pathlib
import re

import numpy as np
import pytest

from repro.core import gf as jgf
from repro.kernels import gf_matmul as jgk

SOURCE = (pathlib.Path(__file__).resolve().parents[1]
          / "src/repro_torch/kernels/csrc/gf_matmul.cu")

U32 = np.uint32
LOW3, LOW2 = U32(0x07070707), U32(0x03030303)  # kLow3, kLow2
SEL = ((1 << 20) + 1, (1 << 29) + (1 << 17), (1 << 26) + (1 << 14))  # kSel0, kSel1, kSel2
CHUNK = 16  # kChunk: bytes of each row a thread owns
GROUP = 4  # kGroup: rows of B per step of the K loop
ROW_TILES = (1, 2, 4, 6, 8)  # the output rows one block owns, as the launcher picks them
ORDER = 0x3120  # selectors put byte i's index in nibble (0, 2, 1, 3)[i]; this prmt undoes it


# -- the kernel's steps ---------------------------------------------------------------

def prmt(x, y, s):
    """PTX ``prmt.b32`` (``__byte_perm``) in its default mode: byte i of the
    result is byte (s >> 4i) & 7 of the 8-byte value {y, x}; bit 3 of that
    nibble replicates the selected byte's top bit instead."""
    x, y, s = (np.asarray(v, dtype=np.uint64) for v in (x, y, s))
    src = (y << np.uint64(32)) | x
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    for i in range(4):
        nib = (s >> np.uint64(4 * i)) & np.uint64(15)
        byte = (src >> (np.uint64(8) * (nib & np.uint64(7)))) & np.uint64(255)
        sign = np.where(byte & np.uint64(128), np.uint64(255), np.uint64(0))
        out |= np.where(nib & np.uint64(8), sign, byte) << np.uint64(8 * i)
    return out.astype(U32)


def mad_hi(x, y, z):
    """PTX ``mad.hi.u32``: the high word of x * y, plus z (mod 2^32)."""
    prod = np.asarray(x, np.uint64) * np.asarray(y, np.uint64)
    return ((prod >> np.uint64(32)) + np.asarray(z, np.uint64)).astype(U32)


def xtime(x):
    return ((x << 1) ^ ((x >> 7) * 0x1D)) & 0xFF


def span4(x, y):
    """Bytes {0, x, y, x ^ y}: c*v for v = 0..3 given x = c*1, y = c*2."""
    return (x << 8) | (y << 16) | ((x ^ y) << 24)


def split_tables(c):
    """The five table words of coefficient(s) c, as the kernel stores them:
    T0 lo / hi (c*v, v = 0..7), T1 lo / hi (c*(v << 3)), T2 (c*(v << 6), v = 0..3)."""
    p = [np.asarray(c, dtype=np.int64)]
    for _ in range(7):
        p.append(xtime(p[-1]))  # p[i] = c * 2^i
    lo0, lo1 = span4(p[0], p[1]), span4(p[3], p[4])
    words = (lo0, lo0 ^ (p[2] * 0x01010101), lo1, lo1 ^ (p[5] * 0x01010101), span4(p[6], p[7]))
    return tuple(w.astype(U32) for w in words)


def selectors(w):
    """The three prmt selectors of B word(s) w: byte i's 3-bit (3, 3, 2)
    index in nibble (0, 2, 1, 3)[i], packed as v + (v >> 12) by the high
    word of a product."""
    v0 = w & LOW3
    return (mad_hi(v0, SEL[0], v0), mad_hi(w & (LOW3 << U32(3)), SEL[1], 0),
            mad_hi(w & (LOW2 << U32(6)), SEL[2], 0))


def mul_words(tables, sels):
    """c * each byte of a word, in the selectors' byte order."""
    lo0, hi0, lo1, hi1, t2 = tables
    s0, s1, s2 = sels
    return prmt(lo0, hi0, s0) ^ prmt(lo1, hi1, s1) ^ prmt(t2, 0, s2)


def row_tile(m: int) -> int:
    return next(t for t in ROW_TILES if t >= min(m, ROW_TILES[-1]))


def mirror_gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """C = A (x) B as the kernel computes it: B in 16-byte chunks of
    little-endian words (bytes past N read as zero, outputs past N never
    stored), output rows in tiles whose rows past M get all-zero tables, K
    in groups of ``GROUP`` rows whose rows past K get all-zero tables, the
    accumulators put back in byte order before the store."""
    m, k = a.shape
    n = b.shape[1]
    chunks = -(-n // CHUNK)
    kpad = -(-k // GROUP) * GROUP
    padded = np.zeros((kpad, chunks * CHUNK), np.uint8)
    padded[:k, :n] = b
    words = padded.view("<u4").astype(U32)  # (kpad, chunks * 4)
    rt = row_tile(m)
    out = np.zeros((m, chunks * CHUNK), np.uint8)
    for row0 in range(0, m, rt):
        coeffs = np.zeros((rt, kpad), np.int64)
        coeffs[: min(rt, m - row0), :k] = a[row0 : row0 + rt]
        tables = split_tables(coeffs)  # each (rt, kpad)
        acc = np.zeros((rt, words.shape[1]), U32)
        for j0 in range(0, kpad, GROUP):
            for j in range(j0, j0 + GROUP):
                sels = selectors(words[j])
                for r in range(rt):
                    acc[r] ^= mul_words(tuple(t[r, j] for t in tables), sels)
        for r in range(min(rt, m - row0)):
            out[row0 + r] = prmt(acc[r], 0, ORDER).astype("<u4").view(np.uint8)
    return out[:, :n]


# -- the mirror pinned to the source ------------------------------------------------------

def test_mirror_constants_are_the_kernels():
    src = SOURCE.read_text()
    for pattern in (r"kChunk = 16;", r"kGroup = 4;", r"kLow3 = 0x07070707u;",
                    r"kLow2 = 0x03030303u;", r"kSel0 = \(1u << 20\) \+ 1u;",
                    r"kSel1 = \(1u << 29\) \+ \(1u << 17\);",
                    r"kSel2 = \(1u << 26\) \+ \(1u << 14\);",
                    r"mad_hi\(v0, kSel0, v0\)", r"v0 = w\[q\] & kLow3;",
                    r"mad_hi\(w\[q\] & \(kLow3 << 3\), kSel1, 0u\)",
                    r"mad_hi\(w\[q\] & \(kLow2 << 6\), kSel2, 0u\)",
                    r"prmt\(t\.x, t\.y, s\[0\]\), prmt\(t\.z, t\.w, s\[1\]\), prmt\(u, 0u, s\[2\]\)",
                    r"__byte_perm\(acc\[r\]\[q\], 0, 0x3120\)",
                    r"lo0 = span4\(p\[0\], p\[1\]\), lo1 = span4\(p\[3\], p\[4\]\);",
                    r"lo0 \^ \(p\[2\] \* 0x01010101u\)", r"lo1 \^ \(p\[5\] \* 0x01010101u\)",
                    r"t2\[e\] = span4\(p\[6\], p\[7\]\);",
                    r'asm\("prmt\.b32 %0, %1, %2, %3;"', r'asm\("mad\.hi\.u32 %0, %1, %2, %3;"'):
        assert re.search(pattern, src), pattern
    picks = [int(t) for t in re.findall(r"launch_rows<(\d+), V>", src)]
    assert tuple(sorted(set(picks))) == ROW_TILES


# -- prmt, tables, selectors --------------------------------------------------------------

def test_prmt_default_mode():
    x, y = U32(0x33221100), U32(0x77665544)
    assert prmt(x, y, 0x3210) == x and prmt(x, y, 0x7654) == y
    assert prmt(x, y, 0x0123) == U32(0x00112233)
    assert prmt(x, y, 0x3120) == U32(0x33112200)
    assert prmt(U32(0x00008000), 0, 0x0009) == U32(0x000000FF)  # bit 3: replicate the top bit
    assert prmt(x, y, 0xFFFF3210) == x  # only the low 16 bits are read


def test_split_tables_hold_the_products():
    c = np.arange(256)
    table = jgf.mul(c[:, None].astype(np.uint8), np.arange(256, dtype=np.uint8)[None, :])
    lo0, hi0, lo1, hi1, t2 = split_tables(c)

    def bytes_of(*ws):
        return np.stack([(w >> U32(8 * i)) & U32(255) for w in ws for i in range(4)], axis=1)

    np.testing.assert_array_equal(bytes_of(lo0, hi0), table[:, 0:8])
    np.testing.assert_array_equal(bytes_of(lo1, hi1), table[:, 0:64:8])
    np.testing.assert_array_equal(bytes_of(t2), table[:, 0:256:64])


@pytest.mark.parametrize("lane", range(4))
def test_every_coefficient_and_byte_in_every_lane(lane):
    """All 256 x 256 (coefficient, byte) pairs, the byte in lane ``lane`` of
    the word and the other lanes filled with noise."""
    c = np.repeat(np.arange(256), 256)
    x = np.tile(np.arange(256), 256).astype(U32)
    noise = np.random.default_rng(lane).integers(0, 2**32, x.size, dtype=np.uint64).astype(U32)
    keep = U32(~(0xFF << (8 * lane)) & 0xFFFFFFFF)
    w = (noise & keep) | (x << U32(8 * lane))
    got = prmt(mul_words(split_tables(c), selectors(w)), 0, ORDER)
    want = jgf.mul(c.astype(np.uint8), x.astype(np.uint8))
    np.testing.assert_array_equal((got >> U32(8 * lane)) & U32(255), want)
    other = (jgf.mul(c[:, None].astype(np.uint8),
                     ((noise[:, None] >> U32([0, 8, 16, 24])) & U32(255)).astype(np.uint8)))
    for i in set(range(4)) - {lane}:  # the other lanes carry their own products
        np.testing.assert_array_equal((got >> U32(8 * i)) & U32(255), other[:, i])


def test_selector_nibbles_stay_in_the_default_mode():
    """Bit 3 of every selector nibble is clear, so no lookup turns into a
    sign replication and the kernel's prmt needs no mask; nibble i holds the
    index of byte (0, 2, 1, 3)[i]."""
    w = np.random.default_rng(7).integers(0, 2**32, 100_000, dtype=np.uint64).astype(U32)
    for s, (shift, mask) in zip(selectors(w), ((0, 7), (3, 7), (6, 3))):
        for i, byte in enumerate((0, 2, 1, 3)):
            nib = (s >> U32(4 * i)) & U32(15)
            np.testing.assert_array_equal(nib, (w >> U32(8 * byte + shift)) & U32(mask))


def test_mad_hi_packing_never_carries():
    """For every value a split's mask lets through, the high word of its
    product is exactly the shifted sum the packing needs: the low word never
    carries into it."""
    for mask, sel in zip((LOW3, LOW3 << U32(3), LOW2 << U32(6)), SEL):
        bits = [b for b in range(32) if int(mask) >> b & 1]
        v = np.zeros(1 << len(bits), np.uint64)  # every masked value
        for i, b in enumerate(bits):
            v |= ((np.arange(v.size, dtype=np.uint64) >> np.uint64(i)) & np.uint64(1)) << np.uint64(b)
        hi = (v * np.uint64(sel)) >> np.uint64(32)
        shift = {SEL[0]: 0, SEL[1]: 3, SEL[2]: 6}[sel]
        np.testing.assert_array_equal(hi, (v >> np.uint64(shift + 12)) if sel == SEL[0] else
                                      (v >> np.uint64(shift)) + (v >> np.uint64(shift + 12)))


# -- the mirror against the JAX package ----------------------------------------------------

_WIDE_N = (1, 15, 16, 17, 4100, 4104, 4856)  # n < 16, n = 4 / 8 (mod 16), odd, a Clay w


@pytest.fixture(scope="module")
def pallas_6x12():
    """Pallas (interpret mode) products at the Clay (10,6) coefficient shape:
    one compile, every width a slice of one wide B (a product's columns
    depend only on the same columns of B)."""
    rng = np.random.default_rng(612)
    b = rng.integers(0, 256, (12, sum(_WIDE_N)), dtype=np.uint8)
    a = rng.integers(0, 256, (6, 12), dtype=np.uint8)
    a[3] = 0  # an all-zero coefficient row
    return a, b, np.asarray(jgk.gf_matmul(a, b, interpret=True))


@pytest.mark.parametrize("n", _WIDE_N)
def test_mirror_matches_pallas_and_numpy_6x12(pallas_6x12, n):
    a, b_all, c_all = pallas_6x12
    lo = sum(_WIDE_N[: _WIDE_N.index(n)])
    b = np.ascontiguousarray(b_all[:, lo : lo + n])
    out = mirror_gf_matmul(a, b)
    np.testing.assert_array_equal(out, c_all[:, lo : lo + n])
    np.testing.assert_array_equal(out, jgf.matmul_np(a, b))


@pytest.mark.parametrize("m,k,n", [(4, 4, 300), (1, 4, 257), (1, 1, 33), (32, 32, 300)])
def test_mirror_matches_pallas_and_numpy(m, k, n):
    rng = np.random.default_rng(m * 100_000 + k * 10_000 + n)
    a = rng.integers(0, 256, (m, k), dtype=np.uint8)
    b = rng.integers(0, 256, (k, n), dtype=np.uint8)
    out = mirror_gf_matmul(a, b)
    np.testing.assert_array_equal(out, np.asarray(jgk.gf_matmul(a, b, interpret=True)))
    np.testing.assert_array_equal(out, jgf.matmul_np(a, b))


@pytest.mark.parametrize("m", [3, 5, 7, 9, 17])
def test_mirror_row_tiles_and_k_groups_match_numpy(m):
    """Partial row tiles (zero tables past M) and a partial last group of K."""
    rng = np.random.default_rng(m)
    a = rng.integers(0, 256, (m, 25), dtype=np.uint8)
    b = rng.integers(0, 256, (25, 77), dtype=np.uint8)
    np.testing.assert_array_equal(mirror_gf_matmul(a, b), jgf.matmul_np(a, b))
