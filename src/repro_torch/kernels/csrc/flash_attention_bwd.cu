// The gradient of fused attention on Hopper: dQ, dK, dV from q, k, v, the
// forward's output o, the output gradient dO and the forward's row
// log-sum-exp lse, with the forward's visibility rule (explicit positions,
// causal, sliding window, scale; a hidden score is -1e30) and GQA.  q, k, dq
// and dk have head dim hd; v, o, dO and dv head dim hd_v <= hd (MLA: 192 and
// 128), each read and written at its own width:
//
//   P[i, j]  = exp(s[i, j] - lse[i])  if visible(i, j), else 0
//   dP       = dO V^T,   D[i] = sum_d dO[i, d] O[i, d]
//   dS[i, j] = P[i, j] (dP[i, j] - D[i])
//   dV = P^T dO,   dK = scale dS^T Q,   dQ = scale dS K
//
// dK and dV of kv head j sum over its g query heads.  A row that sees no key
// (lse = -1e30, see flash_attention.cu) has the weights 1/Sk over every key
// and no score gradient, as the JAX package's masked softmax gives it.
//
// Replaces no Pallas kernel: the JAX package differentiates its pure-JAX
// chunked attention (repro/models/layers.py::flash_attention) with XLA's
// autodiff, recomputing each score block (jax.checkpoint).  Here the forward
// is the hand-written "tile" kernel of flash_attention.cu, so its gradient is
// hand-written too: kernels/ops.py's autograd function calls it.
//
// Bound by operations.  A fused kernel needs five products per visible
// (query, key) pair and query head, S, dK and dQ of 2 * hd flops, dP and dV
// of 2 * hd_v (S and dP again, dV, dK, dQ); this design does seven (the dQ
// kernel computes S and dP once more), the price of writing dQ once, by its
// owner, with no atomics: the result is the same bits on every run, as the
// reference's.  At the training shape (B 4, Sq = Sk 4096, H 24, Hkv 2, hd
// 128, causal) the seven-product bound is 1.46 ms at the bf16 tensor-core
// peak (five products: 1.04 ms); at MLA's (B 1, 4096, H 16, hd 192, hd_v
// 128) the five-product bound is 0.26 ms.
//
// Head dims up to kWgmmaMaxHeadDim (192) with hd_v up to kWgmmaMaxHeadDimV
// (128) -- every configuration of the repo -- take the "wgmma" design,
// instances (HD, HDV) of (64, 64), (128, 128) and (192, 128) that take any
// runtime (hd, hd_v) up to them (zeros past the widths), three kernels:
//
//  * attn_bwd_prep_kernel: one block per (batch, head, 64-query tile): D by
//    16-byte loads (8 bf16 a lane, hd_v / 8 lanes a row, several rows a warp),
//    and the tile's statistics block {lse in base 2 (-inf: a row that sees
//    no key, +inf: past Sq), D, positions} of 768 contiguous bytes, its
//    positions' range and whether a row of it sees no key; extra blocks give
//    each 64-key tile's positions (256 bytes) and their range.
//  * attn_bwd_dkdv_wgmma_kernel: one block per (128-key tile, kv head,
//    batch), three warpgroups.  K and V stay in shared memory; the producer
//    warp walks the (64-query tile, head) pairs of the g heads, 32 at a time
//    (one coalesced load of their ranges, a ballot), keeps the live ones --
//    some pair visible, or a row that sees no key -- and loads each pair's Q
//    and dO tiles (TMA boxes of 64 rows x 64 columns on the natural (b, s, h,
//    width) layout, each tensor at its own width: q and k at 192 as three
//    boxes, v and dO at 128 as two; 128-byte swizzle, zeros past Sq and the
//    width) and its statistics (a bulk copy) into a ring of kDkdvStages stages with
//    full and empty mbarriers.  Each consumer warpgroup owns 64 keys (the M
//    of wgmma): S^T = K Q^T and dP^T = V dO^T with both operands in shared
//    memory, P and dS formed in registers and rounded to bf16, then used as
//    the A operand from registers for dV += P^T dO and dK += dS^T Q, with B
//    the dO or Q tile read through the descriptor's transpose bit.  A
//    warpgroup skips a pair its own keys cannot see; a pair all of whose
//    keys see all its rows (most of a causal walk) takes P and dS without
//    masks, the rest are masked pair by pair from the positions in shared
//    memory.
//  * attn_bwd_dq_wgmma_kernel: the mirror image, one block per (128-query
//    tile, head, batch): Q and dO stay, the producer streams the live 64-key
//    tiles of K and V (and their positions) through dq_stages<HD, HDV>()
//    stages (kDqStages, 3 at (192, 128) where 4 would not fit), each
//    warpgroup owns 64 rows: S = Q K^T, dP = dO V^T, dQ += dS K.
//
// The tensor maps are encoded on each call (attention_tiles.cuh::encode_rows)
// and passed as __grid_constant__ parameters.
//
// Tiles, stages and registers: the dK/dV accumulators (64 keys x HD and 64 x
// HDV, f32) take (HD + HDV) / 2 registers a thread, S^T and dP^T 32 each; at
// (128, 128) that is 192 of the 240 that setmaxnreg hands each consumer
// thread (the producer warpgroup drops to 24; 384 threads x 168 at launch),
// so a 128-key block runs two consumer warpgroups and no more.  At (192, 128)
// it would be 224: there the pair's schedule never holds S^T and dP^T at once
// (kSerialPairs): S^T, P rounded to bf16 (16 registers), dV += P^T dO issued,
// then by halves of 32 queries dP^T = V dO^T (16 registers), dS from the bf16
// P, dK += dS^T Q -- a peak of 96 + 64 + 16 + 16 + 8 = 200, the same five
// products a pair.  ptxas (sm_90a, CUDA 12 on the H100 machine): a dP^T of
// 64 x 64 at once (208) spilled 16 bytes, the halves with P, the first dS
// half, 1/Sk and the two key indices held past their use 8; as written, 0.  Shared memory
// at (128, 128): K and V 64 KB, 3 stages of Q and dO (32 KB each) and
// statistics: 163 KB, one block per SM; the dQ block keeps Q and dO (64 KB)
// and 4 stages of K and V (32 KB each): 194 KB.  At (192, 128): K 48 + V 32
// KB + 3 x (Q 24 + dO 16 KB) and statistics: 203 KB; dQ: Q 48 + dO 32 KB + 3
// x (K 24 + V 16 KB): 201 KB.  No "wgmma" kernel may spill (chip_smoke.py
// checks ptxas).
//
// Waves at the training shape on 132 SMs: dK/dV 256 blocks (32 key tiles x
// 2 kv heads x 4), one per SM, 1.94 waves; under the causal mask key tile t
// sees (Sq - 128 t) g rows, so the 1-D grid runs every batch and head's tile
// 0 first, then tile 1, ...: longest first, the short tiles fill the tail.
// dQ 3,072 blocks (32 row tiles x 24 heads x 4), 23.3 waves, the latest
// queries (most keys) first.
//
// What no "wgmma" instance holds -- hd above 192, or hd_v above 128 (hd 256,
// or hd_v = hd above 128: test shapes only) -- takes the first, "mma" design:
// mma.sync.m16n8k16 fed by ldmatrix from tiles staged by cp.async in one
// stage, 64 (query, head) rows per tile, V and dO at hd_v zero-filled to the
// <256> tiles.  The launcher picks the design by (hd, hd_v)
// (flash_attention_bwd_design); the delta pass is attn_bwd_prep_kernel's.
//
// Takes bf16 with hd and hd_v multiples of 16, 16 <= hd_v <= hd <= 256,
// 16-byte aligned tensors; the wrapper raises on anything else.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "attention_tiles.cuh"

namespace {

constexpr int kWgmmaMaxHeadDim = 192;   // up to here (and hd_v up to the next) "wgmma", else "mma"
constexpr int kWgmmaMaxHeadDimV = 128;
constexpr int kRowTile = 64;           // queries per tile of the statistics and wgmma kernels
constexpr int kKeyTile = 64;           // keys per wgmma warpgroup and per dQ stage
constexpr int kDkdvKeys = 128;         // keys per dK/dV block: two consumer warpgroups
constexpr int kDqRows = 128;           // queries per dQ block: two consumer warpgroups
constexpr int kDkdvStages = 3;         // ring of Q / dO tiles
constexpr int kDqStages = 4;           // ring of K / V tiles, where it fits (dq_stages)
constexpr int kWgThreads = 128;        // a warpgroup
constexpr int kWgmmaThreads = 3 * kWgThreads;  // two consumer warpgroups, one producer
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStatWords = 3 * kRowTile;  // a query tile's lse in base 2, D, positions
constexpr uint32_t kMaxSmemBytes = 232448;  // dynamic shared memory a block may use on an H100

// ---------------------------------------------------------------------------
// The pass before the products: D = rowsum(dO * O) and the tiles' statistics
// ---------------------------------------------------------------------------

constexpr int kPrepThreads = 256;

// Blocks [0, b*h*nqt): one (batch, head, 64-query tile) each.  D of each row
// by 16-byte loads of O and dO (b, sq, h, hd_v): lanes_per_row (a power of two
// >= hd_v / 8) lanes a row, one
// 16-byte chunk each, 256 / lanes_per_row rows at a time.  "mma" design
// (stats == nullptr): D into delta (b, h, sq).  "wgmma" design: the lse in
// base 2, D and the positions into the tile's statistics block (b, h, nqt,
// 3, 64), the positions' range and blindness into tinfo (b, nqt, h); blocks
// from b*h*nqt on give each 64-key tile's positions (kpos, 0 past Sk) and
// their range (kinfo).
__global__ void __launch_bounds__(kPrepThreads)
attn_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos, float* __restrict__ delta,
                     float* __restrict__ stats, int4* __restrict__ tinfo,
                     int2* __restrict__ kinfo, int* __restrict__ kpos, int sq, int sk, int h,
                     int hd_v, int nqt, long long row_blocks, int lanes_per_row) {
  __shared__ int red[2][3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (static_cast<long long>(blockIdx.x) >= row_blocks) {  // a key tile's position range
    const int kt = static_cast<int>(blockIdx.x - row_blocks);
    if (threadIdx.x >= kKeyTile) return;
    const int j = kt * kKeyTile + threadIdx.x;
    int lo = INT_MAX, hi = INT_MIN;
    if (j < sk) lo = hi = __ldg(k_pos + j);
    kpos[j] = j < sk ? lo : 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, s));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, s));
    }
    if (lane == 0) red[warp][0] = lo, red[warp][1] = hi;
    asm volatile("bar.sync 1, 64;\n" ::: "memory");  // the two warps of this tile
    if (threadIdx.x == 0)
      kinfo[kt] = make_int2(min(red[0][0], red[1][0]), max(red[0][1], red[1][1]));
    return;
  }
  const int qt = static_cast<int>(blockIdx.x % nqt);
  const long long bh = blockIdx.x / nqt;  // b * h + head
  const int head = static_cast<int>(bh % h);
  const long long b = bh / h;
  const int chunks = hd_v / 8;
  const int c = threadIdx.x & (lanes_per_row - 1);
  float* st = stats ? stats + (bh * nqt + qt) * kStatWords : nullptr;
  for (int r = threadIdx.x / lanes_per_row; r < kRowTile; r += kPrepThreads / lanes_per_row) {
    const int qi = qt * kRowTile + r;
    float s = 0.f;
    if (qi < sq && c < chunks) {
      const long long off = ((b * sq + qi) * h + head) * hd_v + c * 8;
      const uint4 x = *reinterpret_cast<const uint4*>(o + off);
      const uint4 y = *reinterpret_cast<const uint4*>(dout + off);
      const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xa[e]), yf = __bfloat1622float2(ya[e]);
        s += xf.x * yf.x + xf.y * yf.y;
      }
    }
    for (int m = lanes_per_row >> 1; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (c == 0) {
      if (st)
        st[kRowTile + r] = qi < sq ? s : 0.f;
      else if (qi < sq)
        delta[bh * sq + qi] = s;
    }
  }
  if (!st || threadIdx.x >= kRowTile) return;
  const int r = threadIdx.x, qi = qt * kRowTile + r;
  int lo = INT_MAX, hi = INT_MIN, blind = 0;
  float l2 = INFINITY;  // past Sq: P = 0
  if (qi < sq) {
    const float x = lse[bh * sq + qi];
    blind = x == kMasked;
    l2 = blind ? -INFINITY : x * kLog2e;
    lo = hi = __ldg(q_pos + qi);
  }
  st[r] = l2;
  reinterpret_cast<int*>(st)[2 * kRowTile + r] = qi < sq ? lo : 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, s));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, s));
    blind |= __shfl_xor_sync(0xffffffffu, blind, s);
  }
  if (lane == 0) red[warp][0] = lo, red[warp][1] = hi, red[warp][2] = blind;
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
  if (threadIdx.x == 0)
    tinfo[(b * nqt + qt) * h + head] = make_int4(min(red[0][0], red[1][0]),
                                                 max(red[0][1], red[1][1]),
                                                 red[0][2] | red[1][2], 0);
}

// ---------------------------------------------------------------------------
// "wgmma" design: shared memory layouts
// ---------------------------------------------------------------------------

// HD: the width of Q, K (and dQ, dK) tiles; HDV: of V and dO (and dV)
template <int HD, int HDV>
struct DkdvSmem {
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + tile_bytes<HD>(kDkdvKeys);
  static constexpr uint32_t stage = v + tile_bytes<HDV>(kDkdvKeys);  // Q then dO, per stage
  static constexpr uint32_t stage_bytes = tile_bytes<HD>(kRowTile) + tile_bytes<HDV>(kRowTile);
  static constexpr uint32_t stats = stage + kDkdvStages * stage_bytes;
  static constexpr uint32_t full = stats + kDkdvStages * kStatWords * 4;
  static constexpr uint32_t empty = full + 8 * kDkdvStages;
  static constexpr uint32_t kv_bar = empty + 8 * kDkdvStages;
  static constexpr uint32_t info = kv_bar + 8;  // int[8] per stage: qt, qmin, qmax, blind
  static constexpr uint32_t bytes = info + 32 * kDkdvStages + 1024;  // + alignment slack
  static_assert(bytes <= kMaxSmemBytes, "the dK/dV block does not fit");
};

// Bytes of the dQ block's shared memory with a ring of `stages` K / V stages
template <int HD, int HDV>
constexpr uint32_t dq_smem_bytes(int stages) {
  return tile_bytes<HD>(kDqRows) + tile_bytes<HDV>(kDqRows) +
         stages * (tile_bytes<HD>(kKeyTile) + tile_bytes<HDV>(kKeyTile) + kKeyTile * 4 + 16 + 32) +
         8 + 1024;
}
// The dQ ring's stages: kDqStages where they fit, fewer where not (3 at (192, 128))
template <int HD, int HDV>
constexpr int dq_stages() {
  int s = kDqStages;
  while (s > 1 && dq_smem_bytes<HD, HDV>(s) > kMaxSmemBytes) --s;
  return s;
}

template <int HD, int HDV>
struct DqSmem {
  static constexpr int stages = dq_stages<HD, HDV>();
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = q + tile_bytes<HD>(kDqRows);
  static constexpr uint32_t stage = dout + tile_bytes<HDV>(kDqRows);  // K then V, per stage
  static constexpr uint32_t stage_bytes = tile_bytes<HD>(kKeyTile) + tile_bytes<HDV>(kKeyTile);
  static constexpr uint32_t kpos = stage + stages * stage_bytes;  // 64 key positions a stage
  static constexpr uint32_t full = kpos + stages * kKeyTile * 4;
  static constexpr uint32_t empty = full + 8 * stages;
  static constexpr uint32_t qd_bar = empty + 8 * stages;
  static constexpr uint32_t info = qd_bar + 8;  // int[8] per stage: kt, kmin, kmax
  static constexpr uint32_t bytes = info + 32 * stages + 1024;
  static_assert(bytes == dq_smem_bytes<HD, HDV>(stages) && bytes <= kMaxSmemBytes, "dQ block");
};

// ---------------------------------------------------------------------------
// dK, dV ("wgmma"): one block per (128-key tile, kv head, batch)
// ---------------------------------------------------------------------------

// The dK/dV consumer's schedule of a pair: with the accumulators of (HD, HDV)
// and S^T and dP^T over the 240 registers less about 48 for addresses,
// indices and statistics, never hold S^T and dP^T at once (see the header).
// Below that the overlapped schedule is faster: at (128, 128) the serial one
// took 2.874 ms against 2.565 at the training microbatch (B 4, S 4096, H 24,
// Hkv 2; scripts/attn_bwd_ab.py in turns on an H100 80GB HBM3 at 700 W).
template <int HD, int HDV>
constexpr bool kSerialPairs = HD / 2 + HDV / 2 + 64 > kConsumerRegs - 48;

template <int HD, int HDV>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const float* __restrict__ stats, const int4* __restrict__ tinfo,
                           const int2* __restrict__ kinfo, const int* __restrict__ k_pos,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int b_count, int sq,
                           int sk, int h, int hkv, int hd, int hd_v, float scale,
                           float scale_log2, int causal, int window) {
  using L = DkdvSmem<HD, HDV>;
  extern __shared__ __align__(128) unsigned char smem_raw[];  // aligned to 1024 below
  const uint32_t base = align1024(smem_u32(smem_raw));
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const int g = h / hkv, nqt = (sq + kRowTile - 1) / kRowTile, nkt = (sk + kKeyTile - 1) / kKeyTile;
  // 1-D grid, the key tile slowest: every (batch, kv head)'s first tile (most rows) first
  const int per = hkv * b_count;
  const int kb = blockIdx.x / per, kvh = blockIdx.x % per % hkv, b = blockIdx.x % per / hkv;
  const int kt0 = kb * kDkdvKeys;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDkdvStages; ++s) {
      mbar_init(base + L::full + 8 * s, 1);
      mbar_init(base + L::empty + 8 * s, 2 * kWgThreads / 32);  // one arrival per consumer warp
    }
    mbar_init(base + L::kv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWgThreads) {  // ---- producer warpgroup ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 2 * kWgThreads + 32) {  // one warp issues
      const int lane = threadIdx.x & 31;
      // the block's keys: one or two 64-key tiles
      int kmin = INT_MAX, kmax = INT_MIN;
      for (int t = kt0 / kKeyTile; t < min(nkt, kt0 / kKeyTile + kDkdvKeys / kKeyTile); ++t) {
        const int2 r = kinfo[t];
        kmin = min(kmin, r.x);
        kmax = max(kmax, r.y);
      }
      if (lane == 0) {
        mbar_expect_tx(base + L::kv_bar, tile_bytes<HD>(kDkdvKeys) + tile_bytes<HDV>(kDkdvKeys));
        load_rows<HD>(base + L::k, kDkdvKeys, 0, &map_k, base + L::kv_bar, kvh, kt0, 2, b);
        load_rows<HDV>(base + L::v, kDkdvKeys, 0, &map_v, base + L::kv_bar, kvh, kt0, 2, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      const int pairs = nqt * g;  // pair c: 64-query tile c / g of head kvh * g + c % g
      for (int c0 = 0; c0 < pairs; c0 += 32) {
        const int c = c0 + lane;
        int4 ti = make_int4(0, 0, 0, 0);
        bool live = false;
        if (c < pairs) {
          ti = tinfo[(static_cast<long long>(b) * nqt + c / g) * h + kvh * g + c % g];
          live = ti.z || tile_state_of(kmin, kmax, ti.x, ti.y, causal, window) != 0;
        }
        uint32_t mask = __ballot_sync(0xffffffffu, live);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const int qmin = __shfl_sync(0xffffffffu, ti.x, src);
          const int qmax = __shfl_sync(0xffffffffu, ti.y, src);
          const int blind = __shfl_sync(0xffffffffu, ti.z, src);
          if (lane == 0) {
            const int cc = c0 + src, qt = cc / g, head = kvh * g + cc % g;
            mbar_wait(base + L::empty + 8 * stage, phase ^ 1);
            int* info = reinterpret_cast<int*>(gbase + L::info) + 8 * stage;
            info[0] = qt;
            info[1] = qmin;
            info[2] = qmax;
            info[3] = blind;
            const uint32_t full = base + L::full + 8 * stage;
            mbar_expect_tx(full, L::stage_bytes + kStatWords * 4);
            const uint32_t qs = base + L::stage + stage * L::stage_bytes;
            load_rows<HD>(qs, kRowTile, 0, &map_q, full, head, qt * kRowTile, 1, b);
            load_rows<HDV>(qs + tile_bytes<HD>(kRowTile), kRowTile, 0, &map_do, full, head,
                           qt * kRowTile, 1, b);
            bulk_load(base + L::stats + stage * kStatWords * 4,
                      stats + ((static_cast<long long>(b) * h + head) * nqt + qt) * kStatWords,
                      kStatWords * 4, full);
          }
          __syncwarp();
          if (++stage == kDkdvStages) stage = 0, phase ^= 1;
        }
      }
      if (lane == 0) {  // the end of the walk
        mbar_wait(base + L::empty + 8 * stage, phase ^ 1);
        reinterpret_cast<int*>(gbase + L::info)[8 * stage] = -1;
        mbar_arrive(base + L::full + 8 * stage);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5, lane = tid & 31, tig = lane & 3;
    const int key_base = kt0 + wg * kKeyTile;
    const bool has_keys = key_base < sk;
    int kmin = INT_MAX, kmax = INT_MIN;
    if (has_keys) {
      const int2 r = kinfo[key_base / kKeyTile];
      kmin = r.x;
      kmax = r.y;
    }
    const int r0 = warp * 16 + (lane >> 2);  // this thread's keys: r0 and r0 + 8 of the 64
    // this thread's keys key0 and key0 + 8; nothing held that can be recomputed (1/Sk is
    // formed where a row sees no key): at (192, 128) one register more spills
    const int key0 = key_base + r0;
    const int kp[2] = {key0 < sk ? __ldg(k_pos + key0) : 0,
                       key0 + 8 < sk ? __ldg(k_pos + key0 + 8) : 0};
    float dk_acc[HD / 2], dv_acc[HDV / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) dv_acc[i] = 0.f;
    mbar_wait(base + L::kv_bar, 0);
    const uint32_t k_rows = base + L::k + wg * kKeyTile * kHalfRowBytes;
    const uint32_t v_rows = base + L::v + wg * kKeyTile * kHalfRowBytes;
    constexpr uint32_t kv_half = kDkdvKeys * kHalfRowBytes, row_half = kRowTile * kHalfRowBytes;

    int stage = 0;
    uint32_t phase = 0;
    for (;; (++stage == kDkdvStages) ? (stage = 0, phase ^= 1) : 0) {
      mbar_wait(base + L::full + 8 * stage, phase);
      const int* info = reinterpret_cast<const int*>(gbase + L::info) + 8 * stage;
      if (info[0] < 0) break;  // the end of the walk
      const int state = tile_state_of(kmin, kmax, info[1], info[2], causal, window);
      if (has_keys && (state != 0 || info[3])) {
        const uint32_t qs = base + L::stage + stage * L::stage_bytes;
        const uint32_t dos = qs + tile_bytes<HD>(kRowTile);
        // the pair's statistics: lse in base 2, D, the queries' positions (int)
        const float* st = reinterpret_cast<const float*>(gbase + L::stats) + stage * kStatWords;
        const int* st_pos = reinterpret_cast<const int*>(st) + 2 * kRowTile;
        // P^T from S^T in place.  A pair every key of which sees every row
        // (state 2) holds no row that sees no key and needs no mask: its P
        // and dS are plain arithmetic.  Otherwise each pair is masked by its
        // positions.
        auto softmax = [&](float (&s)[32]) {
          if (state == 2) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[4 * j + e] = fast_exp2(s[4 * j + e] * scale_log2 - st[8 * j + 2 * tig + (e & 1)]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = 8 * j + 2 * tig + (e & 1);
                const float l2 = st[col];
                const bool seen = state == 1 && visible(st_pos[col], kp[e >> 1], causal, window);
                const float p = fast_exp2(s[4 * j + e] * scale_log2 - l2);
                // a row that sees no key: uniform weights, no score gradient
                s[4 * j + e] = l2 == -INFINITY ? __frcp_rn(static_cast<float>(sk)) : seen ? p : 0.f;
              }
            }
          }
        };
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {  // S^T = K Q^T: keys x queries
          const uint32_t off = (kk & 3) * 32;
          wgmma_ss_n64(s, desc_kmajor(k_rows + (kk >> 2) * kv_half + off),
                       desc_kmajor(qs + (kk >> 2) * row_half + off), kk > 0);
        }
        wgmma_commit();
        uint32_t pa[4][4];
        if constexpr (!kSerialPairs<HD, HDV>) {
          float dp[32];
          uint32_t da[4][4];
#pragma unroll
          for (int kk = 0; kk < HDV / 16; ++kk) {  // dP^T = V dO^T
            const uint32_t off = (kk & 3) * 32;
            wgmma_ss_n64(dp, desc_kmajor(v_rows + (kk >> 2) * kv_half + off),
                         desc_kmajor(dos + (kk >> 2) * row_half + off), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(s);
          softmax(s);
          wgmma_wait<0>();
          fence_regs(dp);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * tig + (e & 1);
              const float ds = s[4 * j + e] * (dp[4 * j + e] - st[kRowTile + col]);
              dp[4 * j + e] = state != 2 && st[col] == -INFINITY ? 0.f : ds;
            }
          }
          pack_a(pa, s);
          pack_a(da, dp);
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO: 16 queries a step
            wgmma_rs_tb<HDV>(dv_acc, pa[kk], desc_mnmajor(dos + kk * 16 * kHalfRowBytes, row_half));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // dK += dS^T Q
            wgmma_rs_tb<HD>(dk_acc, da[kk], desc_mnmajor(qs + kk * 16 * kHalfRowBytes, row_half));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          fence_regs(pa);
          fence_regs(da);
        } else {
          // S^T's registers go to bf16 P before any of dP^T is issued; P^T dO
          // runs beside dP^T's first half.  dP^T, dS and dS^T Q go by halves
          // of 32 queries (16 registers of dP^T, 8 of dS), dS from the bf16 P.
          wgmma_wait<0>();
          fence_regs(s);
          softmax(s);
          pack_a(pa, s);
          fence_regs(dv_acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO: 16 queries a step
            wgmma_rs_tb<HDV>(dv_acc, pa[kk], desc_mnmajor(dos + kk * 16 * kHalfRowBytes, row_half));
          uint32_t dh[2][2][4];  // dS^T of each half: two A fragments of 16 queries
#pragma unroll
          for (int hq = 0; hq < 2; ++hq) {  // queries [32 hq, 32 hq + 32)
            float dph[16];
            const uint32_t dos_h = dos + hq * 32 * kHalfRowBytes;
#pragma unroll
            for (int kk = 0; kk < HDV / 16; ++kk) {  // dP^T = V dO^T, this half
              const uint32_t off = (kk & 3) * 32;
              wgmma_ss_n32(dph, desc_kmajor(v_rows + (kk >> 2) * kv_half + off),
                           desc_kmajor(dos_h + (kk >> 2) * row_half + off), kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();  // dP^T's half (and dV, and the previous half's dK)
            fence_regs(dph);
            if (hq == 0) {  // dV is done with all of P ...
              fence_regs(dv_acc);
              fence_regs(pa);
            } else {  // ... and the first half's dK with its dS
              fence_regs(dh[0]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
              for (int e = 0; e < 4; e += 2) {
                const int i = 16 * hq + 4 * j + e;  // P of entries i, i + 1: pa's pair i / 2
                const float2 p = unpack_bf16(pa[i / 8][(i % 8) / 2]);
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                  const int col = 32 * hq + 8 * j + 2 * tig + u;
                  const float ds = (u ? p.y : p.x) * (dph[4 * j + e + u] - st[kRowTile + col]);
                  dph[4 * j + e + u] = state != 2 && st[col] == -INFINITY ? 0.f : ds;
                }
              }
            }
            pack_a(dh[hq], dph);
            fence_regs(dk_acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)  // dK += dS^T Q, this half
              wgmma_rs_tb<HD>(dk_acc, dh[hq][kk],
                              desc_mnmajor(qs + (32 * hq + 16 * kk) * kHalfRowBytes, row_half));
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs(dk_acc);
          fence_regs(dh[1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(base + L::empty + 8 * stage);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key0 + 8 * i >= sk) continue;
      const long long row = (static_cast<long long>(b) * sk + key0 + 8 * i) * hkv + kvh;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int d = 8 * j + 2 * tig;
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(dk + row * hd + d) = __floats2bfloat162_rn(
              dk_acc[4 * j + 2 * i] * scale, dk_acc[4 * j + 2 * i + 1] * scale);
      }
#pragma unroll
      for (int j = 0; j < HDV / 8; ++j) {
        const int d = 8 * j + 2 * tig;
        if (d < hd_v)
          *reinterpret_cast<__nv_bfloat162*>(dv + row * hd_v + d) =
              __floats2bfloat162_rn(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ ("wgmma"): one block per (128-query tile, head, batch)
// ---------------------------------------------------------------------------

template <int HD, int HDV>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ stats, const int4* __restrict__ tinfo,
                         const int2* __restrict__ kinfo, const int* __restrict__ kpos,
                         const int* __restrict__ q_pos, bf16* __restrict__ dq, int b_count,
                         int sq, int sk, int h, int hkv, float scale, float scale_log2,
                         int causal, int window, int hd) {
  using L = DqSmem<HD, HDV>;
  extern __shared__ __align__(128) unsigned char smem_raw[];  // aligned to 1024 below
  const uint32_t base = align1024(smem_u32(smem_raw));
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const int g = h / hkv, nqt = (sq + kRowTile - 1) / kRowTile, nkt = (sk + kKeyTile - 1) / kKeyTile;
  const int nqb = (sq + kDqRows - 1) / kDqRows;
  // 1-D grid, the row tile slowest: the latest queries (most keys) first
  const int per = h * b_count;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x / per);
  const int head = blockIdx.x % per % h, b = blockIdx.x % per / h, kvh = head / g;
  const int q0 = qb * kDqRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::stages; ++s) {
      mbar_init(base + L::full + 8 * s, 1);
      mbar_init(base + L::empty + 8 * s, 2 * kWgThreads / 32);
    }
    mbar_init(base + L::qd_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWgThreads) {  // ---- producer warpgroup ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 2 * kWgThreads + 32) {  // one warp issues
      const int lane = threadIdx.x & 31;
      int qmin = INT_MAX, qmax = INT_MIN;
      for (int t = q0 / kRowTile; t < min(nqt, q0 / kRowTile + kDqRows / kRowTile); ++t) {
        const int4 r = tinfo[(static_cast<long long>(b) * nqt + t) * h + head];
        qmin = min(qmin, r.x);
        qmax = max(qmax, r.y);
      }
      if (lane == 0) {
        mbar_expect_tx(base + L::qd_bar, tile_bytes<HD>(kDqRows) + tile_bytes<HDV>(kDqRows));
        load_rows<HD>(base + L::q, kDqRows, 0, &map_q, base + L::qd_bar, head, q0, 2, b);
        load_rows<HDV>(base + L::dout, kDqRows, 0, &map_do, base + L::qd_bar, head, q0, 2, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t0 = 0; t0 < nkt; t0 += 32) {
        const int t = t0 + lane;
        int2 ki = make_int2(0, 0);
        bool live = false;
        if (t < nkt) {
          ki = kinfo[t];
          live = tile_state_of(ki.x, ki.y, qmin, qmax, causal, window) != 0;
        }
        uint32_t mask = __ballot_sync(0xffffffffu, live);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const int kmin = __shfl_sync(0xffffffffu, ki.x, src);
          const int kmax = __shfl_sync(0xffffffffu, ki.y, src);
          if (lane == 0) {
            const int kt = t0 + src;
            mbar_wait(base + L::empty + 8 * stage, phase ^ 1);
            int* info = reinterpret_cast<int*>(gbase + L::info) + 8 * stage;
            info[0] = kt;
            info[1] = kmin;
            info[2] = kmax;
            const uint32_t full = base + L::full + 8 * stage;
            mbar_expect_tx(full, L::stage_bytes + kKeyTile * 4);
            const uint32_t ks = base + L::stage + stage * L::stage_bytes;
            load_rows<HD>(ks, kKeyTile, 0, &map_k, full, kvh, kt * kKeyTile, 1, b);
            load_rows<HDV>(ks + tile_bytes<HD>(kKeyTile), kKeyTile, 0, &map_v, full, kvh,
                           kt * kKeyTile, 1, b);
            bulk_load(base + L::kpos + stage * kKeyTile * 4, kpos + kt * kKeyTile, kKeyTile * 4,
                      full);
          }
          __syncwarp();
          if (++stage == L::stages) stage = 0, phase ^= 1;
        }
      }
      if (lane == 0) {
        mbar_wait(base + L::empty + 8 * stage, phase ^ 1);
        reinterpret_cast<int*>(gbase + L::info)[8 * stage] = -1;
        mbar_arrive(base + L::full + 8 * stage);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5, lane = tid & 31, tig = lane & 3;
    const int qt = q0 / kRowTile + wg;
    const bool has_rows = qt * kRowTile < sq;
    int qmin = INT_MAX, qmax = INT_MIN;
    const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8 of the 64
    const int row[2] = {qt * kRowTile + r0, qt * kRowTile + r0 + 8};
    float l2[2] = {INFINITY, INFINITY}, dlt[2] = {0.f, 0.f};
    int qp[2] = {0, 0};
    if (has_rows) {
      const int4 r = tinfo[(static_cast<long long>(b) * nqt + qt) * h + head];
      qmin = r.x;
      qmax = r.y;
      const float* st = stats + ((static_cast<long long>(b) * h + head) * nqt + qt) * kStatWords;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l2[i] = st[r0 + 8 * i];
        dlt[i] = st[kRowTile + r0 + 8 * i];
        qp[i] = row[i] < sq ? __ldg(q_pos + row[i]) : 0;
      }
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    mbar_wait(base + L::qd_bar, 0);
    const uint32_t q_rows = base + L::q + wg * kRowTile * kHalfRowBytes;
    const uint32_t do_rows = base + L::dout + wg * kRowTile * kHalfRowBytes;
    constexpr uint32_t qd_half = kDqRows * kHalfRowBytes, key_half = kKeyTile * kHalfRowBytes;

    int stage = 0;
    uint32_t phase = 0;
    for (;; (++stage == L::stages) ? (stage = 0, phase ^= 1) : 0) {
      mbar_wait(base + L::full + 8 * stage, phase);
      const int* info = reinterpret_cast<const int*>(gbase + L::info) + 8 * stage;
      const int kt = info[0];
      if (kt < 0) break;
      const int state = tile_state_of(info[1], info[2], qmin, qmax, causal, window);
      if (has_rows && state != 0) {  // rows that see no key get no score gradient
        const uint32_t ks = base + L::stage + stage * L::stage_bytes;
        const uint32_t vs = ks + tile_bytes<HD>(kKeyTile);
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {  // S = Q K^T: rows x keys
          const uint32_t off = (kk & 3) * 32;
          wgmma_ss_n64(s, desc_kmajor(q_rows + (kk >> 2) * qd_half + off),
                       desc_kmajor(ks + (kk >> 2) * key_half + off), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HDV / 16; ++kk) {  // dP = dO V^T
          const uint32_t off = (kk & 3) * 32;
          wgmma_ss_n64(dp, desc_kmajor(do_rows + (kk >> 2) * qd_half + off),
                       desc_kmajor(vs + (kk >> 2) * key_half + off), kk > 0);
        }
        wgmma_commit();
        const int t0 = kt * kKeyTile;
        const int* kp = reinterpret_cast<const int*>(gbase + L::kpos) + stage * kKeyTile;
        // a tile every key of which every row sees (state 2, none past Sk)
        // needs no mask: plain arithmetic (its rows all see a key)
        const bool plain = state == 2 && t0 + kKeyTile <= sk;
        wgmma_wait<1>();
        fence_regs(s);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * j + e] = fast_exp2(s[4 * j + e] * scale_log2 - l2[e >> 1]);
        }
        wgmma_wait<0>();
        fence_regs(dp);
        if (plain) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[4 * j + e] *= dp[4 * j + e] - dlt[e >> 1];
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1, col = 8 * j + 2 * tig + (e & 1);
              const bool seen = t0 + col < sk && l2[i] != -INFINITY &&
                                (state == 2 || visible(qp[i], kp[col], causal, window));
              s[4 * j + e] = seen ? s[4 * j + e] * (dp[4 * j + e] - dlt[i]) : 0.f;
            }
          }
        }
        uint32_t da[4][4];
        pack_a(da, s);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dQ += dS K: 16 keys a step
          wgmma_rs_tb<HD>(acc, da[kk], desc_mnmajor(ks + kk * 16 * kHalfRowBytes, key_half));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(base + L::empty + 8 * stage);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] >= sq) continue;
      bf16* out = dq + ((static_cast<long long>(b) * sq + row[i]) * h + head) * hd;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int d = 8 * j + 2 * tig;
        if (d < hd)
          *reinterpret_cast<__nv_bfloat162*>(out + d) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// "mma" design (hd above 192, or hd_v above 128): mma.sync tiles of 64
// (query, head) rows; V and dO rows at hd_v, zero-filled to HD in shared memory
// ---------------------------------------------------------------------------

constexpr int kTile = 64;  // keys per K/V tile, (query, head) rows per row tile

// min and max of k_pos over keys [t0, min(t0 + kTile, sk)), in every warp
__device__ __forceinline__ void key_range(const int* __restrict__ k_pos, int t0, int sk, int* kmin,
                                          int* kmax) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
  const int end = min(sk, t0 + kTile);
  for (int j = t0 + lane; j < end; j += 32) {
    const int p = __ldg(k_pos + j);
    lo = min(lo, p);
    hi = max(hi, p);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  *kmin = lo;
  *kmax = hi;
}

// min and max query position over rows [row0, row0 + kTile) of (query, head)
// rows (row / g is the query), in every warp
__device__ __forceinline__ void row_range(const int* __restrict__ q_pos, int row0, int rows, int g,
                                          int* qmin, int* qmax) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = lane; r < kTile; r += 32) {
    const int row = row0 + r;
    if (row < rows) {
      const int p = __ldg(q_pos + row / g);
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  *qmin = lo;
  *qmax = hi;
}

// Address of (query, head) row `row` of kv head kvh in a (b, sq, h, width) tensor
__device__ __forceinline__ long long row_offset(long long b, int row, int kvh, int sq, int h,
                                                int width, int g) {
  const int qi = row / g, head = kvh * g + (row - qi * g);
  return ((b * sq + qi) * h + head) * width;
}

// Index of (query, head) row `row` of kv head kvh in a (b, h, sq) statistic
__device__ __forceinline__ long long stat_index(long long b, int row, int kvh, int sq, int h,
                                                int g) {
  const int qi = row / g, head = kvh * g + (row - qi * g);
  return (b * h + head) * sq + qi;
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (64-key tile, kv head, batch)
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t bwd_smem_bytes() {
  return 4 * 2 * HD * kTile + 3 * sizeof(float) * kTile;  // four bf16 tiles, lse/D/positions
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int h, int hkv,
                     int hd, int hd_v, float scale, float scale_log2, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr uint32_t kTileBytes = 2 * HD * kTile;
  const uint32_t ks = smem_u32(smem_raw);
  const uint32_t vs = ks + kTileBytes;
  const uint32_t qs = vs + kTileBytes;
  const uint32_t dos = qs + kTileBytes;
  float* lse_s = reinterpret_cast<float*>(smem_raw + 4 * kTileBytes);  // base 2; +inf pad, -inf blind
  float* d_s = lse_s + kTile;
  int* qp_s = reinterpret_cast<int*>(d_s + kTile);

  const int g = h / hkv, rows = sq * g;
  const int kt0 = blockIdx.x * kTile;  // the earliest keys (most rows see them) first
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;

  auto kv_src = [&](const bf16* base, int width) {
    return [=](int r) -> const bf16* {
      const int j = kt0 + r;
      return j < sk ? base + ((b * sk + j) * hkv + kvh) * width : nullptr;
    };
  };
  stage_rows<HD, kTile>(ks, hd, k, kv_src(k, hd));
  stage_rows<HD, kTile>(vs, hd_v, v, kv_src(v, hd_v));
  cp_async_commit();

  int kmin, kmax;
  key_range(k_pos, kt0, sk, &kmin, &kmax);
  const int key[2] = {kt0 + warp * 16 + grp, kt0 + warp * 16 + grp + 8};  // this thread's keys
  const int kp[2] = {key[0] < sk ? __ldg(k_pos + key[0]) : 0,
                     key[1] < sk ? __ldg(k_pos + key[1]) : 0};
  const float inv_sk = 1.f / static_cast<float>(sk);

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  for (int r0 = 0; r0 < rows; r0 += kTile) {
    int qmin, qmax;
    row_range(q_pos, r0, rows, g, &qmin, &qmax);
    const int state = tile_state_of(kmin, kmax, qmin, qmax, causal, window);  // same in every warp
    if (state == 0) {
      // every pair hidden: skip, unless a row sees no key (its weights reach every key)
      bool blind = false;
      if (threadIdx.x < kTile && r0 + threadIdx.x < rows)
        blind = lse[stat_index(b, r0 + threadIdx.x, kvh, sq, h, g)] == kMasked;
      if (!__syncthreads_or(blind)) continue;
    }
    __syncthreads();  // the previous row tile is consumed
    auto row_src = [&](const bf16* base, int width) {
      return [=](int r) -> const bf16* {
        const int row = r0 + r;
        return row < rows ? base + row_offset(b, row, kvh, sq, h, width, g) : nullptr;
      };
    };
    stage_rows<HD, kTile>(qs, hd, q, row_src(q, hd));
    stage_rows<HD, kTile>(dos, hd_v, dout, row_src(dout, hd_v));
    cp_async_commit();
    if (threadIdx.x < kTile) {
      const int row = r0 + threadIdx.x;
      if (row < rows) {
        const long long i = stat_index(b, row, kvh, sq, h, g);
        const float L = lse[i];
        lse_s[threadIdx.x] = L == kMasked ? -INFINITY : L * kLog2e;
        d_s[threadIdx.x] = delta[i];
        qp_s[threadIdx.x] = __ldg(q_pos + row / g);
      } else {
        lse_s[threadIdx.x] = INFINITY;  // P = 0
        d_s[threadIdx.x] = 0.f;
        qp_s[threadIdx.x] = 0;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    qk<HD, kTile / 8>(s, ks, warp * 16, qs, 0);    // S^T: this warp's 16 keys x 64 rows
    qk<HD, kTile / 8>(dp, vs, warp * 16, dos, 0);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + tig * 2 + (e & 1), i = e >> 1;
        const float L = lse_s[col];
        float p = 0.f, ds = 0.f;
        if (key[i] < sk) {
          if (L == -INFINITY) {
            p = inv_sk;  // a row that sees no key: uniform weights, no score gradient
          } else if (state == 2 || visible(qp_s[col], kp[i], causal, window)) {
            p = exp2f(s[n][e] * scale_log2 - L);
            ds = p * (dp[n][e] - d_s[col]);
          }
        }
        s[n][e] = p;
        dp[n][e] = ds;
      }
    }
    pv<HD, kTile / 8>(dv_acc, s, dos, 0);  // dV += P^T dO
    pv<HD, kTile / 8>(dk_acc, dp, qs, 0);  // dK += dS^T Q
  }
  cp_async_wait<0>();  // K and V, if every row tile was skipped

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= sk) continue;
    const long long row = (b * sk + key[i]) * hkv + kvh;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = n * 8 + tig * 2;
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(dk + row * hd + d) =
            __floats2bfloat162_rn(dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
      if (d < hd_v)
        *reinterpret_cast<__nv_bfloat162*>(dv + row * hd_v + d) =
            __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (64-row tile, kv head, batch)
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 2)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                   bf16* __restrict__ dq, int sq, int sk, int h, int hkv, int hd, int hd_v,
                   float scale, float scale_log2, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr uint32_t kTileBytes = 2 * HD * kTile;
  const uint32_t qs = smem_u32(smem_raw);
  const uint32_t dos = qs + kTileBytes;
  const uint32_t ks = dos + kTileBytes;
  const uint32_t vs = ks + kTileBytes;

  const int g = h / hkv, rows = sq * g;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // the latest queries (most keys) first
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;

  auto row_src = [&](const bf16* base, int width) {
    return [=](int r) -> const bf16* {
      const int row = row0 + r;
      return row < rows ? base + row_offset(b, row, kvh, sq, h, width, g) : nullptr;
    };
  };
  stage_rows<HD, kTile>(qs, hd, q, row_src(q, hd));
  stage_rows<HD, kTile>(dos, hd_v, dout, row_src(dout, hd_v));
  cp_async_commit();

  int qmin, qmax;
  row_range(q_pos, row0, rows, g, &qmin, &qmax);
  const int row[2] = {row0 + warp * 16 + grp, row0 + warp * 16 + grp + 8};
  int qp[2];
  float L[2], dlt[2];  // L: lse in base 2; +inf past the rows (P = 0), -inf a row that sees no key
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] < rows) {
      const long long si = stat_index(b, row[i], kvh, sq, h, g);
      const float x = lse[si];
      L[i] = x == kMasked ? -INFINITY : x * kLog2e;
      dlt[i] = delta[si];
      qp[i] = __ldg(q_pos + row[i] / g);
    } else {
      L[i] = INFINITY;
      dlt[i] = 0.f;
      qp[i] = 0;
    }
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = (sk + kTile - 1) / kTile;
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = t * kTile;
    int kmin, kmax;
    key_range(k_pos, t0, sk, &kmin, &kmax);
    const int state = tile_state_of(kmin, kmax, qmin, qmax, causal, window);  // same in every warp
    if (state == 0) continue;  // rows that see no key get no score gradient: nothing to add
    __syncthreads();  // the previous K/V tile is consumed
    auto kv_src = [&](const bf16* base, int width) {
      return [=](int r) -> const bf16* {
        const int j = t0 + r;
        return j < sk ? base + ((b * sk + j) * hkv + kvh) * width : nullptr;
      };
    };
    stage_rows<HD, kTile>(ks, hd, k, kv_src(k, hd));
    stage_rows<HD, kTile>(vs, hd_v, v, kv_src(v, hd_v));
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
    qk<HD, kTile / 8>(s, qs, warp * 16, ks, 0);    // S: this warp's 16 rows x 64 keys
    qk<HD, kTile / 8>(dp, dos, warp * 16, vs, 0);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t0 + n * 8 + tig * 2 + (e & 1), i = e >> 1;
        float ds = 0.f;
        if (j < sk && L[i] != -INFINITY &&
            (state == 2 || visible(qp[i], __ldg(k_pos + j), causal, window))) {
          const float p = exp2f(s[n][e] * scale_log2 - L[i]);
          ds = p * (dp[n][e] - dlt[i]);
        }
        s[n][e] = ds;
      }
    }
    pv<HD, kTile / 8>(acc, s, ks, 0);  // dQ += dS K
  }
  cp_async_wait<0>();  // Q and dO, if every key tile was skipped

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= rows) continue;
    bf16* out = dq + row_offset(b, row[i], kvh, sq, h, hd, g);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = n * 8 + tig * 2;
      if (d < hd)
        *reinterpret_cast<__nv_bfloat162*>(out + d) =
            __floats2bfloat162_rn(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
    }
  }
}

template <int HD>
int mma_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* q_pos, const void* k_pos, void* dq, void* dk,
               void* dv, int b, int sq, int sk, int h, int hkv, int hd, int hd_v, float scale,
               int causal, int window, cudaStream_t stream) {
  static int smem_dkdv = 0, smem_dq = 0;
  constexpr size_t smem = bwd_smem_bytes<HD>();
  cudaError_t err = allow_smem(attn_bwd_dkdv_kernel<HD>, smem, &smem_dkdv);
  if (err == cudaSuccess) err = allow_smem(attn_bwd_dq_kernel<HD>, smem, &smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = scale * kLog2e;
  attn_bwd_dkdv_kernel<HD><<<dim3((sk + kTile - 1) / kTile, hkv, b), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, h,
      hkv, hd, hd_v, scale, scale_log2, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(sq) * (h / hkv);
  attn_bwd_dq_kernel<HD><<<dim3(static_cast<unsigned>((rows + kTile - 1) / kTile), hkv, b),
                           kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<bf16*>(dq), sq, sk, h, hkv, hd, hd_v, scale,
      scale_log2, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Byte offsets of the "wgmma" design's scratch: query tiles' statistics and
// info, key tiles' positions and ranges (each 16-byte aligned).
struct Scratch {
  long long stats, tinfo, kpos, kinfo, bytes;
  Scratch(int b, int sq, int sk, int h) {
    const long long tiles = static_cast<long long>(b) * h * ((sq + kRowTile - 1) / kRowTile);
    const long long key_tiles = (sk + kKeyTile - 1) / kKeyTile;
    stats = 0;
    tinfo = tiles * kStatWords * 4;
    kpos = tinfo + tiles * 16;
    kinfo = kpos + key_tiles * kKeyTile * 4;
    bytes = kinfo + key_tiles * 8;
  }
};

int prep_launch(const void* o, const void* dout, const void* lse, const void* q_pos,
                const void* k_pos, float* delta, unsigned char* scratch, int b, int sq, int sk,
                int h, int hd_v, cudaStream_t stream) {
  const int nqt = (sq + kRowTile - 1) / kRowTile;
  const long long row_blocks = static_cast<long long>(b) * h * nqt;
  int lanes = 1;
  while (lanes < hd_v / 8) lanes <<= 1;
  float* stats = nullptr;
  int4* tinfo = nullptr;
  int2* kinfo = nullptr;
  int* kpos = nullptr;
  long long blocks = row_blocks;
  if (scratch) {
    const Scratch sc(b, sq, sk, h);
    stats = reinterpret_cast<float*>(scratch + sc.stats);
    tinfo = reinterpret_cast<int4*>(scratch + sc.tinfo);
    kinfo = reinterpret_cast<int2*>(scratch + sc.kinfo);
    kpos = reinterpret_cast<int*>(scratch + sc.kpos);
    blocks += (sk + kKeyTile - 1) / kKeyTile;
  }
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_prep_kernel<<<static_cast<unsigned>(blocks), kPrepThreads, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), delta, stats, tinfo, kinfo, kpos, sq, sk, h, hd_v, nqt,
      row_blocks, lanes);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int HDV>
int wgmma_launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const void* lse, const void* q_pos, const void* k_pos, void* dq, void* dk,
                 void* dv, void* scratch, int b, int sq, int sk, int h, int hkv, int hd, int hd_v,
                 float scale, int causal, int window, cudaStream_t stream) {
  using Dkdv = DkdvSmem<HD, HDV>;
  using Dq = DqSmem<HD, HDV>;
  static int smem_dkdv = 0, smem_dq = 0;
  cudaError_t err = allow_smem(attn_bwd_dkdv_wgmma_kernel<HD, HDV>, Dkdv::bytes, &smem_dkdv);
  if (err == cudaSuccess)
    err = allow_smem(attn_bwd_dq_wgmma_kernel<HD, HDV>, Dq::bytes, &smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq, mk, mv, mdo;  // each at its tensor's own width
  int e = encode_rows(&mq, q, hd, h, sq, b);
  if (!e) e = encode_rows(&mdo, dout, hd_v, h, sq, b);
  if (!e) e = encode_rows(&mk, k, hd, hkv, sk, b);
  if (!e) e = encode_rows(&mv, v, hd_v, hkv, sk, b);
  if (e) return e;
  unsigned char* s = static_cast<unsigned char*>(scratch);
  e = prep_launch(o, dout, lse, q_pos, k_pos, nullptr, s, b, sq, sk, h, hd_v, stream);
  if (e) return e;
  const Scratch sc(b, sq, sk, h);
  const float* stats = reinterpret_cast<const float*>(s + sc.stats);
  const int4* tinfo = reinterpret_cast<const int4*>(s + sc.tinfo);
  const int2* kinfo = reinterpret_cast<const int2*>(s + sc.kinfo);
  const int* kpos = reinterpret_cast<const int*>(s + sc.kpos);
  const float scale_log2 = scale * kLog2e;
  const long long dkdv_blocks =
      static_cast<long long>((sk + kDkdvKeys - 1) / kDkdvKeys) * hkv * b;
  const long long dq_blocks = static_cast<long long>((sq + kDqRows - 1) / kDqRows) * h * b;
  if (dkdv_blocks > INT_MAX || dq_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_dkdv_wgmma_kernel<HD, HDV><<<static_cast<unsigned>(dkdv_blocks), kWgmmaThreads,
                                        Dkdv::bytes, stream>>>(
      mq, mk, mv, mdo, stats, tinfo, kinfo, static_cast<const int*>(k_pos),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), b, sq, sk, h, hkv, hd, hd_v, scale,
      scale_log2, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_wgmma_kernel<HD, HDV><<<static_cast<unsigned>(dq_blocks), kWgmmaThreads,
                                      Dq::bytes, stream>>>(
      mq, mk, mv, mdo, stats, tinfo, kinfo, kpos, static_cast<const int*>(q_pos),
      static_cast<bf16*>(dq), b, sq, sk, h, hkv, scale, scale_log2, causal, window, hd);
  return static_cast<int>(cudaGetLastError());
}

// The "wgmma" instance that takes (hd, hd_v): its HD, 64, 128 or 192 (HDV 64, 128, 128)
int wgmma_instance(int hd, int hd_v) {
  return hd <= 64 ? 64 : hd <= 128 && hd_v <= 128 ? 128 : 192;
}

}  // namespace

// 0: the "wgmma" design takes head dims (hd, hd_v); 1: the "mma" design
extern "C" int flash_attention_bwd_design(int hd, int hd_v) {
  return hd <= kWgmmaMaxHeadDim && hd_v <= kWgmmaMaxHeadDimV ? 0 : 1;
}

// Bytes of the scratch buffer flash_attention_bwd_launch needs (256-byte aligned)
extern "C" long long flash_attention_bwd_scratch_bytes(int b, int sq, int sk, int h, int hd,
                                                       int hd_v) {
  if (flash_attention_bwd_design(hd, hd_v) == 0) return Scratch(b, sq, sk, h).bytes;
  return 4LL * b * h * sq;  // D (b, h, sq)
}

// The design's shape at head dims (hd, hd_v): {design, keys per dK/dV block,
// queries per tile it walks, its stages, rows per dQ block, keys per tile it
// walks, its stages, threads per block, the instance's HD and HDV}
extern "C" void flash_attention_bwd_config(int hd, int hd_v, int* out) {
  if (flash_attention_bwd_design(hd, hd_v) == 0) {
    const int inst = wgmma_instance(hd, hd_v);
    const int stages = inst == 64    ? dq_stages<64, 64>()
                       : inst == 128 ? dq_stages<128, 128>()
                                     : dq_stages<192, 128>();
    const int cfg[10] = {0,       kDkdvKeys, kRowTile,      kDkdvStages, kDqRows, kKeyTile,
                         stages, kWgmmaThreads, inst, inst == 64 ? 64 : 128};
    for (int i = 0; i < 10; ++i) out[i] = cfg[i];
  } else {
    const int cfg[10] = {1, kTile, kTile, 1, kTile, kTile, 1, kTcThreads, kMaxHeadDim, kMaxHeadDim};
    for (int i = 0; i < 10; ++i) out[i] = cfg[i];
  }
}

// q, dq: (b, sq, h, hd); o, dout: (b, sq, h, hd_v); k, dk: (b, sk, hkv, hd);
// v, dv: (b, sk, hkv, hd_v); bf16, contiguous, 16-byte aligned, on the
// current device; lse (b, h, sq) f32; scratch:
// flash_attention_bwd_scratch_bytes(...) bytes, 256-byte aligned, written
// here; q_pos (sq,) and k_pos (sk,) int32.  Launches the design's three
// kernels on `stream`; returns 0, a cudaError_t of the launches, or an error
// of the tensor maps (flash_attention_bwd_error_string).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          const void* q_pos, const void* k_pos, void* dq,
                                          void* dk, void* dv, void* scratch, int b, int sq,
                                          int sk, int h, int hkv, int hd, int hd_v, float scale,
                                          int causal, int window, void* stream) {
  if (b < 1 || b > 65535 || sq < 1 || sk < 1 || hkv < 1 || hkv > 65535 || h < hkv || h % hkv ||
      hd > kMaxHeadDim || hd % 16 || hd_v < 16 || hd_v > hd || hd_v % 16 ||
      static_cast<long long>(sq) * (h / hkv) > (1LL << 31) - kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flash_attention_bwd_design(hd, hd_v) == 0) {
    switch (wgmma_instance(hd, hd_v)) {
      case 64:
        return wgmma_launch<64, 64>(q, k, v, o, dout, lse, q_pos, k_pos, dq, dk, dv, scratch, b,
                                    sq, sk, h, hkv, hd, hd_v, scale, causal, window, s);
      case 128:
        return wgmma_launch<128, 128>(q, k, v, o, dout, lse, q_pos, k_pos, dq, dk, dv, scratch, b,
                                      sq, sk, h, hkv, hd, hd_v, scale, causal, window, s);
      default:
        return wgmma_launch<192, 128>(q, k, v, o, dout, lse, q_pos, k_pos, dq, dk, dv, scratch, b,
                                      sq, sk, h, hkv, hd, hd_v, scale, causal, window, s);
    }
  }
  float* delta = static_cast<float*>(scratch);
  const int err = prep_launch(o, dout, lse, q_pos, k_pos, delta, nullptr, b, sq, sk, h, hd_v, s);
  if (err) return err;
  return mma_launch<256>(q, k, v, dout, lse, delta, q_pos, k_pos, dq, dk, dv, b, sq, sk, h, hkv,
                         hd, hd_v, scale, causal, window, s);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return launch_error_string(err);
}
