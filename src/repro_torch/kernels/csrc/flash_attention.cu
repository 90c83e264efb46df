// Fused attention with online softmax on Hopper, f32 accumulation, GQA,
// explicit positions:
//
//   o[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h / g],
//   s[i, j] = scale * q[b, i, h] . k[b, j, h / g]   if visible(i, j), else -1e30,
//
// q and k have head dim hd, v and o head dim hd_v <= hd (MLA: 192 and 128).
//   visible(i, j) = (!causal || qpos[i] >= kpos[j]) && (window == 0 || qpos[i] - kpos[j] < window)
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_fused (body `_kernel`), widened to the contract of
// repro/models/layers.py::flash_attention and ::decode_attention, which the
// models call: positions are explicit (a one-token decode against a cache is
// Sq = 1 with qpos = [pos]; a ring buffer permutes kpos), a sliding window,
// and any Sq and Sk.  Masked scores are -1e30, as in the JAX package, so a
// row that sees no key averages v over all Sk keys there and here alike.
// Keys past Sk are left out entirely (score -inf): no padding of Sk.
//
// The work is 2 * (hd + hd_v) operations per visible (query, key) pair and
// head; the bytes are Q, O, and K/V of the slots some query sees.  Three
// kernels, chosen by the wrapper (kernels/flash_attention.py::choose_variant)
// from dtype and shape, plus the split's combine; "tile" has two designs,
// chosen by flash_attention_tile_design from (dtype, hd, hd_v, Sq):
//
//  * "tile" (bf16, hd % 16 == 0, Sq * g >= 64 (query, head) rows of a kv
//    head).  Bound by operations (989 TFLOP/s bf16 dense).
//    - attn_fwd_wgmma_kernel, the "wgmma" design (hd <= 192, hd_v <= 128,
//      Sq >= 64: every training and prefill shape of the repo).  One block
//      per (128-query tile, head, batch) on a 1-D grid, the latest queries
//      (most keys) first; 384 threads.  The producer warpgroup drops to 24
//      registers (setmaxnreg); its first warp loads the block's Q once by TMA
//      (4-D tensor maps {width, heads, seq, batch}, 64 x 64 boxes, 128-byte
//      swizzle, zeros past Sq and the width), then walks the key tiles of
//      kFwdKeys (128): each tile's position range from k_pos (four ints a
//      lane, a shuffle reduction), the tiles some pair of the block may see
//      kept, each streamed into a ring of fwd_stages() stages (4 at (64, 64),
//      2 at (128, 128) and (192, 128), all that fit in 227 KB) whose K and V
//      halves have full and empty mbarriers of their own: K with the tile's
//      positions (stored by the warp) and V by TMA at their own widths.  The
//      two consumer warpgroups (240 registers) own 64 rows each, the M of
//      wgmma: S = Q K^T by ss-wgmma m64n128 from K-major descriptors, the
//      online softmax in f32 registers (base 2, the scale folded into one
//      FFMA, ex2.approx), P rounded to bf16 A fragments in registers and O +=
//      P V by rs-wgmma m64nHDVk16 with V through the descriptor's transpose
//      bit.  Tile t's S is issued before tile t-1's P V, so the tensor cores
//      run P V while tile t's softmax runs; a stage's K half is freed after
//      the tile's softmax, its V half after the tile's P V, so the next
//      tile's K loads during this one's softmax even with two stages.  A
//      warpgroup skips a tile its rows cannot see (first finishing the P V it
//      holds, so the ring never waits on a stage it holds); a tile all of
//      whose pairs are visible and inside Sk takes the softmax without
//      masks.  Instances
//      (HD, HDV) (64, 64), (128, 128), (192, 128) take any runtime hd <= HD,
//      hd_v <= HDV (the tensor maps zero-fill past them): hd 160 runs on
//      (192, 128).  No atomics and no split over keys: the same bits on
//      every run.  scripts/attn_fwd_ab.py --variant times, in turns, two
//      alternatives it writes as text patches of this source: keys64 (m64n64
//      S, 64-key tiles, four stages everywhere) and pingpong (the two
//      warpgroups take turns on named barriers to issue their products).
//    - attn_tile_kernel, the "mma" design (hd 256, hd_v above 128, or
//      Sq < 64: a prefill of short prompts at a large GQA group).  Rows are
//      (query, head-in-group) pairs of one kv head, row = qi * g + gi, so the
//      g query heads that share a kv head share every K/V tile staged; a
//      block owns 64 rows, 16 per warp; S = Q K^T and O += P V run with
//      mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands from shared
//      memory by ldmatrix (V transposed), P from the S registers as the A
//      operand.  K/V tiles of 64 keys go in by 16-byte cp.async into
//      XOR-swizzled rows (conflict-free ldmatrix), two stages.  Templated on
//      (64, 64), (128, 128), (192, 128) and (256, 256), the runtime widths
//      zero-padded to them (cp.async zero-fill).  The heaviest row tiles
//      (latest queries) are scheduled first.
//  * attn_split_kernel ("split": bf16, hd % 16 == 0, Sq * g < 64: decode).
//    Bound by the bytes of the cache (about 8 flop per K/V byte at g = 8).
//    Flash-decoding: grid (kv head, split, batch x 16-row group); each block
//    takes all g heads of its kv head over one contiguous run of at most four
//    tiles (the wrapper picks the split count from Sk and the SM count), its
//    four warps 16 keys of each 64-key tile apiece, K/V double-buffered by
//    16-byte cp.async.  The tiles' skip states are worked out up front, one
//    per warp, so the loop waits only on K/V; a wholly hidden split exits at
//    once.  The warps' partials merge in shared memory.  With one split the
//    block writes O; otherwise it writes (m, l, acc) in f32 to scratch and
//    attn_combine_kernel merges the splits by the log-sum-exp rule in a fixed
//    order, so the result is the same from run to run.  V is staged at
//    hd_v in tiles of the q/k instance's width (zeros past hd_v), O and the
//    per-split accumulators are written at hd_v.
//  * flash_attention_kernel ("general": f32, or hd not a multiple of 16).
//    The first version of this kernel, kept for what the tensor-core tiles
//    do not take: its dot products run on the CUDA cores in f32 (TF32 tensor
//    cores would break the 1e-4 tolerance against the JAX package in f32).
//    hd_v is a runtime width beside hd.
//
// Tile skipping (tile and split): a K/V tile is skipped when every pair in
// it is hidden -- causal and min kpos > max qpos of the block, or a window
// and max kpos <= min qpos - window -- worked out from the tile's positions,
// not its indices, since a ring buffer permutes kpos.  A tile that every row
// sees in full skips the mask arithmetic.  Skipping is exact for every row
// that sees some key (exp(-1e30 - m) is 0 in f32); a row that sees no key is
// recognised by its running max staying at -1e30 and given the mean of V
// over all Sk keys, as the unskipped softmax of equal scores would give.
//
// The row log-sum-exp (training): "tile" and "general" take an optional
// lse (B, H, Sq) f32 output, written in the epilogue from the running (m, l)
// as the natural log of sum_j exp(s[i, j]) -- the softmax statistics that
// flash_attention_bwd.cu recomputes P from.  A row that sees no key gets
// -1e30 (its weights are 1/Sk, as above).  Null on the serve path: serving's
// launches and outputs are unchanged.  "split" (decode) writes it too when
// given one, from the block's merged (m, l) with one split and from the
// combine's with several: a rank's partial attention over its shard of a
// sequence-sharded cache combines across ranks by it.
//
// ptxas (-Xptxas -v, sm_90a; chip_smoke.py prints these at build) on an H100:
//   attn_fwd_wgmma_kernel<64,64 / 128,128 / 192,128>  168 registers at launch (the
//                                   consumers raise theirs to 240), no spills
//   attn_tile_kernel<64,64 / 128,128 / 192,128 / 256,256>  174 / 213 / 218 / 255 registers,
//                                   no spills
//   attn_split_kernel<64/128/256>   96 / 126 / 200 registers, no spills, 128 B static shared
//   attn_combine_kernel             48 registers, 1 KiB static shared memory
//   flash_attention_kernel<f32/bf16> 126 registers, no spills
// Dynamic shared memory: "wgmma" fwd_smem_bytes (Q, the stages of K, V and
// positions, barriers, the mean of V): 147.8 / 163.1 / 211.1 KiB at (64, 64)
// / (128, 128) / (192, 128), one block per SM; "mma" 2 (64 HD + 128 (HD +
// HDV)) bytes (80 KiB at (128, 128), 104 KiB at (192, 128): two blocks per
// SM), split 544 * HD bytes (68 KiB at hd 128: three blocks per SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "attention_tiles.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// ---------------------------------------------------------------------------
// "general": f32, or head dims the tensor-core tiles do not take
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows per block
constexpr int kTile = 64;                     // keys per shared-memory tile
constexpr int kDPerLane = kMaxHeadDim / 32;

size_t general_smem_bytes(int hd, int hd_v) {
  return sizeof(float) * (static_cast<size_t>(kRows) * hd + kTile * (hd + 1) + kTile * hd_v +
                          kRows * kTile) +
         sizeof(int) * kTile;
}

// Each warp owns 4 rows; K/V tiles of 64 keys are converted to f32 into
// shared memory (K rows padded by one float against bank conflicts); a lane
// scores keys lane and lane + 32, then accumulates features lane, lane + 32,
// ... of P V for its rows in registers.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, T* __restrict__ o,
                       float* __restrict__ lse, int sq, int sk, int h, int hkv, int hd,
                       int hd_v, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [kRows][hd], scaled
  float* ks = qs + kRows * hd;        // [kTile][hd + 1]
  float* vs = ks + kTile * (hd + 1);  // [kTile][hd_v]
  float* ps = vs + kTile * hd_v;      // [kRows][kTile]
  int* kps = reinterpret_cast<int*>(ps + kRows * kTile);  // [kTile]

  const int g = h / hkv;
  const int rows = sq * g;
  const int row0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int e = threadIdx.x; e < kRows * hd; e += kThreads) {
    const int r = e / hd, d = e - r * hd, row = row0 + r;
    float x = 0.f;
    if (row < rows) {
      const int qi = row / g, head = kvh * g + (row - qi * g);
      x = to_f32(q[((b * sq + qi) * h + head) * hd + d]) * scale;
    }
    qs[e] = x;
  }

  int qp[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp * kRowsPerWarp + i;
    qp[i] = row < rows ? q_pos[row / g] : 0;
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPerLane; ++dd) acc[i][dd] = 0.f;
  }

  for (int t0 = 0; t0 < sk; t0 += kTile) {
    const int n = min(kTile, sk - t0);
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int e = threadIdx.x; e < n * hd; e += kThreads) {
      const int j = e / hd, d = e - j * hd;
      const long long row = (b * sk + t0 + j) * hkv + kvh;
      ks[j * (hd + 1) + d] = to_f32(k[row * hd + d]);
      if (d < hd_v) vs[j * hd_v + d] = to_f32(v[row * hd_v + d]);
    }
    for (int j = threadIdx.x; j < n; j += kThreads) kps[j] = k_pos[t0 + j];
    __syncthreads();

    float s[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.f;
    const float* ka = ks + lane * (hd + 1);
    const float* kb = ks + (lane + 32) * (hd + 1);
    const float* qw = qs + warp * kRowsPerWarp * hd;
    for (int d = 0; d < hd; ++d) {
      const float k0 = ka[d], k1 = kb[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float qv = qw[i * hd + d];
        s[i][0] = fmaf(qv, k0, s[i][0]);
        s[i][1] = fmaf(qv, k1, s[i][1]);
      }
    }

    float* pw = ps + warp * kRowsPerWarp * kTile;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        if (j >= n) {
          s[i][c] = -INFINITY;  // past Sk: not a key at all
        } else {
          const int kp = kps[j];
          const bool visible = (!causal || qp[i] >= kp) && (window <= 0 || qp[i] - kp < window);
          if (!visible) s[i][c] = kMasked;
        }
      }
      const float m_new = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p0 + p1);
      m[i] = m_new;
      pw[i * kTile + lane] = p0;
      pw[i * kTile + lane + 32] = p1;
#pragma unroll
      for (int dd = 0; dd < kDPerLane; ++dd) acc[i][dd] *= corr;
    }
    __syncwarp();

    for (int j = 0; j < n; ++j) {
      const float* vrow = vs + j * hd_v;
      float vv[kDPerLane];
#pragma unroll
      for (int dd = 0; dd < kDPerLane; ++dd) {
        const int d = lane + 32 * dd;
        vv[dd] = d < hd_v ? vrow[d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = pw[i * kTile + j];
#pragma unroll
        for (int dd = 0; dd < kDPerLane; ++dd) acc[i][dd] = fmaf(pj, vv[dd], acc[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp * kRowsPerWarp + i;
    if (row >= rows) continue;
    const int qi = row / g, head = kvh * g + (row - qi * g);
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && lane == 0)  // m and l are the same in every lane
      lse[(b * h + head) * sq + qi] = m[i] == kMasked ? kMasked : m[i] + logf(l[i]);
    T* orow = o + ((b * sq + qi) * h + head) * hd_v;
#pragma unroll
    for (int dd = 0; dd < kDPerLane; ++dd) {
      const int d = lane + 32 * dd;
      if (d < hd_v) orow[d] = from_f32<T>(acc[i][dd] / denom);
    }
  }
}

template <typename T>
int general_launch(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* k_pos, void* o, void* lse, int b, int sq, int sk, int h, int hkv,
                   int hd, int hd_v, float scale, int causal, int window, cudaStream_t stream) {
  static int smem_set = 0;
  const size_t smem = general_smem_bytes(hd, hd_v);
  cudaError_t err = allow_smem(flash_attention_kernel<T>, smem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(sq) * (h / hkv);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), hkv, b);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), static_cast<T*>(o),
      static_cast<float*>(lse), sq, sk, h, hkv, hd, hd_v, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// tensor-core tiles: shared by "tile" ("mma") and "split"
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;   // keys per K/V tile
constexpr int kSplitRows = 16;            // rows of a "split" block

// What a K/V tile holds for the rows with positions in [qmin, qmax]:
// 0 every pair hidden, 1 some hidden, 2 every pair visible.  Computed by each
// warp alone (the same answer in every warp), from the tile's positions.
__device__ __forceinline__ int tile_state(const int* __restrict__ k_pos, int t0, int sk,
                                          int qmin, int qmax, int causal, int window) {
  if (!causal && window <= 0) return 2;
  const int lane = threadIdx.x & 31;
  int kmin = INT_MAX, kmax = INT_MIN;
  const int end = min(sk, t0 + kKeys);
  for (int j = t0 + lane; j < end; j += 32) {
    const int p = __ldg(k_pos + j);
    kmin = min(kmin, p);
    kmax = max(kmax, p);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
  }
  return tile_state_of(kmin, kmax, qmin, qmax, causal, window);
}

// The first tile at or after t in [t, end) with a visible pair; end if none.
__device__ __forceinline__ int next_live(const int* __restrict__ k_pos, int t, int end, int sk,
                                         int qmin, int qmax, int causal, int window, int* state) {
  for (; t < end; ++t) {
    *state = tile_state(k_pos, t * kKeys, sk, qmin, qmax, causal, window);
    if (*state) break;
  }
  return t;
}

// min and max query position over rows [row0, row0 + n) of the block, in every warp
__device__ __forceinline__ void q_range(const int* __restrict__ q_pos, int row0, int n, int rows,
                                        int g, int* qmin, int* qmax) {
  const int lane = threadIdx.x & 31;
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = lane; r < n; r += 32) {
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

// Online-softmax state of one warp's 16 rows; this thread's rows are grp and
// grp + 8 (index 0 and 1).
template <int HD>
struct RowState {
  float m[2], l[2];      // running max (base 2, scaled) and this thread's part of the sum
  float acc[HD / 8][4];  // O: n-tile of 8 features, (grp, 2 tig + {0,1}), (grp + 8, ...)
  int qp[2];             // query positions of the two rows

  __device__ __forceinline__ void init() {
    m[0] = m[1] = kMasked;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  // Scale, mask and fold NT 8-key n-tiles of scores s (keys key0 + 8 n + ...)
  // into the state; leaves P (unnormalised, f32) in s.
  template <int NT>
  __device__ __forceinline__ void softmax(float (&s)[NT][4], int key0, int state, int sk,
                                          const int* __restrict__ k_pos, float scale_log2,
                                          int causal, int window) {
    const int tig = threadIdx.x & 3;
    const bool tail = key0 + NT * 8 > sk;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (state != 2 || tail) {
          const int key = key0 + n * 8 + tig * 2 + (e & 1);
          if (key >= sk) {
            x = -INFINITY;  // past Sk: not a key at all
          } else if (state != 2) {
            const int kp = __ldg(k_pos + key), qp_ = qp[e >> 1];
            const bool vis = (!causal || qp_ >= kp) &&
                             (window <= 0 || static_cast<long long>(qp_) - kp < window);
            if (!vis) x = kMasked;
          }
        }
        s[n][e] = x;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float corr[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    }
    l[0] = l[0] * corr[0] + sum[0];
    l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
  }

  // The row sums over the quad of threads that share the rows.
  __device__ __forceinline__ void reduce_l() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }
};

// The mean of V (head dim hd_v) over all sk keys of (b, kvh), feature by
// feature, into meanv[hd_v] (f32, shared): the output of a row that sees no
// key.  Thread `tid` of the `nthreads` that compute it takes features tid,
// tid + nthreads, ...
__device__ void mean_v(const bf16* __restrict__ v, long long b, int sk, int hkv, int kvh, int hd_v,
                       float* meanv, int tid, int nthreads) {
  constexpr int kLanes = 8;  // independent sums: eight loads in flight, added in a fixed order
  const long long stride = static_cast<long long>(hkv) * hd_v;
  for (int d = tid; d < hd_v; d += nthreads) {
    const bf16* p = v + (b * sk * hkv + kvh) * hd_v + d;
    float sum[kLanes] = {};
    int j = 0;
    for (; j + kLanes <= sk; j += kLanes) {
#pragma unroll
      for (int u = 0; u < kLanes; ++u) sum[u] += __bfloat162float(p[(j + u) * stride]);
    }
    for (int u = 0; j < sk; ++j, ++u) sum[u] += __bfloat162float(p[j * stride]);
    float total = 0.f;
#pragma unroll
    for (int u = 0; u < kLanes; ++u) total += sum[u];
    meanv[d] = total / static_cast<float>(sk);
  }
}

// Output row `row` = (query, head-in-group) of kv head kvh in a (b, sq, h, hd_v) tensor
__device__ __forceinline__ bf16* out_row(bf16* o, long long b, int row, int kvh, int sq, int h,
                                         int hd_v, int g) {
  const int qi = row / g, head = kvh * g + (row - qi * g);
  return o + ((b * sq + qi) * h + head) * hd_v;
}

// ---------------------------------------------------------------------------
// "tile", "mma" design: many (query, head) rows of a kv head
// ---------------------------------------------------------------------------

constexpr int kTileRows = 16 * kTcWarps;  // rows of a "tile" block

template <int HD, int HDV>
constexpr size_t tile_smem_bytes() {
  return 2 * (HD * kTileRows + 2 * kKeys * (HD + HDV));  // Q, then K and V in two stages
}

// HD: the q/k head dim of the shared-memory tiles, HDV: v's; hd <= HD and
// hd_v <= HDV at run time, zeros past them.
template <int HD, int HDV>
__global__ void __launch_bounds__(kTcThreads, 2)
attn_tile_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ k_pos, bf16* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int h, int hkv, int hd, int hd_v, float scale_log2, int causal,
                 int window) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t qs = smem_u32(smem_raw);
  const uint32_t kv0 = qs + 2 * HD * kTileRows;
  constexpr uint32_t kStageK = 2 * HD * kKeys;             // bytes of one K tile
  constexpr uint32_t kStage = kStageK + 2 * HDV * kKeys;  // a stage: K, then V

  const int g = h / hkv;
  const int rows = sq * g;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTileRows;  // latest queries first
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, grp = lane >> 2;

  stage_rows<HD, kTileRows>(qs, hd, q, [&](int r) -> const bf16* {
    const int row = row0 + r;
    if (row >= rows) return nullptr;
    const int qi = row / g, head = kvh * g + (row - qi * g);
    return q + ((b * sq + qi) * h + head) * hd;
  });
  cp_async_commit();
  int qmin, qmax;
  q_range(q_pos, row0, kTileRows, rows, g, &qmin, &qmax);

  auto stage_kv = [&](int t, int st) {
    const int t0 = t * kKeys;
    auto src = [&](const bf16* base, int width) {
      return [=](int r) -> const bf16* {
        const int j = t0 + r;
        return j < sk ? base + ((b * sk + j) * hkv + kvh) * width : nullptr;
      };
    };
    stage_rows<HD, kKeys>(kv0 + st * kStage, hd, k, src(k, hd));
    stage_rows<HDV, kKeys>(kv0 + st * kStage + kStageK, hd_v, v, src(v, hd_v));
  };

  RowState<HDV> rs;
  rs.init();
  const int ra = row0 + warp * 16 + grp, rb = ra + 8;
  rs.qp[0] = ra < rows ? __ldg(q_pos + ra / g) : 0;
  rs.qp[1] = rb < rows ? __ldg(q_pos + rb / g) : 0;

  const int ntiles = (sk + kKeys - 1) / kKeys;
  int state = 0;
  int t = next_live(k_pos, 0, ntiles, sk, qmin, qmax, causal, window, &state);
  if (t < ntiles) stage_kv(t, 0);
  cp_async_commit();
  int st = 0;
  while (t < ntiles) {
    int state_next = 0;
    const int tn = next_live(k_pos, t + 1, ntiles, sk, qmin, qmax, causal, window, &state_next);
    if (tn < ntiles) stage_kv(tn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[kKeys / 8][4];
    qk<HD, kKeys / 8>(s, qs, warp * 16, kv0 + st * kStage, 0);
    rs.softmax(s, t * kKeys, state, sk, k_pos, scale_log2, causal, window);
    pv<HDV, kKeys / 8>(rs.acc, s, kv0 + st * kStage + kStageK, 0);
    __syncthreads();  // this stage is free for the load after next
    t = tn;
    state = state_next;
    st ^= 1;
  }
  cp_async_wait<0>();

  rs.reduce_l();
  const bool blind[2] = {rs.m[0] == kMasked, rs.m[1] == kMasked};  // rows that see no key
  float* meanv = reinterpret_cast<float*>(smem_raw);  // Q's room, no longer read
  if (__syncthreads_or((ra < rows && blind[0]) || (rb < rows && blind[1]))) {
    mean_v(v, b, sk, hkv, kvh, hd_v, meanv, threadIdx.x, blockDim.x);
    __syncthreads();
  }
  const int tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? rb : ra;
    if (row >= rows) continue;
    const float inv = blind[i] ? 0.f : 1.f / rs.l[i];
    if (lse != nullptr && tig == 0) {  // the quad shares m and (reduced) l: one writes
      const int qi = row / g, head = kvh * g + (row - qi * g);
      lse[(b * h + head) * sq + qi] = blind[i] ? kMasked : (rs.m[i] + log2f(rs.l[i])) * kLn2;
    }
    bf16* orow = out_row(o, b, row, kvh, sq, h, hd_v, g);
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n) {
      const int d = n * 8 + tig * 2;
      if (d < hd_v) {
        const float x0 = blind[i] ? meanv[d] : rs.acc[n][2 * i] * inv;
        const float x1 = blind[i] ? meanv[d + 1] : rs.acc[n][2 * i + 1] * inv;
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <int HD, int HDV>
int tile_launch(const void* q, const void* k, const void* v, const void* q_pos, const void* k_pos,
                void* o, void* lse, int b, int sq, int sk, int h, int hkv, int hd, int hd_v,
                float scale, int causal, int window, cudaStream_t stream) {
  static int smem_set = 0;
  constexpr size_t smem = tile_smem_bytes<HD, HDV>();
  cudaError_t err = allow_smem(attn_tile_kernel<HD, HDV>, smem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(sq) * (h / hkv);
  const dim3 grid(static_cast<unsigned>((rows + kTileRows - 1) / kTileRows), hkv, b);
  attn_tile_kernel<HD, HDV><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), static_cast<bf16*>(o),
      static_cast<float*>(lse), sq, sk, h, hkv, hd, hd_v, scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// "tile", "wgmma" design: one block per (128-query tile, head, batch)
// ---------------------------------------------------------------------------

constexpr int kWgmmaMaxHeadDim = 192;   // up to here (and hd_v up to the next) "wgmma" ...
constexpr int kWgmmaMaxHeadDimV = 128;
constexpr int kWgmmaMinQueries = 64;    // ... at Sq of a warpgroup's rows or more; else "mma"
constexpr int kFwdRows = 128;           // queries per block: two consumer warpgroups of 64
constexpr int kFwdKeys = 128;           // keys per K/V tile and stage: the N of S's wgmma
constexpr int kFwdStages = 4;  // ring of K / V tiles, where it fits (fwd_stages)
constexpr int kWgThreads = 128;         // a warpgroup
constexpr int kWgmmaThreads = 3 * kWgThreads;  // two consumer warpgroups, one producer
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint32_t kMaxSmemBytes = 232448;  // dynamic shared memory a block may use on an H100

// Bytes of the block's shared memory with a ring of `stages` K / V stages:
// Q, the stages (K, V, their kFwdKeys positions, full and empty mbarriers of
// K and of V, the stage's info), Q's mbarrier, each consumer warpgroup's mean
// of V, 1 KB of alignment slack
template <int HD, int HDV>
constexpr uint32_t fwd_smem_bytes(int stages) {
  return tile_bytes<HD>(kFwdRows) +
         stages * (tile_bytes<HD>(kFwdKeys) + tile_bytes<HDV>(kFwdKeys) + kFwdKeys * 4 + 32 + 32) +
         8 + 2 * HDV * 4 + 1024;
}
// The ring's stages: kFwdStages where they fit, fewer where not
template <int HD, int HDV>
constexpr int fwd_stages() {
  int s = kFwdStages;
  while (s > 1 && fwd_smem_bytes<HD, HDV>(s) > kMaxSmemBytes) --s;
  return s;
}

template <int HD, int HDV>
struct FwdSmem {
  static constexpr int stages = fwd_stages<HD, HDV>();
  static constexpr uint32_t q = 0;
  static constexpr uint32_t stage = q + tile_bytes<HD>(kFwdRows);  // K then V, per stage
  static constexpr uint32_t stage_bytes = tile_bytes<HD>(kFwdKeys) + tile_bytes<HDV>(kFwdKeys);
  static constexpr uint32_t kpos = stage + stages * stage_bytes;  // the stage's key positions
  static constexpr uint32_t full_k = kpos + stages * kFwdKeys * 4;  // K, positions, info
  static constexpr uint32_t full_v = full_k + 8 * stages;
  static constexpr uint32_t empty_k = full_v + 8 * stages;
  static constexpr uint32_t empty_v = empty_k + 8 * stages;
  static constexpr uint32_t q_bar = empty_v + 8 * stages;
  static constexpr uint32_t info = q_bar + 8;  // int[8] per stage: kt, kmin, kmax
  static constexpr uint32_t meanv = info + 32 * stages;  // float[2][HDV]
  static constexpr uint32_t bytes = meanv + 2 * HDV * 4 + 1024;
  static_assert(bytes == fwd_smem_bytes<HD, HDV>(stages) && bytes <= kMaxSmemBytes, "fwd block");
  static_assert(stages >= 2, "a consumer holds a stage until the next tile arrives");
};

// Whether any of the warpgroup's 128 threads passes `pred` (named barrier `id`)
__device__ __forceinline__ bool warpgroup_any(int id, bool pred) {
  uint32_t out;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.or.pred p, %2, 128, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(out)
      : "r"(static_cast<uint32_t>(pred)), "r"(id)
      : "memory");
  return out != 0;
}
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// HD: the width of the Q and K tiles, HDV: of V (and O); hd <= HD and hd_v <=
// HDV at run time, the tensor maps zero-fill past them.  Warpgroups 0 and 1
// consume (64 rows each: the M of wgmma), warpgroup 2's first warp produces.
template <int HD, int HDV>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const bf16* __restrict__ v,
                      const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                      bf16* __restrict__ o, float* __restrict__ lse, int b_count, int sq, int sk,
                      int h, int hkv, int hd_v, float scale_log2, int causal, int window) {
  using L = FwdSmem<HD, HDV>;
  extern __shared__ __align__(128) unsigned char smem_raw[];  // aligned to 1024 below
  const uint32_t base = align1024(smem_u32(smem_raw));
  unsigned char* gbase = smem_raw + (base - smem_u32(smem_raw));
  const int g = h / hkv, nkt = (sk + kFwdKeys - 1) / kFwdKeys;
  const int nqb = (sq + kFwdRows - 1) / kFwdRows;
  // 1-D grid, the query tile slowest: the latest queries (most keys) first
  const int per = h * b_count;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x / per);
  const int head = blockIdx.x % per % h, b = blockIdx.x % per / h, kvh = head / g;
  const int q0 = qb * kFwdRows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::stages; ++s) {
      mbar_init(base + L::full_k + 8 * s, 32);  // every producer lane (its positions)
      mbar_init(base + L::full_v + 8 * s, 1);
      mbar_init(base + L::empty_k + 8 * s, 2 * kWgThreads / 32);  // one arrival per consumer warp
      mbar_init(base + L::empty_v + 8 * s, 2 * kWgThreads / 32);
    }
    mbar_init(base + L::q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWgThreads) {  // ---- producer warpgroup ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 2 * kWgThreads + 32) {  // one warp
      const int lane = threadIdx.x & 31;
      int qmin, qmax;  // the block's queries
      q_range(q_pos, q0, kFwdRows, sq, 1, &qmin, &qmax);
      if (lane == 0) {
        mbar_expect_tx(base + L::q_bar, tile_bytes<HD>(kFwdRows));
        load_rows<HD>(base + L::q, kFwdRows, 0, &map_q, base + L::q_bar, head, q0, 2, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < nkt; ++t) {  // keep the tiles some pair of the block sees
        constexpr int kPer = kFwdKeys / 32;  // positions a lane
        int p[kPer], kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int j = t * kFwdKeys + 32 * i + lane;
          p[i] = j < sk ? __ldg(k_pos + j) : 0;
          if (j < sk) kmin = min(kmin, p[i]), kmax = max(kmax, p[i]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
          kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
        }
        if (tile_state_of(kmin, kmax, qmin, qmax, causal, window) == 0) continue;
        // K with its positions and info, then V, each into its half of the stage once
        // the consumers freed it (K after the tile's softmax, V after its P V)
        const uint32_t ks = base + L::stage + stage * L::stage_bytes;
        const int n = kFwdKeys / kBoxRows;
        mbar_wait(base + L::empty_k + 8 * stage, phase ^ 1);
        int* kp = reinterpret_cast<int*>(gbase + L::kpos) + stage * kFwdKeys;
#pragma unroll
        for (int i = 0; i < kPer; ++i) kp[32 * i + lane] = p[i];
        const uint32_t full_k = base + L::full_k + 8 * stage;
        if (lane == 0) {
          int* info = reinterpret_cast<int*>(gbase + L::info) + 8 * stage;
          info[0] = t;
          info[1] = kmin;
          info[2] = kmax;
          mbar_expect_tx(full_k, tile_bytes<HD>(kFwdKeys));
          load_rows<HD>(ks, kFwdKeys, 0, &map_k, full_k, kvh, t * kFwdKeys, n, b);
        } else {
          mbar_arrive(full_k);
        }
        mbar_wait(base + L::empty_v + 8 * stage, phase ^ 1);
        if (lane == 0) {
          const uint32_t full_v = base + L::full_v + 8 * stage;
          mbar_expect_tx(full_v, tile_bytes<HDV>(kFwdKeys));
          load_rows<HDV>(ks + tile_bytes<HD>(kFwdKeys), kFwdKeys, 0, &map_v, full_v, kvh,
                         t * kFwdKeys, n, b);
        }
        if (++stage == L::stages) stage = 0, phase ^= 1;
      }
      // the end of the walk
      mbar_wait(base + L::empty_k + 8 * stage, phase ^ 1);
      if (lane == 0) reinterpret_cast<int*>(gbase + L::info)[8 * stage] = -1;
      mbar_arrive(base + L::full_k + 8 * stage);
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
    const int warp = tid >> 5, lane = tid & 31, tig = lane & 3;
    const int row0 = q0 + wg * 64;
    const bool has_rows = row0 < sq;
    const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8 of the 64
    const int row[2] = {row0 + r0, row0 + r0 + 8};
    const int qp[2] = {row[0] < sq ? __ldg(q_pos + row[0]) : 0,
                       row[1] < sq ? __ldg(q_pos + row[1]) : 0};
    int qmin, qmax;  // the warpgroup's queries (every warp alike)
    q_range(q_pos, row0, 64, sq, 1, &qmin, &qmax);
    float acc[HDV / 2];  // O: 64 rows x HDV, f32
#pragma unroll
    for (int i = 0; i < HDV / 2; ++i) acc[i] = 0.f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // running max (base 2, scaled), sum
    uint32_t pa[kFwdKeys / 16][4] = {};  // P of the previous tile, bf16, until its P V is issued
    mbar_wait(base + L::q_bar, 0);
    const uint32_t q_rows = base + L::q + wg * 64 * kHalfRowBytes;
    constexpr uint32_t q_half = kFwdRows * kHalfRowBytes, key_half = kFwdKeys * kHalfRowBytes;
    auto v_tile = [&](int st) {
      return base + L::stage + st * L::stage_bytes + tile_bytes<HD>(kFwdKeys);
    };
    auto release = [&](uint32_t empty, int st) {
      __syncwarp();
      if (lane == 0) mbar_arrive(base + empty + 8 * st);
    };

    // Tile t's S = Q K^T is issued before tile t-1's O += P V, so that the
    // tensor cores run P V while the softmax of tile t runs on the CUDA cores.
    // A stage's K half (and its positions) is released after the tile's
    // softmax, its V half once the tile's P V is done, before the next wait
    // on the ring: a tile this warpgroup skips flushes the held P V first, so
    // the held V is always the previous entry's and the ring never waits on
    // it (with two stages, or after a run of skipped tiles).
    int pend = -1;  // the stage whose P (in pa) still has to go through P V
    int stage = 0;
    uint32_t phase = 0;
    for (;; (++stage == L::stages) ? (stage = 0, phase ^= 1) : 0) {
      mbar_wait(base + L::full_k + 8 * stage, phase);
      const int* info = reinterpret_cast<const int*>(gbase + L::info) + 8 * stage;
      const int kt = info[0];
      if (kt < 0) break;
      // whether some pair of this warpgroup's rows sees the tile
      const int state = has_rows ? tile_state_of(info[1], info[2], qmin, qmax, causal, window) : 0;
      const uint32_t ks = base + L::stage + stage * L::stage_bytes;
      float s[kFwdKeys / 2];
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      if (state != 0) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {  // S = Q K^T: rows x keys
          const uint32_t off = (kk & 3) * 32;
          wgmma_ss_n128(s, desc_kmajor(q_rows + (kk >> 2) * q_half + off),
                        desc_kmajor(ks + (kk >> 2) * key_half + off), kk > 0);
        }
        wgmma_commit();
      }
      if (pend >= 0) {
#pragma unroll
        for (int kk = 0; kk < kFwdKeys / 16; ++kk)  // O += P V of the previous tile: 16 keys a step
          wgmma_rs_tb<HDV>(acc, pa[kk], desc_mnmajor(v_tile(pend) + kk * 16 * kHalfRowBytes,
                                                     key_half));
        wgmma_commit();
      }
      if (state == 0) {  // a skipped tile: the previous tile's P V done, both stages free
        release(L::empty_k, stage);
        if (pend >= 0) {
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(pa);
          release(L::empty_v, pend);
          pend = -1;
        }
        mbar_wait(base + L::full_v + 8 * stage, phase);  // V's copy is done before it is freed
        release(L::empty_v, stage);
        continue;
      }
      if (pend >= 0)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence_regs(s);
      // mask and fold the scores into the running max and sum; P in s.  A tile
      // whose pairs are all visible and inside Sk keeps s unscaled (max and
      // exp2's argument by one FFMA each); the others scale it and mask
      const int t0 = kt * kFwdKeys;
      const bool plain = state == 2 && t0 + kFwdKeys <= sk && scale_log2 > 0.f;
      if (!plain) {
        const int* kp = reinterpret_cast<const int*>(gbase + L::kpos) + stage * kFwdKeys;
#pragma unroll
        for (int j = 0; j < kFwdKeys / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * tig + (e & 1);
            float x = s[4 * j + e] * scale_log2;
            if (t0 + col >= sk)
              x = -INFINITY;  // past Sk: not a key at all
            else if (state != 2 && !visible(qp[e >> 1], kp[col], causal, window))
              x = kMasked;
            s[4 * j + e] = x;
          }
        }
      }
      const float sc = plain ? scale_log2 : 1.f;  // s * sc is the scaled score
      float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};  // two chains a row
#pragma unroll
      for (int j = 0; j < kFwdKeys / 8; ++j) {
        mx[0][j & 1] = fmaxf(mx[0][j & 1], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1][j & 1] = fmaxf(mx[1][j & 1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = fmaxf(mx[i][0], mx[i][1]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        x = fmaxf(m[i], x * sc);
        corr[i] = fast_exp2(m[i] - x);
        m[i] = x;
      }
      float sum[2][2] = {};
#pragma unroll
      for (int i = 0; i < kFwdKeys / 2; ++i) {
        s[i] = fast_exp2(fmaf(s[i], sc, -m[(i >> 1) & 1]));
        sum[(i >> 1) & 1][(i >> 2) & 1] += s[i];
      }
      release(L::empty_k, stage);  // K and the positions are read
      l[0] = l[0] * corr[0] + (sum[0][0] + sum[0][1]);
      l[1] = l[1] * corr[1] + (sum[1][0] + sum[1][1]);
      if (pend >= 0) {  // the previous tile's P V is done: its V is free
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        release(L::empty_v, pend);
      }
#pragma unroll
      for (int i = 0; i < HDV / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      pack_a(pa, s);
      mbar_wait(base + L::full_v + 8 * stage, phase);  // V's copy, before its P V is issued
      pend = stage;
    }
    if (pend >= 0) {  // the last tile's P V
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk)
        wgmma_rs_tb<HDV>(acc, pa[kk], desc_mnmajor(v_tile(pend) + kk * 16 * kHalfRowBytes,
                                                   key_half));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(L::empty_v, pend);
    }

    if (has_rows) {  // the epilogue (a warpgroup's rows all past Sq write nothing)
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the row sums over the quad that shares the row
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      }
      const bool blind[2] = {m[0] == kMasked, m[1] == kMasked};  // rows that see no key
      float* meanv = reinterpret_cast<float*>(gbase + L::meanv) + wg * HDV;
      if (warpgroup_any(1 + wg, (row[0] < sq && blind[0]) || (row[1] < sq && blind[1]))) {
        mean_v(v, b, sk, hkv, kvh, hd_v, meanv, tid, kWgThreads);
        warpgroup_sync(1 + wg);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (row[i] >= sq) continue;
        const long long r = (static_cast<long long>(b) * sq + row[i]) * h + head;
        if (lse != nullptr && tig == 0)  // the quad shares m and (reduced) l: one writes
          lse[(static_cast<long long>(b) * h + head) * sq + row[i]] =
              blind[i] ? kMasked : (m[i] + log2f(l[i])) * kLn2;
        const float inv = blind[i] ? 0.f : 1.f / l[i];
        bf16* orow = o + r * hd_v;
#pragma unroll
        for (int j = 0; j < HDV / 8; ++j) {
          const int d = 8 * j + 2 * tig;
          if (d < hd_v) {
            const float x0 = blind[i] ? meanv[d] : acc[4 * j + 2 * i] * inv;
            const float x1 = blind[i] ? meanv[d + 1] : acc[4 * j + 2 * i + 1] * inv;
            *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
          }
        }
      }
    }
  }
}

template <int HD, int HDV>
int fwd_wgmma_launch(const void* q, const void* k, const void* v, const void* q_pos,
                     const void* k_pos, void* o, void* lse, int b, int sq, int sk, int h, int hkv,
                     int hd, int hd_v, float scale, int causal, int window, cudaStream_t stream) {
  using L = FwdSmem<HD, HDV>;
  static int smem_set = 0;
  cudaError_t err = allow_smem(attn_fwd_wgmma_kernel<HD, HDV>, L::bytes, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq, mk, mv;  // each at its tensor's own width
  int e = encode_rows(&mq, q, hd, h, sq, b);
  if (!e) e = encode_rows(&mk, k, hd, hkv, sk, b);
  if (!e) e = encode_rows(&mv, v, hd_v, hkv, sk, b);
  if (e) return e;
  const long long blocks = static_cast<long long>((sq + kFwdRows - 1) / kFwdRows) * h * b;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  attn_fwd_wgmma_kernel<HD, HDV><<<static_cast<unsigned>(blocks), kWgmmaThreads, L::bytes,
                                   stream>>>(
      mq, mk, mv, static_cast<const bf16*>(v), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<bf16*>(o), static_cast<float*>(lse), b, sq, sk,
      h, hkv, hd_v, scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// 0: the "wgmma" design takes a "tile" call of this dtype (bf16 nonzero),
// head dims and Sq; 1: the "mma" design
int tile_design(int bf16, int hd, int hd_v, int sq) {
  return bf16 && hd % 16 == 0 && hd_v % 16 == 0 && hd <= kWgmmaMaxHeadDim &&
                 hd_v <= kWgmmaMaxHeadDimV && sq >= kWgmmaMinQueries
             ? 0
             : 1;
}

// ---------------------------------------------------------------------------
// "split": decode, split over keys, and the combine
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t split_smem_bytes() {
  return 2 * HD * (kSplitRows + 2 * 2 * kKeys);  // Q, then K and V in two stages
}

// grid (kv head, split, batch * row groups); block: rows [rg * 16, +16) of
// (b, kvh) over tiles [split * tiles_per_split, +tiles_per_split).  Warp w
// takes keys [16 w, 16 w + 16) of each 64-key tile.
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attn_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ q_pos,
                  const int* __restrict__ k_pos, bf16* __restrict__ o, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  float* __restrict__ lse, int sq, int sk, int h, int hkv, int hd, int hd_v,
                  float scale_log2, int causal, int window, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t qs = smem_u32(smem_raw);
  const uint32_t kv0 = qs + 2 * HD * kSplitRows;
  constexpr uint32_t kStage = 2 * HD * kKeys;

  const int g = h / hkv;
  const int rows = sq * g;
  const int groups = (rows + kSplitRows - 1) / kSplitRows;
  const int kvh = blockIdx.x;  // kv heads next to each other: their rows interleave in memory
  const int split = blockIdx.y, nsplit = gridDim.y;
  const long long b = blockIdx.z / groups;
  const int row0 = (blockIdx.z - b * groups) * kSplitRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, grp = lane >> 2, tig = lane & 3;

  stage_rows<HD, kSplitRows>(qs, hd, q, [&](int r) -> const bf16* {
    const int row = row0 + r;
    if (row >= rows) return nullptr;
    const int qi = row / g, head = kvh * g + (row - qi * g);
    return q + ((b * sq + qi) * h + head) * hd;
  });
  cp_async_commit();

  // The states of this split's tiles (at most one per warp), worked out before
  // any K/V load: the loop below then waits on nothing but its tiles.
  __shared__ int tile_states[kTcWarps];
  const int ntiles = (sk + kKeys - 1) / kKeys;
  const int first = split * tiles_per_split;
  const int count = min(ntiles, first + tiles_per_split) - first;
  {
    // every load first, then the reductions, so the two positions' loads overlap
    const int t0 = (first + warp) * kKeys;
    const bool mine = warp < count && (causal || window > 0);
    const int j0 = t0 + lane, j1 = j0 + 32;
    const int k0 = mine && j0 < sk ? __ldg(k_pos + j0) : INT_MAX;
    const int k1 = mine && j1 < sk && j1 < t0 + kKeys ? __ldg(k_pos + j1) : INT_MAX;
    const int qrow = row0 + (lane & 15);
    const int qv = qrow < rows ? __ldg(q_pos + qrow / g) : INT_MAX;
    int kmin = min(k0, k1), kmax = max(k0 == INT_MAX ? INT_MIN : k0, k1 == INT_MAX ? INT_MIN : k1);
    int qmin = qv, qmax = qv == INT_MAX ? INT_MIN : qv;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
    }
    if (warp < count && lane == 0)
      tile_states[warp] = tile_state_of(kmin, kmax, qmin, qmax, causal, window);
  }

  auto stage_kv = [&](int t, int st) {
    const int t0 = t * kKeys;
    auto src = [&](const bf16* base, int width) {
      return [=](int r) -> const bf16* {
        const int j = t0 + r;
        return j < sk ? base + ((b * sk + j) * hkv + kvh) * width : nullptr;
      };
    };
    stage_rows<HD, kKeys>(kv0 + (2 * st) * kStage, hd, k, src(k, hd));
    stage_rows<HD, kKeys>(kv0 + (2 * st + 1) * kStage, hd_v, v, src(v, hd_v));  // 0 past hd_v
  };

  RowState<HD> rs;
  rs.init();
  const int ra = row0 + grp, rb = ra + 8;
  rs.qp[0] = ra < rows ? __ldg(q_pos + ra / g) : 0;
  rs.qp[1] = rb < rows ? __ldg(q_pos + rb / g) : 0;
  __syncthreads();  // tile_states

  auto live_from = [&](int i) {  // the first live tile at or after index i of the split
    while (i < count && tile_states[i] == 0) ++i;
    return i;
  };
  int i = live_from(0);
  const long long pbase = ((b * hkv + kvh) * nsplit + split) * rows;  // (b, kvh, split) rows
  if (i == count && nsplit > 1) {  // the whole split is hidden: the combine skips it
    if (threadIdx.x < kSplitRows && row0 + threadIdx.x < rows)
      part_m[pbase + row0 + threadIdx.x] = kMasked;
    cp_async_wait<0>();
    return;
  }
  if (i < count) stage_kv(first + i, 0);
  cp_async_commit();
  int st = 0;
  while (i < count) {
    const int in = live_from(i + 1);
    if (in < count) stage_kv(first + in, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[2][4];
    qk<HD, 2>(s, qs, 0, kv0 + (2 * st) * kStage, warp * 16);
    rs.softmax(s, (first + i) * kKeys + warp * 16, tile_states[i], sk, k_pos, scale_log2,
               causal, window);
    pv<HD, 2>(rs.acc, s, kv0 + (2 * st + 1) * kStage, warp * 16);
    __syncthreads();
    i = in;
    st ^= 1;
  }
  cp_async_wait<0>();
  rs.reduce_l();
  __syncthreads();  // every stage is free: merge the four warps there

  float* wm = reinterpret_cast<float*>(smem_raw + 2 * HD * kSplitRows);  // [4][16] warp maxima
  float* wl = wm + kTcWarps * kSplitRows;                                // [4][16] warp sums
  float* ww = wl + kTcWarps * kSplitRows;                                // [4][16] warp weights
  float* bm = ww + kTcWarps * kSplitRows;                                // [16] block maxima
  float* bl = bm + kSplitRows;                                           // [16] block sums
  float* wacc = bl + kSplitRows;                                         // [4][16][HD]
  float* meanv = wacc + kTcWarps * kSplitRows * HD;                      // [HD]
  if (tig == 0) {
    wm[warp * kSplitRows + grp] = rs.m[0];
    wm[warp * kSplitRows + grp + 8] = rs.m[1];
    wl[warp * kSplitRows + grp] = rs.l[0];
    wl[warp * kSplitRows + grp + 8] = rs.l[1];
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    float* a = wacc + (warp * kSplitRows + grp) * HD + n * 8 + tig * 2;
    a[0] = rs.acc[n][0];
    a[1] = rs.acc[n][1];
    a[8 * HD] = rs.acc[n][2];
    a[8 * HD + 1] = rs.acc[n][3];
  }
  __syncthreads();
  if (threadIdx.x < kSplitRows) {  // the block's (m, l) per row, warps in a fixed order
    const int r = threadIdx.x;
    float mx = kMasked;
    for (int w = 0; w < kTcWarps; ++w) mx = fmaxf(mx, wm[w * kSplitRows + r]);
    float sum = 0.f;
    for (int w = 0; w < kTcWarps; ++w) {
      const float wt = exp2f(wm[w * kSplitRows + r] - mx);
      ww[w * kSplitRows + r] = wt;
      sum += wt * wl[w * kSplitRows + r];
    }
    bm[r] = mx;
    bl[r] = sum;
  }
  __syncthreads();

  const bool single = nsplit == 1;
  bool empty = false;  // the same in every thread
  for (int r = 0; r < kSplitRows; ++r) empty |= row0 + r < rows && bm[r] == kMasked;
  if (single && empty) {  // a row that sees no key: the mean of V
    mean_v(v, b, sk, hkv, kvh, hd_v, meanv, threadIdx.x, blockDim.x);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < kSplitRows * hd_v; e += kTcThreads) {
    const int r = e / hd_v, d = e - r * hd_v, row = row0 + r;
    if (row >= rows) continue;
    float a = 0.f;
    for (int w = 0; w < kTcWarps; ++w)
      a += ww[w * kSplitRows + r] * wacc[(w * kSplitRows + r) * HD + d];
    if (single) {
      const float x = bm[r] == kMasked ? meanv[d] : a / bl[r];
      out_row(o, b, row, kvh, sq, h, hd_v, g)[d] = __float2bfloat16(x);
    } else {
      part_acc[(pbase + row) * hd_v + d] = a;
    }
  }
  if (!single && threadIdx.x < kSplitRows && row0 + threadIdx.x < rows) {
    part_m[pbase + row0 + threadIdx.x] = bm[threadIdx.x];
    part_l[pbase + row0 + threadIdx.x] = bl[threadIdx.x];
  }
  if (single && lse != nullptr && threadIdx.x < kSplitRows && row0 + threadIdx.x < rows) {
    const int row = row0 + threadIdx.x, qi = row / g, head = kvh * g + (row - qi * g);
    const float m = bm[threadIdx.x];
    lse[(b * h + head) * sq + qi] = m == kMasked ? kMasked : (m + log2f(bl[threadIdx.x])) * kLn2;
  }
}

// grid (rows, kv heads, batch): merge the splits of one row, s = 0, 1, ... in
// order, by the log-sum-exp rule; a row that no split saw a key for gets the
// mean of V (and lse -1e30).
__global__ void __launch_bounds__(kTcThreads)
attn_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, const bf16* __restrict__ v,
                    bf16* __restrict__ o, float* __restrict__ lse, int sq, int sk, int h,
                    int hkv, int hd_v, int nsplit) {
  __shared__ float meanv[kMaxHeadDim];
  const int g = h / hkv, rows = sq * g;
  const int row = blockIdx.x, kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const long long base = (b * hkv + kvh) * nsplit;
  float mx = kMasked;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[(base + s) * rows + row]);
  bf16* orow = out_row(o, b, row, kvh, sq, h, hd_v, g);
  const int qi = row / g;
  float* lse_row = lse == nullptr ? nullptr : lse + (b * h + kvh * g + (row - qi * g)) * sq + qi;
  if (mx == kMasked) {
    if (lse_row != nullptr && threadIdx.x == 0) *lse_row = kMasked;
    mean_v(v, b, sk, hkv, kvh, hd_v, meanv, threadIdx.x, blockDim.x);
    for (int d = threadIdx.x; d < hd_v; d += blockDim.x) orow[d] = __float2bfloat16(meanv[d]);
    return;
  }
  // a split whose m is -1e30 saw no key of this row (its weight is 0) or was
  // wholly hidden (its l and acc were never written): both are left out
  float sum = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long i = (base + s) * rows + row;
    if (part_m[i] != kMasked) sum += exp2f(part_m[i] - mx) * part_l[i];
  }
  if (lse_row != nullptr && threadIdx.x == 0) *lse_row = (mx + log2f(sum)) * kLn2;
  for (int d = threadIdx.x; d < hd_v; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const long long i = (base + s) * rows + row;
      if (part_m[i] != kMasked) a += exp2f(part_m[i] - mx) * part_acc[i * hd_v + d];
    }
    orow[d] = __float2bfloat16(a / sum);
  }
}

template <int HD>
constexpr size_t split_merge_bytes() {  // what the merge after the loop uses past Q's room
  return sizeof(float) * (3 * kTcWarps * kSplitRows + 2 * kSplitRows +
                          kTcWarps * kSplitRows * HD + HD);
}
static_assert(split_merge_bytes<64>() <= split_smem_bytes<64>() - 2 * 64 * kSplitRows, "smem");

template <int HD>
int split_launch(const void* q, const void* k, const void* v, const void* q_pos,
                 const void* k_pos, void* o, void* part_m, void* part_l, void* part_acc,
                 void* lse, int b, int sq, int sk, int h, int hkv, int hd, int hd_v, float scale,
                 int causal, int window, int nsplit, int tiles_per_split, cudaStream_t stream) {
  static int smem_set = 0;
  constexpr size_t smem = split_smem_bytes<HD>();
  cudaError_t err = allow_smem(attn_split_kernel<HD>, smem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = sq * (h / hkv);
  const int groups = (rows + kSplitRows - 1) / kSplitRows;
  attn_split_kernel<HD><<<dim3(hkv, nsplit, b * groups), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), static_cast<bf16*>(o),
      static_cast<float*>(part_m), static_cast<float*>(part_l), static_cast<float*>(part_acc),
      static_cast<float*>(lse), sq, sk, h, hkv, hd, hd_v, scale * kLog2e, causal, window,
      tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  attn_combine_kernel<<<dim3(rows, hkv, b), kTcThreads, 0, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), sq, sk, h, hkv, hd_v, nsplit);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int b, int sq, int sk, int h, int hkv, int hd, int hd_v) {
  return b >= 1 && b <= 65535 && sq >= 1 && sk >= 1 && hkv >= 1 && hkv <= 65535 && h >= hkv &&
         h % hkv == 0 && hd >= 1 && hd <= kMaxHeadDim && hd_v >= 1 && hd_v <= hd &&
         static_cast<long long>(sq) * (h / hkv) <= (1LL << 31) - 64;
}

}  // namespace

// All launchers: q: (b, sq, h, hd); k: (b, sk, hkv, hd); v: (b, sk, hkv, hd_v);
// o: (b, sq, h, hd_v), hd_v <= hd; contiguous, on the current device; q_pos
// (sq,) and k_pos (sk,) int32; lse, where taken, a (b, h, sq) f32 output or null.  Each launches on `stream` and returns the
// cudaError_t of its launches (0 on success).

// "general": bf16 when `bf16` is nonzero, f32 otherwise; any hd_v <= hd <= 256.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* k_pos, void* o, void* lse,
                                      int b, int sq, int sk, int h, int hkv, int hd, int hd_v,
                                      float scale, int causal, int window, int bf16,
                                      void* stream) {
  if (!shape_ok(b, sq, sk, h, hkv, hd, hd_v)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return general_launch<__nv_bfloat16>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, hkv, hd,
                                         hd_v, scale, causal, window, s);
  }
  return general_launch<float>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, hkv, hd, hd_v, scale,
                               causal, window, s);
}

// The design of a "tile" call (flash_attention_tile_launch takes bf16 only):
// 0 "wgmma" for bf16 with hd <= 192, hd_v <= 128, both multiples of 16, and
// Sq >= 64; 1 "mma" otherwise (hd 256; fewer than 64 queries of a head, but
// 64 or more (query, head) rows of a kv head).
extern "C" int flash_attention_tile_design(int bf16, int hd, int hd_v, int sq) {
  return tile_design(bf16, hd, hd_v, sq);
}

// "tile": bf16, hd and hd_v multiples of 8, 16-byte aligned rows.  `design`
// -1: the one flash_attention_tile_design names; 0 "wgmma" (an error where
// it does not take the call) on the instance (64, 64), (128, 128) or (192,
// 128) that holds (hd, hd_v); 1 "mma" on (64, 64), (128, 128), (192, 128)
// or (256, 256).
extern "C" int flash_attention_tile_launch(const void* q, const void* k, const void* v,
                                           const void* q_pos, const void* k_pos, void* o,
                                           void* lse, int b, int sq, int sk, int h, int hkv,
                                           int hd, int hd_v, float scale, int causal, int window,
                                           int design, void* stream) {
  const int rule = tile_design(1, hd, hd_v, sq);
  if (!shape_ok(b, sq, sk, h, hkv, hd, hd_v) || hd % 8 || hd_v % 8 || design < -1 ||
      design > 1 || (design == 0 && rule != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((design < 0 ? rule : design) == 0) {
    if (hd <= 64)
      return fwd_wgmma_launch<64, 64>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, hkv, hd, hd_v,
                                      scale, causal, window, s);
    if (hd <= 128)
      return fwd_wgmma_launch<128, 128>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, hkv, hd,
                                        hd_v, scale, causal, window, s);
    return fwd_wgmma_launch<192, 128>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, hkv, hd, hd_v,
                                      scale, causal, window, s);
  }
  if (hd <= 64)
    return tile_launch<64, 64>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, hkv, hd, hd_v, scale,
                               causal, window, s);
  if (hd <= 128)
    return tile_launch<128, 128>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, hkv, hd, hd_v,
                                 scale, causal, window, s);
  if (hd <= 192 && hd_v <= 128)
    return tile_launch<192, 128>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, hkv, hd, hd_v,
                                 scale, causal, window, s);
  return tile_launch<256, 256>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, hkv, hd, hd_v, scale,
                               causal, window, s);
}

// "split": bf16, hd and hd_v multiples of 8 (tiles of width 64, 128 or 256 by
// hd), over `nsplit` ranges of `tiles_per_split` (at most 4) 64-key tiles that
// cover sk exactly (the last may be short).  With nsplit > 1, part_m and
// part_l are (b, hkv, nsplit, sq * h / hkv) f32 and part_acc the same by hd_v.
extern "C" int flash_attention_split_launch(const void* q, const void* k, const void* v,
                                            const void* q_pos, const void* k_pos, void* o,
                                            void* part_m, void* part_l, void* part_acc,
                                            void* lse, int b, int sq, int sk, int h, int hkv,
                                            int hd, int hd_v, float scale, int causal, int window,
                                            int nsplit, int tiles_per_split, void* stream) {
  const long long ntiles = (sk + kKeys - 1) / kKeys;
  const long long groups = (static_cast<long long>(sq) * (h / hkv) + kSplitRows - 1) / kSplitRows;
  if (!shape_ok(b, sq, sk, h, hkv, hd, hd_v) || hd % 8 || hd_v % 8 || nsplit < 1 ||
      nsplit > 65535 ||
      hkv > 65535 || tiles_per_split < 1 || tiles_per_split > kTcWarps ||
      static_cast<long long>(nsplit) * tiles_per_split < ntiles ||
      static_cast<long long>(nsplit - 1) * tiles_per_split >= ntiles || b * groups > 65535 ||
      (nsplit > 1 && (!part_m || !part_l || !part_acc))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return split_launch<64>(q, k, v, q_pos, k_pos, o, part_m, part_l, part_acc, lse, b, sq, sk, h,
                            hkv, hd, hd_v, scale, causal, window, nsplit, tiles_per_split, s);
  if (hd <= 128)
    return split_launch<128>(q, k, v, q_pos, k_pos, o, part_m, part_l, part_acc, lse, b, sq, sk,
                             h, hkv, hd, hd_v, scale, causal, window, nsplit, tiles_per_split, s);
  return split_launch<256>(q, k, v, q_pos, k_pos, o, part_m, part_l, part_acc, lse, b, sq, sk, h,
                           hkv, hd, hd_v, scale, causal, window, nsplit, tiles_per_split, s);
}

extern "C" const char* flash_attention_error_string(int err) { return launch_error_string(err); }
