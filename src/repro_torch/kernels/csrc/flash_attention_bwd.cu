// The gradient of fused attention on Hopper: dQ, dK, dV from q, k, v, the
// forward's output o, the output gradient dO and the forward's row
// log-sum-exp lse, with the forward's visibility rule (explicit positions,
// causal, sliding window, scale; a hidden score is -1e30) and GQA:
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
// Bound by operations: five products of 2 * hd flops per visible (query,
// key) pair and query head (S and dP again, dV, dK, dQ) at the bf16
// tensor-core peak.  Three kernels, all deterministic (no atomics):
//
//  * attn_bwd_delta_kernel: D = rowsum(dO * O) in f32, one warp per row.
//  * attn_bwd_dkdv_kernel: one block per (batch, kv head, 64-key tile); its
//    four warps own 16 keys each and walk every 64-row tile of the g query
//    heads' (query, head) rows (row = qi * g + gi, as in the forward), with
//    S^T = K Q^T and dP^T = V dO^T on the tensor cores (mma.sync.m16n8k16,
//    bf16 in, f32 accumulate, operands by ldmatrix from XOR-swizzled shared
//    memory), then dV += P^T dO and dK += dS^T Q with P and dS rounded to
//    bf16 as A operands straight from the accumulator registers.  A row tile
//    whose pairs are all hidden is skipped unless it holds a row that sees
//    no key.
//  * attn_bwd_dq_kernel: one block per (batch, kv head, 64-row tile), the
//    forward tile kernel's layout: S = Q K^T, dP = dO V^T, dQ += dS K over
//    the live 64-key tiles.
//
// Each tile is staged by 16-byte cp.async in one stage (load, wait, compute):
// the simple first version.  Not yet Hopper-specific: wgmma and TMA with a
// ring of stages are the redesign (ROADMAP Queue 2).  The tile helpers and
// products (qk, pv) are attention_tiles.cuh's, shared with the forward.
//
// Takes bf16 with hd a multiple of 16, at most 256 (padded to 64/128/256 in
// shared memory with zeros), 16-byte aligned tensors; the wrapper raises on
// anything else.  Dynamic shared memory: 512 * HD bytes (+ 768 B) per block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "attention_tiles.cuh"

namespace {

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

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  return (!causal || qp >= kp) && (window <= 0 || static_cast<long long>(qp) - kp < window);
}

// Address of (query, head) row `row` of kv head kvh in a (b, sq, h, hd) tensor
__device__ __forceinline__ long long row_offset(long long b, int row, int kvh, int sq, int h,
                                                int hd, int g) {
  const int qi = row / g, head = kvh * g + (row - qi * g);
  return ((b * sq + qi) * h + head) * hd;
}

// Index of (query, head) row `row` of kv head kvh in a (b, h, sq) statistic
__device__ __forceinline__ long long stat_index(long long b, int row, int kvh, int sq, int h,
                                                int g) {
  const int qi = row / g, head = kvh * g + (row - qi * g);
  return (b * h + head) * sq + qi;
}

// ---------------------------------------------------------------------------
// D = rowsum(dO * O)
// ---------------------------------------------------------------------------

constexpr int kDeltaThreads = 256;

// One warp per (b, query, head) row, in o's memory order; D is (b, h, sq).
__global__ void __launch_bounds__(kDeltaThreads)
attn_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      float* __restrict__ delta, long long nrows, int sq, int h, int hd) {
  const long long r = (static_cast<long long>(blockIdx.x) * kDeltaThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= nrows) return;
  const bf16* po = o + r * hd;
  const bf16* pd = dout + r * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s += __bfloat162float(po[d]) * __bfloat162float(pd[d]);
  s = warp_sum(s);
  if (lane == 0) {
    const long long bq = r / h;
    const int head = static_cast<int>(r - bq * h);
    const long long b = bq / sq;
    const int qi = static_cast<int>(bq - b * sq);
    delta[(b * h + head) * sq + qi] = s;
  }
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
                     int hd, float scale, float scale_log2, int causal, int window) {
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

  auto kv_src = [&](const bf16* base) {
    return [=](int r) -> const bf16* {
      const int j = kt0 + r;
      return j < sk ? base + ((b * sk + j) * hkv + kvh) * hd : nullptr;
    };
  };
  stage_rows<HD, kTile>(ks, hd, k, kv_src(k));
  stage_rows<HD, kTile>(vs, hd, v, kv_src(v));
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
    auto row_src = [&](const bf16* base) {
      return [=](int r) -> const bf16* {
        const int row = r0 + r;
        return row < rows ? base + row_offset(b, row, kvh, sq, h, hd, g) : nullptr;
      };
    };
    stage_rows<HD, kTile>(qs, hd, q, row_src(q));
    stage_rows<HD, kTile>(dos, hd, dout, row_src(dout));
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
    const long long off = ((b * sk + key[i]) * hkv + kvh) * hd;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = n * 8 + tig * 2;
      if (d < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + d) =
            __floats2bfloat162_rn(dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + d) =
            __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
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
                   bf16* __restrict__ dq, int sq, int sk, int h, int hkv, int hd, float scale,
                   float scale_log2, int causal, int window) {
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

  auto row_src = [&](const bf16* base) {
    return [=](int r) -> const bf16* {
      const int row = row0 + r;
      return row < rows ? base + row_offset(b, row, kvh, sq, h, hd, g) : nullptr;
    };
  };
  stage_rows<HD, kTile>(qs, hd, q, row_src(q));
  stage_rows<HD, kTile>(dos, hd, dout, row_src(dout));
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
    auto kv_src = [&](const bf16* base) {
      return [=](int r) -> const bf16* {
        const int j = t0 + r;
        return j < sk ? base + ((b * sk + j) * hkv + kvh) * hd : nullptr;
      };
    };
    stage_rows<HD, kTile>(ks, hd, k, kv_src(k));
    stage_rows<HD, kTile>(vs, hd, v, kv_src(v));
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
int bwd_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* q_pos, const void* k_pos, void* dq, void* dk,
               void* dv, int b, int sq, int sk, int h, int hkv, int hd, float scale, int causal,
               int window, cudaStream_t stream) {
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
      hkv, hd, scale, scale_log2, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(sq) * (h / hkv);
  attn_bwd_dq_kernel<HD><<<dim3(static_cast<unsigned>((rows + kTile - 1) / kTile), hkv, b),
                           kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(q_pos),
      static_cast<const int*>(k_pos), static_cast<bf16*>(dq), sq, sk, h, hkv, hd, scale,
      scale_log2, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq: (b, sq, h, hd); k, v, dk, dv: (b, sk, hkv, hd); bf16,
// contiguous, 16-byte aligned, on the current device; lse and delta (b, h,
// sq) f32 (delta is scratch, written here); q_pos (sq,) and k_pos (sk,)
// int32.  Launches the three kernels on `stream`; returns the cudaError_t of
// the launches (0 on success).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          const void* q_pos, const void* k_pos, void* dq,
                                          void* dk, void* dv, void* delta, int b, int sq, int sk,
                                          int h, int hkv, int hd, float scale, int causal,
                                          int window, void* stream) {
  if (b < 1 || b > 65535 || sq < 1 || sk < 1 || hkv < 1 || hkv > 65535 || h < hkv || h % hkv ||
      hd < 16 || hd > kMaxHeadDim || hd % 16 ||
      static_cast<long long>(sq) * (h / hkv) > (1LL << 31) - kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nrows = static_cast<long long>(b) * sq * h;
  const long long blocks = (nrows * 32 + kDeltaThreads - 1) / kDeltaThreads;
  attn_bwd_delta_kernel<<<static_cast<unsigned>(blocks), kDeltaThreads, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      nrows, sq, h, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd <= 64)
    return bwd_launch<64>(q, k, v, dout, lse, delta, q_pos, k_pos, dq, dk, dv, b, sq, sk, h, hkv,
                          hd, scale, causal, window, s);
  if (hd <= 128)
    return bwd_launch<128>(q, k, v, dout, lse, delta, q_pos, k_pos, dq, dk, dv, b, sq, sk, h,
                           hkv, hd, scale, causal, window, s);
  return bwd_launch<256>(q, k, v, dout, lse, delta, q_pos, k_pos, dq, dk, dv, b, sq, sk, h, hkv,
                         hd, scale, causal, window, s);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
