// Fused attention with online softmax on Hopper, f32 accumulation, GQA,
// explicit positions:
//
//   o[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h / g],
//   s[i, j] = scale * q[b, i, h] . k[b, j, h / g]   if visible(i, j), else -1e30,
//   visible(i, j) = (!causal || qpos[i] >= kpos[j]) && (window == 0 || qpos[i] - kpos[j] < window)
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_fused (body `_kernel`), widened to the contract of
// repro/models/layers.py::flash_attention and ::decode_attention, which the
// models call: positions are explicit (a one-token decode against a cache is
// Sq = 1 with qpos = [pos]; a ring buffer permutes kpos), a sliding window,
// and any Sq and Sk.  Masked scores are -1e30, as in the JAX package, so a
// row that sees no key averages v over all keys there and here alike.
//
// What bounds it on an H100: the useful work is 4 * hd operations per
// visible (query, key) pair and head against Q/K/V/O read or written once.
// Prefill-sized calls are bound by operations (989 TFLOP/s bf16 dense);
// decode (Sq = 1) by the bytes of the cache.  This first version runs its
// dot products on the CUDA cores in f32 from shared memory, far from the
// tensor-core bound; wgmma and TMA are later work.
//
// Design:
//  * Rows are (query, head-in-group) pairs of one kv head: a block owns 16
//    such rows of one (batch, kv head), so the g query heads that share a kv
//    head share every K/V tile it stages (for decode, all g heads in one block).
//  * Each warp owns 4 rows.  K/V tiles of 64 keys are converted to f32 into
//    shared memory; K rows are padded by one float so that lanes reading
//    64 different keys at one feature hit different banks.  A lane scores
//    keys lane and lane + 32 for its warp's rows; max and sum reduce across
//    the warp with shuffles (online softmax, running max and sum in
//    registers); then the lane accumulates features lane, lane + 32, ... of
//    P V for its rows in registers (hd <= 256).
//  * Keys past Sk in the last tile are left out entirely (score -inf), not
//    masked: the kernel needs no padding of Sk and reads nothing past it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows per block
constexpr int kTile = 64;                     // keys per shared-memory tile
constexpr int kMaxHeadDim = 256;
constexpr int kDPerLane = kMaxHeadDim / 32;
constexpr float kMasked = -1e30f;  // the JAX package's NEG_INF

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int hd) {
  return sizeof(float) * (static_cast<size_t>(kRows) * hd + kTile * (hd + 1) + kTile * hd +
                          kRows * kTile) +
         sizeof(int) * kTile;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, T* __restrict__ o, int sq, int sk,
                       int h, int hkv, int hd, float scale, int causal, int window) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [kRows][hd], scaled
  float* ks = qs + kRows * hd;        // [kTile][hd + 1]
  float* vs = ks + kTile * (hd + 1);  // [kTile][hd]
  float* ps = vs + kTile * hd;        // [kRows][kTile]
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
      const long long src = ((b * sk + t0 + j) * hkv + kvh) * hd + d;
      ks[j * (hd + 1) + d] = to_f32(k[src]);
      vs[j * hd + d] = to_f32(v[src]);
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
      const float* vrow = vs + j * hd;
      float vv[kDPerLane];
#pragma unroll
      for (int dd = 0; dd < kDPerLane; ++dd) {
        const int d = lane + 32 * dd;
        vv[dd] = d < hd ? vrow[d] : 0.f;
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
    T* orow = o + ((b * sq + qi) * h + head) * hd;
#pragma unroll
    for (int dd = 0; dd < kDPerLane; ++dd) {
      const int d = lane + 32 * dd;
      if (d < hd) orow[d] = from_f32<T>(acc[i][dd] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* q_pos, const void* k_pos,
           void* o, int b, int sq, int sk, int h, int hkv, int hd, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(sq) * (h / hkv);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), hkv, b);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), static_cast<T*>(o), sq, sk,
      h, hkv, hd, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch attention on `stream`.  q, o: (b, sq, h, hd); k, v: (b, sk, hkv, hd),
// all contiguous, bf16 when `bf16` is nonzero and f32 otherwise; q_pos (sq,)
// and k_pos (sk,) int32; all on the current device.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* k_pos, void* o, int b,
                                      int sq, int sk, int h, int hkv, int hd, float scale,
                                      int causal, int window, int bf16, void* stream) {
  if (b < 1 || b > 65535 || sq < 1 || sk < 1 || hkv < 1 || hkv > 65535 || h < hkv ||
      h % hkv != 0 || hd < 1 || hd > kMaxHeadDim ||
      static_cast<long long>(sq) * (h / hkv) > (1LL << 31) - kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(q, k, v, q_pos, k_pos, o, b, sq, sk, h, hkv, hd, scale, causal,
                                 window, s);
  }
  return launch<float>(q, k, v, q_pos, k_pos, o, b, sq, sk, h, hkv, hd, scale, causal, window, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
