// Tensor-core tile helpers shared by flash_attention.cu (the forward kernels)
// and flash_attention_bwd.cu (the gradient): XOR-swizzled bf16 tiles in
// shared memory staged by 16-byte cp.async, ldmatrix (also transposed),
// mma.sync.m16n8k16 with f32 accumulation, the visibility of a tile of keys
// from its positions, and the two tile products every kernel is built from.
// Each .cu builds alone (kernels/_build.py hashes this header with it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kMasked = -1e30f;  // the JAX package's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxHeadDim = 256;
constexpr int kTcWarps = 4;  // warps of a tensor-core block, 16 rows each
constexpr int kTcThreads = kTcWarps * 32;

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

// Set a kernel's dynamic shared memory limit once per size, not per launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int* done) {
  if (static_cast<int>(bytes) <= *done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess) *done = static_cast<int>(bytes);
  return err;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of row `r` in a [rows][HD] bf16 tile
// whose chunks are XOR-swizzled by the row: the 8 rows that one ldmatrix
// phase reads at one column land on 8 different bank groups.
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int chunk) {
  return static_cast<uint32_t>(r * HD * 2 + ((chunk ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                          uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&x);
}

// Stage `nrows` rows of hd bf16 each into a swizzled [nrows][HD] tile; row r
// comes from src(r) (nullptr: zeros).  Chunks past hd are zero-filled.
template <int HD, int NROWS, typename Src>
__device__ __forceinline__ void stage_rows(uint32_t dst, int hd, const bf16* base, Src src) {
  constexpr int kChunks = HD / 8;
  for (int e = threadIdx.x; e < NROWS * kChunks; e += kTcThreads) {
    const int r = e / kChunks, c = e - r * kChunks;
    const bf16* p = src(r);
    const bool valid = p != nullptr && c * 8 < hd;
    cp_async16(dst + swz<HD>(r, c), valid ? p + c * 8 : base, valid);
  }
}

// What a tile of keys at positions in [kmin, kmax] holds for rows at
// positions in [qmin, qmax]: 0 every pair hidden, 1 some hidden, 2 every pair visible.
__device__ __forceinline__ int tile_state_of(int kmin, int kmax, int qmin, int qmax, int causal,
                                             int window) {
  if (!causal && window <= 0) return 2;
  const bool hidden = (causal && kmin > qmax) ||
                      (window > 0 && static_cast<long long>(qmin) - kmax >= window);
  if (hidden) return 0;
  const bool full = (!causal || kmax <= qmin) &&
                    (window <= 0 || static_cast<long long>(qmax) - kmin < window);
  return full ? 2 : 1;
}

// S (16 rows x 8 NT keys) = Q rows [qrow0, +16) . K rows [krow0, +8 NT) over HD
template <int HD, int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4], uint32_t qs, int qrow0, uint32_t ks,
                                   int krow0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a0, a1, a2, a3;
    ldsm_x4(a0, a1, a2, a3, qs + swz<HD>(qrow0 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      const int r = krow0 + np * 16 + ((lane >> 4) << 3) + (lane & 7);
      ldsm_x4(b0, b1, b2, b3, ks + swz<HD>(r, kk * 2 + ((lane >> 3) & 1)));
      mma16816(s[2 * np], a0, a1, a2, a3, b0, b1);
      mma16816(s[2 * np + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// acc (16 rows x HD) += P (16 rows x 8 NT keys, in s) . V rows [vrow0, +8 NT)
template <int HD, int NT>
__device__ __forceinline__ void pv(float (&acc)[HD / 8][4], const float (&p)[NT][4], uint32_t vs,
                                   int vrow0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a0 = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    const uint32_t a1 = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    const uint32_t a2 = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const int r = vrow0 + kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_t(b0, b1, b2, b3, vs + swz<HD>(r, dp * 2 + (lane >> 4)));
      mma16816(acc[2 * dp], a0, a1, a2, a3, b0, b1);
      mma16816(acc[2 * dp + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

}  // namespace
