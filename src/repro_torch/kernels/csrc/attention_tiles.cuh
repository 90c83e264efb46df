// Tensor-core tile helpers shared by flash_attention.cu (the forward kernels)
// and flash_attention_bwd.cu (the gradient): XOR-swizzled bf16 tiles in
// shared memory staged by 16-byte cp.async, ldmatrix (also transposed),
// mma.sync.m16n8k16 with f32 accumulation, the visibility of a tile of keys
// from its positions, and the two tile products every kernel is built from;
// then the Hopper pieces of the backward's wgmma kernels: mbarriers, TMA
// loads, setmaxnreg, wgmma with its shared-memory descriptors.
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

// ---------------------------------------------------------------------------
// Hopper (sm_90a): mbarriers, TMA, warpgroup register hand-off and wgmma,
// used by the backward's redesigned kernels (flash_attention_bwd.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// make initialised barriers visible to the async proxy (TMA) before any use
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive once and expect `bytes` of TMA transactions in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the phase of parity `parity` has completed.  (No __trap() on a
// long wait: a trap in the kernel makes ptxas ignore setmaxnreg, allocate
// every warpgroup the launch's 168 registers, spill and serialize wgmma.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: one box of a 4-D tensor map (a __grid_constant__ CUtensorMap) at
// coordinates {c0 innermost, c1, c2, c3} into shared memory; the bytes
// complete on `bar`.  Out-of-bounds elements are written as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// TMA: `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Hand registers from the producer warpgroup to the consumers (all four warps
// of a warpgroup execute it together)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Tie registers that wgmma writes asynchronously to the waits around them, so
// the compiler neither reads them early nor moves their writes past a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// ... and A fragments in registers, which an issued wgmma still reads
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

// wgmma shared-memory descriptors for tiles that TMA wrote with the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), 8-row groups of 1024 bytes, the
// tile 1024-byte aligned.  K-major (the reduction dimension contiguous): a
// step of 16 along K adds 32 bytes to the start address; LBO is unused.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
// MN-major (the output dimension contiguous, read through the transpose bit):
// LBO is the stride between 64-column halves, SBO between 8-row groups of K;
// a step of 16 along K adds 2048 bytes.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t half_stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((half_stride & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64, f32) = A (64 x 16) . B (64 x 16)^T (+ d if acc): both from shared memory,
// K-major, by descriptor
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}
// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) . B (16 x 64): B from
// shared memory by descriptor, MN-major (its 64 columns contiguous: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 128, f32) += A (64 x 16, bf16 pairs in registers) . B (16 x 128): B from
// shared memory by descriptor, MN-major (its 128 columns contiguous: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x HD) += A . B for HD 64 or 128 (B MN-major)
template <int HD>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[HD / 2], const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (HD == 64)
    wgmma_rs_n64_tb(d, a, b);
  else
    wgmma_rs_n128_tb(d, a, b);
}

}  // namespace
