// C (M, N) = A (M, K) (x) B (K, N) over GF(2^8), polynomial 0x11D, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gf_matmul.py::gf_matmul (body
// `_kernel`, helper `_gf_mul_vec`): the byte data path of every Clay encode
// and decode.  A is tiny (M <= m, K <= N_clay - 1: 6 x 12 at Clay (10,6)),
// B is wide (N = plane-group bytes x chunksets, up to 10^8 columns).
//
// What bounds it on an H100: bytes.  The kernel must read K*N bytes of B and
// write M*N bytes of C (18 bytes per column at 6 x 12, about 0.58 ms for a
// 1 GiB blob's encode at 3.35 TB/s).  Its work is M*K GF multiply-adds per
// column, done here as one shared-memory table lookup each; a 32-lane
// lookup into a 256-byte table costs about two shared-memory wavefronts
// (two table words per bank), so at 6 x 12 the lookups, not the bytes, are
// the likely limit of this first version.
//
// Design:
//  * Each block builds, in shared memory, one 256-byte product table
//    T[i][j][x] = A[i][j] * x for the output rows it owns (M*K*256 bytes:
//    18 KiB at 6 x 12).  Blocks stride over N (a persistent grid of a few
//    blocks per SM), so each table is built once per block.
//  * When N % 4 == 0 and both pointers are 4-byte aligned (every Clay shape:
//    w is kept 4-byte aligned), a thread owns one u32 word = 4 consecutive
//    columns: K u32 loads, 4 lookups per (row, k), M u32 stores.  Otherwise
//    a thread owns one column and moves single bytes.  Either way the ragged
//    tail of N is masked by the loop bound: no padding, no read past N.
//  * Output rows are accumulated 8 at a time in registers; a block owns at
//    most kTableBudget / (K * 256) rows (>= 6 for K <= 32), and gridDim.y
//    covers the rest, so every 1 <= M, K <= 32 fits 48 KiB of shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 8;              // output rows held in registers per pass
constexpr int kMaxDim = 32;              // largest M and K the kernel accepts
constexpr int kTableBudget = 48 * 1024;  // dynamic shared memory without opt-in
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ uint32_t gf_mul_byte(uint32_t a, uint32_t b) {
  uint32_t acc = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    acc ^= b & (0u - (a & 1u));
    a >>= 1;
    b = ((b << 1) & 0xFFu) ^ (0x1Du & (0u - (b >> 7)));
  }
  return acc;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 uint8_t* __restrict__ c, int m, int k, long long n,
                 int rows_per_block) {
  extern __shared__ uint8_t tab[];  // [rows][k][256]
  const int row0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, m - row0);

  const int entries = rows * k * 256;
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const int rj = e >> 8;  // r * k + j
    const int r = rj / k;
    const int j = rj - r * k;
    tab[e] = static_cast<uint8_t>(gf_mul_byte(a[(row0 + r) * k + j], e & 255));
  }
  __syncthreads();

  const long long units = kVec ? (n >> 2) : n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       u < units; u += stride) {
    for (int r0 = 0; r0 < rows; r0 += kRowTile) {
      uint32_t acc[kRowTile];
#pragma unroll
      for (int t = 0; t < kRowTile; ++t) acc[t] = 0;
      for (int j = 0; j < k; ++j) {
        const uint8_t* brow = b + static_cast<long long>(j) * n;
        if (kVec) {
          const uint32_t w = reinterpret_cast<const uint32_t*>(brow)[u];
          const uint32_t x0 = w & 0xFFu, x1 = (w >> 8) & 0xFFu;
          const uint32_t x2 = (w >> 16) & 0xFFu, x3 = w >> 24;
#pragma unroll
          for (int t = 0; t < kRowTile; ++t) {
            if (r0 + t < rows) {
              const uint8_t* tj = tab + ((r0 + t) * k + j) * 256;
              acc[t] ^= static_cast<uint32_t>(tj[x0]) |
                        (static_cast<uint32_t>(tj[x1]) << 8) |
                        (static_cast<uint32_t>(tj[x2]) << 16) |
                        (static_cast<uint32_t>(tj[x3]) << 24);
            }
          }
        } else {
          const uint32_t x = brow[u];
#pragma unroll
          for (int t = 0; t < kRowTile; ++t) {
            if (r0 + t < rows) acc[t] ^= tab[((r0 + t) * k + j) * 256 + x];
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kRowTile; ++t) {
        if (r0 + t < rows) {
          uint8_t* crow = c + static_cast<long long>(row0 + r0 + t) * n;
          if (kVec) {
            reinterpret_cast<uint32_t*>(crow)[u] = acc[t];
          } else {
            crow[u] = static_cast<uint8_t>(acc[t]);
          }
        }
      }
    }
  }
}

}  // namespace

// Launch C = A (x) B on `stream`.  a: (m, k), b: (k, n), c: (m, n), all
// contiguous uint8 on the current device; `num_sms` sizes the persistent
// grid.  Returns the cudaError_t of the launch (0 on success).
extern "C" int gf_matmul_launch(const void* a, const void* b, void* c, int m, int k,
                                long long n, int num_sms, void* stream) {
  if (m < 1 || m > kMaxDim || k < 1 || k > kMaxDim || n < 1 || num_sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows_per_block = std::min(m, kTableBudget / (k * 256));
  const int grid_y = (m + rows_per_block - 1) / rows_per_block;
  const size_t smem = static_cast<size_t>(rows_per_block) * k * 256;
  const bool vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(b) % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(c) % 4 == 0);
  const long long units = vec ? n / 4 : n;
  const long long want = (units + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(num_sms) * kBlocksPerSM;
  const dim3 grid(static_cast<unsigned>(std::min(want, cap)), grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const uint8_t* b8 = static_cast<const uint8_t*>(b);
  uint8_t* c8 = static_cast<uint8_t*>(c);
  if (vec) {
    gf_matmul_kernel<true><<<grid, kThreads, smem, s>>>(a8, b8, c8, m, k, n, rows_per_block);
  } else {
    gf_matmul_kernel<false><<<grid, kThreads, smem, s>>>(a8, b8, c8, m, k, n, rows_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gf_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
