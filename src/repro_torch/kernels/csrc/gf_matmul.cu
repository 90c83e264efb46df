// C (M, N) = A (M, K) (x) B (K, N) over GF(2^8), polynomial 0x11D, on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/gf_matmul.py::gf_matmul (body
// `_kernel`, helper `_gf_mul_vec`): the byte data path of every Clay encode
// and decode.  A is tiny (M <= m, K <= N_clay - 1: 6 x 12 at Clay (10,6)),
// B is wide (N = plane-group bytes x chunksets, up to 10^8 columns).
//
// What bounds it on an H100: bytes.  The kernel must read K*N bytes of B and
// write M*N bytes of C: 18 bytes per column at 6 x 12, 0.58 ms for the
// 108,036,288 columns of a 1 GiB blob's encode at 3.35 TB/s.  Against that it
// does M*K GF multiply-adds per column (72 at 6 x 12), so the design is about
// the instructions spent per byte product.
//
// Design:
//  * Split product tables.  Multiplying by a constant c is linear over GF(2):
//    with x = x0 + 8*x1 + 64*x2 (x0, x1 in 0..7, x2 in 0..3),
//    c*x = T0[x0] ^ T1[x1] ^ T2[x2], T0[v] = c*v, T1[v] = c*(v << 3) and
//    T2[v] = c*(v << 6): 8 + 8 + 4 bytes, five u32 words per coefficient
//    instead of a 256-byte table.  Each block builds them in shared memory
//    for its output rows (M*K*20 bytes: 1,440 at 6 x 12), a few xtime steps
//    per coefficient, and every thread reads them with uniform (broadcast)
//    loads into registers.
//  * Four lookups in one instruction.  PTX prmt (byte permute) picks byte i of
//    its result from the 8 bytes of two registers by nibble i of a selector,
//    so prmt(T0 lo, T0 hi, sel) looks up all four bytes of a u32 word of B at
//    once.  The three selectors of a word depend on (k, word) only and serve
//    all M rows: the 3-bit index of each byte is masked out (one lop3) and
//    packed into nibbles as v + (v >> 12), which puts the bytes in the order
//    0, 2, 1, 3; the packing runs as the high word of a product (mad.hi) on
//    the multiply-add pipe.  The accumulators keep that order and are put
//    back by one prmt each before the store.  Per (row, k, word): three prmt
//    and 1.5 three-input XORs (lop3), two rows of K at a time; per (k, word):
//    three lop3 and three mad.hi.  The selectors never set a nibble's bit 3
//    (prmt's sign mode), so prmt is issued from PTX directly: __byte_perm
//    would mask every selector with 0x7777 first.
//  * 16-byte streams.  A thread owns 16 consecutive columns of each row (a
//    chunk), loaded with the widest access that N and both base pointers
//    allow: one 16-byte load, two 8-byte, four 4-byte, or single bytes.  The
//    ragged tail of N is masked in the kernel (no padding, no read past N).
//    The K loop walks B four rows at a time; as soon as a pair of rows is in
//    the selectors its registers are reloaded with the rows that follow (past
//    the last rows, the first rows of the thread's next chunk), so the loads
//    overlap the lookups.  Rows past K meet all-zero tables.
//  * Output rows: a block owns 1, 2, 4, 6 or 8 rows (the smallest that holds
//    M, else 8; rows past M have all-zero tables and are not stored), held as
//    accumulators in registers; gridDim.y covers M > 8.  Blocks stride over
//    the chunks; the grid is as many blocks as are resident at once (from the
//    occupancy calculator), fewer when N has fewer chunks, so one Clay
//    chunkset's 65,556 chunks spread over all 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // <= 128 registers: 16 warps per SM, and ptxas spills nothing
constexpr int kMaxDim = 32;    // largest M and K the kernel accepts
constexpr int kGroup = 4;      // rows of B per step of the K loop (even: XORs in pairs)
constexpr int kMaxK = (kMaxDim + kGroup - 1) / kGroup * kGroup;
constexpr int kChunk = 16;     // bytes of each row a thread owns
constexpr int kWidths[] = {16, 8, 4};
constexpr uint32_t kLow3 = 0x07070707u;
constexpr uint32_t kLow2 = 0x03030303u;
// v + (v >> 12) as the high word of v * kSel (+ v for split 0), for v masked
// to one split: the low word of each product never carries into the high one
constexpr uint32_t kSel0 = (1u << 20) + 1u;               // (v << 20) + v < 2^32
constexpr uint32_t kSel1 = (1u << 29) + (1u << 17);       // (v >> 3) + (v >> 15)
constexpr uint32_t kSel2 = (1u << 26) + (1u << 14);       // (v >> 6) + (v >> 18)

__device__ __forceinline__ uint32_t xtime(uint32_t x) {  // x * 2 in GF(2^8)
  return ((x << 1) ^ ((x >> 7) * 0x1Du)) & 0xFFu;
}

// bytes {0, x, y, x ^ y}: c*v for v = 0..3, given x = c*1 and y = c*2
__device__ __forceinline__ uint32_t span4(uint32_t x, uint32_t y) {
  return (x << 8) | (y << 16) | ((x ^ y) << 24);
}

__device__ __forceinline__ uint32_t mad_hi(uint32_t x, uint32_t y, uint32_t z) {
  uint32_t d;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(y), "r"(z));
  return d;
}

__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t prmt(uint32_t lo, uint32_t hi, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(lo), "r"(hi), "r"(sel));
  return d;
}

// The three prmt selectors of each word of a chunk of one row of B.
__device__ __forceinline__ void selectors(const uint32_t (&w)[4], uint32_t (&s)[4][3]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t v0 = w[q] & kLow3;
    s[q][0] = mad_hi(v0, kSel0, v0);
    s[q][1] = mad_hi(w[q] & (kLow3 << 3), kSel1, 0u);
    s[q][2] = mad_hi(w[q] & (kLow2 << 6), kSel2, 0u);
  }
}

// c * (four bytes of B) from c's tables t (T0, T1) and u (T2)
__device__ __forceinline__ uint32_t lookup(const uint4& t, uint32_t u, const uint32_t (&s)[3]) {
  return xor3(prmt(t.x, t.y, s[0]), prmt(t.z, t.w, s[1]), prmt(u, 0u, s[2]));
}

template <int V>
__device__ __forceinline__ void load_chunk(const uint8_t* __restrict__ row, long long col,
                                           long long n, uint32_t (&w)[4]) {
  if (V == 16) {  // n % 16 == 0: every chunk is whole
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + col));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else if (V == 8) {
    const uint2* p = reinterpret_cast<const uint2*>(row + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint2 q = col + 8 * h + 8 <= n ? __ldg(p + h) : make_uint2(0u, 0u);
      w[2 * h] = q.x; w[2 * h + 1] = q.y;
    }
  } else if (V == 4) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row + col);
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = col + 4 * q + 4 <= n ? __ldg(p + q) : 0u;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t x = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long at = col + 4 * q + i;
        if (at < n) x |= static_cast<uint32_t>(__ldg(row + at)) << (8 * i);
      }
      w[q] = x;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_chunk(uint8_t* __restrict__ row, long long col, long long n,
                                            const uint32_t (&w)[4]) {
  if (V == 16) {
    *reinterpret_cast<uint4*>(row + col) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (V == 8) {
    uint2* p = reinterpret_cast<uint2*>(row + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (col + 8 * h + 8 <= n) p[h] = make_uint2(w[2 * h], w[2 * h + 1]);
    }
  } else if (V == 4) {
    uint32_t* p = reinterpret_cast<uint32_t*>(row + col);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (col + 4 * q + 4 <= n) p[q] = w[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long at = col + 4 * q + i;
        if (at < n) row[at] = static_cast<uint8_t>(w[q] >> (8 * i));
      }
    }
  }
}

// Rows 0 .. kGroup - 1 of B at `col`; rows past k read as zero.
template <int V>
__device__ __forceinline__ void load_first_rows(const uint8_t* __restrict__ b, int k, long long n,
                                                long long col, uint32_t (&bw)[kGroup][4]) {
  const uint8_t* row = b;
#pragma unroll
  for (int g = 0; g < kGroup; ++g, row += n) {
    if (g < k) {
      load_chunk<V>(row, col, n, bw[g]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) bw[g][q] = 0u;
    }
  }
}

// RT output rows per block, V-byte accesses (16, 8, 4 or 1).
template <int RT, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gf_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 uint8_t* __restrict__ c, int m, int k, long long n) {
  __shared__ uint4 t01[kMaxK * RT];    // {T0 lo, T0 hi, T1 lo, T1 hi} of A[row0 + r][j] at j*RT + r
  __shared__ uint32_t t2[kMaxK * RT];  // T2 of the same
  const int row0 = blockIdx.y * RT;
  const int kpad = (k + kGroup - 1) / kGroup * kGroup;
  for (int e = threadIdx.x; e < kpad * RT; e += blockDim.x) {
    const int j = e / RT, r = e - j * RT;
    uint32_t p[8];  // p[i] = c * 2^i; zero past M and K
    p[0] = row0 + r < m && j < k ? a[(row0 + r) * k + j] : 0u;
#pragma unroll
    for (int i = 1; i < 8; ++i) p[i] = xtime(p[i - 1]);
    const uint32_t lo0 = span4(p[0], p[1]), lo1 = span4(p[3], p[4]);
    t01[e] = make_uint4(lo0, lo0 ^ (p[2] * 0x01010101u), lo1, lo1 ^ (p[5] * 0x01010101u));
    t2[e] = span4(p[6], p[7]);
  }
  __syncthreads();

  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long ch = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t bw[kGroup][4];  // rows j0 .. j0 + 3 of B at this chunk
  if (ch < chunks) load_first_rows<V>(b, k, n, ch * kChunk, bw);
  for (; ch < chunks; ch += stride) {
    const long long col = ch * kChunk;
    uint32_t acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0u;
    }
    const bool more = ch + stride < chunks;
    for (int j0 = 0; j0 < k; j0 += kGroup) {
      // the rows that follow this group: the next group's, or past the last
      // group the first rows of this thread's next chunk
      const bool last = j0 + kGroup >= k;
      const long long next_col = last ? col + stride * kChunk : col;
      const uint8_t* next = b + static_cast<long long>(last ? 0 : j0 + kGroup) * n;
      const int next_rows = last ? (more ? k : 0) : k - j0 - kGroup;
#pragma unroll
      for (int g = 0; g < kGroup; g += 2, next += 2 * n) {
        uint32_t s0[4][3], s1[4][3];
        selectors(bw[g], s0);
        selectors(bw[g + 1], s1);
        // these two rows are in the selectors now: their registers take the
        // rows that follow, whose loads overlap the lookups below
        if (g < next_rows) load_chunk<V>(next, next_col, n, bw[g]);
        if (g + 1 < next_rows) load_chunk<V>(next + n, next_col, n, bw[g + 1]);
        const uint4* tp = t01 + (j0 + g) * RT;
        const uint32_t* up = t2 + (j0 + g) * RT;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const uint4 ta = tp[r], tb = tp[RT + r];
          const uint32_t ua = up[r], ub = up[RT + r];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r][q] = xor3(acc[r][q], lookup(ta, ua, s0[q]), lookup(tb, ub, s1[q]));
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (row0 + r < m) {
        uint32_t out[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q] = __byte_perm(acc[r][q], 0, 0x3120);  // bytes 0, 2, 1, 3 back
        store_chunk<V>(c + static_cast<long long>(row0 + r) * n, col, n, out);
      }
    }
  }
}

template <int RT, int V>
int launch_rows(const uint8_t* a, const uint8_t* b, uint8_t* c, int m, int k, long long n,
                int num_sms, cudaStream_t s) {
  static int per_sm = 0;  // resident blocks per SM, asked once per instance
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gf_matmul_kernel<RT, V>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_sm = std::max(per_sm, 1);
  }
  // one wave of resident blocks striding over the chunks, or one chunk per
  // thread when there are fewer (a Clay (10,6) chunkset: 513 blocks)
  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long want = (chunks + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(num_sms) * per_sm;
  const dim3 grid(static_cast<unsigned>(std::min(want, cap)), (m + RT - 1) / RT);
  gf_matmul_kernel<RT, V><<<grid, kThreads, 0, s>>>(a, b, c, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_width(const uint8_t* a, const uint8_t* b, uint8_t* c, int m, int k, long long n,
                 int num_sms, cudaStream_t s) {
  if (m == 1) return launch_rows<1, V>(a, b, c, m, k, n, num_sms, s);
  if (m == 2) return launch_rows<2, V>(a, b, c, m, k, n, num_sms, s);
  if (m <= 4) return launch_rows<4, V>(a, b, c, m, k, n, num_sms, s);
  if (m <= 6) return launch_rows<6, V>(a, b, c, m, k, n, num_sms, s);
  return launch_rows<8, V>(a, b, c, m, k, n, num_sms, s);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Launch C = A (x) B on `stream`.  a: (m, k), b: (k, n), c: (m, n), all
// contiguous uint8 on the current device; `num_sms` sizes the grid.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int gf_matmul_launch(const void* a, const void* b, void* c, int m, int k,
                                long long n, int num_sms, void* stream) {
  if (m < 1 || m > kMaxDim || k < 1 || k > kMaxDim || n < 1 || num_sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int vec = 1;  // the widest access every row of B and C allows
  for (int v : kWidths) {
    if (n % v == 0 && aligned(b, v) && aligned(c, v)) {
      vec = v;
      break;
    }
  }
  const uint8_t* a8 = static_cast<const uint8_t*>(a);
  const uint8_t* b8 = static_cast<const uint8_t*>(b);
  uint8_t* c8 = static_cast<uint8_t*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return launch_width<16>(a8, b8, c8, m, k, n, num_sms, s);
    case 8: return launch_width<8>(a8, b8, c8, m, k, n, num_sms, s);
    case 4: return launch_width<4>(a8, b8, c8, m, k, n, num_sms, s);
    default: return launch_width<1>(a8, b8, c8, m, k, n, num_sms, s);
  }
}

extern "C" const char* gf_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
