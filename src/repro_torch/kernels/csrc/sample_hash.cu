// Bulk audit-sample digests on Hopper: out[l] = mix(words[l, 0 .. W)), an
// xxhash32-style lane mix with uint32 wraparound:
//
//   acc = seed + P4;  per word: acc += w * P2; acc = rotl(acc, 13) * P1;
//   avalanche: acc ^= acc >> 15; acc *= P2; acc ^= acc >> 13; acc *= P3;
//              acc ^= acc >> 16.
//
// Replaces the Pallas TPU kernel repro/kernels/sample_hash.py::sample_hash
// (body `_kernel`): the digests of core/commitments.py::bulk_sample_digests,
// one leaf per 1 KiB audit sample (W = 256 words).
//
// What bounds it on an H100: bytes.  Every word is read once and used once
// (4 integer operations per 4 bytes), so the floor is L * W * 4 bytes over
// HBM bandwidth: about 0.52 ms for the 1.69 M samples of a 1 GiB put's
// coded chunks at 3.35 TB/s.
//
// Design (first version): one thread owns one leaf, because a leaf's words
// form one dependent chain; a persistent grid of a few blocks per SM strides
// over the leaves.  When W % 4 == 0 and the words are 16-byte aligned (every
// 1 KiB sample) a thread reads its row with 16-byte loads through the
// read-only cache; otherwise it reads single words.  The ragged tail of L is
// masked by the loop bound: no padding, no read past the last leaf.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 2246822519u;
constexpr uint32_t kP3 = 3266489917u;
constexpr uint32_t kP4 = 668265263u;
constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ uint32_t mix(uint32_t acc, uint32_t w) {
  acc += w * kP2;
  acc = __funnelshift_l(acc, acc, 13);  // rotl 13
  return acc * kP1;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
sample_hash_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                   long long leaves, int w, uint32_t init) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long l = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       l < leaves; l += stride) {
    const uint32_t* row = words + l * w;
    uint32_t acc = init;
    if (kVec) {
      const uint4* row4 = reinterpret_cast<const uint4*>(row);
      const int quads = w >> 2;
#pragma unroll 8
      for (int i = 0; i < quads; ++i) {
        const uint4 v = __ldg(row4 + i);
        acc = mix(acc, v.x);
        acc = mix(acc, v.y);
        acc = mix(acc, v.z);
        acc = mix(acc, v.w);
      }
    } else {
      for (int i = 0; i < w; ++i) acc = mix(acc, __ldg(row + i));
    }
    acc ^= acc >> 15;
    acc *= kP2;
    acc ^= acc >> 13;
    acc *= kP3;
    acc ^= acc >> 16;
    out[l] = acc;
  }
}

}  // namespace

// Launch the digests of `leaves` rows of `w` uint32 words on `stream`.
// words: (leaves, w) contiguous, out: (leaves,), both on the current device;
// `seed` is taken mod 2^32; `num_sms` sizes the persistent grid.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int sample_hash_launch(const void* words, void* out, long long leaves, int w,
                                  unsigned int seed, int num_sms, void* stream) {
  if (leaves < 1 || w < 1 || num_sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (w % 4 == 0) && (reinterpret_cast<uintptr_t>(words) % 16 == 0);
  const long long want = (leaves + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(num_sms) * kBlocksPerSM;
  const dim3 grid(static_cast<unsigned>(std::min(want, cap)));
  const uint32_t init = static_cast<uint32_t>(seed) + kP4;  // wraps mod 2^32
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(words);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (vec) {
    sample_hash_kernel<true><<<grid, kThreads, 0, s>>>(in, o, leaves, w, init);
  } else {
    sample_hash_kernel<false><<<grid, kThreads, 0, s>>>(in, o, leaves, w, init);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sample_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
