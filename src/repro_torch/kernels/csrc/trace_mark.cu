// Device marks of the port's spans (repro_torch/trace.py): one empty
// one-thread kernel per mark number, trace_mark_kernel<N>, launched on the
// stream a span's work runs on as the span enters and as it leaves.  The
// number is in the kernel's name, so a profiler's trace of the device says
// which span began or ended where, on the device's own clock; trace.py's
// MARKED table maps numbers to span names (span i: 2i begins, 2i + 1 ends).
//
// A stream runs its work in order, so every kernel, copy or memset between a
// span's two marks on that stream is the span's.  A mark costs one launch and
// the ~1-2 us an empty kernel occupies the stream; it runs only while a
// profiler records.
#include <cuda_runtime.h>

#include <array>
#include <utility>

constexpr int kMarks = 128;

template <int N>
__global__ void trace_mark_kernel() {}

namespace {

using Launch = void (*)(cudaStream_t);

template <int N>
void launch(cudaStream_t stream) {
  trace_mark_kernel<N><<<1, 1, 0, stream>>>();
}

template <int... N>
constexpr std::array<Launch, sizeof...(N)> table(std::integer_sequence<int, N...>) {
  return {&launch<N>...};
}

constexpr std::array<Launch, kMarks> kLaunch = table(std::make_integer_sequence<int, kMarks>{});

}  // namespace

extern "C" int trace_mark_count() { return kMarks; }

extern "C" int trace_mark_launch(int number, void* stream) {
  if (number < 0 || number >= kMarks) return static_cast<int>(cudaErrorInvalidValue);
  kLaunch[number](static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trace_mark_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
