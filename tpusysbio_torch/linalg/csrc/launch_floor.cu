// An empty kernel, launched through the same route as the port's kernels
// (a plain C entry point called with ctypes on PyTorch's current stream).
//
// It exists only to measure the launch floor: the time the card takes for a
// kernel that does nothing, which no one-launch kernel can go below however
// few bytes it moves. chip_smoke.py times it (its [floor] line) beside the
// bytes bounds of the real kernels. The port never calls it.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

// Launches `blocks` blocks of `threads` threads that return at once.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tsb_launch_floor(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024) {
    return cudaErrorInvalidValue;
  }
  launch_floor_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
