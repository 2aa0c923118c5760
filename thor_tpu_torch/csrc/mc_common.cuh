// Shared helpers of the motion-compensation kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace thor {

constexpr int kOpCopy = 1;      // dec/device_pixels.py OP_COPY
constexpr int kOpLowpass = 3;   // dec/device_pixels.py OP_LOWPASS
constexpr int kThreads = 256;

// An index as a JAX gather takes it: a negative index counts from the
// end, then the result is clamped into [0, n).  The kernels apply it to
// every window coordinate and table index, so that they equal the XLA
// gathers of dec/device_pixels.py:mc_cells_* on any input, in bounds or
// not.
static __device__ __forceinline__ int jidx(int i, int n) {
  if (i < 0) i += n;
  return min(max(i, 0), n - 1);
}

static __device__ __forceinline__ int clip_px(int v, int maxv) {
  return min(max(v, 0), maxv);
}

}  // namespace thor
