// Quarter-pel luma motion compensation over uniform cs x cs cells.
//
// Replaces the Pallas kernel thor_tpu/ops/mc_pallas.py:mc_luma_tiles_pallas
// (body _kernel), and on the decoder's main path the XLA gather it was
// written for, thor_tpu/dec/device_pixels.py:mc_cells_luma: per cell a
// reference index into a stack of padded planes, a window origin, an op
// (copy, separable 6-tap with one rounding (acc+2048)>>12, or the 4x4
// centre lowpass (lp+8)>>4), the fractions and the filter set (standard
// or bipred taps).  Output layout [N, cs, cs] int32, as in JAX.
//
// What bounds it on an H100: the gather.  Each output pixel reads up to
// 36 int16 reference samples at a data-dependent address and writes one
// int32; at 1080p (130,560 cells of 4x4) the unique bytes are the two
// reference planes (~6 MB each), the cell metadata (3.6 MB) and the
// output (8.4 MB), so the kernel is bound by L1/L2 traffic and latency,
// not by arithmetic.  The TPU kernel's aligned 32x256 window DMAs,
// double buffering, pltpu.roll and SMEM taps have no meaning here.
// Design: one thread per output pixel; the cs*cs threads of one cell are
// adjacent lanes of one warp, so their window rows fall on the same cache
// lines and the per-cell metadata loads are broadcast; the taps sit in
// __constant__ memory (at most two distinct fractions per warp at cs=4).
// The kernel reads the int16 reference ring directly, with no int32 copy
// of the planes.

#include "mc_common.cuh"

namespace thor {

__constant__ int c_luma_bank[2 * 4 * 6];   // [fset, frac, tap]
__constant__ int c_lowpass[4 * 4];

__global__ void __launch_bounds__(kThreads) mc_luma_cells_kernel(
    const int16_t* __restrict__ ref, int R, int Hp, int Wp,
    const int32_t* __restrict__ rsel, const int32_t* __restrict__ y0,
    const int32_t* __restrict__ x0, const int32_t* __restrict__ op,
    const int32_t* __restrict__ vf, const int32_t* __restrict__ hf,
    const int32_t* __restrict__ fs, long long total, int cs, int maxv,
    int32_t* __restrict__ out) {
  long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= total) return;
  const int area = cs * cs;
  const long long n = t / area;
  const int p = static_cast<int>(t - n * area);
  const int i = p / cs;
  const int j = p - i * cs;
  const int16_t* plane = ref + static_cast<size_t>(jidx(rsel[n], R)) * Hp * Wp;
  // top-left of this pixel's 6x6 window (the cell window starts at
  // origin - 2)
  const int wy = y0[n] - 2 + i;
  const int wx = x0[n] - 2 + j;
  const int o = op[n];
  int v;
  if (o == kOpCopy) {
    v = plane[static_cast<size_t>(jidx(wy + 2, Hp)) * Wp + jidx(wx + 2, Wp)];
  } else if (o == kOpLowpass) {
    int acc = 0;
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
      const size_t row = static_cast<size_t>(jidx(wy + 1 + dy, Hp)) * Wp;
#pragma unroll
      for (int dx = 0; dx < 4; ++dx)
        acc += c_lowpass[dy * 4 + dx] * plane[row + jidx(wx + 1 + dx, Wp)];
    }
    v = clip_px((acc + 8) >> 4, maxv);
  } else {
    const int set = jidx(fs[n], 2);
    const int* fv = c_luma_bank + (set * 4 + jidx(vf[n], 4)) * 6;
    const int* fh = c_luma_bank + (set * 4 + jidx(hf[n], 4)) * 6;
    int acc = 0;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      const size_t row = static_cast<size_t>(jidx(wy + m, Hp)) * Wp;
      int h = 0;
#pragma unroll
      for (int k = 0; k < 6; ++k) h += fh[k] * plane[row + jidx(wx + k, Wp)];
      acc += fv[m] * h;
    }
    v = clip_px((acc + 2048) >> 12, maxv);
  }
  out[t] = v;
}

}  // namespace thor

extern "C" int thor_mc_luma_cells(
    int device, const int16_t* ref, int R, int Hp, int Wp,
    const int32_t* rsel, const int32_t* y0, const int32_t* x0,
    const int32_t* op, const int32_t* vf, const int32_t* hf,
    const int32_t* fs, int N, int cs, int bitdepth, const int32_t* bank,
    const int32_t* lowpass, int32_t* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemcpyToSymbolAsync(thor::c_luma_bank, bank, sizeof(int) * 48, 0,
                              cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return e;
  e = cudaMemcpyToSymbolAsync(thor::c_lowpass, lowpass, sizeof(int) * 16, 0,
                              cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(N) * cs * cs;
  const unsigned blocks =
      static_cast<unsigned>((total + thor::kThreads - 1) / thor::kThreads);
  thor::mc_luma_cells_kernel<<<blocks, thor::kThreads, 0, s>>>(
      ref, R, Hp, Wp, rsel, y0, x0, op, vf, hf, fs, total, cs,
      (1 << bitdepth) - 1, out);
  return cudaGetLastError();
}

extern "C" const char* thor_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
