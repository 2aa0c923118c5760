// Eighth-pel 4-tap chroma motion compensation over uniform cs x cs cells,
// for one plane or for U and V together.
//
// Replaces the Pallas kernels thor_tpu/ops/mc_pallas.py:
// mc_chroma_tiles_pallas (_chroma_kernel, one plane) and
// mc_chroma_uv_tiles_pallas (_chroma_uv_kernel, U and V sharing per-tile
// offsets and fractions), and on the decoder's main path the XLA gather
// thor_tpu/dec/device_pixels.py:mc_cells_chroma, which pixel_core calls
// for U and V with the same cell metadata.  Filter taps COEFFS_CHROMA, one
// rounding (acc+2048)>>12 after both passes, so the pass order does not
// matter; op copy takes the window centre.  Output [N, cs, cs] int32 per
// plane, as in JAX.
//
// What bounds it on an H100: as for the luma kernel, the data-dependent
// gather (up to 16 int16 samples per output pixel and plane), not the
// arithmetic.  Design: one thread per output pixel of a cell; the thread
// reads the cell's metadata once and filters both planes with it, which
// is what the TPU's U+V kernel bought by sharing its scalar pass.  Taps
// in __constant__ memory; the int16 ring planes are read directly.

#include "mc_common.cuh"

namespace thor {

__constant__ int c_chroma_bank[8 * 4];   // [frac, tap]

static __device__ __forceinline__ int chroma_px(
    const int16_t* plane, int Hp, int Wp, int wy, int wx, bool copy,
    const int* fv, const int* fh, int maxv) {
  if (copy)
    return plane[static_cast<size_t>(jidx(wy + 1, Hp)) * Wp + jidx(wx + 1, Wp)];
  int acc = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const size_t row = static_cast<size_t>(jidx(wy + m, Hp)) * Wp;
    int h = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) h += fh[k] * plane[row + jidx(wx + k, Wp)];
    acc += fv[m] * h;
  }
  return clip_px((acc + 2048) >> 12, maxv);
}

__global__ void __launch_bounds__(kThreads) mc_chroma_cells_kernel(
    const int16_t* __restrict__ ref_u, const int16_t* __restrict__ ref_v,
    int R, int Hp, int Wp, const int32_t* __restrict__ rsel,
    const int32_t* __restrict__ y0, const int32_t* __restrict__ x0,
    const int32_t* __restrict__ op, const int32_t* __restrict__ vf,
    const int32_t* __restrict__ hf, long long total, int cs, int maxv,
    int32_t* __restrict__ out_u, int32_t* __restrict__ out_v) {
  long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= total) return;
  const int area = cs * cs;
  const long long n = t / area;
  const int p = static_cast<int>(t - n * area);
  const int i = p / cs;
  const int j = p - i * cs;
  const size_t base = static_cast<size_t>(jidx(rsel[n], R)) * Hp * Wp;
  // top-left of this pixel's 4x4 window (the cell window starts at
  // origin - 1)
  const int wy = y0[n] - 1 + i;
  const int wx = x0[n] - 1 + j;
  const bool copy = op[n] == kOpCopy;
  const int* fv = c_chroma_bank + jidx(vf[n], 8) * 4;
  const int* fh = c_chroma_bank + jidx(hf[n], 8) * 4;
  out_u[t] = chroma_px(ref_u + base, Hp, Wp, wy, wx, copy, fv, fh, maxv);
  if (ref_v != nullptr)
    out_v[t] = chroma_px(ref_v + base, Hp, Wp, wy, wx, copy, fv, fh, maxv);
}

}  // namespace thor

// ref_v and out_v are null for the one-plane case.
extern "C" int thor_mc_chroma_cells(
    int device, const int16_t* ref_u, const int16_t* ref_v, int R, int Hp,
    int Wp, const int32_t* rsel, const int32_t* y0, const int32_t* x0,
    const int32_t* op, const int32_t* vf, const int32_t* hf, int N, int cs,
    int bitdepth, const int32_t* bank, int32_t* out_u, int32_t* out_v,
    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemcpyToSymbolAsync(thor::c_chroma_bank, bank, sizeof(int) * 32, 0,
                              cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(N) * cs * cs;
  const unsigned blocks =
      static_cast<unsigned>((total + thor::kThreads - 1) / thor::kThreads);
  thor::mc_chroma_cells_kernel<<<blocks, thor::kThreads, 0, s>>>(
      ref_u, ref_v, R, Hp, Wp, rsel, y0, x0, op, vf, hf, total, cs,
      (1 << bitdepth) - 1, out_u, out_v);
  return cudaGetLastError();
}
