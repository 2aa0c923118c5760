// Quarter-pel luma motion compensation over uniform 4x4 cells.
//
// Replaces the Pallas kernel thor_tpu/ops/mc_pallas.py:mc_luma_tiles_pallas
// (body _kernel), and on the decoder's main path the XLA gather it was
// written for, thor_tpu/dec/device_pixels.py:mc_cells_luma: per cell a
// reference index into a stack of padded planes, a window origin, an op
// (copy, separable 6-tap with one rounding (acc+2048)>>12, or the 4x4
// centre lowpass (lp+8)>>4; any other op value filters, as in JAX), the
// fractions and the filter set (standard or bipred taps).  Output
// [N, 4, 4] int32, as in JAX.
//
// What bounds it on an H100: bytes.  A cell needs at most 81 distinct
// int16 samples, seven int32 of metadata and writes 16 int32; at 1080p
// (130,560 cells) that is about 20 MB, 6 us at 3.35 TB/s, while the
// arithmetic is at most 20 multiply-adds per pixel.  Tensor cores are not
// the lever: samples reach 12 bits and the taps differ per cell, and the
// work is bound by memory traffic.  Design (mc_common.cuh): a warp owns
// 32 cells, a lane per cell, four groups to a CTA; each lane reads the
// window rows its op needs with 16-byte loads and runs the separable
// filter in registers (the 6-tap horizontal pass of a row, then that
// row's share of the vertical pass), and writes its 16 outputs with
// 16-byte stores, so a group's outputs are one contiguous run.  The taps
// are __constant__ arrays set here, which each CTA copies to shared
// memory (the lanes of a warp index them differently); thor_mc_luma_taps
// lets the wrapper hold them equal to tables.py.

#include "mc_common.cuh"

namespace thor {

// COEFFS_STANDARD then COEFFS_BIPRED (tables.py), [fset][frac][tap]
__constant__ int c_luma_bank[2 * 4 * 6] = {
    0, 0, 64, 0,  0,  0,  1, -7,  55, 19, -5, 1,
    1, -7, 38, 38, -7, 1, 1, -5,  19, 55, -7, 1,
    0, 0, 64, 0,  0,  0,  2, -10, 59, 17, -5, 1,
    1, -8, 39, 39, -8, 1, 1, -5,  17, 59, -10, 2};
// LOWPASS_K (tables.py)
__constant__ int c_lowpass[4 * 4] = {0, 1, 1, 0, 1, 2, 2, 1,
                                     1, 2, 2, 1, 0, 1, 1, 0};

struct LumaCells {
  static constexpr int CS = 4;
  static constexpr int TAPS = 6;
  static constexpr int P = 1;
  static constexpr int W = CS + TAPS - 1;
  static constexpr int kBank = 2 * 4 * TAPS;

  static __device__ __forceinline__ int bank(int k) { return c_luma_bank[k]; }

  static constexpr int kRawN = 7;   // metadata arrays: rsel .. fs

  static __device__ __forceinline__ void decode(
      const McArgs& a, const int (&v)[kRaw], int& r, int& y0, int& x0,
      int& op, int& fv, int& fh) {
    r = jidx(v[0], a.R);
    y0 = v[1];
    x0 = v[2];
    op = v[3];
    const int set = jidx(v[6], 2);
    fv = set * 4 + jidx(v[4], 4);
    fh = set * 4 + jidx(v[5], 4);
  }

  // The cell's output rows i need window row 2 + i alone: a copy, or the
  // six-tap at a whole-sample vertical position (bank row f with f % 4 ==
  // 0: the taps 0, 0, 64, 0, 0, 0).
  static __device__ __forceinline__ bool centre_rows(int op, int fv) {
    return op == kOpCopy || (op != kOpLowpass && fv % 4 == 0);
  }

  // One cell's output from its window rows.  The six-tap filters each
  // window row horizontally as it arrives and adds it, with its vertical
  // tap, to the output rows it reaches; with `centre` (centre_rows holds
  // for every cell of the warp) it reads the centre rows alone.  A copy
  // reads the centre rows, the lowpass rows 1..7.
  template <class Rd>
  static __device__ __forceinline__ void cell(const Rd& rd, const int* bank,
                                              int op, int fv, int fh,
                                              bool centre, int maxv,
                                              int (&v)[CS][CS]) {
    int s[W];
    if (op == kOpCopy) {
#pragma unroll
      for (int i = 0; i < CS; ++i) {
        rd.template get<2, 2 + CS>(2 + i, s);
#pragma unroll
        for (int j = 0; j < CS; ++j) v[i][j] = s[2 + j];
      }
      return;
    }
    int acc[CS][CS] = {};
    if (op == kOpLowpass) {   // window rows and columns 1 .. CS + 3
#pragma unroll
      for (int r = 1; r < CS + 4; ++r) {
        rd.template get<1, CS + 4>(r, s);
#pragma unroll
        for (int i = 0; i < CS; ++i) {
          const int dy = r - 1 - i;
          if (dy < 0 || dy >= 4) continue;
#pragma unroll
          for (int j = 0; j < CS; ++j)
#pragma unroll
            for (int dx = 0; dx < 4; ++dx)
              acc[i][j] += c_lowpass[dy * 4 + dx] * s[1 + j + dx];
        }
      }
#pragma unroll
      for (int i = 0; i < CS; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j)
          v[i][j] = clip_px((acc[i][j] + 8) >> 4, maxv);
      return;
    }
    int th[TAPS], tv[TAPS];
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      th[k] = bank[fh * TAPS + k];
      tv[k] = bank[fv * TAPS + k];
    }
    // the horizontal pass of window row r
    auto hpass = [&](int r, int (&t)[CS]) {
      rd.template get<0, W>(r, s);
#pragma unroll
      for (int j = 0; j < CS; ++j) {
        t[j] = 0;
#pragma unroll
        for (int k = 0; k < TAPS; ++k) t[j] += th[k] * s[j + k];
      }
    };
    int t[CS];
    if (centre) {
#pragma unroll
      for (int i = 0; i < CS; ++i) {
        hpass(2 + i, t);
#pragma unroll
        for (int j = 0; j < CS; ++j) acc[i][j] = tv[2] * t[j];
      }
    } else {
#pragma unroll
      for (int r = 0; r < W; ++r) {
        hpass(r, t);
#pragma unroll
        for (int i = 0; i < CS; ++i) {
          const int m = r - i;
          if (m < 0 || m >= TAPS) continue;
#pragma unroll
          for (int j = 0; j < CS; ++j) acc[i][j] += tv[m] * t[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < CS; ++i)
#pragma unroll
      for (int j = 0; j < CS; ++j)
        v[i][j] = clip_px((acc[i][j] + 2048) >> 12, maxv);
  }
};

}  // namespace thor

// cs must be 4 (the wrapper checks it).
extern "C" int thor_mc_luma_cells(
    int device, const int16_t* ref, int R, int Hp, int Wp,
    const int32_t* rsel, const int32_t* y0, const int32_t* x0,
    const int32_t* op, const int32_t* vf, const int32_t* hf,
    const int32_t* fs, long long N, int cs, int bitdepth, int32_t* out,
    void* stream) {
  if (cs != thor::LumaCells::CS) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  thor::McArgs a{};
  a.ref[0] = ref;
  a.R = R;
  a.Hp = Hp;
  a.Wp = Wp;
  a.rsel = rsel;
  a.y0 = y0;
  a.x0 = x0;
  a.op = op;
  a.vf = vf;
  a.hf = hf;
  a.fs = fs;
  a.n = N;
  a.maxv = (1 << bitdepth) - 1;
  a.vec_ok = thor::vec_ok(ref, Hp, Wp);
  a.out[0] = out;
  return thor::launch_cells<thor::LumaCells>(
      a, static_cast<cudaStream_t>(stream));
}

// The taps the kernel filters with: 48 ints [fset][frac][tap] and the 16
// lowpass weights.
extern "C" int thor_mc_luma_taps(int32_t* bank, int32_t* lowpass) {
  cudaError_t e = cudaMemcpyFromSymbol(bank, thor::c_luma_bank,
                                       sizeof(thor::c_luma_bank));
  if (e != cudaSuccess) return e;
  return cudaMemcpyFromSymbol(lowpass, thor::c_lowpass,
                              sizeof(thor::c_lowpass));
}

extern "C" const char* thor_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
