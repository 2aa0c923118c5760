// Eighth-pel 4-tap chroma motion compensation over uniform 2x2 cells,
// for one plane or for U and V together.
//
// Replaces the Pallas kernels thor_tpu/ops/mc_pallas.py:
// mc_chroma_tiles_pallas (_chroma_kernel, one plane) and
// mc_chroma_uv_tiles_pallas (_chroma_uv_kernel, U and V sharing per-tile
// offsets and fractions), and on the decoder's main path the XLA gather
// thor_tpu/dec/device_pixels.py:mc_cells_chroma, which pixel_core calls
// for U and V with the same cell metadata.  Filter taps COEFFS_CHROMA,
// horizontal then vertical with one rounding (acc+2048)>>12; op copy
// takes the window centre, any other op filters.  Output [N, 2, 2] int32
// per plane, as in JAX.
//
// What bounds it on an H100: bytes, as for the luma kernel (at most 25
// distinct int16 samples per cell and plane, six int32 of metadata, 4
// int32 out per plane), not the arithmetic, and tensor cores are not the
// lever (12-bit samples, per-cell taps).  Design (mc_common.cuh): a warp
// owns 32 cells, a lane per cell, four groups to a CTA; each cell's
// metadata is loaded once and serves both planes (what the TPU's U+V
// kernel bought by sharing its scalar pass); each lane reads the window
// rows its op needs with 16-byte loads, filters in registers (the 4-tap
// horizontal pass of a row, then that row's share of the vertical pass)
// and writes each plane's 2x2 outputs with one 16-byte store.  The taps
// are a __constant__ array set here, which each CTA copies to shared
// memory; thor_mc_chroma_taps lets the wrapper hold them equal to
// tables.py.

#include "mc_common.cuh"

namespace thor {

// COEFFS_CHROMA (tables.py), [frac][tap]
__constant__ int c_chroma_bank[8 * 4] = {
    0,  64, 0,  0,  -2, 58, 10, -2, -4, 54, 16, -2, -4, 44, 28, -4,
    -4, 36, 36, -4, -4, 28, 44, -4, -2, 16, 54, -4, -2, 10, 58, -2};

template <int NPLANES>
struct ChromaCells {
  static constexpr int CS = 2;
  static constexpr int TAPS = 4;
  static constexpr int P = NPLANES;
  static constexpr int W = CS + TAPS - 1;
  static constexpr int kBank = 8 * TAPS;

  static __device__ __forceinline__ int bank(int k) {
    return c_chroma_bank[k];
  }

  static constexpr int kRawN = 6;   // metadata arrays: rsel .. hf

  static __device__ __forceinline__ void decode(
      const McArgs& a, const int (&v)[kRaw], int& r, int& y0, int& x0,
      int& op, int& fv, int& fh) {
    r = jidx(v[0], a.R);
    y0 = v[1];
    x0 = v[2];
    op = v[3];
    fv = jidx(v[4], 8);
    fh = jidx(v[5], 8);
  }

  // The cell's output rows i need window row 1 + i alone: a copy, or the
  // filter at a whole-sample vertical position (bank row 0: the taps 0,
  // 64, 0, 0).
  static __device__ __forceinline__ bool centre_rows(int op, int fv) {
    return op == kOpCopy || fv == 0;
  }

  // One cell's output in one plane from its window rows: each row is
  // filtered horizontally as it arrives and added, with its vertical tap,
  // to the output rows it reaches; with `centre` (centre_rows holds for
  // every cell of the warp) the filter reads the centre rows alone.  A
  // copy reads the centre rows.
  template <class Rd>
  static __device__ __forceinline__ void cell(const Rd& rd, const int* bank,
                                              int op, int fv, int fh,
                                              bool centre, int maxv,
                                              int (&v)[CS][CS]) {
    int s[W];
    if (op == kOpCopy) {
#pragma unroll
      for (int i = 0; i < CS; ++i) {
        rd.template get<1, 1 + CS>(1 + i, s);
#pragma unroll
        for (int j = 0; j < CS; ++j) v[i][j] = s[1 + j];
      }
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
    int acc[CS][CS] = {};
    int t[CS];
    if (centre) {
#pragma unroll
      for (int i = 0; i < CS; ++i) {
        hpass(1 + i, t);
#pragma unroll
        for (int j = 0; j < CS; ++j) acc[i][j] = tv[1] * t[j];
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

// ref_v and out_v are null for the one-plane case; cs must be 2 (the
// wrapper checks it).
extern "C" int thor_mc_chroma_cells(
    int device, const int16_t* ref_u, const int16_t* ref_v, int R, int Hp,
    int Wp, const int32_t* rsel, const int32_t* y0, const int32_t* x0,
    const int32_t* op, const int32_t* vf, const int32_t* hf, long long N,
    int cs, int bitdepth, int32_t* out_u, int32_t* out_v, void* stream) {
  if (cs != thor::ChromaCells<1>::CS) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  thor::McArgs a{};
  a.ref[0] = ref_u;
  a.ref[1] = ref_v;
  a.R = R;
  a.Hp = Hp;
  a.Wp = Wp;
  a.rsel = rsel;
  a.y0 = y0;
  a.x0 = x0;
  a.op = op;
  a.vf = vf;
  a.hf = hf;
  a.n = N;
  a.maxv = (1 << bitdepth) - 1;
  a.vec_ok = thor::vec_ok(ref_u, Hp, Wp) &&
             (ref_v == nullptr || thor::vec_ok(ref_v, Hp, Wp));
  a.out[0] = out_u;
  a.out[1] = out_v;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ref_v == nullptr)
    return thor::launch_cells<thor::ChromaCells<1>>(a, s);
  return thor::launch_cells<thor::ChromaCells<2>>(a, s);
}

// The taps the kernel filters with: 32 ints [frac][tap].
extern "C" int thor_mc_chroma_taps(int32_t* bank) {
  return cudaMemcpyFromSymbol(bank, thor::c_chroma_bank,
                              sizeof(thor::c_chroma_bank));
}
