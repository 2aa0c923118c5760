// The cell-group machinery shared by the motion-compensation kernels
// (mc_luma.cu, mc_chroma.cu).
//
// A warp owns a group of kGroup = 32 consecutive cells, a lane per cell;
// a CTA holds kWarps groups, and the grid covers every group.  A lane
// loads its cell's metadata, reads the window rows its op needs straight
// from device memory through L1, and filters in registers.  Neighbouring
// cells of a real stream share their rows' cache lines, so a warp's row
// loads touch a few lines each.
//
// A window row that stays inside the plane is read as the two aligned
// 16-byte chunks that hold it, and a funnel of byte permutes takes its
// samples out (Rows below); a row that leaves the plane's columns is
// gathered sample by sample with the column clamp `jidx`.  Rows are
// clamped with `jidx` once each.
//
// Measured on an H100 (PERF.md), this beat the designs that stage
// the windows in shared memory first (a CTA of 32 cells x cs threads with
// a cp.async ring; a warp per group with cp.async rows, or one cp.async
// box per coherent group), and a persistent grid: the staging cost
// shared memory that would otherwise hold more warps, the loads it
// replaced hit L1, and the card keeps more groups in flight when it
// schedules the CTAs itself.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace thor {

constexpr int kOpCopy = 1;      // dec/device_pixels.py OP_COPY
constexpr int kOpLowpass = 3;   // dec/device_pixels.py OP_LOWPASS
constexpr int kGroup = 32;      // cells per group: the lanes of a warp
constexpr int kWarps = 4;       // groups per CTA
// the raw metadata of a cell: rsel, y0, x0, op, vf, hf and (luma) fs
constexpr int kRaw = 7;

// An index as a JAX gather takes it: a negative index counts from the
// end, then the result is clamped into [0, n).  Applied to every window
// coordinate, table index and reference index (in 64 bits, so that no
// int32 input overflows on the way), the kernels equal the XLA gathers
// of dec/device_pixels.py:mc_cells_* on any input, in bounds or not.
static __device__ __forceinline__ int jidx(long long i, int n) {
  if (i < 0) i += n;
  return static_cast<int>(i < 0 ? 0 : (i >= n ? n - 1 : i));
}

static __device__ __forceinline__ int clip_px(int v, int maxv) {
  return min(max(v, 0), maxv);
}

// Arguments of one launch.  `ref` holds one reference stack per plane
// ([R, Hp, Wp] int16 each, U and V for the two-plane chroma case); `fs`
// is null for chroma.
struct McArgs {
  const int16_t* ref[2];
  int R, Hp, Wp;
  const int32_t* rsel;
  const int32_t* y0;
  const int32_t* x0;
  const int32_t* op;
  const int32_t* vf;
  const int32_t* hf;
  const int32_t* fs;
  long long n;       // cells
  int maxv;          // (1 << bitdepth) - 1
  int vec_ok;        // planes allow aligned 16-byte loads (vec_ok below)
  int32_t* out[2];   // [n, cs, cs] per plane
};

// The planes allow the aligned 16-byte row loads: 16-byte aligned, and
// rows and planes a multiple of 8 samples long.
static inline int vec_ok(const int16_t* p, int Hp, int Wp) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && Wp % 8 == 0 &&
         (static_cast<long long>(Hp) * Wp) % 8 == 0;
}

static __device__ __forceinline__ int prmt(uint32_t a, uint32_t b,
                                           uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return static_cast<int>(r);
}

// Samples C0 .. C1-1 of a window row that starts `off` samples into the
// 16 int16 of (lo, hi); the other entries of s are left unset.  A sample
// is one prmt of a word pair: its two bytes and their sign, so int16
// samples widen exactly.
template <int W, int C0, int C1>
__device__ __forceinline__ void extract(const uint4 lo, const uint4 hi,
                                        int off, int (&s)[W]) {
  static_assert(0 <= C0 && C0 < C1 && C1 <= W && W <= 9,
                "a window row fits the 16 samples after off");
  uint32_t w[9] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w, 0u};
  const int ws = off >> 1;   // whole words to drop, 0..3
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = (ws & 1) ? w[k + 1] : w[k];
#pragma unroll
  for (int k = 0; k < 7; ++k) w[k] = (ws & 2) ? w[k + 2] : w[k];
  // sample k is a half of word k/2 (even offset) or of word (k+1)/2 (odd
  // offset): the low half with its sign is selector 0x9910, the high half
  // 0xBB32, the low half of the next word 0xDD54
  const bool odd = off & 1;
  const uint32_t even_k = odd ? 0xBB32u : 0x9910u;
  const uint32_t odd_k = odd ? 0xDD54u : 0xBB32u;
#pragma unroll
  for (int k = C0; k < C1; ++k)
    s[k] = prmt(w[k >> 1], w[(k >> 1) + 1], (k & 1) ? odd_k : even_k);
}

// Window rows as a lane reads them: get<C0, C1>(r, s) sets samples
// C0 .. C1-1 of window row r.
//
// For a window inside the plane's columns: the two aligned 16-byte
// chunks at column xs of the clamped row.  Both are read whether the
// samples asked for need them or not: a load under a condition becomes a
// branch, and the compiler then no longer issues the loads of several
// rows before it waits for the first.  Where the second chunk would pass
// the row's end the window lies in the first, and the first is read
// twice.
template <int W>
struct Rows {
  const int16_t* plane;
  long long wy;
  int Hp, Wp, xs, off;
  template <int C0, int C1>
  __device__ __forceinline__ void get(int r, int (&s)[W]) const {
    const uint4* q = reinterpret_cast<const uint4*>(
        plane + static_cast<long long>(jidx(wy + r, Hp)) * Wp + xs);
    extract<W, C0, C1>(__ldg(q), __ldg(q + (xs + 16 <= Wp)), off, s);
  }
};

// For a window that leaves the plane's columns (or planes that do not
// allow the 16-byte loads): sample by sample, with both clamps.
template <int W>
struct GatherRows {
  const int16_t* plane;
  long long wy, wx;
  int Hp, Wp;
  template <int C0, int C1>
  __device__ __forceinline__ void get(int r, int (&s)[W]) const {
    const int16_t* row =
        plane + static_cast<long long>(jidx(wy + r, Hp)) * Wp;
#pragma unroll
    for (int c = C0; c < C1; ++c) s[c] = __ldg(row + jidx(wx + c, Wp));
  }
};

static __device__ __forceinline__ const int32_t* raw_array(const McArgs& a,
                                                           int k) {
  switch (k) {   // constant indices: a computed one would copy `a` to the stack
    case 0: return a.rsel;
    case 1: return a.y0;
    case 2: return a.x0;
    case 3: return a.op;
    case 4: return a.vf;
    case 5: return a.hf;
    default: return a.fs;
  }
}

// One lane's cell: cell index g * 32 + lane, where g is the warp's group.
// The lane loads the cell's metadata (the warp's loads of one array are
// one coalesced 128-byte request), reads the window rows its op needs,
// filters, and writes its cs x cs int32 outputs with 16-byte stores (a
// cell's outputs are contiguous, so a group's are one run).
template <class K>
__device__ __forceinline__ void mc_cell(long long g, const McArgs& a,
                                        const int* bank) {
  constexpr int CS = K::CS;
  constexpr int W = K::W;
  constexpr int BACK = K::TAPS / 2 - 1;
  static_assert(CS * CS % 4 == 0, "a cell's outputs are whole int4s");
  const long long cell = g * kGroup + (threadIdx.x & 31);
  const bool valid = cell < a.n;
  int v[kRaw] = {};
  if (valid) {
#pragma unroll
    for (int k = 0; k < K::kRawN; ++k) v[k] = __ldg(raw_array(a, k) + cell);
  }
  int r, y0, x0, op, fv, fh;
  K::decode(a, v, r, y0, x0, op, fv, fh);
  // the warp reads the centre rows alone when no filter of it needs more
  // (a vote of all lanes, so that they do not split between two loops)
  const bool centre =
      __all_sync(0xffffffffu, !valid || K::centre_rows(op, fv));
  if (!valid) return;
  const long long wy = static_cast<long long>(y0) - BACK;
  const long long wx = static_cast<long long>(x0) - BACK;
  const bool vec = a.vec_ok && wx >= 0 && wx + W <= a.Wp;
  const int xs = vec ? static_cast<int>(wx) & ~7 : 0;
  const long long plane = static_cast<long long>(a.Hp) * a.Wp;
#pragma unroll
  for (int p = 0; p < K::P; ++p) {
    const int16_t* pl = a.ref[p] + r * plane;
    int o[CS][CS];
    if (vec)
      K::cell(Rows<W>{pl, wy, a.Hp, a.Wp, xs, static_cast<int>(wx) - xs},
              bank, op, fv, fh, centre, a.maxv, o);
    else
      K::cell(GatherRows<W>{pl, wy, wx, a.Hp, a.Wp}, bank, op, fv, fh,
              centre, a.maxv, o);
    int4* dst = reinterpret_cast<int4*>(a.out[p] + cell * CS * CS);
#pragma unroll
    for (int k = 0; k < CS * CS / 4; ++k) {
      const int* q = &o[0][0] + 4 * k;
      dst[k] = make_int4(q[0], q[1], q[2], q[3]);
    }
  }
}

// A CTA is kWarps warps, a group each.  At most 128 registers a thread:
// an SM then holds 16 warps.
template <class K>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
    mc_cells_kernel(const McArgs a) {
  __shared__ int bank[K::kBank];
  for (int k = threadIdx.x; k < K::kBank; k += kWarps * 32)
    bank[k] = K::bank(k);
  __syncthreads();
  const long long g =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  mc_cell<K>(g, a, bank);
}

template <class K>
cudaError_t launch_cells(const McArgs& a, cudaStream_t s) {
  const long long ctas = (a.n + kWarps * kGroup - 1) / (kWarps * kGroup);
  mc_cells_kernel<K><<<static_cast<unsigned>(ctas), kWarps * 32, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace thor
