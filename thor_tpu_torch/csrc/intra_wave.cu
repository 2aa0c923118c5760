// The fused frame decoder's intra wave scan: one launch reconstructs one
// wave segment, and thor_intra_waves issues every segment of a frame in
// order on the caller's stream.
//
// Replaces no TPU kernel: thor_tpu/dec/device_frame.py:_intra_waves is a
// lax.scan over segments of XLA ops, and the port's torch twin
// (dec/device_frame.py:_intra_waves, kept as the CPU route) issues about
// 1,150 torch operations a segment from a host loop.  It computes what
// that loop computes, bit for bit: ops/intra_batch.py:make_refs_batch
// with its clamps, the coded mode's prediction of predict_all_modes +
// select_mode (the other nine modes were computed and thrown away; a
// mode outside [0, 10) selects mode 0), the residual add at _slices'
// clamped origin and the clip, device_frame._cfl_j's int64 regression,
// and the writes at _write's clamped origin (window wmax for luma, wc for
// chroma).
//
// What bounds it on an H100: neither bytes nor operations.  A segment
// holds at most 64 blocks of one size (8 to 128); its bytes are a few
// hundred KB at most and its arithmetic a few dozen operations a pixel,
// so a launch lasts a few microseconds, most of it the launch itself.
// The design therefore spends nothing on staging: one CTA per lane (a
// block), its reference rows and columns and their filtered forms in
// shared memory, each thread predicting and reconstructing 2x2 luma
// quads straight from the residual in device memory, and, with CFL, the
// block's nine sums reduced with warp shuffles.  Segments of one frame
// depend on each other through the planes, so they run one launch after
// another on one stream; the host's cost is one launch a segment from C.
//
// Within a segment the torch loop reads every block's references before
// it writes any block.  Here CTAs of one segment run together, so a
// block may see another block of its segment already written.  That
// changes no result: build_wave_segments puts a block in a later wave
// than every block whose pixels its prediction uses (its nominal read
// set covers the references that its ur/dl availability selects), and
// the references it reads but does not use (the unselected extension
// sample, the top row at y == 0, the left column at x == 0) do not
// reach its output.  The blocks of a segment tile disjoint areas, and
// their write windows do too where the apron holds them unclamped
// (dec/device_frame.py:_check_bounds).
//
// Integers as the torch loop has them: int64 sums and products wrap in
// 64 bits (done in uint64), int32 products in 32 bits (uint32), floor
// division where torch uses `//`, truncation where C or _cdiv8 does.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace thor {
namespace intra {

constexpr int kRow = 7;       // act, yy, xx, log2size, mode, ur, dl
constexpr int kLanes = 64;    // dec/device_frame.py LANES
constexpr int kModes = 10;
constexpr int kSums = 9;      // the CFL sums of one block

struct WaveArgs {
  int32_t* pl[3];           // apron planes Y, U, V: [hp, wp] contiguous
  int hp[3], wp[3];
  const int32_t* res[3];    // residual planes [rh, rw], row stride rs
  int rh[3], rw[3], rs[3];
  int bd, cfl, wmax, wc;
};

// Reference samples of one block of size M and their filtered forms
// (ops/intra_batch.py:make_refs_batch, predict_all_modes).
template <int M>
struct Refs {
  int top[2 * M], left[2 * M];
  int tF2[2 * M], lF2[2 * M];   // filter_121 over 2M
  int tF1[M], lF1[M];           // filter_121 over the first M
  int tP[M], lP[M];             // _planar_filt
  int tl, tl1, tlF, dc;
};

// threads of the CTA for blocks of size N
#define THOR_INTRA_THREADS(N) ((N) == 8 ? 64 : ((N) == 16 ? 128 : 256))

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int i16(int v) {   // ops/transform.py:_i16
  return static_cast<int>(static_cast<int16_t>(v));
}

__device__ __forceinline__ long long wmul(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) *
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ long long wadd(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ long long wneg(long long a) { return wsub(0, a); }
__device__ __forceinline__ long long wshl(long long a, int s) {
  return static_cast<long long>(static_cast<unsigned long long>(a) << s);
}

// Python's (and torch's) a // b.
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  if (b == -1) return wneg(a);
  long long q = a / b;
  if (a % b != 0 && ((a < 0) != (b < 0))) --q;
  return q;
}

// make_refs_batch for one block at (cy, cx) of plane [hp, wp]: the top
// row and left column with _slice_start's clamps, the ur / dl extension
// and the frame-edge value `half`.
template <int M, int T>
__device__ void load_refs(Refs<M>& r, const int32_t* pl, int hp, int wp,
                          int cy, int cx, bool ur, bool dl, int half) {
  const int y0 = max(cy - 1, 0), x0 = max(cx - 1, 0);
  const int ty = clampi(y0, 0, hp - 1), tx = clampi(cx, 0, wp - (M + 1));
  const int ly = clampi(cy, 0, hp - (M + 1)), lx = clampi(x0, 0, wp - 1);
  const int32_t* trow = pl + static_cast<long long>(ty) * wp + tx;
  const int32_t* lcol = pl + static_cast<long long>(ly) * wp + lx;
  for (int k = threadIdx.x; k < 2 * M; k += T) {
    const int kt = k < M ? k : (ur ? M : M - 1);
    const int kl = k < M ? k : (dl ? M : M - 1);
    r.top[k] = cy == 0 ? half : trow[kt];
    r.left[k] = cx == 0 ? half : lcol[static_cast<long long>(kl) * wp];
  }
  if (threadIdx.x == 0) {
    const int left0 = cx == 0 ? half : lcol[0];
    const int top0 = cy == 0 ? half : trow[0];
    const int tlpx =
        pl[static_cast<long long>(min(y0, hp - 1)) * wp + min(x0, wp - 1)];
    r.tl = cy == 0 ? left0 : (cx > 0 ? tlpx : top0);
  }
}

// The filtered references of predict_all_modes, and the DC value (the
// sum reduced by warp `w`).
template <int M, int T>
__device__ void filter_refs(Refs<M>& r, int cy, int cx, int w) {
  for (int k = threadIdx.x; k < 2 * M; k += T) {
    const int km = max(k - 1, 0), kp = min(k + 1, 2 * M - 1);
    r.tF2[k] = (r.top[km] + 2 * r.top[k] + r.top[kp] + 2) >> 2;
    r.lF2[k] = (r.left[km] + 2 * r.left[k] + r.left[kp] + 2) >> 2;
    if (k < M) {
      const int kq = min(k + 1, M - 1);
      r.tF1[k] = (r.top[km] + 2 * r.top[k] + r.top[kq] + 2) >> 2;
      r.lF1[k] = (r.left[km] + 2 * r.left[k] + r.left[kq] + 2) >> 2;
      const int a = max(k - 2, 0), b = km, c = kq, d = min(k + 2, M - 1);
      r.tP[k] = r.top[a] + 2 * r.top[b] + 2 * r.top[k] + 2 * r.top[c] +
                r.top[d];
      r.lP[k] = r.left[a] + 2 * r.left[b] + 2 * r.left[k] +
                2 * r.left[c] + r.left[d];
    }
  }
  if (static_cast<int>(threadIdx.x) / 32 == w) {
    const int lane = threadIdx.x % 32;
    long long s = 0;
    for (int k = lane; k < M; k += 32)
      s += (cy != 0 ? r.top[k] : r.left[k]) +
           (cx != 0 ? r.left[k] : r.top[k]);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) {
      r.dc = static_cast<int>(floordiv(s + M, 2 * M));
      r.tl1 = (2 * r.tl + r.left[0] + r.top[0] + 2) >> 2;
      r.tlF = r.left[1] + 2 * r.left[0] + 2 * r.tl + 2 * r.top[0] + r.top[1];
    }
  }
}

// Pixel (i, j) of mode `mode`'s prediction (predict_all_modes).
template <int M>
__device__ __forceinline__ int pred_px(const Refs<M>& r, int mode, int i,
                                       int j, int maxv) {
  constexpr int L1 = M - 1, L2 = 2 * M - 1;
  switch (mode) {
    case 0:   // DC
      return r.dc;
    case 1:   // PLANAR: _cdiv8 truncates, as C's division does
      return clampi((r.lP[i] + r.tP[j] - r.tlF + 4) / 8, 0, maxv);
    case 2:   // HOR
      return r.left[i];
    case 3:   // VER
      return r.top[j];
    case 4: {  // UPLEFT
      const int d = i - j;
      return d > 0 ? r.lF1[clampi(d - 1, 0, L1)]
                   : (d == 0 ? r.tl1 : r.tF1[clampi(-d - 1, 0, L1)]);
    }
    case 5:   // UPRIGHT
      return r.tF2[i + j + 1];
    case 6: {  // UPUPRIGHT
      const int d = i + 2 * j;
      if (d & 1) return r.tF2[clampi((d + 1) >> 1, 0, L2)];
      return (r.tF2[clampi(d >> 1, 0, L2)] +
              r.tF2[clampi((d >> 1) + 1, 0, L2)]) >> 1;
    }
    case 7: {  // UPUPLEFT
      const int d = i - 2 * j;
      if (d > 1) return r.lF1[clampi(d - 2, 0, L1)];
      if (d == 1) return r.tl1;
      if (d == 0) return (r.tl1 + r.tF1[0]) >> 1;
      const int h = (-d) >> 1;
      if (d & 1) return r.tF1[clampi(h, 0, L1)];
      return (r.tF1[clampi(h, 0, L1)] + r.tF1[clampi(h - 1, 0, L1)]) >> 1;
    }
    case 8: {  // UPLEFTLEFT
      const int d = 2 * i - j;
      if (d < -1) return r.tF1[clampi(-d - 2, 0, L1)];
      if (d == -1) return r.tl1;
      if (d == 0) return (r.tl1 + r.lF1[0]) >> 1;
      const int h = d >> 1;
      if (d & 1) return r.lF1[clampi(h, 0, L1)];
      return (r.lF1[clampi(h, 0, L1)] + r.lF1[clampi(h - 1, 0, L1)]) >> 1;
    }
    default: {  // DOWNLEFTLEFT
      const int d = 2 * i + j;
      if (d & 1) return r.lF2[clampi((d + 1) >> 1, 0, L2)];
      return (r.lF2[clampi(d >> 1, 0, L2)] +
              r.lF2[clampi((d >> 1) + 1, 0, L2)]) >> 1;
    }
  }
}

// _cfl_j's remap coefficients (a, b) of one chroma plane.
__device__ void cfl_coef(long long ssyx, long long xsum, long long ysum,
                         long long ssyy_s, int sh, int bd, int& a, int& b) {
  const long long num = wshl(ssyx, 16);
  const long long a64 = num < 0 ? wneg(floordiv(wneg(num), ssyy_s))
                                : floordiv(num, ssyy_s);
  const long long b64 = wsub(wshl(xsum, 16), wmul(a64, ysum)) >> sh;
  const long long lim = 1LL << (31 - bd);
  a = static_cast<int>(min(max(a64, -lim), lim));
  b = static_cast<int>(min(max(wadd(b64, 1 << 15), static_cast<long long>(
                                   INT_MIN)), static_cast<long long>(INT_MAX)));
}

// A remapped chroma sample: the 2x2 mean of ((a * rec + b) >> 16)
// clipped, in int32 arithmetic that wraps.
__device__ __forceinline__ int cfl_px(const int16_t* rec, int n, int i,
                                      int j, int a, int b, int maxv) {
  int s = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int r = rec[(2 * i + (d >> 1)) * n + 2 * j + (d & 1)];
    const int m = static_cast<int>(static_cast<uint32_t>(a) *
                                       static_cast<uint32_t>(r) +
                                   static_cast<uint32_t>(b)) >> 16;
    s += clampi(m, 0, maxv);
  }
  return (s + 2) >> 2;
}

template <int N>
__global__ void __launch_bounds__(THOR_INTRA_THREADS(N))
    intra_wave_segment(WaveArgs a, const int32_t* __restrict__ seg) {
  constexpr int T = THOR_INTRA_THREADS(N);
  constexpr int NC = N / 2;
  constexpr int LOG2N = N == 8 ? 3 : N == 16 ? 4 : N == 32 ? 5
                      : N == 64 ? 6 : 7;
  __shared__ Refs<N> ry;
  __shared__ Refs<NC> ru, rv;
  __shared__ unsigned long long part[T / 32][kSums];
  __shared__ int coef[6];   // do_u, a_u, b_u, do_v, a_v, b_v
  extern __shared__ int dyn[];
  int* pu = dyn;                          // [NC, NC] chroma predictions
  int* pv = dyn + NC * NC;
  int16_t* rec = reinterpret_cast<int16_t*>(dyn + 2 * NC * NC);  // [N, N]

  const int32_t* row = seg + blockIdx.x * kRow;
  if (row[0] <= 0) return;
  const int yy = row[1], xx = row[2];
  const int mode = (row[4] >= 0 && row[4] < kModes) ? row[4] : 0;
  const bool ur = row[5] > 0, dl = row[6] > 0;
  const int yc = yy >> 1, xc = xx >> 1;
  const int half = 128 << (a.bd - 8), maxv = (1 << a.bd) - 1;
  const int tid = threadIdx.x;

  load_refs<N, T>(ry, a.pl[0], a.hp[0], a.wp[0], yy, xx, ur, dl, half);
  load_refs<NC, T>(ru, a.pl[1], a.hp[1], a.wp[1], yc, xc, ur, dl, half);
  load_refs<NC, T>(rv, a.pl[2], a.hp[2], a.wp[2], yc, xc, ur, dl, half);
  __syncthreads();
  filter_refs<N, T>(ry, yy, xx, 0);
  filter_refs<NC, T>(ru, yc, xc, 1 % (T / 32));
  filter_refs<NC, T>(rv, yc, xc, 2 % (T / 32));
  __syncthreads();
  for (int p = tid; p < NC * NC; p += T) {
    pu[p] = pred_px(ru, mode, p / NC, p % NC, maxv);
    pv[p] = pred_px(rv, mode, p / NC, p % NC, maxv);
  }
  __syncthreads();

  // luma, a 2x2 quad a thread at a time: prediction, reconstruction,
  // the write, and with CFL the quad's share of the nine sums
  const int ry0 = clampi(yy, 0, a.rh[0] - N), rx0 = clampi(xx, 0, a.rw[0] - N);
  const int wy = clampi(yy, 0, a.hp[0] - a.wmax);
  const int wx = clampi(xx, 0, a.wp[0] - a.wmax);
  // sqres, ysum, usum, vsum, yysum, yusum, yvsum, uusum, vvsum
  unsigned long long s[kSums] = {};
  for (int q = tid; q < NC * NC; q += T) {
    const int qi = q / NC, qj = q % NC;
    unsigned long long psum = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int i = 2 * qi + (d >> 1), j = 2 * qj + (d & 1);
      const int p = pred_px(ry, mode, i, j, maxv);
      const int r = clampi(
          a.res[0][static_cast<long long>(ry0 + i) * a.rs[0] + rx0 + j] +
              i16(p), 0, maxv);
      a.pl[0][static_cast<long long>(wy + i) * a.wp[0] + wx + j] = r;
      if (a.cfl) {
        rec[i * N + j] = static_cast<int16_t>(r);
        const long long e = static_cast<long long>(r) - p;
        s[0] += static_cast<unsigned long long>(wmul(e, e));
        psum += static_cast<unsigned long long>(static_cast<long long>(p));
      }
    }
    if (a.cfl) {
      const long long ys =
          static_cast<long long>(psum + 2) >> 2;
      const long long us = pu[q], vs = pv[q];
      s[1] += ys;
      s[2] += us;
      s[3] += vs;
      s[4] += wmul(ys, ys);
      s[5] += wmul(ys, us);
      s[6] += wmul(ys, vs);
      s[7] += wmul(us, us);
      s[8] += wmul(vs, vs);
    }
  }

  if (a.cfl) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      for (int o = 16; o > 0; o >>= 1)
        s[k] += __shfl_down_sync(0xffffffffu, s[k], o);
      if (tid % 32 == 0) part[tid / 32][k] = s[k];
    }
    __syncthreads();
    if (tid == 0) {
      long long t[kSums];
      for (int k = 0; k < kSums; ++k) {
        unsigned long long v = 0;
        for (int w = 0; w < T / 32; ++w) v += part[w][k];
        t[k] = static_cast<long long>(v);
      }
      const long long sqres = t[0], ysum = t[1], usum = t[2], vsum = t[3];
      const int sh = 2 * (LOG2N - 1);
      const bool skip_all =
          (sqres >> (2 * LOG2N)) <= (64LL << (2 * (a.bd - 8)));
      const long long ssyy = wsub(t[4], wmul(ysum, ysum) >> sh);
      const long long ssuu = wsub(t[7], wmul(usum, usum) >> sh);
      const long long ssvv = wsub(t[8], wmul(vsum, vsum) >> sh);
      const long long ssyu = wsub(t[5], wmul(ysum, usum) >> sh);
      const long long ssyv = wsub(t[6], wmul(ysum, vsum) >> sh);
      const bool gate = !skip_all && ssyy != 0;
      const long long ssyy_s = ssyy == 0 ? 1 : ssyy;
      coef[0] = gate && wmul(wmul(ssyu, ssyu), 2) > wmul(ssyy, ssuu);
      coef[3] = gate && wmul(wmul(ssyv, ssyv), 2) > wmul(ssyy, ssvv);
      cfl_coef(ssyu, usum, ysum, ssyy_s, sh, a.bd, coef[1], coef[2]);
      cfl_coef(ssyv, vsum, ysum, ssyy_s, sh, a.bd, coef[4], coef[5]);
    }
    __syncthreads();
  }

  // chroma: the prediction (remapped where CFL chose to), the residual,
  // the clip and the write
  const int cy0 = clampi(yc, 0, a.rh[1] - NC), cx0 = clampi(xc, 0, a.rw[1] - NC);
  for (int p = tid; p < NC * NC; p += T) {
    const int i = p / NC, j = p % NC;
#pragma unroll
    for (int c = 1; c < 3; ++c) {
      int pr = (c == 1 ? pu : pv)[p];
      if (a.cfl && coef[3 * (c - 1)])
        pr = cfl_px(rec, N, i, j, coef[3 * (c - 1) + 1],
                    coef[3 * (c - 1) + 2], maxv);
      const int r = clampi(
          a.res[c][static_cast<long long>(cy0 + i) * a.rs[c] + cx0 + j] +
              i16(pr), 0, maxv);
      const int oy = clampi(yc, 0, a.hp[c] - a.wc);
      const int ox = clampi(xc, 0, a.wp[c] - a.wc);
      a.pl[c][static_cast<long long>(oy + i) * a.wp[c] + ox + j] = r;
    }
  }
}

template <int N>
constexpr size_t dyn_bytes() {
  return 2 * (N / 2) * (N / 2) * sizeof(int) + N * N * sizeof(int16_t);
}

template <int N>
cudaError_t launch(const WaveArgs& a, const int32_t* seg, int lanes,
                   cudaStream_t stream) {
  intra_wave_segment<N>
      <<<lanes, THOR_INTRA_THREADS(N), dyn_bytes<N>(), stream>>>(a, seg);
  return cudaGetLastError();
}

template <int N>
cudaError_t allow_dyn() {
  return cudaFuncSetAttribute(intra_wave_segment<N>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(dyn_bytes<N>()));
}

}  // namespace intra
}  // namespace thor

// Reconstructs the intra blocks of one frame, segment after segment, on
// `stream`: the planes are updated in place.  y, u, v: the apron planes
// (int32, [hy, wy] and [hc, wc] contiguous); ry, ru, rv: the residual
// planes (int32, [rhy, rwy] and [rhc, rwc], row strides rsy and rsc);
// segs: device [nseg, 64, 7] int32 rows (act, yy, xx, log2size, mode, ur,
// dl); segcls and lanes: host [nseg], the size class (0: skip, i + 1:
// sizes[i]) and the CTAs to launch (lanes 0 .. lanes - 1 hold the
// segment's blocks); sizes: host [nsizes] block sizes, each 8, 16, 32, 64
// or 128; bd: 8, 10 or 12.  It neither synchronises nor allocates.  Returns the number of
// segments launched, or minus the first cudaError_t.
extern "C" int thor_intra_waves(
    int device, int32_t* y, int32_t* u, int32_t* v, int hy, int wy, int hc,
    int wc, const int32_t* ry, const int32_t* ru, const int32_t* rv, int rhy,
    int rwy, int rsy, int rhc, int rwc, int rsc, const int32_t* segs,
    const int32_t* segcls, const int32_t* lanes, int nseg,
    const int32_t* sizes, int nsizes, int bd, int cfl, void* stream) {
  using namespace thor::intra;
  // the depths a stream header codes; the block's luma reconstruction is
  // kept in int16 for CFL, which holds them
  if ((bd != 8 && bd != 10 && bd != 12) || nsizes < 1)
    return -cudaErrorInvalidValue;
  int wmax = 0;
  for (int k = 0; k < nsizes; ++k) {
    const int n = sizes[k];
    if (n != 8 && n != 16 && n != 32 && n != 64 && n != 128)
      return -cudaErrorInvalidValue;
    wmax = n > wmax ? n : wmax;
    if (n > hy || n > wy || n / 2 > hc || n / 2 > wc)
      return -cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -e;
  if (wmax == 128 && (e = allow_dyn<128>()) != cudaSuccess) return -e;
  WaveArgs a{};
  a.pl[0] = y;
  a.pl[1] = u;
  a.pl[2] = v;
  a.res[0] = ry;
  a.res[1] = ru;
  a.res[2] = rv;
  a.hp[0] = hy;
  a.wp[0] = wy;
  a.rh[0] = rhy;
  a.rw[0] = rwy;
  a.rs[0] = rsy;
  for (int c = 1; c < 3; ++c) {
    a.hp[c] = hc;
    a.wp[c] = wc;
    a.rh[c] = rhc;
    a.rw[c] = rwc;
    a.rs[c] = rsc;
  }
  a.bd = bd;
  a.cfl = cfl != 0;
  a.wmax = wmax;
  a.wc = wmax / 2 > 4 ? wmax / 2 : 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int launched = 0;
  for (int s = 0; s < nseg; ++s) {
    const int cls = segcls[s];
    if (cls == 0) continue;
    if (cls < 0 || cls > nsizes || lanes[s] < 1 || lanes[s] > kLanes)
      return -cudaErrorInvalidValue;
    const int32_t* seg = segs + static_cast<long long>(s) * kLanes * kRow;
    switch (sizes[cls - 1]) {
      case 8: e = launch<8>(a, seg, lanes[s], st); break;
      case 16: e = launch<16>(a, seg, lanes[s], st); break;
      case 32: e = launch<32>(a, seg, lanes[s], st); break;
      case 64: e = launch<64>(a, seg, lanes[s], st); break;
      default: e = launch<128>(a, seg, lanes[s], st); break;
    }
    if (e != cudaSuccess) return -e;
    ++launched;
  }
  return launched;
}
