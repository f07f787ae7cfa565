// Stage routines shared by the port's FFT kernels for Hopper (sm_90a):
// interleaved complex values, the radix-2/3/4/5/7/8 butterflies, the
// register passes of the one-block kernels over one shared buffer
// (block_fft, below), one Stockham stage over a tile of columns in two
// buffers (run_stage, the column pass's), and the launches' opt-in to more
// than 48 KB of shared memory a block (opt_in).
//
// Included by stockham.cu (the fused 1-D kernel and its real-input folds:
// block_fft; the column pass: run_stage), fft2.cu (the fused rank-2
// kernel and its fold: block_fft), fftconv.cu (Cx, the butterflies: its
// own power-of-two stage routine), fft4step.cu and tc_product.cuh (Cx,
// mul, scale) and dft.cu (Cx, cfma, mul, the butterflies); every kernel's
// launch uses opt_in.
// Everything here lives in an anonymous namespace: each kernel library is
// its own translation unit.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kMaxSmem = 232448;        // Hopper: 227 KB per block
constexpr int kDefaultSmem = 48 * 1024; // above this, opt in per kernel
constexpr int kMaxDevices = 64;

// Above 48 KB of dynamic shared memory a kernel must opt in; the opt-in is
// a per-device attribute of each instantiation: set it on the first large
// launch on each device only.
template <auto Kern>
cudaError_t opt_in(size_t smem) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  static std::atomic<bool> opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) opted_in[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <typename T>
struct alignas(2 * sizeof(T)) Cx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ Cx<T> add(Cx<T> a, Cx<T> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename T>
__device__ __forceinline__ Cx<T> sub(Cx<T> a, Cx<T> b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename T>
__device__ __forceinline__ Cx<T> mul(Cx<T> a, Cx<T> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <typename T>
__device__ __forceinline__ Cx<T> scale(Cx<T> a, T s) {
  return {a.re * s, a.im * s};
}
// acc + a * b, as four FMAs (the complex products of dft.cu)
template <typename T>
__device__ __forceinline__ Cx<T> cfma(Cx<T> a, Cx<T> b, Cx<T> acc) {
  acc.re = acc.re + a.re * b.re;
  acc.re = acc.re - a.im * b.im;
  acc.im = acc.im + a.re * b.im;
  acc.im = acc.im + a.im * b.re;
  return acc;
}
// a * W_4^1: -i for the forward transform, +i for the inverse (a swap).
template <bool INV, typename T>
__device__ __forceinline__ Cx<T> rot(Cx<T> a) {
  return INV ? Cx<T>{-a.im, a.re} : Cx<T>{a.im, -a.re};
}
// a * W_8^1 = a * (1 -+ i)/sqrt(2).
template <bool INV, typename T>
__device__ __forceinline__ Cx<T> rot8(Cx<T> a) {
  const T h = T(0.70710678118654752440);
  return INV ? Cx<T>{h * (a.re - a.im), h * (a.re + a.im)}
             : Cx<T>{h * (a.re + a.im), h * (a.im - a.re)};
}

// cos(2*pi*j/r) and sin(2*pi*j/r) for the odd radices, 0 < j < r: not
// recursive and always inlined, so that the unrolled butterflies fold
// them to constants (a call would spill the caller's registers).
__host__ __device__ __forceinline__ constexpr double kcos(int r, int j) {
  const int h = j > r / 2 ? r - j : j;
  return r == 3 ? -0.5
       : r == 5 ? (h == 1 ? 0.3090169943749474241023 : -0.8090169943749474241023)
       : (h == 1 ? 0.6234898018587335305251
          : h == 2 ? -0.2225209339563144042889 : -0.9009688679024191262361);
}
__host__ __device__ __forceinline__ constexpr double ksin(int r, int j) {
  const int h = j > r / 2 ? r - j : j;
  const double v = r == 3 ? 0.8660254037844386467637
       : r == 5 ? (h == 1 ? 0.9510565162951535721164 : 0.5877852522924731291687)
       : (h == 1 ? 0.7818314824680298087084
          : h == 2 ? 0.9749279121818236070181 : 0.4338837391175581204758);
  return j > r / 2 ? -v : v;
}

template <int R, bool INV, typename T>
struct Butterfly;

// The one-point DFT (the identity pass of a one-point axis).
template <bool INV, typename T>
struct Butterfly<1, INV, T> {
  __device__ __forceinline__ static void run(Cx<T>*) {}
};

template <bool INV, typename T>
struct Butterfly<2, INV, T> {
  __device__ __forceinline__ static void run(Cx<T>* a) {
    const Cx<T> t = a[0];
    a[0] = add(t, a[1]);
    a[1] = sub(t, a[1]);
  }
};

template <bool INV, typename T>
struct Butterfly<4, INV, T> {
  __device__ __forceinline__ static void run(Cx<T>* a) {
    const Cx<T> t0 = add(a[0], a[2]), t1 = sub(a[0], a[2]);
    const Cx<T> t2 = add(a[1], a[3]), t3 = rot<INV>(sub(a[1], a[3]));
    a[0] = add(t0, t2);
    a[1] = add(t1, t3);
    a[2] = sub(t0, t2);
    a[3] = sub(t1, t3);
  }
};

// Radix 8 as two radix-4 halves (even and odd inputs) joined by W_8^u:
// multiplies only on the (1 -+ i)/sqrt(2) terms.
template <bool INV, typename T>
struct Butterfly<8, INV, T> {
  __device__ __forceinline__ static void run(Cx<T>* a) {
    Cx<T> e[4] = {a[0], a[2], a[4], a[6]};
    Cx<T> o[4] = {a[1], a[3], a[5], a[7]};
    Butterfly<4, INV, T>::run(e);
    Butterfly<4, INV, T>::run(o);
    o[1] = rot8<INV>(o[1]);
    o[2] = rot<INV>(o[2]);
    o[3] = rot<INV>(rot8<INV>(o[3]));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = add(e[u], o[u]);
      a[u + 4] = sub(e[u], o[u]);
    }
  }
};

// Odd radix (3, 5, 7): pair inputs t and r-t, so each output pair
// (u, r-u) shares one set of multiplies: y_u = A + iB, y_{r-u} = A - iB.
template <int R, bool INV, typename T>
struct OddButterfly {
  __device__ __forceinline__ static void run(Cx<T>* a) {
    constexpr int H = (R - 1) / 2;
    constexpr double sign = INV ? 1.0 : -1.0;
    Cx<T> p[H], m[H];
    Cx<T> y0 = a[0];
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      p[k - 1] = add(a[k], a[R - k]);
      m[k - 1] = sub(a[k], a[R - k]);
      y0 = add(y0, p[k - 1]);
    }
    Cx<T> y[R];
    y[0] = y0;
#pragma unroll
    for (int u = 1; u <= H; ++u) {
      Cx<T> A = a[0], B = {T(0), T(0)};
#pragma unroll
      for (int k = 1; k <= H; ++k) {
        const int j = (k * u) % R;
        A = add(A, scale(p[k - 1], T(kcos(R, j))));
        B = add(B, scale(m[k - 1], T(sign * ksin(R, j))));
      }
      y[u] = {A.re - B.im, A.im + B.re};
      y[R - u] = {A.re + B.im, A.im - B.re};
    }
#pragma unroll
    for (int u = 0; u < R; ++u) a[u] = y[u];
  }
};

template <bool INV, typename T>
struct Butterfly<3, INV, T> : OddButterfly<3, INV, T> {};
template <bool INV, typename T>
struct Butterfly<5, INV, T> : OddButterfly<5, INV, T> {};
template <bool INV, typename T>
struct Butterfly<7, INV, T> : OddButterfly<7, INV, T> {};

// One radix-R stage over `rows` rows, each holding `cols` interleaved
// sequences of length n: element k of sequence c sits at c + k*cols
// (cols = 1 for contiguous rows; cols = n2 for the columns of a row-major
// n1 x n2 signal).  src and dst point at the tile's first row (global
// memory or a shared-memory buffer).  Threads stride over the
// rows * n/R * cols butterflies, the sequence index fastest and then
// j = p*s + q, so the R loads of a butterfly are contiguous across the
// warp.
template <int R, bool INV, typename T>
__device__ __forceinline__ void run_stage(const Cx<T>* __restrict__ src,
                                          Cx<T>* __restrict__ dst,
                                          const Cx<T>* __restrict__ tw,
                                          int n, int rows, int m, int s,
                                          int base, bool last, T inv_n,
                                          int cols = 1) {
  const int nr = n / R;  // == m * s
  const int total = rows * nr * cols;
  for (int g = threadIdx.x; g < total; g += blockDim.x) {
    const int line = g / cols;
    const int c = g - line * cols;
    const int row = line / nr;
    const int j = line - row * nr;
    const int p = j / s;
    const int q = j - p * s;
    const long long row_off = static_cast<long long>(row) * n * cols + c;
    const Cx<T>* in = src + row_off + static_cast<long long>(j) * cols;
    Cx<T> a[R];
#pragma unroll
    for (int t = 0; t < R; ++t) a[t] = in[t * nr * cols];
    Butterfly<R, INV, T>::run(a);
    if (m > 1) {
#pragma unroll
      for (int u = 1; u < R; ++u) a[u] = mul(a[u], tw[base + (u - 1) * m + p]);
    }
    if (INV && last) {
#pragma unroll
      for (int u = 0; u < R; ++u) a[u] = scale(a[u], inv_n);
    }
    Cx<T>* out = dst + row_off +
                 (q + static_cast<long long>(s) * R * p) * cols;
#pragma unroll
    for (int u = 0; u < R; ++u) out[static_cast<long long>(s) * u * cols] = a[u];
  }
}

// ---------------------------------------------------------------------------
// Register passes over one shared buffer: the one-block kernels' stages
// (stockham.cu's 1-D kernel and its real-input folds, fft2.cu's rank-2
// kernel and its folds).
//
// A block owns a tile of `tile` signals, each n1 rows of l2 points (n1 = 1
// for a 1-D signal), row-major.  The host groups the stages of each axis'
// schedule into passes of one or two stages (radices RA, then RB; R = RA
// RB points a thread).  A pass runs over lines of L points: the rows of
// the tile (the l2 axis, C = 1) or, in the column form, the n1-point
// columns of a signal, C = l2 of them interleaved (element a of column c at
// c + a C).  With the pass's entry stride s and M = L / (R s), the thread
// that owns butterfly (q < s, p < M) of a line
//   1. loads x[q + s (p + M t)], t = t2 + RB t1 < R, into registers (the
//      first pass from global memory, the others from shared memory);
//   2. runs stage A: for each t2 the RA-point butterfly over t1, output u1
//      times W_cur^((p + M t2) u1), cur = R M, from the host's per-stage
//      table; then stage B: for each u1 the RB-point butterfly over t2,
//      output u2 times W_(cur/RA)^(p u2) -- the schedule's two stages, so
//      the table is the reference's, unchanged;
//   3. after a barrier, stores output k = u1 + RA u2 at x[q + s (k + R p)]
//      in the same buffer (the last pass to global memory).
// A pass that reads and writes the buffer holds all its butterflies
// across the barrier, one a thread (the host sizes the block for it); the
// host falls back to two buffers (a pass reads one, writes the other) only
// where a tile's butterflies outnumber the threads.  Every index is a
// product or a FastDiv (a multiply-high and a shift) of the host's
// per-pass constants: no division in the loop.  Each layout between two
// passes may be padded, element e at e + (e >> sh), with sh chosen on the
// host by a bank model so that a warp's stores and the next pass's loads
// fall on distinct banks.
//
// Real input (the folds, ``mode`` kEven / kOdd):
//   * kEven, forward (R2C of an even last extent n2 = 2h): the real signal
//     is read as n1 x h complex points (no copy); the last pass pairs each
//     butterfly with its mirror (the points (-k1, -k2) mod (n1, h)) and
//     stores X[k1][k2] = E + W_n2^k2 O, E = (Z + conj Z')/2, O = -i (Z -
//     conj Z')/2, Z' = Z[-k1][-k2], and X[k1][h] = E - O at k2 = 0, in
//     registers: the post-pass costs no pass over memory;
//   * kEven, inverse (C2R): the first pass pairs butterflies the same way
//     and builds z = E + i O, E = (Y + conj Y')/2, O = (Y - conj Y')
//     W_n2^(-k2)/2 from the bins Y[k1][k2] and Y' = Y[-k1][h - k2] (the
//     Nyquist bin at k2 = 0); the last store writes the real output viewed
//     as complex, times 1/(n1 h);
//   * kOdd (1-D, odd n): the first pass reads real values (forward) or
//     rebuilds the Hermitian half, x[k] = conj Y[n - k] for k > n/2
//     (inverse); the last pass stores bins 0..n/2 (forward) or the real
//     parts times 1/n (inverse).

constexpr int kMaxPasses = 16;
enum : int { kC2C = 0, kEven = 1, kOdd = 2 };

// n / d as a multiply-high and a shift (1 <= d, n < 2^31): the host
// computes mul = floor(2^32 (2^shr - d) / d) + 1, shr = ceil(log2 d).
struct FastDiv {
  unsigned d, mul, shr;
};
__device__ __forceinline__ int fdiv(const FastDiv& f, int n) {
  const unsigned u = static_cast<unsigned>(n);
  return static_cast<int>((__umulhi(u, f.mul) + u) >> f.shr);
}

// One register pass (see above).  A and B pair a fold's butterflies: A
// lines (rows of a signal) or columns, B butterflies.
struct PassDesc {
  int code;                 // (RA, RB): index into REPRO_PASS_CASES
  int col;                  // 1: the column form
  int L, C, s, M, nb;       // line length, interleave, stride, M, L / R
  int upg;                  // work units of one signal
  int base_a, base_b;       // the stages' twiddle bases; -1: all ones
  int in_off, out_off;      // shared-memory offsets of the layouts read, written
  int in_sh, out_sh;        // their pad shifts (31: none)
  int A, B;
  FastDiv f_upg, f_nb, f_c, f_s, f_b;
};

struct BlockPlan {
  int n_passes;
  int n1, l2;               // a signal: n1 rows of l2 points
  int tile;                 // signals a block
  int nyq;                  // a fold's Nyquist index: h (kEven), n / 2 (kOdd)
  int mode;                 // kC2C, kEven, kOdd
  long long in_sig, in_row;    // a fold's bins in: signal and row strides
  long long out_sig, out_row;  // a fold's bins out
  PassDesc pass[kMaxPasses];
};

// The (RA, RB) of every pass code; block.PASS_CASES holds the same list.
#define REPRO_PASS_CASES                                                   \
  REPRO_PASS(0, 1, 1) REPRO_PASS(1, 2, 1) REPRO_PASS(2, 3, 1)              \
  REPRO_PASS(3, 4, 1) REPRO_PASS(4, 5, 1) REPRO_PASS(5, 7, 1)              \
  REPRO_PASS(6, 8, 1) REPRO_PASS(7, 7, 7) REPRO_PASS(8, 7, 5)              \
  REPRO_PASS(9, 7, 3) REPRO_PASS(10, 7, 8) REPRO_PASS(11, 7, 4)            \
  REPRO_PASS(12, 7, 2) REPRO_PASS(13, 5, 5) REPRO_PASS(14, 5, 3)           \
  REPRO_PASS(15, 5, 8) REPRO_PASS(16, 5, 4) REPRO_PASS(17, 5, 2)           \
  REPRO_PASS(18, 3, 3) REPRO_PASS(19, 3, 8) REPRO_PASS(20, 3, 4)           \
  REPRO_PASS(21, 3, 2) REPRO_PASS(22, 8, 8) REPRO_PASS(23, 8, 4)           \
  REPRO_PASS(24, 8, 2) REPRO_PASS(25, 4, 4) REPRO_PASS(26, 4, 2)           \
  REPRO_PASS(27, 2, 2)

// The block's side of a pass: its signals' base pointers (computed once
// a block, so every other offset is 32-bit), the twiddle and pack tables,
// the fold's geometry and the flags.  The pass itself is read from the
// plan (a __grid_constant__ kernel parameter) where it is used.  The
// inverse runs as the conjugate of the forward transform (conj on the
// first load, conjugated twiddles, conj on the last store: exact in
// floating point), so one code serves both directions.
// The kernels' case families (bit I: the case REPRO_PASS(I, ...)): every
// kernel inlines its family's cases into one switch, and ptxas allocates
// one kernel's registers for all of them, so a family is a few cases that
// fit 255 registers together (block.py holds the same sets and plans each
// launch within one family).
//   kSmallPow2: the power-of-two passes of at most 16 points;
//   kOddRadix: the passes of odd radices of at most 16 points (complex128: one
//         stage only) and the power-of-two single stages;
//   kBig (complex64): the 64-point pass of two radix-8 stages and the
//         power-of-two single stages;
//   kOneStage: the single stages of every radix and no paired pass: few
//         registers, so up to 512 threads a block and several blocks an
//         SM for the plans of small passes.
// A paired pass (a fold's) holds two butterflies: its cases are the
// family's of at most half the points.
enum : int { kSmallPow2 = 0, kOddRadix = 1, kBig = 2, kOneStage = 3 };
template <typename... I>
__host__ __device__ constexpr unsigned long long bits(I... codes) {
  return (0ULL | ... | (1ULL << codes));
}
constexpr unsigned long long kSingles = bits(0, 1, 3, 6);           // 1, 2, 4, 8
constexpr unsigned long long kOddSingles = bits(2, 4, 5);           // 3, 5, 7
constexpr unsigned long long kPow2Pairs16 = bits(24, 25, 26, 27);   // 8x2, 4x4, 4x2, 2x2
constexpr unsigned long long kOddPairs16 = bits(12, 14, 17, 18, 20, 21);
__host__ __device__ constexpr unsigned long long family_cases(int family, bool dbl,
                                                               bool paired) {
  return family == kSmallPow2
             ? (paired ? kSingles | bits(26, 27) : kSingles | kPow2Pairs16)
         : family == kOddRadix
             ? (paired || dbl ? kSingles | kOddSingles | (dbl ? 0 : bits(21))
                              : kSingles | kOddSingles | kOddPairs16)
         : family == kBig && !dbl ? (paired ? kSingles : kSingles | bits(22))
         : family == kOneStage && !paired ? kSingles | kOddSingles
                                          : 0;
}

// A family's most threads a block: 512 for kOneStage in complex64 (at
// most 128 registers a thread), 256 for the others (up to 255).
__host__ __device__ constexpr int family_threads(int family, bool dbl) {
  return family == kOneStage && !dbl ? 512 : 256;
}

template <typename T>
struct Block {
  const void* x;            // the block's first input signal
  void* y;                  // its first output signal
  const Cx<T>* tw;          // the stage twiddles (the direction's table)
  const Cx<T>* roots;       // a kEven fold's W_n2^(-+k), k < h
  int sigs;                 // signals in this block (a ragged last tile has fewer)
  int n1, l2, nyq, mode;
  int in_sig, in_row, out_sig, out_row;
  bool inv, first, last;
  T scale;                  // the inverse's 1/n, folded into the last store
};

// The dynamic shared memory of every kernel of the translation unit.
extern __shared__ __align__(16) unsigned char repro_smem[];

template <typename T>
__device__ __forceinline__ Cx<T>* shared_points() {
  return reinterpret_cast<Cx<T>*>(repro_smem);
}

__device__ __forceinline__ int padded(int e, int sh) { return e + (e >> sh); }

template <typename T>
__device__ __forceinline__ Cx<T> conj(Cx<T> a) {
  return {a.re, -a.im};
}

// W_64^j = exp(-2 pi i j / 64), j < 64, in float64 (the forward roots of
// every power-of-two pass of 16 to 64 points: W_R^j = W_64^(j 64 / R)).
struct Root64 {
  double re, im;
};
__device__ constexpr Root64 kRoots64[64] = {
    {1, -0},
    {0.995184726672196928732, -0.0980171403295606036288},
    {0.980785280403230430579, -0.195090322016128248084},
    {0.956940335732208824382, -0.290284677254462331053},
    {0.923879532511286738483, -0.382683432365089781779},
    {0.881921264348355049556, -0.47139673682599764204},
    {0.831469612302545235671, -0.555570233019602177649},
    {0.773010453362736993377, -0.634393284163645487794},
    {0.707106781186547572737, -0.707106781186547461715},
    {0.634393284163645487794, -0.773010453362736993377},
    {0.555570233019602288671, -0.831469612302545235671},
    {0.471396736825997808573, -0.881921264348354938534},
    {0.38268343236508983729, -0.923879532511286738483},
    {0.290284677254462331053, -0.956940335732208935404},
    {0.195090322016128331351, -0.980785280403230430579},
    {0.0980171403295607701622, -0.995184726672196817709},
    {6.12323399573676603587e-17, -1},
    {-0.0980171403295606452621, -0.995184726672196928732},
    {-0.195090322016128192573, -0.980785280403230430579},
    {-0.29028467725446216452, -0.956940335732208935404},
    {-0.382683432365089726268, -0.923879532511286738483},
    {-0.471396736825997697551, -0.881921264348355049556},
    {-0.555570233019601955604, -0.831469612302545457716},
    {-0.634393284163645376772, -0.773010453362737104399},
    {-0.707106781186547461715, -0.707106781186547572737},
    {-0.773010453362736993377, -0.634393284163645487794},
    {-0.831469612302545346694, -0.555570233019602177649},
    {-0.881921264348354938534, -0.471396736825997864084},
    {-0.923879532511286738483, -0.382683432365089892802},
    {-0.956940335732208824382, -0.290284677254462386564},
    {-0.980785280403230430579, -0.195090322016128608906},
    {-0.995184726672196817709, -0.0980171403295608256734},
    {-1, -1.22464679914735320717e-16},
    {-0.995184726672196928732, 0.098017140329560589751},
    {-0.980785280403230430579, 0.195090322016128359106},
    {-0.956940335732208935404, 0.290284677254462109008},
    {-0.923879532511286849505, 0.382683432365089670757},
    {-0.881921264348355049556, 0.47139673682599764204},
    {-0.831469612302545457716, 0.555570233019601955604},
    {-0.773010453362737104399, 0.63439328416364526575},
    {-0.70710678118654768376, 0.707106781186547461715},
    {-0.634393284163645931883, 0.77301045336273666031},
    {-0.555570233019602177649, 0.831469612302545235671},
    {-0.471396736825997864084, 0.881921264348354938534},
    {-0.382683432365090336891, 0.923879532511286516439},
    {-0.290284677254462442075, 0.956940335732208824382},
    {-0.195090322016128664417, 0.980785280403230319557},
    {-0.0980171403295604509731, 0.995184726672196928732},
    {-1.8369701987210296875e-16, 1},
    {0.0980171403295600901506, 0.995184726672196928732},
    {0.195090322016128303595, 0.980785280403230430579},
    {0.290284677254462053497, 0.956940335732208935404},
    {0.382683432365090003824, 0.923879532511286627461},
    {0.471396736825997586529, 0.881921264348355049556},
    {0.555570233019601844582, 0.831469612302545457716},
    {0.634393284163645598817, 0.773010453362736882355},
    {0.707106781186547350693, 0.70710678118654768376},
    {0.77301045336273666031, 0.634393284163645931883},
    {0.831469612302545235671, 0.555570233019602177649},
    {0.881921264348354827511, 0.471396736825997919595},
    {0.923879532511286516439, 0.382683432365090392402},
    {0.956940335732208824382, 0.290284677254462497586},
    {0.980785280403230319557, 0.195090322016128719929},
    {0.995184726672196928732, 0.0980171403295605064843},
};

// Stages A and B of a pass (forward butterflies; conjugated twiddles for
// the inverse) on the R = RA RB points of butterfly column p; output k =
// u1 + RA u2 ends in a[u2 + RB u1].  Stage A's twiddle of (p + M t2, u1)
// is the table's W_cur^((p + M t2) u1); a power-of-two pass of 16 or more
// points forms it as W_cur^(p u1) (the table's t2 = 0 entries, RA - 1
// loads) times the constant W_R^(t2 u1), so that its registers do not
// hold (RA - 1) RB loaded twiddles at once.
template <int RA, int RB, typename T>
__device__ __forceinline__ void pass_stages(Cx<T> (&a)[RA * RB], const PassDesc& ps,
                                            const Block<T>& b, int p) {
  constexpr int R = RA * RB;
  constexpr bool kFactor = R >= 16 && (R & (R - 1)) == 0;
  const int base_a = ps.base_a, base_b = ps.base_b, M = ps.M;
  const bool inv = b.inv;
  const Cx<T>* __restrict__ tw = b.tw;
  Cx<T> wa[RA];
  if constexpr (kFactor) {
    if (base_a >= 0) {
      const Cx<T>* w = tw + base_a + p;
#pragma unroll
      for (int u1 = 1; u1 < RA; ++u1) {
        const Cx<T> wv = w[(u1 - 1) * M * RB];
        wa[u1] = inv ? conj(wv) : wv;
      }
    }
  }
#pragma unroll
  for (int t2 = 0; t2 < RB; ++t2) {
    Cx<T> v[RA];
#pragma unroll
    for (int t1 = 0; t1 < RA; ++t1) v[t1] = a[t2 + RB * t1];
    Butterfly<RA, false, T>::run(v);
    if (base_a >= 0) {
      const Cx<T>* w = tw + base_a + p + M * t2;
      const int ma = M * RB;
#pragma unroll
      for (int u1 = 1; u1 < RA; ++u1) {
        if constexpr (kFactor) {
          constexpr int kStep = 64 / R;
          const Root64 c = kRoots64[(t2 * u1 % R) * kStep];
          v[u1] = mul(v[u1], mul(wa[u1], Cx<T>{T(c.re), T(c.im)}));
        } else {
          const Cx<T> wv = w[(u1 - 1) * ma];
          v[u1] = mul(v[u1], inv ? conj(wv) : wv);
        }
      }
    }
#pragma unroll
    for (int u1 = 0; u1 < RA; ++u1) a[t2 + RB * u1] = v[u1];
  }
  if constexpr (RB > 1) {
#pragma unroll
    for (int u1 = 0; u1 < RA; ++u1) {
      Cx<T> v[RB];
#pragma unroll
      for (int t2 = 0; t2 < RB; ++t2) v[t2] = a[t2 + RB * u1];
      Butterfly<RB, false, T>::run(v);
      if (base_b >= 0) {
        const Cx<T>* w = tw + base_b + p;
#pragma unroll
        for (int u2 = 1; u2 < RB; ++u2) {
          const Cx<T> wv = w[(u2 - 1) * M];
          v[u2] = mul(v[u2], inv ? conj(wv) : wv);
        }
      }
#pragma unroll
      for (int u2 = 0; u2 < RB; ++u2) a[u2 + RB * u1] = v[u2];
    }
  }
}

// The register slot of output k (k = u1 + RA u2 sits at u2 + RB u1).
template <int RA, int RB>
__device__ __forceinline__ constexpr int slot(int k) {
  return k / RA + RB * (k % RA);
}

// Load the R points of butterfly (line, col, q, p): from shared memory,
// or, in the first pass, from global memory (complex; real values for an
// odd forward fold; the Hermitian half for an odd inverse fold).
template <int RA, int RB, typename T>
__device__ __forceinline__ void load_points(Cx<T> (&a)[RA * RB], const PassDesc& ps,
                                            const Block<T>& b, int line, int col,
                                            int q, int p) {
  constexpr int R = RA * RB;
  const int eb = line * ps.L * ps.C + col + ps.C * (q + ps.s * p);
  const int step = ps.C * ps.s * ps.M;
  if (!b.first) {
    const Cx<T>* src = shared_points<T>() + ps.in_off;
    const int sh = ps.in_sh;
#pragma unroll
    for (int t = 0; t < R; ++t) a[t] = src[padded(eb + step * t, sh)];
    return;
  }
  if (b.mode == kOdd && !b.inv) {
    const T* src = static_cast<const T*>(b.x);
#pragma unroll
    for (int t = 0; t < R; ++t) a[t] = {src[eb + step * t], T(0)};
  } else if (b.mode == kOdd) {
    // x[k] = conj Y[n - k] above n/2, conjugated for the inverse
    const Cx<T>* row = static_cast<const Cx<T>*>(b.x) + line * b.in_sig;
    const int M = ps.M, nyq = b.nyq, n = b.l2;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int k = p + M * t;                     // s = 1, q = 0
      a[t] = k <= nyq ? conj(row[k]) : row[n - k];
    }
  } else {
    const Cx<T>* src = static_cast<const Cx<T>*>(b.x);
    const bool inv = b.inv;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const Cx<T> v = src[eb + step * t];
      a[t] = inv ? conj(v) : v;
    }
  }
}

// Store output k of butterfly (line, col, q, p): to shared memory or, in
// the last pass, to global memory (complex, times the inverse's scale;
// bins 0..n/2 of an odd forward fold; real parts of an odd inverse fold).
template <int RA, int RB, typename T>
__device__ __forceinline__ void store_points(const Cx<T> (&a)[RA * RB],
                                             const PassDesc& ps, const Block<T>& b,
                                             int line, int col, int q, int p) {
  constexpr int R = RA * RB;
  const int eb = line * ps.L * ps.C + col + ps.C * (q + ps.s * R * p);
  const int step = ps.C * ps.s;
  if (!b.last) {
    Cx<T>* dst = shared_points<T>() + ps.out_off;
    const int sh = ps.out_sh;
#pragma unroll
    for (int k = 0; k < R; ++k) dst[padded(eb + step * k, sh)] = a[slot<RA, RB>(k)];
    return;
  }
  const T sc = b.scale;
  if (b.mode == kOdd && !b.inv) {
    Cx<T>* row = static_cast<Cx<T>*>(b.y) + line * b.out_sig;
    const int s = ps.s, nyq = b.nyq;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int bin = q + s * k;                   // M = 1, p = 0
      if (bin <= nyq) row[bin] = a[slot<RA, RB>(k)];
    }
  } else if (b.mode == kOdd) {
    T* dst = static_cast<T*>(b.y);
#pragma unroll
    for (int k = 0; k < R; ++k) dst[eb + step * k] = a[slot<RA, RB>(k)].re * sc;
  } else {
    Cx<T>* dst = static_cast<Cx<T>*>(b.y);
    const bool inv = b.inv;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const Cx<T> v = a[slot<RA, RB>(k)];
      dst[eb + step * k] = inv ? Cx<T>{v.re * sc, -v.im * sc} : v;
    }
  }
}

// Work unit u of an unpaired pass: line, column, butterfly (q, p).
__device__ __forceinline__ void locate(const PassDesc& ps, int n1, int u,
                                       int& line, int& col, int& q, int& p) {
  const int sig = fdiv(ps.f_upg, u);
  const int rest = u - sig * ps.upg;
  int j;
  if (ps.col) {
    j = fdiv(ps.f_c, rest);
    col = rest - j * ps.C;
    line = sig;
  } else {
    const int r = fdiv(ps.f_nb, rest);
    j = rest - r * ps.nb;
    col = 0;
    line = sig * n1 + r;
  }
  p = fdiv(ps.f_s, j);
  q = j - p * ps.s;
}

// A pass whose butterflies stand alone.  A pass that reads and writes the
// same buffer runs one butterfly a thread and holds it across the
// barrier; any other loops over its butterflies.
template <int RA, int RB, typename T>
__device__ __forceinline__ void pass_case(const PassDesc& ps, const Block<T>& b) {
  constexpr int R = RA * RB;
  const int units = b.sigs * ps.upg;
  const bool in_place = !b.first && !b.last && ps.in_off == ps.out_off;
  for (int u = threadIdx.x;; u += blockDim.x) {
    const bool active = u < units;
    if (!in_place && !active) break;
    Cx<T> a[R];
    int line = 0, col = 0, q = 0, p = 0;
    if (active) {
      locate(ps, b.n1, u, line, col, q, p);
      load_points<RA, RB>(a, ps, b, line, col, q, p);
      pass_stages<RA, RB>(a, ps, b, p);
    }
    if (in_place) __syncthreads();
    if (active) store_points<RA, RB>(a, ps, b, line, col, q, p);
    if (in_place) break;
  }
}

// z = E + i O of a C2R pre-pass from bins y (point) and ym (its mirror's,
// or the Nyquist bin), root W_n2^(+k2).
template <typename T>
__device__ __forceinline__ Cx<T> pack_point(Cx<T> y, Cx<T> ym, Cx<T> root) {
  const Cx<T> g = conj(ym);
  const Cx<T> e = scale(add(y, g), T(0.5));
  const Cx<T> o = mul(scale(sub(y, g), T(0.5)), root);
  return {e.re - o.im, e.im + o.re};
}

// The pre-pass on the bins of a butterfly (side 0) and its mirror (side
// 1): point t of one and point tm = R - 1 - t (rev) or (R - t) mod R of
// the other are mirrors; z pairwise in place, conjugated for the stages
// (the inverse).
template <int R, typename T>
__device__ __forceinline__ void pack_pairs(Cx<T> (&a)[2][R], const PassDesc& ps,
                                           const Block<T>& b, const Cx<T>* bins,
                                           const int (&al)[2], const int (&pp)[2],
                                           bool rev) {
  const int M = ps.M, n1 = b.n1, nyq = b.nyq, in_row = b.in_row;
  const bool col = ps.col;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int tm = rev ? R - 1 - t : (R - t) % R;
    const Cx<T> y0 = a[0][t];
    const Cx<T> y1 = rev ? a[1][R - 1 - t] : a[1][(R - t) % R];
    const int j0 = pp[0] + M * t, j1 = pp[1] + M * tm;
    const int k1a = col ? j0 : al[0], k2a = col ? al[0] : j0;
    const int k1b = col ? j1 : al[1], k2b = col ? al[1] : j1;
    const Cx<T> ga = k2a == 0 ? bins[((n1 - k1a) & (n1 - 1)) * in_row + nyq] : y1;
    const Cx<T> gb = k2b == 0 ? bins[((n1 - k1b) & (n1 - 1)) * in_row + nyq] : y0;
    a[0][t] = conj(pack_point(y0, ga, b.roots[k2a]));
    const Cx<T> z1 = conj(pack_point(y1, gb, b.roots[k2b]));
    if (rev) {
      a[1][R - 1 - t] = z1;
    } else {
      a[1][(R - t) % R] = z1;
    }
  }
}

// The post-pass: X = E + W^k2 O from a butterfly's outputs (side m) and
// its mirror's (output R - 1 - k, rev, or (R - k) mod R), and the Nyquist
// bin at k2 = 0.
template <int RA, int RB, typename T>
__device__ __forceinline__ void unpack_side(const Cx<T> (&a)[2][RA * RB], int m,
                                            const PassDesc& ps, const Block<T>& b,
                                            Cx<T>* bins, int al, int q, bool rev) {
  constexpr int R = RA * RB;
  const int s = ps.s, nyq = b.nyq, out_row = b.out_row;
  const bool col = ps.col;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = q + s * k;
    const int k1 = col ? j : al, k2 = col ? al : j;
    const Cx<T> z = a[m][slot<RA, RB>(k)];
    const Cx<T> zm = rev ? a[1 - m][slot<RA, RB>(R - 1 - k)]
                         : a[1 - m][slot<RA, RB>((R - k) % R)];
    const Cx<T> d = sub(z, conj(zm));
    const Cx<T> e = scale(add(z, conj(zm)), T(0.5));
    const Cx<T> o = {T(0.5) * d.im, T(-0.5) * d.re};
    Cx<T>* row = bins + k1 * out_row;
    row[k2] = add(e, mul(b.roots[k2], o));
    if (k2 == 0) row[nyq] = sub(e, o);
  }
}

// A kEven fold's paired pass: the first (inverse: the bins' pre-pass) or
// the last (forward: the post-pass).  Work unit = a butterfly and its
// mirror, over (alpha, beta) = (line or column, p or q) with the mirror
// (-alpha mod A, -beta mod B); a self-mirrored unit runs its one
// butterfly twice and stores it once.  The mirror of a butterfly's point
// t is the mirror butterfly's point R - 1 - t (beta > 0) or (R - t) mod R.
template <int RA, int RB, typename T>
__device__ __forceinline__ void paired_case(const PassDesc& ps, const Block<T>& b) {
  constexpr int R = RA * RB;
  const int units = b.sigs * ps.upg;
  const int h0 = (ps.B >> 1) + 1;
  const int mid = ((ps.A >> 1) - 1) * ps.B;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int sig = fdiv(ps.f_upg, u);
    const int rest = u - sig * ps.upg;
    int alpha, beta;
    if (ps.A == 1 || rest < h0) {
      alpha = 0;
      beta = rest;
    } else if (rest < h0 + mid) {
      // the column form takes the column fastest (a warp's bins on one
      // row), the row form the butterfly (a warp's bins along a row)
      const int v = rest - h0;
      const int a1 = fdiv(ps.f_b, v);
      if (ps.col) {
        beta = a1;
        alpha = 1 + v - a1 * ((ps.A >> 1) - 1);
      } else {
        alpha = 1 + a1;
        beta = v - a1 * ps.B;
      }
    } else {
      alpha = ps.A >> 1;
      beta = rest - h0 - mid;
    }
    const int al[2] = {alpha, alpha ? ps.A - alpha : 0};
    const int be[2] = {beta, beta ? ps.B - beta : 0};
    const bool self = al[1] == al[0] && be[1] == be[0];
    int line[2], col[2], q[2], pp[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      line[m] = ps.col ? sig : sig * b.n1 + al[m];
      col[m] = ps.col ? al[m] : 0;
      q[m] = b.inv ? 0 : be[m];
      pp[m] = b.inv ? be[m] : 0;
    }
    Cx<T> a[2][R];
    if (b.inv) {
      // the pre-pass (s = 1, q = 0): the bins of both butterflies
      const Cx<T>* bins = static_cast<const Cx<T>*>(b.x) + sig * b.in_sig;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const int j = pp[m] + ps.M * t;
          const int k1 = ps.col ? j : al[m], k2 = ps.col ? al[m] : j;
          a[m][t] = bins[k1 * b.in_row + k2];
        }
      pack_pairs<R>(a, ps, b, bins, al, pp, beta != 0);
    } else {
      // the post-pass's butterflies (M = 1, p = 0)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int eb = line[m] * ps.L * ps.C + col[m] + ps.C * q[m];
        const int step = ps.C * ps.s;
        if (b.first) {
          const Cx<T>* src = static_cast<const Cx<T>*>(b.x);
#pragma unroll
          for (int t = 0; t < R; ++t) a[m][t] = src[eb + step * t];
        } else {
          const Cx<T>* src = shared_points<T>() + ps.in_off;
          const int sh = ps.in_sh;
#pragma unroll
          for (int t = 0; t < R; ++t) a[m][t] = src[padded(eb + step * t, sh)];
        }
      }
    }
    pass_stages<RA, RB>(a[0], ps, b, pp[0]);
    pass_stages<RA, RB>(a[1], ps, b, pp[1]);
    if (b.inv) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && self) break;
        store_points<RA, RB>(a[m], ps, b, line[m], col[m], 0, pp[m]);
      }
    } else {
      Cx<T>* bins = static_cast<Cx<T>*>(b.y) + sig * b.out_sig;
      unpack_side<RA, RB>(a, 0, ps, b, bins, al[0], q[0], beta != 0);
      if (!self) unpack_side<RA, RB>(a, 1, ps, b, bins, al[1], q[1], beta != 0);
    }
  }
}

template <int I, int RA, int RB, int FAMILY, typename T>
__device__ __forceinline__ void dispatch_pass(const PassDesc& ps, const Block<T>& b,
                                              bool paired) {
  constexpr bool dbl = sizeof(T) == 8;
  if (paired) {
    if constexpr ((family_cases(FAMILY, dbl, true) >> I) & 1ULL) {
      paired_case<RA, RB>(ps, b);
    } else {
      __trap();  // never planned for this family (block.py)
    }
  } else {
    if constexpr ((family_cases(FAMILY, dbl, false) >> I) & 1ULL) {
      pass_case<RA, RB>(ps, b);
    } else {
      __trap();
    }
  }
}

// The one-block kernels' body: the host's passes in order, a barrier
// between two, each pass a case of the kernel's FAMILY.
template <typename T, int FAMILY>
__global__ void __launch_bounds__(family_threads(FAMILY, sizeof(T) == 8))
block_fft(const void* __restrict__ x, void* __restrict__ y,
          const Cx<T>* __restrict__ tw, const Cx<T>* __restrict__ roots,
          long long batch, T scale, int inverse,
          const __grid_constant__ BlockPlan bp) {
  const long long sig0 = static_cast<long long>(blockIdx.x) * bp.tile;
  Block<T> b;
  b.inv = inverse != 0;
  b.mode = bp.mode;
  // the block's first signal in and out: complex points, real values (an
  // odd fold's real side) or bins (a fold's complex side)
  const long long pts = static_cast<long long>(bp.n1) * bp.l2;
  const bool real_in = b.mode == kOdd && !b.inv;
  const bool real_out = b.mode == kOdd && b.inv;
  const bool bins_in = b.mode != kC2C && b.inv;
  const bool bins_out = b.mode != kC2C && !b.inv;
  b.x = real_in ? static_cast<const void*>(static_cast<const T*>(x) + sig0 * pts)
                : static_cast<const void*>(static_cast<const Cx<T>*>(x) +
                                           sig0 * (bins_in ? bp.in_sig : pts));
  b.y = real_out ? static_cast<void*>(static_cast<T*>(y) + sig0 * pts)
                 : static_cast<void*>(static_cast<Cx<T>*>(y) +
                                      sig0 * (bins_out ? bp.out_sig : pts));
  b.tw = tw;
  b.roots = roots;
  b.sigs = static_cast<int>(min(static_cast<long long>(bp.tile), batch - sig0));
  b.n1 = bp.n1;
  b.l2 = bp.l2;
  b.nyq = bp.nyq;
  b.in_sig = static_cast<int>(bp.in_sig);
  b.in_row = static_cast<int>(bp.in_row);
  b.out_sig = static_cast<int>(bp.out_sig);
  b.out_row = static_cast<int>(bp.out_row);
  b.scale = scale;
  for (int i = 0; i < bp.n_passes; ++i) {
    const PassDesc& ps = bp.pass[i];
    b.first = i == 0;
    b.last = i == bp.n_passes - 1;
    const bool paired = b.mode == kEven && (b.inv ? b.first : b.last);
    switch (ps.code) {
#define REPRO_PASS(I, RA, RB)                                                  \
  case I:                                                                      \
    dispatch_pass<I, RA, RB, FAMILY>(ps, b, paired);                           \
    break;
      REPRO_PASS_CASES
#undef REPRO_PASS
      default:
        __trap();
    }
    // the next pass reads what this one wrote
    if (!b.last) __syncthreads();
  }
}

// Launch one block_fft instantiation (its family's cases; at most
// family_threads threads a block).
template <typename T, int FAMILY>
int launch_block_fft(const void* x, void* y, const void* tw, const void* roots,
                     long long batch, const BlockPlan& bp, int inverse,
                     double scale, int threads, size_t smem,
                     cudaStream_t stream) {
  auto kern = block_fft<T, FAMILY>;
  if (threads < 1 || threads > family_threads(FAMILY, sizeof(T) == 8) ||
      bp.tile < 1 || batch < 1 ||
      bp.n_passes < 1 || bp.n_passes > kMaxPasses ||
      bp.mode < kC2C || bp.mode > kOdd || (bp.mode == kEven && !roots) ||
      smem > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  const long long blocks = (batch + bp.tile - 1) / bp.tile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t err = opt_in<block_fft<T, FAMILY>>(smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      x, y, static_cast<const Cx<T>*>(tw), static_cast<const Cx<T>*>(roots),
      batch, static_cast<T>(scale), inverse, bp);
  return cudaGetLastError();
}

// The plain C entry of a library of one-block kernels: the host's
// BlockPlan (``plan``), the direction, the case family.  POW2 libraries
// (fft2.cu) hold only the power-of-two families.
template <typename T, bool POW2>
int launch_block(const void* x, void* y, const void* tw, const void* roots,
                 const void* plan, long long batch, int inverse, int family,
                 double scale, int threads, long long smem, void* stream) {
  const BlockPlan& bp = *static_cast<const BlockPlan*>(plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  switch (family) {
    case kSmallPow2:
      return launch_block_fft<T, kSmallPow2>(x, y, tw, roots, batch, bp, inverse, scale, threads, sm, s);
    case kOddRadix:
      if constexpr (!POW2)
        return launch_block_fft<T, kOddRadix>(x, y, tw, roots, batch, bp, inverse, scale, threads, sm, s);
      break;
    case kBig:
      if constexpr (sizeof(T) == 4)
        return launch_block_fft<T, kBig>(x, y, tw, roots, batch, bp, inverse, scale, threads, sm, s);
      break;
    case kOneStage:
      return launch_block_fft<T, kOneStage>(x, y, tw, roots, batch, bp, inverse, scale, threads, sm, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
