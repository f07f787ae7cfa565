// Batched DFT of rows of length n <= 128 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/dft_matmul/dft_matmul.py : dft_matmul
//   (body _dft_kernel: the (B, n) real/imaginary planes times the n x n
//   DFT matrix as four real products, accumulated in the plane dtype).
// For each row x it computes y[k] = sum_j x[j] W_n^(j k), W_n = exp(-+ 2 pi
// i / n); the inverse folds 1/n into the store.
//
// Bound: device-memory bytes, once the arithmetic is an FFT.  The TPU
// kernel's product takes 8 n real flops per point (1016 at n = 127), about
// 3x the card's flop-per-byte ridge without tensor cores (67 TFLOP/s over
// 3.35 TB/s at 16 bytes a point: ~320): a direct product on the CUDA cores
// ran at 6-8x the bytes' bound.  Both bodies below are FFTs held in
// registers, one read and one write of each row, so their flops stay under
// the ridge (~5 log2(n) a point for a 7-smooth n; ~130 a point for the
// chirp body at n = 127: two 256-point FFTs and the products for a row of
// 127) and the bytes bound them in principle.  Each warp owns `rpw`
// rows and a private slice of shared memory, padded so that every pass
// spreads over the banks; its lanes take tasks in turn; no block barrier.
//
// * 7-smooth n (dft_fft_kernel): n = n1 * n2, both at most 16 (25 for
//   n = 125), as two passes:
//     pass 1: a lane loads column j2 of a row (x[j1*n2 + j2], j1 < n1:
//             for each j1 the warp reads runs of n2 consecutive points),
//             runs the n1-point FFT in registers (RegFft, reg_fft.cuh:
//             radix-2/3/4/5/7/8 DIF steps on the butterflies of
//             stockham_stages.cuh, shared with fft4step.cu),
//             multiplies output k1 by W_n^(j2 k1) and writes it to the
//             slice;
//     pass 2: after __syncwarp, a lane reads row k1 of the slice, runs
//             the n2-point FFT and stores output k2 at y[k1 + n1 k2] (runs
//             of n1 consecutive points).
//   Every twiddle is a root W_n^e of one table of n roots.
// * any other n (11, 13, ..., 127; dft_chirp_kernel): the chirp-z
//   (Bluestein) identity y[k] = c[k] sum_j (x[j] c[j]) conj(c[k - j]),
//   c[j] = W_2n^(j^2), a circular convolution at a length m = m1 * m2 >=
//   2n - 1 that splits into two register-FFT sizes, the split of the
//   fewest flops (24 = 3 x 8 for n = 11, 40 = 5 x 8 for 19, 256 = 16 x 16
//   for 127), as four passes:
//     stage:  the warp copies its rows (contiguous) into shared memory,
//             eight coalesced loads a lane in flight;
//     pass 1: as the FFT body's pass 1 over the chirped row zero-padded
//             to m (indices >= n are zeros, not read);
//     pass 2: row k1 of the slice, the m2-point FFT: the lane now holds
//             the spectrum points k1 + m1 k2, k2 < m2;
//     pass 3: in the same lane, times the filter spectrum F (fft(conj c)
//             / m, in the order k1 + m1 k2), conjugated, the m2-point FFT
//             of those points (the first pass of the inverse transform,
//             which needs no exchange), times W_m^(k1 t2), written back to
//             the slot the lane read in pass 2;
//     pass 4: after __syncwarp, column t2 of the slice, the m1-point FFT:
//             outputs t = t2 + m2 t1 of the convolution, conjugated; the
//             lane stores the t < n of them times c[t] (runs of m2); the
//             outputs no n of this m reaches are never computed.
//   Its plan is one table: the m roots W_m^e, the n chirp values and the
//   m spectrum values, each built in float64 on the host and cast once.
// Neither body computes a sine on the card; each plan serves both
// directions: the inverse conjugates on load and on store and applies 1/n.
//
// Layout: interleaved complex (torch.view_as_real of contiguous tensors).
// Plain C interface (dft_fft_f32 / dft_fft_f64 and dft_chirp_f32 /
// dft_chirp_f64), loaded with ctypes; each returns the cudaError_t of the
// launch.

#include <cuda_runtime.h>

#include "reg_fft.cuh"          // RegFft, FftOrder
#include "stockham_stages.cuh"  // Cx, mul, conj

namespace {

constexpr int kFftWarps = 4;            // warps of a block (both bodies)
constexpr int kMaxN = 128;

// ---- the FFT body ------------------------------------------------------

// Pass 1 over a warp's vr rows: column j2's N1-point FFT, output k1 times
// W_n^(j2 k1), to slice[r*rs + k1*pitch + j2].
template <int N1, int N2, typename T>
__device__ __forceinline__ void column_ffts(const Cx<T>* __restrict__ xw,
                                            Cx<T>* slice,
                                            const Cx<T>* __restrict__ w,
                                            int vr, int pitch, int rs,
                                            bool inv) {
  constexpr int n = N1 * N2;
  for (int task = threadIdx.x & 31; task < vr * N2; task += 32) {
    const int r = task / N2, j2 = task - r * N2;
    const Cx<T>* xs = xw + r * n + j2;
    Cx<T> a[N1];
#pragma unroll
    for (int j1 = 0; j1 < N1; ++j1) {
      a[j1] = xs[j1 * N2];
      if (inv) a[j1].im = -a[j1].im;
    }
    RegFft<N1, T>::run(a, w, N2);
    Cx<T>* s = slice + r * rs + j2;
    constexpr FftOrder<N1> order{};
    s[0] = a[0];
#pragma unroll
    for (int k1 = 1; k1 < N1; ++k1) s[k1 * pitch] = mul(a[order.at[k1]], w[k1 * j2]);
  }
}

// Pass 2: row k1 of the slice, N2-point FFT, output k2 to y[k1 + N1 k2]
// (conjugated and scaled by 1/n for the inverse).
template <int N1, int N2, typename T>
__device__ __forceinline__ void row_ffts(const Cx<T>* slice,
                                         Cx<T>* __restrict__ yw,
                                         const Cx<T>* __restrict__ w, int vr,
                                         int pitch, int rs, bool inv) {
  constexpr int n = N1 * N2;
  const T inv_n = T(1) / T(n);
  for (int task = threadIdx.x & 31; task < vr * N1; task += 32) {
    const int r = task / N1, k1 = task - r * N1;
    const Cx<T>* s = slice + r * rs + k1 * pitch;
    Cx<T> a[N2];
#pragma unroll
    for (int j2 = 0; j2 < N2; ++j2) a[j2] = s[j2];
    RegFft<N2, T>::run(a, w, N1);
    Cx<T>* ys = yw + r * n + k1;
    constexpr FftOrder<N2> order{};
#pragma unroll
    for (int k2 = 0; k2 < N2; ++k2) {
      const Cx<T> v = a[order.at[k2]];
      ys[k2 * N1] = inv ? Cx<T>{v.re * inv_n, -v.im * inv_n} : v;
    }
  }
}

// The split n = N1 * N2 of every 7-smooth n <= 128 (dft_matmul.py:
// fft_split), one kernel each.
#define DFT_FFT_SPLITS(X)                                                     \
  X(1, 1) X(1, 2) X(1, 3) X(2, 2) X(1, 5) X(2, 3) X(1, 7) X(2, 4) X(3, 3)    \
  X(2, 5) X(3, 4) X(2, 7) X(3, 5) X(4, 4) X(3, 6) X(4, 5) X(3, 7) X(4, 6)    \
  X(5, 5) X(3, 9) X(4, 7) X(5, 6) X(4, 8) X(5, 7) X(6, 6) X(5, 8) X(6, 7)    \
  X(5, 9) X(6, 8) X(7, 7) X(5, 10) X(6, 9) X(7, 8) X(6, 10) X(7, 9) X(8, 8)  \
  X(7, 10) X(8, 9) X(5, 15) X(8, 10) X(9, 9) X(7, 12) X(9, 10) X(8, 12)      \
  X(7, 14) X(10, 10) X(7, 15) X(9, 12) X(8, 14) X(10, 12) X(5, 25) X(9, 14)  \
  X(8, 16)

// A block of kFftWarps warps owns tile_b rows, rpw to a warp; w holds the
// n forward roots W_n^e.
template <typename T, int N1, int N2>
__global__ void __launch_bounds__(kFftWarps * 32)
dft_fft_kernel(const Cx<T>* __restrict__ x, Cx<T>* __restrict__ y,
               const Cx<T>* __restrict__ w, long long rows, int tile_b,
               int rpw, int pitch, int rs, int inverse) {
  constexpr int n = N1 * N2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  Cx<T>* slice = reinterpret_cast<Cx<T>*>(smem_raw) + warp * rpw * rs;
  const long long block0 = static_cast<long long>(blockIdx.x) * tile_b;
  const long long row0 = block0 + static_cast<long long>(warp) * rpw;
  const long long end = min(rows, block0 + tile_b);
  const int vr = static_cast<int>(max(0LL, min(static_cast<long long>(rpw), end - row0)));
  if (vr == 0) return;  // the whole warp: it has no rows
  const bool inv = inverse != 0;
  column_ffts<N1, N2, T>(x + row0 * n, slice, w, vr, pitch, rs, inv);
  __syncwarp();
  row_ffts<N1, N2, T>(slice, y + row0 * n, w, vr, pitch, rs, inv);
}

// ---- the chirp body ----------------------------------------------------

// The most points of a row that a chirp length m takes (2n - 1 <= m).
template <int M1, int M2>
__host__ __device__ constexpr int chirp_max_n() { return (M1 * M2 + 1) / 2; }

// A warp's vr rows (vr * n points, contiguous) into its staging area, up
// to kStageLoads loads a lane in flight before any store: one coalesced
// read of the rows.
constexpr int kStageLoads = 8;
template <typename T>
__device__ __forceinline__ void chirp_stage(const Cx<T>* __restrict__ xw,
                                            Cx<T>* stage, int count) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < count; base += 32 * kStageLoads) {
    Cx<T> v[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = base + u * 32 + lane;
      if (i < count) v[u] = xw[i];
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = base + u * 32 + lane;
      if (i < count) stage[i] = v[u];
    }
  }
}

// Pass 1 over a warp's vr staged rows: column j2 of the chirped row
// zero-padded to M = M1 * M2 points (x[j] c[j] at j = j1*M2 + j2 < n,
// zero beyond), its M1-point FFT, output k1 times W_M^(j2 k1), to
// slice[r*rs + k1*pitch + j2].
template <int M1, int M2, typename T>
__device__ __forceinline__ void chirp_columns(
    const Cx<T>* stage, Cx<T>* slice, const Cx<T>* __restrict__ w,
    const Cx<T>* __restrict__ chirp, int n, int vr, int pitch, int rs,
    bool inv) {
  constexpr FftOrder<M1> order{};
  constexpr int live = (chirp_max_n<M1, M2>() + M2 - 1) / M2;  // j1 < live
  for (int task = threadIdx.x & 31; task < vr * M2; task += 32) {
    const int r = task / M2, j2 = task - r * M2;
    const Cx<T>* xs = stage + r * n;
    Cx<T> a[M1];
#pragma unroll
    for (int j1 = 0; j1 < M1; ++j1) {
      const int j = j1 * M2 + j2;
      a[j1] = Cx<T>{T(0), T(0)};
      if (j1 < live && j < n) {
        Cx<T> v = xs[j];
        if (inv) v.im = -v.im;
        a[j1] = mul(v, chirp[j]);
      }
    }
    RegFft<M1, T>::run(a, w, M2);
    Cx<T>* s = slice + r * rs + j2;
    s[0] = a[0];
#pragma unroll
    for (int k1 = 1; k1 < M1; ++k1) s[k1 * pitch] = mul(a[order.at[k1]], w[k1 * j2]);
  }
}

// Passes 2 and 3: row k1 of the slice, its M2-point FFT (the chirped
// row's spectrum at k1 + M1 k2, k2 < M2), times the filter spectrum
// spec[k1 + M1 k2] and conjugated; then, with no exchange, the M2-point
// FFT of those points over k2 (the first pass of the inverse transform),
// output t2 times W_M^(k1 t2), back to the lane's own row of the slice
// (slice[r*rs + k1*pitch + t2]: only this lane reads or writes it here).
template <int M1, int M2, typename T>
__device__ __forceinline__ void chirp_product(Cx<T>* slice,
                                              const Cx<T>* __restrict__ w,
                                              const Cx<T>* __restrict__ spec,
                                              int vr, int pitch, int rs) {
  constexpr FftOrder<M2> order{};
  for (int task = threadIdx.x & 31; task < vr * M1; task += 32) {
    const int r = task / M1, k1 = task - r * M1;
    Cx<T>* s = slice + r * rs + k1 * pitch;
    Cx<T> a[M2];
#pragma unroll
    for (int j2 = 0; j2 < M2; ++j2) a[j2] = s[j2];
    RegFft<M2, T>::run(a, w, M1);
    Cx<T> b[M2];
#pragma unroll
    for (int k2 = 0; k2 < M2; ++k2)
      b[k2] = conj(mul(a[order.at[k2]], spec[k1 + M1 * k2]));
    RegFft<M2, T>::run(b, w, M1);
    s[0] = b[0];
#pragma unroll
    for (int t2 = 1; t2 < M2; ++t2) s[t2] = mul(b[order.at[t2]], w[k1 * t2]);
  }
}

// Pass 4: column t2 of the slice, its M1-point FFT: the points t = t2 +
// M2 t1 of the circular convolution, conjugated; the t < n of them times
// the chirp to y[t] (conjugated and scaled by inv_n = 1/n, from the host,
// for the inverse).
template <int M1, int M2, typename T>
__device__ __forceinline__ void chirp_rows(const Cx<T>* slice,
                                           Cx<T>* __restrict__ yw,
                                           const Cx<T>* __restrict__ w,
                                           const Cx<T>* __restrict__ chirp,
                                           int n, T inv_n, int vr, int pitch,
                                           int rs, bool inv) {
  constexpr FftOrder<M1> order{};
  // outputs t1 >= live are never stored: the compiler drops their work
  constexpr int live = (chirp_max_n<M1, M2>() + M2 - 1) / M2;
  for (int task = threadIdx.x & 31; task < vr * M2; task += 32) {
    const int r = task / M2, t2 = task - r * M2;
    const Cx<T>* s = slice + r * rs + t2;
    Cx<T> a[M1];
#pragma unroll
    for (int k1 = 0; k1 < M1; ++k1) a[k1] = s[k1 * pitch];
    RegFft<M1, T>::run(a, w, M2);
    Cx<T>* ys = yw + r * n;
#pragma unroll
    for (int t1 = 0; t1 < live; ++t1) {
      const int t = t2 + M2 * t1;
      if (t < n) {
        const Cx<T> v = mul(chirp[t], conj(a[order.at[t1]]));
        ys[t] = inv ? Cx<T>{v.re * inv_n, -v.im * inv_n} : v;
      }
    }
  }
}

// The split m = M1 * M2 of the chirp length of every n <= 128 that is not
// 7-smooth (dft_matmul.py: chirp_split), one kernel each.
#define DFT_CHIRP_SPLITS(X)                                                   \
  X(3, 8) X(4, 8) X(3, 12) X(5, 8) X(3, 16) X(8, 8) X(8, 9) X(5, 16)         \
  X(8, 12) X(8, 16) X(9, 16) X(10, 16) X(12, 16) X(16, 16)

// A block of kFftWarps warps owns tile_b rows, rpw to a warp: a warp's
// slice (rpw * rs points) and, after all the warps' slices, its staging
// area (rpw * n points).  tab holds the M roots W_M^e, then the n chirp
// values, then the M spectrum values.
template <typename T, int M1, int M2>
__global__ void __launch_bounds__(kFftWarps * 32)
dft_chirp_kernel(const Cx<T>* __restrict__ x, Cx<T>* __restrict__ y,
                 const Cx<T>* __restrict__ tab, long long rows, int n,
                 T inv_n, int tile_b, int rpw, int pitch, int rs,
                 int inverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  Cx<T>* slice = reinterpret_cast<Cx<T>*>(smem_raw) + warp * rpw * rs;
  const long long block0 = static_cast<long long>(blockIdx.x) * tile_b;
  const long long row0 = block0 + static_cast<long long>(warp) * rpw;
  const long long end = min(rows, block0 + tile_b);
  const int vr = static_cast<int>(max(0LL, min(static_cast<long long>(rpw), end - row0)));
  if (vr == 0) return;  // the whole warp: it has no rows
  const bool inv = inverse != 0;
  const Cx<T>* chirp = tab + M1 * M2;
  const Cx<T>* spec = chirp + n;
  Cx<T>* stage = reinterpret_cast<Cx<T>*>(smem_raw) + kFftWarps * rpw * rs +
                 warp * rpw * n;
  chirp_stage<T>(x + row0 * n, stage, vr * n);
  __syncwarp();
  chirp_columns<M1, M2, T>(stage, slice, tab, chirp, n, vr, pitch, rs, inv);
  __syncwarp();
  chirp_product<M1, M2, T>(slice, tab, spec, vr, pitch, rs);
  __syncwarp();
  chirp_rows<M1, M2, T>(slice, y + row0 * n, tab, chirp, n, inv_n, vr, pitch,
                        rs, inv);
}

template <typename T, int N1, int N2>
int launch_split(const void* x, void* y, const void* w, long long rows,
                 int tile_b, int rpw, int pitch, int rs, int inverse,
                 cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kFftWarps) * rpw * rs * sizeof(Cx<T>);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kern = dft_fft_kernel<T, N1, N2>;
  const cudaError_t err = opt_in<dft_fft_kernel<T, N1, N2>>(smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + tile_b - 1) / tile_b;
  kern<<<static_cast<unsigned>(blocks), kFftWarps * 32, smem, stream>>>(
      static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(y),
      static_cast<const Cx<T>*>(w), rows, tile_b, rpw, pitch, rs, inverse);
  return cudaGetLastError();
}

template <typename T>
int launch_fft(const void* x, void* y, const void* w, long long rows, int n,
               int n1, int n2, int tile_b, int rpw, int pitch, int rs,
               int inverse, void* stream) {
  if (n < 1 || n > kMaxN || n1 * n2 != n || tile_b < 1 || rows < 1 ||
      rpw < 1 || rpw * kFftWarps < tile_b || pitch < n2 || rs < n1 * pitch)
    return cudaErrorInvalidValue;
  if ((rows + tile_b - 1) / tile_b > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DFT_LAUNCH(A, B)                                                   \
  if (n1 == A && n2 == B)                                                  \
    return launch_split<T, A, B>(x, y, w, rows, tile_b, rpw, pitch, rs,    \
                                 inverse, s);
  DFT_FFT_SPLITS(DFT_LAUNCH)
#undef DFT_LAUNCH
  return cudaErrorInvalidValue;  // not a split of the FFT body
}

template <typename T, int M1, int M2>
int launch_chirp_split(const void* x, void* y, const void* tab,
                       long long rows, int n, int tile_b, int rpw, int pitch,
                       int rs, int inverse, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kFftWarps) * rpw * (rs + n) * sizeof(Cx<T>);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  auto kern = dft_chirp_kernel<T, M1, M2>;
  const cudaError_t err = opt_in<dft_chirp_kernel<T, M1, M2>>(smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + tile_b - 1) / tile_b;
  kern<<<static_cast<unsigned>(blocks), kFftWarps * 32, smem, stream>>>(
      static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(y),
      static_cast<const Cx<T>*>(tab), rows, n, T(1) / static_cast<T>(n),
      tile_b, rpw, pitch, rs, inverse);
  return cudaGetLastError();
}

template <typename T>
int launch_chirp(const void* x, void* y, const void* tab, long long rows,
                 int n, int m1, int m2, int tile_b, int rpw, int pitch,
                 int rs, int inverse, void* stream) {
  if (n < 1 || n > kMaxN || m1 * m2 < 2 * n - 1 || tile_b < 1 || rows < 1 ||
      rpw < 1 || rpw * kFftWarps < tile_b || pitch < m2 || rs < m1 * pitch)
    return cudaErrorInvalidValue;
  if ((rows + tile_b - 1) / tile_b > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DFT_LAUNCH(A, B)                                                   \
  if (m1 == A && m2 == B)                                                  \
    return launch_chirp_split<T, A, B>(x, y, tab, rows, n, tile_b, rpw,    \
                                       pitch, rs, inverse, s);
  DFT_CHIRP_SPLITS(DFT_LAUNCH)
#undef DFT_LAUNCH
  return cudaErrorInvalidValue;  // not a split of the chirp body
}

}  // namespace

extern "C" int dft_fft_f32(const void* x, void* y, const void* w,
                           long long rows, int n, int n1, int n2, int tile_b,
                           int rpw, int pitch, int rs, int inverse,
                           void* stream) {
  return launch_fft<float>(x, y, w, rows, n, n1, n2, tile_b, rpw, pitch, rs,
                           inverse, stream);
}

extern "C" int dft_fft_f64(const void* x, void* y, const void* w,
                           long long rows, int n, int n1, int n2, int tile_b,
                           int rpw, int pitch, int rs, int inverse,
                           void* stream) {
  return launch_fft<double>(x, y, w, rows, n, n1, n2, tile_b, rpw, pitch, rs,
                            inverse, stream);
}

extern "C" int dft_chirp_f32(const void* x, void* y, const void* tab,
                             long long rows, int n, int m1, int m2,
                             int tile_b, int rpw, int pitch, int rs,
                             int inverse, void* stream) {
  return launch_chirp<float>(x, y, tab, rows, n, m1, m2, tile_b, rpw, pitch,
                             rs, inverse, stream);
}

extern "C" int dft_chirp_f64(const void* x, void* y, const void* tab,
                             long long rows, int n, int m1, int m2,
                             int tile_b, int rpw, int pitch, int rs,
                             int inverse, void* stream) {
  return launch_chirp<double>(x, y, tab, rows, n, m1, m2, tile_b, rpw, pitch,
                              rs, inverse, stream);
}
