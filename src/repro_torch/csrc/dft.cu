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
// kernel's product takes 8 n real flops per point (1024 at n = 128), over
// the card's flop-per-byte ridge without tensor cores: a direct product on
// the CUDA cores ran at 6x the bytes' bound (1.97 ms at 128 x 524288
// complex64).  A mixed-radix FFT of a 7-smooth n <= 128 needs about
// 5 log2(n) flops per point, so the FFT body below is bounded by one read
// and one write of the rows.  Two bodies:
//
// * 7-smooth n (dft_fft_kernel): n = n1 * n2, both at most 16 (25 for
//   n = 125), as two passes of FFTs held in registers.  Each warp owns
//   `rpw` rows and a private slice of shared memory; its lanes take tasks
//   in turn:
//     pass 1: a lane loads column j2 of a row (x[j1*n2 + j2], j1 < n1:
//             for each j1 the warp reads runs of n2 consecutive points),
//             runs the n1-point FFT in registers (RegFft: radix-2/3/4/5/
//             7/8 DIF steps on the butterflies of stockham_stages.cuh),
//             multiplies output k1 by W_n^(j2 k1) and writes it to the
//             slice (padded so that both passes spread over the banks);
//     pass 2: after __syncwarp, a lane reads row k1 of the slice, runs
//             the n2-point FFT and stores output k2 at y[k1 + n1 k2] (runs
//             of n1 consecutive points).
//   One read and one write of each row, no block barrier.  Every twiddle
//   is a root W_n^e of one table of n roots, built in float64 on the host
//   and cast once (no fast-math sincos); the forward table serves the
//   inverse too, which conjugates on load and on store.
// * other n (11, 13, ..., 127; dft_kernel): the direct product, as the
//   first port had it: one CTA owns a tile of tile_b rows in shared memory;
//   each thread owns a 4 x 4 register tile of outputs (4 rows, 4 columns)
//   and, per step j of the sum, loads 4 values of X (broadcasts) and 4 of
//   W's row j (coalesced) for 16 complex FMAs; W (up to 256 KB) is read
//   from global memory, resident in L1/L2; fp32 / fp64 FMA on the CUDA
//   cores (TF32 would break the suite's 1e-5 roundtrip bar).
//
// Layout: interleaved complex (torch.view_as_real of contiguous tensors).
// Plain C interface (dft_fft_f32 / dft_fft_f64 and dft_f32 / dft_f64),
// loaded with ctypes; each returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "stockham_stages.cuh"  // Cx, cfma, mul, Butterfly

namespace {

constexpr int kThreads = 256;
constexpr int kFftWarps = 4;            // warps of an FFT-body block
constexpr int kRT = 4;                  // register tile edge
constexpr int kMaxN = 128;

// ---- the FFT body ------------------------------------------------------

// The radix of the first DIF step of an m-point FFT in registers: all of m
// where one butterfly takes it, else 4, 2, 3 or 5.
__host__ __device__ constexpr int first_radix(int m) {
  return (m == 2 || m == 3 || m == 4 || m == 5 || m == 7 || m == 8) ? m
       : m % 4 == 0 ? 4 : m % 2 == 0 ? 2 : m % 3 == 0 ? 3 : 5;
}

// Where RegFft<m> leaves X[k]: each DIF step leaves its outputs in
// digit-reversed blocks, X[u + R k'] at (m / R) u + (position of k' in the
// sub-FFT).
__host__ __device__ constexpr int fft_pos(int m, int k) {
  int pos = 0;
  while (m > 1 && first_radix(m) != m) {
    const int r = first_radix(m);
    m /= r;
    pos += m * (k % r);
    k /= r;
  }
  return m > 1 ? pos + k : pos;
}

// fft_pos for every output, evaluated by the compiler, so that a register
// array is only ever indexed by constants.
template <int M>
struct FftOrder {
  int at[M];
  __host__ __device__ constexpr FftOrder() : at() {
    for (int k = 0; k < M; ++k) at[k] = fft_pos(M, k);
  }
};

// The forward M-point FFT of a[0..M) in registers: a radix-R DIF step
// (R-point butterflies over a[q + Q t], outputs times W_M^(u q)), then the
// Q-point FFTs of the R blocks.  w[e * stride] is W_M^e.
template <int M, typename T>
struct RegFft {
  __device__ __forceinline__ static void run(Cx<T>* a,
                                             const Cx<T>* __restrict__ w,
                                             int stride) {
    constexpr int R = first_radix(M);
    constexpr int Q = M / R;
    if constexpr (Q == 1) {
      Butterfly<R, false, T>::run(a);
    } else {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        Cx<T> b[R];
#pragma unroll
        for (int t = 0; t < R; ++t) b[t] = a[q + Q * t];
        Butterfly<R, false, T>::run(b);
        a[q] = b[0];
#pragma unroll
        for (int u = 1; u < R; ++u)
          a[q + Q * u] = q == 0 ? b[u] : mul(b[u], w[u * q * stride]);
      }
#pragma unroll
      for (int u = 0; u < R; ++u) RegFft<Q, T>::run(a + Q * u, w, stride * R);
    }
  }
};

template <typename T>
struct RegFft<1, T> {
  __device__ __forceinline__ static void run(Cx<T>*, const Cx<T>* __restrict__,
                                             int) {}
};

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

// ---- the direct body ---------------------------------------------------

template <typename T, bool INV>
__global__ void __launch_bounds__(kThreads)
dft_kernel(const Cx<T>* __restrict__ x, Cx<T>* __restrict__ y,
           const Cx<T>* __restrict__ w, long long rows, int n, int tile_b,
           T inv_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* xs = reinterpret_cast<Cx<T>*>(smem_raw);  // tile_b * n
  const long long row0 = static_cast<long long>(blockIdx.x) * tile_b;
  const int sigs = static_cast<int>(min(static_cast<long long>(tile_b), rows - row0));

  const Cx<T>* xg = x + row0 * n;
  for (int i = threadIdx.x; i < sigs * n; i += blockDim.x) xs[i] = xg[i];
  __syncthreads();

  // outputs y[r, k] for r = ri + a*ni, k = kj + c*nj
  const int ni = (sigs + kRT - 1) / kRT;
  const int nj = (n + kRT - 1) / kRT;
  for (int g = threadIdx.x; g < ni * nj; g += blockDim.x) {
    const int kj = g % nj;
    const int ri = g / nj;
    const Cx<T>* xr[kRT];
    int kk[kRT];
#pragma unroll
    for (int a = 0; a < kRT; ++a) xr[a] = xs + min(ri + a * ni, sigs - 1) * n;
#pragma unroll
    for (int c = 0; c < kRT; ++c) kk[c] = min(kj + c * nj, n - 1);
    Cx<T> acc[kRT][kRT];
#pragma unroll
    for (int a = 0; a < kRT; ++a)
#pragma unroll
      for (int c = 0; c < kRT; ++c) acc[a][c] = {T(0), T(0)};
    for (int j = 0; j < n; ++j) {
      const Cx<T>* wrow = w + j * n;
      Cx<T> u[kRT], v[kRT];
#pragma unroll
      for (int a = 0; a < kRT; ++a) u[a] = xr[a][j];
#pragma unroll
      for (int c = 0; c < kRT; ++c) v[c] = wrow[kk[c]];
#pragma unroll
      for (int a = 0; a < kRT; ++a)
#pragma unroll
        for (int c = 0; c < kRT; ++c) acc[a][c] = cfma(u[a], v[c], acc[a][c]);
    }
#pragma unroll
    for (int a = 0; a < kRT; ++a) {
      const int r = ri + a * ni;
      if (r >= sigs) continue;
      Cx<T>* yo = y + (row0 + r) * n;
#pragma unroll
      for (int c = 0; c < kRT; ++c) {
        const int k = kj + c * nj;
        if (k < n)
          yo[k] = INV ? Cx<T>{acc[a][c].re * inv_n, acc[a][c].im * inv_n}
                      : acc[a][c];
      }
    }
  }
}

template <typename T, bool INV>
int launch_dir(const void* x, void* y, const void* w, long long rows, int n,
               int tile_b, size_t smem, cudaStream_t stream) {
  auto kern = dft_kernel<T, INV>;
  const cudaError_t err = opt_in<dft_kernel<T, INV>>(smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + tile_b - 1) / tile_b;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(y),
      static_cast<const Cx<T>*>(w), rows, n, tile_b,
      T(1) / static_cast<T>(n));
  return cudaGetLastError();
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

template <typename T>
int launch(const void* x, void* y, const void* w, long long rows, int n,
           int tile_b, int inverse, void* stream) {
  if (n < 1 || n > kMaxN || tile_b < 1 || rows < 1)
    return cudaErrorInvalidValue;
  if ((rows + tile_b - 1) / tile_b > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(tile_b) * n * sizeof(Cx<T>);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return inverse ? launch_dir<T, true>(x, y, w, rows, n, tile_b, smem, s)
                 : launch_dir<T, false>(x, y, w, rows, n, tile_b, smem, s);
}

}  // namespace

extern "C" int dft_f32(const void* x, void* y, const void* w, long long rows,
                       int n, int tile_b, int inverse, void* stream) {
  return launch<float>(x, y, w, rows, n, tile_b, inverse, stream);
}

extern "C" int dft_f64(const void* x, void* y, const void* w, long long rows,
                       int n, int tile_b, int inverse, void* stream) {
  return launch<double>(x, y, w, rows, n, tile_b, inverse, stream);
}

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
