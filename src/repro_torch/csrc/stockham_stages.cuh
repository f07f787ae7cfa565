// Stage routine shared by the port's FFT kernels for Hopper (sm_90a):
// interleaved complex values, the radix-2/3/4/5/7/8 butterflies, one
// Stockham stage over a tile of rows (run_stage), and the launches' opt-in
// to more than 48 KB of shared memory a block (opt_in).
//
// Included by stockham.cu (the fused 1-D kernel), fft2.cu (the fused
// rank-2 kernel: its row stages and, with cols = n2, its column stages),
// fftconv.cu (Cx, the butterflies: its own power-of-two stage routine),
// fft4step.cu and tc_product.cuh (Cx, mul, scale) and dft.cu (Cx, cfma, mul,
// the butterflies); every kernel's launch uses opt_in.
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

// cos(2*pi*j/r) and sin(2*pi*j/r) for the odd radices, 0 < j < r.
__host__ __device__ constexpr double kcos(int r, int j) {
  return j > r / 2 ? kcos(r, r - j)
       : r == 3 ? -0.5
       : r == 5 ? (j == 1 ? 0.3090169943749474241023 : -0.8090169943749474241023)
       : (j == 1 ? 0.6234898018587335305251
          : j == 2 ? -0.2225209339563144042889 : -0.9009688679024191262361);
}
__host__ __device__ constexpr double ksin(int r, int j) {
  return j > r / 2 ? -ksin(r, r - j)
       : r == 3 ? 0.8660254037844386467637
       : r == 5 ? (j == 1 ? 0.9510565162951535721164 : 0.5877852522924731291687)
       : (j == 1 ? 0.7818314824680298087084
          : j == 2 ? 0.9749279121818236070181 : 0.4338837391175581204758);
}

template <int R, bool INV, typename T>
struct Butterfly;

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

}  // namespace
