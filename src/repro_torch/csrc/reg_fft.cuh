// The register FFT shared by the port's kernels for Hopper (sm_90a): an
// M-point FFT held in one thread's registers as radix-2/3/4/5/7/8 DIF
// steps on the butterflies of stockham_stages.cuh, its outputs left in
// digit-reversed places (FftOrder says where).
//
// Included by dft.cu (the FFT and chirp bodies' passes) and fft4step.cu
// (the four-step kernel's FFT body: each side's passes).  Everything here
// lives in an anonymous namespace, as in stockham_stages.cuh.

#pragma once

#include "stockham_stages.cuh"  // Cx, mul, Butterfly

namespace {

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

}  // namespace
