// Tensor-core panel products for the port's DFT-as-product kernels on
// Hopper (sm_90a), through mma.sync:
//
//   out[m][c] = sum_{k < N} W[m][k] * B[k][c],  W[m][k] = w^{(m k) mod N}
//
// for the rows m of one group of m-tiles and the columns c of one panel,
// where W is an N x N DFT matrix given by its N roots w^e (a table in
// shared memory, indexed at (m k) mod N, so W itself never needs to fit)
// and B is read through a functor.  A warp owns the group: it keeps the
// group's accumulators in registers for the whole depth k, so a caller can
// read a panel of B and write the product back over it (in place) once
// every warp that reads the panel has its sums.
//
// complex64 (3xTF32): each fp32 operand is split into a TF32 high part and
// a TF32 remainder (cvt.rna.tf32.f32), and hi*hi + hi*lo + lo*hi is summed
// in fp32 accumulators by mma.sync.m16n8k8 (tf32): plain TF32 keeps 10
// mantissa bits and misses the suite's 1e-5 bar, the three terms keep
// fp32's accuracy.  The roots are split once, into the shared table.
// complex128: mma.sync.m8n8k4 (f64), the fp64 tensor-core path.
// The complex product runs as the real block product
//   [Re; Im] += [Wr -Wi; Wi Wr] [Br; Bi]
// (four real products; Gauss's three-product form would need a third
// accumulator set and subtracts nearly equal sums).
//
// Included by fft4step.cu (its column and row passes); the same routine
// serves a direct DFT, x W = (W x^T)^T, panel by panel of rows.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "stockham_stages.cuh"  // Cx

namespace {

// A root in the shared table: (hi.re, hi.im, lo.re, lo.im) TF32 parts for
// complex64, the value for complex128.
template <typename T>
struct TcRoot;
template <>
struct TcRoot<float> {
  using type = float4;
};
template <>
struct TcRoot<double> {
  using type = double2;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ float4 make_root(Cx<float> w) {
  uint32_t hr, lr, hi, li;
  split_tf32(w.re, hr, lr);
  split_tf32(w.im, hi, li);
  return make_float4(__uint_as_float(hr), __uint_as_float(hi),
                     __uint_as_float(lr), __uint_as_float(li));
}
__device__ __forceinline__ double2 make_root(Cx<double> w) {
  return make_double2(w.re, w.im);
}

// d += a b: (16 x 8) += (16 x 8 tf32) (8 x 8 tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: (8 x 8) += (8 x 4 f64) (4 x 8 f64)
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

__device__ __forceinline__ int wrap_add(int a, int b, int n) {
  const int s = a + b;
  return s >= n ? s - n : s;
}

// The accumulators of one warp's group of up to MG m-tiles (16 rows each
// for complex64, 8 for complex128) by NP 8-column n-tiles: each A
// fragment, looked up from the roots, serves NP products.
template <typename T, int MG, int NP>
struct TcAcc;

template <int MG, int NP>
struct TcAcc<float, MG, NP> {
  static constexpr int kRows = 16;  // rows of an m-tile
  float re[MG][NP][4], im[MG][NP][4];

  // mts m-tiles from m-tile mt0; load_b(k, c) returns B[k][c] for
  // c < 8 NP, zero for k >= N or a column the caller does not have (the
  // A fragment is not masked: any root times a zero adds nothing)
  template <typename LoadB>
  __device__ __forceinline__ void product(const float4* __restrict__ roots,
                                          int N, int mt0, int mts,
                                          LoadB load_b) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MG; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) re[i][j][e] = im[i][j][e] = 0.f;
    // A fragment (m16 x k8): rows r0 = 16 mt + g and r1 = r0 + 8, columns
    // ka = 8 ks + t and kb = ka + 4; the root index (r k) mod N of each,
    // stepped by 8 r per k-step and by 16 k per m-tile
    const int r0 = kRows * mt0 + g, r1 = r0 + 8;
    int i00 = (r0 * t) % N, i10 = (r1 * t) % N;
    int i01 = (r0 * (t + 4)) % N, i11 = (r1 * (t + 4)) % N;
    const int d0 = (8 * r0) % N, d1 = (8 * r1) % N;
    int sa = (16 * t) % N, sb = (16 * (t + 4)) % N;
    const int dk = 128 % N;
    for (int ka = t; ka < N + t; ka += 8) {
      const int kb = ka + 4;
      // B's parts, and its imaginary parts negated for Re += Ai (-Bi)
      uint32_t brh[NP][2], brl[NP][2], bih[NP][2], bil[NP][2];
      uint32_t nih[NP][2], nil[NP][2];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const Cx<float> v0 = load_b(ka, 8 * j + g), v1 = load_b(kb, 8 * j + g);
        split_tf32(v0.re, brh[j][0], brl[j][0]);
        split_tf32(v1.re, brh[j][1], brl[j][1]);
        split_tf32(v0.im, bih[j][0], bil[j][0]);
        split_tf32(v1.im, bih[j][1], bil[j][1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          nih[j][h] = bih[j][h] ^ 0x80000000u;
          nil[j][h] = bil[j][h] ^ 0x80000000u;
        }
      }
      int j00 = i00, j10 = i10, j01 = i01, j11 = i11;
#pragma unroll
      for (int i = 0; i < MG; ++i) {
        if (i < mts) {
          const float4 w0 = roots[j00], w1 = roots[j10];
          const float4 w2 = roots[j01], w3 = roots[j11];
          const uint32_t arh[4] = {__float_as_uint(w0.x), __float_as_uint(w1.x),
                                   __float_as_uint(w2.x), __float_as_uint(w3.x)};
          const uint32_t aih[4] = {__float_as_uint(w0.y), __float_as_uint(w1.y),
                                   __float_as_uint(w2.y), __float_as_uint(w3.y)};
          const uint32_t arl[4] = {__float_as_uint(w0.z), __float_as_uint(w1.z),
                                   __float_as_uint(w2.z), __float_as_uint(w3.z)};
          const uint32_t ail[4] = {__float_as_uint(w0.w), __float_as_uint(w1.w),
                                   __float_as_uint(w2.w), __float_as_uint(w3.w)};
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            // the small terms first, then the large one
            mma_tf32(re[i][j], arl, brh[j][0], brh[j][1]);
            mma_tf32(re[i][j], arh, brl[j][0], brl[j][1]);
            mma_tf32(re[i][j], ail, nih[j][0], nih[j][1]);
            mma_tf32(re[i][j], aih, nil[j][0], nil[j][1]);
            mma_tf32(re[i][j], arh, brh[j][0], brh[j][1]);
            mma_tf32(re[i][j], aih, nih[j][0], nih[j][1]);
            mma_tf32(im[i][j], ail, brh[j][0], brh[j][1]);
            mma_tf32(im[i][j], aih, brl[j][0], brl[j][1]);
            mma_tf32(im[i][j], arl, bih[j][0], bih[j][1]);
            mma_tf32(im[i][j], arh, bil[j][0], bil[j][1]);
            mma_tf32(im[i][j], aih, brh[j][0], brh[j][1]);
            mma_tf32(im[i][j], arh, bih[j][0], bih[j][1]);
          }
        }
        j00 = wrap_add(j00, sa, N);
        j10 = wrap_add(j10, sa, N);
        j01 = wrap_add(j01, sb, N);
        j11 = wrap_add(j11, sb, N);
      }
      i00 = wrap_add(i00, d0, N);
      i10 = wrap_add(i10, d1, N);
      i01 = wrap_add(i01, d0, N);
      i11 = wrap_add(i11, d1, N);
      sa = wrap_add(sa, dk, N);
      sb = wrap_add(sb, dk, N);
    }
  }

  // store(m, c, v0, v1): out[m][c] = v0 and out[m][c + 1] = v1, for every
  // row m < N of the group (c even, < 8 NP; the caller drops columns it
  // lacks)
  template <typename Store>
  __device__ __forceinline__ void epilogue(int N, int mt0, int mts,
                                           Store store) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MG; ++i) {
      if (i < mts) {
        const int m0 = kRows * (mt0 + i) + g;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (m0 < N)
            store(m0, 8 * j + 2 * t, Cx<float>{re[i][j][0], im[i][j][0]},
                  Cx<float>{re[i][j][1], im[i][j][1]});
          if (m0 + 8 < N)
            store(m0 + 8, 8 * j + 2 * t, Cx<float>{re[i][j][2], im[i][j][2]},
                  Cx<float>{re[i][j][3], im[i][j][3]});
        }
      }
    }
  }
};

template <int MG, int NP>
struct TcAcc<double, MG, NP> {
  static constexpr int kRows = 8;
  double re[MG][NP][2], im[MG][NP][2];

  template <typename LoadB>
  __device__ __forceinline__ void product(const double2* __restrict__ roots,
                                          int N, int mt0, int mts,
                                          LoadB load_b) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MG; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) re[i][j][e] = im[i][j][e] = 0.0;
    // A fragment (m8 x k4): row r = 8 mt + g, column k = 4 ks + t; the
    // root index (r k) mod N, stepped by 4 r per k-step and by 8 k per
    // m-tile
    const int r = kRows * mt0 + g;
    int i0 = (r * t) % N;
    const int d = (4 * r) % N;
    int s = (8 * t) % N;
    const int dk = 32 % N;
    for (int k = t; k < N + t; k += 4) {
      Cx<double> v[NP];
#pragma unroll
      for (int j = 0; j < NP; ++j) v[j] = load_b(k, 8 * j + g);
      int idx = i0;
#pragma unroll
      for (int i = 0; i < MG; ++i) {
        if (i < mts) {
          const double2 w = roots[idx];
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            mma_f64(re[i][j], w.x, v[j].re);
            mma_f64(re[i][j], -w.y, v[j].im);
            mma_f64(im[i][j], w.y, v[j].re);
            mma_f64(im[i][j], w.x, v[j].im);
          }
        }
        idx = wrap_add(idx, s, N);
      }
      i0 = wrap_add(i0, d, N);
      s = wrap_add(s, dk, N);
    }
  }

  template <typename Store>
  __device__ __forceinline__ void epilogue(int N, int mt0, int mts,
                                           Store store) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MG; ++i) {
      const int m = kRows * (mt0 + i) + g;
      if (i < mts && m < N) {
#pragma unroll
        for (int j = 0; j < NP; ++j)
          store(m, 8 * j + 2 * t, Cx<double>{re[i][j][0], im[i][j][0]},
                Cx<double>{re[i][j][1], im[i][j][1]});
      }
    }
  }
};

}  // namespace
