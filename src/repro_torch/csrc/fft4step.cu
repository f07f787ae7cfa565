// Fused four-step FFT for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fft4step/fft4step.py : fft4step
//   (body _fft4step_kernel: D = (W1 @ A * T) @ W2, out = D^T).
// For a signal of length n = n1*n2 (n1, n2 <= 128) viewed as the
// row-major n1 x n2 matrix X[j1, j2] = x[j1*n2 + j2] it computes
//
//     C[k1, j2] = T[k1, j2] * DFT_n1(X[:, j2])[k1]    (column pass)
//     y[k2*n1 + k1] = DFT_n2(C[k1, :])[k2]             (row pass)
//
// with T[k1, j2] = w_n^(k1 j2), so y is the natural-order DFT of x; the
// inverse applies 1/n.
//
// Bound: device-memory bytes for the function (a length-n DFT: ~5 n
// log2(n) flops on 2 * n * sizeof(complex) bytes, ~66 flops a point at
// 4096, under the fp32 ridge of ~320).  Two bodies, one per split:
//
// * The FFT body (both sides 7-smooth: the main path's splits but P14's):
//   each side's DFTs are FFTs held in registers (reg_fft.cuh), so the
//   arithmetic stays near 5 log2(n) flops a point and the bytes bound it.
//   A side runs as one to three register passes of radix f <= 16 over a
//   shared-memory plane (the host's side_radices: one pass up to 16
//   points, 64 = 8 x 8, 128 = 16 x 8, 125 = 5 x 5 x 5), each an in-place
//   DIF step: a thread takes the f points q + step p of one block of the
//   side, runs their f-point FFT and leaves output k at q + step k, times
//   W_span^(q k) unless it is the side's last pass.  After a side's passes
//   position r holds the frequency digit_rev(r).  So:
//     load:    the tile's signals into the plane (rows padded to an odd
//              pitch where it fits, so that a warp reading down a column
//              hits each bank the fewest times), up to 16 complex64 or
//              8 complex128 loads a thread in flight, conjugated for the
//              inverse;
//     columns: the n1-side passes over every column, lanes on adjacent
//              columns; the last one multiplies output k1 by T from two
//              128-entry root tables (w_n^(128 (e >> 7)) * w_n^(e & 127))
//              and writes it back in place;
//     rows:    the n2-side passes over every row, lanes on adjacent rows;
//              the last one stores output k2 of row r to y[k2*n1 + k1],
//              k1 = digit_rev(r) (a warp's 32 rows are runs of 32/f
//              consecutive k1; one point a lane: pairs of adjacent k1
//              through a lane shuffle spill at the launch bounds and read
//              slower, profile_fourstep.py's "pair stores").
//   A block barrier separates the passes.  A complex128 split whose plane
//   one block does not hold (over 13920 points: P11's 128 x 128) runs as
//   two launches through a scratch signal: the column passes over a tile
//   of adjacent columns (the last pass's points, times T, stored to the
//   scratch signal in position order), then the row passes over a tile of
//   adjacent rows with the transposed store; each launch moves the signal
//   once.  Every table is read from the plan; the inverse conjugates the
//   tables, the input and the output.
// * The product body (a side that is not 7-smooth, such as P14's 19 x
//   19): both DFTs as dense products on the tensor cores through the
//   panel product of tc_product.cuh: 3xTF32 (mma.sync.m16n8k8, three TF32
//   products per fp32 product, so 3 * 8 (n1 + n2) flops per point at the
//   495 TFLOP/s TF32 peak) for complex64, and mma.sync.m8n8k4 f64 (the 67
//   TFLOP/s fp64 tensor-core peak) for complex128.  Shared memory holds
//   one plane per signal, in place:
//   * one CTA owns a tile of tile_b signals; it copies them into its
//     plane (rows padded to a pitch of 4 mod 16 points, so a warp's
//     fragment loads of either pass hit each bank at most the minimum
//     number of times) and the roots of W1, W2 (split for 3xTF32) and of T
//     into shared tables;
//   * column pass: a warp owns a panel of 16 columns (NP = 2 tensor-core
//     n-tiles, which share each looked-up fragment of W1; 8 columns when a
//     side is at most 8) and a group of up to MG m-tiles of the output
//     rows, sums the whole depth j1 in registers, then writes C over its
//     panel with the twiddle applied.  A panel whose rows need more than
//     one group is read by all of them before any writes: the block
//     barriers between a round's sums and its stores;
//   * row pass: a warp owns 16 (or 8) rows of C (the product's columns, C^T)
//     and a group of m-tiles of k2, and stores y[k2*n1 + k1] straight to
//     global memory: a quad of lanes writes 8 consecutive points, in
//     complex64 as four 16-byte stores (64 bytes, two whole sectors).
//   W1 and W2 never exist whole: the panel product indexes their root
//   tables at (m k) mod n1 or n2.  A complex128 split over one block runs
//   as two launches as above, with the products.
// One plane holds every split in complex64 (n = 16384 at most: one signal
// of 16384 is 129 KB, one block an SM) and, in complex128, the splits
// whose product-body plane fits 227 KB (up to 13920).
//
// Layout: interleaved complex (torch.view_as_real of contiguous tensors);
// the table vector holds the roots of W1 (n1), of W2 (n2), and T's two
// root tables (128 each).  Plain C interface (fft4step_fft_f32 /
// fft4step_fft_f64 and fft4step_fft_passes_f32 / _f64 for the FFT body,
// fft4step_f32 / fft4step_f64 and fft4step_passes_f32 / _f64 for the
// product body), loaded with ctypes; each returns the cudaError_t of the
// launch.

#include <cuda_runtime.h>

#include <type_traits>

#include "reg_fft.cuh"          // RegFft, FftOrder
#include "stockham_stages.cuh"  // Cx, mul, conj, scale, FastDiv
#include "tc_product.cuh"       // TcRoot, TcAcc, make_root

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN1 = 128;
constexpr int kTwiddleRoots = 128;      // each of T's two root tables

// points per padded plane row: n2 rounded up to 4 mod 16
__host__ __device__ constexpr int plane_pitch(int n2) {
  return n2 + ((4 - n2) % 16 + 16) % 16;
}

template <typename T>
constexpr size_t table_bytes() {
  return 2 * kMaxN1 * sizeof(typename TcRoot<T>::type) +
         2 * kTwiddleRoots * sizeof(Cx<T>);
}

template <typename T>
size_t smem_bytes(int n1, int n2, int tile_b) {
  return table_bytes<T>() + static_cast<size_t>(tile_b) * n1 *
                                plane_pitch(n2) * sizeof(Cx<T>);
}

// The roots of W1 and W2 (split for 3xTF32 in complex64) and T's two root
// tables, as far as k1 j2 < n reaches, from the plan's table vector into
// shared memory.
template <typename T>
__device__ __forceinline__ void load_tables(
    const Cx<T>* __restrict__ tables, int n1, int n2,
    typename TcRoot<T>::type* r1, typename TcRoot<T>::type* r2, Cx<T>* tlo,
    Cx<T>* thi) {
  const int n = n1 * n2;
  for (int i = threadIdx.x; i < n1; i += blockDim.x) r1[i] = make_root(tables[i]);
  for (int i = threadIdx.x; i < n2; i += blockDim.x) r2[i] = make_root(tables[n1 + i]);
  for (int i = threadIdx.x; i < min(n, kTwiddleRoots); i += blockDim.x)
    tlo[i] = tables[n1 + n2 + i];
  for (int i = threadIdx.x; i <= (n - 1) >> 7; i += blockDim.x)
    thi[i] = tables[n1 + n2 + kTwiddleRoots + i];
}

// A warp's item: a panel of 8 NP columns (column pass) or rows of C (row
// pass) by a group of up to MG m-tiles of the output rows.
template <typename T, int MG, int NP>
__global__ void __launch_bounds__(kThreads, 2)
fft4step_kernel(const Cx<T>* __restrict__ x, Cx<T>* __restrict__ y,
                const Cx<T>* __restrict__ tables, long long batch, int n1,
                int n2, int tile_b, T out_scale) {
  using Root = typename TcRoot<T>::type;
  using Acc = TcAcc<T, MG, NP>;
  constexpr int kPanel = 8 * NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Root* r1 = reinterpret_cast<Root*>(smem_raw);
  Root* r2 = r1 + kMaxN1;
  Cx<T>* tlo = reinterpret_cast<Cx<T>*>(r2 + kMaxN1);
  Cx<T>* thi = tlo + kTwiddleRoots;
  Cx<T>* plane = thi + kTwiddleRoots;
  const int n = n1 * n2;
  const int pitch = plane_pitch(n2);
  const long long sig0 = static_cast<long long>(blockIdx.x) * tile_b;
  const int sigs = static_cast<int>(min(static_cast<long long>(tile_b), batch - sig0));

  load_tables(tables, n1, n2, r1, r2, tlo, thi);
  // the tile's points in order, point i at plane row i / n2 (X[j1] of
  // signal j1 / n1, the tile's rows being consecutive) and column i % n2,
  // both stepped without a division
  const Cx<T>* xg = x + sig0 * n;
  {
    const int drow = kThreads / n2, dcol = kThreads % n2;
    int row = threadIdx.x / n2, col = threadIdx.x % n2;
    for (int i = threadIdx.x; i < sigs * n; i += kThreads) {
      plane[row * pitch + col] = xg[i];
      row += drow;
      col += dcol;
      if (col >= n2) {
        col -= n2;
        ++row;
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;

  const Cx<T> zero = {T(0), T(0)};

  // column pass: items (signal, panel of columns, group of m-tiles of
  // k1); a power-of-two count of groups per panel, so a round of kWarps
  // items holds every group of its panels (a group past the last m-tile
  // sums nothing)
  const int mt1 = (n1 + Acc::kRows - 1) / Acc::kRows;
  int groups1 = 1;
  while (groups1 * MG < mt1) groups1 *= 2;
  const int panels1 = (n2 + kPanel - 1) / kPanel;
  const int items1 = sigs * panels1 * groups1;
  for (int round = 0; round * kWarps < items1; ++round) {
    const int item = round * kWarps + warp;
    const int grp = item % groups1;
    const int s = item / groups1 / panels1;
    const int c0 = kPanel * (item / groups1 % panels1);
    const int mt0 = grp * MG;
    const int mts = min(MG, mt1 - mt0);
    const bool active = item < items1 && mts > 0;
    Cx<T>* xs = plane + s * n1 * pitch;
    Acc acc;
    if (active)
      acc.product(r1, n1, mt0, mts, [&](int j1, int c) {
        return j1 < n1 && c0 + c < n2 ? xs[j1 * pitch + c0 + c] : zero;
      });
    // a panel's groups all read it before any of them writes it
    if (groups1 > 1) __syncthreads();
    if (active)
      acc.epilogue(n1, mt0, mts, [&](int k1, int c, Cx<T> v0, Cx<T> v1) {
        const Cx<T> v[2] = {v0, v1};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j2 = c0 + c + u;
          if (j2 < n2) {
            const int e = k1 * j2;  // < n
            xs[k1 * pitch + j2] = mul(v[u], mul(thi[e >> 7], tlo[e & 127]));
          }
        }
      });
  }
  __syncthreads();

  // row pass: items (signal, panel of rows of C, group of m-tiles of
  // k2), stored transposed
  const int mt2 = (n2 + Acc::kRows - 1) / Acc::kRows;
  const int groups2 = (mt2 + MG - 1) / MG;
  const int panels2 = (n1 + kPanel - 1) / kPanel;
  const int items2 = sigs * panels2 * groups2;
  for (int item = warp; item < items2; item += kWarps) {
    const int grp = item % groups2;
    const int s = item / groups2 / panels2;
    const int k10 = kPanel * (item / groups2 % panels2);
    const int mt0 = grp * MG;
    const int mts = min(MG, mt2 - mt0);
    const Cx<T>* cs = plane + s * n1 * pitch;
    Cx<T>* yo = y + (sig0 + s) * n;
    Acc acc;
    acc.product(r2, n2, mt0, mts, [&](int j2, int c) {
      return j2 < n2 && k10 + c < n1 ? cs[(k10 + c) * pitch + j2] : zero;
    });
    acc.epilogue(n2, mt0, mts, [&](int k2, int c, Cx<T> v0, Cx<T> v1) {
      const int k1 = k10 + c;  // even
      Cx<T>* out = yo + k2 * n1 + k1;
      v0 = scale(v0, out_scale);
      v1 = scale(v1, out_scale);
      if constexpr (sizeof(T) == 4) {
        if (k1 + 1 < n1 && n1 % 2 == 0) {
          // the pair as one 16-byte store: a quad of lanes writes 64
          // contiguous bytes, two whole sectors
          *reinterpret_cast<float4*>(out) =
              make_float4(v0.re, v0.im, v1.re, v1.im);
          return;
        }
      }
      if (k1 < n1) out[0] = v0;
      if (k1 + 1 < n1) out[1] = v1;
    });
  }
}


// The two-launch form, for a signal whose plane does not fit one block
// (complex128 above 13920 points, such as 128 x 128 and 128 x 108): the
// same products, through a scratch signal C in global memory.
//   columns: a block stages a tile of `tile` adjacent columns of X (all
//            n1 rows: runs of `tile` points), and its warps write
//            C[k1, j2] = T[k1, j2] * (W1 X)[k1, j2] over them;
//   rows:    a block stages a tile of `tile` adjacent rows of C (one run
//            of tile * n2 points), and its warps store y[k2*n1 + k1] as
//            the one-block kernel's row pass does.
// Each launch moves the signal once, so the pair costs two round trips;
// its products are the one-block kernel's.
template <typename T, int MG, int NP>
__global__ void __launch_bounds__(kThreads, 2)
fft4step_columns_kernel(const Cx<T>* __restrict__ x, Cx<T>* __restrict__ c_out,
                        const Cx<T>* __restrict__ tables, int n1, int n2,
                        int tile) {
  using Root = typename TcRoot<T>::type;
  using Acc = TcAcc<T, MG, NP>;
  constexpr int kPanel = 8 * NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Root* r1 = reinterpret_cast<Root*>(smem_raw);
  Root* r2 = r1 + kMaxN1;
  Cx<T>* tlo = reinterpret_cast<Cx<T>*>(r2 + kMaxN1);
  Cx<T>* thi = tlo + kTwiddleRoots;
  Cx<T>* plane = thi + kTwiddleRoots;
  const int n = n1 * n2;
  const int pitch = plane_pitch(tile);
  const int tiles = (n2 + tile - 1) / tile;
  const long long s = blockIdx.x / tiles;
  const int col0 = static_cast<int>(blockIdx.x - s * tiles) * tile;
  const int cw = min(tile, n2 - col0);
  const Cx<T> zero = {T(0), T(0)};
  load_tables(tables, n1, n2, r1, r2, tlo, thi);
  const Cx<T>* xs = x + s * n + col0;
  for (int i = threadIdx.x; i < n1 * tile; i += kThreads) {
    const int j1 = i / tile, c = i - j1 * tile;
    plane[j1 * pitch + c] = c < cw ? xs[j1 * n2 + c] : zero;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int mt1 = (n1 + Acc::kRows - 1) / Acc::kRows;
  const int groups1 = (mt1 + MG - 1) / MG;
  const int items = (cw + kPanel - 1) / kPanel * groups1;
  Cx<T>* cs = c_out + s * n;
  for (int item = warp; item < items; item += kWarps) {
    const int mt0 = item % groups1 * MG;
    const int mts = min(MG, mt1 - mt0);
    const int p0 = kPanel * (item / groups1);  // the panel's first column
    Acc acc;
    acc.product(r1, n1, mt0, mts, [&](int j1, int c) {
      return j1 < n1 && p0 + c < cw ? plane[j1 * pitch + p0 + c] : zero;
    });
    acc.epilogue(n1, mt0, mts, [&](int k1, int c, Cx<T> v0, Cx<T> v1) {
      const Cx<T> v[2] = {v0, v1};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (p0 + c + u < cw) {
          const int j2 = col0 + p0 + c + u;
          const int e = k1 * j2;  // < n
          cs[k1 * n2 + j2] = mul(v[u], mul(thi[e >> 7], tlo[e & 127]));
        }
      }
    });
  }
}

template <typename T, int MG, int NP>
__global__ void __launch_bounds__(kThreads, 2)
fft4step_rows_kernel(const Cx<T>* __restrict__ c_in, Cx<T>* __restrict__ y,
                     const Cx<T>* __restrict__ tables, int n1, int n2,
                     int tile, T out_scale) {
  using Root = typename TcRoot<T>::type;
  using Acc = TcAcc<T, MG, NP>;
  constexpr int kPanel = 8 * NP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Root* r1 = reinterpret_cast<Root*>(smem_raw);
  Root* r2 = r1 + kMaxN1;
  Cx<T>* tlo = reinterpret_cast<Cx<T>*>(r2 + kMaxN1);
  Cx<T>* thi = tlo + kTwiddleRoots;
  Cx<T>* plane = thi + kTwiddleRoots;
  const int n = n1 * n2;
  const int pitch = plane_pitch(n2);
  const int tiles = (n1 + tile - 1) / tile;
  const long long s = blockIdx.x / tiles;
  const int row0 = static_cast<int>(blockIdx.x - s * tiles) * tile;
  const int rw = min(tile, n1 - row0);
  const Cx<T> zero = {T(0), T(0)};
  load_tables(tables, n1, n2, r1, r2, tlo, thi);
  const Cx<T>* cg = c_in + s * n + static_cast<long long>(row0) * n2;
  {
    const int drow = kThreads / n2, dcol = kThreads % n2;
    int row = threadIdx.x / n2, col = threadIdx.x % n2;
    for (int i = threadIdx.x; i < rw * n2; i += kThreads) {
      plane[row * pitch + col] = cg[i];
      row += drow;
      col += dcol;
      if (col >= n2) {
        col -= n2;
        ++row;
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int mt2 = (n2 + Acc::kRows - 1) / Acc::kRows;
  const int groups2 = (mt2 + MG - 1) / MG;
  const int items = (rw + kPanel - 1) / kPanel * groups2;
  Cx<T>* yo = y + s * n;
  for (int item = warp; item < items; item += kWarps) {
    const int mt0 = item % groups2 * MG;
    const int mts = min(MG, mt2 - mt0);
    const int p0 = kPanel * (item / groups2);  // the panel's first row
    Acc acc;
    acc.product(r2, n2, mt0, mts, [&](int j2, int c) {
      return j2 < n2 && p0 + c < rw ? plane[(p0 + c) * pitch + j2] : zero;
    });
    acc.epilogue(n2, mt0, mts, [&](int k2, int c, Cx<T> v0, Cx<T> v1) {
      const int k1 = row0 + p0 + c;  // even
      Cx<T>* out = yo + k2 * n1 + k1;
      v0 = scale(v0, out_scale);
      v1 = scale(v1, out_scale);
      if (k1 < row0 + rw) out[0] = v0;
      if (k1 + 1 < row0 + rw) out[1] = v1;
    });
  }
}

// f(MG, NP) with the runtime pair as compile-time constants.
template <typename F>
int with_mg_np(int mg, int np, F f) {
  using std::integral_constant;
  switch (4 * np + mg) {
    case 5: return f(integral_constant<int, 1>{}, integral_constant<int, 1>{});
    case 6: return f(integral_constant<int, 2>{}, integral_constant<int, 1>{});
    case 8: return f(integral_constant<int, 4>{}, integral_constant<int, 1>{});
    case 9: return f(integral_constant<int, 1>{}, integral_constant<int, 2>{});
    case 10: return f(integral_constant<int, 2>{}, integral_constant<int, 2>{});
    default: return f(integral_constant<int, 4>{}, integral_constant<int, 2>{});
  }
}

template <typename T, int MG, int NP>
int launch_mg(const void* x, void* y, const void* tables, long long batch,
              int n1, int n2, int tile_b, T out_scale, size_t smem,
              cudaStream_t stream) {
  auto kern = fft4step_kernel<T, MG, NP>;
  const cudaError_t err = opt_in<fft4step_kernel<T, MG, NP>>(smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (batch + tile_b - 1) / tile_b;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(y),
      static_cast<const Cx<T>*>(tables), batch, n1, n2, tile_b, out_scale);
  return cudaGetLastError();
}

bool valid_split(int n1, int n2, int mg, int np, long long batch) {
  return n1 >= 1 && n1 <= kMaxN1 && n2 >= 1 && n2 <= kMaxN1 && batch >= 1 &&
         (mg == 1 || mg == 2 || mg == 4) && (np == 1 || np == 2);
}

template <typename T>
int launch(const void* x, void* y, const void* tables, long long batch,
           int n1, int n2, int tile_b, int mg, int np, int inverse,
           void* stream) {
  if (!valid_split(n1, n2, mg, np, batch) || tile_b < 1)
    return cudaErrorInvalidValue;
  if ((batch + tile_b - 1) / tile_b > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(n1, n2, tile_b);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const T out_scale = inverse ? T(1) / static_cast<T>(n1 * n2) : T(1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_mg_np(mg, np, [&](auto MG, auto NP) {
    return launch_mg<T, decltype(MG)::value, decltype(NP)::value>(
        x, y, tables, batch, n1, n2, tile_b, out_scale, smem, s);
  });
}

template <typename T, int MG, int NP>
int launch_passes_mg(const void* x, void* tmp, void* y, const void* tables,
                     long long batch, int n1, int n2, int tile_cols,
                     int tile_rows, T out_scale, cudaStream_t stream) {
  const size_t smem_c = table_bytes<T>() + static_cast<size_t>(n1) *
                                               plane_pitch(tile_cols) * sizeof(Cx<T>);
  const size_t smem_r = table_bytes<T>() + static_cast<size_t>(tile_rows) *
                                               plane_pitch(n2) * sizeof(Cx<T>);
  const long long blocks_c = batch * ((n2 + tile_cols - 1) / tile_cols);
  const long long blocks_r = batch * ((n1 + tile_rows - 1) / tile_rows);
  if (smem_c > static_cast<size_t>(kMaxSmem) ||
      smem_r > static_cast<size_t>(kMaxSmem) || blocks_c > 0x7fffffffLL ||
      blocks_r > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err = opt_in<fft4step_columns_kernel<T, MG, NP>>(smem_c);
  if (err != cudaSuccess) return err;
  err = opt_in<fft4step_rows_kernel<T, MG, NP>>(smem_r);
  if (err != cudaSuccess) return err;
  auto kc = fft4step_columns_kernel<T, MG, NP>;
  auto kr = fft4step_rows_kernel<T, MG, NP>;
  kc<<<static_cast<unsigned>(blocks_c), kThreads, smem_c, stream>>>(
      static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(tmp),
      static_cast<const Cx<T>*>(tables), n1, n2, tile_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kr<<<static_cast<unsigned>(blocks_r), kThreads, smem_r, stream>>>(
      static_cast<const Cx<T>*>(tmp), static_cast<Cx<T>*>(y),
      static_cast<const Cx<T>*>(tables), n1, n2, tile_rows, out_scale);
  return cudaGetLastError();
}

// The two launches (columns to tmp, rows to y); tile_cols and tile_rows are
// multiples of the panel (8 np).
template <typename T>
int launch_passes(const void* x, void* tmp, void* y, const void* tables,
                  long long batch, int n1, int n2, int tile_cols,
                  int tile_rows, int mg, int np, int inverse, void* stream) {
  if (!valid_split(n1, n2, mg, np, batch) || tile_cols < 1 || tile_rows < 1 ||
      tile_cols % (8 * np) != 0 || tile_rows % (8 * np) != 0)
    return cudaErrorInvalidValue;
  const T out_scale = inverse ? T(1) / static_cast<T>(n1 * n2) : T(1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_mg_np(mg, np, [&](auto MG, auto NP) {
    return launch_passes_mg<T, decltype(MG)::value, decltype(NP)::value>(
        x, tmp, y, tables, batch, n1, n2, tile_cols, tile_rows, out_scale, s);
  });
}

// ---- the FFT body --------------------------------------------------------

constexpr int kFftThreads = 256;      // threads of a block
constexpr int kFftWideThreads = 512;  // of a block with an SM to itself
// Blocks an SM the registers must allow (the launch bounds): three in
// complex64 (80 registers a thread, no spill), two in complex128 (three
// spill); one for a wide block.
constexpr int kFftMinBlocksF = 3;
constexpr int kFftMinBlocksD = 2;
constexpr int kSidePasses = 3;        // register passes of one side at most
constexpr int kFftRoots = 4 * 128;    // the shared tables: W1's, W2's, T's two
// Loads a thread keeps in flight staging: 16 points of complex64 in the one
// launch and the two launches, 8 of complex128 in the one launch (the same
// bytes in flight; 16 read alike at P7's 64 x 524288, 4 slower).
constexpr int kLoadsF = 16;
constexpr int kLoadsD = 8;
constexpr int kPassLoads = 16;

// The radices of the register passes (fft4step.py: FFT_RADICES); 1 is the
// one-point side of a prime n.
#define FFT4_RADICES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(12) X(14) X(15) X(16)

bool fft_radix(int f) {
#define FFT4_IS(F) f == F ||
  return FFT4_RADICES(FFT4_IS) false;
#undef FFT4_IS
}

// One register pass of a side: the side's positions in blocks of `span` =
// f * step points; a task takes the f points q + step p (p < f) of one
// block, runs their f-point FFT and leaves output k at q + step k (not the
// side's last pass: times W_len^(q k tw), tw = len / span).  groups = len
// / f tasks a line; d_lines divides a task index by the lines the pass
// runs over (the plane's columns, or its rows).
struct FftPass {
  int f, step, span, groups, tw, last;
  FastDiv d_lines, d_groups, d_step;
};

// A side of the split (n1: the column FFTs, n2: the row FFTs): its radices,
// first pass first; digit i of a frequency weighs pre[i] = f[0] ... f[i-1].
struct FftSide {
  int len, passes;
  int f[kSidePasses], pre[kSidePasses];
  FastDiv d_f[kSidePasses];
  FftPass pass[kSidePasses];
};

// pass i of a side, selected among compile-time indices (a kernel
// parameter indexed at run time would be copied to local memory)
__device__ __forceinline__ FftPass pass_of(const FftSide& s, int i) {
  return i == 0 ? s.pass[0] : i == 1 ? s.pass[1] : s.pass[2];
}

// The frequency at position pos after the side's first `count` passes: its
// digits, most significant first, in the radices f[0..count), reversed.
__device__ __forceinline__ int digit_rev(int pos, const FftSide& s,
                                         int count) {
  int k = 0;
#pragma unroll
  for (int i = kSidePasses - 1; i >= 0; --i) {
    if (i < count) {
      const int rest = fdiv(s.d_f[i], pos);
      k += (pos - rest * s.f[i]) * s.pre[i];
      pos = rest;
    }
  }
  return k;
}

// What one block's passes work on: nsig signals of rows x cols points (rows
// along the n1 side, columns along the n2 side) at `pitch` points a row;
// the plane's first row and column in its signal, the lines a ragged last
// tile holds, and the last pass's destination in global memory.
template <typename T>
struct FftCtx {
  Cx<T>* plane;
  const Cx<T>* r1;   // W_n1^e
  const Cx<T>* r2;   // W_n2^e
  const Cx<T>* tlo;  // w_n^e, e < 128
  const Cx<T>* thi;  // w_n^(128 e)
  int nsig, pitch, sig_stride;
  int rows, cols;              // lines of the row passes / column passes
  int valid_rows, valid_cols;  // lines that hold points
  int row0, col0;
  Cx<T>* out;                  // nullptr: the column side ends in the plane
  long long sig0;              // the plane's first signal
  int n, n1, n2;
  T scale;                     // the inverse's 1/n
  bool inv;
};

// A pass of the n1 side over every column of the plane, lanes on adjacent
// columns.  The side's last pass multiplies output k1 by T[k1, j2] and
// writes it back in place or (c.out: the two-launch form) to the scratch
// signal, at row position b F + k.
template <int F, typename T>
__device__ __forceinline__ void column_pass(const FftCtx<T>& c,
                                            const FftSide& side,
                                            const FftPass& p) {
  constexpr FftOrder<F> order{};
  const int tasks = c.nsig * p.groups * c.cols;
  const int dp = p.step * c.pitch;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int tq = fdiv(p.d_lines, t);
    const int col = t - tq * c.cols;
    if (col >= c.valid_cols) continue;
    const int s = fdiv(p.d_groups, tq);
    const int g = tq - s * p.groups;
    const int b = fdiv(p.d_step, g);
    const int q = g - b * p.step;
    Cx<T>* base = c.plane + s * c.sig_stride + (b * p.span + q) * c.pitch + col;
    Cx<T> a[F];
#pragma unroll
    for (int i = 0; i < F; ++i) a[i] = base[i * dp];
    RegFft<F, T>::run(a, c.r1, p.groups);
    if (!p.last) {
      const int e = q * p.tw;
      base[0] = a[0];
#pragma unroll
      for (int k = 1; k < F; ++k) base[k * dp] = mul(a[order.at[k]], c.r1[e * k]);
    } else {
      // step 1, q 0: block b holds the frequencies k1 = k0 + groups k
      const int k0 = digit_rev(b, side, side.passes - 1);
      const int j2 = c.col0 + col;
      Cx<T>* o = c.out ? c.out + (c.sig0 + s) * c.n +
                             static_cast<long long>(b * F) * c.n2 + j2
                       : base;
      const int os = c.out ? c.n2 : c.pitch;
#pragma unroll
      for (int k = 0; k < F; ++k) {
        const int e = (k0 + p.groups * k) * j2;  // < n
        o[k * os] = mul(a[order.at[k]], mul(c.thi[e >> 7], c.tlo[e & 127]));
      }
    }
  }
}

// A pass of the n2 side over every row of the plane, lanes on adjacent
// rows.  The side's last pass stores output k2 of row position r to
// out[k2 n1 + k1], k1 = the n1 side's digit_rev(row0 + r) (conjugated and
// times 1/n for the inverse).
template <int F, typename T>
__device__ __forceinline__ void row_pass(const FftCtx<T>& c,
                                         const FftSide& cside,
                                         const FftSide& side,
                                         const FftPass& p) {
  constexpr FftOrder<F> order{};
  const int tasks = c.nsig * p.groups * c.rows;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int tq = fdiv(p.d_lines, t);
    const int r = t - tq * c.rows;
    if (r >= c.valid_rows) continue;
    const int s = fdiv(p.d_groups, tq);
    const int g = tq - s * p.groups;
    const int b = fdiv(p.d_step, g);
    const int q = g - b * p.step;
    Cx<T>* base = c.plane + s * c.sig_stride + r * c.pitch + b * p.span + q;
    Cx<T> a[F];
#pragma unroll
    for (int i = 0; i < F; ++i) a[i] = base[i * p.step];
    RegFft<F, T>::run(a, c.r2, p.groups);
    if (!p.last) {
      const int e = q * p.tw;
      base[0] = a[0];
#pragma unroll
      for (int k = 1; k < F; ++k) base[k * p.step] = mul(a[order.at[k]], c.r2[e * k]);
    } else {
      const int k2 = digit_rev(b, side, side.passes - 1);
      const int k1 = digit_rev(c.row0 + r, cside, cside.passes);
      Cx<T>* o = c.out + (c.sig0 + s) * c.n + k1 +
                 static_cast<long long>(k2) * c.n1;
      const int os = p.groups * c.n1;
#pragma unroll
      for (int k = 0; k < F; ++k) {
        const Cx<T> v = a[order.at[k]];
        o[k * os] = c.inv ? Cx<T>{v.re * c.scale, -v.im * c.scale} : v;
      }
    }
  }
}

// Every pass of the n1 side (the column FFTs and T), a block barrier after
// each.
template <typename T>
__device__ __forceinline__ void column_side(const FftCtx<T>& c,
                                            const FftSide& side) {
  for (int i = 0; i < side.passes; ++i) {
    const FftPass p = pass_of(side, i);
    switch (p.f) {
#define FFT4_CASE(F) \
  case F: column_pass<F, T>(c, side, p); break;
      FFT4_RADICES(FFT4_CASE)
#undef FFT4_CASE
    }
    __syncthreads();
  }
}

// Every pass of the n2 side (the row FFTs and the transposed store).
template <typename T>
__device__ __forceinline__ void row_side(const FftCtx<T>& c,
                                         const FftSide& cside,
                                         const FftSide& side) {
  for (int i = 0; i < side.passes; ++i) {
    const FftPass p = pass_of(side, i);
    switch (p.f) {
#define FFT4_CASE(F) \
  case F: row_pass<F, T>(c, cside, side, p); break;
      FFT4_RADICES(FFT4_CASE)
#undef FFT4_CASE
    }
    if (i + 1 < side.passes) __syncthreads();
  }
}

// The plan's roots into the shared tables (conjugated for the inverse, so
// that every pass runs the forward transform): W1's n1, W2's n2, T's two.
template <typename T>
__device__ __forceinline__ void load_fft_tables(
    const Cx<T>* __restrict__ tables, int n1, int n2, bool inv,
    Cx<T>* tab) {
  const int n = n1 * n2;
  const int count[4] = {n1, n2, min(n, kTwiddleRoots), ((n - 1) >> 7) + 1};
  const int from[4] = {0, n1, n1 + n2, n1 + n2 + kTwiddleRoots};
#pragma unroll
  for (int t = 0; t < 4; ++t)
    for (int i = threadIdx.x; i < count[t]; i += blockDim.x) {
      const Cx<T> v = tables[from[t] + i];
      tab[t * kTwiddleRoots + i] = inv ? conj(v) : v;
    }
}

// `count` rows of `width` points, `gstride` apart in global memory, into
// plane rows `pitch` apart: each thread keeps up to LOADS loads in flight
// before its stores.  Points of a row past `valid` are zeros (a ragged
// last tile of columns).
template <int LOADS, typename T>
__device__ __forceinline__ void stage_rows(const Cx<T>* __restrict__ src,
                                           int count, int width, int valid,
                                           FastDiv d_width, int gstride,
                                           Cx<T>* plane, int pitch,
                                           bool inv) {
  const int total = count * width;
  const int nt = blockDim.x;
  for (int base = 0; base < total; base += nt * LOADS) {
    Cx<T> v[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = base + u * nt + threadIdx.x;
      v[u] = Cx<T>{T(0), T(0)};
      if (i < total) {
        const int row = fdiv(d_width, i), col = i - row * width;
        if (col < valid) v[u] = src[static_cast<long long>(row) * gstride + col];
      }
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = base + u * nt + threadIdx.x;
      if (i < total) {
        const int row = fdiv(d_width, i), col = i - row * width;
        plane[row * pitch + col] = inv ? conj(v[u]) : v[u];
      }
    }
  }
}

// The host's geometry of one launch of the FFT body.
struct FftGeom {
  FftSide col, row;   // the n1 side (over the plane's columns), the n2 side
  int pitch;          // points a plane row
  FastDiv d_width;    // the staged rows' width
};

// One launch: a block of THREADS stages tile_b signals into its plane,
// runs the column passes in place and the row passes with the transposed
// store.
template <typename T, int THREADS>
__global__ void __launch_bounds__(
    THREADS, THREADS > kFftThreads ? 1
             : sizeof(T) == 4     ? kFftMinBlocksF
                                  : kFftMinBlocksD)
fft4step_fft_kernel(const Cx<T>* __restrict__ x, Cx<T>* __restrict__ y,
                    const Cx<T>* __restrict__ tables, long long batch,
                    int tile_b, FftGeom g, T out_scale, int inverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(smem_raw);
  const int n1 = g.col.len, n2 = g.row.len, n = n1 * n2;
  const bool inv = inverse != 0;
  FftCtx<T> c;
  c.plane = tab + kFftRoots;
  c.r1 = tab;
  c.r2 = tab + kTwiddleRoots;
  c.tlo = tab + 2 * kTwiddleRoots;
  c.thi = tab + 3 * kTwiddleRoots;
  c.sig0 = static_cast<long long>(blockIdx.x) * tile_b;
  c.nsig = static_cast<int>(min(static_cast<long long>(tile_b), batch - c.sig0));
  c.pitch = g.pitch;
  c.sig_stride = n1 * g.pitch;
  c.rows = c.valid_rows = n1;
  c.cols = c.valid_cols = n2;
  c.row0 = c.col0 = 0;
  c.n = n;
  c.n1 = n1;
  c.n2 = n2;
  c.scale = out_scale;
  c.inv = inv;
  load_fft_tables(tables, n1, n2, inv, tab);
  stage_rows<sizeof(T) == 4 ? kLoadsF : kLoadsD>(
      x + c.sig0 * n, c.nsig * n1, n2, n2, g.d_width, n2, c.plane, g.pitch,
      inv);
  __syncthreads();
  c.out = nullptr;
  column_side(c, g.col);
  c.out = y;
  row_side(c, g.col, g.row);
}

// The two-launch form's first launch: a block stages the n1 rows of a tile
// of `tile` adjacent columns of one signal and runs the column passes, the
// last storing C (times T) to the scratch signal.
template <typename T>
__global__ void __launch_bounds__(
    kFftThreads, sizeof(T) == 4 ? kFftMinBlocksF : kFftMinBlocksD)
fft4step_fft_columns_kernel(const Cx<T>* __restrict__ x,
                            Cx<T>* __restrict__ c_out,
                            const Cx<T>* __restrict__ tables, int tile,
                            FftGeom g, int inverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(smem_raw);
  const int n1 = g.col.len, n2 = g.row.len, n = n1 * n2;
  const int tiles = (n2 + tile - 1) / tile;
  const bool inv = inverse != 0;
  FftCtx<T> c;
  c.plane = tab + kFftRoots;
  c.r1 = tab;
  c.r2 = tab + kTwiddleRoots;
  c.tlo = tab + 2 * kTwiddleRoots;
  c.thi = tab + 3 * kTwiddleRoots;
  c.sig0 = blockIdx.x / tiles;
  c.col0 = static_cast<int>(blockIdx.x - c.sig0 * tiles) * tile;
  c.row0 = 0;
  c.nsig = 1;
  c.pitch = g.pitch;
  c.sig_stride = n1 * g.pitch;
  c.rows = c.valid_rows = n1;
  c.cols = tile;
  c.valid_cols = min(tile, n2 - c.col0);
  c.n = n;
  c.n1 = n1;
  c.n2 = n2;
  c.scale = T(1);
  c.inv = false;
  c.out = c_out;
  load_fft_tables(tables, n1, n2, inv, tab);
  stage_rows<kPassLoads>(x + c.sig0 * n + c.col0, n1, tile, c.valid_cols,
                         g.d_width, n2, c.plane, g.pitch, inv);
  __syncthreads();
  column_side(c, g.col);
}

// The second launch: a block stages `tile` adjacent rows of the scratch
// signal and runs the row passes with the transposed store.
template <typename T>
__global__ void __launch_bounds__(
    kFftThreads, sizeof(T) == 4 ? kFftMinBlocksF : kFftMinBlocksD)
fft4step_fft_rows_kernel(const Cx<T>* __restrict__ c_in,
                         Cx<T>* __restrict__ y,
                         const Cx<T>* __restrict__ tables, int tile,
                         FftGeom g, T out_scale, int inverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* tab = reinterpret_cast<Cx<T>*>(smem_raw);
  const int n1 = g.col.len, n2 = g.row.len, n = n1 * n2;
  const int tiles = (n1 + tile - 1) / tile;
  const bool inv = inverse != 0;
  FftCtx<T> c;
  c.plane = tab + kFftRoots;
  c.r1 = tab;
  c.r2 = tab + kTwiddleRoots;
  c.tlo = tab + 2 * kTwiddleRoots;
  c.thi = tab + 3 * kTwiddleRoots;
  c.sig0 = blockIdx.x / tiles;
  c.row0 = static_cast<int>(blockIdx.x - c.sig0 * tiles) * tile;
  c.col0 = 0;
  c.nsig = 1;
  c.pitch = g.pitch;
  c.sig_stride = tile * g.pitch;
  c.rows = tile;
  c.valid_rows = min(tile, n1 - c.row0);
  c.cols = c.valid_cols = n2;
  c.n = n;
  c.n1 = n1;
  c.n2 = n2;
  c.scale = out_scale;
  c.inv = inv;
  c.out = y;
  load_fft_tables(tables, n1, n2, inv, tab);
  stage_rows<kPassLoads>(
      c_in + c.sig0 * n + static_cast<long long>(c.row0) * n2, c.valid_rows,
      n2, n2, g.d_width, n2, c.plane, g.pitch, false);
  __syncthreads();
  row_side(c, g.col, g.row);
}

// n / d on the card as a multiply-high and a shift (FastDiv).
FastDiv make_div(int d) {
  unsigned shr = 0;
  while ((1u << shr) < static_cast<unsigned>(d)) ++shr;
  const unsigned long long mul =
      ((1ull << 32) * ((1ull << shr) - static_cast<unsigned>(d))) / d + 1;
  return {static_cast<unsigned>(d), static_cast<unsigned>(mul), shr};
}

// A side of `len` points with the radices f[0..3) (0: no pass) over
// `lines` lines; false if the radices are not a register-pass split of len.
bool make_side(FftSide& s, int len, const int* f, int lines) {
  s = FftSide{};
  s.len = len;
  int pre = 1;
  for (int i = 0; i < kSidePasses; ++i) {
    s.f[i] = 1;
    s.pre[i] = pre;
    s.d_f[i] = make_div(1);
    if (f[i] > 0 && i == s.passes) {
      if (!fft_radix(f[i])) return false;
      s.f[i] = f[i];
      s.d_f[i] = make_div(f[i]);
      pre *= f[i];
      ++s.passes;
    }
  }
  if (s.passes == 0 || pre != len || lines < 1) return false;
  int span = len;
  for (int i = 0; i < kSidePasses; ++i) {
    FftPass& p = s.pass[i];
    p.f = s.f[i];
    p.span = span;
    p.step = span / p.f;
    p.groups = len / p.f;
    p.tw = len / span;
    p.last = i == s.passes - 1;
    p.d_lines = make_div(lines);
    p.d_groups = make_div(p.groups);
    p.d_step = make_div(p.step);
    span = p.step;
  }
  return true;
}

template <typename T>
size_t fft_smem_bytes(int rows, int pitch) {
  return (static_cast<size_t>(kFftRoots) + static_cast<size_t>(rows) * pitch) *
         sizeof(Cx<T>);
}

template <typename T, int THREADS>
int launch_fft_threads(const void* x, void* y, const void* tables,
                       long long batch, int tile_b, const FftGeom& g,
                       size_t smem, int inverse, cudaStream_t stream) {
  const cudaError_t err = opt_in<fft4step_fft_kernel<T, THREADS>>(smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (batch + tile_b - 1) / tile_b;
  const T out_scale = T(1) / static_cast<T>(g.col.len * g.row.len);
  fft4step_fft_kernel<T, THREADS><<<static_cast<unsigned>(blocks), THREADS,
                                    smem, stream>>>(
      static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(y),
      static_cast<const Cx<T>*>(tables), batch, tile_b, g, out_scale,
      inverse);
  return cudaGetLastError();
}

// threads: kFftThreads, or kFftWideThreads for a block whose plane leaves
// no room for a second on its SM (the host's fft_threads)
template <typename T>
int launch_fft(const void* x, void* y, const void* tables, long long batch,
               int n1, int n2, const int* f1, const int* f2, int tile_b,
               int pitch, int threads, int inverse, void* stream) {
  FftGeom g;
  if (n1 < 1 || n1 > kMaxN1 || n2 < 1 || n2 > kMaxN1 || batch < 1 ||
      tile_b < 1 || pitch < n2 || !make_side(g.col, n1, f1, n2) ||
      !make_side(g.row, n2, f2, n1) ||
      (threads != kFftThreads && threads != kFftWideThreads))
    return cudaErrorInvalidValue;
  const long long blocks = (batch + tile_b - 1) / tile_b;
  const size_t smem = fft_smem_bytes<T>(tile_b * n1, pitch);
  if (blocks > 0x7fffffffLL || smem > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  g.pitch = pitch;
  g.d_width = make_div(n2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return threads == kFftThreads
             ? launch_fft_threads<T, kFftThreads>(x, y, tables, batch, tile_b,
                                                  g, smem, inverse, s)
             : launch_fft_threads<T, kFftWideThreads>(
                   x, y, tables, batch, tile_b, g, smem, inverse, s);
}

template <typename T>
int launch_fft_passes(const void* x, void* tmp, void* y, const void* tables,
                      long long batch, int n1, int n2, const int* f1,
                      const int* f2, int tile_cols, int tile_rows,
                      int pitch_cols, int pitch_rows, int inverse,
                      void* stream) {
  FftGeom gc, gr;
  if (n1 < 1 || n1 > kMaxN1 || n2 < 1 || n2 > kMaxN1 || batch < 1 ||
      tile_cols < 1 || tile_rows < 1 || pitch_cols < tile_cols ||
      pitch_rows < n2 || !make_side(gc.col, n1, f1, tile_cols) ||
      !make_side(gc.row, n2, f2, tile_rows) ||
      !make_side(gr.col, n1, f1, tile_cols) ||
      !make_side(gr.row, n2, f2, tile_rows))
    return cudaErrorInvalidValue;
  const long long blocks_c = batch * ((n2 + tile_cols - 1) / tile_cols);
  const long long blocks_r = batch * ((n1 + tile_rows - 1) / tile_rows);
  const size_t smem_c = fft_smem_bytes<T>(n1, pitch_cols);
  const size_t smem_r = fft_smem_bytes<T>(tile_rows, pitch_rows);
  if (blocks_c > 0x7fffffffLL || blocks_r > 0x7fffffffLL ||
      smem_c > static_cast<size_t>(kMaxSmem) ||
      smem_r > static_cast<size_t>(kMaxSmem))
    return cudaErrorInvalidValue;
  gc.pitch = pitch_cols;
  gc.d_width = make_div(tile_cols);
  gr.pitch = pitch_rows;
  gr.d_width = make_div(n2);
  cudaError_t err = opt_in<fft4step_fft_columns_kernel<T>>(smem_c);
  if (err != cudaSuccess) return err;
  err = opt_in<fft4step_fft_rows_kernel<T>>(smem_r);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fft4step_fft_columns_kernel<T><<<static_cast<unsigned>(blocks_c),
                                   kFftThreads, smem_c, s>>>(
      static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(tmp),
      static_cast<const Cx<T>*>(tables), tile_cols, gc, inverse);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T out_scale = T(1) / static_cast<T>(n1 * n2);
  fft4step_fft_rows_kernel<T><<<static_cast<unsigned>(blocks_r), kFftThreads,
                                smem_r, s>>>(
      static_cast<const Cx<T>*>(tmp), static_cast<Cx<T>*>(y),
      static_cast<const Cx<T>*>(tables), tile_rows, gr, out_scale, inverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fft4step_f32(const void* x, void* y, const void* tables,
                            long long batch, int n1, int n2, int tile_b,
                            int mg, int np, int inverse, void* stream) {
  return launch<float>(x, y, tables, batch, n1, n2, tile_b, mg, np, inverse,
                       stream);
}

extern "C" int fft4step_f64(const void* x, void* y, const void* tables,
                            long long batch, int n1, int n2, int tile_b,
                            int mg, int np, int inverse, void* stream) {
  return launch<double>(x, y, tables, batch, n1, n2, tile_b, mg, np, inverse,
                        stream);
}

extern "C" int fft4step_passes_f32(const void* x, void* tmp, void* y,
                                   const void* tables, long long batch,
                                   int n1, int n2, int tile_cols,
                                   int tile_rows, int mg, int np, int inverse,
                                   void* stream) {
  return launch_passes<float>(x, tmp, y, tables, batch, n1, n2, tile_cols,
                              tile_rows, mg, np, inverse, stream);
}

extern "C" int fft4step_passes_f64(const void* x, void* tmp, void* y,
                                   const void* tables, long long batch,
                                   int n1, int n2, int tile_cols,
                                   int tile_rows, int mg, int np, int inverse,
                                   void* stream) {
  return launch_passes<double>(x, tmp, y, tables, batch, n1, n2, tile_cols,
                               tile_rows, mg, np, inverse, stream);
}

extern "C" int fft4step_fft_f32(const void* x, void* y, const void* tables,
                                long long batch, int n1, int n2, int c0,
                                int c1, int c2, int r0, int r1, int r2,
                                int tile_b, int pitch, int threads,
                                int inverse, void* stream) {
  const int f1[kSidePasses] = {c0, c1, c2}, f2[kSidePasses] = {r0, r1, r2};
  return launch_fft<float>(x, y, tables, batch, n1, n2, f1, f2, tile_b,
                           pitch, threads, inverse, stream);
}

extern "C" int fft4step_fft_f64(const void* x, void* y, const void* tables,
                                long long batch, int n1, int n2, int c0,
                                int c1, int c2, int r0, int r1, int r2,
                                int tile_b, int pitch, int threads,
                                int inverse, void* stream) {
  const int f1[kSidePasses] = {c0, c1, c2}, f2[kSidePasses] = {r0, r1, r2};
  return launch_fft<double>(x, y, tables, batch, n1, n2, f1, f2, tile_b,
                            pitch, threads, inverse, stream);
}

extern "C" int fft4step_fft_passes_f32(
    const void* x, void* tmp, void* y, const void* tables, long long batch,
    int n1, int n2, int c0, int c1, int c2, int r0, int r1, int r2,
    int tile_cols, int tile_rows, int pitch_cols, int pitch_rows,
    int inverse, void* stream) {
  const int f1[kSidePasses] = {c0, c1, c2}, f2[kSidePasses] = {r0, r1, r2};
  return launch_fft_passes<float>(x, tmp, y, tables, batch, n1, n2, f1, f2,
                                  tile_cols, tile_rows, pitch_cols,
                                  pitch_rows, inverse, stream);
}

extern "C" int fft4step_fft_passes_f64(
    const void* x, void* tmp, void* y, const void* tables, long long batch,
    int n1, int n2, int c0, int c1, int c2, int r0, int r1, int r2,
    int tile_cols, int tile_rows, int pitch_cols, int pitch_rows,
    int inverse, void* stream) {
  const int f1[kSidePasses] = {c0, c1, c2}, f2[kSidePasses] = {r0, r1, r2};
  return launch_fft_passes<double>(x, tmp, y, tables, batch, n1, n2, f1, f2,
                                   tile_cols, tile_rows, pitch_cols,
                                   pitch_rows, inverse, stream);
}
