// Fused four-step FFT for Hopper (sm_90a), its products on the tensor
// cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fft4step/fft4step.py : fft4step
//   (body _fft4step_kernel: D = (W1 @ A * T) @ W2, out = D^T).
// For a signal of length n = n1*n2 (n1, n2 <= 128) viewed as the
// row-major n1 x n2 matrix X[j1, j2] = x[j1*n2 + j2] it computes
//
//     C[k1, j2] = T[k1, j2] * sum_j1 W1[k1, j1] X[j1, j2]   (column pass)
//     y[k2*n1 + k1] = sum_j2 W2[k2, j2] C[k1, j2]            (row pass)
//
// so y is the natural-order DFT of x; the inverse runs the conjugate
// tables and folds 1/n into the store.
//
// Bound: device-memory bytes for the function (a length-n DFT: ~5 n
// log2(n) flops on 2 * n * sizeof(complex) bytes).  This algorithm does
// 8 (n1 + n2) real flops per point, 128 per byte at n = 64 x 64 in
// complex64: on the CUDA cores (the first design) its own arithmetic, not
// the bytes, limited it.  This design runs both products on the tensor
// cores through the panel product of tc_product.cuh: 3xTF32
// (mma.sync.m16n8k8, three TF32 products per fp32 product, so 3 * 8 (n1 +
// n2) flops per point at the 495 TFLOP/s TF32 peak) for complex64, and
// mma.sync.m8n8k4 f64 (the 67 TFLOP/s fp64 tensor-core peak) for
// complex128.  Shared memory holds one plane per signal, in place:
//   * one CTA owns a tile of tile_b signals; it copies them into its
//     plane (rows padded to a pitch of 4 mod 16 points, so a warp's
//     fragment loads of either pass hit each bank at most the minimum
//     number of times) and the roots of W1, W2 (split for 3xTF32) and of T
//     into shared tables;
//   * column pass: a warp owns a panel of 16 columns (NP = 2 tensor-core
//     n-tiles, which share each looked-up fragment of W1; 8 columns when a
//     side is at most 8) and a group of up to MG m-tiles of the output
//     rows, sums the whole depth j1 in registers, then writes C over its
//     panel with the twiddle applied,
//     T = w_n^{k1 j2} from two 128-entry root tables (w_n^{128 (e >> 7)}
//     * w_n^{e & 127}).  A panel whose rows need more than one group is
//     read by all of them before any writes: the block barriers between a
//     round's sums and its stores;
//   * row pass: a warp owns 16 (or 8) rows of C (the product's columns, C^T)
//     and a group of m-tiles of k2, and stores y[k2*n1 + k1] straight to
//     global memory: a quad of lanes writes 8 consecutive points, in
//     complex64 as four 16-byte stores (64 bytes, two whole sectors).
// W1 and W2 never exist whole: the panel product indexes their root
// tables at (m k) mod n1 or n2.  One plane holds every split in complex64
// (n = 16384 at most) and, in complex128, the splits whose padded plane
// fits 227 KB (up to 13920); the other complex128 splits, up to the
// reference's 128 x 128, run as two launches (below).
//
// Layout: interleaved complex (torch.view_as_real of contiguous tensors);
// the table vector holds the roots of W1 (n1), of W2 (n2), and T's two
// root tables (128 each).  Plain C interface (fft4step_f32 /
// fft4step_f64, and fft4step_passes_f32 / fft4step_passes_f64 for the
// two launches), loaded with ctypes; each returns the cudaError_t of the
// launch.

#include <cuda_runtime.h>

#include <type_traits>

#include "stockham_stages.cuh"  // Cx, mul, scale
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
