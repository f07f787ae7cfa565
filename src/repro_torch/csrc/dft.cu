// Batched direct DFT for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/dft_matmul/dft_matmul.py : dft_matmul
//   (body _dft_kernel: the (B, n) real/imaginary planes times the n x n
//   DFT matrix as four real products, accumulated in the plane dtype).
// For each row x of length n <= 128 it computes
//
//     y[k] = sum_j x[j] W[j, k]          W[j, k] = exp(-+ 2 pi i j k / n)
//
// with W the reference's table (host float64, cast once to the plane
// type); the inverse uses the conjugate table and folds 1/n into the
// store.
//
// Bound: operations.  The product takes 8 n real flops per point (1024 at
// n = 128) on 16 or 32 bytes of traffic per point, far above the card's
// flop-per-byte ridge without tensor cores; TF32 would break the suite's
// 1e-5 roundtrip bar, so the sums run as fp32 FMA for complex64 and fp64
// FMA for complex128 on the CUDA cores.  The design reads and writes
// device memory once and keeps the loads per FMA low:
//   * one CTA owns a tile of tile_b rows; it copies them into shared
//     memory with coalesced interleaved-complex loads;
//   * each thread owns a 4 x 4 register tile of outputs (4 rows, 4
//     columns) and, per step j of the sum, loads 4 values of X (shared
//     memory, the same words across a warp: broadcasts) and 4 of W's row
//     j (consecutive threads on consecutive columns: coalesced) for 16
//     complex FMAs.  Rows and columns are strided (k = k0 + c*ceil(n/4)),
//     so a warp's stores land on consecutive addresses;
//   * W (128 KB at n = 128 in complex64, 256 KB in complex128, more than a
//     block's 227 KB) is read from global memory, where it stays resident
//     in L1/L2 for every block;
//   * the ragged last tile is masked, not padded: its missing rows are
//     neither loaded nor stored.
//
// Layout: interleaved complex (torch.view_as_real of contiguous tensors).
// Plain C interface (dft_f32 / dft_f64), loaded with ctypes; each returns
// the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <atomic>

#include "stockham_stages.cuh"  // Cx, cfma

namespace {

constexpr int kThreads = 256;
constexpr int kRT = 4;                  // register tile edge
constexpr int kMaxN = 128;
constexpr int kMaxSmem = 232448;        // Hopper: 227 KB per block
constexpr int kDefaultSmem = 48 * 1024; // above this, opt in per kernel
constexpr int kMaxDevices = 64;

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
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    // the opt-in is a per-device attribute of this instantiation: set it on
    // the first large launch on each device only
    static std::atomic<bool> opted_in[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || !opted_in[dev].load(std::memory_order_acquire)) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) opted_in[dev].store(true, std::memory_order_release);
    }
  }
  const long long blocks = (rows + tile_b - 1) / tile_b;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(y),
      static_cast<const Cx<T>*>(w), rows, n, tile_b,
      T(1) / static_cast<T>(n));
  return cudaGetLastError();
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
