// Fused four-step FFT for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fft4step/fft4step.py : fft4step
//   (body _fft4step_kernel: D = (W1 @ A * T) @ W2, out = D^T).
// For a signal of length n = n1*n2 (n1, n2 <= 128) viewed as the
// row-major n1 x n2 matrix X[j1, j2] = x[j1*n2 + j2] it computes
//
//     C[k1, j2] = T[k1, j2] * sum_j1 W1[k1, j1] X[j1, j2]   (column DFTs)
//     y[k2*n1 + k1] = sum_j2 C[k1, j2] W2[j2, k2]            (row DFTs)
//
// so y is the natural-order DFT of x.  W1, W2 and T are the reference's
// tables (host float64, cast once to the plane type); the inverse uses the
// conjugate tables and folds 1/n into the store.
//
// Bound: device-memory bytes.  The function, a length-n DFT, needs
// ~5 n log2(n) flops on 2 * n * sizeof(complex) bytes of traffic, below
// the card's flop-per-byte ridge.  This algorithm does more: the two
// complex matrix products take 8 (n1 + n2) real flops per point (at n =
// 64 x 64, 17x the FFT's 60), 128 flops per byte in complex64, above the
// float32 (non tensor core) ridge of ~20, so its own arithmetic, not the
// bytes, is what limits it on the CUDA cores.  The design keeps the signal
// on chip between the two products and reads and writes device memory
// once:
//   * one CTA owns a tile of tile_b signals; it copies them into shared
//     memory (X) with coalesced loads;
//   * each pass is a small complex matrix product in register tiles: a
//     thread owns RT x RT outputs and, per step of the sum, loads RT
//     values of each operand for RT*RT complex FMAs (RT = 4, or 2 below
//     n = 256, where 4x4 tiles would leave most threads of a block idle;
//     the wrapper picks it and fills the block with signals).  A thread's
//     rows and columns are strided (k = k0 + i*ceil(n/RT)), so
//     consecutive threads touch consecutive shared-memory words;
//   * the column DFTs read X[j1, j2] (threads along j2) and write C,
//     twiddle applied, to a second shared buffer whose rows are padded to
//     n2 + 1, so the row pass reads C along k1 without bank conflicts;
//   * the row DFTs (threads along k1) store y[k2*n1 + k1]: consecutive
//     threads write consecutive addresses.
// W1/W2/T are read from global memory (a few hundred KB at most, held in
// L1/L2); the threads of a warp share their rows of W1/W2, so most of
// those loads are broadcasts.  Arithmetic is fp32 FMA for complex64 and fp64 for
// complex128, no TF32.  The two buffers cap a signal at 14464 points
// (complex64) and 7216 (complex128) in 227 KB per block.
//
// Layout: interleaved complex (torch.view_as_real of contiguous tensors).
// Plain C interface (fft4step_f32 / fft4step_f64), loaded with ctypes;
// each returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <atomic>

#include "stockham_stages.cuh"  // Cx, mul, cfma

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN1 = 128;
constexpr int kMaxSmem = 232448;        // Hopper: 227 KB per block
constexpr int kDefaultSmem = 48 * 1024; // above this, opt in per kernel
constexpr int kMaxDevices = 64;

// RT x RT outputs per thread and pass (the register tile)
template <typename T, bool INV, int RT>
__global__ void __launch_bounds__(kThreads)
fft4step_kernel(const Cx<T>* __restrict__ x, Cx<T>* __restrict__ y,
                const Cx<T>* __restrict__ w1, const Cx<T>* __restrict__ w2,
                const Cx<T>* __restrict__ t, long long batch, int n1, int n2,
                int tile_b, T inv_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = n1 * n2;
  const int pitch = n2 + 1;
  Cx<T>* xs = reinterpret_cast<Cx<T>*>(smem_raw);        // tile_b * n
  Cx<T>* cs = xs + static_cast<long long>(tile_b) * n;   // tile_b * n1 * pitch
  const long long sig0 = static_cast<long long>(blockIdx.x) * tile_b;
  const int sigs = static_cast<int>(min(static_cast<long long>(tile_b), batch - sig0));

  const Cx<T>* xg = x + sig0 * n;
  for (int i = threadIdx.x; i < sigs * n; i += blockDim.x) xs[i] = xg[i];
  __syncthreads();

  // column DFTs and twiddle: C[k1, j2] for k1 = ki + i*ni, j2 = jj + j*nj
  const int ni = (n1 + RT - 1) / RT;
  const int nj = (n2 + RT - 1) / RT;
  for (int g = threadIdx.x; g < sigs * ni * nj; g += blockDim.x) {
    const int jj = g % nj;
    const int rest = g / nj;
    const int ki = rest % ni;
    const int sig = rest / ni;
    const Cx<T>* wr[RT];
    const Cx<T>* xc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) wr[i] = w1 + min(ki + i * ni, n1 - 1) * n1;
#pragma unroll
    for (int j = 0; j < RT; ++j) xc[j] = xs + sig * n + min(jj + j * nj, n2 - 1);
    Cx<T> acc[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) acc[i][j] = {T(0), T(0)};
    for (int j1 = 0; j1 < n1; ++j1) {
      Cx<T> w[RT], v[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) w[i] = wr[i][j1];
#pragma unroll
      for (int j = 0; j < RT; ++j) v[j] = xc[j][j1 * n2];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] = cfma(w[i], v[j], acc[i][j]);
    }
    Cx<T>* cc = cs + sig * n1 * pitch;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int k1 = ki + i * ni;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int j2 = jj + j * nj;
        if (k1 < n1 && j2 < n2)
          cc[k1 * pitch + j2] = mul(acc[i][j], t[k1 * n2 + j2]);
      }
    }
  }
  __syncthreads();

  // row DFTs, stored transposed: y[k2*n1 + k1] for k1 = ki + i*ni,
  // k2 = kj + j*nj
  for (int g = threadIdx.x; g < sigs * ni * nj; g += blockDim.x) {
    const int ki = g % ni;
    const int rest = g / ni;
    const int kj = rest % nj;
    const int sig = rest / nj;
    const Cx<T>* cr[RT];
    int kk[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
      cr[i] = cs + (sig * n1 + min(ki + i * ni, n1 - 1)) * pitch;
#pragma unroll
    for (int j = 0; j < RT; ++j) kk[j] = min(kj + j * nj, n2 - 1);
    Cx<T> acc[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) acc[i][j] = {T(0), T(0)};
    for (int j2 = 0; j2 < n2; ++j2) {
      const Cx<T>* wrow = w2 + j2 * n2;
      Cx<T> c[RT], w[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) c[i] = cr[i][j2];
#pragma unroll
      for (int j = 0; j < RT; ++j) w[j] = wrow[kk[j]];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) acc[i][j] = cfma(c[i], w[j], acc[i][j]);
    }
    Cx<T>* yo = y + (sig0 + sig) * n;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int k1 = ki + i * ni;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int k2 = kj + j * nj;
        if (k1 < n1 && k2 < n2) {
          yo[static_cast<long long>(k2) * n1 + k1] =
              INV ? Cx<T>{acc[i][j].re * inv_n, acc[i][j].im * inv_n}
                  : acc[i][j];
        }
      }
    }
  }
}

template <typename T, bool INV, int RT>
int launch_dir(const void* x, void* y, const void* w1, const void* w2,
               const void* t, long long batch, int n1, int n2, int tile_b,
               size_t smem, cudaStream_t stream) {
  auto kern = fft4step_kernel<T, INV, RT>;
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
  const long long blocks = (batch + tile_b - 1) / tile_b;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(y),
      static_cast<const Cx<T>*>(w1), static_cast<const Cx<T>*>(w2),
      static_cast<const Cx<T>*>(t), batch, n1, n2, tile_b,
      T(1) / static_cast<T>(n1 * n2));
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, const void* w1, const void* w2,
           const void* t, long long batch, int n1, int n2, int tile_b,
           int rt, int inverse, void* stream) {
  if (n1 < 1 || n1 > kMaxN1 || n2 < 1 || n2 > kMaxN1 || tile_b < 1 ||
      batch < 1 || (rt != 2 && rt != 4))
    return cudaErrorInvalidValue;
  if ((batch + tile_b - 1) / tile_b > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(tile_b) *
                      (static_cast<size_t>(n1) * n2 +
                       static_cast<size_t>(n1) * (n2 + 1)) * sizeof(Cx<T>);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rt == 2)
    return inverse
        ? launch_dir<T, true, 2>(x, y, w1, w2, t, batch, n1, n2, tile_b, smem, s)
        : launch_dir<T, false, 2>(x, y, w1, w2, t, batch, n1, n2, tile_b, smem, s);
  return inverse
      ? launch_dir<T, true, 4>(x, y, w1, w2, t, batch, n1, n2, tile_b, smem, s)
      : launch_dir<T, false, 4>(x, y, w1, w2, t, batch, n1, n2, tile_b, smem, s);
}

}  // namespace

extern "C" int fft4step_f32(const void* x, void* y, const void* w1,
                            const void* w2, const void* t, long long batch,
                            int n1, int n2, int tile_b, int rt, int inverse,
                            void* stream) {
  return launch<float>(x, y, w1, w2, t, batch, n1, n2, tile_b, rt, inverse,
                       stream);
}

extern "C" int fft4step_f64(const void* x, void* y, const void* w1,
                            const void* w2, const void* t, long long batch,
                            int n1, int n2, int tile_b, int rt, int inverse,
                            void* stream) {
  return launch<double>(x, y, w1, w2, t, batch, n1, n2, tile_b, rt, inverse,
                        stream);
}
