// Fused mixed-radix Stockham FFT for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/stockham_pallas/stockham_pallas.py : stockham_pallas
//   (body _stockham_kernel -> apply_stages -> _butterfly).
// It computes the same batched DIF Stockham FFT along the last axis of a
// (B, n) complex array for any 7-smooth n, with the same stage schedule
// (radix-7/5/3 stages first, then radix-8/4 stages with a 4/2 cleanup) and
// the same host-float64 stage twiddles W_cur^{p u}.  With the buffer
// holding x[q + s*(p + m*t)] for a stage of size cur = r*m at stride s
// (cur*s == n), one radix-r stage computes
//
//     y[q + s*(u + r*p)] = ( sum_t x[q + s*(p + m*t)] * W_r^{t u} ) * W_cur^{p u}
//
// then recurses with (cur, s) <- (m, r*s).
//
// Bound: device-memory bytes.  An FFT does ~5 n log2(n) flops per row on
// 2*n*sizeof(complex) bytes of traffic, far below the card's
// flop-per-byte ridge, so the least time is one read and one write of the
// B*n complex values.  The design does exactly that: one CTA owns a tile of
// tile_b rows; the first stage reads the tile straight from global memory,
// every intermediate stage ping-pongs between two shared-memory buffers,
// and the last stage writes straight to global memory (with the inverse's
// 1/n folded into that store).  log(n) stages cost one global round trip.
//
// The butterflies and the stage routine (run_stage) are in
// stockham_stages.cuh, shared with the fused rank-2 kernel (fft2.cu).
//
// Layout: interleaved complex (torch.view_as_real of a contiguous
// complex64/complex128 tensor), so no real/imag plane split is needed.
// Twiddles: one interleaved complex vector; the twiddle of (stage, u, p)
// sits at base[stage] + (u-1)*m + p.  Row offsets are 64-bit.
//
// Plain C interface (stockham_fft_f32 / stockham_fft_f64), loaded with
// ctypes; each returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <atomic>

#include "stockham_stages.cuh"

namespace {

constexpr int kMaxStages = 32;
constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;        // Hopper: 227 KB per block
constexpr int kDefaultSmem = 48 * 1024; // above this, opt in per kernel
constexpr int kMaxDevices = 64;

struct Schedule {
  int n_stages;
  int radix[kMaxStages];
  int base[kMaxStages];
};

template <typename T, bool INV>
__global__ void __launch_bounds__(kThreads)
stockham_kernel(const Cx<T>* __restrict__ x, Cx<T>* __restrict__ y,
                const Cx<T>* __restrict__ tw, long long batch, int n,
                int tile_b, Schedule sch, T inv_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Cx<T>* buf0 = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* buf1 = buf0 + static_cast<long long>(tile_b) * n;
  const long long row0 = static_cast<long long>(blockIdx.x) * tile_b;
  const int rows = static_cast<int>(min(static_cast<long long>(tile_b), batch - row0));
  const Cx<T>* src = x + row0 * n;
  int cur = n;
  for (int st = 0; st < sch.n_stages; ++st) {
    const int r = sch.radix[st];
    const int m = cur / r;
    const int s = n / cur;
    const bool last = st == sch.n_stages - 1;
    Cx<T>* dst = last ? y + row0 * n : ((st & 1) ? buf1 : buf0);
    switch (r) {
      case 2: run_stage<2, INV>(src, dst, tw, n, rows, m, s, sch.base[st], last, inv_n); break;
      case 3: run_stage<3, INV>(src, dst, tw, n, rows, m, s, sch.base[st], last, inv_n); break;
      case 4: run_stage<4, INV>(src, dst, tw, n, rows, m, s, sch.base[st], last, inv_n); break;
      case 5: run_stage<5, INV>(src, dst, tw, n, rows, m, s, sch.base[st], last, inv_n); break;
      case 7: run_stage<7, INV>(src, dst, tw, n, rows, m, s, sch.base[st], last, inv_n); break;
      default: run_stage<8, INV>(src, dst, tw, n, rows, m, s, sch.base[st], last, inv_n); break;
    }
    // the next stage reads what this one wrote, and writes the buffer
    // this one read
    __syncthreads();
    src = dst;
    cur = m;
  }
}

template <typename T, bool INV>
int launch_dir(const void* x, void* y, const void* tw, long long batch, int n,
               int tile_b, const Schedule& sch, size_t smem, cudaStream_t stream) {
  auto kern = stockham_kernel<T, INV>;
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
      static_cast<const Cx<T>*>(tw), batch, n, tile_b, sch,
      T(1) / static_cast<T>(n));
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, const void* tw, long long batch, int n,
           int tile_b, int inverse, int n_stages, const int* radices,
           const int* bases, void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || n < 2 || tile_b < 1 || batch < 1)
    return cudaErrorInvalidValue;
  if ((batch + tile_b - 1) / tile_b > 0x7fffffffLL) return cudaErrorInvalidValue;
  Schedule sch{};
  sch.n_stages = n_stages;
  int prod = 1;
  for (int i = 0; i < n_stages; ++i) {
    const int r = radices[i];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8)
      return cudaErrorInvalidValue;
    sch.radix[i] = r;
    sch.base[i] = bases[i];
    prod *= r;
  }
  if (prod != n) return cudaErrorInvalidValue;
  const size_t smem =
      n_stages > 1 ? 2 * static_cast<size_t>(tile_b) * n * sizeof(Cx<T>) : 0;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return inverse ? launch_dir<T, true>(x, y, tw, batch, n, tile_b, sch, smem, s)
                 : launch_dir<T, false>(x, y, tw, batch, n, tile_b, sch, smem, s);
}

}  // namespace

extern "C" int stockham_fft_f32(const void* x, void* y, const void* tw,
                                long long batch, int n, int tile_b,
                                int inverse, int n_stages, const int* radices,
                                const int* bases, void* stream) {
  return launch<float>(x, y, tw, batch, n, tile_b, inverse, n_stages, radices,
                       bases, stream);
}

extern "C" int stockham_fft_f64(const void* x, void* y, const void* tw,
                                long long batch, int n, int tile_b,
                                int inverse, int n_stages, const int* radices,
                                const int* bases, void* stream) {
  return launch<double>(x, y, tw, batch, n, tile_b, inverse, n_stages, radices,
                        bases, stream);
}
