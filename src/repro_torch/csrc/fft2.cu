// Fused rank-2 FFT for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fft2_pallas/fft2_pallas.py : fft2_pallas
//   (body _fft2_kernel: row stages, transpose, column stages, transpose).
// It computes the 2-D DFT over the last two axes of a (B, n1, n2) complex
// array for power-of-two n1 and n2, with the reference's stage schedules
// (radix-8/4 work stages with a 4/2 cleanup, per axis) and its packed
// host-float64 twiddles: the n2 (row) pack first, then the n1 (column)
// pack at offsets shifted past it.
//
// Bound: device-memory bytes.  A 2-D FFT of n1*n2 points does
// ~5 n log2(n) flops on 2 * n * sizeof(complex) bytes of traffic, far
// below the card's flop-per-byte ridge.  The separable path pays a
// transpose copy in and out for the outer axis on top of its two
// transforms; this kernel reads the signal once and writes it once.  One
// CTA owns a tile of tile_b whole signals, held in two shared-memory
// ping-pong buffers:
//   * the row stages are run_stage (stockham_stages.cuh) over tile_b*n1
//     rows of length n2; the first reads straight from global memory;
//   * the column stages are run_stage over tile_b signals of n2
//     interleaved columns (cols = n2: the elements of one column n2
//     apart), so no transpose is needed: consecutive threads take
//     consecutive columns, and every shared-memory access of a warp is to
//     consecutive words;
//   * the last stage writes straight to global memory in natural order,
//     with the inverse's 1/(n1*n2) folded into that store.
// Two buffers of n1*n2 points cap one block's signal at 8192 points in
// complex64 and 4096 in complex128 (227 KB per block); a larger tile, up
// to the reference's 2^18 points, runs as passes through global memory on
// stockham.cu's entries (the rows' FFTs, then the column pass), launched
// by this kernel's wrapper (kernels/fft2_pallas/ops.py).
//
// Layout: interleaved complex (torch.view_as_real of a contiguous
// complex64/complex128 tensor).  Twiddles: one interleaved complex vector;
// the twiddle of (stage, u, p) sits at base[stage] + (u-1)*m + p.
//
// Plain C interface (fft2_f32 / fft2_f64), loaded with ctypes; each
// returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "stockham_stages.cuh"

namespace {

constexpr int kMaxStages = 32;
constexpr int kThreads = 512;

// Row (n2) stages first, then column (n1) stages.
struct Schedule2 {
  int n_stages;
  int n_row;
  int radix[kMaxStages];
  int base[kMaxStages];
};

template <typename T, bool INV>
__global__ void __launch_bounds__(kThreads)
fft2_kernel(const Cx<T>* __restrict__ x, Cx<T>* __restrict__ y,
            const Cx<T>* __restrict__ tw, long long batch, int n1, int n2,
            int tile_b, Schedule2 sch, T inv_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long n = static_cast<long long>(n1) * n2;
  Cx<T>* buf0 = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* buf1 = buf0 + static_cast<long long>(tile_b) * n;
  const long long sig0 = static_cast<long long>(blockIdx.x) * tile_b;
  const int sigs = static_cast<int>(min(static_cast<long long>(tile_b), batch - sig0));
  const Cx<T>* src = x + sig0 * n;
  int cur = n2;
  for (int st = 0; st < sch.n_stages; ++st) {
    const bool row = st < sch.n_row;
    if (st == sch.n_row) cur = n1;
    const int r = sch.radix[st];
    const int m = cur / r;
    const int s = (row ? n2 : n1) / cur;
    const bool last = st == sch.n_stages - 1;
    Cx<T>* dst = last ? y + sig0 * n : ((st & 1) ? buf1 : buf0);
    const int b = sch.base[st];
    if (row) {
      const int rows = sigs * n1;
      switch (r) {
        case 2: run_stage<2, INV>(src, dst, tw, n2, rows, m, s, b, last, inv_n); break;
        case 4: run_stage<4, INV>(src, dst, tw, n2, rows, m, s, b, last, inv_n); break;
        default: run_stage<8, INV>(src, dst, tw, n2, rows, m, s, b, last, inv_n); break;
      }
    } else {
      switch (r) {
        case 2: run_stage<2, INV>(src, dst, tw, n1, sigs, m, s, b, last, inv_n, n2); break;
        case 4: run_stage<4, INV>(src, dst, tw, n1, sigs, m, s, b, last, inv_n, n2); break;
        default: run_stage<8, INV>(src, dst, tw, n1, sigs, m, s, b, last, inv_n, n2); break;
      }
    }
    // the next stage reads what this one wrote, and writes the buffer
    // this one read
    __syncthreads();
    src = dst;
    cur = m;
  }
}

template <typename T, bool INV>
int launch_dir(const void* x, void* y, const void* tw, long long batch, int n1,
               int n2, int tile_b, const Schedule2& sch, size_t smem,
               cudaStream_t stream) {
  auto kern = fft2_kernel<T, INV>;
  const cudaError_t err = opt_in<fft2_kernel<T, INV>>(smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (batch + tile_b - 1) / tile_b;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(y),
      static_cast<const Cx<T>*>(tw), batch, n1, n2, tile_b, sch,
      T(1) / static_cast<T>(static_cast<long long>(n1) * n2));
  return cudaGetLastError();
}

bool pow2(int v) { return v >= 1 && (v & (v - 1)) == 0; }

template <typename T>
int launch(const void* x, void* y, const void* tw, long long batch, int n1,
           int n2, int tile_b, int inverse, int n_stages, int n_row,
           const int* radices, const int* bases, void* stream) {
  if (!pow2(n1) || !pow2(n2) || tile_b < 1 || batch < 1 || n_stages < 1 ||
      n_stages > kMaxStages || n_row < 0 || n_row > n_stages)
    return cudaErrorInvalidValue;
  if ((batch + tile_b - 1) / tile_b > 0x7fffffffLL) return cudaErrorInvalidValue;
  Schedule2 sch{};
  sch.n_stages = n_stages;
  sch.n_row = n_row;
  int prod_row = 1, prod_col = 1;
  for (int i = 0; i < n_stages; ++i) {
    const int r = radices[i];
    if (r != 2 && r != 4 && r != 8) return cudaErrorInvalidValue;
    sch.radix[i] = r;
    sch.base[i] = bases[i];
    (i < n_row ? prod_row : prod_col) *= r;
  }
  if (prod_row != n2 || prod_col != n1) return cudaErrorInvalidValue;
  const size_t smem = n_stages > 1
      ? 2 * static_cast<size_t>(tile_b) * n1 * n2 * sizeof(Cx<T>) : 0;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return inverse
      ? launch_dir<T, true>(x, y, tw, batch, n1, n2, tile_b, sch, smem, s)
      : launch_dir<T, false>(x, y, tw, batch, n1, n2, tile_b, sch, smem, s);
}

}  // namespace

extern "C" int fft2_f32(const void* x, void* y, const void* tw,
                        long long batch, int n1, int n2, int tile_b,
                        int inverse, int n_stages, int n_row,
                        const int* radices, const int* bases, void* stream) {
  return launch<float>(x, y, tw, batch, n1, n2, tile_b, inverse, n_stages,
                       n_row, radices, bases, stream);
}

extern "C" int fft2_f64(const void* x, void* y, const void* tw,
                        long long batch, int n1, int n2, int tile_b,
                        int inverse, int n_stages, int n_row,
                        const int* radices, const int* bases, void* stream) {
  return launch<double>(x, y, tw, batch, n1, n2, tile_b, inverse, n_stages,
                        n_row, radices, bases, stream);
}
