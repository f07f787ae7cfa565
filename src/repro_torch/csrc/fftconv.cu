// Fused causal depthwise convolution (fftconv) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fftconv/fftconv.py : fftconv_kernel
//   (body _fftconv_kernel: a real square four-step forward transform, the
//   pointwise product by the filter spectrum, the inverse four-step, and
//   its real part; 14 k x k x k real products per signal).
// Each signal is a real tile of n = k*k points (k = 2^m <= 128) viewed as
// the row-major k x k matrix X[j1, j2] = x[j1*k + j2].  With W, Wi the
// forward and inverse k x k DFT matrices and T, Ti the twiddles (all
// symmetric, the reference's tables: host float64, cast once to float32)
// and H the channel's spectrum reshaped (k, k) with 1/n folded in, one
// block computes, per signal and in place in shared memory,
//
//   A  C[r, c]  = T[r, c] * sum_j W[r, j] X[j, c]       column DFTs, real X
//   B  E[r, c]  = H[c, r] * sum_j C[r, j] W[j, c]       row DFTs, spectrum
//   C  C[r, c]  = Ti[r, c] * sum_j E[r, j] Wi[j, c]     inverse row DFTs
//   D  y[r*k+c] = Re sum_j Wi[r, j] C[j, c]             inverse column DFTs
//
// which is the reference's arithmetic in another layout: its forward
// output is the natural-order spectrum reshaped (k, k), so E is the
// transpose of its spectral product, pass C is its inverse column DFT (on
// E's rows) and pass D its last row DFT, read along the other axis so the
// output lands in natural time order.  Pass D computes only the real part
// (2 real products where the reference takes 4 and drops the imaginary
// half): 12 k^3 FMAs per signal in all.
//
// Bound: device-memory bytes.  The convolution reads the L-point signal
// and writes the L-point result once (8 L bytes per signal, plus the
// channel's K taps) and needs ~2 * 2.5 n log2(n) flops (two real FFTs),
// below the card's flop-per-byte ridge.  This algorithm's own 24 k^3
// flops per signal (1.5 k flops per byte, 96 at k = 64) are above the
// fp32 ridge of ~20 on the CUDA cores, so its arithmetic, not the bytes,
// is what limits it.  TF32 would break the 1e-5 bar, so the sums run as fp32 FMA.  The
// design keeps the signal on chip from the load to the store:
//   * one CTA owns a tile of tile_b signals of one channel (the last
//     tile of a channel may hold fewer); it reads each signal's L points
//     into shared memory (the first buffer) and zero-fills them to n;
//   * pass A writes the complex plane C (second buffer, rows padded to
//     k + 1 points so that a warp's two rows of A operands at k = 64 land
//     on different banks);
//   * passes B and C go half the rows at a time: B writes the rows' E
//     into the first buffer (the real tile is dead by then), C writes them
//     back over the same rows of C.  So a block needs one complex plane
//     and half of one, and k = 128 (128 KB per plane) fits with one signal
//     per block: 193.5 KB of the 227 KB;
//   * pass D stores y[r*k + c] for r*k + c < L, with consecutive threads
//     on consecutive c;
//   * every pass is a register-tiled product: a thread owns RT x RT
//     outputs (RT = 4 from k = 32, else 2) and, per step j of the sum,
//     loads RT values of each operand for RT*RT multiply-adds; its rows
//     and columns are strided (c = c0 + t*ceil(k/RT)), so the threads of
//     a warp read one operand as a broadcast and the other at consecutive
//     addresses;
//   * W, Wi, T, Ti (32 KB each at k = 64) and the channel's spectrum are
//     read from global memory, where they stay resident in L1/L2.
//
// Layout: x, y (channels, batch, L) float32, L <= n; the spectrum
// (channels, n) and the tables (W, Wi, T, Ti; 4 x n) interleaved
// complex64; the wrapper pads nothing and cuts nothing.  Plain C
// interface (fftconv_f32), loaded with ctypes; it returns the cudaError_t
// of the launch.

#include <cuda_runtime.h>

#include <atomic>

#include "stockham_stages.cuh"  // Cx, mul, cfma

namespace {

using C32 = Cx<float>;

constexpr int kThreads = 256;
constexpr int kMaxK = 128;
constexpr int kMaxSmem = 232448;        // Hopper: 227 KB per block
constexpr int kDefaultSmem = 48 * 1024; // above this, opt in per kernel
constexpr int kMaxDevices = 64;

// acc + w * x for real x (pass A)
__device__ __forceinline__ C32 mac(C32 w, float x, C32 acc) {
  acc.re = acc.re + w.re * x;
  acc.im = acc.im + w.im * x;
  return acc;
}
// acc + a * b (passes B and C)
__device__ __forceinline__ C32 mac(C32 a, C32 b, C32 acc) {
  return cfma(a, b, acc);
}
// acc + Re(a * b) (pass D)
__device__ __forceinline__ float mac(C32 a, C32 b, float acc) {
  acc = acc + a.re * b.re;
  return acc - a.im * b.im;
}

// out(s, i, c) = sum_j A(s, i, j) B(s, j, c) for i < rows, c < k, j < k
// and each of the tile's sigs signals, with A(s, i, j) = a[s*a_sig +
// i*a_row + j] and B(s, j, c) = b[s*b_sig + j*b_row + c]; store(s, i, c,
// value) writes one output.  Threads take RT x RT outputs each, columns
// fastest.
template <int RT, typename Acc, typename TA, typename TB, typename Store>
__device__ __forceinline__ void product(int sigs, int rows, int k,
                                        const TA* a, int a_sig, int a_row,
                                        const TB* b, int b_sig, int b_row,
                                        Store store) {
  const int ni = (rows + RT - 1) / RT;
  const int nj = (k + RT - 1) / RT;
  for (int g = threadIdx.x; g < sigs * ni * nj; g += blockDim.x) {
    const int c0 = g % nj;
    const int rest = g / nj;
    const int i0 = rest % ni;
    const int s = rest / ni;
    const TA* ar[RT];
    const TB* bc[RT];
#pragma unroll
    for (int t = 0; t < RT; ++t)
      ar[t] = a + s * a_sig + min(i0 + t * ni, rows - 1) * a_row;
#pragma unroll
    for (int t = 0; t < RT; ++t) bc[t] = b + s * b_sig + min(c0 + t * nj, k - 1);
    Acc acc[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < RT; ++c) acc[i][c] = Acc{};
    for (int j = 0; j < k; ++j) {
      TA u[RT];
      TB v[RT];
#pragma unroll
      for (int t = 0; t < RT; ++t) u[t] = ar[t][j];
#pragma unroll
      for (int t = 0; t < RT; ++t) v[t] = bc[t][j * b_row];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < RT; ++c) acc[i][c] = mac(u[i], v[c], acc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = i0 + i * ni;
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        const int col = c0 + c * nj;
        if (r < rows && col < k) store(s, r, col, acc[i][c]);
      }
    }
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
fftconv_kernel(const float* __restrict__ x, float* __restrict__ y,
               const C32* __restrict__ hf, const C32* __restrict__ tables,
               int batch, int length, int k, int tile_b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = k * k;
  const int pitch = k + 1;
  const int half = (k + 1) / 2;
  const int x_sig = max(n, 2 * half * pitch);  // floats per signal, buffer 1
  const int e_sig = x_sig / 2;                 // the same, in complex points
  const int c_sig = k * pitch;                 // complex points per signal
  float* xs = reinterpret_cast<float*>(smem_raw);
  C32* es = reinterpret_cast<C32*>(smem_raw);  // buffer 1 as passes B/C's E
  C32* cs = reinterpret_cast<C32*>(xs + tile_b * x_sig);

  const int tiles = (batch + tile_b - 1) / tile_b;
  const int ch = blockIdx.x / tiles;
  const int b0 = (blockIdx.x % tiles) * tile_b;
  const int sigs = min(tile_b, batch - b0);  // the last tile may be ragged
  const long long sig0 = static_cast<long long>(ch) * batch + b0;
  const C32* w = tables;
  const C32* wi = tables + n;
  const C32* tf = tables + 2 * n;
  const C32* ti = tables + 3 * n;
  const C32* h = hf + static_cast<long long>(ch) * n;

  // the signal's L points, zero-filled to n on chip
  const float* xg = x + sig0 * length;
  for (int i = threadIdx.x; i < sigs * n; i += blockDim.x) {
    const int s = i / n;
    const int p = i % n;
    xs[s * x_sig + p] = p < length ? xg[static_cast<long long>(s) * length + p]
                                   : 0.f;
  }
  __syncthreads();

  // A: column DFTs of the real signal, then the twiddle
  product<RT, C32>(sigs, k, k, w, 0, k, xs, x_sig, k,
                   [&](int s, int r, int c, C32 v) {
                     cs[s * c_sig + r * pitch + c] = mul(v, tf[r * k + c]);
                   });
  __syncthreads();
  for (int h0 = 0; h0 < k; h0 += half) {
    const int rows = min(half, k - h0);
    // B: row DFTs of rows h0.., times the spectrum (transposed), into E
    product<RT, C32>(sigs, rows, k, cs + h0 * pitch, c_sig, pitch, w, 0, k,
                     [&](int s, int r, int c, C32 v) {
                       es[s * e_sig + r * pitch + c] = mul(v, h[c * k + h0 + r]);
                     });
    __syncthreads();
    // C: inverse row DFTs of E, then the inverse twiddle, back into C
    product<RT, C32>(sigs, rows, k, es, e_sig, pitch, wi, 0, k,
                     [&](int s, int r, int c, C32 v) {
                       cs[s * c_sig + (h0 + r) * pitch + c] =
                           mul(v, ti[(h0 + r) * k + c]);
                     });
    __syncthreads();
  }
  // D: inverse column DFTs, real part only, the first L points straight to
  // global memory
  float* yg = y + sig0 * length;
  product<RT, float>(sigs, k, k, wi, 0, k, cs, c_sig, pitch,
                     [&](int s, int r, int c, float v) {
                       if (r * k + c < length)
                         yg[static_cast<long long>(s) * length + r * k + c] = v;
                     });
}

size_t smem_bytes(int k, int tile_b) {
  const int half = (k + 1) / 2;
  const size_t x_sig =
      static_cast<size_t>(k * k > 2 * half * (k + 1) ? k * k : 2 * half * (k + 1));
  return static_cast<size_t>(tile_b) *
         (x_sig * sizeof(float) + static_cast<size_t>(k) * (k + 1) * sizeof(C32));
}

template <int RT>
int launch_rt(const void* x, void* y, const void* hf, const void* tables,
              int channels, int batch, int length, int k, int tile_b,
              size_t smem, cudaStream_t stream) {
  auto kern = fftconv_kernel<RT>;
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
  const long long blocks =
      static_cast<long long>(channels) * ((batch + tile_b - 1) / tile_b);
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const C32*>(hf), static_cast<const C32*>(tables), batch,
      length, k, tile_b);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fftconv_f32(const void* x, void* y, const void* hf,
                           const void* tables, int channels, int batch,
                           int length, int k, int tile_b, int rt,
                           void* stream) {
  if (k < 1 || k > kMaxK || (k & (k - 1)) || tile_b < 1 || channels < 1 ||
      batch < 1 || length < 1 || length > k * k || (rt != 2 && rt != 4))
    return cudaErrorInvalidValue;
  if (static_cast<long long>(channels) * ((batch + tile_b - 1) / tile_b) >
      0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(k, tile_b);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rt == 2
      ? launch_rt<2>(x, y, hf, tables, channels, batch, length, k, tile_b,
                     smem, s)
      : launch_rt<4>(x, y, hf, tables, channels, batch, length, k, tile_b,
                     smem, s);
}
