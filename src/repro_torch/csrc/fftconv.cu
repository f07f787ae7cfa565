// Fused causal depthwise convolution (fftconv) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fftconv/fftconv.py : fftconv_kernel
//   (body _fftconv_kernel: a real square four-step forward transform, the
//   pointwise product by the filter spectrum, the inverse four-step, and
//   its real part).
// It computes the same function, the circular convolution of each real
// signal with its channel's filter at length n (n = 4^m <= 16384, the
// reference's length rule; with n >= L + K - 1 this is the causal linear
// convolution), but not by the TPU's dense k x k DFT products: on this card
// those cost 24 k^3 flops per signal, ~29x the two real FFTs at n = 16384.
// Per signal, in shared memory from the load to the store:
//
//   1. load the L real points (16-byte loads where the row allows) and
//      zero-fill to n; read as N = n/2 complex points they are the packed
//      signal z[j] = x[2j] + i x[2j+1] (the same words);
//   2. Z = FFT_N(z): radix-8/4/2 Stockham stages ping-ponging between two
//      buffers, with the host's float64 stage twiddles: run_stage's
//      arithmetic (its butterflies, stockham_stages.cuh) for power-of-two
//      sizes, in a layout padded against bank conflicts;
//   3. one pass over the pairs (k, N-k), k <= N/2, in place:
//        E = (Z[k] + conj Z[N-k]) / 2,  O = (Z[k] - conj Z[N-k]) / 2i,
//        X[k] = E + w^k O,  X[N-k] = conj(E - w^k O)      (w = e^{-2 pi i/n})
//      the real signal's spectrum; Y = X H with H the channel's half
//      spectrum rfft(h, n)/n; and the re-pack of Y's inverse,
//        A = Y[k] + conj Y[N-k],  B = (Y[k] - conj Y[N-k]) conj(w^k),
//        Z'[k] = A + iB,  Z'[N-k] = conj A + i conj B,
//      stored conjugated;
//   4. the same forward stages on conj Z', so the buffer holds
//      conj(IFFT_N(Z')) (no inverse twiddle table, no 1/N: H holds 1/n);
//   5. store y[2j] = Re, y[2j+1] = -Im of it for the first L points.
//
// Bound: device-memory bytes.  The convolution reads the L-point signal and
// writes the L-point result once (8 L bytes per signal, plus the channel's
// K taps and the spectrum, which stay in L2) and needs ~2 * 2.5 n log2(n)
// flops per signal, about 4 flops per byte, far below the card's ridge.
// So the signal never leaves the chip between the load and the store.  A
// block owns tile_b signals of one channel (the last tile of a channel may
// hold fewer) and needs two buffers of N complex64 per signal, padded
// (below): 8.5 n bytes, 136 KB at n = 16384.  Its threads follow n (256 at
// n = 4096, 1024 at 16384: one radix-8 butterfly of one signal each).
// The stage twiddles (one packed table, ~N points), the N/2 + 1 roots w^k
// and the spectra are read from global memory, where they stay resident
// in L1/L2 across the blocks of a channel.
//
// Layout: x, y (channels, batch, L) float32, L <= n; the spectrum
// (channels, N + 1), the twiddles and the roots interleaved complex64.
// Plain C interface (fftconv_f32), loaded with ctypes; it returns the
// cudaError_t of the launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "stockham_stages.cuh"  // Cx, mul, Butterfly

namespace {

using C32 = Cx<float>;

// threads of a block: one radix-8 butterfly of one signal each at the
// main path's lengths (n/16), at least 128
__host__ __device__ constexpr int block_threads(int n) {
  return n >= 16384 ? 1024 : n >= 4096 ? 256 : 128;
}

constexpr int kMaxN = 16384;
constexpr int kMaxStages = 16;

struct Schedule {
  int n_stages;
  int radix[kMaxStages];
  int base[kMaxStages];
};

__device__ __forceinline__ C32 cconj(C32 a) { return {a.re, -a.im}; }

// A signal's buffers hold complex point i at i + i/16: one pad point per
// 16 spreads the strided stores of the first stages (stride 8 and 64
// points) over all banks, so every stage's loads and stores take the
// fewest wavefronts a warp's 256 bytes allow.
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// One radix-R Stockham stage over `rows` rows of N = 2^log_n points, as
// run_stage (stockham_stages.cuh) computes it with cols = 1, for the
// padded layout (row pitch `pitch`) and power-of-two sizes (shifts, not
// divisions): y[q + s (R p + u)] = (sum_t x[q + s p + N/R t] W_R^{t u})
// W_cur^{p u}, with m = 2^log_m and s = 2^log_s.
template <int R>
__device__ __forceinline__ void stage(const C32* __restrict__ src,
                                      C32* __restrict__ dst,
                                      const C32* __restrict__ tw, int log_n,
                                      int rows, int log_m, int log_s,
                                      int base, int pitch) {
  constexpr int kLogR = R == 8 ? 3 : R == 4 ? 2 : 1;
  const int log_nr = log_n - kLogR;  // N/R = m s
  const int nr = 1 << log_nr;
  const int m = 1 << log_m;
  const int s = 1 << log_s;
  for (int g = threadIdx.x; g < rows << log_nr; g += blockDim.x) {
    const int row = g >> log_nr;
    const int j = g & (nr - 1);
    const int p = j >> log_s;
    const int q = j & (s - 1);
    const C32* in = src + row * pitch;
    C32 a[R];
#pragma unroll
    for (int t = 0; t < R; ++t) a[t] = in[pad(j + t * nr)];
    Butterfly<R, false, float>::run(a);
    if (m > 1) {
#pragma unroll
      for (int u = 1; u < R; ++u) a[u] = mul(a[u], tw[base + (u - 1) * m + p]);
    }
    C32* out = dst + row * pitch;
    const int o = q + s * R * p;
#pragma unroll
    for (int u = 0; u < R; ++u) out[pad(o + s * u)] = a[u];
  }
}

// The forward Stockham FFT of `rows` rows of N = 2^log_n points, starting
// in *src; on return *src holds the result and *dst the other buffer.
__device__ __forceinline__ void forward_stages(C32** src, C32** dst,
                                               const C32* __restrict__ tw,
                                               int log_n, int rows, int pitch,
                                               const Schedule& sch) {
  int log_cur = log_n;
  for (int st = 0; st < sch.n_stages; ++st) {
    const int r = sch.radix[st];
    const int log_m = log_cur - (r == 8 ? 3 : r == 4 ? 2 : 1);
    const int log_s = log_n - log_cur;
    switch (r) {
      case 2: stage<2>(*src, *dst, tw, log_n, rows, log_m, log_s, sch.base[st], pitch); break;
      case 4: stage<4>(*src, *dst, tw, log_n, rows, log_m, log_s, sch.base[st], pitch); break;
      default: stage<8>(*src, *dst, tw, log_n, rows, log_m, log_s, sch.base[st], pitch); break;
    }
    __syncthreads();
    C32* t = *src;
    *src = *dst;
    *dst = t;
    log_cur = log_m;
  }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
fftconv_kernel(const float* __restrict__ x, float* __restrict__ y,
               const C32* __restrict__ hf, const C32* __restrict__ tw,
               const C32* __restrict__ roots, int batch, int length, int n,
               int tile_b, bool vec, Schedule sch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = n / 2;
  const int tiles = (batch + tile_b - 1) / tile_b;
  const int ch = blockIdx.x / tiles;
  const int b0 = (blockIdx.x % tiles) * tile_b;
  const int sigs = min(tile_b, batch - b0);  // the last tile may be ragged
  const long long sig0 = static_cast<long long>(ch) * batch + b0;
  const float* xg = x + sig0 * length;
  float* yg = y + sig0 * length;
  const C32* h = hf + static_cast<long long>(ch) * (N + 1);

  if (n == 1) {  // L = K = 1: one product per signal
    for (int s = threadIdx.x; s < sigs; s += blockDim.x) yg[s] = xg[s] * h[0].re;
    return;
  }
  const int log_n = __ffs(N) - 1;
  const int pitch = N + (N >> 4);  // padded points per signal
  C32* src = reinterpret_cast<C32*>(smem_raw);
  C32* dst = src + tile_b * pitch;

  // 1. the L real points, zero-filled to n: the packed z
  if (vec) {  // L % 4 == 0 and x 16-byte aligned: every row is too
    for (int i = threadIdx.x; i < sigs * (N / 2); i += blockDim.x) {
      const int s = i >> (log_n - 1);
      const int c = 2 * (i & (N / 2 - 1));  // points c, c + 1: one pad block
      const int p = 2 * c;
      const float4 v = p < length
          ? *reinterpret_cast<const float4*>(xg + static_cast<long long>(s) * length + p)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      C32* z = src + s * pitch + pad(c);
      z[0] = {v.x, v.y};
      z[1] = {v.z, v.w};
    }
  } else {
    for (int i = threadIdx.x; i < sigs * n; i += blockDim.x) {
      const int s = i / n;
      const int p = i - s * n;
      reinterpret_cast<float*>(src + s * pitch + pad(p >> 1))[p & 1] =
          p < length ? xg[static_cast<long long>(s) * length + p] : 0.f;
    }
  }
  __syncthreads();

  // 2. Z = FFT_N(z)
  forward_stages(&src, &dst, tw, log_n, sigs, pitch, sch);

  // 3. the spectral pass over the pairs (k, N - k), in place
  const int half = N / 2;
  for (int i = threadIdx.x; i < sigs * (half + 1); i += blockDim.x) {
    const int s = i / (half + 1);
    const int k = i - s * (half + 1);
    const int m = (N - k) & (N - 1);  // k = 0 pairs with itself (Z[N] = Z[0])
    C32* z = src + s * pitch;
    const C32 zk = z[pad(k)], zm = z[pad(m)];
    const C32 w = roots[k];
    const C32 e = {0.5f * (zk.re + zm.re), 0.5f * (zk.im - zm.im)};
    const C32 o = {0.5f * (zk.im + zm.im), -0.5f * (zk.re - zm.re)};
    const C32 wo = mul(w, o);
    const C32 xk = add(e, wo);
    const C32 xm = cconj(sub(e, wo));
    const C32 yk = mul(xk, h[k]);
    const C32 ym = mul(xm, h[N - k]);
    const C32 a = add(yk, cconj(ym));
    const C32 b = mul(sub(yk, cconj(ym)), cconj(w));
    z[pad(k)] = {a.re - b.im, -(a.im + b.re)};  // conj(A + iB)
    if (m != k) z[pad(m)] = {a.re + b.im, a.im - b.re};  // conj(conj A + i conj B)
  }
  __syncthreads();

  // 4. conj(IFFT_N(Z')) = FFT_N(conj Z')
  forward_stages(&src, &dst, tw, log_n, sigs, pitch, sch);

  // 5. y[2j] = Re, y[2j + 1] = -Im, the first L points
  if (vec) {
    const int q = length / 4;
    for (int i = threadIdx.x; i < sigs * q; i += blockDim.x) {
      const int s = i / q;
      const int p = 4 * (i - s * q);
      const C32* z = src + s * pitch + pad(p >> 1);
      *reinterpret_cast<float4*>(yg + static_cast<long long>(s) * length + p) =
          make_float4(z[0].re, -z[0].im, z[1].re, -z[1].im);
    }
  } else {
    for (int i = threadIdx.x; i < sigs * length; i += blockDim.x) {
      const int s = i / length;
      const int p = i - s * length;
      const float v = reinterpret_cast<const float*>(src + s * pitch + pad(p >> 1))[p & 1];
      yg[static_cast<long long>(s) * length + p] = (p & 1) ? -v : v;
    }
  }
}

// two buffers of n/2 complex64 per signal, one pad point per 16
size_t smem_bytes(int n, int tile_b) {
  const int N = n / 2;
  return n > 1 ? 2 * static_cast<size_t>(tile_b) * (N + (N >> 4)) * sizeof(C32)
               : 0;
}

template <int kThreads>
int launch(const float* x, float* y, const C32* hf, const C32* tw,
           const C32* roots, int channels, int batch, int length, int n,
           int tile_b, bool vec, const Schedule& sch, size_t smem,
           cudaStream_t stream) {
  auto kern = fftconv_kernel<kThreads>;
  const cudaError_t err = opt_in<fftconv_kernel<kThreads>>(smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(channels) * ((batch + tile_b - 1) / tile_b);
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, y, hf, tw, roots, batch, length, n, tile_b, vec, sch);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fftconv_f32(const void* x, void* y, const void* hf,
                           const void* tw, const void* roots, int channels,
                           int batch, int length, int n, int tile_b,
                           int n_stages, const int* radices, const int* bases,
                           void* stream) {
  if (n < 1 || n > kMaxN || (n & (n - 1)) || tile_b < 1 || channels < 1 ||
      batch < 1 || length < 1 || length > n || n_stages < 0 ||
      n_stages > kMaxStages)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(channels) * ((batch + tile_b - 1) / tile_b) >
      0x7fffffffLL)
    return cudaErrorInvalidValue;
  Schedule sch{};
  sch.n_stages = n_stages;
  int prod = 1;
  for (int i = 0; i < n_stages; ++i) {
    const int r = radices[i];
    if (r != 2 && r != 4 && r != 8) return cudaErrorInvalidValue;
    sch.radix[i] = r;
    sch.base[i] = bases[i];
    prod *= r;
  }
  if (n > 1 && prod != n / 2) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n, tile_b);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const bool vec = length % 4 == 0 && n % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(y) % 16 == 0;
  const auto xf = static_cast<const float*>(x);
  const auto yf = static_cast<float*>(y);
  const auto h = static_cast<const C32*>(hf);
  const auto t = static_cast<const C32*>(tw);
  const auto r = static_cast<const C32*>(roots);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_threads(n)) {
    case 128:
      return launch<128>(xf, yf, h, t, r, channels, batch, length, n, tile_b,
                         vec, sch, smem, s);
    case 256:
      return launch<256>(xf, yf, h, t, r, channels, batch, length, n, tile_b,
                         vec, sch, smem, s);
    default:
      return launch<1024>(xf, yf, h, t, r, channels, batch, length, n,
                          tile_b, vec, sch, smem, s);
  }
}
