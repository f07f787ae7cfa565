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
// Layout: interleaved complex (torch.view_as_real of a contiguous
// complex64/complex128 tensor), so no real/imag plane split is needed.
// Twiddles: one interleaved complex vector; the twiddle of (stage, u, p)
// sits at base[stage] + (u-1)*m + p.  Row offsets are 64-bit.
//
// Plain C interface (stockham_fft_f32 / stockham_fft_f64), loaded with
// ctypes; each returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <atomic>

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

template <typename T>
struct alignas(2 * sizeof(T)) Cx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ Cx<T> add(Cx<T> a, Cx<T> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename T>
__device__ __forceinline__ Cx<T> sub(Cx<T> a, Cx<T> b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename T>
__device__ __forceinline__ Cx<T> mul(Cx<T> a, Cx<T> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
template <typename T>
__device__ __forceinline__ Cx<T> scale(Cx<T> a, T s) {
  return {a.re * s, a.im * s};
}
// a * W_4^1: -i for the forward transform, +i for the inverse (a swap).
template <bool INV, typename T>
__device__ __forceinline__ Cx<T> rot(Cx<T> a) {
  return INV ? Cx<T>{-a.im, a.re} : Cx<T>{a.im, -a.re};
}
// a * W_8^1 = a * (1 -+ i)/sqrt(2).
template <bool INV, typename T>
__device__ __forceinline__ Cx<T> rot8(Cx<T> a) {
  const T h = T(0.70710678118654752440);
  return INV ? Cx<T>{h * (a.re - a.im), h * (a.re + a.im)}
             : Cx<T>{h * (a.re + a.im), h * (a.im - a.re)};
}

// cos(2*pi*j/r) and sin(2*pi*j/r) for the odd radices, 0 < j < r.
__host__ __device__ constexpr double kcos(int r, int j) {
  return j > r / 2 ? kcos(r, r - j)
       : r == 3 ? -0.5
       : r == 5 ? (j == 1 ? 0.3090169943749474241023 : -0.8090169943749474241023)
       : (j == 1 ? 0.6234898018587335305251
          : j == 2 ? -0.2225209339563144042889 : -0.9009688679024191262361);
}
__host__ __device__ constexpr double ksin(int r, int j) {
  return j > r / 2 ? -ksin(r, r - j)
       : r == 3 ? 0.8660254037844386467637
       : r == 5 ? (j == 1 ? 0.9510565162951535721164 : 0.5877852522924731291687)
       : (j == 1 ? 0.7818314824680298087084
          : j == 2 ? 0.9749279121818236070181 : 0.4338837391175581204758);
}

template <int R, bool INV, typename T>
struct Butterfly;

template <bool INV, typename T>
struct Butterfly<2, INV, T> {
  __device__ __forceinline__ static void run(Cx<T>* a) {
    const Cx<T> t = a[0];
    a[0] = add(t, a[1]);
    a[1] = sub(t, a[1]);
  }
};

template <bool INV, typename T>
struct Butterfly<4, INV, T> {
  __device__ __forceinline__ static void run(Cx<T>* a) {
    const Cx<T> t0 = add(a[0], a[2]), t1 = sub(a[0], a[2]);
    const Cx<T> t2 = add(a[1], a[3]), t3 = rot<INV>(sub(a[1], a[3]));
    a[0] = add(t0, t2);
    a[1] = add(t1, t3);
    a[2] = sub(t0, t2);
    a[3] = sub(t1, t3);
  }
};

// Radix 8 as two radix-4 halves (even and odd inputs) joined by W_8^u:
// multiplies only on the (1 -+ i)/sqrt(2) terms.
template <bool INV, typename T>
struct Butterfly<8, INV, T> {
  __device__ __forceinline__ static void run(Cx<T>* a) {
    Cx<T> e[4] = {a[0], a[2], a[4], a[6]};
    Cx<T> o[4] = {a[1], a[3], a[5], a[7]};
    Butterfly<4, INV, T>::run(e);
    Butterfly<4, INV, T>::run(o);
    o[1] = rot8<INV>(o[1]);
    o[2] = rot<INV>(o[2]);
    o[3] = rot<INV>(rot8<INV>(o[3]));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = add(e[u], o[u]);
      a[u + 4] = sub(e[u], o[u]);
    }
  }
};

// Odd radix (3, 5, 7): pair inputs t and r-t, so each output pair
// (u, r-u) shares one set of multiplies: y_u = A + iB, y_{r-u} = A - iB.
template <int R, bool INV, typename T>
struct OddButterfly {
  __device__ __forceinline__ static void run(Cx<T>* a) {
    constexpr int H = (R - 1) / 2;
    constexpr double sign = INV ? 1.0 : -1.0;
    Cx<T> p[H], m[H];
    Cx<T> y0 = a[0];
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      p[k - 1] = add(a[k], a[R - k]);
      m[k - 1] = sub(a[k], a[R - k]);
      y0 = add(y0, p[k - 1]);
    }
    Cx<T> y[R];
    y[0] = y0;
#pragma unroll
    for (int u = 1; u <= H; ++u) {
      Cx<T> A = a[0], B = {T(0), T(0)};
#pragma unroll
      for (int k = 1; k <= H; ++k) {
        const int j = (k * u) % R;
        A = add(A, scale(p[k - 1], T(kcos(R, j))));
        B = add(B, scale(m[k - 1], T(sign * ksin(R, j))));
      }
      y[u] = {A.re - B.im, A.im + B.re};
      y[R - u] = {A.re + B.im, A.im - B.re};
    }
#pragma unroll
    for (int u = 0; u < R; ++u) a[u] = y[u];
  }
};

template <bool INV, typename T>
struct Butterfly<3, INV, T> : OddButterfly<3, INV, T> {};
template <bool INV, typename T>
struct Butterfly<5, INV, T> : OddButterfly<5, INV, T> {};
template <bool INV, typename T>
struct Butterfly<7, INV, T> : OddButterfly<7, INV, T> {};

// One radix-R stage over `rows` rows of length n: src and dst point at the
// tile's first row (global memory or a shared-memory buffer).  Threads
// stride over the rows * n/R butterflies; consecutive threads take
// consecutive j = p*s + q, so the R loads of a butterfly are contiguous
// across the warp.
template <int R, bool INV, typename T>
__device__ __forceinline__ void run_stage(const Cx<T>* __restrict__ src,
                                          Cx<T>* __restrict__ dst,
                                          const Cx<T>* __restrict__ tw,
                                          int n, int rows, int m, int s,
                                          int base, bool last, T inv_n) {
  const int nr = n / R;  // == m * s
  const int total = rows * nr;
  for (int g = threadIdx.x; g < total; g += blockDim.x) {
    const int row = g / nr;
    const int j = g - row * nr;
    const int p = j / s;
    const int q = j - p * s;
    const Cx<T>* in = src + static_cast<long long>(row) * n + j;
    Cx<T> a[R];
#pragma unroll
    for (int t = 0; t < R; ++t) a[t] = in[t * nr];
    Butterfly<R, INV, T>::run(a);
    if (m > 1) {
#pragma unroll
      for (int u = 1; u < R; ++u) a[u] = mul(a[u], tw[base + (u - 1) * m + p]);
    }
    if (INV && last) {
#pragma unroll
      for (int u = 0; u < R; ++u) a[u] = scale(a[u], inv_n);
    }
    Cx<T>* out = dst + static_cast<long long>(row) * n + q +
                 static_cast<long long>(s) * R * p;
#pragma unroll
    for (int u = 0; u < R; ++u) out[static_cast<long long>(s) * u] = a[u];
  }
}

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
