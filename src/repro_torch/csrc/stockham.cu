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
// B*n complex values.  One CTA owns a tile of tile_b rows and runs the
// schedule as register passes over ONE shared buffer (block_fft in
// stockham_stages.cuh): the host groups the stages into passes of one or
// two stages that one kernel's case family holds (a radix-8 pair is a
// 64-point pass, the kBig family's), the first pass reads the tile
// straight from global memory, each pass runs its stages in registers
// and, after a barrier, writes back into the same buffer, and the last
// pass writes straight to global memory (the inverse's 1/n folded into
// that store).  So P3's 4096 = 8^4 is two passes, one barrier and one
// trip through shared memory.  Half the shared memory of two ping-pong
// buffers lets more rows share an SM; no index in the loop divides
// (FastDiv), and a layout padded on the host keeps a warp's shared-memory
// stores on distinct banks.  A family is a few cases compiled into one
// switch: ptxas gives a kernel one register budget for all its cases, and
// larger families spilled, so this library holds four small kernels
// (block.py picks one a launch).
//
// The same kernels run the real-input folds (the plan's mode), numpy's
// rfft / irfft along the last axis of a (B, n) real array / (B, n/2 + 1)
// bins, in place of the separate torch passes that pack and unpack a real
// signal around the kernel (fft/rfft.py: a strided gather, flip, roll,
// conj, the 0.5 and roots arithmetic and a cat, each a pass over memory):
//   * even n = 2h: the real row read as h complex points (no copy), the
//     h-point FFT, and the post-pass X[k] = E + W_n^k O, X[h] = E - O (E,
//     O from Z[k] and Z[-k]) in the last pass's registers, each butterfly
//     paired with its mirror; the inverse builds z = E + i O from the bins
//     in the first pass's registers the same way and stores the real
//     output viewed as complex, times 1/h;
//   * odd n: the real row read with zero imaginary parts and bins 0..n/2
//     stored (forward); the Hermitian half rebuilt on load, conj Y[n - k]
//     for k > n/2, and the real parts stored times 1/n (inverse).
// A fold moves one read of the input and one write of the output: n reals
// and n/2 + 1 bins a row, about half a complex transform's bytes.
//
// The host caps one block at the rows that two buffers would hold (14406
// points in complex64, 7203 in complex128: 227 KB per block), falling back
// to two buffers only where a tile's butterflies outnumber the threads
// that must hold them across a barrier.  Longer rows, up to the
// reference's 2^20, run as two passes through global memory over a
// second entry, the column pass: with n = n1*n2 and x[j1*n2 + j2],
//   pass 1: the n2 strided columns' n1-point FFTs, each output k1 times
//           W_n^(j2*k1), stored transposed (tmp[j2*n1 + k1]);
//   pass 2: the n1 columns of tmp, n2-point FFTs, stored in natural
//           order y[k2*n1 + k1], the inverse's 1/n folded in.
// A block of the column pass owns a tile of `cols` adjacent columns of one
// signal, so every load is a run of `cols` consecutive points (and pass
// 1's transposed store a run of n1); the stages run on the tile in shared
// memory with run_stage's interleaved-columns form.  The same entry runs
// the fused rank-2 kernel's passes over its one-block cap (fft2.cu's
// wrapper).  Each pass moves the signal once, so two passes cost two
// round trips; the pass twiddle W_n^e comes from two float64-built root
// tables, W_n^(1024 a) * W_n^b for e = 1024 a + b.
//
// Layout: interleaved complex (torch.view_as_real of a contiguous
// complex64/complex128 tensor), so no real/imag plane split is needed.
// Twiddles: one interleaved complex vector; the twiddle of (stage, u, p)
// sits at base[stage] + (u-1)*m + p.  Row offsets are 64-bit.
//
// Plain C interface (stockham_block_f32: the host's BlockPlan, see
// stockham_pallas/block.py; its complex128 twin stockham_block_f64 is
// stockham64.cu, a library of its own so that the two compile in
// parallel; stockham_columns_f32 / stockham_columns_f64), loaded with
// ctypes; each returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "stockham_stages.cuh"

namespace {

constexpr int kMaxStages = 32;
constexpr int kThreads = 256;

struct Schedule {
  int n_stages;
  int radix[kMaxStages];
  int base[kMaxStages];
};

// One column pass (see the header): signal `sig`'s column `col` holds
// element j at x[sig*in_sig + j*in_k + col]; its output k, times
// W_tw_n^(k * (col / tw_q)) when tw_n > 0 and times `scale`, goes to
// y[(sig / group)*out_big + (sig % group)*out_small + k*out_k + col*out_col].
struct Columns {
  long long in_sig, in_k, group, out_big, out_small, out_k, out_col;
  int length, width, cols, tiles, tw_n, tw_q;
};

constexpr int kRootShift = 10;  // W_n^e = hi[e >> 10] * lo[e & 1023]
constexpr int kLoadBatch = 8;   // a column-pass thread's loads in flight
constexpr int kRootLo = 1 << kRootShift;

template <typename T, bool INV>
__global__ void __launch_bounds__(kThreads)
stockham_columns_kernel(const Cx<T>* __restrict__ x, Cx<T>* __restrict__ y,
                        const Cx<T>* __restrict__ tw,
                        const Cx<T>* __restrict__ roots, Columns p,
                        Schedule sch, T out_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = p.length, C = p.cols;
  Cx<T>* src = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* dst = src + static_cast<long long>(L) * C;
  const long long sig = blockIdx.x / p.tiles;
  const int col0 = static_cast<int>(blockIdx.x - sig * p.tiles) * C;
  const int cw = min(C, p.width - col0);  // columns this block holds
  // element j of column col0 + c into src[j*C + c]: runs of C points,
  // kLoadBatch loads in flight a thread before their stores
  const Cx<T>* xs = x + sig * p.in_sig + col0;
  for (int i0 = threadIdx.x; i0 < L * C; i0 += kLoadBatch * blockDim.x) {
    Cx<T> v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const int j = i / C, c = i - j * C;
      v[u] = i < L * C && c < cw ? xs[j * p.in_k + c] : Cx<T>{T(0), T(0)};
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < L * C) src[i] = v[u];
    }
  }
  __syncthreads();
  int cur = L;
  for (int st = 0; st < sch.n_stages; ++st) {
    const int r = sch.radix[st];
    const int m = cur / r;
    const int s = L / cur;
    const int b = sch.base[st];
    switch (r) {
      case 2: run_stage<2, INV>(src, dst, tw, L, 1, m, s, b, false, T(1), C); break;
      case 3: run_stage<3, INV>(src, dst, tw, L, 1, m, s, b, false, T(1), C); break;
      case 4: run_stage<4, INV>(src, dst, tw, L, 1, m, s, b, false, T(1), C); break;
      case 5: run_stage<5, INV>(src, dst, tw, L, 1, m, s, b, false, T(1), C); break;
      case 7: run_stage<7, INV>(src, dst, tw, L, 1, m, s, b, false, T(1), C); break;
      default: run_stage<8, INV>(src, dst, tw, L, 1, m, s, b, false, T(1), C); break;
    }
    __syncthreads();
    Cx<T>* t = src;
    src = dst;
    dst = t;
    cur = m;
  }
  // output k of column col0 + c is at src[k*C + c]; the store walks the
  // output's unit stride (k when out_k is 1, else c)
  Cx<T>* ys = y + (sig / p.group) * p.out_big + (sig % p.group) * p.out_small +
              col0 * p.out_col;
  const bool k_fast = p.out_k == 1;
  for (int i = threadIdx.x; i < L * C; i += blockDim.x) {
    int k, c;
    if (k_fast) {
      c = i / L;
      k = i - c * L;
    } else {
      k = i / C;
      c = i - k * C;
    }
    if (c >= cw) continue;
    Cx<T> v = src[k * C + c];
    if (p.tw_n > 0) {
      const int e = k * ((col0 + c) / p.tw_q);  // < tw_n
      v = mul(v, mul(roots[kRootLo + (e >> kRootShift)], roots[e & (kRootLo - 1)]));
    }
    ys[k * p.out_k + c * p.out_col] = scale(v, out_scale);
  }
}

// The stage schedule from the caller's radices and twiddle bases; false if
// a radix is not one of the butterflies or the product is not n.
bool make_schedule(int n, int n_stages, const int* radices, const int* bases,
                   Schedule& sch) {
  if (n_stages < 1 || n_stages > kMaxStages) return false;
  sch.n_stages = n_stages;
  int prod = 1;
  for (int i = 0; i < n_stages; ++i) {
    const int r = radices[i];
    if (r != 2 && r != 3 && r != 4 && r != 5 && r != 7 && r != 8) return false;
    sch.radix[i] = r;
    sch.base[i] = bases[i];
    prod *= r;
  }
  return prod == n;
}

template <typename T, bool INV>
int launch_columns_dir(const void* x, void* y, const void* tw, const void* roots,
                       long long nsig, const Columns& p, const Schedule& sch,
                       size_t smem, T out_scale, cudaStream_t stream) {
  auto kern = stockham_columns_kernel<T, INV>;
  const cudaError_t err = opt_in<stockham_columns_kernel<T, INV>>(smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(nsig * p.tiles), kThreads, smem, stream>>>(
      static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(y),
      static_cast<const Cx<T>*>(tw), static_cast<const Cx<T>*>(roots), p, sch,
      out_scale);
  return cudaGetLastError();
}

// prm: nsig, length, width, cols, in_sig, in_k, group, out_big, out_small,
// out_k, out_col, tw_n, tw_q (see Columns).
template <typename T>
int launch_columns(const void* x, void* y, const void* tw, const void* roots,
                   const long long* prm, int inverse, int n_stages,
                   const int* radices, const int* bases, double out_scale,
                   void* stream) {
  const long long nsig = prm[0];
  Columns p{};
  p.length = static_cast<int>(prm[1]);
  p.width = static_cast<int>(prm[2]);
  p.cols = static_cast<int>(prm[3]);
  p.in_sig = prm[4];
  p.in_k = prm[5];
  p.group = prm[6];
  p.out_big = prm[7];
  p.out_small = prm[8];
  p.out_k = prm[9];
  p.out_col = prm[10];
  p.tw_n = static_cast<int>(prm[11]);
  p.tw_q = static_cast<int>(prm[12]);
  if (nsig < 1 || p.length < 2 || p.width < 1 || p.cols < 1 || p.group < 1 ||
      p.tw_n < 0 || p.tw_q < 1 || (p.tw_n > 0 && roots == nullptr))
    return cudaErrorInvalidValue;
  p.tiles = (p.width + p.cols - 1) / p.cols;
  if (nsig * p.tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  Schedule sch{};
  if (!make_schedule(p.length, n_stages, radices, bases, sch))
    return cudaErrorInvalidValue;
  const size_t smem = 2 * static_cast<size_t>(p.length) * p.cols * sizeof(Cx<T>);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T sc = static_cast<T>(out_scale);
  return inverse
      ? launch_columns_dir<T, true>(x, y, tw, roots, nsig, p, sch, smem, sc, s)
      : launch_columns_dir<T, false>(x, y, tw, roots, nsig, p, sch, smem, sc, s);
}

}  // namespace

extern "C" int stockham_block_f32(const void* x, void* y, const void* tw,
                                  const void* roots, const void* plan,
                                  long long batch, int inverse, int family,
                                  double scale, int threads, long long smem,
                                  void* stream) {
  return launch_block<float, false>(x, y, tw, roots, plan, batch, inverse,
                                    family, scale, threads, smem, stream);
}

extern "C" int stockham_columns_f32(const void* x, void* y, const void* tw,
                                    const void* roots, const long long* prm,
                                    int inverse, int n_stages,
                                    const int* radices, const int* bases,
                                    double out_scale, void* stream) {
  return launch_columns<float>(x, y, tw, roots, prm, inverse, n_stages,
                               radices, bases, out_scale, stream);
}

extern "C" int stockham_columns_f64(const void* x, void* y, const void* tw,
                                    const void* roots, const long long* prm,
                                    int inverse, int n_stages,
                                    const int* radices, const int* bases,
                                    double out_scale, void* stream) {
  return launch_columns<double>(x, y, tw, roots, prm, inverse, n_stages,
                                radices, bases, out_scale, stream);
}
