// The column pass of the fused Stockham kernel for Hopper (sm_90a):
// stockham_columns_kernel, for the axes over one block's cap (the two
// passes of stockham.cu's header) and the fused rank-2 kernel's columns
// over its one-block cap (fft2_pallas/ops.py).  Part of the port of the
// TPU kernel src/repro/kernels/stockham_pallas/stockham_pallas.py :
// stockham_pallas, whose one block holds the whole axis.
//
// One column pass: signal `sig`'s column `col` holds element j at
// x[sig*in_sig + j*in_k + col]; its L-point FFT's output k, times
// W_tw_n^(k * (col / tw_q)) when tw_n > 0 and times `scale`, goes to
// y[(sig / group)*out_big + (sig % group)*out_small + k*out_k + col*out_col].
//
// Bound: device-memory bytes, one read and one write of the signal (an
// L-point column costs ~5 L log2(L) flops on 2 L complex values of
// traffic, far below the card's flop-per-byte ridge).  So the design keeps
// the signal out of device memory between the load and the store:
//   * block_fft's register passes in the column form (stockham_stages.cuh):
//     a block owns a tile of `cols` adjacent columns of one signal; the
//     host groups the schedule's stages into passes of one or two stages
//     (block.column_layout), each pass holds R = RA*RB points a thread in
//     registers, with one barrier a pass over ONE shared buffer, padded on
//     the host by a bank model (two buffers only where a middle pass has
//     more butterflies than threads).  1024 points in complex64 is two
//     32-point passes (8x4, 8x4: the schedule of ops.column_schedule),
//     one barrier and one trip through shared memory.  The families hold
//     passes of at most 32 points (16 in complex128) and no kBig: its 8x8
//     case spilled.
//   * The first pass reads its points straight from global memory into
//     registers, the columns fastest across a warp, so every load is a
//     row-run of `cols` adjacent points (16-byte loads in complex128; 8
//     bytes a lane in complex64, a 16-lane run filling a 128-byte line:
//     two columns a thread would double the 32-point pass's registers).
//     The host puts the largest pass first (ops.column_schedule orders a
//     power-of-two axis so) and gives the block a thread for each of its
//     butterflies, so the whole tile's loads are in flight together.
//   * The last pass multiplies in registers by the pass twiddle, from two
//     float64-built root tables (W_n^e = hi[e >> 10] * lo[e & 1023]), and
//     by `scale`, and stores straight to global memory; where the output's
//     unit stride is along k (pass 1's transposed store) its lanes take
//     the butterflies fastest (`jfast`), so a warp's store is a run of k.
//   * Shared memory is touched passes - 1 times, never on the way in or
//     out; no index divides (FastDiv, a block's signal and group too).
//   * The tile (host rule, ops.column_layout): the fewest columns whose
//     row-run is 128 bytes (16 complex64 / 8 complex128 points), halved
//     only while the block's layout does not fit its 227 KB.  Measured on
//     the card (profile_columns.py), the 128-byte run was worth more than
//     blocks sharing an SM (1024 points: 16 columns, 139 KB, one block an
//     SM, 1.07 ms for both passes of 2^20 x 64 against 1.10 at 8 columns).
//   * Registers set how many warps an SM holds, and with few warps the
//     passes' arithmetic and shared-memory traffic, not device memory,
//     bound the time (measured on the card): column_threads and
//     column_min_blocks hold each family's registers to what was measured
//     fastest without a spill.  Tried and dropped: each thread loading
//     several first-pass butterflies (it spilled), and a persistent block
//     that copies the next tile with cp.async while it runs the current
//     one (slower at every shape tried).
// The inverse runs as the conjugate of the forward passes (conj on the
// first load, conjugated stage twiddles, conj on the last store), as
// block_fft does; the pass twiddle and the scale follow the last conj.
// A family is a few cases compiled into one switch, as for block_fft; a
// launch takes the family the host's plan names.
//
// Included by stockham.cu (stockham_columns_f32) and stockham64.cu
// (stockham_columns_f64).

#pragma once

#include "stockham_stages.cuh"

namespace {

constexpr int kRootShift = 10;  // W_n^e = hi[e >> 10] * lo[e & 1023]
constexpr int kRootLo = 1 << kRootShift;

// The column kernel's families: block_fft's unpaired ones, without kBig,
// and the kSmallPow2 family in complex64 also holds the 32-point 8x4
// pass, so that 1024 points are two passes (ops.column_schedule);
// block.family_cases(..., column=True) holds the same sets.  (Pairing
// complex128's odd radices with a 2 made P13's 98 and 140 two passes
// each, but that family spilled and ran P13 slower.)
constexpr unsigned long long kColumnPow2 = bits(23);
__host__ __device__ constexpr unsigned long long column_cases(int family,
                                                              bool dbl) {
  return family == kBig ? 0ULL
         : family_cases(family, dbl, false) |
               (family == kSmallPow2 && !dbl ? kColumnPow2 : 0ULL);
}

// A family's most threads a block (block.max_threads(..., column=True)),
// and the blocks of that size that must fit an SM together
// (__launch_bounds__' minimum: ptxas keeps a thread's registers within
// 64K / (threads * blocks)).  In complex128 the single-stage families
// run blocks of at most 64 threads, six an SM (168 registers, no spill):
// at P13's 98 x 140 split a block holds a few hundred points, and at
// block_fft's bound (218 registers, one or two blocks an SM) both passes
// took 5.9 ms against 3.7 (profile_columns.py); every other family keeps
// block_fft's bound (up to 255 registers, no spill).
__host__ __device__ constexpr int column_threads(int family, bool dbl) {
  return dbl && family != kSmallPow2 ? 64 : family_threads(family, dbl);
}
__host__ __device__ constexpr int column_min_blocks(int family, bool dbl) {
  return dbl && family != kSmallPow2 ? 6 : 1;
}

// The host's plan of a column pass (block.ColumnPlanC): the strides of
// the pass (see the header), the tile of `cols` columns, the pass twiddle
// and the register passes over the tile (its L rows by `cols` columns).
struct ColumnPlan {
  long long in_sig, in_k, out_big, out_small, out_k, out_col;
  int n_passes;
  int width, cols, tiles, tw_n, jfast;
  FastDiv f_tiles, f_group, f_twq;  // block -> signal; signal -> group; col / tw_q
  PassDesc pass[kMaxPasses];
};

// A block's side of the column pass: its tile's first input point and
// first output point (64-bit offsets folded in once), the columns it
// holds, the pass twiddle's tables.
template <typename T>
struct ColumnTile {
  const Cx<T>* x;
  Cx<T>* y;
  const Cx<T>* roots;
  int in_k, out_k, out_col;
  int col0, cw, tw_n;
  FastDiv f_twq;
  T scale;
};

// The first pass (s = 1, q = 0): element p + M t of column `col` from
// global memory, zero past the width, conjugated for the inverse.
template <int R, typename T>
__device__ __forceinline__ void load_columns(Cx<T> (&a)[R], const PassDesc& ps,
                                             const ColumnTile<T>& tl, bool inv,
                                             int col, int p) {
  const bool live = col < tl.cw;
  const Cx<T>* __restrict__ src = tl.x + col + p * tl.in_k;
  const int step = ps.M * tl.in_k;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const Cx<T> v = live ? src[t * step] : Cx<T>{T(0), T(0)};
    a[t] = inv ? conj(v) : v;
  }
}

// A butterfly's R points from the buffer's layout, and its R outputs to
// the next layout (block_fft's shared-memory loads and stores, line 0).
template <int RA, int RB, typename T>
__device__ __forceinline__ void load_shared(Cx<T> (&a)[RA * RB], const PassDesc& ps,
                                            const Cx<T>* buf, int col, int q, int p) {
  const Cx<T>* src = buf + ps.in_off;
  const int eb = col + ps.C * (q + ps.s * p), step = ps.C * ps.s * ps.M;
#pragma unroll
  for (int t = 0; t < RA * RB; ++t) a[t] = src[padded(eb + step * t, ps.in_sh)];
}
template <int RA, int RB, typename T>
__device__ __forceinline__ void store_shared(const Cx<T> (&a)[RA * RB],
                                             const PassDesc& ps, Cx<T>* buf,
                                             int col, int q, int p) {
  constexpr int R = RA * RB;
  Cx<T>* dst = buf + ps.out_off;
  const int eb = col + ps.C * (q + ps.s * R * p), step = ps.C * ps.s;
#pragma unroll
  for (int k = 0; k < R; ++k) dst[padded(eb + step * k, ps.out_sh)] = a[slot<RA, RB>(k)];
}

// The last pass (M = 1, p = 0): output k = q + s kk of column `col`,
// conjugated for the inverse, times W_tw_n^(k * ((col0 + col) / tw_q))
// and the scale, to global memory.
template <int RA, int RB, typename T>
__device__ __forceinline__ void store_columns(const Cx<T> (&a)[RA * RB],
                                              const PassDesc& ps,
                                              const ColumnTile<T>& tl, bool inv,
                                              int col, int q) {
  constexpr int R = RA * RB;
  if (col >= tl.cw) return;
  Cx<T>* __restrict__ dst = tl.y + col * tl.out_col;
  const int jq = tl.tw_n > 0 ? fdiv(tl.f_twq, tl.col0 + col) : 0;
  const Cx<T>* __restrict__ roots = tl.roots;
#pragma unroll
  for (int kk = 0; kk < R; ++kk) {
    const int k = q + ps.s * kk;
    Cx<T> v = a[slot<RA, RB>(kk)];
    if (inv) v = conj(v);
    if (tl.tw_n > 0) {
      const int e = k * jq;  // < tw_n
      v = mul(v, mul(roots[kRootLo + (e >> kRootShift)], roots[e & (kRootLo - 1)]));
    }
    dst[k * tl.out_k] = scale(v, tl.scale);
  }
}

// Work unit u of a pass -> (column, q, p): the column fastest, or the
// butterfly fastest (`jfast`, the last pass of a transposed store).
__device__ __forceinline__ void locate_column(const PassDesc& ps, bool jfast,
                                              int u, int& col, int& q, int& p) {
  int j;
  if (jfast) {
    col = fdiv(ps.f_nb, u);
    j = u - col * ps.nb;
  } else {
    j = fdiv(ps.f_c, u);
    col = u - j * ps.C;
  }
  p = fdiv(ps.f_s, j);
  q = j - p * ps.s;
}

// One register pass over the tile: the first from global memory, the
// others from the buffer; the last to global memory, the others to the
// buffer.  The host puts the largest pass first and sizes the block for
// it, so a thread's first-pass loads (all R issued before its first
// stage) are the block's whole tile in flight.  A pass that reads and
// writes the one buffer holds its butterflies across the barrier, one a
// thread (the host sizes the block for it); any other loops over them.
template <int RA, int RB, typename T>
__device__ __forceinline__ void column_case(const PassDesc& ps, const Block<T>& b,
                                            const ColumnTile<T>& tl, bool jfast) {
  constexpr int R = RA * RB;
  Cx<T>* const buf = shared_points<T>();
  const int units = ps.upg;
  const bool in_place = !b.first && !b.last && ps.in_off == ps.out_off;
  for (int u = threadIdx.x;; u += blockDim.x) {
    const bool active = u < units;
    if (!in_place && !active) break;
    Cx<T> a[R];
    int col = 0, q = 0, p = 0;
    if (active) {
      locate_column(ps, jfast, u, col, q, p);
      if (b.first) {
        load_columns<R>(a, ps, tl, b.inv, col, p);
      } else {
        load_shared<RA, RB>(a, ps, buf, col, q, p);
      }
      pass_stages<RA, RB>(a, ps, b, p);
    }
    if (in_place) __syncthreads();
    if (active) {
      if (b.last) {
        store_columns<RA, RB>(a, ps, tl, b.inv, col, q);
      } else {
        store_shared<RA, RB>(a, ps, buf, col, q, p);
      }
    }
    if (in_place) break;
  }
}

template <int I, int RA, int RB, int FAMILY, typename T>
__device__ __forceinline__ void dispatch_column(const PassDesc& ps, const Block<T>& b,
                                                const ColumnTile<T>& tl,
                                                bool jfast) {
  if constexpr ((column_cases(FAMILY, sizeof(T) == 8) >> I) & 1ULL) {
    column_case<RA, RB>(ps, b, tl, jfast);
  } else {
    __trap();  // never planned for this family (block.py)
  }
}

// A block: tile blockIdx.x, columns (t % tiles) * cols... of signal
// t / tiles; the host's passes in order, a barrier between two.
template <typename T, int FAMILY>
__global__ void __launch_bounds__(column_threads(FAMILY, sizeof(T) == 8),
                                  column_min_blocks(FAMILY, sizeof(T) == 8))
stockham_columns_kernel(const Cx<T>* __restrict__ x, Cx<T>* __restrict__ y,
                        const Cx<T>* __restrict__ tw,
                        const Cx<T>* __restrict__ roots, T scale, int inverse,
                        const __grid_constant__ ColumnPlan cp) {
  const int t = static_cast<int>(blockIdx.x);
  const int sig = fdiv(cp.f_tiles, t);
  const int grp = fdiv(cp.f_group, sig);
  ColumnTile<T> tl;
  tl.col0 = (t - sig * cp.tiles) * cp.cols;
  tl.cw = min(cp.cols, cp.width - tl.col0);
  tl.x = x + sig * cp.in_sig + tl.col0;
  tl.y = y + grp * cp.out_big +
         static_cast<long long>(sig - grp * static_cast<int>(cp.f_group.d)) *
             cp.out_small +
         tl.col0 * cp.out_col;
  tl.roots = roots;
  tl.in_k = static_cast<int>(cp.in_k);
  tl.out_k = static_cast<int>(cp.out_k);
  tl.out_col = static_cast<int>(cp.out_col);
  tl.tw_n = cp.tw_n;
  tl.f_twq = cp.f_twq;
  tl.scale = scale;
  // what pass_stages reads
  Block<T> b;
  b.tw = tw;
  b.inv = inverse != 0;
  b.mode = kC2C;
  for (int i = 0; i < cp.n_passes; ++i) {
    const PassDesc& ps = cp.pass[i];
    b.first = i == 0;
    b.last = i == cp.n_passes - 1;
    const bool jfast = b.last && cp.jfast;
    switch (ps.code) {
#define REPRO_PASS(I, RA, RB)                                                  \
  case I:                                                                      \
    dispatch_column<I, RA, RB, FAMILY>(ps, b, tl, jfast);                      \
    break;
      REPRO_PASS_CASES
#undef REPRO_PASS
      default:
        __trap();
    }
    // the next pass reads what this one wrote
    if (!b.last) __syncthreads();
  }
}

template <typename T, int FAMILY>
int launch_columns_fft(const void* x, void* y, const void* tw, const void* roots,
                       long long blocks, const ColumnPlan& cp, int inverse,
                       double scale, int threads, size_t smem,
                       cudaStream_t stream) {
  if (threads < 1 || threads > column_threads(FAMILY, sizeof(T) == 8))
    return cudaErrorInvalidValue;
  const cudaError_t err = opt_in<stockham_columns_kernel<T, FAMILY>>(smem);
  if (err != cudaSuccess) return err;
  stockham_columns_kernel<T, FAMILY>
      <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
          static_cast<const Cx<T>*>(x), static_cast<Cx<T>*>(y),
          static_cast<const Cx<T>*>(tw), static_cast<const Cx<T>*>(roots),
          static_cast<T>(scale), inverse, cp);
  return cudaGetLastError();
}

// The plain C entry of the column pass: the host's ColumnPlan (``plan``),
// the signals, the direction, the case family, the scale of the last
// store, the block's threads and shared memory.
template <typename T>
int launch_columns(const void* x, void* y, const void* tw, const void* roots,
                   const void* plan, long long nsig, int inverse, int family,
                   double scale, int threads, long long smem, void* stream) {
  const ColumnPlan& cp = *static_cast<const ColumnPlan*>(plan);
  if (nsig < 1 || cp.n_passes < 1 || cp.n_passes > kMaxPasses ||
      cp.cols < 1 || cp.width < 1 || cp.tiles != (cp.width + cp.cols - 1) / cp.cols ||
      cp.tw_n < 0 || (cp.tw_n > 0 && roots == nullptr) || smem < 0 ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const long long blocks = nsig * cp.tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = static_cast<size_t>(smem);
  switch (family) {
    case kSmallPow2:
      return launch_columns_fft<T, kSmallPow2>(x, y, tw, roots, blocks, cp, inverse, scale, threads, sm, s);
    case kOddRadix:
      return launch_columns_fft<T, kOddRadix>(x, y, tw, roots, blocks, cp, inverse, scale, threads, sm, s);
    case kOneStage:
      return launch_columns_fft<T, kOneStage>(x, y, tw, roots, blocks, cp, inverse, scale, threads, sm, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
