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
// second entry, the column pass (stockham_columns.cuh): with n = n1*n2
// and x[j1*n2 + j2],
//   pass 1: the n2 strided columns' n1-point FFTs, each output k1 times
//           W_n^(j2*k1), stored transposed (tmp[j2*n1 + k1]);
//   pass 2: the n1 columns of tmp, n2-point FFTs, stored in natural
//           order y[k2*n1 + k1], the inverse's 1/n folded in.
// A block of the column pass owns a tile of adjacent columns of one
// signal and runs block_fft's register passes in their column form over
// one shared buffer: the first pass loads row-runs of the tile straight
// into registers, the last stores from registers, pass 1's twiddled and
// transposed (a warp's store a run along k).  The same entry runs the
// fused rank-2 kernel's passes over its one-block cap (fft2_pallas's
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
// stockham_pallas/block.py; stockham_columns_f32: the host's ColumnPlan;
// their complex128 twins stockham_block_f64 and stockham_columns_f64 are
// stockham64.cu, a library of its own so that the two compile in
// parallel), loaded with ctypes; each returns the cudaError_t of the
// launch.

#include <cuda_runtime.h>

#include "stockham_columns.cuh"
#include "stockham_stages.cuh"

extern "C" int stockham_block_f32(const void* x, void* y, const void* tw,
                                  const void* roots, const void* plan,
                                  long long batch, int inverse, int family,
                                  double scale, int threads, long long smem,
                                  void* stream) {
  return launch_block<float, false>(x, y, tw, roots, plan, batch, inverse,
                                    family, scale, threads, smem, stream);
}

extern "C" int stockham_columns_f32(const void* x, void* y, const void* tw,
                                    const void* roots, const void* plan,
                                    long long nsig, int inverse, int family,
                                    double scale, int threads, long long smem,
                                    void* stream) {
  return launch_columns<float>(x, y, tw, roots, plan, nsig, inverse, family,
                               scale, threads, smem, stream);
}
