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
// CTA owns a tile of tile_b whole signals in ONE shared buffer and runs
// the register passes of block_fft (stockham_stages.cuh):
//   * the row passes (the n2 axis, stages grouped into passes of one or
//     two that one case family holds), the first reading straight from
//     global memory;
//   * the column passes in the interleaved-columns form (the elements of a
//     column n2 apart: consecutive threads take consecutive columns, so a
//     warp's shared-memory accesses are to consecutive words), no
//     transpose;
//   * the last pass writes straight to global memory in natural order,
//     with the inverse's 1/(n1*n2) folded into that store.
// P6's 128 x 64 tile is three passes (one row pass of 64 points a thread,
// then 64 and 2 down the columns, the kBig family) with two barriers,
// where the two-buffer design ran five stages.  The real-input fold of an even last extent n2
// = 2h (rfft2 / irfft2 of the wrapper) runs the packed n1 x h tile in the
// same passes: the R2C post-pass X[k1][k2] = E + W_n2^k2 O from Z[k1][k2]
// and Z[-k1][-k2], and X[k1][h] = E - O, in the last pass's registers (a
// butterfly paired with its mirror); the C2R pre-pass z = E + i O from the
// bins in the first pass's.  This replaces fft/rfft.py's rfftn_packed /
// irfftn_packed torch passes around the kernel.
// The host caps one block at the tiles that two buffers would hold (8192
// points in complex64, 4096 in complex128: 227 KB per block); a larger
// tile, up to the reference's 2^18 points, runs as passes through global
// memory on stockham.cu's entries (the rows' FFTs, then the column pass),
// launched by this kernel's wrapper (kernels/fft2_pallas/ops.py).
//
// Layout: interleaved complex (torch.view_as_real of a contiguous
// complex64/complex128 tensor).  Twiddles: one interleaved complex vector;
// the twiddle of (stage, u, p) sits at base[stage] + (u-1)*m + p.
//
// Plain C interface (fft2_block_f32 / fft2_block_f64: the host's
// BlockPlan, its mode complex or an even n2's real fold; the direction,
// the kernel width), loaded with ctypes; each returns the cudaError_t of
// the launch.

#include <cuda_runtime.h>

#include "stockham_stages.cuh"

extern "C" int fft2_block_f32(const void* x, void* y, const void* tw,
                              const void* roots, const void* plan,
                              long long batch, int inverse, int family,
                              double scale, int threads, long long smem,
                              void* stream) {
  return launch_block<float, true>(x, y, tw, roots, plan, batch, inverse,
                                   family, scale, threads, smem, stream);
}

extern "C" int fft2_block_f64(const void* x, void* y, const void* tw,
                              const void* roots, const void* plan,
                              long long batch, int inverse, int family,
                              double scale, int threads, long long smem,
                              void* stream) {
  return launch_block<double, true>(x, y, tw, roots, plan, batch, inverse,
                                    family, scale, threads, smem, stream);
}
