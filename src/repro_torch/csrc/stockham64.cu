// The complex128 one-block entry of the fused Stockham kernel for Hopper
// (sm_90a): stockham.cu's block_fft (stockham_stages.cuh) for complex128,
// its complex transforms and real-input folds, built as a library of its
// own so that it compiles in parallel with stockham.cu (see there for the
// design, the TPU kernel it replaces and its bound).
//
// Plain C interface (stockham_block_f64: the host's BlockPlan, see
// stockham_pallas/block.py), loaded with ctypes; returns the cudaError_t
// of the launch.

#include <cuda_runtime.h>

#include "stockham_stages.cuh"

extern "C" int stockham_block_f64(const void* x, void* y, const void* tw,
                                  const void* roots, const void* plan,
                                  long long batch, int inverse, int family,
                                  double scale, int threads, long long smem,
                                  void* stream) {
  return launch_block<double, false>(x, y, tw, roots, plan, batch, inverse,
                                     family, scale, threads, smem, stream);
}
