// The complex128 entries of the fused Stockham kernel for Hopper
// (sm_90a): stockham.cu's block_fft (stockham_stages.cuh) for complex128,
// its complex transforms and real-input folds, and the column pass
// (stockham_columns.cuh), built as a library of its own so that it
// compiles in parallel with stockham.cu (see there and in
// stockham_columns.cuh for the design, the TPU kernel they replace and
// their bound).
//
// Plain C interface (stockham_block_f64: the host's BlockPlan;
// stockham_columns_f64: its ColumnPlan; see stockham_pallas/block.py),
// loaded with ctypes; each returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include "stockham_columns.cuh"
#include "stockham_stages.cuh"

extern "C" int stockham_block_f64(const void* x, void* y, const void* tw,
                                  const void* roots, const void* plan,
                                  long long batch, int inverse, int family,
                                  double scale, int threads, long long smem,
                                  void* stream) {
  return launch_block<double, false>(x, y, tw, roots, plan, batch, inverse,
                                     family, scale, threads, smem, stream);
}

extern "C" int stockham_columns_f64(const void* x, void* y, const void* tw,
                                    const void* roots, const void* plan,
                                    long long nsig, int inverse, int family,
                                    double scale, int threads, long long smem,
                                    void* stream) {
  return launch_columns<double>(x, y, tw, roots, plan, nsig, inverse, family,
                                scale, threads, smem, stream);
}
