"""Fused fftconv kernel: two real FFTs in shared memory around the
spectral product, in one pass over memory."""
