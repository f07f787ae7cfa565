"""Fused fftconv kernel: real four-step, spectral product, inverse
four-step in one pass over memory."""
