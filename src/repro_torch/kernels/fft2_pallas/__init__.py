"""Fused rank-2 FFT kernel."""
