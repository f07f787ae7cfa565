"""Fused mixed-radix Stockham FFT kernel."""
