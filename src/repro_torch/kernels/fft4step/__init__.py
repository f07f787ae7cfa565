"""Fused four-step FFT kernel."""
