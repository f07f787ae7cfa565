"""Batched direct DFT kernel (n <= 128)."""
