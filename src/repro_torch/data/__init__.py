"""Synthetic token data for the LM workloads."""
