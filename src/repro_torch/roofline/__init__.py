"""Roofline models of the port: the FFT envelope of each device and the
LM formulas."""
