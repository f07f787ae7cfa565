"""FFT engine layer: reference conventions, R2C packing, separable ND."""
