"""The FFT clients, one per backend binary."""
