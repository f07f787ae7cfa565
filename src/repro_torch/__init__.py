"""gearshifft-style FFT benchmark suite in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (H100)."""
