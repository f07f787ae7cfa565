"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``) with their
wrappers and plain PyTorch versions."""
