"""Four-step (Bailey) FFT as dense matrix products in plain PyTorch: the
reference package's ``fft/fourstep.py`` (its ``fourstep`` backend).

It is a baseline, not a kernel: the planner offers it (``candidates``)
and wisdom records name it; its products go to ``torch.matmul``.  With
n = n1 * n2 (n1 <= 128) and A = x.reshape(n1, n2),

    D = (W_n1 @ A  *  T) @ W_n2,   out = transpose(D).flatten()

where the length-n2 row transform recurses until n2 <= 128 and a length
up to 128 is one product with its DFT matrix.  The tables (float64
angles, cast once) are cached per length, dtype and device.
"""

from __future__ import annotations

import functools

import torch

from .reference import dft_matrix, twiddles

#: Largest radix handled by a single dense DFT product.
MAX_RADIX = 128


@functools.lru_cache(maxsize=256)
def _dft(n: int, inverse: bool, dtype: torch.dtype,
         device: torch.device) -> torch.Tensor:
    return dft_matrix(n, inverse, dtype, device=device)


@functools.lru_cache(maxsize=256)
def _twiddles(n1: int, n2: int, inverse: bool, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    return twiddles(n1, n2, inverse, dtype, device=device)


def _split(n: int) -> tuple[int, int]:
    """Factor n = n1 * n2 with n1 as large as possible but <= MAX_RADIX:
    the largest power of two up to 128, else the smallest odd factor."""
    for cand in (128, 64, 32, 16, 8, 4, 2):
        if n % cand == 0:
            return cand, n // cand
    for cand in range(3, MAX_RADIX + 1, 2):
        if n % cand == 0:
            return cand, n // cand
    raise ValueError(
        f"fourstep cannot factor n={n} with radices <= {MAX_RADIX}; "
        "use the bluestein backend for large-prime lengths")


def _fft_unnormalized(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    n = x.shape[-1]
    if n <= MAX_RADIX:   # W is symmetric: x @ W is the DFT of each row
        return x @ _dft(n, inverse, x.dtype, x.device)
    n1, n2 = _split(n)
    batch = x.shape[:-1]
    a = x.reshape(*batch, n1, n2)
    b = _dft(n1, inverse, x.dtype, x.device) @ a        # column DFTs
    c = b * _twiddles(n1, n2, inverse, x.dtype, x.device)
    d = _fft_unnormalized(c, inverse)                   # row DFTs
    return d.transpose(-1, -2).reshape(*batch, n)


def fft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Four-step FFT along the last axis.  The length must factor into
    radices up to 128.  Forward unnormalized, the inverse applies 1/n.
    Real input is cast to complex64, as the reference does."""
    if not x.is_complex():
        x = x.to(torch.complex64)
    y = _fft_unnormalized(x, inverse)
    return y / x.shape[-1] if inverse else y
