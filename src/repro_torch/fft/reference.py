"""``torch.fft`` reference transforms and the host-side twiddle tables.

``torch.fft`` is cuFFT on the card and pocketfft on the CPU.  These
wrappers pin down the conventions (sign, normalization, half-spectrum
layout) every hand-written backend is checked against:

  forward :  X[k] = sum_j x[j] * exp(-2*pi*i*j*k / n)       (no scaling)
  inverse :  x[j] = (1/n) * sum_k X[k] * exp(+2*pi*i*j*k / n)
  rfft    :  returns n//2 + 1 coefficients along the transformed axis

The twiddle tables are computed in numpy float64 with the index products
reduced mod n in integer arithmetic, cast once to the requested dtype and
placed on the device the caller names (there is no default device).
"""

from __future__ import annotations

import numpy as np
import torch


def fft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Forward complex-to-complex DFT along ``axis``."""
    return torch.fft.fft(x, dim=axis)


def ifft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse complex-to-complex DFT along ``axis`` (1/n normalized)."""
    return torch.fft.ifft(x, dim=axis)


def rfft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Real-to-complex forward transform (half spectrum, n//2+1 bins)."""
    return torch.fft.rfft(x, dim=axis)


def irfft(x: torch.Tensor, n: int, axis: int = -1) -> torch.Tensor:
    """Complex-to-real inverse transform. ``n`` is the real output length."""
    return torch.fft.irfft(x, n=n, dim=axis)


def fftn(x: torch.Tensor, axes=None) -> torch.Tensor:
    return torch.fft.fftn(x, dim=axes)


def ifftn(x: torch.Tensor, axes=None) -> torch.Tensor:
    return torch.fft.ifftn(x, dim=axes)


def rfftn(x: torch.Tensor, axes=None) -> torch.Tensor:
    return torch.fft.rfftn(x, dim=axes)


def irfftn(x: torch.Tensor, shape, axes=None) -> torch.Tensor:
    return torch.fft.irfftn(x, s=shape, dim=axes)


def _table(ang: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.exp(1j * ang), dtype=dtype, device=device)


def dft_matrix(n: int, inverse: bool = False, dtype=torch.complex64, *,
               device) -> torch.Tensor:
    """The dense n x n DFT matrix W[j,k] = exp(-+ 2 pi i j k / n); the
    inverse includes no 1/n factor."""
    j = np.arange(n, dtype=np.int64)
    sign = 2.0 if inverse else -2.0
    ang = (sign * np.pi / n) * ((j[:, None] * j[None, :]) % n).astype(np.float64)
    return _table(ang, dtype, device)


def twiddles(n1: int, n2: int, inverse: bool = False, dtype=torch.complex64,
             *, device) -> torch.Tensor:
    """Four-step twiddle factors T[j1, k2] = exp(-+ 2 pi i j1 k2 / (n1*n2))."""
    n = n1 * n2
    sign = 2.0 if inverse else -2.0
    j1 = np.arange(n1, dtype=np.int64)
    k2 = np.arange(n2, dtype=np.int64)
    ang = (sign * np.pi / n) * ((j1[:, None] * k2[None, :]) % n).astype(np.float64)
    return _table(ang, dtype, device)


def half_roots(n: int, inverse: bool = False, dtype=torch.complex64, *,
               device) -> torch.Tensor:
    """The first n//2 of the n-th unit roots e^{-+ 2 pi i k / n}: the R2C
    pack/unpack twiddles."""
    sign = 2.0 if inverse else -2.0
    ang = (sign * np.pi / n) * np.arange(n // 2, dtype=np.float64)
    return _table(ang, dtype, device)


def unit_roots(n: int, count: int, inverse: bool = False,
               dtype=torch.complex64, *, device) -> torch.Tensor:
    """The roots w^e = exp(-+ 2 pi i e / n) for e < ``count`` (``count``
    may exceed n: e is reduced mod n), one row of :func:`dft_matrix`'s
    values."""
    e = np.arange(count, dtype=np.int64)
    sign = 2.0 if inverse else -2.0
    return _table((sign * np.pi / n) * (e % n).astype(np.float64), dtype,
                  device)
