"""Plain PyTorch versions of the dft_matmul kernel, on any device.

* :func:`apply_dft` repeats the kernel's arithmetic with the kernel's own
  table: the complex rows times the n x n DFT matrix, as four real
  products accumulated in the plane dtype.  ``ops.dft`` takes it for
  tensors that lie on the CPU.
* :func:`dft_ref` is the oracle, as the reference package's ``ref.py`` has
  it: real/imaginary planes in and out, the table built in float64 and
  cast to the plane dtype.

Neither applies 1/n to the inverse (callers normalize).
"""

from __future__ import annotations

import torch

from ...fft.reference import dft_matrix


def _planes(xr, xi, wr, wi) -> tuple[torch.Tensor, torch.Tensor]:
    """(xr + i xi) @ (wr + i wi) as four real products; W is symmetric,
    so x @ W is the DFT along the last axis."""
    return xr @ wr - xi @ wi, xr @ wi + xi @ wr


def dft_ref(xr: torch.Tensor, xi: torch.Tensor, inverse: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched direct DFT on (..., n) real/imaginary planes; returns the
    output planes in the planes' dtype."""
    n = xr.shape[-1]
    w = dft_matrix(n, inverse, torch.complex128, device=xr.device)
    return _planes(xr, xi, w.real.to(xr.dtype), w.imag.to(xr.dtype))


def apply_dft(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """DFT along the last axis of complex ``x`` with the table ``w`` (n x n,
    ``x``'s dtype)."""
    yr, yi = _planes(x.real, x.imag, w.real, w.imag)
    return torch.complex(yr, yi)
