"""Plain PyTorch versions of the four-step kernel, on any device.

* :func:`apply_fourstep` repeats the kernel's arithmetic with the kernel's
  own tables (W1, W2, T in the plane dtype): two complex matrix products
  with the twiddle multiply between them, and the transposed store.
  ``ops.fft`` takes it for tensors that lie on the CPU.
* :func:`fft4step_ref` is the oracle, as the reference package's
  ``ref.py`` has it: the same steps in complex128, on complex128 tables,
  cast back at the end.
"""

from __future__ import annotations

import torch

from ...fft.reference import dft_matrix, twiddles
from .fft4step import choose_factors


def apply_fourstep(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                   t: torch.Tensor) -> torch.Tensor:
    """Four-step DFT along the last axis of complex ``x`` (length n1*n2,
    the tables' sizes), natural-order output, no 1/n scaling."""
    n1, n2 = t.shape
    lead = x.shape[:-1]
    c = torch.matmul(w1, x.reshape(*lead, n1, n2)) * t     # column DFTs
    d = torch.matmul(c, w2)                                # row DFTs
    return d.transpose(-1, -2).reshape(*lead, n1 * n2)


def fft4step_ref(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Four-step FFT along the last axis in complex128, cast back to the
    input's dtype.  Forward unnormalized, inverse applies 1/n."""
    n = x.shape[-1]
    n1, n2 = choose_factors(n)
    c128, dev = torch.complex128, x.device
    y = apply_fourstep(x.to(c128), dft_matrix(n1, inverse, c128, device=dev),
                       dft_matrix(n2, inverse, c128, device=dev),
                       twiddles(n1, n2, inverse, c128, device=dev))
    if inverse:
        y = y / n
    return y.to(x.dtype)
