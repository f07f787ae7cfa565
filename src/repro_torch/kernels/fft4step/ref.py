"""Plain PyTorch versions of the four-step kernel, on any device.

* :func:`apply_fourstep` repeats the kernel's arithmetic with the kernel's
  own tables (W1, W2, T in the plane dtype): two complex matrix products
  with the twiddle multiply between them, and the transposed store.
  ``ops.fft`` takes it for tensors that lie on the CPU.
* :func:`split_product` and :func:`apply_fourstep_tf32` model the
  kernel's tensor-core arithmetic for complex64 on any device: each fp32
  operand rounded to TF32 as ``cvt.rna.tf32.f32`` does (:func:`tf32`) and
  split into that high part and a TF32 remainder, the product summed from
  three (or, for plain TF32, one) such terms.
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


def tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest
    (ties away from zero), the 13 low mantissa bits dropped."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(a)
    return hi, tf32(a - hi)


def split_product(a: torch.Tensor, b: torch.Tensor,
                  terms: int = 3) -> torch.Tensor:
    """``a @ b`` for complex64 operands as four real products, each summed
    from TF32 parts: hi*hi + hi*lo + lo*hi (``terms=3``, 3xTF32) or hi*hi
    alone (``terms=1``, plain TF32).  The parts' products are exact in
    fp32, so fp32 matmuls sum them as the tensor cores do, up to order."""
    def real(x, y):
        (xh, xl), (yh, yl) = _split(x), _split(y)
        out = torch.matmul(xh, yh)
        if terms == 3:
            out = out + torch.matmul(xh, yl) + torch.matmul(xl, yh)
        return out
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(real(ar, br) - real(ai, bi),
                         real(ai, br) + real(ar, bi))


def apply_fourstep_tf32(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                        t: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """:func:`apply_fourstep` with both complex64 products summed from
    TF32 parts (:func:`split_product`): the kernel's complex64 arithmetic
    (``terms=3``) or plain TF32 (``terms=1``)."""
    n1, n2 = t.shape
    lead = x.shape[:-1]
    c = split_product(w1, x.reshape(*lead, n1, n2), terms) * t
    d = split_product(c, w2, terms)
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
