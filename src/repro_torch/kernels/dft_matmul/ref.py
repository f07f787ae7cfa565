"""Plain PyTorch versions of the dft_matmul kernel, on any device.

* :func:`apply_fft` repeats the FFT body's arithmetic (7-smooth n) with
  the kernel's own table of n roots: the n1-point FFTs of the columns of
  the n1 x n2 view, the twiddle W_n^(j2 k1), the n2-point FFTs of the
  rows, each FFT the kernel's radix-by-radix DIF steps (:func:`reg_fft`);
  the inverse conjugates on the way in and out.
* :func:`apply_chirp` repeats the chirp body's (any other n) with the
  kernel's own tables at its length m = m1 * m2: the chirped row
  zero-padded to m, its FFT as the FFT body's two passes, the product
  with the filter spectrum, conjugated, the second FFT's two passes (the
  first without an exchange) and the store of the points t < n.
  ``ops.dft`` takes these two for tensors that lie on the CPU.
* :func:`dft_ref` is the oracle, as the reference package's ``ref.py`` has
  it: real/imaginary planes in and out, the table built in float64 and
  cast to the plane dtype; :func:`apply_dft` is the same direct product
  on a complex tensor with a given n x n table.

Only :func:`apply_fft` and :func:`apply_chirp` normalize (the inverse's
1/n, as the kernel folds it into its store); the others leave it to the
caller.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...fft.reference import dft_matrix
from .dft_matmul import FFT_SIZES


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


def first_radix(m: int) -> int:
    """The kernel's first DIF radix of an m-point register FFT
    (``first_radix`` in ``csrc/dft.cu``)."""
    if m in (2, 3, 4, 5, 7, 8):
        return m
    return next(r for r in (4, 2, 3, 5) if m % r == 0)


@functools.cache
def _butterfly_matrix(r: int, dtype: torch.dtype, device) -> torch.Tensor:
    e = np.outer(np.arange(r), np.arange(r)) % r
    return torch.as_tensor(np.exp(-2j * np.pi * e / r), dtype=dtype,
                           device=device)


def _butterfly(v: torch.Tensor, r: int) -> torch.Tensor:
    """The r-point DFT along dim -2 of ``v`` (..., r, q)."""
    return torch.matmul(_butterfly_matrix(r, v.dtype, v.device), v)


def reg_fft(a: torch.Tensor, roots: torch.Tensor,
            stride: int) -> torch.Tensor:
    """The forward FFT along the last axis of ``a`` (length m, a register
    FFT size) as the kernel's RegFft runs it: an r-point DIF step over
    a[q + (m/r) t], output u times W_m^(u q) = roots[u q stride], then the
    (m/r)-point FFTs; natural order out."""
    m = a.shape[-1]
    if m == 1:
        return a
    if m not in FFT_SIZES:
        raise ValueError(f"no register FFT of {m} points")
    r = first_radix(m)
    q = m // r
    lead = a.shape[:-1]
    b = _butterfly(a.reshape(*lead, r, q), r)          # (u, q)
    if q == 1:
        return b.reshape(*lead, m)
    e = torch.outer(torch.arange(r), torch.arange(q)).to(roots.device)
    b = reg_fft(b * roots[e * stride], roots, stride * r)   # (u, k')
    return b.transpose(-1, -2).reshape(*lead, m)       # X[u + r k']


def apply_fft(x: torch.Tensor, roots: torch.Tensor, n1: int, n2: int,
              inverse: bool) -> torch.Tensor:
    """The FFT body along the last axis of complex ``x`` (length n =
    n1*n2) with the table of n forward roots: column j2's n1-point FFT,
    output k1 times W_n^(j2 k1), then row k1's n2-point FFT, output k2 at
    y[k1 + n1 k2].  The inverse conjugates in and out and applies 1/n."""
    n = n1 * n2
    lead = x.shape[:-1]
    if inverse:
        x = torch.conj_physical(x)
    a = reg_fft(x.reshape(*lead, n1, n2).transpose(-1, -2), roots, n2)
    e = torch.outer(torch.arange(n2), torch.arange(n1)).to(roots.device)
    b = reg_fft((a * roots[e]).transpose(-1, -2), roots, n1)   # (k1, k2)
    y = b.transpose(-1, -2).reshape(*lead, n)
    if inverse:
        y = torch.conj_physical(y) * (1.0 / n)
    return y


def apply_chirp(x: torch.Tensor, roots: torch.Tensor, chirp: torch.Tensor,
                spectrum: torch.Tensor, m1: int, m2: int,
                inverse: bool) -> torch.Tensor:
    """The chirp body along the last axis of complex ``x`` (length n,
    convolution length m = m1*m2 >= 2n - 1) with the kernel's tables: the
    m roots W_m^e, the n chirp values and the m spectrum values (with
    1/m).  Pass 1: column j2 of the chirped row zero-padded to m
    (a[j1*m2 + j2]), its m1-point FFT, output k1 times W_m^(j2 k1); pass
    2: row k1's m2-point FFT, the point k1 + m1 k2; pass 3: times the
    spectrum, conjugated, the m2-point FFT over k2, output t2 times
    W_m^(k1 t2); pass 4: column t2's m1-point FFT, the point t2 + m2 t1,
    conjugated, times the chirp for t < n.  The inverse conjugates in and
    out and applies 1/n."""
    n = x.shape[-1]
    m = m1 * m2
    lead = x.shape[:-1]
    dev = roots.device
    if inverse:
        x = torch.conj_physical(x)
    a = torch.zeros((*lead, m), dtype=x.dtype, device=x.device)
    a[..., :n] = x * chirp
    a = reg_fft(a.reshape(*lead, m1, m2).transpose(-1, -2), roots, m2)
    a = a * roots[torch.outer(torch.arange(m2), torch.arange(m1)).to(dev)]
    a = reg_fft(a.transpose(-1, -2), roots, m1)                # (k1, k2)
    a = torch.conj_physical(a * spectrum.reshape(m2, m1).transpose(0, 1))
    a = reg_fft(a, roots, m1)                                  # (k1, t2)
    a = a * roots[torch.outer(torch.arange(m1), torch.arange(m2)).to(dev)]
    a = reg_fft(a.transpose(-1, -2), roots, m2)                # (t2, t1)
    q = a.transpose(-1, -2).reshape(*lead, m)[..., :n]
    y = chirp * torch.conj_physical(q)
    if inverse:
        y = torch.conj_physical(y) * (1.0 / n)
    return y
