"""Plain PyTorch versions of the four-step kernel, on any device.

* :func:`apply_fourstep_fft` repeats the FFT body's arithmetic (both sides
  7-smooth) with the kernel's own root vector: each side's register
  passes (``fft4step.side_radices``) as in-place DIF steps on its
  positions, each FFT the kernel's radix-by-radix steps
  (``dft_matmul.ref.reg_fft``), the twiddle T from its two root tables
  after the column side, and the transposed store from the positions'
  digit-reversed frequencies.
* :func:`apply_fourstep` repeats the product body's with the kernel's own
  tables (W1, W2, T in the plane dtype): two complex matrix products
  with the twiddle multiply between them, and the transposed store.
  ``ops.plain`` takes the split's body; ``ops.fft`` takes it for tensors
  that lie on the CPU.
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

import functools

import numpy as np
import torch

from ...fft.reference import dft_matrix, twiddles
from ..dft_matmul.ref import reg_fft
from .fft4step import MAX_FACTOR, choose_factors, side_radices


@functools.cache
def frequencies(m: int) -> np.ndarray:
    """The frequency each position of a side of m points holds after its
    register passes (the kernel's ``digit_rev``): position digits, most
    significant first in the radices ``side_radices(m)``, reversed."""
    freq = np.zeros(m, dtype=np.int64)
    pos = np.arange(m)
    weight = 1
    radices = side_radices(m)
    for i, f in enumerate(radices):
        later = int(np.prod(radices[i + 1:], dtype=np.int64))
        freq += (pos // later) % f * weight
        weight *= f
    return freq


def side_passes(a: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """A side's register passes along the last axis of ``a`` (m points)
    with the side's m roots, in place as the kernel runs them: pass i
    views the axis as blocks of f * step points, takes the f-point FFT of
    the points q + step p of each block, leaves output k at q + step k
    and, unless it is the last pass, multiplies it by
    roots[q k (m / span)]."""
    m = a.shape[-1]
    lead = a.shape[:-1]
    radices = side_radices(m)
    span = m
    for i, f in enumerate(radices):
        step = span // f
        v = a.reshape(*lead, m // span, f, step).transpose(-1, -2)
        v = reg_fft(v, roots, m // f)                  # (.., b, q, k)
        if i + 1 < len(radices):
            e = torch.outer(torch.arange(step), torch.arange(f)) * (m // span)
            v = v * roots[e.to(roots.device)]
        a = v.transpose(-1, -2).reshape(*lead, m)
        span = step
    return a


def apply_fourstep_fft(x: torch.Tensor, roots: torch.Tensor, n1: int,
                       n2: int, inverse: bool) -> torch.Tensor:
    """The FFT body along the last axis of complex ``x`` (length n =
    n1*n2) with the kernel's root vector (W1's n1 roots, W2's n2, T's two
    root tables of 128): the n1 side's passes down every column, output
    k1 times T[k1, j2] = hi[e >> 7] * lo[e & 127] (e = k1 j2), the n2
    side's passes along every row, and y[k2 n1 + k1].  The inverse
    conjugates the roots, the input and the output and applies 1/n."""
    n = n1 * n2
    lead = x.shape[:-1]
    k = MAX_FACTOR
    if inverse:
        x, roots = torch.conj_physical(x), torch.conj_physical(roots)
    r1, r2 = roots[:n1], roots[n1:n1 + n2]
    lo, hi = roots[n1 + n2:n1 + n2 + k], roots[n1 + n2 + k:]
    dev = roots.device
    a = side_passes(x.reshape(*lead, n1, n2).transpose(-1, -2), r1)
    f1 = torch.as_tensor(frequencies(n1), device=dev)
    e = torch.arange(n2, device=dev)[:, None] * f1[None, :]   # (j2, pos1)
    a = a * (hi[e >> 7] * lo[e & 127])
    a = side_passes(a.transpose(-1, -2), r2)                   # (pos1, pos2)
    at1 = torch.as_tensor(np.argsort(frequencies(n1)), device=dev)
    at2 = torch.as_tensor(np.argsort(frequencies(n2)), device=dev)
    y = a[..., at1, :][..., at2].transpose(-1, -2).reshape(*lead, n)
    if inverse:
        y = torch.conj_physical(y) * (1.0 / n)
    return y


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
