"""Plain PyTorch versions of the fused fftconv kernel, on any device.

* :func:`fftconv_plain` repeats the kernel's arithmetic with the kernel's
  own tables, in float32: the signal packed as n/2 complex points, the
  Stockham stages (``stockham_pallas.ref.apply_stages``), the spectral
  pass over the bin pairs (:func:`spectral_pass`) and the same stages on
  the conjugate.  ``ops.fftconv`` takes it for tensors that lie on the
  CPU.
* :func:`fftconv_ref` is the oracle, as the reference package's ``ref.py``
  has it: circular convolution at length n through ``torch.fft``.
"""

from __future__ import annotations

import torch

from ..stockham_pallas.ref import apply_stages


def fftconv_ref(x: torch.Tensor, h: torch.Tensor, n: int) -> torch.Tensor:
    """Circular depthwise convolution at length n via the frequency domain.

    x: (C, B, L) real;  h: (C, K) real filters;  returns (C, B, L) in
    ``x``'s dtype.  With n >= L + K - 1 this is causal linear convolution.
    """
    L = x.shape[-1]
    xf = torch.fft.fft(x, n=n, dim=-1)
    hf = torch.fft.fft(h, n=n, dim=-1)
    y = torch.fft.ifft(xf * hf[:, None, :], dim=-1)
    return y[..., :L].real.to(x.dtype)


def spectral_pass(z: torch.Tensor, hf: torch.Tensor,
                  roots: torch.Tensor) -> torch.Tensor:
    """The kernel's pass over the bin pairs (k, N - k), k <= N/2, of the
    packed spectra ``z`` (..., N): the real signals' spectra X, their
    product Y = X * ``hf`` (the (..., N + 1) half spectra, broadcast), and
    the packed spectrum of Y's inverse, conjugated.  ``roots`` holds
    w^k = exp(-2 pi i k / 2N) for k <= N/2."""
    N = z.shape[-1]
    k = torch.arange(N // 2 + 1, device=z.device)
    m = (N - k) % N                      # k = 0 pairs with itself
    zk, zm = z[..., k], z[..., m]
    e = torch.complex(0.5 * (zk.real + zm.real), 0.5 * (zk.imag - zm.imag))
    o = torch.complex(0.5 * (zk.imag + zm.imag), -0.5 * (zk.real - zm.real))
    wo = roots * o
    yk = (e + wo) * hf[..., k]
    ym = (e - wo).conj() * hf[..., N - k]
    a = yk + ym.conj()
    b = (yk - ym.conj()) * roots.conj()
    out = torch.empty_like(z)
    out[..., m] = torch.complex(a.real + b.imag, a.imag - b.real)
    out[..., k] = torch.complex(a.real - b.imag, -(a.imag + b.real))
    return out


def fftconv_plain(xp: torch.Tensor, hf: torch.Tensor, tw: torch.Tensor,
                  radices: tuple[int, ...], bases: tuple[int, ...],
                  roots: torch.Tensor) -> torch.Tensor:
    """The kernel's function on (C, B, n) real float32 signals, zero-filled
    to n, with the (C, n/2 + 1) filter half spectra (1/n folded in), the
    packed Stockham twiddles of length n/2 and the roots of
    :func:`spectral_pass`; returns the (C, B, n) real output."""
    n = xp.shape[-1]
    if n == 1:
        return xp * hf.real[:, None, :]
    z = torch.view_as_complex(xp.reshape(*xp.shape[:-1], n // 2, 2))
    z = apply_stages(z, tw, radices, bases, False)
    z = spectral_pass(z, hf[:, None, :], roots)
    z = apply_stages(z, tw, radices, bases, False)
    return torch.view_as_real(z.conj().resolve_conj()).reshape(xp.shape)
