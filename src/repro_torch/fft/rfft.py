"""Real-to-complex (R2C) and complex-to-real (C2R) transforms on top of any
complex engine, by the half-length packing trick:

  even n:  z[j] = x[2j] + i x[2j+1]  (length n/2 complex), Z = cfft(z), then
           X[k] = (Z[k] + conj(Z[-k]))/2  -  (i/2) e^{-2pi i k/n} (Z[k] - conj(Z[-k]))
           for k = 0..n/2 (Z indices mod n/2): n/2+1 outputs.
  odd n:   the full complex transform of the realified input.

Real input halves both the memory traffic and the flops of C2C (paper
Fig. 8a); every complex backend gets an R2C variant for free.
"""

from __future__ import annotations

from typing import Callable

import torch

from .reference import half_roots

CFFT = Callable[..., torch.Tensor]  # (x, inverse=False) -> y, along last axis


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype in (torch.float64, torch.complex128) \
        else torch.complex64


def _real_dtype(cdtype: torch.dtype) -> torch.dtype:
    return torch.float64 if cdtype == torch.complex128 else torch.float32


def _rev(a: torch.Tensor) -> torch.Tensor:
    """a[..., (-k) mod h] along the last axis."""
    return torch.roll(torch.flip(a, dims=(-1,)), 1, dims=-1)


def rfft(x: torch.Tensor, cfft: CFFT,
         roots: torch.Tensor | None = None) -> torch.Tensor:
    """Forward R2C along the last axis using complex engine ``cfft``.
    Returns n//2+1 coefficients (numpy rfft layout).  ``roots`` is the
    prebuilt ``half_roots(n)`` table of a plan (built here when absent)."""
    n = x.shape[-1]
    cdtype = _complex_dtype(x.dtype)
    if n % 2:  # odd length: no packing trick; pay the full transform
        return cfft(x.to(cdtype).contiguous())[..., : n // 2 + 1]
    real = _real_dtype(cdtype)
    z = torch.complex(x[..., 0::2].to(real), x[..., 1::2].to(real))
    zf = cfft(z)  # (..., h)
    zrev = _rev(zf).conj()
    even = 0.5 * (zf + zrev)
    odd = -0.5j * (zf - zrev)
    if roots is None:
        roots = half_roots(n, inverse=False, dtype=cdtype, device=x.device)
    half = even + roots * odd              # X[0..h-1]
    nyq = even[..., :1] - odd[..., :1]     # X[h]: e^{-i pi} = -1
    return torch.cat([half, nyq], dim=-1)


def irfft(y: torch.Tensor, n: int, cfft: CFFT,
          roots: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse C2R along the last axis (input n//2+1 bins, output length n).
    ``roots`` is the prebuilt ``half_roots(n, inverse=True)`` table of a
    plan (built here when absent)."""
    cdtype = y.dtype if y.is_complex() else _complex_dtype(y.dtype)
    y = y.to(cdtype)
    if n % 2:
        # the full spectrum by Hermitian symmetry, then a full C2C inverse
        tail = torch.flip(y[..., 1:], dims=(-1,)).conj()
        full = torch.cat([y, tail], dim=-1)
        return cfft(full, inverse=True).real.contiguous()
    h = n // 2
    half, nyq = y[..., :h], y[..., h:h + 1]
    # reversed half spectrum; the X[-0] slot carries X[h]
    half_rev = torch.cat([nyq, torch.flip(half[..., 1:], dims=(-1,))], dim=-1)
    g = half_rev.conj()
    even = 0.5 * (half + g)
    if roots is None:
        roots = half_roots(n, inverse=True, dtype=cdtype, device=y.device)
    odd = 0.5 * (half - g) * roots
    zt = cfft((even + 1j * odd).contiguous(), inverse=True)
    return torch.view_as_real(zt.contiguous()).reshape(*y.shape[:-1], n)
