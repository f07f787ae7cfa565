"""Real-to-complex (R2C) and complex-to-real (C2R) transforms on top of any
complex engine, by the half-length packing trick:

  even n:  z[j] = x[2j] + i x[2j+1]  (length n/2 complex), Z = cfft(z), then
           X[k] = (Z[k] + conj(Z[-k]))/2  -  (i/2) e^{-2pi i k/n} (Z[k] - conj(Z[-k]))
           for k = 0..n/2 (Z indices mod n/2): n/2+1 outputs.
  odd n:   the full complex transform of the realified input.

Real input halves both the memory traffic and the flops of C2C (paper
Fig. 8a); every complex backend gets an R2C variant for free.

``rfftn_packed``/``irfftn_packed`` apply the same trick over a
whole-transform engine (the fused rank-2 kernel): the outer axes' DFTs are
linear and commute with the last-axis pack, so the packed signal runs
through one fused rank-d transform, and the reversal ``Z[-k]`` becomes the
index reversal mod every transformed axis.
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


# ---------------------------------------------------------------------------
# packed real transforms over a fused rank-d complex engine
# ---------------------------------------------------------------------------
def _rev_mod(a: torch.Tensor, dims) -> torch.Tensor:
    """Index reversal mod the extent on each of ``dims``:
    ``out[..., k, ...] = a[..., (-k) % n, ...]``."""
    dims = tuple(dims)
    if not dims:
        return a
    return torch.roll(torch.flip(a, dims=dims), (1,) * len(dims), dims=dims)


def rfftn_packed(x: torch.Tensor, cfftn: CFFT, rank: int,
                 roots: torch.Tensor | None = None) -> torch.Tensor:
    """Forward R2C over the trailing ``rank`` axes through the
    whole-transform complex engine ``cfftn`` (the fused rank-2 kernel).

    The last axis becomes n//2+1 bins (numpy rfftn layout).  An even last
    extent runs the packed half-length trick through ONE fused complex
    transform, whose reversal ``Z[-k]`` is taken mod every transformed
    axis; an odd one pays the full complex transform.  ``roots`` is the
    plan's ``half_roots(n)`` table (built here when absent)."""
    n = x.shape[-1]
    cdtype = _complex_dtype(x.dtype)
    if n % 2:
        return cfftn(x.to(cdtype).contiguous())[..., : n // 2 + 1]
    real = _real_dtype(cdtype)
    z = torch.complex(x[..., 0::2].to(real), x[..., 1::2].to(real))
    zf = cfftn(z)
    zrev = _rev_mod(zf, range(-rank, 0)).conj()
    even = 0.5 * (zf + zrev)
    odd = -0.5j * (zf - zrev)
    if roots is None:
        roots = half_roots(n, inverse=False, dtype=cdtype, device=x.device)
    half = even + roots * odd              # X[..., 0..h-1]
    nyq = even[..., :1] - odd[..., :1]     # k_last = h: e^{-i pi} = -1
    return torch.cat([half, nyq], dim=-1)


def irfftn_packed(y: torch.Tensor, shape, cfftn: CFFT,
                  roots: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse C2R over the trailing ``len(shape)`` axes through a
    whole-transform complex engine (n//2+1 bins on the last axis in).
    ``roots`` is the plan's ``half_roots(n, inverse=True)`` table."""
    shape = tuple(shape)
    rank, n = len(shape), shape[-1]
    cdtype = y.dtype if y.is_complex() else _complex_dtype(y.dtype)
    y = y.to(cdtype)
    outer = range(-rank, -1)
    if n % 2:
        # Hermitian rebuild of the full last axis, then a full C2C inverse:
        # X[k_outer, n-k] = conj(X[-k_outer, k])
        tail = _rev_mod(torch.flip(y[..., 1:], dims=(-1,)), outer).conj()
        full = torch.cat([y, tail], dim=-1)
        return cfftn(full, inverse=True).real.contiguous()
    h = n // 2
    half, nyq = y[..., :h], y[..., h:h + 1]
    # reversed half spectrum; the X[-0] slot carries X[h]
    half_rev = torch.cat([nyq, torch.flip(half[..., 1:], dims=(-1,))], dim=-1)
    g = _rev_mod(half_rev, outer).conj()   # E - tw*O at (k_outer, k)
    even = 0.5 * (half + g)
    if roots is None:
        roots = half_roots(n, inverse=True, dtype=cdtype, device=y.device)
    odd = 0.5 * (half - g) * roots
    zt = cfftn((even + 1j * odd).contiguous(), inverse=True)
    return torch.view_as_real(zt.contiguous()).reshape(*y.shape[:-1], n)
