"""Iterative Stockham autosort radix-2 FFT in plain PyTorch: the
reference package's ``fft/stockham.py`` (its ``stockham`` backend), one
pass over memory per radix-2 stage.

It is a baseline, not a kernel: the planner offers it (``candidates``)
and wisdom records name it.  With N = n * s fixed and the buffer indexed
as x[q + s*p], one stage computes

    y[q + s*(2p + 0)] =  x[q + s*p] + x[q + s*(p + n/2)]
    y[q + s*(2p + 1)] = (x[q + s*p] - x[q + s*(p + n/2)]) * w_n^p ,  p < n/2

and recurses with (n, s) <- (n/2, 2s); after log2(N) stages the output is
in natural order.  Each stage's twiddles (float64 angles, cast once) are
cached per length, dtype and device, so a call builds no table twice.
"""

from __future__ import annotations

import functools

import torch

from .reference import half_roots


@functools.lru_cache(maxsize=256)
def _stage_twiddle(n: int, inverse: bool, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    return half_roots(n, inverse, dtype, device=device)


def fft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Radix-2 Stockham FFT along the last axis (power-of-two length).

    Forward is unnormalized; the inverse applies 1/N (numpy semantics).
    Real input is cast to complex64, as the reference does.
    """
    n_total = x.shape[-1]
    if n_total & (n_total - 1):
        raise ValueError(f"stockham requires power-of-two length, got {n_total}")
    if not x.is_complex():
        x = x.to(torch.complex64)
    batch = x.shape[:-1]
    n, s = n_total, 1
    while n > 1:
        m = n // 2
        w = _stage_twiddle(n, inverse, x.dtype, x.device)  # (m,)
        v = x.reshape(*batch, 2, m, s)
        a, b = v[..., 0, :, :], v[..., 1, :, :]
        x = torch.stack([a + b, (a - b) * w[:, None]], dim=-2).reshape(
            *batch, n_total)                                  # (..., m, 2, s)
        n, s = m, 2 * s
    if inverse:
        x = x / n_total
    return x
