"""Plain PyTorch versions of the Stockham kernel, on any device.

* :func:`apply_stages` repeats the kernel's arithmetic with the kernel's own
  packed twiddles, one stage per pass over memory.  ``ops.fft`` takes it for
  tensors that lie on the CPU.
* :func:`apply_two_pass` repeats the two column passes of an axis over the
  one-block cap (n = n1*n2): the n1-point column FFTs with the pass
  twiddle W_n^(j2*k1) from the plan's root tables, then the n2-point ones,
  stored in natural order.
* :func:`stockham_ref` is the independent oracle: the same recursion with
  its twiddles computed here, as the reference package's ``ref.py`` does, so
  a kernel-vs-oracle comparison isolates the kernel, not the factorization.
"""

from __future__ import annotations

import numpy as np
import torch

from .stockham_pallas import radix_schedule


def _butterfly_roots(r: int, inverse: bool) -> list[complex]:
    sign = 2.0 if inverse else -2.0
    return [complex(w) for w in
            np.exp(1j * (sign * np.pi / r) * np.arange(r, dtype=np.float64))]


def _stage(v: torch.Tensor, r: int, inverse: bool, twiddle) -> torch.Tensor:
    """One radix-r stage on ``v`` viewed as (..., r, m, s); ``twiddle(u)``
    gives the (m,) stage twiddles of output u >= 1."""
    w = _butterfly_roots(r, inverse)
    rows = []
    for u in range(r):
        acc = v[..., 0, :, :]
        for t in range(1, r):
            acc = acc + v[..., t, :, :] * w[(t * u) % r]
        if u:
            acc = acc * twiddle(u)[:, None]
        rows.append(acc)
    return torch.stack(rows, dim=-2)          # (..., m, r, s)


def apply_stages(x: torch.Tensor, tw: torch.Tensor,
                 radices: tuple[int, ...], bases: tuple[int, ...],
                 inverse: bool) -> torch.Tensor:
    """The kernel's stage chain along the last axis of complex ``x``, with
    the packed twiddles ``tw`` (stage twiddle of (u, p) at
    ``bases[stage] + (u-1)*m + p``).  No 1/n scaling."""
    lead, n = x.shape[:-1], x.shape[-1]
    cur = n
    for r, base in zip(radices, bases):
        m = cur // r
        v = x.reshape(*lead, r, m, n // cur)
        x = _stage(v, r, inverse,
                   lambda u, b=base, m=m: tw[b + (u - 1) * m:b + u * m]
                   ).reshape(*lead, n)
        cur = m
    return x


def pass_twiddle(roots: torch.Tensor, e: torch.Tensor,
                 lo: int = 1024) -> torch.Tensor:
    """W_n^e from the two-pass root tables (``ops.pass_roots``): hi[e //
    lo] * lo[e % lo], in the tables' dtype, as the kernel forms it."""
    return roots[lo + torch.div(e, lo, rounding_mode="floor")] * roots[e % lo]


def apply_two_pass(x: torch.Tensor, n1: int, n2: int, first, second,
                   roots: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The kernel's two passes along the last axis of complex ``x`` (length
    n1*n2): the n1-point FFTs of the columns x[j1*n2 + j2], each output k1
    times W_n^(j2*k1); then the n2-point FFTs over j2, output k2 of row k1
    at y[k1 + n1*k2].  ``first`` and ``second`` are each pass's (packed
    twiddles, radices, bases).  No 1/n scaling."""
    lead = x.shape[:-1]
    cols = x.reshape(*lead, n1, n2).transpose(-1, -2)        # (j2, j1)
    a = apply_stages(cols, *first, inverse)                  # (j2, k1)
    e = torch.outer(torch.arange(n2, device=x.device),
                    torch.arange(n1, device=x.device))
    a = a * pass_twiddle(roots, e)
    b = apply_stages(a.transpose(-1, -2), *second, inverse)  # (k1, k2)
    return b.transpose(-1, -2).reshape(*lead, n1 * n2)


def stockham_ref(x: torch.Tensor, radix: int = 8,
                 inverse: bool = False) -> torch.Tensor:
    """General-radix Stockham FFT along the last axis (7-smooth length),
    the kernel's schedule with twiddles computed here in float64.  Forward
    unnormalized, inverse applies 1/n (numpy semantics)."""
    if not x.is_complex():
        x = x.to(torch.complex64)
    lead, n = x.shape[:-1], x.shape[-1]
    sign = 2.0 if inverse else -2.0
    cur = n
    for r in radix_schedule(n, radix):
        m = cur // r
        p = np.arange(m, dtype=np.int64)

        def twiddle(u, cur=cur, p=p):
            ang = (sign * np.pi / cur) * ((u * p) % cur).astype(np.float64)
            return torch.as_tensor(np.exp(1j * ang), dtype=x.dtype,
                                   device=x.device)

        x = _stage(x.reshape(*lead, r, m, n // cur), r, inverse,
                   twiddle).reshape(*lead, n)
        cur = m
    if inverse:
        x = x / n
    return x
