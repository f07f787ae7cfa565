"""Plain PyTorch versions of the fused fftconv kernel, on any device.

* :func:`fftconv_plain` repeats the reference kernel's arithmetic with the
  kernel's own tables, in float32: the real four-step forward
  (``_fourstep_core``), the spectral product in the transposed layout (the
  natural-order spectrum reshaped (k, k)), the inverse four-step, the real
  part.  ``ops.fftconv`` takes it for tensors that lie on the CPU.
* :func:`fftconv_ref` is the oracle, as the reference package's ``ref.py``
  has it: circular convolution at length n through ``torch.fft``.
"""

from __future__ import annotations

import torch


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


def _fourstep_core(xr, xi, wr, wi, tr, ti):
    """One four-step pass on (..., k, k) planes -> the transposed
    (..., k, k) planes (the natural-order DFT reshaped (k, k)).  ``xi`` is
    None for real input: half the column-DFT products."""
    if xi is None:
        br, bi = wr @ xr, wi @ xr
    else:
        br = wr @ xr - wi @ xi
        bi = wr @ xi + wi @ xr
    cr = br * tr - bi * ti
    ci = br * ti + bi * tr
    dr = cr @ wr - ci @ wi
    di = cr @ wi + ci @ wr
    return dr.transpose(-1, -2), di.transpose(-1, -2)


def fftconv_plain(xp, hfr, hfi, wfr, wfi, wir, wii, tfr, tfi, tir, tii
                  ) -> torch.Tensor:
    """The kernel's function on (C, B, k, k) real signals with (C, k, k)
    filter-spectrum planes (1/n folded in) and the (k, k) forward/inverse
    DFT matrices and twiddles; returns the (C, B, k, k) real output,
    natural time order when flattened."""
    xfr, xfi = _fourstep_core(xp, None, wfr, wfi, tfr, tfi)
    hr, hi = hfr[:, None], hfi[:, None]
    er = xfr * hr - xfi * hi
    ei = xfr * hi + xfi * hr
    yr, _ = _fourstep_core(er, ei, wir, wii, tir, tii)
    return yr
