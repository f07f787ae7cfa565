"""FFT-based long convolution: the model-side consumer of the FFT stack.

Hyena/H3-style sequence mixing: y = irfft( rfft(x_pad) * rfft(h_pad) ) with
zero padding to next_pow2(2L) (linear, not circular, convolution), as the
reference package's ``fft/fftconv.py`` computes it.  Its backends:

* ``"xla"``: ``torch.fft.rfft``/``irfft`` (cuFFT on the card), the
  reference's ``jnp.fft`` path under its backend name;
* ``"stockham"``/``"fourstep"``: the port's plain engines
  (``fft/stockham.py``, ``fft/fourstep.py``) through ``fft/rfft.py``'s
  half-length R2C packing.

Cost: O(L log L) against O(L*K) for direct convolution.  The fused
single-kernel version of the same convolution is
``repro_torch.kernels.fftconv``.
"""

from __future__ import annotations

import torch

from ..core.extents import next_pow2
from . import fourstep, stockham
from . import rfft as _rfft

_ENGINES = {"stockham": stockham.fft, "fourstep": fourstep.fft}


def fftconv(x: torch.Tensor, h: torch.Tensor,
            backend: str = "xla") -> torch.Tensor:
    """Depthwise linear convolution via FFT.

    x: (..., L, D) activations;  h: (K, D) or (L, D) depthwise filters.
    Returns (..., L, D): causal convolution y[t] = sum_{s<=t} x[s] h[t-s],
    in ``x``'s dtype.
    """
    L = x.shape[-2]
    m = next_pow2(2 * L)
    xt = x.transpose(-1, -2)  # (..., D, L): transform the time axis
    ht = h.transpose(-1, -2)  # (D, K)
    if backend == "xla":
        xf = torch.fft.rfft(xt, n=m, dim=-1)
        hf = torch.fft.rfft(ht, n=m, dim=-1)
        y = torch.fft.irfft(xf * hf, n=m, dim=-1)[..., :L]
    elif backend in _ENGINES:
        eng = _ENGINES[backend]
        pad_x = torch.nn.functional.pad(xt, (0, m - L))
        pad_h = torch.nn.functional.pad(ht, (0, m - ht.shape[-1]))
        xf = _rfft.rfft(pad_x, eng)
        hf = _rfft.rfft(pad_h, eng)
        y = _rfft.irfft(xf * hf, m, eng)[..., :L]
    else:
        raise ValueError(f"unknown fftconv backend {backend!r}; known: "
                         f"{['xla', *_ENGINES]}")
    return y.transpose(-1, -2).to(x.dtype)
