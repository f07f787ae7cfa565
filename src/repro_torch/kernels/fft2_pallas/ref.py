"""Plain PyTorch versions of the fused rank-2 kernel, on any device.

* :func:`apply2_passes` repeats the kernel's arithmetic with the kernel's
  own packed twiddles in its register passes: the row stages, then the
  column stages on the transposed view, each axis grouped as
  ``stockham_pallas.block.group_passes`` groups it
  (``stockham_pallas.ref.apply_passes``).  ``ops.fft2`` takes it for
  tensors that lie on the CPU; ``stockham_pallas.ref.run_block`` runs the
  kernel's own indices.
* :func:`fft2_ref` is the independent oracle, as the reference package's
  ``ref.py`` has it: the rank-1 Stockham recursion with its own twiddles,
  along the rows, then along the columns.
"""

from __future__ import annotations

import torch

from ..stockham_pallas.ref import apply_passes, apply_stages, stockham_ref


def apply2_passes(x: torch.Tensor, tw: torch.Tensor,
                  radices1: tuple[int, ...], radices2: tuple[int, ...],
                  bases1: tuple[int, ...], bases2: tuple[int, ...],
                  groups1: tuple[int, ...], groups2: tuple[int, ...],
                  inverse: bool) -> torch.Tensor:
    """The kernel's stage chain over the last two axes of complex ``x`` in
    its passes: the n2 stages in ``groups2`` of one or two along the rows,
    then the n1 stages in ``groups1`` along the columns, with the packed
    twiddles ``tw``.  No 1/(n1*n2) scaling."""
    y = apply_passes(x, tw, radices2, bases2, groups2, inverse)
    y = apply_passes(y.transpose(-1, -2), tw, radices1, bases1, groups1,
                     inverse)
    return y.transpose(-1, -2)


def fft2_ref(x: torch.Tensor, radix: int = 8,
             inverse: bool = False) -> torch.Tensor:
    """Rank-2 Stockham FFT over the last two axes (power-of-two extents),
    twiddles computed here in float64.  Forward unnormalized; the inverse
    applies 1/(n1*n2) (the two per-axis 1/n compose, numpy semantics)."""
    y = stockham_ref(x, radix=radix, inverse=inverse)
    y = stockham_ref(y.transpose(-1, -2), radix=radix, inverse=inverse)
    return y.transpose(-1, -2)
