"""N-dimensional transforms by separable axis application.

A rank-d FFT is d batched 1-D transforms with axis moves in between.
Every engine transforms the contiguous last axis of a batched tensor, so per
axis there is one swap in and one swap out, and none at all when the axis
*is* the last one (the innermost axis, and the whole transform for rank 1).
``rfftn`` transforms the last axis real-to-complex first, then the complex
axes (numpy layout); ``roots`` is the real axis's prebuilt R2C pack table
(see ``rfft``).  ``r2c`` / ``c2r``, where given, transform the real axis
in one call instead (a kernel that folds the pack into its passes, such as
``stockham_pallas.ops.rfft`` / ``irfft``); without them the real axis runs
``rfft.py``'s packing around its complex engine.

``cfft`` may be one callable (the same engine on every axis) or a sequence
aligned with ``axes``.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import torch

from . import rfft as _rfft

CFFT = Callable[..., torch.Tensor]
CFFTS = Union[CFFT, Sequence[CFFT]]


def _per_axis(cfft: CFFTS, n_axes: int) -> Sequence[CFFT]:
    """Normalize ``cfft`` to one engine per axis."""
    if callable(cfft):
        return (cfft,) * n_axes
    fns = tuple(cfft)
    if len(fns) != n_axes:
        raise ValueError(f"{len(fns)} engines for {n_axes} axes")
    return fns


def _apply_last(x: torch.Tensor, ax: int,
                fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Apply a last-axis transform along ``ax``: the engine gets a
    contiguous last axis, with one swap in and one swap out only when
    ``ax`` is not last."""
    ax = ax % x.ndim
    if ax == x.ndim - 1:
        return fn(x.contiguous())
    return fn(x.transpose(ax, -1).contiguous()).transpose(ax, -1)


def fftn(x: torch.Tensor, cfft: CFFTS, axes: Sequence[int] | None = None,
         inverse: bool = False) -> torch.Tensor:
    axes = tuple(range(x.ndim)) if axes is None else tuple(axes)
    for ax, fn in zip(axes, _per_axis(cfft, len(axes))):
        x = _apply_last(x, ax, lambda v, f=fn: f(v, inverse=inverse))
    return x


def rfftn(x: torch.Tensor, cfft: CFFTS, axes: Sequence[int] | None = None,
          roots: torch.Tensor | None = None,
          r2c: Callable[[torch.Tensor], torch.Tensor] | None = None
          ) -> torch.Tensor:
    axes = tuple(range(x.ndim)) if axes is None else tuple(axes)
    fns = _per_axis(cfft, len(axes))
    last, rest = axes[-1], axes[:-1]
    y = _apply_last(x, last, r2c or (lambda v: _rfft.rfft(v, fns[-1], roots)))
    for ax, fn in zip(rest, fns[:-1]):
        y = _apply_last(y, ax, fn)
    return y


def irfftn(y: torch.Tensor, shape: Sequence[int], cfft: CFFTS,
           axes: Sequence[int] | None = None,
           roots: torch.Tensor | None = None,
           c2r: Callable[[torch.Tensor, int], torch.Tensor] | None = None
           ) -> torch.Tensor:
    axes = tuple(range(y.ndim)) if axes is None else tuple(axes)
    fns = _per_axis(cfft, len(axes))
    last, rest = axes[-1], axes[:-1]
    for ax, fn in zip(rest, fns[:-1]):
        y = _apply_last(y, ax, lambda v, f=fn: f(v, inverse=True))
    n_last = shape[-1] if len(shape) else y.shape[last]
    if c2r is not None:
        return _apply_last(y, last, lambda v: c2r(v, n_last))
    return _apply_last(y, last,
                       lambda v: _rfft.irfft(v, n_last, fns[-1], roots))
