"""The plain reference: the discrete Fourier transform by its definition.

Each axis is one matrix product with the n x n matrix
``W[j, k] = exp(-2 pi i (j k mod n) / n)``, its angles taken from exact
integers, so the reference's own error is that of the products in the
precision asked for.  A real kind's last axis keeps the first n // 2 + 1
columns (numpy's ``rfft`` layout); its inverse rebuilds the whole spectrum
by Hermitian symmetry and keeps the real part.  The inverse applies 1/n on
each axis, as the port and numpy do.

``precision`` is ``float64`` for the reference that decides ``correct``,
and the next precision below the configuration's for the control
(``CONTROL``): ``tf32`` for float (operands rounded to TF32's 10-bit
mantissa, products summed in float32, as the tensor cores do), ``float32``
for double.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

#: The configuration's precision -> the control's, the step below it.
CONTROL = {"float": "tf32", "double": "float32"}

PRECISIONS = ("float64", "float32", "tf32")


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits), to
    nearest, ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _matrix(n: int, inverse: bool, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.int64, device=device)
    jk = torch.outer(k, k) % n
    sign = 1.0 if inverse else -1.0
    angle = jk.to(torch.float64) * (sign * 2.0 * math.pi / n)
    return torch.polar(torch.ones_like(angle), angle)


class Dft:
    """The transforms of one problem's shape in one precision, the
    matrices built once.  ``rank`` trailing axes are transformed; the
    leading ones are the batch."""

    def __init__(self, extents, real: bool, precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.extents = tuple(int(e) for e in extents)
        self.real = real
        self.precision = precision
        self._w: dict = {}

    def _w_of(self, n: int, inverse: bool, device) -> torch.Tensor:
        key = (n, inverse, str(device))
        if key not in self._w:
            self._w[key] = _matrix(n, inverse, device)
        return self._w[key]

    def _last(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., n) times w (n, m) in this precision."""
        if self.precision == "float64":
            return x.to(torch.complex128) @ w
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False   # sums in float32
        try:
            rnd = _tf32 if self.precision == "tf32" else (lambda t: t)
            wr = rnd(w.real.to(torch.float32))
            wi = rnd(w.imag.to(torch.float32))
            if x.is_complex():
                xr = rnd(x.real.to(torch.float32))
                xi = rnd(x.imag.to(torch.float32))
                return torch.complex(xr @ wr - xi @ wi, xr @ wi + xi @ wr)
            xr = rnd(x.to(torch.float32))
            return torch.complex(xr @ wr, xr @ wi)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    def _along(self, x: torch.Tensor, axis: int, w: torch.Tensor):
        if axis == -1:
            return self._last(x, w)
        return self._last(x.movedim(axis, -1), w).movedim(-1, axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rank = len(self.extents)
        n = self.extents[-1]
        w = self._w_of(n, False, x.device)
        y = self._along(x, -1, w[:, : n // 2 + 1] if self.real else w)
        for axis in range(-2, -rank - 1, -1):
            y = self._along(y, axis, self._w_of(self.extents[axis], False,
                                                x.device))
        return y

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        rank = len(self.extents)
        for axis in range(-2, -rank - 1, -1):
            n = self.extents[axis]
            y = self._along(y, axis, self._w_of(n, True, y.device)) / n
        n = self.extents[-1]
        if self.real:
            h = n // 2 + 1
            tail = torch.flip(y[..., 1: n - h + 1], dims=(-1,)).conj()
            y = torch.cat([y, tail], dim=-1)
        x = self._along(y, -1, self._w_of(n, True, y.device)) / n
        return x.real if self.real else x
