"""The yardstick: peaks, the work of a problem, percentiles.

Every number here depends on the problem alone, never on the implementation
that runs it, so a later change to the program cannot move it.

* Peaks: NVIDIA's H100 SXM data sheet, 67 TFLOP/s in float32 outside the
  tensor cores (the float64 tensor-core rate is the same) and 3.35 TB/s of
  HBM3.  A roofline share is stated against them, with the card's power
  limit beside it.
* Work: one read of a transform's input and one write of its output, and
  5 * n * log2(n) flops a complex transform of n points (2.5 * n * log2(n)
  a real one), as the paper's Fig. 7 counts them (copied from the port's
  ``roofline/analysis.py`` ``fft_model_flops``).
* ``percentile``: numpy's default (linear) method, copied from the port's
  ``core/compare.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

_REAL_BYTES = {"float": 4, "double": 8}


@dataclass(frozen=True)
class Problem:
    """One cell's FFT problem, in the paper's terms."""

    extents: tuple[int, ...]
    kind: str          # Outplace_Complex, Outplace_Real, Inplace_*
    precision: str     # float | double
    batch: int

    @property
    def complex_input(self) -> bool:
        return self.kind.endswith("Complex")

    @property
    def points(self) -> int:
        """Points of one transform."""
        return math.prod(self.extents)

    @property
    def input_bytes(self) -> int:
        item = _REAL_BYTES[self.precision] * (2 if self.complex_input else 1)
        return self.batch * self.points * item

    @property
    def output_bytes(self) -> int:
        """Bytes of the forward's output: the whole spectrum of a complex
        kind, the half spectrum (last extent n // 2 + 1) of a real one."""
        if self.complex_input:
            return self.input_bytes
        half = self.points // self.extents[-1] * (self.extents[-1] // 2 + 1)
        return self.batch * half * 2 * _REAL_BYTES[self.precision]


def batch_for(extents, kind: str, precision: str, input_bytes: int) -> int:
    """The largest batch whose input fits in ``input_bytes``."""
    item = _REAL_BYTES[precision] * (2 if kind.endswith("Complex") else 1)
    return input_bytes // (math.prod(extents) * item)


def transform_flops(p: Problem) -> float:
    """Flops of one forward (or one inverse) of the whole batch."""
    n = p.points
    if n <= 1:
        return 0.0
    full = 5.0 * p.batch * n * math.log2(n)
    return full if p.complex_input else full / 2


def pair_bytes(p: Problem) -> int:
    """A forward and an inverse: each reads its input once and writes its
    output once."""
    return 2 * (p.input_bytes + p.output_bytes)


def pair_flops(p: Problem) -> float:
    return 2 * transform_flops(p)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the flops over the
    peak rate and the bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def pair_bound_s(p: Problem) -> float:
    return bound_s(pair_flops(p), pair_bytes(p))


def launch_work(n: int, rows: int, dtype: str) -> tuple[float, int]:
    """(flops, bytes) of one launch of a kernel that transforms ``rows``
    complex rows of ``n`` points: one read and one write of the rows."""
    item = {"complex64": 8, "complex128": 16}[dtype]
    flops = 5.0 * rows * n * math.log2(n) if n > 1 else 0.0
    return flops, 2 * rows * n * item


def percentile(vals, q: float) -> float:
    """q-th percentile (0..100), linear interpolation between closest
    ranks: ``numpy.percentile``'s default method."""
    if not vals:
        raise ValueError("percentile of empty sequence")
    s = sorted(vals)
    if len(s) == 1:
        return float(s[0])
    pos = (len(s) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))

