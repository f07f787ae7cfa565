"""The fused fftconv kernel and its launch.

The kernel is CUDA C++ (``repro_torch/csrc/fftconv.cu``).  It replaces the
reference package's Pallas kernel ``fftconv_kernel``
(``src/repro/kernels/fftconv/fftconv.py``, body ``_fftconv_kernel``): for a
tile of real signals of one channel, zero-filled to n = 4^m <= 16384
points, the circular convolution with the channel's filter, with one read
of the L-point signals and one write of the L-point results.  Where the
TPU kernel runs a real square four-step as dense k x k products, this one
runs two real FFTs in shared memory: each signal packed as n/2 complex
points, a radix-8/4/2 Stockham FFT of n/2, one spectral pass over the bin
pairs (k, n/2 - k) (the R2C unpack, the product by the filter's half
spectrum, the C2R re-pack) and the same forward FFT again on the
conjugate, which is the inverse.

A block holds two buffers of n/2 complex64 per signal (8.5 n bytes with
the padding against bank conflicts), between which the stages ping-pong.
This module keeps the launch's host side: the caps, the stage schedule
and the shared-memory size of one block (the kernel sizes its block by n).
"""

from __future__ import annotations

from ..stockham_pallas.stockham_pallas import radix_schedule

#: Longest signal: n <= 16384, the reference's cap.
MAX_N = 16384

#: Most signals one block takes: short signals (n <= 1024, 128 threads a
#: block) need several to give each thread a butterfly.
MAX_TILE_B = 8

#: Signals per block by default (where that many fit): the fastest tile of
#: the F2 sweep that ``chip_smoke.py`` runs (n = 4096).
DEFAULT_TILE_B = 1


def stage_schedule(n: int) -> tuple[int, ...]:
    """Radices of the complex FFT of the packed n/2 points (none for
    n = 1): the Stockham kernel's radix-8 schedule, e.g. (8, 8, 8, 4) for
    n = 4096 and (8, 8, 8, 8, 2) for n = 16384."""
    return radix_schedule(n // 2, 8) if n > 1 else ()


def smem_bytes(n: int, tile_b: int) -> int:
    """Dynamic shared memory of one block of ``tile_b`` signals: two
    buffers of n/2 complex64 per signal, each with one pad point per 16
    (none for n = 1)."""
    half = n // 2
    return tile_b * 16 * (half + half // 16) if n > 1 else 0
