"""The fused fftconv kernel and its launch.

The kernel is CUDA C++ (``repro_torch/csrc/fftconv.cu``).  It replaces the
reference package's Pallas kernel ``fftconv_kernel``
(``src/repro/kernels/fftconv/fftconv.py``, body ``_fftconv_kernel``): for a
tile of real signals of one channel, each of length n = k*k (k a power of
two <= 128), the square four-step forward transform, the pointwise product
by the channel's filter spectrum (1/n folded in), and the inverse four-step
whose real part is the result, with one read of the L-point signals and
one write of the L-point results (zero-filled to n and cut on chip).  Its products run as fp32 FMA on the CUDA cores: TF32 would break
the 1e-5 bar.

One block holds, per signal, the real tile (whose space the row passes
reuse as scratch, half the rows at a time) and one complex plane, both
with rows padded to k + 1 points; at k = 128 that is 193.5 KB, so one
signal per block.  This module keeps the launch's host side: the caps,
the register tile and the shared-memory size of one block.
"""

from __future__ import annotations

#: Largest side of the square: n = k*k <= 16384, the reference's cap.
MAX_K = 128

#: Signals per block the reference's wrapper asks for.
DEFAULT_TILE_B = 4

def register_tile(k: int) -> int:
    """Outputs per thread along each axis of a pass's product: 4x4 from
    k = 32 on, 2x2 below, where 4x4 tiles would leave most of a block's
    threads idle."""
    return 4 if k >= 32 else 2


def scratch_floats(k: int) -> int:
    """Floats per signal of the first buffer: the real k x k tile, or the
    row passes' scratch (half the rows, rounded up, of the complex plane
    with rows padded to k + 1), whichever is larger."""
    return max(k * k, 2 * ((k + 1) // 2) * (k + 1))


def smem_bytes(k: int, tile_b: int) -> int:
    """Dynamic shared memory of one block of ``tile_b`` signals: the first
    buffer and the complex plane (rows padded to k + 1 points)."""
    return tile_b * (4 * scratch_floats(k) + 8 * k * (k + 1))
