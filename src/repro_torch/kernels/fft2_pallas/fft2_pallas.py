"""The fused rank-2 FFT kernel and its launch.

The kernel is CUDA C++ (``repro_torch/csrc/fft2.cu``).  It replaces the
reference package's Pallas kernel ``fft2_pallas`` (``_fft2_kernel``): one
block owns a tile of whole n1 x n2 signals in two shared-memory buffers,
runs the n2 (row) Stockham stages with the 1-D kernel's stage routine
(``csrc/stockham_stages.cuh``), then the n1 (column) stages with the same
routine on elements n2 apart (so no transpose pass), and writes the
result once in natural order, the inverse's 1/(n1*n2) folded into the last
store.  One launch reads the signal once and writes it once.  A tile
that one block does not hold runs as passes (``ops.Passes2``).

This module keeps the launch's host side: the per-axis schedules (the
reference's, from ``stockham_pallas.radix_schedule``) and the shared-memory
size of one block.
"""

from __future__ import annotations

from ..stockham_pallas.stockham_pallas import radix_schedule

#: Rows of the (n1, n2) tile per block unless the caller sets ``tile_b``.
SMEM_TARGET_BYTES = 32 << 10


def pow2(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def schedules(n1: int, n2: int, radix: int
              ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The column (n1) and row (n2) stage schedules, as the reference
    builds them; an extent of 1 has no stage."""
    return radix_schedule(n1, radix), radix_schedule(n2, radix)


def smem_bytes(n_elems: int, tile_b: int, itemsize: int, n_stages: int) -> int:
    """Dynamic shared memory of one block: two ping-pong buffers of
    ``tile_b`` signals of ``n_elems`` points, or none for a single-stage
    transform (global in, global out)."""
    return 2 * tile_b * n_elems * itemsize if n_stages > 1 else 0
