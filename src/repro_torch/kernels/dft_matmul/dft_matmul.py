"""The batched direct DFT kernel and its launch.

The kernel is CUDA C++ (``repro_torch/csrc/dft.cu``).  It replaces the
reference package's Pallas kernel ``dft_matmul`` (``_dft_kernel``): a tile
of rows of length n <= 128 times the n x n DFT matrix, with fp32 FMA for
complex64 and fp64 for complex128 on the CUDA cores (TF32 would break the
suite's accuracy bar).  One block copies its rows into shared memory;
each thread computes a 4 x 4 register tile of outputs, reading W from
global memory (L1/L2 resident: at n = 128 in complex128 it is larger than
a block's shared memory).

This module keeps the launch's host side: the cap, the register tile and
the shared-memory size of one block.
"""

from __future__ import annotations

#: Longest row the kernel takes (both dtypes): the reference's n <= 128.
MAX_N = 128

#: Threads of one block (``kThreads`` in the kernel).
THREADS = 256

#: Outputs per thread along each axis of the product (``kRT``).
REGISTER_TILE = 4


def smem_bytes(n: int, tile_b: int, itemsize: int) -> int:
    """Dynamic shared memory of one block: its ``tile_b`` rows."""
    return tile_b * n * itemsize


def fill_rows(n: int) -> int:
    """Rows that give each of a block's threads one register tile."""
    col_groups = -(-n // REGISTER_TILE)
    return max(1, THREADS // col_groups) * REGISTER_TILE
